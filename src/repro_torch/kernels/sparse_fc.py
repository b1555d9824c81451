"""Block-sparse FC: the CUDA kernels of ``csrc/sparse_fc.cu`` and their
plain PyTorch version (the GENESIS pruned-FC hot spot).

The paper's pruned FC layers are element-sparse and run in software on the
MCU (LEA cannot exploit sparsity, Sec. 7.2).  The JAX package maps element
sparsity onto *block* sparsity for the TPU's matrix unit: the weight is
stored as a block-CSR bundle (values (nnzb, bm, bk), row pointers, column
indices) and the kernel walks each output row-block's nonzero blocks,
skipping pruned ones entirely.  :func:`to_block_csr` is that package's
function that makes the bundle, copied as numpy so both packages store the
same bundle bit for bit.  The Pallas kernel needs a uniform step plan (``_plan``) with
scalar-prefetched indices; on the card each thread block reads its own
``row_ptr`` range, so no plan is made.

Three kernels, chosen from the operands before the launch by
:func:`fc_path`: ``"wgmma"``, bf16 x and values on the tensor cores;
``"tf32x3"``, f32 x and values on the tensor cores as three tf32 products
of split operands (near f32 accuracy); ``"simt"``, the CUDA-core kernel in
f32, for every block shape or operand the tensor-core kernel does not take.
As in the JAX package, the output has x's dtype and the sums run in f32; a
pair of one f32 and one bf16 operand is computed in f32 (the bf16 one
widened, as JAX promotes it) and rounded once to x's dtype.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _launch
from .ref import block_sparse_matvec_ref

F32, BF16 = torch.float32, torch.bfloat16
I32 = torch.int32
DTYPES = (F32, BF16)
#: Batch rows one thread block of the CUDA-core kernel carries (its
#: instantiations).
BATCH_TILES = (1, 2, 4, 8, 16, 32)
#: The tensor-core kernel's block rows (wgmma N) and batch rows a CTA.
HOPPER_BM = 128
HOPPER_ROWS = 128
#: Elements of one 128-byte swizzle row, the tensor-core kernel's K slice:
#: bk must be a multiple of it.
SLICE = {F32: 32, BF16: 64}
#: Which kernel computes in which dtype.
PATH_DTYPE = {"wgmma": BF16, "tf32x3": F32, "simt": F32}
_INT_MAX = 2**31 - 1
_GRID_Y_MAX = 65535


def to_block_csr(w: np.ndarray, bm: int, bk: int):
    """Dense (M, K) with zeros -> (vals (nnzb,bm,bk), row_ptr, col_idx).

    Blocks that are entirely zero are dropped; rows are padded to at least
    one block so every row-block has work (simplifies the kernel grid)."""
    m, k = w.shape
    if m % bm or k % bk:
        raise ValueError(f"({m}, {k}) is not a multiple of the block "
                         f"({bm}, {bk})")
    nbr, nbc = m // bm, k // bk
    vals, col_idx, row_ptr = [], [], [0]
    for i in range(nbr):
        row_cols = []
        for j in range(nbc):
            blk = w[i * bm:(i + 1) * bm, j * bk:(j + 1) * bk]
            if np.any(blk != 0):
                vals.append(blk)
                row_cols.append(j)
        if not row_cols:                       # keep one zero block
            vals.append(np.zeros((bm, bk), w.dtype))
            row_cols.append(0)
        col_idx.extend(row_cols)
        row_ptr.append(len(vals))
    return (np.stack(vals), np.asarray(row_ptr, np.int32),
            np.asarray(col_idx, np.int32))


def block_sparse_matvec_plain(x, vals, row_ptr, col_idx, m: int, *,
                              bm: int, bk: int) -> torch.Tensor:
    """The plain version: scatter the bundle's blocks (summing any that
    share a position, as the kernel would) into a dense (m, K) weight and
    multiply by it in f32 (:func:`~.ref.block_sparse_matvec_ref`)."""
    k = x.shape[1]
    nbr = row_ptr.numel() - 1
    nbc = -(-k // bk)
    if col_idx.numel():
        nbc = max(nbc, int(col_idx.max()) + 1)
    rows = torch.repeat_interleave(
        torch.arange(nbr, device=x.device),
        torch.diff(row_ptr.to(torch.int64)))
    w = torch.zeros((nbr, nbc, bm, bk), dtype=F32, device=x.device)
    w.index_put_((rows, col_idx.to(torch.int64)), vals.to(F32),
                 accumulate=True)
    w = w.permute(0, 2, 1, 3).reshape(nbr * bm, nbc * bk)[:m, :k]
    return block_sparse_matvec_ref(x, w)


def _library():
    """Build (first use) and bind the kernel's C entry point."""
    from . import _build

    lib = _build.load("sparse_fc").lib
    if getattr(lib, "_bound", False):
        return lib
    for fn in (lib.block_sparse_fc_hopper_bm, lib.block_sparse_fc_hopper_rows):
        fn.restype, fn.argtypes = ctypes.c_int, []
    if (lib.block_sparse_fc_hopper_bm(), lib.block_sparse_fc_hopper_rows()) \
            != (HOPPER_BM, HOPPER_ROWS):
        raise RuntimeError("csrc/sparse_fc.cu was built for other tiles than "
                           "sparse_fc.py's")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.block_sparse_fc_launch.restype = i
    lib.block_sparse_fc_launch.argtypes = [p] * 5 + [i] * 7 + [p]
    lib.block_sparse_fc_hopper_launch.restype = i
    lib.block_sparse_fc_hopper_launch.argtypes = [p] * 5 + [i] * 7 + [p]
    lib._bound = True
    return lib


def check_tiles(bm: int, bk: int, bn: int) -> None:
    """Raise ``ValueError`` unless the kernel can launch with these
    block and batch-tile sizes."""
    if bn not in BATCH_TILES:
        raise ValueError(f"bn={bn}: the kernel carries {BATCH_TILES} "
                         f"batch rows a block")
    if not (1 <= bm <= 1024 and bk >= 1):
        raise ValueError(f"block ({bm}, {bk}): bm is the threads of a "
                         f"block, 1..1024, and bk must be positive")


def fc_path(x: torch.Tensor, vals: torch.Tensor, bm: int, bk: int) -> str:
    """Which kernel takes x (N, K) against ``vals`` (nnzb, bm, bk) on the
    card, from the operands alone, before any launch.

    The tensor-core kernel computes in bf16 when both operands are bf16
    (``"wgmma"``) and in f32 otherwise (``"tf32x3"``, a bf16 operand of a
    mixed pair widened first).  It takes blocks of ``HOPPER_BM`` rows whose
    ``bk`` is a multiple of ``SLICE`` of that dtype, K with 16-byte rows,
    no dimension 0, sizes that fit its int32 indices and grid, and, for an
    operand it reads as given (not widened), a contiguous tensor whose
    data is 16-byte aligned, as a TMA tensor map needs.  Anything else
    takes ``"simt"``."""
    dt = BF16 if x.dtype == vals.dtype == BF16 else F32
    n, k = x.shape
    nnzb = vals.shape[0]
    size = 2 if dt == BF16 else 4
    tiles = bm == HOPPER_BM and bk > 0 and bk % SLICE[dt] == 0
    sizes = min(n, k, nnzb) > 0 and (k * size) % 16 == 0 \
        and max(n, k, nnzb) <= _INT_MAX \
        and -(-n // HOPPER_ROWS) <= _GRID_Y_MAX
    tma = all(t.is_contiguous() and t.data_ptr() % 16 == 0
              for t in (x, vals) if t.dtype == dt)
    if tiles and sizes and tma:
        return "wgmma" if dt == BF16 else "tf32x3"
    return "simt"


def _check_bundle(x, vals, row_ptr, m: int, bm: int, bk: int, bn: int):
    check_tiles(bm, bk, bn)
    if x.dim() != 2 or vals.dim() != 3 or tuple(vals.shape[1:]) != (bm, bk):
        raise ValueError(f"x {tuple(x.shape)} and vals {tuple(vals.shape)} "
                         f"do not fit blocks of ({bm}, {bk})")
    nbr = row_ptr.numel() - 1
    if nbr != -(-m // bm):
        raise ValueError(f"row_ptr has {nbr} row-blocks; m={m} needs "
                         f"{-(-m // bm)}")


def block_sparse_matvec(x: torch.Tensor, vals: torch.Tensor,
                        row_ptr: torch.Tensor, col_idx: torch.Tensor,
                        m: int, *, bm: int, bk: int,
                        bn: int = 8) -> torch.Tensor:
    """y (N, m) = x (N, K) @ W^T where W is the block-CSR bundle
    (``vals`` (nnzb, bm, bk), ``row_ptr`` (ceil(m / bm) + 1,), ``col_idx``
    (nnzb,)), columns of W past K being zero; in x's dtype, summed in f32.

    CPU tensors take :func:`block_sparse_matvec_plain`; CUDA tensors (f32
    or bf16 x and values, int32 indices) launch the kernel that
    :func:`fc_path` names on the current stream (the CUDA-core one with
    ``bn`` batch rows a block), and count the launch in
    ``block_sparse_matvec.launches`` and, by kernel, in
    ``block_sparse_matvec.launches_by_path``."""
    _check_bundle(x, vals, row_ptr, m, bm, bk, bn)
    if x.device.type == "cpu":
        return block_sparse_matvec_plain(x, vals, row_ptr, col_idx, m,
                                         bm=bm, bk=bk)
    _check_cuda(x, vals, row_ptr, col_idx)
    return _run(x, vals, row_ptr, col_idx, m, fc_path(x, vals, bm, bk),
                bm, bk, bn)


def launch(x: torch.Tensor, vals: torch.Tensor, row_ptr: torch.Tensor,
           col_idx: torch.Tensor, m: int, path: str, *, bm: int, bk: int,
           bn: int = 8) -> torch.Tensor:
    """Launch kernel ``path`` (``"wgmma"``, ``"tf32x3"`` or ``"simt"``) on
    CUDA tensors and count it.  :func:`block_sparse_matvec` takes the path
    from :func:`fc_path`; naming ``"simt"`` for operands the tensor-core
    kernel takes runs the CUDA-core kernel on them, as timing the two side
    by side needs.  Operands are widened to the path's dtype where they
    differ from it, and the output is rounded once to x's dtype."""
    _check_bundle(x, vals, row_ptr, m, bm, bk, bn)
    _check_cuda(x, vals, row_ptr, col_idx)
    if path not in _wrapper.launches_by_path:
        raise ValueError(f"no block-sparse kernel {path!r}")
    if path != "simt" and fc_path(x, vals, bm, bk) != path:
        raise ValueError(f"the {path} kernel does not take x {x.dtype} "
                         f"{tuple(x.shape)} with vals {vals.dtype} "
                         f"{tuple(vals.shape)}")
    return _run(x, vals, row_ptr, col_idx, m, path, bm, bk, bn)


def _check_cuda(x, vals, row_ptr, col_idx) -> None:
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"block_sparse_matvec runs on CUDA or CPU "
                         f"tensors, got {device}")
    _launch.check_input("x", x, device, DTYPES, 2)
    _launch.check_input("vals", vals, device, DTYPES, 3)
    _launch.check_input("row_ptr", row_ptr, device, (I32,), 1)
    _launch.check_input("col_idx", col_idx, device, (I32,), 1)
    if col_idx.numel() != vals.shape[0]:
        raise ValueError(f"col_idx has {col_idx.numel()} entries for "
                         f"{vals.shape[0]} blocks")


def _run(x, vals, row_ptr, col_idx, m: int, path: str, bm: int, bk: int,
         bn: int) -> torch.Tensor:
    """Launch ``path`` on checked CUDA operands and count it."""
    device = x.device
    n, k = x.shape
    nbr = row_ptr.numel() - 1
    if max(n, k, m) > _INT_MAX or (path == "simt"
                                   and -(-n // bn) > _GRID_Y_MAX):
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid at "
                         f"bn={bn}")
    dt = PATH_DTYPE[path]
    xk = x if x.dtype == dt else x.to(dt)
    vk = vals if vals.dtype == dt else vals.to(dt)
    y = torch.empty((n, m), dtype=dt, device=device)
    if y.numel():
        lib = _library()
        with torch.cuda.device(device):
            if path == "simt":
                err = lib.block_sparse_fc_launch(
                    xk.data_ptr(), vk.data_ptr(), row_ptr.data_ptr(),
                    col_idx.data_ptr(), y.data_ptr(), n, k, m, nbr, bm, bk,
                    bn, _launch.stream(device))
            else:
                err = lib.block_sparse_fc_hopper_launch(
                    xk.data_ptr(), vk.data_ptr(), row_ptr.data_ptr(),
                    col_idx.data_ptr(), y.data_ptr(), n, k, m, nbr,
                    vk.shape[0], bk, int(path == "tf32x3"),
                    _launch.stream(device))
        _launch.check_status(err, f"block_sparse_fc ({path})")
        _wrapper.launches += 1
        _wrapper.launches_by_path[path] += 1
    return y if y.dtype == x.dtype else y.to(x.dtype)


#: ``block_sparse_matvec.launches`` counts launches of the CUDA kernels
#: (calls that take the plain version do not count),
#: ``block_sparse_matvec.launches_by_path`` each kernel's, through this
#: alias.
_wrapper = block_sparse_matvec
block_sparse_matvec.launches = 0
block_sparse_matvec.launches_by_path = {"wgmma": 0, "tf32x3": 0, "simt": 0}
