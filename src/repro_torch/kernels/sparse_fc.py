"""Block-sparse FC: the CUDA kernel ``csrc/sparse_fc.cu`` and its plain
PyTorch version (the GENESIS pruned-FC hot spot).

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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _launch
from .ref import block_sparse_matvec_ref

F32 = torch.float32
I32 = torch.int32
#: Batch rows one thread block carries (the kernel's instantiations).
BATCH_TILES = (1, 2, 4, 8, 16, 32)
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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.block_sparse_fc_launch.restype = i
    lib.block_sparse_fc_launch.argtypes = [p] * 5 + [i] * 7 + [p]
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


def block_sparse_matvec(x: torch.Tensor, vals: torch.Tensor,
                        row_ptr: torch.Tensor, col_idx: torch.Tensor,
                        m: int, *, bm: int, bk: int,
                        bn: int = 8) -> torch.Tensor:
    """y (N, m) = x (N, K) @ W^T where W is the block-CSR bundle
    (``vals`` (nnzb, bm, bk), ``row_ptr`` (ceil(m / bm) + 1,), ``col_idx``
    (nnzb,)), columns of W past K being zero.

    CPU tensors take :func:`block_sparse_matvec_plain`; CUDA tensors
    launch the kernel (f32 values, int32 indices) on the current stream
    with ``bn`` batch rows a block, and count the launch in
    ``block_sparse_matvec.launches``."""
    check_tiles(bm, bk, bn)
    if x.dim() != 2 or vals.dim() != 3 or tuple(vals.shape[1:]) != (bm, bk):
        raise ValueError(f"x {tuple(x.shape)} and vals {tuple(vals.shape)} "
                         f"do not fit blocks of ({bm}, {bk})")
    nbr = row_ptr.numel() - 1
    if nbr != -(-m // bm):
        raise ValueError(f"row_ptr has {nbr} row-blocks; m={m} needs "
                         f"{-(-m // bm)}")
    if x.device.type == "cpu":
        return block_sparse_matvec_plain(x, vals, row_ptr, col_idx, m,
                                         bm=bm, bk=bk)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"block_sparse_matvec runs on CUDA or CPU "
                         f"tensors, got {device}")
    _launch.check_input("x", x, device, (F32,), 2)
    _launch.check_input("vals", vals, device, (F32,), 3)
    _launch.check_input("row_ptr", row_ptr, device, (I32,), 1)
    _launch.check_input("col_idx", col_idx, device, (I32,), 1)
    if col_idx.numel() != vals.shape[0]:
        raise ValueError(f"col_idx has {col_idx.numel()} entries for "
                         f"{vals.shape[0]} blocks")
    n, k = x.shape
    if max(n, k, m) > _INT_MAX or -(-n // bn) > _GRID_Y_MAX:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid at "
                         f"bn={bn}")
    y = torch.empty((n, m), dtype=F32, device=device)
    if y.numel() == 0:
        return y
    lib = _library()
    with torch.cuda.device(device):
        err = lib.block_sparse_fc_launch(
            x.data_ptr(), vals.data_ptr(), row_ptr.data_ptr(),
            col_idx.data_ptr(), y.data_ptr(), n, k, m, nbr, bm, bk, bn,
            _launch.stream(device))
    _launch.check_status(err, "block_sparse_fc")
    _wrapper.launches += 1
    return y


#: ``block_sparse_matvec.launches`` counts launches of the CUDA kernel
#: (calls that take the plain version do not count), through this alias.
_wrapper = block_sparse_matvec
block_sparse_matvec.launches = 0
