"""Tiled dense matmul: the CUDA kernels of ``csrc/dense_matmul.cu`` and
their plain PyTorch version.

The counterpart of the JAX package's Pallas kernel
``repro/kernels/dense_matmul.py:matmul``: there the K axis is the
innermost, sequential grid axis and each (bm, bn) output tile stays in a
f32 VMEM accumulator across it -- SONIC's loop-ordered accumulation, the
accumulator being the front buffer committed once per tile.  On the card
one thread block owns one output tile and loops over K itself, with the
accumulators in registers.  The kernels handle ragged edges, so unlike the
Pallas kernel they take any M, K and N.

Four kernels, chosen from the operands before the launch by
:func:`matmul_path`: ``"wgmma"``, bf16 on the tensor cores with its own
128 x 128 tiles fed by a TMA ring, and ``"tf32x3"``, f32 on the tensor
cores as 3xTF32 (each operand split into two tf32 parts, three products)
with the same tiles and K split over a cluster of CTAs where the tiles
are too few to fill the card (:func:`tf32x3_plan`), each for operands TMA
can read; ``"narrow"``, for the rest with N at most
:data:`NARROW_MAX_N` (MNIST's fc3, N = 10): a band of
:func:`narrow_plan` rows of x a CTA, so that the CTAs cover the card,
with x's and w's K slices streamed through shared memory and one output a
thread summed over K in order; ``"simt"``, the CUDA-core kernel at the
caller's tiles, for everything else (operands that are not contiguous,
or have N above that and K or N off a multiple of 8 for bf16 or of 4 for
f32, or misaligned).  The narrow kernel sums each output as the CUDA-core
kernel does (``fmaf`` over K in order from 0), so the two give the same
bits.  A pair of one f32 and one bf16 operand is computed as the JAX
package computes it, in f32: the bf16 operand is widened, an f32 kernel
runs, and the output is returned in x's dtype.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch

from . import _launch
from .calibrate import (MATMUL_MAX_THREADS, SMEM_MAX_BYTES, SMS, TILE,
                        MatmulTiles)
from .ref import matmul_ref

DTYPES = (torch.float32, torch.bfloat16)
#: The wgmma kernel's output tile edge (BM = BN).
WGMMA_TILE = 128
#: The tf32x3 kernel's output tile edge (BM = BN), its K slice (one
#: 128-byte row of f32) and the most CTAs of a cluster that split one
#: tile's K between them.
TF32X3_TILE = 128
TF32X3_SLICE = 32
TF32X3_MAX_SPLIT = 4
#: The narrow kernel's CTA (most threads, one output each; most rows of x;
#: most shared memory, two stages of K slices) and the widest N it takes
#: (csrc/dense_matmul.cu: NR_*).
NARROW_MAX_THREADS, NARROW_MAX_ROWS, NARROW_SMEM_MAX = 1024, 64, 96 * 1024
NARROW_KERNEL_MAX_N = 64
#: The widest N that :func:`matmul_path` sends to the narrow kernel: it
#: beat the CUDA-core kernel at every N timed, 1, 10, 16, 32 and 64 (M =
#: 1024, K = 500, f32; chip_smoke.py's ``narrow_sweep``, PERF.md).
NARROW_MAX_N = 64
_INT_MAX = 2**31 - 1
_GRID_Y_MAX = 65535


def _library():
    """Build (first use) and bind the kernel's C entry point."""
    from . import _build

    lib = _build.load("dense_matmul").lib
    if getattr(lib, "_bound", False):
        return lib
    for fn in (lib.dense_matmul_tile, lib.dense_matmul_max_threads):
        fn.restype, fn.argtypes = ctypes.c_int, []
    if (lib.dense_matmul_tile(), lib.dense_matmul_max_threads()) != \
            (TILE, MATMUL_MAX_THREADS):
        raise RuntimeError("csrc/dense_matmul.cu was built for another "
                           "micro-tile than calibrate.py's")
    for fn in (lib.dense_matmul_wgmma_tile, lib.dense_matmul_tf32x3_tile,
               lib.dense_matmul_tf32x3_slice,
               lib.dense_matmul_tf32x3_max_split,
               lib.dense_matmul_narrow_shape, lib.dense_matmul_narrow_max_n):
        fn.restype, fn.argtypes = ctypes.c_int, []
    if lib.dense_matmul_wgmma_tile() != WGMMA_TILE:
        raise RuntimeError("csrc/dense_matmul.cu was built for another "
                           "wgmma tile than dense_matmul.py's")
    if (lib.dense_matmul_tf32x3_tile(), lib.dense_matmul_tf32x3_slice(),
            lib.dense_matmul_tf32x3_max_split()) != \
            (TF32X3_TILE, TF32X3_SLICE, TF32X3_MAX_SPLIT):
        raise RuntimeError("csrc/dense_matmul.cu was built for another "
                           "tf32x3 tile, slice or split than "
                           "dense_matmul.py's")
    shape = lib.dense_matmul_narrow_shape()
    if ((shape & 2047, shape >> 11 & 127, (shape >> 18) * 1024),
            lib.dense_matmul_narrow_max_n()) != \
            ((NARROW_MAX_THREADS, NARROW_MAX_ROWS, NARROW_SMEM_MAX),
             NARROW_KERNEL_MAX_N):
        raise RuntimeError("csrc/dense_matmul.cu was built for another "
                           "narrow kernel than dense_matmul.py's")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_matmul_launch.restype = i
    lib.dense_matmul_launch.argtypes = [p, p, p] + [i] * 7 + [p]
    lib.dense_matmul_wgmma_launch.restype = i
    lib.dense_matmul_wgmma_launch.argtypes = [p, p, p] + [i] * 3 + [p]
    lib.dense_matmul_tf32x3_launch.restype = i
    lib.dense_matmul_tf32x3_launch.argtypes = [p, p, p] + [i] * 4 + [p]
    lib.dense_matmul_narrow_launch.restype = i
    lib.dense_matmul_narrow_launch.argtypes = [p, p, p] + [i] * 6 + [p]
    lib._bound = True
    return lib


#: The tensor-core kernel of each dtype, and the multiple of 16 bytes that
#: K and N must be in that dtype.
_TMA_PATHS = {torch.bfloat16: ("wgmma", 8), torch.float32: ("tf32x3", 4)}


def matmul_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel takes x @ w on the card: ``"wgmma"`` when both are bf16
    and ``"tf32x3"`` when both are f32, each only if both are contiguous
    and 16-byte aligned with K and N spanning a multiple of 16 bytes (8
    bf16, 4 f32) and no dimension 0 (what a TMA tensor map reads); else
    ``"narrow"`` when the narrow kernel takes them (:func:`narrow_takes`)
    and N is at most :data:`NARROW_MAX_N`; else ``"simt"``.  Decided from
    the operands alone, before any launch."""
    path, mult = _TMA_PATHS.get(x.dtype, ("simt", 0))
    m, k = x.shape
    n = w.shape[1]
    if mult and w.dtype == x.dtype and m and k and n \
            and k % mult == 0 and n % mult == 0 \
            and x.is_contiguous() and w.is_contiguous() \
            and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0:
        return path
    if n <= NARROW_MAX_N and k and narrow_takes(x, w):
        return "narrow"
    return "simt"


def narrow_takes(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether the narrow kernel can take x @ w: both f32 or both bf16,
    contiguous, M and N at least 1 and N at most
    :data:`NARROW_KERNEL_MAX_N`."""
    return x.dtype in DTYPES and w.dtype == x.dtype and x.shape[0] >= 1 \
        and 1 <= w.shape[1] <= NARROW_KERNEL_MAX_N \
        and x.is_contiguous() and w.is_contiguous()


class NarrowPlan(NamedTuple):
    """How the narrow kernel covers a product: ``bm`` rows of x a CTA (a
    thread an output) and K in slices of ``bk``."""
    bm: int
    bk: int


@functools.lru_cache(maxsize=256)
def narrow_plan(m: int, k: int, n: int, size: int) -> NarrowPlan:
    """The narrow kernel's plan for (m, k) @ (k, n) of ``size``-byte
    elements.  ``bm``: few enough rows that the CTAs cover :data:`SMS` SMs
    in one wave, at most :data:`NARROW_MAX_ROWS` and
    ``NARROW_MAX_THREADS // n``.  ``bk``: as long as two stages of (bm +
    n) x bk elements (x's slice rows padded by one) fit in
    :data:`NARROW_SMEM_MAX`, and no longer than K: each slice costs a
    round trip to memory.  MNIST's fc3, 1024 x 500 x 10 f32: 8 rows (80
    threads, 128 CTAs) and all of K in one slice."""
    bm = max(1, min(-(-m // SMS), NARROW_MAX_ROWS, NARROW_MAX_THREADS // n))
    fit = (NARROW_SMEM_MAX // (2 * size) - bm) // (bm + n)
    return NarrowPlan(bm, max(1, min(k, fit)))


class Tf32x3Plan(NamedTuple):
    """How the tf32x3 kernel covers a product: (bm, bn) output tiles, and
    K split over ``split`` CTAs of a cluster for each tile."""
    bm: int
    bn: int
    split: int

    def ctas(self, m: int, n: int) -> int:
        return -(-m // self.bm) * -(-n // self.bn) * self.split


@functools.lru_cache(maxsize=256)
def tf32x3_plan(m: int, k: int, n: int) -> Tf32x3Plan:
    """The tf32x3 kernel's tiles and split for (m, k) @ (k, n), from the
    shape alone: 128 x 128 output tiles, and K split the most ways of 4,
    2 and 1 that keeps the grid within one wave of :data:`SMS` CTAs (one
    CTA an SM) and leaves every CTA a 32-wide K slice.  At 512 x 1024 x 768
    the 24 tiles take a split of 4 (96 CTAs); at 4096^3 the 1,024 tiles
    take none."""
    plan = Tf32x3Plan(TF32X3_TILE, TF32X3_TILE, 1)
    slices = -(-k // TF32X3_SLICE)
    split = TF32X3_MAX_SPLIT
    while split > 1:
        per = -(-slices // split)
        if plan._replace(split=split).ctas(m, n) <= SMS \
                and (split - 1) * per < slices:
            return plan._replace(split=split)
        split //= 2
    return plan


@functools.lru_cache(maxsize=256)
def check_tiles(bm: int, bk: int, bn: int, bytes_per_el: int) -> None:
    """Raise ``ValueError`` unless the kernel can launch with these tiles."""
    t = MatmulTiles(bm, bk, bn)
    if min(bm, bk, bn) < 1 or bm % TILE or bn % TILE:
        raise ValueError(f"tiles {t}: bm and bn must be positive multiples "
                         f"of {TILE} and bk positive")
    if t.threads > MATMUL_MAX_THREADS:
        raise ValueError(f"tiles {t} need {t.threads} threads a block, "
                         f"more than {MATMUL_MAX_THREADS}")
    if t.working_set(bytes_per_el) > SMEM_MAX_BYTES:
        raise ValueError(f"tiles {t} need {t.working_set(bytes_per_el)} "
                         f"bytes of shared memory, more than "
                         f"{SMEM_MAX_BYTES}")


def _check_operands(x, w, bm: int, bk: int, bn: int) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"cannot multiply {tuple(x.shape)} by "
                         f"{tuple(w.shape)}")
    check_tiles(bm, bk, bn, max(x.element_size(), w.element_size()))
    if w.device != x.device:
        raise ValueError(f"x is on {x.device} but w on {w.device}")


def matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int, bk: int,
           bn: int) -> torch.Tensor:
    """x (M, K) @ w (K, N) in x's dtype, summed in f32.

    CPU tensors take the plain version (:func:`~.ref.matmul_ref`, which
    has no tiles); CUDA tensors, f32 or bf16, launch the kernel that
    :func:`matmul_path` names on the current stream: a tensor-core kernel
    with its own tiles (the tf32x3 one split as :func:`tf32x3_plan` says),
    the narrow kernel with its own bands (:func:`narrow_plan`), or the
    CUDA-core kernel with (bm, bk, bn).  A pair of one f32 and one
    bf16 operand runs an f32 kernel on the bf16 one widened, its output
    rounded once to x's dtype.  Launches are counted in
    ``matmul.launches`` and, by kernel, in ``matmul.launches_by_path``.
    Tiles the CUDA-core kernel cannot take (at the wider operand's size)
    raise ``ValueError`` on either device and on every path."""
    _check_operands(x, w, bm, bk, bn)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    _check_cuda(x)
    if x.dtype != w.dtype and {x.dtype, w.dtype} <= set(DTYPES):
        x32, w32 = x.float(), w.float()
        return _run(x32, w32, matmul_path(x32, w32), bm, bk, bn).to(x.dtype)
    return _run(x, w, matmul_path(x, w), bm, bk, bn)


def launch(x: torch.Tensor, w: torch.Tensor, path: str, *, bm: int = 128,
           bk: int = 64, bn: int = 128) -> torch.Tensor:
    """Launch kernel ``path`` (``"wgmma"``, ``"tf32x3"``, ``"narrow"`` or
    ``"simt"``) on CUDA tensors and count it.  :func:`matmul` takes the
    path from :func:`matmul_path`; naming ``"simt"`` for operands another
    kernel takes runs the CUDA-core kernel on them, and naming
    ``"narrow"`` runs the narrow kernel on any operands it can take
    (:func:`narrow_takes`), as timing two kernels side by side needs."""
    _check_operands(x, w, bm, bk, bn)
    _check_cuda(x)
    if path not in _wrapper.launches_by_path:
        raise ValueError(f"no matmul kernel {path!r}")
    if path == "narrow" and not narrow_takes(x, w):
        raise ValueError(f"the narrow kernel does not take {x.dtype} "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    if path not in ("simt", "narrow") and matmul_path(x, w) != path:
        raise ValueError(f"the {path} kernel does not take {x.dtype} "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    return _run(x, w, path, bm, bk, bn)


def _check_cuda(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or CPU tensors, got "
                         f"{x.device}")


def _run(x, w, path: str, bm: int, bk: int, bn: int) -> torch.Tensor:
    """Launch kernel ``path`` on CUDA operands whose shapes and tiles are
    checked and that it takes, once dtypes and layouts are checked too."""
    device = x.device
    _launch.check_input("x", x, device, DTYPES, 2)
    _launch.check_input("w", w, device, (x.dtype,), 2)
    m, k = x.shape
    n = w.shape[1]
    rows = {"wgmma": WGMMA_TILE, "tf32x3": TF32X3_TILE}.get(path, bm)
    if max(m, k, n) > _INT_MAX or \
            (path != "narrow" and -(-m // rows) > _GRID_Y_MAX):
        raise ValueError(f"({m}, {k}) @ ({k}, {n}) exceeds the kernel's "
                         f"grid")
    out = x.new_empty((m, n))
    if out.numel() == 0:
        return out
    lib = _library()
    # torch.cuda.device costs microseconds a call: enter it only to switch
    with contextlib.nullcontext() \
            if device.index == torch._C._cuda_getDevice() \
            else torch.cuda.device(device):
        if path == "wgmma":
            err = lib.dense_matmul_wgmma_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                _launch.stream(device))
        elif path == "tf32x3":
            err = lib.dense_matmul_tf32x3_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                tf32x3_plan(m, k, n).split, _launch.stream(device))
        elif path == "narrow":
            plan = narrow_plan(m, k, n, x.element_size())
            err = lib.dense_matmul_narrow_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
                plan.bm, plan.bk, int(x.dtype == torch.bfloat16),
                _launch.stream(device))
        else:
            err = lib.dense_matmul_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, bm, bk,
                bn, int(x.dtype == torch.bfloat16), _launch.stream(device))
    _launch.check_status(err, f"dense_matmul ({path})")
    _wrapper.launches += 1
    _wrapper.launches_by_path[path] += 1
    return out


#: ``matmul.launches`` counts launches of the CUDA kernels (calls that take
#: the plain version do not count), ``matmul.launches_by_path`` each
#: kernel's.  The wrapper counts through this alias, so a caller that wraps
#: ``matmul`` still reads the counts off the original.
_wrapper = matmul
matmul.launches = 0
matmul.launches_by_path = {"wgmma": 0, "tf32x3": 0, "narrow": 0, "simt": 0}
