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

Two kernels, chosen from the operands before the launch by
:func:`matmul_path`: ``"wgmma"``, bf16 on the tensor cores with its own
128 x 128 tiles fed by a TMA ring, for operands TMA can read; ``"simt"``,
the CUDA-core kernel at the caller's tiles, for everything else (f32, or
bf16 that is misaligned or has K or N off a multiple of 8).  A pair of
one f32 and one bf16 operand is computed as the JAX package computes it,
in f32: the bf16 operand is widened, the f32 kernel runs, and the output
is returned in x's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch
from .calibrate import (MATMUL_MAX_THREADS, SMEM_MAX_BYTES, TILE,
                        MatmulTiles)
from .ref import matmul_ref

DTYPES = (torch.float32, torch.bfloat16)
#: The wgmma kernel's output tile edge (BM = BN).
WGMMA_TILE = 128
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
    lib.dense_matmul_wgmma_tile.restype = ctypes.c_int
    lib.dense_matmul_wgmma_tile.argtypes = []
    if lib.dense_matmul_wgmma_tile() != WGMMA_TILE:
        raise RuntimeError("csrc/dense_matmul.cu was built for another "
                           "wgmma tile than dense_matmul.py's")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_matmul_launch.restype = i
    lib.dense_matmul_launch.argtypes = [p, p, p] + [i] * 7 + [p]
    lib.dense_matmul_wgmma_launch.restype = i
    lib.dense_matmul_wgmma_launch.argtypes = [p, p, p] + [i] * 3 + [p]
    lib._bound = True
    return lib


def matmul_path(x: torch.Tensor, w: torch.Tensor) -> str:
    """Which kernel takes x @ w on the card: ``"wgmma"`` when both are bf16,
    contiguous and 16-byte aligned with K and N multiples of 8 and no
    dimension 0 (what a TMA tensor map reads), else ``"simt"``.  Decided
    from the operands alone, before any launch."""
    m, k = x.shape
    n = w.shape[1]
    tma = all(t.dtype == torch.bfloat16 and t.is_contiguous()
              and t.data_ptr() % 16 == 0 for t in (x, w))
    if tma and min(m, k, n) > 0 and k % 8 == 0 and n % 8 == 0:
        return "wgmma"
    return "simt"


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
    :func:`matmul_path` names on the current stream: the wgmma kernel with
    its own tiles, or the CUDA-core kernel with (bm, bk, bn).  A pair of
    one f32 and one bf16 operand runs the f32 kernel on the bf16 one
    widened, its output rounded once to x's dtype.  Launches are counted
    in ``matmul.launches`` and, by kernel, in ``matmul.launches_by_path``.
    Tiles the CUDA-core kernel cannot take (at the wider operand's size)
    raise ``ValueError`` on either device and on either path."""
    _check_operands(x, w, bm, bk, bn)
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    if x.dtype != w.dtype and {x.dtype, w.dtype} <= set(DTYPES):
        x32, w32 = x.float(), w.float()
        return launch(x32, w32, matmul_path(x32, w32), bm=bm, bk=bk,
                      bn=bn).to(x.dtype)
    return launch(x, w, matmul_path(x, w), bm=bm, bk=bk, bn=bn)


def launch(x: torch.Tensor, w: torch.Tensor, path: str, *, bm: int = 128,
           bk: int = 64, bn: int = 128) -> torch.Tensor:
    """Launch kernel ``path`` (``"wgmma"`` or ``"simt"``) on CUDA tensors
    and count it.  :func:`matmul` takes the path from :func:`matmul_path`;
    naming ``"simt"`` for operands the wgmma kernel takes runs the
    CUDA-core kernel on them, as timing the two side by side needs."""
    _check_operands(x, w, bm, bk, bn)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or CPU tensors, got {device}")
    _launch.check_input("x", x, device, DTYPES, 2)
    _launch.check_input("w", w, device, (x.dtype,), 2)
    if path not in _wrapper.launches_by_path:
        raise ValueError(f"no matmul kernel {path!r}")
    if path == "wgmma" and matmul_path(x, w) != "wgmma":
        raise ValueError(f"the wgmma kernel does not take {x.dtype} "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    rows = WGMMA_TILE if path == "wgmma" else bm
    if max(m, k, n) > _INT_MAX or -(-m // rows) > _GRID_Y_MAX:
        raise ValueError(f"({m}, {k}) @ ({k}, {n}) exceeds the kernel's "
                         f"grid")
    out = torch.empty((m, n), dtype=x.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        if path == "wgmma":
            err = lib.dense_matmul_wgmma_launch(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n,
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
matmul.launches_by_path = {"wgmma": 0, "simt": 0}
