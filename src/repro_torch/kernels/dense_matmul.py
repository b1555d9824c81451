"""Tiled dense matmul: the CUDA kernel ``csrc/dense_matmul.cu`` and its
plain PyTorch version.

The counterpart of the JAX package's Pallas kernel
``repro/kernels/dense_matmul.py:matmul``: there the K axis is the
innermost, sequential grid axis and each (bm, bn) output tile stays in a
f32 VMEM accumulator across it -- SONIC's loop-ordered accumulation, the
accumulator being the front buffer committed once per tile.  On the card
one thread block owns one output tile and loops over K itself, with the
accumulators in registers.  The kernel masks ragged edges, so unlike the
Pallas kernel it takes any M, K and N.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch
from .calibrate import (MATMUL_MAX_THREADS, SMEM_MAX_BYTES, TILE,
                        MatmulTiles)
from .ref import matmul_ref

DTYPES = (torch.float32, torch.bfloat16)
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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dense_matmul_launch.restype = i
    lib.dense_matmul_launch.argtypes = [p, p, p] + [i] * 7 + [p]
    lib._bound = True
    return lib


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


def matmul(x: torch.Tensor, w: torch.Tensor, *, bm: int, bk: int,
           bn: int) -> torch.Tensor:
    """x (M, K) @ w (K, N) in x's dtype, summed in f32.

    CPU tensors take the plain version (:func:`~.ref.matmul_ref`, which
    has no tiles); CUDA tensors launch the kernel with (bm, bk, bn) on the
    current stream, f32 or bf16, and count the launch in
    ``matmul.launches``.  Tiles the kernel cannot take raise
    ``ValueError`` on either device."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"cannot multiply {tuple(x.shape)} by "
                         f"{tuple(w.shape)}")
    check_tiles(bm, bk, bn, x.element_size())
    if w.device != x.device:
        raise ValueError(f"x is on {x.device} but w on {w.device}")
    if x.device.type == "cpu":
        return matmul_ref(x, w)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"matmul runs on CUDA or CPU tensors, got {device}")
    _launch.check_input("x", x, device, DTYPES, 2)
    _launch.check_input("w", w, device, (x.dtype,), 2)
    m, k = x.shape
    n = w.shape[1]
    if max(m, k, n) > _INT_MAX or -(-m // bm) > _GRID_Y_MAX:
        raise ValueError(f"({m}, {k}) @ ({k}, {n}) exceeds the kernel's "
                         f"grid at bm={bm}")
    out = torch.empty((m, n), dtype=x.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        err = lib.dense_matmul_launch(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, bm, bk, bn,
            int(x.dtype == torch.bfloat16), _launch.stream(device))
    _launch.check_status(err, "dense_matmul")
    _wrapper.launches += 1
    return out


#: ``matmul.launches`` counts launches of the CUDA kernel (calls that take
#: the plain version do not count).  The wrapper counts through this alias,
#: so a caller that wraps ``matmul`` still reads the count off the original.
_wrapper = matmul
matmul.launches = 0
