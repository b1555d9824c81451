"""Mamba2 SSD intra-chunk cell: the CUDA kernel ``csrc/ssd_intra.cu`` and
its plain PyTorch version (:func:`~.ref.ssd_intra_ref`).

The counterpart of the JAX package's Pallas kernel
``repro/kernels/ssd_intra.py:ssd_intra``: per (batch*chunk, head) cell,
``G = C B^T``, the masked decay ``M = G * exp(cs_i - cs_j)`` for j <= i,
``y = M (x dt)`` and the chunk state ``S = B^T (exp(cs_Q - cs) * x dt)``,
with the (Q, Q) decay matrix kept out of HBM.  On the card a cell is cut
into 64-row tiles of y and of S, one thread block each (see the source),
and the exponential of a masked pair, which overflows at realistic chunk
lengths, is never evaluated.  Each input may be f32 or bf16, as in the
JAX package; y and S are f32.  No model of either package calls it: it is
reached through the ``kernels`` entry point.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch
from .ref import ssd_intra_ref

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = (F32, BF16)
#: The kernel's tile edge (rows of y and S a block owns, columns of P).
TILE = 64
_INT_MAX = 2**31 - 1
_GRID_YZ_MAX = 65535


def _library():
    """Build (first use) and bind the kernel's C entry point."""
    from . import _build

    lib = _build.load("ssd_intra").lib
    if getattr(lib, "_bound", False):
        return lib
    lib.ssd_intra_tile.restype, lib.ssd_intra_tile.argtypes = ctypes.c_int, []
    if lib.ssd_intra_tile() != TILE:
        raise RuntimeError("csrc/ssd_intra.cu was built for another tile "
                           "than ssd_intra.py's")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra_launch.restype = i
    lib.ssd_intra_launch.argtypes = [p] * 6 + [ctypes.c_longlong] + \
        [i] * 5 + [p]
    lib._bound = True
    return lib


def ssd_intra(xdt: torch.Tensor, bb: torch.Tensor, cc: torch.Tensor,
              cs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xdt (BC, H, Q, P), bb/cc (BC, Q, N), cs (BC, H, Q), each f32 or
    bf16 -> (y (BC, H, Q, P), s (BC, H, N, P)) in f32, rounded as
    :func:`~.ref.ssd_intra_ref` says for a bf16 cs.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream and count the launch in ``ssd_intra.launches``.
    Nothing falls back."""
    if xdt.dim() != 4 or bb.dim() != 3 or cc.shape != bb.shape \
            or cs.dim() != 3:
        raise ValueError(f"expected xdt (BC, H, Q, P), bb/cc (BC, Q, N), cs "
                         f"(BC, H, Q); got {tuple(xdt.shape)}, "
                         f"{tuple(bb.shape)}, {tuple(cc.shape)}, "
                         f"{tuple(cs.shape)}")
    bc, h, q, p = xdt.shape
    n = bb.shape[2]
    if bb.shape[:2] != (bc, q) or cs.shape != (bc, h, q):
        raise ValueError(f"bb {tuple(bb.shape)} and cs {tuple(cs.shape)} do "
                         f"not match xdt {tuple(xdt.shape)}")
    if min(q, n, p) < 1:
        raise ValueError("Q, N and P must be at least 1")
    if not (xdt.device == bb.device == cc.device == cs.device):
        raise ValueError("xdt, bb, cc and cs must lie on one device")
    if xdt.device.type == "cpu":
        return ssd_intra_ref(xdt, bb, cc, cs)
    device = xdt.device
    if device.type != "cuda":
        raise ValueError(f"ssd_intra runs on CUDA or CPU tensors, got "
                         f"{device}")
    _launch.check_input("xdt", xdt, device, DTYPES, 4)
    _launch.check_input("bb", bb, device, DTYPES, 3)
    _launch.check_input("cc", cc, device, DTYPES, 3)
    _launch.check_input("cs", cs, device, DTYPES, 3)
    if bc * h > _INT_MAX or max(q * p, q * n, n * p) > _INT_MAX \
            or -(-q // TILE) + -(-n // TILE) > _GRID_YZ_MAX \
            or -(-p // TILE) > _GRID_YZ_MAX:
        raise ValueError(f"xdt {tuple(xdt.shape)} with N={n} exceeds the "
                         f"kernel's grid")
    y = torch.empty((bc, h, q, p), dtype=F32, device=device)
    s = torch.empty((bc, h, n, p), dtype=F32, device=device)
    if bc * h == 0:
        return y, s
    lib = _library()
    with torch.cuda.device(device):
        err = lib.ssd_intra_launch(xdt.data_ptr(), bb.data_ptr(),
                                   cc.data_ptr(), cs.data_ptr(), y.data_ptr(),
                                   s.data_ptr(), bc, h, q, n, p,
                                   sum(int(t.dtype == BF16) << i for i, t in
                                       enumerate((xdt, bb, cc, cs))),
                                   _launch.stream(device))
    _launch.check_status(err, "ssd_intra")
    _wrapper.launches += 1
    return y, s


#: ``ssd_intra.launches`` counts launches of the CUDA kernel (calls that
#: take the plain version do not count), through this alias.
_wrapper = ssd_intra
ssd_intra.launches = 0
