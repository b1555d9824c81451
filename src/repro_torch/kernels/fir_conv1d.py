"""Depthwise 1-D FIR: the CUDA kernel ``csrc/fir_conv1d.cu`` and its plain
PyTorch version (the TAILS FIR-DTC analogue).

LEA's FIR-DTC primitive computes a K-tap convolution over a DMA'd vector;
TAILS composes 2-D/3-D convolutions by iterating 1-D FIRs and accumulating
(Sec. 7.2): iterate (ci, dy), accumulate.  The JAX package's Pallas kernel
holds whole rows of a block of channels; on the card a thread block covers
a block of channels x output positions, so rows are tiled too
(:func:`~.calibrate.fir_tiles` and :func:`~.calibrate.fir_width`).  The
taps are summed in order t = 0 .. K-1 with one rounding per multiply and
per add, so the kernel is bitwise equal to its plain version,
:func:`~.ref.fir_conv1d_ref`.  As in the JAX package, x and the taps may be
f32 or bf16: the kernel widens bf16 as it reads it and rounds a bf16
output once.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch
from .calibrate import FIR_TAP_SLICE, FIR_THREADS, fir_width
from .ref import fir_conv1d_ref

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = (F32, BF16)
_INT_MAX = 2**31 - 1
_GRID_Y_MAX = 65535


def _library():
    """Build (first use) and bind the kernel's C entry point."""
    from . import _build

    lib = _build.load("fir_conv1d").lib
    if getattr(lib, "_bound", False):
        return lib
    lib.fir_conv1d_tap_slice.restype = ctypes.c_int
    lib.fir_conv1d_tap_slice.argtypes = []
    if lib.fir_conv1d_tap_slice() != FIR_TAP_SLICE:
        raise RuntimeError("csrc/fir_conv1d.cu was built for another tap "
                           "slice than calibrate.py's")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fir_conv1d_launch.restype = i
    lib.fir_conv1d_launch.argtypes = [p, p, p, ctypes.c_longlong] + \
        [i] * 6 + [p]
    lib._bound = True
    return lib


def fir_conv1d(x: torch.Tensor, taps: torch.Tensor, *,
               cb: int) -> torch.Tensor:
    """Depthwise 'valid' FIR: x (C, L), taps (C, K) -> (C, L-K+1), in x's
    dtype.

    CPU tensors take the plain version; CUDA tensors (f32 or bf16, each
    of x and the taps) launch the kernel on the current stream with blocks
    of ``cb`` channels x :func:`~.calibrate.fir_width` positions, and count
    the launch in ``fir_conv1d.launches``."""
    if x.dim() != 2 or taps.dim() != 2 or x.shape[0] != taps.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and taps {tuple(taps.shape)} "
                         f"must be (C, L) and (C, K)")
    c, length = x.shape
    k = taps.shape[1]
    if not 1 <= k <= length:
        raise ValueError(f"need 1 <= K <= L, got K={k}, L={length}")
    tw = fir_width(length)
    if not 1 <= cb <= FIR_THREADS // tw:
        raise ValueError(f"cb={cb}: a block of {tw} positions takes 1 to "
                         f"{FIR_THREADS // tw} channels")
    if taps.device != x.device:
        raise ValueError(f"x is on {x.device} but taps on {taps.device}")
    if x.device.type == "cpu":
        return fir_conv1d_ref(x, taps)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"fir_conv1d runs on CUDA or CPU tensors, got "
                         f"{device}")
    _launch.check_input("x", x, device, DTYPES, 2)
    _launch.check_input("taps", taps, device, DTYPES, 2)
    out_len = length - k + 1
    if length > _INT_MAX or -(-out_len // tw) > _GRID_Y_MAX \
            or -(-c // cb) > _INT_MAX:
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid")
    out = torch.empty((c, out_len), dtype=x.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        err = lib.fir_conv1d_launch(x.data_ptr(), taps.data_ptr(),
                                    out.data_ptr(), c, length, k, cb, tw,
                                    int(x.dtype == BF16),
                                    int(taps.dtype == BF16),
                                    _launch.stream(device))
    _launch.check_status(err, "fir_conv1d")
    _wrapper.launches += 1
    return out


#: ``fir_conv1d.launches`` counts launches of the CUDA kernel (calls that
#: take the plain version do not count), through this alias.
_wrapper = fir_conv1d
fir_conv1d.launches = 0
