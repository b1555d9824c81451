"""Depthwise 1-D FIR: the CUDA kernels of ``csrc/fir_conv1d.cu`` and their
plain PyTorch version (the TAILS FIR-DTC analogue).

LEA's FIR-DTC primitive computes a K-tap convolution over a DMA'd vector;
TAILS composes 2-D/3-D convolutions by iterating 1-D FIRs and accumulating
(Sec. 7.2): iterate (ci, dy), accumulate.  The JAX package's Pallas kernel
holds whole rows of a block of channels.  On the card two designs, chosen
by :func:`fir_path` before the launch:

* ``"flat"``: x and the output are contiguous, so a tile of consecutive
  outputs in flat order (:data:`FLAT_OUT_BYTES` of them) reads one contiguous
  span of x and one of the taps, whatever rows it spans; a persistent grid
  stages the spans of its tiles in shared memory, a tile ahead, so rows
  of 8 outputs and rows of 8,188 keep every thread live.  It takes a call
  of at least one tile an SM (:data:`FLAT_MIN_TILES`).
* ``"tiled"``, the first design: a thread block covers a block of channels
  x output positions (:func:`~.calibrate.fir_tiles` and
  :func:`~.calibrate.fir_width`), the taps staged in slices, so any K fits.

The taps are summed in order t = 0 .. K-1 with one rounding per multiply
and per add, so both kernels are bitwise equal to the plain version,
:func:`~.ref.fir_conv1d_ref`.  As in the JAX package, x and the taps may
be f32 or bf16: the kernels widen bf16 as they read it and round a bf16
output once.
"""

from __future__ import annotations

import ctypes

import torch

from . import _launch
from .calibrate import FIR_TAP_SLICE, FIR_THREADS, SMS, fir_width
from .ref import fir_conv1d_ref

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = (F32, BF16)
#: The flat design's tile, in bytes of output (2,048 f32 or 4,096 bf16
#: outputs), and a stage's input and tap spans in bytes, at most
#: (csrc/fir_conv1d.cu's FLAT_*).
FLAT_OUT_BYTES = 8192
FLAT_IN_BYTES, FLAT_TAP_BYTES = 14336, 6144
#: The fewest tiles :func:`fir_path` gives the flat design: one an SM.
#: With fewer, a CTA's first copy is not hidden behind another tile's sums
#: and the tiled design took less device time on the card (PERF.md).
FLAT_MIN_TILES = SMS
PATHS = ("flat", "tiled")
_INT_MAX = 2**31 - 1
_GRID_Y_MAX = 65535


def _library():
    """Build (first use) and bind the kernel's C entry points."""
    from . import _build

    lib = _build.load("fir_conv1d").lib
    if getattr(lib, "_bound", False):
        return lib
    for fn in (lib.fir_conv1d_tap_slice, lib.fir_conv1d_flat_shape):
        fn.restype, fn.argtypes = ctypes.c_int, []
    if lib.fir_conv1d_tap_slice() != FIR_TAP_SLICE:
        raise RuntimeError("csrc/fir_conv1d.cu was built for another tap "
                           "slice than calibrate.py's")
    if lib.fir_conv1d_flat_shape() != FLAT_OUT_BYTES \
            | (FLAT_IN_BYTES // 1024) << 16 | (FLAT_TAP_BYTES // 1024) << 24:
        raise RuntimeError("csrc/fir_conv1d.cu was built for another flat "
                           "tile than fir_conv1d.py's")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fir_conv1d_launch.restype = i
    lib.fir_conv1d_launch.argtypes = [p, p, p, ctypes.c_longlong] + \
        [i] * 6 + [p]
    lib.fir_conv1d_flat_launch.restype = i
    lib.fir_conv1d_flat_launch.argtypes = [p, p, p, ctypes.c_longlong] + \
        [i] * 5 + [p]
    lib._bound = True
    return lib


def flat_fits(length: int, k: int, x_size: int, taps_size: int) -> bool:
    """Whether every tile of the flat design fits its stage at this row
    length and K (element sizes in bytes): a tile's T outputs cross at most
    (T + L - K - 1) / (L - K + 1) row ends, each adding K - 1 input words to
    the span and a row of taps, and each span is rounded out to 16 bytes."""
    t, lo = FLAT_OUT_BYTES // x_size, length - k + 1
    rows = (t + lo - 2) // lo
    return ((t + k - 1 + rows * (k - 1)) * x_size + 32 <= FLAT_IN_BYTES
            and (rows + 1) * k * taps_size + 32 <= FLAT_TAP_BYTES)


def flat_takes(x: torch.Tensor, taps: torch.Tensor) -> bool:
    """Whether the flat kernel can take x (C, L) with taps (C, K): both
    contiguous and starting on a 16-byte boundary (its copies are 16
    bytes), and every tile's spans fit its stage (:func:`flat_fits`)."""
    length, k = x.shape[1], taps.shape[1]
    return all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, taps)) and 1 <= k <= length \
        and flat_fits(length, k, x.element_size(), taps.element_size())


def flat_tiles(c: int, length: int, k: int, x_size: int) -> int:
    """The flat design's tiles for C rows of L (x elements of ``x_size``
    bytes) and K taps."""
    t = FLAT_OUT_BYTES // x_size
    return -(-c * (length - k + 1) // t)


def fir_path(x: torch.Tensor, taps: torch.Tensor) -> str:
    """Which kernel takes x (C, L) with taps (C, K) on the card, from the
    operands alone, before any launch: ``"flat"`` where it can
    (:func:`flat_takes`) and has at least :data:`FLAT_MIN_TILES` tiles;
    else ``"tiled"``, the first design."""
    c, length = x.shape
    if flat_takes(x, taps) and flat_tiles(c, length, taps.shape[1],
                                          x.element_size()) >= FLAT_MIN_TILES:
        return "flat"
    return "tiled"


def _check(x, taps, cb: int) -> None:
    if x.dim() != 2 or taps.dim() != 2 or x.shape[0] != taps.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and taps {tuple(taps.shape)} "
                         f"must be (C, L) and (C, K)")
    length, k = x.shape[1], taps.shape[1]
    if not 1 <= k <= length:
        raise ValueError(f"need 1 <= K <= L, got K={k}, L={length}")
    tw = fir_width(length)
    if not 1 <= cb <= FIR_THREADS // tw:
        raise ValueError(f"cb={cb}: a block of {tw} positions takes 1 to "
                         f"{FIR_THREADS // tw} channels")
    if taps.device != x.device:
        raise ValueError(f"x is on {x.device} but taps on {taps.device}")


def fir_conv1d(x: torch.Tensor, taps: torch.Tensor, *,
               cb: int) -> torch.Tensor:
    """Depthwise 'valid' FIR: x (C, L), taps (C, K) -> (C, L-K+1), in x's
    dtype.

    CPU tensors take the plain version; CUDA tensors (f32 or bf16, each
    of x and the taps) launch the kernel :func:`fir_path` names on the
    current stream (the tiled one with blocks of ``cb`` channels x
    :func:`~.calibrate.fir_width` positions) and count the launch in
    ``fir_conv1d.launches`` and ``fir_conv1d.launches_by_path``."""
    _check(x, taps, cb)
    if x.device.type == "cpu":
        return fir_conv1d_ref(x, taps)
    _check_cuda(x, taps)
    return _run(x, taps, fir_path(x, taps), cb)


def launch(x: torch.Tensor, taps: torch.Tensor, path: str, *,
           cb: int = 1, looped: bool = False) -> torch.Tensor:
    """Launch kernel ``path`` (:data:`PATHS`) on CUDA tensors and count it,
    as timing the two designs side by side needs; ``"flat"`` runs any
    operands it can take (:func:`flat_takes`), also below
    :data:`FLAT_MIN_TILES`, and is refused on others.  ``looped``: the flat
    kernel's instantiation that loops over any K, also for K = 5, which
    has one of its own with the sum unrolled (timed beside it)."""
    _check(x, taps, cb)
    _check_cuda(x, taps)
    if path not in PATHS:
        raise ValueError(f"no FIR kernel {path!r}; the kernels are {PATHS}")
    if path == "flat" and not flat_takes(x, taps):
        raise ValueError(f"the flat kernel does not take x {x.dtype} "
                         f"{tuple(x.shape)} with taps {tuple(taps.shape)}")
    return _run(x, taps, path, cb, looped)


def _check_cuda(x, taps) -> None:
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"fir_conv1d runs on CUDA or CPU tensors, got "
                         f"{device}")
    _launch.check_input("x", x, device, DTYPES, 2)
    _launch.check_input("taps", taps, device, DTYPES, 2)


def _run(x, taps, path: str, cb: int, looped: bool = False) -> torch.Tensor:
    """Launch ``path`` on checked CUDA operands and count it."""
    device = x.device
    c, length = x.shape
    k = taps.shape[1]
    out_len = length - k + 1
    tw = fir_width(length)
    if length > _INT_MAX or (path == "tiled" and (
            -(-out_len // tw) > _GRID_Y_MAX or -(-c // cb) > _INT_MAX)):
        raise ValueError(f"x {tuple(x.shape)} exceeds the kernel's grid")
    out = torch.empty((c, out_len), dtype=x.dtype, device=device)
    if out.numel() == 0:
        return out
    lib = _library()
    flags = (int(x.dtype == BF16), int(taps.dtype == BF16))
    with torch.cuda.device(device):
        if path == "flat":
            err = lib.fir_conv1d_flat_launch(
                x.data_ptr(), taps.data_ptr(), out.data_ptr(), c, length, k,
                *flags, int(looped), _launch.stream(device))
        else:
            err = lib.fir_conv1d_launch(
                x.data_ptr(), taps.data_ptr(), out.data_ptr(), c, length, k,
                cb, tw, *flags, _launch.stream(device))
    _launch.check_status(err, f"fir_conv1d ({path})")
    _wrapper.launches += 1
    _wrapper.launches_by_path[path] += 1
    return out


#: ``fir_conv1d.launches`` counts launches of the CUDA kernels (calls that
#: take the plain version do not count), ``fir_conv1d.launches_by_path``
#: each kernel's, through this alias.
_wrapper = fir_conv1d
fir_conv1d.launches = 0
fir_conv1d.launches_by_path = {p: 0 for p in PATHS}
