"""Mamba2 SSD intra-chunk cell: the CUDA kernels of ``csrc/ssd_intra.cu``
and their plain PyTorch version (:func:`~.ref.ssd_intra_ref`).

The counterpart of the JAX package's Pallas kernel
``repro/kernels/ssd_intra.py:ssd_intra``: per (batch*chunk, head) cell,
``G = C B^T``, the masked decay ``M = G * exp(cs_i - cs_j)`` for j <= i,
``y = M (x dt)`` and the chunk state ``S = B^T (exp(cs_Q - cs) * x dt)``,
with the (Q, Q) decay matrix kept out of HBM.  On the card two designs,
chosen by :func:`ssd_path` before the launch:

* ``"wgmma"``: 3xTF32 on the tensor cores for P = 64, Q a multiple of 64
  up to 256 and N a multiple of 64.  G depends only on the batch*chunk, so
  a CTA computes one 64-row tile of it once and reuses it for a group of
  :data:`HEADS_PER_CTA` heads; other CTAs own 64-row tiles of S, with B^T
  split once for their heads; x dt streams through a TMA ring of 32-key
  slices (see the source).
* ``"simt"``, the first design: 64-row tiles of one cell on the CUDA
  cores, G once a cell; it takes every shape.

:func:`launch` also runs ``"wgmma_thread_fed"``, the wgmma design built
with x dt fed by the threads' own loads instead of the ring (the
``ssd_intra_thread_fed`` build), which ``chip_smoke.py`` times beside it;
no path function picks it.

Both evaluate the exponential of a masked pair, which overflows at
realistic chunk lengths, never.  Each input may be f32 or bf16, as in the
JAX package; y and S are f32.  ``models.mamba2.ssd_chunked`` calls it
once a layer; under autograd :class:`SSDIntraFunction` gives it the plain
cell's gradient.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import PLAIN_DEVICES
from . import _launch
from .calibrate import SMS
from .ref import ssd_intra_ref

F32, BF16 = torch.float32, torch.bfloat16
DTYPES = (F32, BF16)
#: The first design's tile edge (rows of y and S a block owns, columns of
#: P); the wgmma design's tile edge, which is also the P it takes, and its
#: largest Q.
TILE = 64
WGMMA_P, WGMMA_Q_MAX = 64, 256
#: Heads a CTA of the wgmma design takes at most (its shared memory holds
#: a row of Q for each); :func:`ssd_plan` chooses how many.
HEADS_PER_CTA = 8
#: A CTA's own work in :func:`ssd_plan`'s cost (its tile of G, or its
#: split of B^T), in units of one head a warpgroup: fitted to the times of
#: 1 to 2,048 cells at Q = 256, N = 128 on an H100 (PERF.md).
PLAN_CTA_WORK = 0.36
PATHS = ("wgmma", "simt")
#: The library each kernel :func:`launch` runs is built as: the kernels of
#: :data:`PATHS`, and the wgmma design with x dt fed by the threads' own
#: loads (its TMA flag 0), kept for timing beside the ring.
BUILDS = {"wgmma": ("ssd_intra", 1), "simt": ("ssd_intra", 1),
          "wgmma_thread_fed": ("ssd_intra_thread_fed", 0)}
_INT_MAX = 2**31 - 1
_GRID_YZ_MAX = 65535


def _library(path: str = "wgmma"):
    """Build (first use) and bind the C entry points of the library that
    kernel ``path`` is built in (:data:`BUILDS`)."""
    from . import _build

    name, tma = BUILDS[path]
    lib = _build.load(name).lib
    if getattr(lib, "_bound", False):
        return lib
    for fn in (lib.ssd_intra_tile, lib.ssd_intra_wgmma_shape):
        fn.restype, fn.argtypes = ctypes.c_int, []
    if (lib.ssd_intra_tile(), lib.ssd_intra_wgmma_shape()) != (
            TILE, WGMMA_P | WGMMA_Q_MAX << 8 | HEADS_PER_CTA << 20
            | tma << 28):
        raise RuntimeError(f"csrc/ssd_intra.cu was built as {name} for "
                           f"other tiles than ssd_intra.py's")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_intra_launch.restype = i
    lib.ssd_intra_launch.argtypes = [p] * 6 + [ctypes.c_longlong] + \
        [i] * 5 + [p]
    lib.ssd_intra_wgmma_launch.restype = i
    lib.ssd_intra_wgmma_launch.argtypes = [p] * 6 + [ctypes.c_longlong] + \
        [i] * 6 + [p]
    lib._bound = True
    return lib


def ssd_path(xdt: torch.Tensor, bb: torch.Tensor, cc: torch.Tensor,
             cs: torch.Tensor) -> str:
    """Which kernel takes the cell on the card, from the operands alone,
    before any launch: ``"wgmma"`` for P = 64, Q a multiple of 64 up to
    256, N a multiple of 64, at least one cell and fewer than 2^31 rows of
    x dt (TMA's row coordinate), and contiguous inputs whose data start on
    a 16-byte boundary (its loads of C and B are 16 bytes, and TMA copies
    x dt); else ``"simt"``, the first design."""
    bc, h, q, p = xdt.shape
    n = bb.shape[-1]
    shape = p == WGMMA_P and q % TILE == 0 and TILE <= q <= WGMMA_Q_MAX \
        and n % TILE == 0 and n >= TILE and 1 <= bc * h \
        and bc * h * q <= _INT_MAX
    aligned = all(t.is_contiguous() and t.data_ptr() % 16 == 0
                  for t in (xdt, bb, cc, cs))
    return "wgmma" if shape and aligned else "simt"


def ssd_plan(bc: int, h: int, q: int, n: int) -> int:
    """Heads a CTA of the wgmma design takes for BC batch*chunks of H
    heads: of 8, 4 and 2 (each CTA computes its tile of G, or splits its
    B^T, once for them, and each warpgroup takes every other head), the
    one whose grid of BC x ceil(H / heads) x (Q / 64 + N / 64) CTAs, one an
    SM, takes the fewest waves x (:data:`PLAN_CTA_WORK` + ceil(heads / 2)),
    the larger on a tie; at most H.  At mamba2-370m's 1,024 cells that is
    8; with few cells, fewer heads a CTA spread them over more SMs."""
    kinds = q // TILE + n // TILE

    def cost(hg: int) -> float:
        waves = -(-bc * -(-h // hg) * kinds // SMS)
        return waves * (PLAN_CTA_WORK + -(-min(hg, h) // 2))

    return min(h, min((HEADS_PER_CTA, 4, 2), key=lambda hg: (cost(hg), -hg)))


def ssd_intra(xdt: torch.Tensor, bb: torch.Tensor, cc: torch.Tensor,
              cs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """xdt (BC, H, Q, P), bb/cc (BC, Q, N), cs (BC, H, Q), each f32 or
    bf16 -> (y (BC, H, Q, P), s (BC, H, N, P)) in f32, rounded as
    :func:`~.ref.ssd_intra_ref` says for a bf16 cs.

    CPU (and meta) tensors take the plain version; CUDA tensors launch
    the kernel :func:`ssd_path` names on the current stream, under
    :class:`SSDIntraFunction` (so a loss through it has the plain cell's
    gradient), and count the launch in ``ssd_intra.launches`` and
    ``ssd_intra.launches_by_path``.  Nothing falls back."""
    _check(xdt, bb, cc, cs)
    if xdt.device.type in PLAIN_DEVICES:
        return ssd_intra_ref(xdt, bb, cc, cs)
    _check_cuda(xdt, bb, cc, cs)
    return SSDIntraFunction.apply(xdt, bb, cc, cs)


class SSDIntraFunction(torch.autograd.Function):
    """The SSD cell's kernel under autograd: the forward launches the
    kernel :func:`ssd_path` names, exactly as without a gradient (and
    counts it); the backward recomputes the plain cell
    (:func:`~.ref.ssd_intra_ref`) from the saved inputs and returns its
    vector-Jacobian product -- the function the JAX package differentiates
    (XLA autodiff of ``ssd_chunked``'s einsums; the Pallas kernel has no
    backward).  ``apply(xdt, bb, cc, cs)``; on CPU tensors the forward is
    the plain cell too."""

    @staticmethod
    def forward(ctx, xdt, bb, cc, cs):
        ctx.save_for_backward(xdt, bb, cc, cs)
        if xdt.device.type in PLAIN_DEVICES:
            return ssd_intra_ref(xdt, bb, cc, cs)
        return _run(xdt, bb, cc, cs, ssd_path(xdt, bb, cc, cs))

    @staticmethod
    def backward(ctx, d_y, d_s):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            return torch.autograd.grad(ssd_intra_ref(*ins), ins, (d_y, d_s))


def launch(xdt: torch.Tensor, bb: torch.Tensor, cc: torch.Tensor,
           cs: torch.Tensor, path: str, *, heads: int | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch kernel ``path`` (a key of :data:`BUILDS`) on CUDA tensors and
    count it, as timing the designs side by side needs; the wgmma ones are
    refused where :func:`ssd_path` would not take the operands.  ``heads``:
    the wgmma design's heads a CTA (1 to :data:`HEADS_PER_CTA`) in place
    of :func:`ssd_plan`'s, as timing that choice needs."""
    _check(xdt, bb, cc, cs)
    _check_cuda(xdt, bb, cc, cs)
    if path not in BUILDS:
        raise ValueError(f"no SSD kernel {path!r}; the kernels are "
                         f"{tuple(BUILDS)}")
    if path != "simt" and ssd_path(xdt, bb, cc, cs) != "wgmma":
        raise ValueError(f"the wgmma kernel does not take xdt "
                         f"{tuple(xdt.shape)} with N = {bb.shape[-1]}")
    if heads is not None and (path == "simt"
                              or not 1 <= heads <= HEADS_PER_CTA):
        raise ValueError(f"heads={heads}: the wgmma kernels take 1 to "
                         f"{HEADS_PER_CTA} heads a CTA")
    return _run(xdt, bb, cc, cs, path, heads)


def _check(xdt, bb, cc, cs) -> None:
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


def _check_cuda(xdt, bb, cc, cs) -> None:
    device = xdt.device
    if device.type != "cuda":
        raise ValueError(f"ssd_intra runs on CUDA or CPU tensors, got "
                         f"{device}")
    _launch.check_input("xdt", xdt, device, DTYPES, 4)
    _launch.check_input("bb", bb, device, DTYPES, 3)
    _launch.check_input("cc", cc, device, DTYPES, 3)
    _launch.check_input("cs", cs, device, DTYPES, 3)


def _run(xdt, bb, cc, cs, path: str,
         heads: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``path`` on checked CUDA operands and count it."""
    device = xdt.device
    bc, h, q, p = xdt.shape
    n = bb.shape[2]
    if bc * h > _INT_MAX or max(q * p, q * n, n * p) > _INT_MAX \
            or -(-q // TILE) + -(-n // TILE) > _GRID_YZ_MAX \
            or -(-p // TILE) > _GRID_YZ_MAX:
        raise ValueError(f"xdt {tuple(xdt.shape)} with N={n} exceeds the "
                         f"kernel's grid")
    y = torch.empty((bc, h, q, p), dtype=F32, device=device)
    s = torch.empty((bc, h, n, p), dtype=F32, device=device)
    if bc * h == 0:
        return y, s
    lib = _library(path)
    mask = sum(int(t.dtype == BF16) << i
               for i, t in enumerate((xdt, bb, cc, cs)))
    with torch.cuda.device(device):
        args = (xdt.data_ptr(), bb.data_ptr(), cc.data_ptr(), cs.data_ptr(),
                y.data_ptr(), s.data_ptr(), bc, h, q, n, p)
        if path != "simt":
            hg = heads or ssd_plan(bc, h, q, n)
            err = lib.ssd_intra_wgmma_launch(*args, hg, mask,
                                             _launch.stream(device))
        else:
            err = lib.ssd_intra_launch(*args, mask, _launch.stream(device))
    _launch.check_status(err, f"ssd_intra ({path})")
    _wrapper.launches += 1
    _wrapper.launches_by_path[path] += 1
    return y, s


#: ``ssd_intra.launches`` counts launches of the CUDA kernels (calls that
#: take the plain version do not count), ``ssd_intra.launches_by_path``
#: each kernel's, through this alias.
_wrapper = ssd_intra
ssd_intra.launches = 0
ssd_intra.launches_by_path = {p: 0 for p in BUILDS}
