"""The deterministic closed-form replay's CUDA kernel and its wrapper.

The JAX package leaves its deterministic row scan to XLA, which fuses it
(no Pallas kernel).  The port's plain version is
``core.fleetsim._scan_replay`` on CPU tensors: a loop of
``fleetsim._scan_step(stochastic=False)`` row steps over all lanes.  On
the card the same scan is ``csrc/closed_form.cu``'s ``closed_form_kernel``,
one thread a lane walking every row in registers with the same f64
operations in the same order, so the two give the same bits.

:func:`closed_form` is the kernel's wrapper: ``fleetsim._scan_replay``
calls it with CUDA tensors (CPU tensors take the plain loop).  It checks
every input, launches once on the current stream, raises if the launch
failed, and counts the launch in ``closed_form.launches``;
``fleetsim._replay_rows.rows`` counts the rows it ran.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.fleetstats import _N_CLASSES
from ..runtime.radio import N_RADIO
from ._launch import check_status, stream
from .charge_replay import (F64, OUTPUTS, _check_constants, _check_lane,
                            _layout_ints, lane_block)

#: A floor on the f64 operations of one lane and row of the closed form,
#: counted from the plain row step on a row that finishes in the charge it
#: starts in (the least a row can do): the class update, five a class
#: (``left * iter``, ``commits * commit``, the two adds into the entry
#: vector and the add into the carry), and nine scalar operations
#: (``needed = e + left * c``: 2; the finish test: 1; the remaining charge,
#: live cycles and charge spent: 3; the dead time, ``(r1 - r0) * tail``
#: added to the carry: 3).
MIN_F64_OPS_PER_ROW = 5 * _N_CLASSES + 9


def _library():
    """Build (first use) and bind the kernel's C entry point."""
    from . import _build

    _check_constants()
    lib = _build.load("closed_form").lib
    if getattr(lib, "_bound", False):
        return lib
    lib.closed_form_n_classes.restype = ctypes.c_int
    lib.closed_form_n_classes.argtypes = []
    if lib.closed_form_n_classes() != _N_CLASSES:
        raise RuntimeError("csrc/closed_form.cu was built for another "
                           "number of op classes")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.closed_form_launch.restype = i
    lib.closed_form_launch.argtypes = (
        [p, ctypes.c_longlong, i, p, p]          # rows, lane stride, rows
        #                                          walked, plan index, layout
        + [p, p, p, i, p, d, p, p]               # lane inputs, theta, radio
        + [i] * 3                                # static flags
        + [p] * 11                               # outputs
        + [i, i, p])                             # n_lanes, block, stream
    lib._bound = True
    return lib


def closed_form(packed, layout, cap, rem0, trace_cum, tail_s, theta, conf,
                radio, *, adaptive: bool, parametric: bool, mode: str,
                has_send: bool, plan_idx=None) -> dict:
    """Launch ``closed_form_kernel`` once over every row of ``packed``:
    check every input's device, dtype, shape and contiguity, allocate the
    11 outputs (``charge_replay.OUTPUTS``), launch on the current stream
    with ``charge_replay.lane_block`` lanes a block, raise if the launch
    failed, and count it in ``closed_form.launches`` (a call without lanes
    launches nothing and counts nothing).  ``packed`` is the row-major
    table of :func:`~repro_torch.kernels.charge_replay.pack_rows` for
    ``mode`` (``"shared"``, ``"lane"`` or ``"plan"``); ``plan_idx`` (int32,
    ``mode == "plan"`` only) is not read back: its range is checked on the
    host (``fleetsim._prepare``)."""
    device = cap.device
    n_lanes = cap.shape[0]
    for name, t in (("cap", cap), ("rem0", rem0), ("tail_s", tail_s),
                    ("conf", conf)):
        _check_lane(name, t, n_lanes, F64, device)
    _check_lane("trace_cum", trace_cum, n_lanes, F64, device, ndim=2)
    if trace_cum.shape[1] < 1:
        raise ValueError("the recharge trace needs at least one column")
    if not torch.is_tensor(radio) or radio.shape != (N_RADIO,) \
            or radio.dtype != F64 or radio.device != device \
            or not radio.is_contiguous():
        raise ValueError(f"radio must be a contiguous ({N_RADIO},) float64 "
                         f"tensor on {device}")
    if (mode == "plan") != (plan_idx is not None):
        raise ValueError("plan_idx goes with shared_rows='plan', and only "
                         "with it")
    if plan_idx is not None:
        _check_lane("plan_idx", plan_idx, n_lanes, torch.int32, device)
    if packed.device != device or packed.dtype != F64 \
            or not packed.is_contiguous() \
            or packed.dim() != (2 if mode == "shared" else 3):
        raise ValueError(f"the row table must be a contiguous float64 "
                         f"{'(S, F)' if mode == 'shared' else '(_, S, F)'} "
                         f"tensor on {device}, got {packed.dtype} "
                         f"{tuple(packed.shape)} on {packed.device}")
    if mode == "lane" and packed.shape[0] != n_lanes:
        raise ValueError(f"per-lane rows hold {packed.shape[0]} lanes, "
                         f"expected {n_lanes}")
    shapes = {k: sh for k, _off, sh in layout}
    if shapes["entry_class"] != (_N_CLASSES,):
        raise ValueError(f"rows carry {shapes['entry_class']} op classes, "
                         f"the kernel {_N_CLASSES}")
    if parametric != ("tile_sel_cost" in shapes):
        raise ValueError("parametric must match the presence of tile tables")
    s_pad, f = packed.shape[-2:]
    g = shapes["entry_seg_cycles"][0]
    k = shapes["tile_n"][0] if parametric else 0
    layout_c = (ctypes.c_int * 21)(*_layout_ints(layout, f, g, k))

    out = dict(live=torch.empty_like(cap), reboots=torch.empty_like(cap),
               dead=torch.empty_like(cap),
               classes=torch.empty((n_lanes, _N_CLASSES), dtype=F64,
                                   device=device),
               wasted=torch.empty_like(cap),
               stuck=torch.empty(n_lanes, dtype=torch.bool, device=device),
               rem=torch.empty_like(cap), belief=torch.empty_like(cap),
               tx_bytes=torch.empty_like(cap),
               msgs_sent=torch.empty_like(cap),
               msgs_deferred=torch.empty_like(cap))
    err = _library().closed_form_launch(
        packed.data_ptr(), 0 if mode == "shared" else s_pad * f, s_pad,
        None if plan_idx is None else plan_idx.data_ptr(), layout_c,
        cap.data_ptr(), rem0.data_ptr(), trace_cum.data_ptr(),
        trace_cum.shape[1], tail_s.data_ptr(), float(theta),
        conf.data_ptr(), radio.data_ptr(), int(adaptive), int(parametric),
        int(has_send), *(out[name].data_ptr() for name in OUTPUTS),
        n_lanes, lane_block(n_lanes), stream(device))
    check_status(err, "closed_form")
    if n_lanes:
        closed_form.launches += 1
    # `packed` may be freed now: PyTorch's caching allocator hands its
    # memory only to later work on the same stream, after the kernel.
    return out


closed_form.launches = 0
