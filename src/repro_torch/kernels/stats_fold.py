"""The streamed statistics fold: plain PyTorch version and CUDA kernel.

The JAX package folds a replay chunk's per-lane outputs into per-group
statistics partials with XLA scatter-adds (``repro/core/fleetstats.py:143``
``reduce_lane_outputs``, no Pallas kernel); its tests hold the result
bitwise against ``stats_from_outputs``, whose ``np.bincount`` adds in lane
order.  On a CUDA tensor PyTorch cannot keep that order (``index_add_``
adds f64 with atomics, ``sum``/``cumsum`` reduce in trees), so the fold is
a hand-written kernel here:

* :func:`stats_fold_plain` -- the plain PyTorch version.  On the CPU every
  sum is a ``cumsum`` down the lane axis, which adds in lane order, so it
  is bitwise equal to ``stats_from_outputs``; on the card it computes the
  same function with the sums in a tree order.
* :func:`stats_fold` -- the wrapper of ``csrc/stats_fold.cu``: CUDA tensors
  launch the kernel (every f64 sum added in lane order by one thread, no
  float atomics), CPU tensors take the plain version.

Both return the JAX package's ``(psums, pmins, pmaxs)`` partial as float64
tensors on the input's device.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.energy import CLOCK_HZ, JOULES_PER_CYCLE
from ..core.fleetstats import (_N_CLASSES, _RADIO_IDX, STAT_CHANNELS,
                               lane_channels)

F64 = torch.float64

#: The per-lane scalar outputs the kernel reads, in its argument order
#: (``classes``, ``stuck`` beside them).
LANE_KEYS = ("live", "dead", "reboots", "wasted", "belief", "tx_bytes",
             "msgs_sent", "msgs_deferred")

#: Columns of one group's ordered pass: count, completed, the op classes,
#: then sum, sum of squares, min and max of every channel.
N_COLUMNS = 2 + _N_CLASSES + 4 * len(STAT_CHANNELS)


def _lanes(out: dict) -> dict:
    """The output dict with the uplink channels of a replay that predates
    them filled with zeros (``lane_channels`` reads them as zero too)."""
    zero = torch.zeros_like(out["live"])
    return {k: out.get(k, zero) for k in LANE_KEYS} | {
        "classes": out["classes"], "stuck": out["stuck"]}


def _edges(edges: dict, device) -> list:
    return [torch.as_tensor(edges[ch], dtype=F64, device=device)
            for ch in STAT_CHANNELS]


def stats_fold_plain(out: dict, group_id, valid, edges: dict,
                     n_groups: int) -> tuple:
    """The fold in plain PyTorch (see the module docstring): ``out`` is a
    replay's per-lane output dict, ``group_id`` ``(L,)`` integer group
    indices (lanes outside ``[0, n_groups)`` are dropped), ``valid`` the
    ``(L,)`` mask of real lanes, ``edges`` each channel's bin edges."""
    out = _lanes(out)
    device = out["live"].device
    gid = group_id.to(torch.int64)
    valid = valid.to(torch.bool)
    done = ~out["stuck"] & valid
    vals = lane_channels(out)
    n = gid.shape[0]
    # every summed column, and the lanes each takes
    cols = [valid.to(F64), done.to(F64)]
    cols += [out["classes"][:, c] for c in range(_N_CLASSES)]
    for ch in STAT_CHANNELS:
        v = vals[ch]
        cols += [v, v * v]
    table = torch.stack(cols, dim=1) if n else \
        torch.zeros((0, len(cols)), dtype=F64, device=device)
    takes = torch.cat([valid[:, None], done[:, None].expand(
        n, len(cols) - 1)], dim=1)
    sums = torch.zeros((n_groups, len(cols)), dtype=F64, device=device)
    for g in range(n_groups):
        sel = takes & (gid == g)[:, None]
        if n:
            # cumsum adds down the lane axis in lane order on the CPU
            sums[g] = torch.where(sel, table, 0.0).cumsum(0)[-1]
    psums = {"count": sums[:, 0], "completed": sums[:, 1],
             "class_sums": sums[:, 2:2 + _N_CLASSES]}
    pmins, pmaxs = {}, {}
    keep = done & (gid >= 0) & (gid < n_groups)
    g_keep = gid[keep]
    for j, (ch, e) in enumerate(zip(STAT_CHANNELS, _edges(edges, device))):
        base = 2 + _N_CLASSES + 2 * j
        psums[f"{ch}:sum"] = sums[:, base]
        psums[f"{ch}:sumsq"] = sums[:, base + 1]
        bins = e.shape[0] - 1
        v = vals[ch][keep]
        idx = torch.clamp(torch.searchsorted(e, v, right=True) - 1, 0,
                          bins - 1)
        psums[f"{ch}:hist"] = torch.zeros(
            (n_groups, bins), dtype=F64, device=device).index_put_(
            (g_keep, idx), torch.ones_like(v), accumulate=True)
        pmins[ch] = _extreme(v, g_keep, n_groups, torch.min, torch.inf)
        pmaxs[ch] = _extreme(v, g_keep, n_groups, torch.max, -torch.inf)
    return psums, pmins, pmaxs


def _extreme(v, gid, n_groups: int, pick, empty: float):
    """Each group's extreme of ``v`` as numpy's ``minimum.at`` /
    ``maximum.at`` leave it, walking the lanes in order: the first NaN
    if there is one, else the extreme's value at its last lane (a tie
    takes the later lane's value, which tells -0.0 from +0.0)."""
    out = torch.full((n_groups,), empty, dtype=F64, device=v.device)
    for g in range(n_groups):
        vs = v[gid == g]
        if not vs.numel():
            continue
        nan = vs.isnan()
        if bool(nan.any()):
            out[g] = vs[nan][0]
        else:
            out[g] = vs[(vs == pick(vs)).nonzero()[-1, 0]]
    return out


def _library():
    """Build (first use) and bind the kernel's C entry point."""
    from . import _build

    lib = _build.load("stats_fold").lib
    if getattr(lib, "_bound", False):
        return lib
    lib.stats_fold_n_channels.restype = ctypes.c_int
    lib.stats_fold_n_channels.argtypes = []
    if lib.stats_fold_n_channels() != len(STAT_CHANNELS):
        raise RuntimeError("csrc/stats_fold.cu was built for another number "
                           "of statistics channels")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.stats_fold_launch.restype = i
    lib.stats_fold_launch.argtypes = ([p, p, p, p, p, i, i, i, d, d, i, p, p,
                                       i, p, p, p, p])
    lib._bound = True
    return lib


def _check(name, t, n, dtype, device, ndim=1):
    from ._launch import check_input

    check_input(name, t, device, (dtype,), ndim)
    if t.shape[0] != n:
        raise ValueError(f"{name} must have {n} lanes first, got "
                         f"{tuple(t.shape)}")


def stats_fold(out: dict, group_id, valid, edges: dict,
               n_groups: int) -> tuple:
    """The fold: the CUDA kernel for CUDA tensors, :func:`stats_fold_plain`
    for CPU tensors.  Arguments are the plain version's; on the card every
    lane input must be a contiguous tensor on one device (f64 channels,
    ``classes`` ``(L, C)``, bool ``stuck`` and ``valid``, int32
    ``group_id``) and each edge array a tensor there too (so a call copies
    nothing from the host and never waits on the card).  Each launch counts
    in ``stats_fold.launches``."""
    device = out["live"].device
    if device.type == "cpu":
        return stats_fold_plain(out, group_id, valid, edges, n_groups)
    if device.type != "cuda":
        raise ValueError(f"stats_fold runs on CUDA or CPU tensors, got "
                         f"{device}")
    return _launch(out, group_id, valid, edges, n_groups)


def _launch(out, group_id, valid, edges, n_groups):
    """The kernel half of :func:`stats_fold`: check, allocate, launch and
    count, on the device of ``out["live"]``."""
    from ._launch import check_status, stream

    out = _lanes(out)
    device = out["live"].device
    n = out["live"].shape[0]
    if n_groups < 1:
        raise ValueError(f"n_groups must be >= 1, got {n_groups}")
    for k in LANE_KEYS:
        _check(k, out[k], n, F64, device)
    _check("classes", out["classes"], n, F64, device, ndim=2)
    if out["classes"].shape[1] != _N_CLASSES:
        raise ValueError(f"classes must have {_N_CLASSES} op classes, got "
                         f"{out['classes'].shape[1]}")
    _check("stuck", out["stuck"], n, torch.bool, device)
    _check("valid", valid, n, torch.bool, device)
    _check("group_id", group_id, n, torch.int32, device)
    offs = [0]
    for ch in STAT_CHANNELS:
        e = edges[ch]
        if not torch.is_tensor(e) or e.device != device or e.dtype != F64 \
                or e.dim() != 1 or e.shape[0] < 2:
            raise ValueError(f"edges[{ch!r}] must be a float64 tensor of at "
                             f"least 2 edges on {device}")
        offs.append(offs[-1] + e.shape[0])
    flat = torch.cat([edges[ch] for ch in STAT_CHANNELS])
    hb = offs[-1] - len(STAT_CHANNELS)
    counts = torch.zeros((n_groups, hb), dtype=torch.int32, device=device)
    acc = torch.empty((n_groups, N_COLUMNS), dtype=F64, device=device)
    hist = torch.empty((n_groups, hb), dtype=F64, device=device)
    lanes = (ctypes.c_void_p * len(LANE_KEYS))(
        *(out[k].data_ptr() for k in LANE_KEYS))
    lib = _library()
    err = lib.stats_fold_launch(
        lanes, out["classes"].data_ptr(), out["stuck"].data_ptr(),
        valid.data_ptr(), group_id.data_ptr(), n, _N_CLASSES, _RADIO_IDX,
        float(CLOCK_HZ), float(JOULES_PER_CYCLE), n_groups, flat.data_ptr(),
        (ctypes.c_int * len(offs))(*offs), hb, counts.data_ptr(),
        acc.data_ptr(), hist.data_ptr(), stream(device))
    check_status(err, "stats_fold")
    _wrapper.launches += 1
    return _split(acc, hist, offs)


def _split(acc, hist, offs) -> tuple:
    """The kernel's ``acc`` (G, N_COLUMNS) and ``hist`` (G, bins) as the
    ``(psums, pmins, pmaxs)`` dicts."""
    psums = {"count": acc[:, 0], "completed": acc[:, 1],
             "class_sums": acc[:, 2:2 + _N_CLASSES]}
    pmins, pmaxs = {}, {}
    for j, ch in enumerate(STAT_CHANNELS):
        base = 2 + _N_CLASSES + 4 * j
        psums[f"{ch}:sum"] = acc[:, base]
        psums[f"{ch}:sumsq"] = acc[:, base + 1]
        pmins[ch] = acc[:, base + 2]
        pmaxs[ch] = acc[:, base + 3]
        lo = offs[j] - j
        psums[f"{ch}:hist"] = hist[:, lo:lo + offs[j + 1] - offs[j] - 1]
    return psums, pmins, pmaxs


#: ``stats_fold.launches`` counts launches of the CUDA kernel (calls that
#: take the plain version do not count).  The wrapper counts through this
#: alias, so a caller that wraps ``stats_fold`` still reads the count off
#: the original function.
_wrapper = stats_fold
stats_fold.launches = 0
