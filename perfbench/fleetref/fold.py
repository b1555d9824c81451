"""The statistics reference: a frozen copy of the port's numpy fold.

Copied from ``src/repro_torch/core/fleetstats.py`` at commit f60fe63:
``STAT_CHANNELS``, ``default_stat_edges``, ``lane_channels`` and
``stats_from_outputs`` (which returns a plain dict here), plus ``merge``, the
sum of two partials in ``FleetStats.merge``'s order.  Numpy adds each
``bincount`` and ``add.at`` in lane order, as the fold kernel does, so the
comparison is exact.
"""

from __future__ import annotations

import numpy as np

from .energy import CLOCK_HZ, JOULES_PER_CYCLE, OP_CLASSES

STAT_CHANNELS = ("live_cycles", "dead_s", "total_s", "reboots",
                 "wasted_cycles", "belief_cycles", "tx_bytes",
                 "msgs_sent", "msgs_deferred", "tx_joules")

_N_CLASSES = len(OP_CLASSES)
_RADIO_IDX = OP_CLASSES.index("radio")


def default_stat_edges(total_cycles: float, capacity: float,
                       recharge_s: float, bins: int = 64) -> dict:
    """Linear histogram edges sized from a plan's nominal bounds.

    ``total_cycles`` is the plan's continuous-power work, ``capacity`` the
    cycles per charge (``inf`` for continuous power; an array covers a
    multi-capacitor sweep -- the smallest finite capacitor sizes the
    reboot/dead ranges, the largest the belief range) and ``recharge_s``
    the mean dead time per reboot (scalar or array; the max is used).
    The ranges deliberately over-cover (reboot re-entry, torn-prefix
    re-execution and adaptive drains inflate live time well past the
    nominal); out-of-range values clip into the end bins, so a generous
    range costs resolution, not correctness."""
    total = max(float(total_cycles), 1.0)
    cap = np.asarray(capacity, np.float64).ravel()
    fin = cap[np.isfinite(cap)]
    cap_lo = float(fin.min()) if fin.size else np.inf
    fin_cap = total if not fin.size else max(float(fin.max()), 1.0)
    reboots_hi = (1.0 if not fin.size
                  else max(8.0 * total / max(cap_lo, 1.0), 8.0))
    live_hi = 8.0 * total
    rec = np.asarray(recharge_s, np.float64).ravel()
    rec_hi = float(rec.max()) if rec.size else 0.0
    dead_hi = max(4.0 * reboots_hi * max(rec_hi, 1e-9), 1e-9)
    return {
        "live_cycles": np.linspace(0.0, live_hi, bins + 1),
        "dead_s": np.linspace(0.0, dead_hi, bins + 1),
        "total_s": np.linspace(0.0, live_hi / CLOCK_HZ + dead_hi,
                               bins + 1),
        "reboots": np.linspace(0.0, reboots_hi, bins + 1),
        "wasted_cycles": np.linspace(0.0, 2.0 * total, bins + 1),
        "belief_cycles": np.linspace(0.0, 2.0 * fin_cap, bins + 1),
        # Uplink channels: the ranges cannot see the radio model here, so
        # they over-cover generously (one SEND row per plan ships tens of
        # bytes; tail values clip into the end bin, min/max stay exact).
        "tx_bytes": np.linspace(0.0, 4096.0, bins + 1),
        "msgs_sent": np.linspace(0.0, 256.0, bins + 1),
        "msgs_deferred": np.linspace(0.0, 256.0, bins + 1),
        "tx_joules": np.linspace(0.0, 2.0 * total * JOULES_PER_CYCLE,
                                 bins + 1),
    }


def lane_channels(out: dict) -> dict:
    """The per-lane ``STAT_CHANNELS`` values of a replay output dict
    (works on numpy arrays and on tensors alike).  Output
    dicts predating the uplink channels (hand-built oracles) fold in as
    all-zero; ``tx_joules`` is derived from the per-class cycle
    breakdown rather than carried as a separate scan output."""
    zero = out["live"] * 0.0
    return {
        "live_cycles": out["live"],
        "dead_s": out["dead"],
        "total_s": out["live"] / CLOCK_HZ + out["dead"],
        "reboots": out["reboots"],
        "wasted_cycles": out["wasted"],
        "belief_cycles": out["belief"],
        "tx_bytes": out["tx_bytes"] if "tx_bytes" in out else zero,
        "msgs_sent": out["msgs_sent"] if "msgs_sent" in out else zero,
        "msgs_deferred": out["msgs_deferred"]
        if "msgs_deferred" in out else zero,
        "tx_joules": out["classes"][..., _RADIO_IDX] * JOULES_PER_CYCLE
        if "classes" in out else zero,
    }


def stats_from_outputs(out: dict, edges: dict, group_id=None,
                       n_groups: int = 1) -> dict:
    """Reference reduction: the same statistics computed from
    *materialized* per-lane outputs with plain numpy.  This is the
    validation oracle for the streamed reduction on the device (and a
    convenience for small fleets): ``fleet_sweep(..., reduce="stats")``
    must be bit-exact on sums/counts and bin-exact on histograms against
    this, per the differential tests."""
    stuck = np.asarray(out["stuck"])
    n = stuck.shape[0]
    gid = (np.zeros(n, np.int64) if group_id is None
           else np.asarray(group_id, np.int64))
    done = ~stuck
    vals = {k: np.asarray(v) for k, v in lane_channels(
        {k: np.asarray(v) for k, v in out.items()}).items()}
    count = np.bincount(gid, minlength=n_groups).astype(np.float64)
    completed = np.bincount(gid, weights=done.astype(np.float64),
                            minlength=n_groups)
    class_sums = np.zeros((n_groups, _N_CLASSES))
    np.add.at(class_sums, gid,
              np.asarray(out["classes"]) * done[:, None].astype(float))
    sums, sumsqs, mins, maxs, hists = {}, {}, {}, {}, {}
    for ch in STAT_CHANNELS:
        v = vals[ch]
        e = np.asarray(edges[ch])
        bins = e.shape[0] - 1
        sums[ch] = np.bincount(gid, weights=np.where(done, v, 0.0),
                               minlength=n_groups)
        sumsqs[ch] = np.bincount(gid, weights=np.where(done, v * v, 0.0),
                                 minlength=n_groups)
        idx = np.clip(np.searchsorted(e, v, side="right") - 1, 0,
                      bins - 1)
        h = np.zeros((n_groups, bins))
        np.add.at(h, (gid, idx), done.astype(np.float64))
        hists[ch] = h
        mn = np.full(n_groups, np.inf)
        mx = np.full(n_groups, -np.inf)
        np.minimum.at(mn, gid, np.where(done, v, np.inf))
        np.maximum.at(mx, gid, np.where(done, v, -np.inf))
        mins[ch], maxs[ch] = mn, mx
    return dict(count=count, completed=completed, sums=sums,
                sumsqs=sumsqs, mins=mins, maxs=maxs, hists=hists,
                class_sums=class_sums)


def merge(a: dict, b: dict) -> dict:
    """Two statistics dicts combined as ``FleetStats.merge`` combines them."""
    return dict(
        count=a["count"] + b["count"],
        completed=a["completed"] + b["completed"],
        sums={c: a["sums"][c] + b["sums"][c] for c in STAT_CHANNELS},
        sumsqs={c: a["sumsqs"][c] + b["sumsqs"][c] for c in STAT_CHANNELS},
        mins={c: np.minimum(a["mins"][c], b["mins"][c])
              for c in STAT_CHANNELS},
        maxs={c: np.maximum(a["maxs"][c], b["maxs"][c])
              for c in STAT_CHANNELS},
        hists={c: a["hists"][c] + b["hists"][c] for c in STAT_CHANNELS},
        class_sums=a["class_sums"] + b["class_sums"])
