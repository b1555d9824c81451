"""Streaming fleet statistics: memory-flat answers to fleet-level questions
(the PyTorch counterpart of the JAX package's ``core/fleetstats.py``).

A replay chunk's per-lane outputs are folded on the device into a
fixed-size partial per statistics group (running counts, sums, sums of
squares, min/max and fixed-bin histograms per output channel), and
partials accumulate associatively across lane chunks
(``lane_chunk=`` in ``fleet_sweep``/``capacitor_sweep``/``replay_plans``),
so peak memory is a function of the chunk size and the histogram shape,
never the fleet size.

* ``count`` / ``completed``        -- fleet completion rate.
* per-channel ``sum``/``sumsq``    -- means and variances.
* per-channel ``min``/``max``      -- exact extremes (not binned).
* per-channel fixed-bin histogram  -- percentile queries to bin
  resolution (:meth:`FleetStats.percentile`).
* ``class_sums``                   -- the per-op-class cycle breakdown.

Distribution statistics are taken over completed lanes only; completion
itself is counted over every valid lane.  Histogram edges are fixed before
streaming and out-of-range values clip into the end bins.

The numpy half (:data:`STAT_CHANNELS`, :func:`default_stat_edges`,
:class:`FleetStats`, :func:`stats_from_outputs`) is a copy of the JAX
package's.  The tensor half is :func:`reduce_lane_outputs`, which runs the
hand-written fold kernel (``kernels/stats_fold``) on CUDA tensors and its
plain PyTorch version on CPU tensors -- both add every sum in lane order,
so they are bitwise equal to :func:`stats_from_outputs` -- and
:func:`merge_parts`, the elementwise left fold of two partials.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..runtime import spans
from .energy import CLOCK_HZ, JOULES_PER_CYCLE, OP_CLASSES

#: Per-lane scalar channels the reduction tracks (sum/sumsq/min/max/hist).
#: The last four are the uplink channels (``fleetsim.KIND_SEND`` rows):
#: they stream through ``reduce="stats"`` / ``lane_chunk`` exactly like
#: the compute channels, so radio accounting survives the memory-flat
#: 1e7-lane path.
STAT_CHANNELS = ("live_cycles", "dead_s", "total_s", "reboots",
                 "wasted_cycles", "belief_cycles", "tx_bytes",
                 "msgs_sent", "msgs_deferred", "tx_joules")

_N_CLASSES = len(OP_CLASSES)
_CONTROL_IDX = OP_CLASSES.index("control")
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


@spans.traced("stats_fold")
def reduce_lane_outputs(out: dict, group_id, valid, edges: dict,
                        n_groups: int) -> tuple:
    """Fold a replay chunk's per-lane outputs (tensors on one device) into
    per-group stats partials ``(psums, pmins, pmaxs)``, the JAX package's
    return shape, as float64 tensors on the same device.

    ``group_id`` assigns each lane to a statistics group (``(L,)`` int32;
    all-zero for ``fleet_sweep``, the capacitor index for
    ``capacitor_sweep``, the candidate for a design sweep; a lane outside
    ``[0, n_groups)`` is dropped, as the JAX package's scatter drops it),
    ``valid`` masks chunk-padding lanes out of every statistic, and
    ``edges`` maps each ``STAT_CHANNELS`` entry to its fixed
    ``(bins + 1,)`` bin edges (arrays or tensors).  CUDA tensors launch the
    fold kernel; CPU tensors take its plain version."""
    from ..kernels.stats_fold import stats_fold

    return stats_fold(out, group_id, valid, edges, n_groups)


@spans.traced("entry")
def merge_parts(a: tuple, b: tuple) -> tuple:
    """Associative merge of two ``(psums, pmins, pmaxs)`` partials: sums
    add, mins take the elementwise minimum, maxs the maximum.  A left fold
    of it over chunk partials performs the f64 additions of the host
    :meth:`FleetStats.merge` loop in the same order, so the device-resident
    accumulator of the overlapped pipeline and the host merge give the
    same bits.  Works on tensors of either device."""
    (psa, pna, pxa), (psb, pnb, pxb) = a, b
    return ({k: torch.add(v, psb[k]) for k, v in psa.items()},
            {k: torch.minimum(v, pnb[k]) for k, v in pna.items()},
            {k: torch.maximum(v, pxb[k]) for k, v in pxa.items()})


@spans.traced("device_wait")
def parts_numpy(parts: tuple) -> tuple:
    """A partial's tensors as numpy arrays (a host sync when they lie on
    the card)."""
    return tuple({k: v.cpu().numpy() if torch.is_tensor(v) else
                  np.asarray(v) for k, v in d.items()} for d in parts)


def partial_nbytes(edges: dict, n_groups: int) -> int:
    """Size in bytes of one ``(psums, pmins, pmaxs)`` stats partial for
    ``n_groups`` groups under ``edges`` -- the device-resident
    accumulator's contribution to the streamed pipeline's peak-memory
    bound (2 chunk buffers + 1 stats buffer)."""
    per_group = 2 + _N_CLASSES          # count, completed, class_sums
    for ch in STAT_CHANNELS:
        bins = np.asarray(edges[ch]).shape[0] - 1
        per_group += 4 + bins           # sum, sumsq, min, max, hist
    return int(n_groups * per_group * 8)


@dataclass
class FleetStats:
    """Fixed-size fleet summary: the streamed replacement for per-lane
    ``ReplayOut`` rows.  ``G`` groups (1 for ``fleet_sweep``, one per
    capacitor for ``capacitor_sweep``) x ``B`` histogram bins."""

    count: np.ndarray                 # (G,) lanes reduced
    completed: np.ndarray             # (G,) lanes that completed
    sums: dict                        # ch -> (G,)
    sumsqs: dict                      # ch -> (G,)
    mins: dict                        # ch -> (G,)  (+inf when empty)
    maxs: dict                        # ch -> (G,)  (-inf when empty)
    hists: dict                       # ch -> (G, B)
    edges: dict                       # ch -> (B + 1,) fixed bin edges
    class_sums: np.ndarray            # (G, C) per-op-class cycles
    group_labels: np.ndarray | None = None   # e.g. capacitor sizes (G,)
    wall_s: float = 0.0               # accumulated replay wall clock
    peak_lane_bytes: int = 0          # max per-chunk lane-buffer bytes

    # -- construction ----------------------------------------------------
    @classmethod
    def from_parts(cls, parts: tuple, edges: dict,
                   group_labels=None) -> "FleetStats":
        """Build from the ``(psums, pmins, pmaxs)`` of
        :func:`reduce_lane_outputs` (device arrays or numpy)."""
        psums, pmins, pmaxs = parts
        np_ = {k: np.asarray(v) for k, v in psums.items()}
        return cls(
            count=np_["count"], completed=np_["completed"],
            sums={ch: np_[f"{ch}:sum"] for ch in STAT_CHANNELS},
            sumsqs={ch: np_[f"{ch}:sumsq"] for ch in STAT_CHANNELS},
            mins={ch: np.asarray(v) for ch, v in pmins.items()},
            maxs={ch: np.asarray(v) for ch, v in pmaxs.items()},
            hists={ch: np_[f"{ch}:hist"] for ch in STAT_CHANNELS},
            edges={ch: np.asarray(e) for ch, e in edges.items()},
            class_sums=np_["class_sums"],
            group_labels=None if group_labels is None
            else np.asarray(group_labels))

    # -- associative accumulation ----------------------------------------
    def merge(self, other: "FleetStats") -> "FleetStats":
        """Associative (and commutative) combination of two partials.
        Requires identical edges -- histograms over different bins do not
        compose (the reason edges are fixed before streaming)."""
        for ch in STAT_CHANNELS:
            if not np.array_equal(self.edges[ch], other.edges[ch]):
                raise ValueError(
                    f"cannot merge FleetStats with different {ch!r} "
                    f"histogram edges")
        return replace(
            self,
            count=self.count + other.count,
            completed=self.completed + other.completed,
            sums={c: self.sums[c] + other.sums[c] for c in STAT_CHANNELS},
            sumsqs={c: self.sumsqs[c] + other.sumsqs[c]
                    for c in STAT_CHANNELS},
            mins={c: np.minimum(self.mins[c], other.mins[c])
                  for c in STAT_CHANNELS},
            maxs={c: np.maximum(self.maxs[c], other.maxs[c])
                  for c in STAT_CHANNELS},
            hists={c: self.hists[c] + other.hists[c]
                   for c in STAT_CHANNELS},
            class_sums=self.class_sums + other.class_sums,
            wall_s=self.wall_s + other.wall_s,
            peak_lane_bytes=max(self.peak_lane_bytes,
                                other.peak_lane_bytes))

    # -- queries ---------------------------------------------------------
    @property
    def n_groups(self) -> int:
        return int(self.count.shape[0])

    @property
    def completion_rate(self) -> np.ndarray:
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(self.count > 0, self.completed / self.count,
                            0.0)

    def mean(self, ch: str) -> np.ndarray:
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(self.completed > 0,
                            self.sums[ch] / self.completed, 0.0)

    def var(self, ch: str) -> np.ndarray:
        m = self.mean(ch)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(
                self.completed > 0,
                np.maximum(self.sumsqs[ch] / np.maximum(self.completed, 1)
                           - m * m, 0.0), 0.0)

    def std(self, ch: str) -> np.ndarray:
        return np.sqrt(self.var(ch))

    @property
    def overhead_cycles(self) -> np.ndarray:
        """Chunk-boundary drain cycles (the ``control`` op class): the
        pure-overhead share of the fleet's live cycles."""
        return self.class_sums[:, _CONTROL_IDX]

    @property
    def energy_j_sum(self) -> np.ndarray:
        return self.sums["live_cycles"] * JOULES_PER_CYCLE

    def percentile(self, ch: str, q: float) -> np.ndarray:
        """Per-group percentile of a channel from its fixed-bin
        histogram, linearly interpolated within the bin (accurate to one
        bin width) and clamped to the exact ``min``/``max`` channels --
        in-bin interpolation alone can otherwise report a percentile
        outside the observed range when most of the mass shares a bin.
        ``q`` in [0, 100]."""
        hist = self.hists[ch]                       # (G, B)
        e = self.edges[ch]
        cum = np.cumsum(hist, axis=1)
        total = cum[:, -1]
        target = np.clip(q / 100.0, 0.0, 1.0) * total
        b = np.minimum((cum < target[:, None]).sum(axis=1),
                       hist.shape[1] - 1)
        g = np.arange(hist.shape[0])
        below = np.where(b > 0, cum[g, b - 1], 0.0)
        inbin = np.maximum(hist[g, b], 1e-300)
        frac = np.clip((target - below) / inbin, 0.0, 1.0)
        width = e[b + 1] - e[b]
        val = np.clip(e[b] + frac * width, self.mins[ch], self.maxs[ch])
        return np.where(total > 0, val, np.nan)

    def energy_percentile(self, q: float) -> np.ndarray:
        """Per-group energy percentile in joules (live cycles are
        proportional to energy, so the live histogram answers it)."""
        return self.percentile("live_cycles", q) * JOULES_PER_CYCLE

    def summary(self, group: int = 0) -> dict:
        """Mirror of ``FleetSweepResult.summary()`` computed from the
        streamed statistics (percentiles to bin resolution)."""
        g = group
        return {
            "devices": int(self.count[g]),
            "completed": int(self.completed[g]),
            "completion_rate": float(self.completion_rate[g]),
            "mean_total_s": float(self.mean("total_s")[g])
            if self.completed[g] else float("inf"),
            "p95_total_s": float(self.percentile("total_s", 95.0)[g])
            if self.completed[g] else float("inf"),
            "mean_reboots": float(self.mean("reboots")[g]),
            "mean_wasted_cycles": float(self.mean("wasted_cycles")[g]),
            "mean_belief_cycles": float(self.mean("belief_cycles")[g]),
            "tx_bytes": float(self.sums["tx_bytes"][g]),
            "msgs_sent": float(self.sums["msgs_sent"][g]),
            "msgs_deferred": float(self.sums["msgs_deferred"][g]),
            "tx_joules": float(self.sums["tx_joules"][g]),
            "wall_s": round(self.wall_s, 3),
            "peak_lane_bytes": int(self.peak_lane_bytes),
        }


def stats_from_outputs(out: dict, edges: dict, group_id=None,
                       n_groups: int = 1,
                       group_labels=None) -> FleetStats:
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
    return FleetStats(
        count=count, completed=completed, sums=sums, sumsqs=sumsqs,
        mins=mins, maxs=maxs, hists=hists,
        edges={ch: np.asarray(e) for ch, e in edges.items()},
        class_sums=class_sums,
        group_labels=None if group_labels is None
        else np.asarray(group_labels))
