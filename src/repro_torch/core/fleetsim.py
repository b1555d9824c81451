"""Fleet-scale intermittent simulator: plan extraction and replay (PyTorch).

The counterpart of the JAX package's ``core/fleetsim.py``.  Every
strategy's charge sequence is first flattened into a :class:`FleetPlan` (a
flat table of rows, built on the host with numpy -- this half is a copy of
the JAX package's), and the replay then advances ``(energy buffer, live
cycles, reboot count, dead time, per-class energy)`` row by row for many
simulated devices at once, one lane per device.  Power failure is a state
transition, not an exception.

The replay takes the same run-time decisions per lane as the JAX package
(see its module docstring): TAILS tile selection from the carried
capacitor, commit granularity under ``policy="adaptive"`` with the
cross-charge window (``batch_rows``) and EWMA belief (``belief_alpha``),
per-reboot dead time from a recharge trace, stochastic per-charge
capacity from a charge trace, and the uplink send/defer decision.

Two replay paths:

* **Stochastic** replays (a charge-capacity trace, or cross-charge
  batching) run the fused event stream of ``kernels/charge_replay``: the
  hand-written CUDA lane kernel on the card, its plain PyTorch version on
  the CPU (``backend="auto"``), or the plain version on either device
  (``backend="torch"``).
* **Deterministic** replays run the closed-form row scan: on the card the
  hand-written ``closed_form_kernel`` (``kernels/csrc/closed_form.cu``,
  one launch a call), on the CPU its plain version (:func:`_scan_step`),
  one row per step.

Both are bit-identical to the JAX package's replay on the same inputs.
The entry points cover the JAX package's surface: ``replay_plans``,
``fleet_sweep`` (of one plan, or of a :class:`PlanSet` of candidates, each
lane reading its candidate's rows through a plan index), ``fleet_evaluate``
and ``capacitor_sweep``; ``reduce="stats"`` (a fixed-size
:class:`~repro_torch.core.fleetstats.FleetStats`, folded on the device by
the ``kernels/stats_fold`` kernel) and ``lane_chunk``/``prefetch`` (the
memory-flat streamed sweep, its host work overlapped with the card),
``mesh=`` (a :class:`~repro_torch.launch.mesh.FleetMesh`: the lanes split
across its shards from this one process, the statistics all-reduced) and
the legacy ``backend="_while"`` oracle (:func:`_while_replay`).  The row
scan's carry is the JAX package's named :class:`ScanState`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..runtime import spans
from .energy import (CLOCK_HZ, Device, JOULES_PER_CYCLE, LEA_COSTS,
                     OP_CLASSES, SOFTWARE_COSTS, class_cycle_vector,
                     make_power_system, rf_recharge_seconds)
from .fleetstats import (FleetStats, default_stat_edges, merge_parts,
                         partial_nbytes, parts_numpy, reduce_lane_outputs)
from .inference import (Conv2D, DenseFC, SimNet, TAILS_FC_ENTRY_COSTS,
                        build_layer_segments, iter_task_spans,
                        naive_layer_cycles, run_naive, sonic_segments,
                        tails_conv_entry_costs, tails_stage_iter_costs,
                        tails_tile_candidates, tails_tile_cost_from,
                        tails_tile_index, tails_tile_schedule)
from .intermittent import (POWER_SYSTEMS, RunResult, STRATEGIES,
                           _alloc_activations, _run_layer_chain)
from .nvstore import NVStore

KIND_WORK = 0
KIND_BURN = 1
KIND_CALIB = 2
KIND_SEND = 3

REPLAY_POLICIES = ("fixed", "adaptive")

_N_CLASSES = len(OP_CLASSES)
_CONTROL_IDX = OP_CLASSES.index("control")
_BURN_IDX = OP_CLASSES.index("lea_mac")
_FRAM_WRITE_IDX = OP_CLASSES.index("fram_write")
_RADIO_IDX = OP_CLASSES.index("radio")
_K_TILES = len(tails_tile_candidates())

#: Scanned row fields shared by every plan.
_ROW_FIELDS = ("kind", "n", "iter_cycles", "entry_cycles", "iter_class",
               "entry_class", "commit_cycles", "commit_class",
               "entry_seg_class", "entry_seg_cycles", "tile_flag")
#: Additional scanned fields of parameterized (TAILS) plans.
_TILE_FIELDS = ("tile_n", "tile_iter_cycles", "tile_iter_class",
                "tile_sel_cost")


#: Replay backends: "auto" runs the CUDA lane kernel for stochastic replays
#: on a CUDA device and the plain PyTorch version on the CPU; "torch" runs
#: the plain version on either device; "cuda" runs the kernel and refuses
#: CPU tensors; "_while" runs the legacy row scan with a data-dependent
#: charge loop a row (:func:`_while_replay`), the differential oracle that
#: "auto" never picks.  Deterministic replays take the closed-form scan
#: whatever the backend.
REPLAY_BACKENDS = ("auto", "torch", "cuda", "_while")

#: ``"none"``: per-lane result arrays; ``"stats"``: one fixed-size
#: :class:`~repro_torch.core.fleetstats.FleetStats` folded on the device.
REPLAY_REDUCES = ("none", "stats")

#: Depth of the overlapped chunk pipeline (``lane_chunk`` with
#: ``prefetch >= 1``): chunks built ahead of the one replaying.
DEFAULT_PREFETCH = 1


# ==========================================================================
# Plan extraction
# ==========================================================================

@dataclass
class FleetPlan:
    """A (net, strategy, power) cell flattened into replayable rows."""

    network: str
    strategy: str
    power: str
    capacity: float              # cycles per charge (inf = continuous)
    recharge_s: float            # mean dead time per reboot
    kind: np.ndarray             # (S,) int32
    n: np.ndarray                # (S,) float64 iterations (0 for atomic rows)
    iter_cycles: np.ndarray      # (S,) float64 cycles per iteration
    entry_cycles: np.ndarray     # (S,) float64 (re-)entry / atomic-unit cost
    iter_class: np.ndarray       # (S, C) float64 per-iteration class cycles
    entry_class: np.ndarray      # (S, C) float64 per-entry class cycles
    commit_cycles: np.ndarray    # (S,) per-iteration commit share of iter
    commit_class: np.ndarray     # (S, C) class vector of that share
    entry_seg_class: np.ndarray  # (S, G) int32 class index per charge block
    entry_seg_cycles: np.ndarray  # (S, G) cycles per charge block (0 = pad)
    tile_flag: np.ndarray        # (S,) int32: 1 = row uses the tile tables
    max_atomic: float            # scalar simulator's non-termination bound
    ref_output: np.ndarray       # continuous-execution output (bit-exact)
    parametric: bool = False     # TAILS tile tables are live
    tile_n: np.ndarray | None = None            # (S, K) iters per candidate
    tile_iter_cycles: np.ndarray | None = None  # (S, K)
    tile_iter_class: np.ndarray | None = None   # (S, K, C)
    tile_sel_cost: np.ndarray | None = None     # (S, K) calibration fit cost

    def __len__(self) -> int:
        return self.kind.shape[0]

    @property
    def total_cycles(self) -> float:
        """Continuous-power cycles (every row completed on first try; for
        parameterized plans, at the nominal capacitor's tile)."""
        return float(np.sum(self.entry_cycles + self.n * self.iter_cycles))


class _RowBuffer:
    def __init__(self, costs, parametric: bool = False):
        self.costs = costs
        self.parametric = parametric
        self.rows: list[tuple] = []

    def _vec(self, counts: dict) -> np.ndarray:
        return np.asarray(class_cycle_vector(self.costs, counts))

    def _segments(self, entry_seq) -> tuple[list, list]:
        """Flatten a charge-ordered sequence of ``(counts, times)`` cost
        dicts into the row's charge-segment list: one ``(class, cycles)``
        block per ``device.charge(op, n * times)`` call the scalar executor
        performs, in execution order.  A torn first attempt walks this list,
        so the burned prefix lands on exactly the classes the scalar's
        per-op accounting charges -- even when one class recurs across the
        sequence's dicts (merged naive / Tile-k rows)."""
        cls, cyc = [], []
        for counts, times in entry_seq:
            for op, k in counts.items():
                c = getattr(self.costs, op) * k * times
                if c > 0:
                    cls.append(OP_CLASSES.index(op))
                    cyc.append(float(c))
        return (cls or [0]), (cyc or [0.0])

    def _append(self, kind, n, iv, ev, cv, segs, tile_flag=0, tile=None):
        if tile is None:
            tile = (np.zeros(_K_TILES), np.zeros(_K_TILES),
                    np.zeros((_K_TILES, _N_CLASSES)), np.zeros(_K_TILES))
        self.rows.append((kind, float(n), float(iv.sum()), float(ev.sum()),
                          iv, ev, float(cv.sum()), cv, segs,
                          int(tile_flag), *tile))

    def work(self, n: int, iter_counts: dict, entry_counts: dict,
             commit_counts: dict | None = None,
             entry_seq: list | None = None) -> None:
        """``entry_seq`` is the charge-ordered ``(counts, times)`` sequence
        the entry cost was merged from; defaults to the single merged dict
        (exact for single-dict rows)."""
        self._append(KIND_WORK, n, self._vec(iter_counts),
                     self._vec(entry_counts), self._vec(commit_counts or {}),
                     self._segments(entry_seq or [(entry_counts, 1.0)]))

    def burn(self) -> None:
        z = np.zeros(_N_CLASSES)
        self._append(KIND_BURN, 0.0, z, z, z, ([0], [0.0]))

    def calib(self, taps: int) -> None:
        """One parameterized calibration for ``taps``: the scan derives the
        per-lane burn count from the lane's capacitor."""
        z = np.zeros(_N_CLASSES)
        sel = np.asarray([tails_tile_cost_from(self.costs, taps, c)
                          for c in tails_tile_candidates()])
        self._append(KIND_CALIB, 0.0, z, z, z, ([0], [0.0]),
                     tile=(np.zeros(_K_TILES), np.zeros(_K_TILES),
                           np.zeros((_K_TILES, _N_CLASSES)), sel))

    def tails_work(self, total: int, taps: int, stage: str,
                   entry_counts: dict, commit_counts: dict,
                   nominal_k: int) -> None:
        """Parameterized TAILS row: one ``(n, iter)`` pair per calibration
        candidate; the direct fields carry the nominal capacitor's pick so
        ``total_cycles`` and non-parameterized consumers stay meaningful."""
        tile_n = np.zeros(_K_TILES)
        tile_ic = np.zeros(_K_TILES)
        tile_iv = np.zeros((_K_TILES, _N_CLASSES))
        sel = np.zeros(_K_TILES)
        for k, cand in enumerate(tails_tile_candidates()):
            t = max(1, min(cand, total))
            iv = self._vec(tails_stage_iter_costs(stage, t, taps))
            tile_n[k] = -(-total // t)
            tile_ic[k] = iv.sum()
            tile_iv[k] = iv
            sel[k] = tails_tile_cost_from(self.costs, taps, cand)
        ev = self._vec(entry_counts)
        cv = self._vec(commit_counts or {})
        self.rows.append((KIND_WORK, tile_n[nominal_k], tile_ic[nominal_k],
                          float(ev.sum()), tile_iv[nominal_k], ev,
                          float(cv.sum()), cv,
                          self._segments([(entry_counts, 1.0)]), 1,
                          tile_n, tile_ic, tile_iv, sel))

    def arrays(self) -> dict:
        cols = list(zip(*self.rows))
        g = max(len(c) for c, _cyc in cols[8])
        seg_cls = np.zeros((len(self.rows), g), np.int32)
        seg_cyc = np.zeros((len(self.rows), g), np.float64)
        for i, (c, cyc) in enumerate(cols[8]):
            seg_cls[i, :len(c)] = c
            seg_cyc[i, :len(cyc)] = cyc
        out = dict(kind=np.asarray(cols[0], np.int32),
                   n=np.asarray(cols[1], np.float64),
                   iter_cycles=np.asarray(cols[2], np.float64),
                   entry_cycles=np.asarray(cols[3], np.float64),
                   iter_class=np.stack(cols[4]).astype(np.float64),
                   entry_class=np.stack(cols[5]).astype(np.float64),
                   commit_cycles=np.asarray(cols[6], np.float64),
                   commit_class=np.stack(cols[7]).astype(np.float64),
                   entry_seg_class=seg_cls,
                   entry_seg_cycles=seg_cyc,
                   tile_flag=np.asarray(cols[9], np.int32))
        if self.parametric:
            out.update(tile_n=np.stack(cols[10]).astype(np.float64),
                       tile_iter_cycles=np.stack(cols[11]).astype(np.float64),
                       tile_iter_class=np.stack(cols[12]).astype(np.float64),
                       tile_sel_cost=np.stack(cols[13]).astype(np.float64))
        return out


#: Per-iteration commit share of SONIC/TAILS loop rows: the single atomic
#: cursor-word FRAM write (what the adaptive policy batches per chunk).
_CURSOR_COMMIT = {"fram_write": 1}


def _cycles(costs, counts: dict) -> float:
    return float(sum(class_cycle_vector(costs, counts)))


def _merge(into: dict, counts: dict, times: float = 1.0) -> None:
    for op, k in counts.items():
        into[op] = into.get(op, 0.0) + k * times


@spans.traced("plan_build", "reference_run")
def _reference_run(net: SimNet, x, strategy: str):
    """Continuous-power scalar execution: bit-exact output + the scalar
    simulator's atomic-region bound (which, for TAILS, is sized with the
    continuously-calibrated tile -- mirroring ``evaluate``'s DNF check)."""
    costs = LEA_COSTS if strategy == "tails" else SOFTWARE_COSTS
    ref_dev = Device(make_power_system("continuous"), costs)
    if strategy == "naive":
        out = run_naive(net, x, ref_dev)
        return np.asarray(out), float(ref_dev.stats.live_cycles)
    out, max_atomic = _run_layer_chain(net, x, ref_dev, strategy)
    return np.asarray(out), float(max_atomic)


def _emit_parametric_tails_layer(buf: _RowBuffer, layer, in_shape,
                                 nominal_k: int) -> None:
    """Rows of one conv/FC layer with per-candidate tile tables, mirroring
    the segment order of ``inference.tails_segments`` exactly."""
    if isinstance(layer, Conv2D):
        co, ho, wo = layer.out_shape(in_shape)
        hw = ho * wo
        ci_n, kh, kw = layer.w.shape[1:]
        for _f in range(co):
            buf.tails_work(hw, kw, "init", {}, _CURSOR_COMMIT, nominal_k)
            for _s in range(ci_n * kh):
                buf.tails_work(hw, kw, "mac", tails_conv_entry_costs(kw),
                               _CURSOR_COMMIT, nominal_k)
            buf.tails_work(hw, kw, "store", {}, _CURSOR_COMMIT, nominal_k)
    else:
        m, n = layer.w.shape
        buf.tails_work(m, 1, "init", {}, _CURSOR_COMMIT, nominal_k)
        for _j in range(n):
            buf.tails_work(m, 1, "mac", dict(TAILS_FC_ENTRY_COSTS),
                           _CURSOR_COMMIT, nominal_k)
        buf.tails_work(m, 1, "store", {}, _CURSOR_COMMIT, nominal_k)


@spans.traced("plan_build")
def build_plan(net: SimNet, x: np.ndarray, strategy: str, power,
               ref: tuple | None = None,
               parametric: bool = False) -> FleetPlan:
    """Flatten one (net, strategy, power) cell into a :class:`FleetPlan`.

    ``power`` is a system name or a :class:`~repro.core.energy.PowerSystem`
    (custom capacitors for sweeps).  ``ref`` is an optional precomputed
    ``(ref_output, max_atomic)`` pair (from :func:`_reference_run`) so
    callers building a whole power row can amortize the single continuous
    scalar pass per strategy.  ``parametric=True`` (TAILS only) emits
    per-candidate tile tables and ``CALIB`` rows instead of baking the
    nominal capacitor's tile, so one plan replays across capacitor grids.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    if parametric and strategy != "tails":
        raise ValueError("parametric plans exist only for TAILS "
                         "(tile calibration is the power-dependent choice)")
    power_sys = make_power_system(power)
    costs = LEA_COSTS if strategy == "tails" else SOFTWARE_COSTS
    capacity = math.inf if power_sys.continuous else power_sys.cycles_per_charge
    ref_out, max_atomic = ref if ref is not None else \
        _reference_run(net, x, strategy)
    buf = _RowBuffer(costs, parametric=parametric)

    if strategy == "naive":
        # The whole inference is one atomic unit: naive accumulates in
        # registers and has no commits, so any power failure restarts it
        # from scratch (a single row re-paying everything on each retry).
        # The per-layer dicts are kept as the row's charge-segment list so
        # a torn attempt books its burned prefix to exactly the (layer, op)
        # blocks the scalar executor charges, in order.
        probe = Device(make_power_system("continuous"), costs)
        counts: dict = {}
        seq: list = []
        for layer, in_shape in zip(net.layers, net.shapes()):
            lc = naive_layer_cycles(probe, layer, in_shape)
            _merge(counts, lc)
            seq.append((lc, 1.0))
        buf.work(0, {}, counts, entry_seq=seq)
        return FleetPlan(net.name, strategy, power_sys.name, capacity,
                         power_sys.recharge_s, max_atomic=max_atomic,
                         ref_output=ref_out, **buf.arrays())

    nv = NVStore(None)
    names = _alloc_activations(nv, net, x)
    probe = Device(make_power_system("continuous"), costs)
    tile_k = int(strategy.split("-")[1]) if strategy.startswith("tile") else 0
    calibrated: dict[int, int] = {}      # taps -> burn count (tails)
    shapes = net.shapes()

    with spans.span("plan_build", "rows"):
        for pc, layer in enumerate(net.layers):
            if strategy == "tails":
                # Pre-seed the capacity-calibrated tile (pure schedule) and
                # emit the charge-burning discovery attempts -- as BURN rows
                # baked for this capacitor, or as one CALIB row whose burn
                # count the scan derives per lane -- in the first-use order
                # the scalar executor performs them.
                t = layer.w.shape[3] if isinstance(layer, Conv2D) else \
                    1 if isinstance(layer, DenseFC) else None
                if t is not None and t not in calibrated:
                    tile, burns = tails_tile_schedule(costs, capacity, t)
                    calibrated[t] = burns
                    if parametric:
                        buf.calib(t)
                    else:
                        nv.alloc(f"tails/tile/{t}", (), np.int64,
                                 init=tile)
                        if not power_sys.continuous:
                            for _ in range(burns):
                                buf.burn()
            if parametric and isinstance(layer, (Conv2D, DenseFC)):
                t = layer.w.shape[3] if isinstance(layer, Conv2D) else 1
                _emit_parametric_tails_layer(
                    buf, layer, shapes[pc],
                    nominal_k=tails_tile_index(costs, capacity, t))
            else:
                if parametric:
                    segs = sonic_segments(nv, layer, names[pc],
                                          names[pc + 1], f"L{pc}")
                else:
                    segs = build_layer_segments(nv, probe, layer, names[pc],
                                                names[pc + 1], f"L{pc}",
                                                strategy)
                if strategy in ("sonic", "tails"):
                    for s in segs:
                        buf.work(s.n, s.iter_costs, s.seg_costs,
                                 _CURSOR_COMMIT)
                else:
                    # Tile-k: enumerate the actual tasks (a task may span
                    # segment boundaries), each an atomic redo-log + commit
                    # + transition.  The span-ordered dicts are the row's
                    # charge-segment list (the scalar runner charges seg
                    # entry, then iters, per span, then the commit walk).
                    for u, hi, task in iter_task_spans(segs, tile_k):
                        counts = {}
                        seq = []
                        for seg, lo_l, hi_l in task:
                            _merge(counts, seg.seg_costs)
                            seq.append((seg.seg_costs, 1.0))
                            _merge(counts, seg.iter_costs, hi_l - lo_l)
                            seq.append((seg.iter_costs, float(hi_l - lo_l)))
                        tail = {"commit_word": hi - u,
                                "task_transition": 1}
                        _merge(counts, tail)
                        seq.append((tail, 1.0))
                        buf.work(0, {}, counts, entry_seq=seq)
            # Layer-boundary commit: one atomic NV word (the layer cursor).
            buf.work(0, {}, {"fram_write": 1})

    return FleetPlan(net.name, strategy, power_sys.name, capacity,
                     power_sys.recharge_s, max_atomic=max_atomic,
                     ref_output=ref_out, parametric=parametric,
                     **buf.arrays())


def with_uplink(plan: FleetPlan) -> FleetPlan:
    """Append the decision-5 uplink row: one ``KIND_SEND`` row whose cost
    the replay derives per lane at run time from the lane's classifier
    confidence and the packed radio vector (``runtime.radio``).

    The row's static cost fields are all zero (``entry_cycles=0``, so
    ``total_cycles`` and every non-uplink consumer are unchanged, and a
    replay without a radio model passes the row through as a no-op); its
    single charge segment is statically classed ``radio`` so a torn
    transmission's burned prefix books to the radio op class.  Idempotent:
    a plan already ending in a SEND row is returned as-is."""
    if len(plan) and plan.kind[-1] == KIND_SEND:
        return plan

    def app(a, row):
        a = np.asarray(a)
        return np.concatenate([a, np.asarray(row, a.dtype)[None]], axis=0)

    g = plan.entry_seg_class.shape[1]
    z = np.zeros(_N_CLASSES)
    seg_cls = np.zeros(g, np.int32)
    seg_cls[0] = _RADIO_IDX
    fields = dict(
        kind=app(plan.kind, KIND_SEND),
        n=app(plan.n, 0.0),
        iter_cycles=app(plan.iter_cycles, 0.0),
        entry_cycles=app(plan.entry_cycles, 0.0),
        iter_class=app(plan.iter_class, z),
        entry_class=app(plan.entry_class, z),
        commit_cycles=app(plan.commit_cycles, 0.0),
        commit_class=app(plan.commit_class, z),
        entry_seg_class=app(plan.entry_seg_class, seg_cls),
        entry_seg_cycles=app(plan.entry_seg_cycles, np.zeros(g)),
        tile_flag=app(plan.tile_flag, 0))
    if plan.parametric:
        fields.update(
            tile_n=app(plan.tile_n, np.zeros(_K_TILES)),
            tile_iter_cycles=app(plan.tile_iter_cycles,
                                 np.zeros(_K_TILES)),
            tile_iter_class=app(plan.tile_iter_class,
                                np.zeros((_K_TILES, _N_CLASSES))),
            tile_sel_cost=app(plan.tile_sel_cost, np.zeros(_K_TILES)))
    return dataclasses.replace(plan, **fields)



def _pad_axis0(a: np.ndarray, pad: int) -> np.ndarray:
    return np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1))


def _pad_stack(plans: list[FleetPlan]) -> dict:
    """Stack plans of different lengths; padding rows are no-op WORK rows.
    Trailing axes that vary per plan (the charge-segment axis) are padded
    to the batch maximum too (zero-length segments book nothing).  Tile
    tables are included iff any plan is parameterized (zero-filled for the
    rest: ``tile_flag=0`` rows never read them)."""
    smax = max(len(p) for p in plans)
    fields = _ROW_FIELDS + (_TILE_FIELDS if any(p.parametric for p in plans)
                            else ())
    out: dict[str, list] = {k: [] for k in fields}
    for p in plans:
        pad = smax - len(p)
        for k in fields:
            v = getattr(p, k)
            if v is None:      # fixed plan in a mixed batch: zero tables
                shape = ((len(p), _K_TILES, _N_CLASSES)
                         if k == "tile_iter_class" else (len(p), _K_TILES))
                v = np.zeros(shape)
            out[k].append(_pad_axis0(v, pad))
    stacked = {}
    for k, vs in out.items():
        if vs[0].ndim > 1:
            gmax = tuple(max(v.shape[i] for v in vs)
                         for i in range(1, vs[0].ndim))
            vs = [np.pad(v, [(0, 0)] + [(0, g - s) for g, s in
                                        zip(gmax, v.shape[1:])])
                  for v in vs]
        stacked[k] = np.stack(vs)
    return stacked


def _plan_rows(plan: FleetPlan) -> dict:
    fields = _ROW_FIELDS + (_TILE_FIELDS if plan.parametric else ())
    return {k: getattr(plan, k) for k in fields}


def _bucket_target(s: int, floor: int = 64) -> int:
    """The power-of-two row-bucket a plan of ``s`` rows is padded to."""
    return max(floor, 1 << max(s - 1, 0).bit_length())


@spans.traced("entry", host_only=True)
def _bucket_rows(rows: dict, lane_axis) -> dict:
    """Pad the plan's row axis to a power-of-two bucket (>= 64) and the
    charge-segment axis to a power-of-two bucket (>= 4), the JAX
    package's shapes.  Padding rows are all-zero WORK rows -- both replay
    paths complete them for free without touching any output channel --
    and the event stream's ``s_real`` cursor bound never walks them
    anyway.  ``lane_axis`` is ``False`` for a single shared plan (row
    axis 0), and ``True`` or ``"plan"`` for a leading axis (per-plan
    lanes / the stacked candidate axis)."""
    ax = 0 if lane_axis is False else 1
    s = rows["kind"].shape[ax]
    target = _bucket_target(s)
    out = {}
    for k, v in rows.items():
        v = np.asarray(v)
        pads = [(0, 0)] * v.ndim
        pads[ax] = (0, target - s)
        if k in ("entry_seg_class", "entry_seg_cycles"):
            g = v.shape[-1]
            pads[-1] = (0, max(4, 1 << max(g - 1, 0).bit_length()) - g)
        out[k] = v if all(p == (0, 0) for p in pads) else np.pad(v, pads)
    return out


def _reboot_upper_bound(rows: dict, caps: np.ndarray,
                        lane_axis) -> np.ndarray:
    """Cheap per-lane estimate of how many reboots a replay can plausibly
    take: nominal plan cycles over the nominal charge (with a 4x safety
    margin for jitter, torn-prefix re-execution and adaptive drains),
    plus one reboot per BURN row and a full ladder per CALIB row.  Used
    only to decide whether the event stream's all-nominal fast path is
    *reachable* (``reboots >= nominal_from``); an under-estimate never
    changes results, the charge-wise step just walks the nominal tail one
    charge at a time.  With a stacked candidate axis (``"plan"``) the
    worst-case plan bounds every lane."""
    ax = 0 if lane_axis is False else 1
    work = np.sum(rows["entry_cycles"]
                  + rows["n"] * (rows["iter_cycles"]
                                 + rows["commit_cycles"]), axis=ax)
    if "tile_n" in rows:
        work = work + np.sum(
            np.max(rows["tile_n"] * rows["tile_iter_cycles"], axis=-1),
            axis=ax)
    burns = (np.sum(rows["kind"] == KIND_BURN, axis=ax)
             + _K_TILES * np.sum(rows["kind"] == KIND_CALIB, axis=ax))
    if lane_axis == "plan":
        work = np.max(work)
        burns = np.max(burns)
    with np.errstate(invalid="ignore"):
        est = np.where(np.isinf(caps), 0.0, 4.0 * work / caps)
    return est + burns


@dataclass
class PlanSet:
    """A stacked batch of candidate plans -- the design axis.

    Where :class:`FleetPlan` is one (network, strategy, power) cell, a
    ``PlanSet`` is P of them stacked into one ``(P, S, ...)`` row-table
    batch (per-plan row counts bucket-padded to a shared power of two)
    plus a per-plan header: strategy, real row count, capacity, recharge,
    nominal cycles.  ``fleet_sweep(plan=planset)`` replays the whole set
    in one launch: lanes are plan-major (``lane = p * n_devices + d``),
    each lane carries its candidate index into the packed ``(P, S, F)``
    row table, and per-plan statistics come back as
    :class:`~repro_torch.core.fleetstats.FleetStats` groups or a
    :class:`DesignSweepResult`.

    The unchunked design sweep draws each plan's lanes with the legacy
    samplers and seeds an individual ``fleet_sweep(plan=plans[p])`` call
    uses, so the stacked sweep's per-plan outputs are bitwise equal to
    replaying each plan separately."""
    plans: tuple
    labels: tuple
    rows: dict                  # (P, S, ...) bucket-padded row tables
    n_rows: np.ndarray          # (P,) int32 real (pre-padding) row counts
    capacity: np.ndarray        # (P,) float64 cycles per full charge
    recharge_s: np.ndarray      # (P,) float64 mean dead time per reboot
    total_cycles: np.ndarray    # (P,) float64 nominal plan cycles
    strategies: tuple

    def __len__(self) -> int:
        return len(self.plans)

    @property
    def parametric(self) -> bool:
        return "tile_sel_cost" in self.rows

    @classmethod
    @spans.traced("plan_build", "from_plans")
    def from_plans(cls, plans, labels=None) -> "PlanSet":
        plans = tuple(plans)
        if not plans:
            raise ValueError("PlanSet needs at least one plan")
        if labels is None:
            labels = tuple(f"{p.network}/{p.strategy}/{p.power}"
                           for p in plans)
        labels = tuple(labels)
        if len(labels) != len(plans):
            raise ValueError(f"got {len(labels)} labels for "
                             f"{len(plans)} plans")
        rows = _bucket_rows(_pad_stack(list(plans)), lane_axis="plan")
        return cls(
            plans=plans, labels=labels, rows=rows,
            n_rows=np.asarray([len(p) for p in plans], np.int32),
            capacity=np.asarray([p.capacity for p in plans], np.float64),
            recharge_s=np.asarray([p.recharge_s for p in plans],
                                  np.float64),
            total_cycles=np.asarray([p.total_cycles for p in plans],
                                    np.float64),
            strategies=tuple(p.strategy for p in plans))


# ==========================================================================
# Replay
# ==========================================================================

class ScanState(NamedTuple):
    """Named carry of the row scan (the JAX package's ``ScanState``): one
    ``(N,)`` tensor a lane scalar, ``(N, C)`` for the class vectors."""
    rem: torch.Tensor           # actual remaining budget this charge
    bel: torch.Tensor           # believed remaining budget this charge
    live: torch.Tensor
    reboots: torch.Tensor
    dead: torch.Tensor
    classes: torch.Tensor
    wasted: torch.Tensor
    stuck: torch.Tensor
    pend: torch.Tensor          # pending-window cycles (cross-charge batching)
    pend_class: torch.Tensor
    pend_rows: torch.Tensor
    bhat: torch.Tensor          # EWMA believed per-charge budget
    chg: torch.Tensor           # cycles spent so far in the current charge
    tx: torch.Tensor            # uplink bytes shipped (decision 5)
    sent: torch.Tensor          # uplink transmissions completed
    deferred: torch.Tensor      # sends deferred past a closed window


def _scan_state0(cap, rem0) -> ScanState:
    """The row scan's initial carry: a full believed budget, nothing
    spent, every state entry its own tensor (the scan advances it in
    place)."""
    n = cap.shape[0]
    zero = torch.zeros_like(rem0)
    zc = torch.zeros((n, _N_CLASSES), dtype=torch.float64,
                     device=cap.device)
    st = ScanState(
        rem=rem0, bel=rem0, live=zero, reboots=zero, dead=zero,
        classes=zc, wasted=zero,
        stuck=torch.zeros(n, dtype=torch.bool, device=cap.device),
        pend=zero, pend_class=zc, pend_rows=zero, bhat=cap + zero,
        chg=zero, tx=zero, sent=zero, deferred=zero)
    return ScanState(*(v.clone() for v in st))


def _scan_outputs(st: ScanState) -> dict:
    return dict(live=st.live, reboots=st.reboots, dead=st.dead,
                classes=st.classes, wasted=st.wasted, stuck=st.stuck,
                rem=st.rem, belief=st.bhat, tx_bytes=st.tx,
                msgs_sent=st.sent, msgs_deferred=st.deferred)


def _scan_step(cap, trace_cum, tail_s, theta, conf, radio,
               adaptive: bool, parametric: bool, has_send: bool,
               st: ScanState, row: dict, charge_cum=None,
               window: float = 1.0, alpha: float = 0.0,
               stochastic: bool = False) -> ScanState:
    """Advance every lane over one plan row.

    Deterministic (``stochastic=False``): every charge delivers exactly
    ``cap``, so an ``n``-iteration row's reboots collapse to the closed
    form (the event stream's
    :func:`~repro_torch.kernels.charge_replay.fast_forward` applied to a
    fresh row), and BURN/CALIB rows burn whole nominal charges.

    Stochastic (the legacy ``backend="_while"`` oracle): the row runs
    charge by charge (:func:`~repro_torch.kernels.charge_replay.charge_once`)
    until every lane is done, a done lane keeping its state; refill ``r``
    delivers ``trace_window(charge_cum, r - 1, r, cap)``.  Every row step
    is a fresh row entry, so a SEND row's closed-window check is
    unconditional here."""
    from ..kernels.charge_replay import (ChargeState, _add_at, _select,
                                         _where, charge_once, fast_forward,
                                         row_ctx, send_defer_wait,
                                         trace_window)

    ctx = row_ctx(row, cap, theta, adaptive, parametric,
                  conf=conf, radio=radio, has_send=has_send)
    zero = torch.zeros_like(cap)
    send_wait = torch.zeros_like(st.dead)
    defer_now = torch.zeros_like(st.stuck)
    if has_send:
        is_send = row["kind"] == KIND_SEND
        want_send = is_send & (ctx.send_bytes > 0.0) & ~ctx.row_stuck
        closed, wait = send_defer_wait(st.live, st.dead, radio)
        defer_now = want_send & closed
        send_wait = torch.where(defer_now, wait, zero)

    passthrough = row["kind"] != KIND_WORK
    if has_send:
        passthrough = passthrough & (row["kind"] != KIND_SEND)
    cs0 = ChargeState(
        rem=st.rem, bel=st.bel, left=ctx.n, live=st.live,
        reboots=st.reboots, classes=st.classes, wasted=st.wasted,
        pend=st.pend, pend_class=st.pend_class, pend_rows=st.pend_rows,
        bhat=st.bhat, chg=st.chg, debt=torch.zeros_like(cap),
        debt_class=torch.zeros_like(st.pend_class),
        stuck=st.stuck, done=passthrough)
    if not stochastic:
        out = fast_forward(ctx, cap, theta, adaptive, cs0)
    else:
        out = cs0
        while bool((~out.done).any()):     # one host check a charge
            out = _select(out.done, out,
                          charge_once(ctx, cap, charge_cum, theta, window,
                                      alpha, adaptive, out))
            _while_replay.charge_steps += 1

    def refill_sum(r0, r1):
        """Total capacity of refills (r0, r1]; past-trace refills fall
        back to the nominal ``cap``."""
        return trace_window(charge_cum, r0, r1, cap)

    rem, bel, live, reboots = st.rem, st.bel, st.live, st.reboots
    classes, bhat = st.classes, st.bhat
    new_rem, new_bel, new_live = out.rem, out.bel, out.live
    new_reboots, new_classes = out.reboots, out.classes
    new_stuck, new_wasted, new_chg = out.stuck, out.wasted, out.chg

    # BURN rows: a failed calibration attempt drains the whole buffer
    is_burn = row["kind"] == KIND_BURN
    new_rem = torch.where(is_burn, refill_sum(reboots, reboots + 1.0)
                          if stochastic else cap, new_rem)
    new_bel = torch.where(is_burn, bhat, new_bel)
    new_live = torch.where(is_burn, live + rem, new_live)
    new_reboots = torch.where(is_burn, reboots + 1.0, new_reboots)
    burn_vec = _add_at(torch.zeros_like(classes), _BURN_IDX, rem)
    new_classes = _where(is_burn, classes + burn_vec, new_classes)
    new_stuck = torch.where(is_burn, st.stuck, new_stuck)
    new_wasted = torch.where(is_burn, st.wasted, new_wasted)
    new_chg = torch.where(is_burn, zero, new_chg)

    # CALIB rows: per-lane burn count from the capacitor (Sec. 7.1)
    if parametric:
        is_calib = row["kind"] == KIND_CALIB
        burns = ctx.k.to(rem.dtype)
        if stochastic:
            calib_live = torch.where(
                burns > 0,
                rem + refill_sum(reboots, reboots + burns - 1.0), zero)
            calib_rem = torch.where(
                burns > 0,
                refill_sum(reboots + burns - 1.0, reboots + burns), rem)
        else:
            calib_live = torch.where(burns > 0, rem + (burns - 1.0) * cap,
                                     zero)
            calib_rem = torch.where(burns > 0, cap, rem)
        new_rem = torch.where(is_calib, calib_rem, new_rem)
        new_bel = torch.where(is_calib, torch.where(burns > 0, bhat, bel),
                              new_bel)
        new_live = torch.where(is_calib, live + calib_live, new_live)
        new_reboots = torch.where(is_calib, reboots + burns, new_reboots)
        calib_vec = _add_at(torch.zeros_like(classes), _BURN_IDX, calib_live)
        new_classes = _where(is_calib, classes + calib_vec, new_classes)
        new_stuck = torch.where(is_calib, st.stuck, new_stuck)
        new_wasted = torch.where(is_calib, st.wasted, new_wasted)
        new_chg = torch.where(is_calib & (burns > 0), zero, new_chg)

    # decision 3: per-reboot dead time (the window wait adds first)
    new_dead = (st.dead + send_wait) + trace_window(
        trace_cum, reboots, new_reboots, tail_s)

    tx, sent, deferred = st.tx, st.sent, st.deferred
    if has_send:
        adv_tx = is_send & ~ctx.row_stuck
        tx = tx + torch.where(adv_tx, ctx.send_bytes, zero)
        sent = sent + torch.where(adv_tx & (ctx.send_bytes > 0.0),
                                  torch.ones_like(cap), zero)
        deferred = deferred + torch.where(defer_now, torch.ones_like(cap),
                                          zero)
    return ScanState(new_rem, new_bel, new_live, new_reboots, new_dead,
                     new_classes, new_wasted, new_stuck, out.pend,
                     out.pend_class, out.pend_rows, out.bhat, new_chg, tx,
                     sent, deferred)


@spans.traced("closed_form")
def _scan_replay(rows, cap, rem0, trace_cum, tail_s, theta, conf,
                 radio, *, adaptive: bool, parametric: bool,
                 shared_rows, has_send: bool, plan_idx=None) -> dict:
    """The deterministic closed-form replay: :func:`_scan_step` over every
    row of the (padded) table, all lanes at once.  CPU tensors take the
    plain version, a loop of row steps (:func:`_replay_rows`); CUDA tensors
    launch ``closed_form_kernel`` once (``kernels.closed_form``: one thread
    a lane walks every row with the same operations in the same order, so
    the same bits; ``closed_form.closed_form.launches`` counts its
    launches).  ``_replay_rows.rows`` counts the rows either path ran."""
    from ..kernels import closed_form
    from ..kernels.charge_replay import _packed, row_mode, unpack_row

    packed, layout = _packed(rows, shared_rows)
    if cap.device.type == "cuda":
        out = closed_form.closed_form(
            packed, layout, cap, rem0, trace_cum, tail_s, theta, conf,
            radio, adaptive=adaptive, parametric=parametric,
            mode=row_mode(shared_rows), has_send=has_send,
            plan_idx=plan_idx)
        _replay_rows.rows += packed.shape[-2]
        return out
    if cap.device.type != "cpu":
        raise ValueError(f"the closed form runs on CUDA or CPU tensors, "
                         f"got {cap.device}")
    plan = None if plan_idx is None else plan_idx.to(torch.int64)
    st = _scan_state0(cap, rem0)
    cursor = torch.zeros(cap.shape[0], dtype=torch.int64, device=cap.device)

    def row_step():
        new = _scan_step(cap, trace_cum, tail_s, theta, conf, radio,
                         adaptive, parametric, has_send, st,
                         unpack_row(packed, layout, cursor, plan))
        for dst, src in zip(st, new):
            dst.copy_(src)
        cursor.add_(1)

    _replay_rows(row_step, packed.shape[-2])
    return _scan_outputs(st)


def _while_replay(rows, cap, rem0, trace_cum, tail_s, charge_cum, theta,
                  window, alpha, conf, radio, *, adaptive: bool,
                  parametric: bool, shared_rows, has_send: bool,
                  plan_idx=None) -> dict:
    """The legacy ``backend="_while"`` replay of a stochastic plan, the
    differential oracle of the fused event stream: a scan over every row
    of the (bucket-padded) table in which each row runs a data-dependent
    charge loop (:func:`_scan_step` with ``stochastic=True``).  With a
    ``(P, S, F)`` pack each lane's candidate rows are gathered first, as
    the JAX package's legacy path does.  Eager on either device, one host
    check of the lanes' ``done`` a charge; ``_while_replay.charge_steps``
    counts the charges run."""
    from ..kernels.charge_replay import _packed, unpack_row

    packed, layout = _packed(rows, shared_rows)
    if plan_idx is not None:
        packed = packed[plan_idx.to(torch.int64)]
    st = _scan_state0(cap, rem0)
    n = cap.shape[0]
    for i in range(packed.shape[-2]):
        cursor = torch.full((n,), i, dtype=torch.int64, device=cap.device)
        st = _scan_step(cap, trace_cum, tail_s, theta, conf, radio,
                        adaptive, parametric, has_send, st,
                        unpack_row(packed, layout, cursor),
                        charge_cum=charge_cum, window=window, alpha=alpha,
                        stochastic=True)
    return _scan_outputs(st)


_while_replay.charge_steps = 0


def _replay_rows(row_step, n_rows: int) -> None:
    """The closed form's plain loop: run ``row_step`` (which advances its
    state in place) ``n_rows`` times, counted in ``_replay_rows.rows``,
    under the span ``closed_form/replay_loop``."""
    _replay_rows.rows += n_rows
    with spans.span("closed_form", "replay_loop"):
        for _ in range(n_rows):
            row_step()


_replay_rows.rows = 0


def _validate_replay_knobs(policy: str, batch_rows: int,
                           belief_alpha: float, backend: str,
                           reduce: str = "none") -> None:
    if policy not in REPLAY_POLICIES:
        raise ValueError(f"unknown replay policy {policy!r}; "
                         f"expected one of {REPLAY_POLICIES}")
    if batch_rows < 1:
        raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
    if not 0.0 <= belief_alpha < 1.0:
        raise ValueError(f"belief_alpha must be in [0, 1), "
                         f"got {belief_alpha}")
    if backend not in REPLAY_BACKENDS:
        raise ValueError(f"unknown replay backend {backend!r}; "
                         f"expected one of {REPLAY_BACKENDS}")
    if reduce not in REPLAY_REDUCES:
        raise ValueError(f"unknown reduce mode {reduce!r}; "
                         f"expected one of {REPLAY_REDUCES}")


def _check_mesh(mesh, device) -> None:
    """A ``mesh=`` must be a :class:`~repro_torch.launch.mesh.FleetMesh`
    whose shards are on the kind of device the call runs on."""
    from ..launch.mesh import FleetMesh

    if mesh is None:
        return
    if not isinstance(mesh, FleetMesh):
        raise TypeError(f"mesh= takes a FleetMesh "
                        f"(repro_torch.launch.mesh.make_fleet_mesh), got "
                        f"{type(mesh).__name__}")
    dev = resolve_device(device)
    if any(d.type != dev.type for d in mesh.devices):
        raise ValueError(f"the mesh's shards are on "
                         f"{sorted({d.type for d in mesh.devices})}, the "
                         f"call runs on {dev.type!r}")


@dataclass
class _Prepared:
    """One replay call's inputs after the host's preparation (the JAX
    package's ``_run_replay`` prologue): numpy arrays, and the static flags
    that choose the path."""
    rows: dict | None           # row tables (bucketed when stochastic)
    caps: np.ndarray
    rem0: np.ndarray
    trace_cum: np.ndarray
    tail_s: np.ndarray
    charge_cum: np.ndarray
    nominal_from: np.ndarray
    s_real: np.ndarray
    conf: np.ndarray
    radio: np.ndarray
    plan_idx: np.ndarray | None
    adaptive: bool
    parametric: bool
    stochastic: bool
    enable_fast: bool
    has_burn: bool
    has_send: bool
    chunk: int


@spans.traced("entry", host_only=True)
def _prepare(rows: dict, caps, rem0, shared_rows, trace_cum=None,
             tail_s=None, policy: str = "fixed", batch_rows: int = 1,
             charge_cum=None, n_rows=None, chunk=None, conf=None,
             radio=None, plan_idx=None, bucketed: bool = False
             ) -> _Prepared:
    """The host half of a replay call: the stochastic path's whole-cycle
    initial charges, row bucketing and charge-trace padding, the
    fast-path reachability flag and the defaults of the missing inputs.
    ``bucketed=True`` says ``rows`` are bucket-padded already (a streamed
    sweep pads them once)."""
    from ..kernels.charge_replay import EVENT_CHUNK, default_event_chunk
    from ..runtime.failures import (charge_trace_nominal_from,
                                    pad_charge_trace_columns)
    from ..runtime.radio import N_RADIO, radio_vector

    n_lanes = caps.shape[0]
    plan_mode = shared_rows == "plan"
    if plan_mode and plan_idx is None:
        raise ValueError("shared_rows='plan' needs a per-lane plan_idx")
    parametric = "tile_sel_cost" in rows
    adaptive = policy == "adaptive"
    has_send = radio is not None and bool(np.any(rows["kind"] == KIND_SEND))
    radio_vec = radio_vector(radio) if radio is not None \
        else np.zeros(N_RADIO, np.float64)
    if conf is None:
        conf = np.zeros(n_lanes, np.float64)
    # Cross-charge batching needs the charge boundaries even without a
    # capacity trace: it rides the charge-by-charge path.
    stochastic = charge_cum is not None or (adaptive and batch_rows > 1)
    # On the charge-wise path the initial charge is floored to whole
    # cycles, keeping every energy quantity an exact integer in float64
    # (the closed-form fast path depends on it).
    if stochastic:
        rem0 = np.where(np.isinf(rem0), np.inf,
                        np.floor(np.asarray(rem0, np.float64)))
    s_axis = 0 if shared_rows is True else 1
    lane_axis = "plan" if plan_mode else not (shared_rows is True)
    s_real = np.broadcast_to(
        np.asarray(n_rows if n_rows is not None
                   else rows["kind"].shape[s_axis], np.int32), (n_lanes,))
    enable_fast = has_burn = False
    nominal_from = np.zeros(n_lanes, np.float64)
    if stochastic:
        has_burn = bool(np.any(rows["kind"] == KIND_BURN))
        if not bucketed:
            rows = _bucket_rows(rows, lane_axis=lane_axis)
        if charge_cum is not None:
            charge_cum = pad_charge_trace_columns(charge_cum, caps)
            nominal_from = charge_trace_nominal_from(charge_cum, caps)
            enable_fast = bool(np.any(
                _reboot_upper_bound(rows, caps, lane_axis)
                >= nominal_from))
        else:
            enable_fast = True
    # the bounds the lane kernel's wrapper would read back from the card,
    # checked here on the host before the upload
    s_pad = rows["kind"].shape[s_axis]
    if n_lanes and int(np.max(s_real)) > s_pad:
        raise ValueError(f"n_rows exceeds the {s_pad}-row table")
    seg = np.asarray(rows["entry_seg_class"])
    if seg.size and not (0 <= seg.min() and seg.max() < _N_CLASSES):
        raise ValueError("entry_seg_class holds an op class out of range")
    if plan_mode and n_lanes and not (
            0 <= np.min(plan_idx)
            and np.max(plan_idx) < rows["kind"].shape[0]):
        raise ValueError(f"plan_idx holds a plan out of "
                         f"[0, {rows['kind'].shape[0]})")
    if chunk is None or chunk == "auto":
        chunk = (default_event_chunk(s_pad) if stochastic else EVENT_CHUNK)
    if trace_cum is None:
        trace_cum = np.zeros((n_lanes, 1), np.float64)
    if charge_cum is None:
        charge_cum = np.zeros((n_lanes, 1), np.float64)
    if tail_s is None:
        tail_s = np.zeros(n_lanes, np.float64)
    return _Prepared(
        rows=rows, caps=np.asarray(caps, np.float64),
        rem0=np.asarray(rem0, np.float64),
        trace_cum=np.asarray(trace_cum, np.float64),
        tail_s=np.broadcast_to(np.asarray(tail_s, np.float64), (n_lanes,)),
        charge_cum=np.asarray(charge_cum, np.float64),
        nominal_from=nominal_from, s_real=s_real,
        conf=np.broadcast_to(np.asarray(conf, np.float64), (n_lanes,)),
        radio=radio_vec,
        plan_idx=None if plan_idx is None
        else np.asarray(plan_idx, np.int32),
        adaptive=adaptive, parametric=parametric, stochastic=stochastic,
        enable_fast=enable_fast, has_burn=has_burn, has_send=has_send,
        chunk=int(chunk))


#: The per-lane inputs of a replay call, in ``_Prepared``'s names.
_LANE_INPUTS = ("caps", "rem0", "trace_cum", "tail_s", "charge_cum",
                "nominal_from", "s_real", "conf", "plan_idx")


def _tensor(a, dev, pinned: bool = False):
    """A numpy array as a tensor on ``dev``: a copy, through pinned memory
    and without waiting (the current stream does the copy) when
    ``pinned``."""
    a = np.ascontiguousarray(a)
    if not pinned:
        return torch.tensor(a, device=dev)
    return torch.from_numpy(a).pin_memory().to(dev, non_blocking=True)


@spans.traced("entry")
def _upload(prep: _Prepared, dev, pinned: bool = False) -> dict:
    """The per-lane inputs (and the radio vector) of ``prep`` as tensors on
    ``dev``."""
    out = {k: _tensor(getattr(prep, k), dev, pinned)
           for k in _LANE_INPUTS if getattr(prep, k) is not None}
    out["radio"] = _tensor(prep.radio, dev, pinned)
    return out


@spans.traced("entry")
def _device_rows(rows: dict, dev, shared_rows, stochastic: bool):
    """A row dict on ``dev``: packed once (:class:`PackedRows`) for the
    event stream, field by field for the closed-form scan."""
    from ..kernels.charge_replay import PackedRows

    t_rows = {k: torch.tensor(np.asarray(v), device=dev)
              for k, v in rows.items()}
    return PackedRows(t_rows, shared_rows) if stochastic else t_rows


@spans.traced("entry")
def _dispatch(prep: _Prepared, t: dict, rows, shared_rows, theta: float,
              batch_rows: int, belief_alpha: float, backend: str,
              reduce: str = "none", stats_in: tuple | None = None,
              host_checked: bool = False):
    """Launch one replay on tensors ``t`` (:func:`_upload`) with row tables
    ``rows`` on their device: the closed-form scan, the plain event stream
    (``backend="torch"``) or the lane kernel's wrapper (its plain version
    on CPU tensors).  ``reduce="stats"`` folds the outputs into a stats
    partial on the device with ``stats_in = (group_id, valid, edges,
    n_groups)`` (tensors there); else the per-lane output tensors come
    back."""
    from ..kernels.charge_replay import charge_replay, event_replay

    plan_idx = t.get("plan_idx")
    if not prep.stochastic:
        out = _scan_replay(rows, t["caps"], t["rem0"], t["trace_cum"],
                           t["tail_s"], float(theta), t["conf"],
                           t["radio"], adaptive=prep.adaptive,
                           parametric=prep.parametric,
                           shared_rows=shared_rows,
                           has_send=prep.has_send, plan_idx=plan_idx)
    else:
        args = (rows, t["caps"], t["rem0"], t["trace_cum"], t["tail_s"],
                t["charge_cum"], t["nominal_from"], t["s_real"],
                float(theta), float(batch_rows), float(belief_alpha))
        kw = dict(adaptive=prep.adaptive, parametric=prep.parametric,
                  shared_rows=shared_rows, enable_fast=prep.enable_fast,
                  has_burn=prep.has_burn, has_send=prep.has_send,
                  conf=t["conf"], radio=t["radio"], chunk=prep.chunk,
                  plan_idx=plan_idx)
        if backend == "_while":
            out = _while_replay(
                rows, t["caps"], t["rem0"], t["trace_cum"], t["tail_s"],
                t["charge_cum"], float(theta), float(batch_rows),
                float(belief_alpha), t["conf"], t["radio"],
                adaptive=prep.adaptive, parametric=prep.parametric,
                shared_rows=shared_rows, has_send=prep.has_send,
                plan_idx=plan_idx)
        elif backend == "torch":
            out = event_replay(*args, **kw)
        elif host_checked:
            out = charge_replay(*args, host_checked=True, **kw)
        else:
            out = charge_replay(*args, **kw)
    if reduce == "stats":
        return reduce_lane_outputs(out, *stats_in)
    return out


@spans.traced("entry")
def _stats_inputs(gid, valid, n_lanes: int, edges: dict, n_groups: int,
                  dev, pinned: bool = False, edges_dev: dict | None = None):
    """``(group_id, valid, edges, n_groups)`` of a stats fold as tensors on
    ``dev`` (all lanes in group 0 and valid by default)."""
    gid = (np.zeros(n_lanes, np.int32) if gid is None
           else np.asarray(gid, np.int32))
    valid = (np.ones(n_lanes, bool) if valid is None
             else np.asarray(valid, bool))
    if edges_dev is None:
        edges_dev = {k: torch.tensor(np.asarray(e, np.float64), device=dev)
                     for k, e in edges.items()}
    return (_tensor(gid, dev, pinned), _tensor(valid, dev, pinned),
            edges_dev, n_groups)


@spans.traced("entry", device_arg="device")
def _run_replay(rows: dict, caps: np.ndarray, rem0: np.ndarray,
                shared_rows, trace_cum: np.ndarray | None = None,
                tail_s: np.ndarray | None = None, policy: str = "fixed",
                theta: float = 0.5, batch_rows: int = 1,
                belief_alpha: float = 0.0,
                charge_cum: np.ndarray | None = None,
                backend: str = "auto", n_rows=None, chunk=None,
                reduce: str = "none",
                group_id: np.ndarray | None = None,
                valid: np.ndarray | None = None,
                edges: dict | None = None, n_groups: int = 1,
                plan_idx: np.ndarray | None = None,
                conf: np.ndarray | None = None, radio=None,
                device="cuda", mesh=None) -> dict | tuple:
    """Replay ``rows`` over every lane and return the per-lane channels as
    numpy arrays, or with ``reduce="stats"`` the ``(psums, pmins, pmaxs)``
    partial folded on the device (numpy).  ``shared_rows=True``: one plan
    broadcast to every lane (fleet sweeps); ``False``: one plan per lane
    (``replay_plans``); ``"plan"``: a ``(P, S, ...)`` pack of candidate
    plans, lane ``l`` replaying ``plan_idx[l]`` (design sweeps).  With a
    ``mesh`` the lanes are split across its shards
    (:func:`_sharded_replay`)."""
    _validate_replay_knobs(policy, batch_rows, belief_alpha, backend,
                           reduce)
    if reduce == "stats" and edges is None:
        raise ValueError("reduce='stats' needs histogram edges")
    dev = resolve_device(device)
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError("backend='cuda' launches the CUDA kernel and "
                         "refuses CPU tensors; use device='cuda'")
    prep = _prepare(rows, caps, rem0, shared_rows, trace_cum, tail_s,
                    policy, batch_rows, charge_cum, n_rows, chunk, conf,
                    radio, plan_idx)
    if mesh is not None:
        return _sharded_replay(prep, mesh, shared_rows, theta, batch_rows,
                               belief_alpha, backend, reduce, group_id,
                               valid, edges, n_groups)
    t = _upload(prep, dev)
    rows_dev = _device_rows(prep.rows, dev, shared_rows, prep.stochastic)
    stats_in = (_stats_inputs(group_id, valid, caps.shape[0], edges,
                              n_groups, dev) if reduce == "stats" else None)
    out = _dispatch(prep, t, rows_dev, shared_rows, theta, batch_rows,
                    belief_alpha, backend, reduce, stats_in)
    if reduce == "stats":
        return parts_numpy(out)
    return {k: v.cpu().numpy() for k, v in out.items()}


#: What a padding lane of a sharded replay holds in each per-lane input:
#: continuous power (cap = rem0 = inf completes every row in one pass), no
#: traces, no real rows (the event stream never walks it), candidate 0.
_PAD_FILLS = dict(caps=np.inf, rem0=np.inf, trace_cum=0.0, tail_s=0.0,
                  charge_cum=0.0, nominal_from=0.0, s_real=0, conf=0.0,
                  plan_idx=0)


def _pad_lanes(prep: _Prepared, pad: int, per_lane_rows: bool) -> _Prepared:
    """``prep`` with ``pad`` inert lanes appended (:data:`_PAD_FILLS`; a
    per-lane row batch gets zero rows)."""
    if not pad:
        return prep
    change = {}
    for k, fill in _PAD_FILLS.items():
        a = getattr(prep, k)
        if a is not None:
            change[k] = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, a.dtype)])
    if per_lane_rows:
        change["rows"] = {k: _pad_axis0(np.asarray(v), pad)
                          for k, v in prep.rows.items()}
    return dataclasses.replace(prep, **change)


def _lane_block(prep: _Prepared, lo: int, hi: int,
                per_lane_rows: bool) -> _Prepared:
    """Lanes ``[lo, hi)`` of ``prep``."""
    change = {k: getattr(prep, k)[lo:hi] for k in _LANE_INPUTS
              if getattr(prep, k) is not None}
    if per_lane_rows:
        change["rows"] = {k: v[lo:hi] for k, v in prep.rows.items()}
    return dataclasses.replace(prep, **change)


def _sharded_replay(prep: _Prepared, mesh, shared_rows, theta: float,
                    batch_rows: int, belief_alpha: float, backend: str,
                    reduce: str, group_id, valid, edges: dict | None,
                    n_groups: int):
    """One replay split across ``mesh``'s shards (the JAX package's
    ``shard_map`` path, driven from this one process): the lane axis is
    padded to a multiple of the shard count with inert lanes
    (:func:`_pad_lanes`, ``valid=False`` in group 0 for the statistics),
    cut into equal contiguous blocks, and each block replayed on its
    shard's device through :func:`_dispatch`, every shard's launches
    issued before any result is read.  ``reduce="none"`` concatenates the
    outputs in lane order without the padding; ``reduce="stats"`` folds
    each shard on its device and all-reduces the partials
    (:func:`~repro_torch.launch.mesh.fleet_all_reduce`)."""
    from ..launch.mesh import fleet_all_reduce

    n = prep.caps.shape[0]
    n_shards = len(mesh.devices)
    pad = (-n) % n_shards
    per = (n + pad) // n_shards
    per_lane_rows = shared_rows is False
    stats = reduce == "stats"
    prep = _pad_lanes(prep, pad, per_lane_rows)
    if stats:
        gid = np.concatenate([
            np.zeros(n, np.int32) if group_id is None
            else np.asarray(group_id, np.int32), np.zeros(pad, np.int32)])
        vld = np.concatenate([np.ones(n, bool) if valid is None
                              else np.asarray(valid, bool),
                              np.zeros(pad, bool)])
    rows_on: dict = {}                  # a shared table, once a device
    outs = []
    for s, dev in enumerate(mesh.devices):
        lo, hi = s * per, (s + 1) * per
        sub = _lane_block(prep, lo, hi, per_lane_rows)
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            t = _upload(sub, dev)
            if per_lane_rows:
                rows_dev = _device_rows(sub.rows, dev, shared_rows,
                                        sub.stochastic)
            else:
                if dev not in rows_on:
                    rows_on[dev] = _device_rows(sub.rows, dev, shared_rows,
                                                sub.stochastic)
                rows_dev = rows_on[dev]
            stats_in = (_stats_inputs(gid[lo:hi], vld[lo:hi], per, edges,
                                      n_groups, dev) if stats else None)
            outs.append(_dispatch(sub, t, rows_dev, shared_rows, theta,
                                  batch_rows, belief_alpha, backend,
                                  reduce, stats_in, host_checked=True))
    if stats:
        return parts_numpy(fleet_all_reduce(outs))
    return {k: np.concatenate([o[k].cpu().numpy() for o in outs])[:n]
            for k in outs[0]}


def _lane_io_bytes(n_lanes: int, *arrays) -> int:
    """Host-visible per-lane buffer bytes of one replay call: the per-lane
    input arrays plus the per-lane output channels (9 f64 scalars --
    including the three uplink channels -- the per-class cycle matrix, and
    the bool ``stuck`` flag).  This is the quantity the memory-flat path
    keeps a function of the chunk size, not the fleet size."""
    return (sum(a.nbytes for a in arrays if a is not None)
            + n_lanes * (8 * (9 + _N_CLASSES) + 1))


@spans.traced("entry", device_arg="device")
def _chunked_replay(plan_rows: dict, n_rows, n_lanes: int,
                    lane_chunk: int, make_inputs, group_id_of,
                    policy: str, theta: float, batch_rows: int,
                    belief_alpha: float, backend: str, reduce: str,
                    edges: dict | None, n_groups: int,
                    event_chunk=None, plan_idx_of=None,
                    prefetch: int = DEFAULT_PREFETCH, shared_rows=None,
                    conf_of=None, radio=None, device="cuda", mesh=None):
    """Drive one replay over the device axis in fixed-size lane chunks:
    per-chunk inputs come from ``make_inputs(lane_lo, m)`` (chunk-invariant
    counter-based samplers, so the chunking never changes a lane's
    inputs), and the last chunk is padded to ``lane_chunk`` with inert
    lanes that ``valid`` masks out of every statistic.  Under
    ``reduce="stats"`` the chunk partials merge associatively into one
    :class:`FleetStats` -- peak lane memory is the chunk, not the fleet;
    under ``reduce="none"`` the chunks' outputs are concatenated
    (bit-identical to the unchunked streamed call).  With ``plan_idx_of``
    the chunks run in plan mode: ``plan_rows`` is the stacked
    ``(P, S, ...)`` batch, ``n_rows`` the per-plan ``(P,)`` row counts and
    ``plan_idx_of(lane_lo, m)`` each chunk's per-lane candidate index.
    ``shared_rows=False`` instead streams a per-lane row batch
    (``replay_plans``): ``plan_rows`` has a leading lane axis, sliced (and
    zero-row padded) chunk by chunk, and ``n_rows`` is per lane.

    ``prefetch >= 1`` overlaps the host with the card
    (:func:`_overlapped_replay`); ``prefetch=0`` is the synchronous loop,
    each chunk's partial brought to the host and merged there.  Both add
    the same partials in the same order, so they give the same bits.
    With a ``mesh`` every chunk is sharded (:func:`_sharded_replay`) in
    the synchronous loop, as the JAX package's mesh path keeps its own
    dispatch."""
    if lane_chunk < 1:
        raise ValueError(f"lane_chunk must be >= 1, got {lane_chunk}")
    if prefetch < 0:
        raise ValueError(f"prefetch must be >= 0, got {prefetch}")
    _validate_replay_knobs(policy, batch_rows, belief_alpha, backend,
                           reduce)
    if reduce == "stats" and edges is None:
        raise ValueError("reduce='stats' needs histogram edges")
    plan_mode = plan_idx_of is not None
    if shared_rows is None:
        shared_rows = "plan" if plan_mode else True
    per_lane_rows = shared_rows is False
    if per_lane_rows:
        n_rows = np.asarray(n_rows, np.int32)
    stats = reduce == "stats"
    starts = list(range(0, n_lanes, lane_chunk))

    def build(lo):
        """One chunk's numpy inputs: sampler draws, grouping, inert-lane
        padding."""
        m = min(lane_chunk, n_lanes - lo)
        pad = lane_chunk - m if n_lanes > lane_chunk else 0
        caps, rem0, tail, cum, ccum = make_inputs(lo, m)
        gid = np.asarray(group_id_of(lo, m), np.int32)
        cnf = (np.asarray(conf_of(lo, m), np.float64)
               if conf_of is not None else None)
        pidx = nr = rows_c = None
        if plan_mode:
            pidx = np.asarray(plan_idx_of(lo, m), np.int32)
            nr = np.asarray(n_rows, np.int32)[pidx]
        elif per_lane_rows:
            rows_c = {k: np.asarray(v)[lo:lo + m]
                      for k, v in plan_rows.items()}
            nr = n_rows[lo:lo + m]
        if pad:
            # inert lanes: continuous power completes every row in one
            # pass; valid=False masks them out of every statistic.
            caps = np.concatenate([caps, np.full(pad, np.inf)])
            rem0 = np.concatenate([rem0, np.full(pad, np.inf)])
            tail = np.concatenate([tail, np.zeros(pad)])
            if cum is not None:
                cum = np.concatenate([cum, np.zeros((pad, cum.shape[1]))])
            if ccum is not None:
                ccum = np.concatenate(
                    [ccum, np.zeros((pad, ccum.shape[1]))])
            gid = np.concatenate([gid, np.zeros(pad, np.int32)])
            if cnf is not None:
                cnf = np.concatenate([cnf, np.zeros(pad)])
            if plan_mode:
                pidx = np.concatenate([pidx, np.zeros(pad, np.int32)])
            if nr is not None:
                nr = np.concatenate([nr, np.zeros(pad, np.int32)])
            if rows_c is not None:
                # zero rows: no-op WORK rows the replay completes for
                # free (and s_real=0 never walks them on the event stream)
                rows_c = {k: _pad_axis0(v, pad) for k, v in rows_c.items()}
        valid = np.arange(m + pad) < m
        return dict(lo=lo, m=m, pad=pad, caps=caps, rem0=rem0, tail=tail,
                    cum=cum, ccum=ccum, gid=gid, pidx=pidx, nr=nr,
                    rows=rows_c, valid=valid, conf=cnf)

    def chunk_bytes(c):
        extra = (tuple(c["rows"].values()) + (c["nr"],)
                 if c["rows"] is not None else ())
        return _lane_io_bytes(c["m"] + c["pad"], c["caps"], c["rem0"],
                              c["tail"], c["cum"], c["ccum"], c["gid"],
                              c["valid"], c["pidx"], c["conf"], *extra)

    if prefetch == 0 or len(starts) == 1 or mesh is not None:
        # the synchronous loop: generate, replay, fold, repeat
        acc_stats = None
        outs: list[dict] = []
        peak = 0
        for lo in starts:
            c = build(lo)
            peak = max(peak, chunk_bytes(c))
            res = _run_replay(
                c["rows"] if per_lane_rows else plan_rows, c["caps"],
                c["rem0"], shared_rows=shared_rows, trace_cum=c["cum"],
                tail_s=c["tail"], policy=policy, theta=theta,
                batch_rows=batch_rows, belief_alpha=belief_alpha,
                charge_cum=c["ccum"], backend=backend,
                n_rows=c["nr"] if (plan_mode or per_lane_rows) else n_rows,
                chunk=event_chunk, reduce=reduce, group_id=c["gid"],
                valid=c["valid"], edges=edges, n_groups=n_groups,
                plan_idx=c["pidx"], conf=c["conf"], radio=radio,
                device=device, mesh=mesh)
            if stats:
                part = FleetStats.from_parts(res, edges)
                acc_stats = part if acc_stats is None \
                    else acc_stats.merge(part)
            else:
                outs.append({k: v[:c["m"]] for k, v in res.items()})
        if stats:
            acc_stats.peak_lane_bytes = peak
            return acc_stats
        return {k: np.concatenate([o[k] for o in outs])
                for k in outs[0]}, peak
    return _overlapped_replay(plan_rows, n_rows, starts, build, chunk_bytes,
                              shared_rows, policy, theta, batch_rows,
                              belief_alpha, backend, reduce, edges,
                              n_groups, event_chunk, prefetch, radio,
                              device)


@spans.traced("entry")
def _overlapped_replay(plan_rows: dict, n_rows, starts: list, build,
                       chunk_bytes, shared_rows, policy: str, theta: float,
                       batch_rows: int, belief_alpha: float, backend: str,
                       reduce: str, edges: dict | None, n_groups: int,
                       event_chunk, prefetch: int, radio, device):
    """The ``prefetch >= 1`` body of :func:`_chunked_replay`.

    A producer thread builds chunk k+1 (sampler draws, padding, the host
    half of the replay call) and, on a card, copies it through pinned
    memory on a side stream, while chunk k runs; it starts at once, so
    chunk 1 is drawn while the caller draws chunk 0 (the host half waits
    for the caller to put the sweep's tables on the device).  The replay
    stream waits on the copy's event, and every uploaded tensor is
    ``record_stream``-ed on it, so the caching allocator cannot hand its
    memory to the next chunk's copy before the replay that reads it has
    run.  At most
    ``prefetch + 1`` chunks are alive: the producer starts chunk j only
    once chunk ``j - prefetch - 1`` has retired, and it waits for that
    itself, on the event the caller records after the chunk's last launch
    (on the CPU, the caller's return from the chunk's replay).  So the
    caller never waits on the card before the end, and a chunk is built
    while the caller still issues the one before it.  Under
    ``reduce="stats"`` each chunk's partial folds into a device-resident
    accumulator through :func:`~repro_torch.core.fleetstats.merge_parts`
    (the lane kernel's wrapper is told the host checked the bounds, so
    its launches never wait either).  The row tables are bucketed and
    uploaded once a sweep (a per-lane row batch, chunk by chunk).  An
    exception in the producer reaches the caller.  Results are bitwise
    those of ``prefetch=0``."""
    import queue as queue_mod
    import threading

    dev = resolve_device(device)
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError("backend='cuda' launches the CUDA kernel and "
                         "refuses CPU tensors; use device='cuda'")
    cuda = dev.type == "cuda"
    plan_mode = shared_rows == "plan"
    per_lane_rows = shared_rows is False
    stats = reduce == "stats"
    depth = prefetch + 1                    # chunks alive at once
    q: queue_mod.Queue = queue_mod.Queue()  # built chunks, in order
    retired: queue_mod.Queue = queue_mod.Queue()  # a chunk's end, in order
    fail = threading.Event()
    done_sentinel = object()

    setup = threading.Event()               # the sweep's tables are up
    adaptive = policy == "adaptive"
    lane_axis = "plan" if plan_mode else not (shared_rows is True)
    stochastic = rows_h = rows_dev = edges_dev = side = main = None

    def prep(c):
        """Stage 1 (producer thread): the host half of the replay call
        and the upload of one built chunk."""
        p = _prepare(c["rows"] if per_lane_rows else rows_h, c["caps"],
                     c["rem0"], shared_rows, c["cum"], c["tail"], policy,
                     batch_rows, c["ccum"],
                     c["nr"] if (plan_mode or per_lane_rows) else n_rows,
                     event_chunk, c["conf"], radio, c["pidx"],
                     bucketed=not per_lane_rows)
        n = c["m"] + c["pad"]
        if side is None:
            return (c, p, _chunk_tensors(p, c, n, dev, False, rows_dev,
                                         per_lane_rows, shared_rows,
                                         stochastic, stats, edges_dev,
                                         n_groups), None)
        with torch.cuda.stream(side):
            t = _chunk_tensors(p, c, n, dev, True, rows_dev, per_lane_rows,
                               shared_rows, stochastic, stats, edges_dev,
                               n_groups)
            ready = torch.cuda.Event()
            ready.record(side)
        return c, p, t, ready

    def producer():
        try:
            for j in range(1, len(starts)):
                if j >= depth:
                    # chunk j takes the slot of chunk j - depth: wait for
                    # that chunk's last launch to end on the card
                    with spans.span("pipeline", "slot_wait"):
                        end = retired.get()
                        if end is not None:
                            end.synchronize()
                if fail.is_set():
                    return
                c = build(starts[j])
                with spans.span("pipeline", "setup_wait"):
                    setup.wait()            # chunk 1 is built beside chunk 0
                if fail.is_set():
                    return
                q.put(prep(c))
            q.put(done_sentinel)
        except BaseException as e:          # relay to the consumer
            q.put(e)

    thread = threading.Thread(target=producer, name="fleetsim-prefetch",
                              daemon=True)
    thread.start()
    acc = None
    outs: list[dict] = []
    peak_chunk = 0
    try:
        first = build(starts[0])
        stochastic = first["ccum"] is not None or \
            (adaptive and batch_rows > 1)
        rows_h = plan_rows
        if stochastic and not per_lane_rows:
            rows_h = _bucket_rows(plan_rows, lane_axis=lane_axis)
        if not per_lane_rows:
            rows_dev = _device_rows(rows_h, dev, shared_rows, stochastic)
        if stats:
            edges_dev = {k: torch.tensor(np.asarray(e, np.float64),
                                         device=dev)
                         for k, e in edges.items()}
        if cuda:
            side = torch.cuda.Stream(dev)
            main = torch.cuda.current_stream(dev)
        setup.set()
        item0 = prep(first)
        for i in range(len(starts)):
            with spans.span("entry", "queue_wait", host_only=True):
                item = item0 if i == 0 else q.get()
            if isinstance(item, BaseException):
                raise item
            c, p, t, ready = item
            if ready is not None:
                main.wait_event(ready)
                for x in t["uploaded"]:
                    x.record_stream(main)
            peak_chunk = max(peak_chunk, chunk_bytes(c))
            res = _dispatch(p, t["inputs"], t["rows"], shared_rows, theta,
                            batch_rows, belief_alpha, backend, reduce,
                            t["stats_in"], host_checked=True)
            del item, t
            end = None
            if stats:
                acc = res if acc is None else merge_parts(acc, res)
                if cuda:
                    end = torch.cuda.Event()
                    end.record(main)
            else:
                outs.append({k: v[:c["m"]].cpu().numpy()
                             for k, v in res.items()})
            retired.put(end)                # the chunk's slot, once it ends
    except BaseException:
        fail.set()
        setup.set()                         # unblock a waiting producer
        for _ in range(depth):
            retired.put(None)
        raise
    finally:
        with spans.span("entry", "thread_join"):
            thread.join()
    peak = (peak_chunk * min(depth, len(starts))
            + (partial_nbytes(edges, n_groups) if stats else 0))
    if stats:
        st = FleetStats.from_parts(parts_numpy(acc), edges)
        st.peak_lane_bytes = peak
        return st
    return {k: np.concatenate([o[k] for o in outs])
            for k in outs[0]}, peak


@spans.traced("entry")
def _chunk_tensors(p: _Prepared, c: dict, n: int, dev, pinned: bool,
                   rows_dev, per_lane_rows: bool, shared_rows,
                   stochastic: bool, stats: bool, edges_dev, n_groups: int
                   ) -> dict:
    """One chunk's tensors on ``dev`` for :func:`_dispatch`: its inputs,
    its row tables (the sweep's, or its own slice of a per-lane batch),
    its stats inputs, and every tensor this upload made (``uploaded``: the
    ones to ``record_stream`` on the replay stream)."""
    inputs = _upload(p, dev, pinned)
    rows = rows_dev
    uploaded = list(inputs.values())
    if per_lane_rows:
        rows = _device_rows(p.rows, dev, shared_rows, stochastic)
        uploaded += ([rows.packed] if stochastic else list(rows.values()))
    stats_in = None
    if stats:
        stats_in = _stats_inputs(c["gid"], c["valid"], n, None, n_groups,
                                 dev, pinned, edges_dev)
        uploaded += list(stats_in[:2])
    return dict(inputs=inputs, rows=rows, stats_in=stats_in,
                uploaded=uploaded)


@dataclass
class ReplayOut:
    """Raw replay state for one (plan, device) lane."""
    live_cycles: float
    reboots: int
    by_class: dict
    completed: bool
    dead_s: float = 0.0
    wasted_cycles: float = 0.0   # committed-work rollback re-execution
    belief_cycles: float = 0.0   # final EWMA believed per-charge budget
    tx_bytes: float = 0.0        # uplink bytes shipped (decision 5)
    msgs_sent: int = 0           # uplink transmissions completed
    msgs_deferred: int = 0       # sends deferred past a closed window

    @property
    def tx_joules(self) -> float:
        """Radio energy: the ``radio`` op class in joules."""
        return self.by_class.get("radio", 0.0) * JOULES_PER_CYCLE


def replay_plans(plans: list[FleetPlan],
                 init_frac: np.ndarray | None = None,
                 policy: str = "fixed", theta: float = 0.5,
                 batch_rows: int = 1, belief_alpha: float = 0.0,
                 recharge_traces: np.ndarray | None = None,
                 charge_traces: np.ndarray | None = None,
                 backend: str = "auto", reduce: str = "none",
                 stats_bins: int = 64,
                 stats_edges: dict | None = None, seed: int | None = None,
                 recharge_cv: float = 0.25, trace_reboots: int = 0,
                 charge_cv: float = 0.0, charge_bias_cv: float = 0.0,
                 charge_reboots: int = 0, lane_lo: int = 0,
                 event_chunk=None, lane_chunk: int | None = None,
                 prefetch: int = DEFAULT_PREFETCH,
                 radio=None, conf: np.ndarray | None = None,
                 device="cuda") -> list[ReplayOut] | FleetStats:
    """Replay many plans at once, one lane per plan (the JAX package's
    ``replay_plans``).

    ``init_frac`` scales each lane's initial charge (default: full).
    ``recharge_traces`` / ``charge_traces`` are ``(len(plans), R)``
    per-reboot recharge times and per-charge capacities; a charge trace
    switches the replay to the stochastic charge-by-charge path.
    ``policy``/``theta``/``batch_rows``/``belief_alpha`` select the commit
    policy, its cross-charge window and the EWMA belief rate.  ``seed=``
    draws the missing per-lane inputs from the Philox ``*_stream``
    samplers for lanes ``lane_lo + i``.  ``radio=`` turns on the uplink
    decision (every plan gets a SEND row; ``conf`` is each lane's
    classifier confidence).  ``event_chunk`` is the plain version's
    completion-check period (``"auto"`` or ``None``: the plan-shape
    default); it never changes results.

    ``reduce="stats"`` folds the lanes into one :class:`FleetStats` on
    the device instead of returning :class:`ReplayOut` rows;
    ``stats_bins``/``stats_edges`` size its fixed histogram bins (defaults
    from the plans' nominal bounds).  ``lane_chunk=`` streams the
    plan-lane axis through that many lanes at a time, every per-lane input
    sliced chunk by chunk, so the chunked replay is bitwise equal to the
    unchunked one on the same inputs; ``prefetch`` is the overlapped
    pipeline's depth (``prefetch=0``: the synchronous loop).  ``device``
    defaults to ``"cuda"``."""
    from ..runtime.failures import (charge_capacity_jitter_stream,
                                    charge_trace_cumulative,
                                    harvest_jitter_stream,
                                    inference_confidence_stream,
                                    initial_charge_fraction_stream,
                                    reboot_recharge_times_stream,
                                    recharge_trace_cumulative)
    resolve_device(device)
    if radio is not None:
        plans = [with_uplink(p) for p in plans]
        if conf is None and seed is not None:
            conf = inference_confidence_stream(len(plans), seed=seed,
                                               lane_lo=lane_lo)
    if reduce not in REPLAY_REDUCES:
        raise ValueError(f"unknown reduce mode {reduce!r}; "
                         f"expected one of {REPLAY_REDUCES}")
    caps = np.asarray([p.capacity for p in plans], np.float64)
    tail = np.asarray([p.recharge_s for p in plans], np.float64)
    if seed is not None:
        n = len(plans)
        if init_frac is None:
            init_frac = initial_charge_fraction_stream(n, seed=seed,
                                                       lane_lo=lane_lo)
        jm = harvest_jitter_stream(n, seed=seed, cv=recharge_cv,
                                   lane_lo=lane_lo)
        if trace_reboots > 0 and recharge_traces is None:
            recharge_traces = reboot_recharge_times_stream(
                n, trace_reboots, tail, seed=seed,
                lane_lo=lane_lo) * jm[:, None]
        if (charge_cv > 0 or charge_bias_cv > 0 or charge_reboots > 0) \
                and charge_traces is None:
            charge_traces = charge_capacity_jitter_stream(
                n, charge_reboots or 256, caps, seed=seed, cv=charge_cv,
                bias_cv=charge_bias_cv, lane_lo=lane_lo)
        tail = tail * jm
    rem0 = caps if init_frac is None else \
        np.where(np.isinf(caps), np.inf, caps * np.asarray(init_frac))
    cum = ccum = None
    if recharge_traces is not None:
        recharge_traces = np.asarray(recharge_traces)
        if recharge_traces.ndim != 2 or \
                recharge_traces.shape[0] != len(plans):
            raise ValueError(
                f"recharge_traces must be (len(plans), R) = "
                f"({len(plans)}, R), got {recharge_traces.shape}")
        cum = recharge_trace_cumulative(recharge_traces)
    if charge_traces is not None:
        charge_traces = np.asarray(charge_traces)
        if charge_traces.ndim != 2 or \
                charge_traces.shape[0] != len(plans):
            raise ValueError(
                f"charge_traces must be (len(plans), R) = "
                f"({len(plans)}, R), got {charge_traces.shape}")
        ccum = charge_trace_cumulative(charge_traces)
    n_rows_arr = np.asarray([len(p) for p in plans], np.int32)
    t0 = time.perf_counter()
    edges = None
    if reduce == "stats":
        edges = stats_edges if stats_edges is not None else \
            default_stat_edges(
                max(p.total_cycles for p in plans),
                np.asarray([p.capacity for p in plans]),
                np.asarray([p.recharge_s for p in plans]), stats_bins)
    common = dict(policy=policy, theta=theta, batch_rows=batch_rows,
                  belief_alpha=belief_alpha, backend=backend,
                  device=device)
    if lane_chunk is not None:
        # every per-lane input is built once for the whole batch above and
        # sliced per chunk, so the chunks replay the unchunked inputs
        tail_f = np.broadcast_to(np.asarray(tail, np.float64),
                                 (len(plans),))

        def make_inputs(lo, m):
            return (caps[lo:lo + m], rem0[lo:lo + m], tail_f[lo:lo + m],
                    None if cum is None else cum[lo:lo + m],
                    None if ccum is None else ccum[lo:lo + m])

        conf_f = (None if conf is None
                  else np.broadcast_to(np.asarray(conf, np.float64),
                                       (len(plans),)))
        res = _chunked_replay(
            _pad_stack(plans), n_rows_arr, len(plans), lane_chunk,
            make_inputs, lambda lo, m: np.zeros(m, np.int32),
            reduce=reduce, edges=edges, n_groups=1,
            event_chunk=event_chunk, shared_rows=False, prefetch=prefetch,
            radio=radio,
            conf_of=(None if conf_f is None
                     else (lambda lo, m: conf_f[lo:lo + m])), **common)
        if reduce == "stats":
            res.wall_s = time.perf_counter() - t0
            return res
        out, _peak = res
    else:
        res = _run_replay(_pad_stack(plans), caps, rem0, shared_rows=False,
                          trace_cum=cum, tail_s=tail, charge_cum=ccum,
                          n_rows=n_rows_arr, chunk=event_chunk,
                          reduce=reduce, edges=edges, conf=conf,
                          radio=radio, **common)
        if reduce == "stats":
            stats = FleetStats.from_parts(res, edges)
            stats.wall_s = time.perf_counter() - t0
            stats.peak_lane_bytes = _lane_io_bytes(len(plans), caps, rem0,
                                                   tail, cum, ccum)
            return stats
        out = res
    results = []
    for i in range(len(plans)):
        by_class = {op: float(v) for op, v in
                    zip(OP_CLASSES, out["classes"][i]) if v > 0.0}
        results.append(ReplayOut(
            float(out["live"][i]),
            int(round(float(out["reboots"][i]))),
            by_class, bool(~out["stuck"][i]),
            dead_s=float(out["dead"][i]),
            wasted_cycles=float(out["wasted"][i]),
            belief_cycles=float(out["belief"][i]),
            tx_bytes=float(out["tx_bytes"][i]),
            msgs_sent=int(round(float(out["msgs_sent"][i]))),
            msgs_deferred=int(round(float(out["msgs_deferred"][i])))))
    return results


def fleet_evaluate(net: SimNet, x: np.ndarray,
                   strategies=STRATEGIES,
                   powers=POWER_SYSTEMS,
                   policy: str = "fixed", theta: float = 0.5,
                   batch_rows: int = 1, belief_alpha: float = 0.0,
                   recharge_traces: np.ndarray | None = None,
                   charge_traces: np.ndarray | None = None,
                   backend: str = "auto", device="cuda") -> list[RunResult]:
    """The full strategy x power matrix as one replay, returning
    :class:`RunResult` rows interchangeable with the scalar ``evaluate``
    (traces, when given, hold one row per cell in strategy-major order)."""
    resolve_device(device)
    plans = []
    for strat in strategies:
        ref = _reference_run(net, x, strat)
        # Only TAILS plans depend on the power system (tile calibration);
        # the other strategies' rows are built once and restamped.
        base = None
        for power in powers:
            if strat == "tails" or base is None:
                base = build_plan(net, x, strat, power, ref=ref)
                plans.append(base)
            else:
                ps = make_power_system(power)
                plans.append(dataclasses.replace(
                    base, power=ps.name, recharge_s=ps.recharge_s,
                    capacity=math.inf if ps.continuous
                    else ps.cycles_per_charge))
    outs = replay_plans(plans, policy=policy, theta=theta,
                        batch_rows=batch_rows, belief_alpha=belief_alpha,
                        recharge_traces=recharge_traces,
                        charge_traces=charge_traces, backend=backend,
                        device=device)
    results = []
    for p, o in zip(plans, outs):
        if not o.completed:
            results.append(RunResult(
                p.network, p.strategy, p.power, False, None, 0.0, 0.0,
                float("inf"), float("inf"), 0, p.max_atomic,
                dnf_reason=f"atomic region of {p.max_atomic:.0f} cycles "
                           f"exceeds the {p.capacity:.0f}-cycle buffer"))
            continue
        live_s = o.live_cycles / CLOCK_HZ
        results.append(RunResult(
            p.network, p.strategy, p.power, True, p.ref_output, live_s,
            o.dead_s, live_s + o.dead_s, o.live_cycles * JOULES_PER_CYCLE,
            o.reboots, p.max_atomic, by_class=o.by_class))
    return results


@dataclass
class FleetSweepResult:
    """Per-device outcomes of one plan replayed across a fleet."""
    strategy: str
    power: str
    n_devices: int
    completed: np.ndarray        # (D,) bool
    live_s: np.ndarray           # (D,)
    dead_s: np.ndarray           # (D,)
    reboots: np.ndarray          # (D,)
    energy_j: np.ndarray         # (D,)
    wall_s: float                # build + replay wall-clock
    wasted_cycles: np.ndarray | None = None   # (D,) rollback re-execution
    belief_cycles: np.ndarray | None = None   # (D,) final EWMA budget
    policy: str = "fixed"        # commit policy the sweep ran under
    theta: float = 0.5
    batch_rows: int = 1
    belief_alpha: float = 0.0
    tx_bytes: np.ndarray | None = None       # (D,) uplink bytes shipped
    msgs_sent: np.ndarray | None = None      # (D,)
    msgs_deferred: np.ndarray | None = None  # (D,) closed-window defers
    tx_joules: np.ndarray | None = None      # (D,) radio energy burned
    classes: np.ndarray | None = None        # (D, C) cycles per op class

    @property
    def total_s(self) -> np.ndarray:
        return self.live_s + self.dead_s

    def summary(self) -> dict:
        done = self.completed
        out = {
            "devices": self.n_devices,
            "policy": self.policy,
            "completed": int(done.sum()),
            "mean_total_s": float(self.total_s[done].mean()) if done.any()
            else float("inf"),
            "p95_total_s": float(np.percentile(self.total_s[done], 95))
            if done.any() else float("inf"),
            "mean_reboots": float(self.reboots[done].mean()) if done.any()
            else 0.0,
            "mean_wasted_cycles":
                float(self.wasted_cycles[done].mean())
                if self.wasted_cycles is not None and done.any() else 0.0,
            "mean_belief_cycles":
                float(self.belief_cycles[done].mean())
                if self.belief_cycles is not None and done.any() else 0.0,
            "wall_s": round(self.wall_s, 3),
        }
        if self.tx_bytes is not None:
            out["uplink"] = {
                "tx_bytes": float(self.tx_bytes.sum()),
                "msgs_sent": int(round(float(self.msgs_sent.sum()))),
                "msgs_deferred":
                    int(round(float(self.msgs_deferred.sum()))),
                "tx_joules": float(self.tx_joules.sum())
                if self.tx_joules is not None else 0.0,
            }
        return out


@dataclass
class DesignSweepResult:
    """Per-candidate, per-device outcomes of one PlanSet design sweep."""
    labels: tuple
    strategies: tuple
    capacities: np.ndarray       # (P,) cycles per full charge
    n_devices: int               # devices per candidate plan
    completed: np.ndarray        # (P, D) bool
    live_s: np.ndarray           # (P, D)
    dead_s: np.ndarray           # (P, D)
    reboots: np.ndarray          # (P, D)
    energy_j: np.ndarray         # (P, D)
    wasted_cycles: np.ndarray    # (P, D)
    belief_cycles: np.ndarray    # (P, D)
    wall_s: float
    replay_config: tuple = ()    # (shared_rows, ...) of the one launch
    policy: str = "fixed"
    tx_bytes: np.ndarray | None = None       # (P, D) uplink bytes shipped
    msgs_sent: np.ndarray | None = None      # (P, D)
    msgs_deferred: np.ndarray | None = None  # (P, D) closed-window defers

    @property
    def total_s(self) -> np.ndarray:
        return self.live_s + self.dead_s

    @property
    def completion_rate(self) -> np.ndarray:
        return self.completed.mean(axis=1)

    def summary(self) -> list[dict]:
        """One dict per candidate: completion, mean energy over completed
        lanes, p95 wall-clock latency -- the per-plan numbers GENESIS's
        frontier selection consumes."""
        rows = []
        for p, label in enumerate(self.labels):
            done = self.completed[p]
            rows.append({
                "label": label,
                "strategy": self.strategies[p],
                "capacity": float(self.capacities[p]),
                "completion": float(done.mean()),
                "mean_energy_j": float(self.energy_j[p][done].mean())
                if done.any() else float("inf"),
                "p95_total_s": float(np.percentile(self.total_s[p][done],
                                                   95))
                if done.any() else float("inf"),
                "mean_reboots": float(self.reboots[p][done].mean())
                if done.any() else 0.0,
            })
        return rows


def _design_result(ps: PlanSet, n_devices: int, out: dict, t0: float,
                   policy: str) -> DesignSweepResult:
    shape = (len(ps), n_devices)
    return DesignSweepResult(
        labels=ps.labels, strategies=ps.strategies,
        capacities=ps.capacity, n_devices=n_devices,
        completed=(~out["stuck"]).reshape(shape),
        live_s=(out["live"] / CLOCK_HZ).reshape(shape),
        dead_s=out["dead"].reshape(shape),
        reboots=out["reboots"].reshape(shape),
        energy_j=(out["live"] * JOULES_PER_CYCLE).reshape(shape),
        wasted_cycles=out["wasted"].reshape(shape),
        belief_cycles=out["belief"].reshape(shape),
        wall_s=time.perf_counter() - t0,
        replay_config=("plan",), policy=policy,
        tx_bytes=out["tx_bytes"].reshape(shape),
        msgs_sent=out["msgs_sent"].reshape(shape),
        msgs_deferred=out["msgs_deferred"].reshape(shape))


@spans.traced("entry")
def _design_sweep(ps: PlanSet, n_devices: int, seed: int,
                  recharge_cv: float, policy: str, theta: float,
                  batch_rows: int, belief_alpha: float,
                  trace_reboots: int, charge_cv: float,
                  charge_bias_cv: float, charge_reboots: int,
                  backend: str, reduce: str, lane_chunk: int | None,
                  stats_bins: int, stats_edges: dict | None,
                  event_chunk, t0: float,
                  prefetch: int = DEFAULT_PREFETCH, radio=None,
                  conf=None, device="cuda", mesh=None):
    """One replay over a whole :class:`PlanSet` design space.

    Lanes are plan-major (``lane = p * n_devices + d``).  Unchunked, each
    plan's ``n_devices`` lanes draw with the same legacy samplers and
    seeds an individual ``fleet_sweep(plan=plans[p])`` call uses, so
    per-plan outputs are bitwise equal to replaying each candidate
    separately.  With ``lane_chunk`` the flat lane axis streams through
    the chunk-invariant ``*_stream`` samplers instead (independent of the
    chunking, but a different draw stream).  Design sweeps always replay
    charge-wise -- an all-nominal capacity trace when the jitter knobs are
    off -- because the event stream is the path that indexes the packed
    ``(P, S, F)`` candidate table in place (on the card, the lane kernel in
    ``"plan"`` mode) instead of copying a table per lane."""
    from ..runtime.failures import (charge_capacity_jitter,
                                    charge_capacity_jitter_stream,
                                    charge_trace_cumulative,
                                    harvest_jitter,
                                    harvest_jitter_stream,
                                    inference_confidence,
                                    inference_confidence_stream,
                                    initial_charge_fraction,
                                    initial_charge_fraction_stream,
                                    reboot_recharge_times,
                                    reboot_recharge_times_stream,
                                    recharge_trace_cumulative)
    n_plans, dev = len(ps), n_devices
    lanes = n_plans * dev
    use_charge = charge_cv > 0 or charge_bias_cv > 0 or charge_reboots > 0
    n_charges = charge_reboots or (256 if use_charge else 8)
    edges = None
    if reduce == "stats":
        edges = stats_edges if stats_edges is not None else \
            default_stat_edges(float(ps.total_cycles.max()), ps.capacity,
                               ps.recharge_s, stats_bins)
    common = dict(policy=policy, theta=theta, batch_rows=batch_rows,
                  belief_alpha=belief_alpha, backend=backend,
                  device=device, mesh=mesh)
    if lane_chunk is not None:
        def plan_of(lo, m):
            return (lo + np.arange(m)) // dev

        def make_inputs(lo, m):
            p = plan_of(lo, m)
            caps_c = ps.capacity[p]
            frac = initial_charge_fraction_stream(m, seed=seed,
                                                  lane_lo=lo)
            jm = harvest_jitter_stream(m, seed=seed, cv=recharge_cv,
                                       lane_lo=lo)
            rem0_c = np.where(np.isinf(caps_c), np.inf, caps_c * frac)
            tail_c = ps.recharge_s[p] * jm
            cum_c = None
            if trace_reboots > 0:
                tr = reboot_recharge_times_stream(
                    m, trace_reboots, ps.recharge_s[p], seed=seed,
                    lane_lo=lo)
                cum_c = recharge_trace_cumulative(tr * jm[:, None])
            ctr = charge_capacity_jitter_stream(
                m, n_charges, caps_c, seed=seed, cv=charge_cv,
                bias_cv=charge_bias_cv, lane_lo=lo)
            return caps_c, rem0_c, tail_c, cum_c, \
                charge_trace_cumulative(ctr)

        conf_of = None
        if conf is not None:
            conf_full = np.asarray(conf, np.float64)

            def conf_of(lo, m):
                return conf_full[lo:lo + m]
        elif radio is not None:
            def conf_of(lo, m):
                return inference_confidence_stream(m, seed=seed,
                                                   lane_lo=lo)

        res = _chunked_replay(
            ps.rows, ps.n_rows, lanes, lane_chunk, make_inputs, plan_of,
            reduce=reduce, edges=edges, n_groups=n_plans,
            event_chunk=event_chunk, plan_idx_of=plan_of,
            prefetch=prefetch, conf_of=conf_of, radio=radio, **common)
        if reduce == "stats":
            res.group_labels = np.asarray(ps.labels)
            res.wall_s = time.perf_counter() - t0
            return res
        out, _peak = res
        return _design_result(ps, dev, out, t0, policy)
    with spans.span("entry", "legacy_draws", host_only=True):
        pidx = np.repeat(np.arange(n_plans, dtype=np.int32), dev)
        caps = ps.capacity[pidx]
        # per-plan legacy draws with per-plan seeds: the bitwise pin
        # against each candidate's own fleet_sweep
        frac = np.tile(initial_charge_fraction(dev, seed=seed), n_plans)
        jm = np.tile(harvest_jitter(dev, seed=seed + 1, cv=recharge_cv),
                     n_plans)
        rem0 = np.where(np.isinf(caps), np.inf, caps * frac)
        tail = ps.recharge_s[pidx] * jm
        cum = None
        if trace_reboots > 0:
            jm_d = jm[:dev]
            cum = recharge_trace_cumulative(np.concatenate(
                [reboot_recharge_times(dev, trace_reboots,
                                       float(ps.recharge_s[p]),
                                       seed=seed + 2) * jm_d[:, None]
                 for p in range(n_plans)]))
        ccum = charge_trace_cumulative(np.concatenate(
            [charge_capacity_jitter(dev, n_charges, float(ps.capacity[p]),
                                    seed=seed + 3, cv=charge_cv,
                                    bias_cv=charge_bias_cv)
             for p in range(n_plans)]))
        if radio is not None and conf is None:
            conf = np.tile(inference_confidence(dev, seed=seed + 4),
                           n_plans)
    common.update(trace_cum=cum, tail_s=tail, charge_cum=ccum,
                  n_rows=ps.n_rows[pidx], chunk=event_chunk,
                  plan_idx=pidx, conf=conf, radio=radio)
    if reduce == "stats":
        parts = _run_replay(ps.rows, caps, rem0, "plan", reduce="stats",
                            group_id=pidx, edges=edges, n_groups=n_plans,
                            **common)
        stats = FleetStats.from_parts(parts, edges,
                                      group_labels=np.asarray(ps.labels))
        stats.wall_s = time.perf_counter() - t0
        stats.peak_lane_bytes = _lane_io_bytes(lanes, caps, rem0, tail,
                                               cum, ccum, pidx)
        return stats
    out = _run_replay(ps.rows, caps, rem0, "plan", **common)
    return _design_result(ps, dev, out, t0, policy)


@spans.traced("entry", device_arg="device")
def fleet_sweep(net: SimNet | None = None, x: np.ndarray | None = None,
                strategy: str | None = None, power=None,
                n_devices: int = 1000, seed: int = 0,
                recharge_cv: float = 0.25,
                plan: "FleetPlan | PlanSet | None" = None,
                policy: str = "fixed", theta: float = 0.5,
                batch_rows: int = 1, belief_alpha: float = 0.0,
                trace_reboots: int = 0, charge_cv: float = 0.0,
                charge_bias_cv: float = 0.0,
                charge_reboots: int = 0, mesh=None,
                backend: str = "auto", reduce: str = "none",
                lane_chunk: int | None = None, stats_bins: int = 64,
                stats_edges: dict | None = None,
                event_chunk=None, prefetch: int = DEFAULT_PREFETCH,
                radio=None, conf=None, device="cuda"
                ) -> "FleetSweepResult | DesignSweepResult | FleetStats":
    """Replay one (strategy, power) plan across ``n_devices`` simulated
    devices with per-device harvest jitter (the JAX package's
    ``fleet_sweep``).

    Each device wakes at a random buffer level and recharges at its own
    rate; ``trace_reboots > 0`` draws per-reboot recharge times,
    ``charge_cv``/``charge_bias_cv``/``charge_reboots`` a per-charge
    capacity trace (the stochastic path).  The inputs are the JAX
    package's legacy draws at the same seeds (fraction ``seed``, harvest
    ``seed + 1``, recharge ``seed + 2``, capacity ``seed + 3``, confidence
    ``seed + 4``), so the two packages replay identical fleets.  The plan
    is shared by every lane.

    ``reduce="stats"`` returns one fixed-size :class:`FleetStats` folded
    on the device instead of the per-lane arrays, and ``lane_chunk=``
    streams the device axis through that many lanes at a time from the
    chunk-invariant ``*_stream`` samplers (results do not depend on the
    chunking, but differ bitwise from the unchunked draw stream), with
    peak device-axis memory a function of ``lane_chunk`` alone
    (``FleetStats.peak_lane_bytes``); ``prefetch`` is the depth of the
    overlapped pipeline (0: the synchronous loop).  ``stats_bins``/
    ``stats_edges`` size the fixed histogram bins.

    ``plan=`` also takes a :class:`PlanSet`: the whole candidate batch
    replays with ``n_devices`` lanes a candidate in one launch, returning
    a :class:`DesignSweepResult` or, with ``reduce="stats"``, a
    :class:`FleetStats` with one group per candidate.  ``mesh=`` (a
    :class:`~repro_torch.launch.mesh.FleetMesh` from ``make_fleet_mesh``)
    splits the lanes across its shards; the results are those of the
    unmeshed call, the statistics' f64 sums added shard by shard.
    ``device`` defaults to ``"cuda"``."""
    from ..runtime.failures import (charge_capacity_jitter,
                                    charge_capacity_jitter_stream,
                                    charge_trace_cumulative,
                                    harvest_jitter, harvest_jitter_stream,
                                    inference_confidence,
                                    inference_confidence_stream,
                                    initial_charge_fraction,
                                    initial_charge_fraction_stream,
                                    reboot_recharge_times,
                                    reboot_recharge_times_stream,
                                    recharge_trace_cumulative)
    resolve_device(device)
    _check_mesh(mesh, device)
    if reduce not in REPLAY_REDUCES:
        raise ValueError(f"unknown reduce mode {reduce!r}; "
                         f"expected one of {REPLAY_REDUCES}")
    t0 = time.perf_counter()
    if isinstance(plan, PlanSet):
        return _design_sweep(plan, n_devices, seed, recharge_cv, policy,
                             theta, batch_rows, belief_alpha,
                             trace_reboots, charge_cv, charge_bias_cv,
                             charge_reboots, backend, reduce, lane_chunk,
                             stats_bins, stats_edges, event_chunk, t0,
                             prefetch, radio=radio, conf=conf,
                             device=device, mesh=mesh)
    if plan is None:
        if net is None or x is None or strategy is None or power is None:
            raise ValueError("fleet_sweep needs (net, x, strategy, power) "
                             "to build a plan, or an explicit plan= "
                             "FleetPlan / PlanSet")
        plan = build_plan(net, x, strategy, power)
    if radio is not None:
        plan = with_uplink(plan)
    if strategy is None:
        strategy = plan.strategy
    if power is None:
        power = plan.power
    use_charge = charge_cv > 0 or charge_bias_cv > 0 or charge_reboots > 0
    edges = None
    if reduce == "stats":
        edges = stats_edges if stats_edges is not None else \
            default_stat_edges(plan.total_cycles, plan.capacity,
                               plan.recharge_s, stats_bins)
    common = dict(policy=policy, theta=theta, batch_rows=batch_rows,
                  belief_alpha=belief_alpha, backend=backend,
                  device=device, mesh=mesh)
    if lane_chunk is not None:
        def make_inputs(lo, m):
            frac = initial_charge_fraction_stream(m, seed=seed,
                                                  lane_lo=lo)
            jm = harvest_jitter_stream(m, seed=seed, cv=recharge_cv,
                                       lane_lo=lo)
            caps_c = np.full(m, plan.capacity, np.float64)
            rem0_c = np.where(np.isinf(caps_c), np.inf, caps_c * frac)
            tail_c = plan.recharge_s * jm
            cum_c = ccum_c = None
            if trace_reboots > 0:
                tr = reboot_recharge_times_stream(
                    m, trace_reboots, plan.recharge_s, seed=seed,
                    lane_lo=lo)
                cum_c = recharge_trace_cumulative(tr * jm[:, None])
            if use_charge:
                ctr = charge_capacity_jitter_stream(
                    m, charge_reboots or 256, plan.capacity, seed=seed,
                    cv=charge_cv, bias_cv=charge_bias_cv, lane_lo=lo)
                ccum_c = charge_trace_cumulative(ctr)
            return caps_c, rem0_c, tail_c, cum_c, ccum_c

        conf_of = None
        if conf is not None:
            conf_full = np.asarray(conf, np.float64)

            def conf_of(lo, m):
                return conf_full[lo:lo + m]
        elif radio is not None:
            def conf_of(lo, m):
                return inference_confidence_stream(m, seed=seed,
                                                   lane_lo=lo)

        res = _chunked_replay(
            _plan_rows(plan), len(plan), n_devices, lane_chunk,
            make_inputs, lambda lo, m: np.zeros(m, np.int32),
            reduce=reduce, edges=edges, n_groups=1,
            event_chunk=event_chunk, prefetch=prefetch, conf_of=conf_of,
            radio=radio, **common)
        if reduce == "stats":
            res.wall_s = time.perf_counter() - t0
            return res
        out, _peak = res
        return _sweep_result(out, strategy, power, n_devices, t0, policy,
                             theta, batch_rows, belief_alpha)
    frac = initial_charge_fraction(n_devices, seed=seed)
    jit_mult = harvest_jitter(n_devices, seed=seed + 1, cv=recharge_cv)
    caps = np.full(n_devices, plan.capacity, np.float64)
    rem0 = np.where(np.isinf(caps), np.inf, caps * frac)
    tail = plan.recharge_s * jit_mult
    cum = ccum = None
    if trace_reboots > 0:
        traces = reboot_recharge_times(n_devices, trace_reboots,
                                       plan.recharge_s, seed=seed + 2)
        cum = recharge_trace_cumulative(traces * jit_mult[:, None])
    if use_charge:
        ctr = charge_capacity_jitter(n_devices, charge_reboots or 256,
                                     plan.capacity, seed=seed + 3,
                                     cv=charge_cv, bias_cv=charge_bias_cv)
        ccum = charge_trace_cumulative(ctr)
    if radio is not None and conf is None:
        conf = inference_confidence(n_devices, seed=seed + 4)
    res = _run_replay(_plan_rows(plan), caps, rem0, shared_rows=True,
                      trace_cum=cum, tail_s=tail, charge_cum=ccum,
                      n_rows=len(plan), chunk=event_chunk, reduce=reduce,
                      edges=edges, conf=conf, radio=radio, **common)
    if reduce == "stats":
        # unchunked stats draw the legacy inputs of reduce="none", so they
        # compare bitwise with statistics of the materialized outputs
        stats = FleetStats.from_parts(res, edges)
        stats.wall_s = time.perf_counter() - t0
        stats.peak_lane_bytes = _lane_io_bytes(n_devices, caps, rem0,
                                               tail, cum, ccum)
        return stats
    return _sweep_result(res, strategy, power, n_devices, t0, policy,
                         theta, batch_rows, belief_alpha)


def _sweep_result(out: dict, strategy, power, n_devices: int, t0: float,
                  policy: str, theta: float, batch_rows: int,
                  belief_alpha: float) -> FleetSweepResult:
    return FleetSweepResult(
        strategy, power, n_devices,
        completed=~out["stuck"],
        live_s=out["live"] / CLOCK_HZ,
        dead_s=out["dead"],
        reboots=out["reboots"],
        energy_j=out["live"] * JOULES_PER_CYCLE,
        wall_s=time.perf_counter() - t0,
        wasted_cycles=out["wasted"],
        belief_cycles=out["belief"],
        policy=policy, theta=theta, batch_rows=batch_rows,
        belief_alpha=belief_alpha,
        tx_bytes=out["tx_bytes"],
        msgs_sent=out["msgs_sent"],
        msgs_deferred=out["msgs_deferred"],
        tx_joules=out["classes"][..., _RADIO_IDX] * JOULES_PER_CYCLE,
        classes=out["classes"])


@dataclass
class CapacitorSweepResult:
    """One parameterized plan replayed over a (capacitors x devices) grid."""
    strategy: str
    capacities: np.ndarray       # (P,) cycles per charge
    n_devices: int               # devices per capacitor
    completed: np.ndarray        # (P, D) bool
    live_s: np.ndarray           # (P, D)
    dead_s: np.ndarray           # (P, D)
    reboots: np.ndarray          # (P, D)
    energy_j: np.ndarray         # (P, D)
    wall_s: float
    wasted_cycles: np.ndarray | None = None   # (P, D)
    belief_cycles: np.ndarray | None = None   # (P, D) final EWMA budget
    policy: str = "fixed"
    theta: float = 0.5
    batch_rows: int = 1
    belief_alpha: float = 0.0

    @property
    def total_s(self) -> np.ndarray:
        return self.live_s + self.dead_s


def capacitor_sweep(net: SimNet, x: np.ndarray,
                    capacities, n_devices: int = 64, seed: int = 0,
                    recharge_cv: float = 0.25, strategy: str = "tails",
                    plan: FleetPlan | None = None, policy: str = "fixed",
                    theta: float = 0.5, batch_rows: int = 1,
                    belief_alpha: float = 0.0, charge_cv: float = 0.0,
                    charge_bias_cv: float = 0.0, charge_reboots: int = 0,
                    mesh=None, backend: str = "auto",
                    reduce: str = "none", lane_chunk: int | None = None,
                    stats_bins: int = 64, stats_edges: dict | None = None,
                    event_chunk=None,
                    prefetch: int = DEFAULT_PREFETCH, device="cuda"
                    ) -> CapacitorSweepResult | FleetStats:
    """Sweep (capacitor size x device) in one replay of one parameterized
    plan -- no per-capacitor re-extraction (the JAX package's
    ``capacitor_sweep``).

    ``capacities`` are buffer sizes in cycles per charge; each gets
    ``n_devices`` jittered lanes (capacitor-major).  TAILS tile
    calibration happens inside the replay per lane, so every capacitor
    picks its own tile (and pays its own discovery burns) from the shared
    plan; completion is the replay's per-lane ``stuck`` flag.
    ``charge_cv``/``charge_reboots`` switch on stochastic per-charge
    capacities around each lane's own nominal budget (on the card, the
    lane kernel).  ``reduce="stats"`` folds the grid into one
    :class:`FleetStats` with one group per capacitor (``group_labels``
    holds the capacities), and ``lane_chunk=``/``prefetch`` stream the
    lane axis as in :func:`fleet_sweep`, and ``mesh=`` shards it as
    there.  ``device`` defaults to ``"cuda"``."""
    from ..runtime.failures import (charge_capacity_jitter,
                                    charge_capacity_jitter_stream,
                                    charge_trace_cumulative,
                                    harvest_jitter, harvest_jitter_stream,
                                    initial_charge_fraction,
                                    initial_charge_fraction_stream)
    resolve_device(device)
    _check_mesh(mesh, device)
    if reduce not in REPLAY_REDUCES:
        raise ValueError(f"unknown reduce mode {reduce!r}; "
                         f"expected one of {REPLAY_REDUCES}")
    t0 = time.perf_counter()
    if plan is None:
        plan = build_plan(net, x, strategy, "1mF", parametric=True)
    if not plan.parametric:
        raise ValueError("capacitor_sweep needs a parametric plan "
                         "(build_plan(..., parametric=True))")
    capacities = np.asarray(capacities, np.float64)
    n_caps = capacities.shape[0]
    lanes = n_caps * n_devices
    use_charge = charge_cv > 0 or charge_bias_cv > 0 or charge_reboots > 0
    edges = None
    if reduce == "stats":
        fin = capacities[np.isfinite(capacities)]
        rec = rf_recharge_seconds(fin) if fin.size else np.zeros(1)
        edges = stats_edges if stats_edges is not None else \
            default_stat_edges(plan.total_cycles, capacities, rec,
                               stats_bins)
    common = dict(policy=policy, theta=theta, batch_rows=batch_rows,
                  belief_alpha=belief_alpha, backend=backend,
                  device=device, mesh=mesh)
    shape = (n_caps, n_devices)
    if lane_chunk is not None:
        def make_inputs(lo, m):
            caps_c = capacities[(lo + np.arange(m)) // n_devices]
            frac = initial_charge_fraction_stream(m, seed=seed,
                                                  lane_lo=lo)
            jm = harvest_jitter_stream(m, seed=seed, cv=recharge_cv,
                                       lane_lo=lo)
            rem0_c = np.where(np.isinf(caps_c), np.inf, caps_c * frac)
            tail_c = np.where(np.isinf(caps_c), 0.0,
                              rf_recharge_seconds(caps_c) * jm)
            ccum_c = None
            if use_charge:
                ctr = charge_capacity_jitter_stream(
                    m, charge_reboots or 256, caps_c, seed=seed,
                    cv=charge_cv, bias_cv=charge_bias_cv, lane_lo=lo)
                ccum_c = charge_trace_cumulative(ctr)
            return caps_c, rem0_c, tail_c, None, ccum_c

        res = _chunked_replay(
            _plan_rows(plan), len(plan), lanes, lane_chunk, make_inputs,
            lambda lo, m: (lo + np.arange(m)) // n_devices,
            reduce=reduce, edges=edges, n_groups=n_caps,
            event_chunk=event_chunk, prefetch=prefetch, **common)
        if reduce == "stats":
            res.group_labels = capacities
            res.wall_s = time.perf_counter() - t0
            return res
        out, _peak = res
    else:
        caps = np.repeat(capacities, n_devices)
        frac = initial_charge_fraction(lanes, seed=seed)
        jit_mult = harvest_jitter(lanes, seed=seed + 1, cv=recharge_cv)
        rem0 = np.where(np.isinf(caps), np.inf, caps * frac)
        tail = np.where(np.isinf(caps), 0.0,
                        rf_recharge_seconds(caps) * jit_mult)
        ccum = None
        if use_charge:
            ctr = charge_capacity_jitter(lanes, charge_reboots or 256, caps,
                                         seed=seed + 3, cv=charge_cv,
                                         bias_cv=charge_bias_cv)
            ccum = charge_trace_cumulative(ctr)
        if reduce == "stats":
            gid = np.repeat(np.arange(n_caps, dtype=np.int32), n_devices)
            parts = _run_replay(_plan_rows(plan), caps, rem0,
                                shared_rows=True, tail_s=tail,
                                charge_cum=ccum, n_rows=len(plan),
                                chunk=event_chunk, reduce="stats",
                                group_id=gid, edges=edges,
                                n_groups=n_caps, **common)
            stats = FleetStats.from_parts(parts, edges,
                                          group_labels=capacities)
            stats.wall_s = time.perf_counter() - t0
            stats.peak_lane_bytes = _lane_io_bytes(lanes, caps, rem0, tail,
                                                   ccum)
            return stats
        out = _run_replay(_plan_rows(plan), caps, rem0, shared_rows=True,
                          tail_s=tail, charge_cum=ccum, n_rows=len(plan),
                          chunk=event_chunk, **common)
    return CapacitorSweepResult(
        strategy, capacities, n_devices,
        completed=(~out["stuck"]).reshape(shape),
        live_s=(out["live"] / CLOCK_HZ).reshape(shape),
        dead_s=out["dead"].reshape(shape),
        reboots=out["reboots"].reshape(shape),
        energy_j=(out["live"] * JOULES_PER_CYCLE).reshape(shape),
        wall_s=time.perf_counter() - t0,
        wasted_cycles=out["wasted"].reshape(shape),
        belief_cycles=out["belief"].reshape(shape),
        policy=policy, theta=theta, batch_rows=batch_rows,
        belief_alpha=belief_alpha)
