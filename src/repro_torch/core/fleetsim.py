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
* **Deterministic** replays run the closed-form row scan
  (:func:`_scan_step`) in plain PyTorch, one row per step.

Both are bit-identical to the JAX package's replay on the same inputs.
Not ported yet, and refused with ``NotImplementedError``: ``mesh=``,
``reduce="stats"``, ``lane_chunk``/``prefetch``, ``PlanSet`` design
sweeps, the legacy ``backend="_while"`` and ``capacitor_sweep``
(``ROADMAP.md`` Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .energy import (CLOCK_HZ, Device, JOULES_PER_CYCLE, LEA_COSTS,
                     OP_CLASSES, SOFTWARE_COSTS, class_cycle_vector,
                     make_power_system)
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
#: CPU tensors.  Deterministic replays take the closed-form scan whatever
#: the backend.
REPLAY_BACKENDS = ("auto", "torch", "cuda")

#: Where each option the port does not cover yet is queued.
_NOT_PORTED = "not ported yet (ROADMAP.md Queue 1, item {})"


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

    for pc, layer in enumerate(net.layers):
        if strategy == "tails":
            # Pre-seed the capacity-calibrated tile (pure schedule) and emit
            # the charge-burning discovery attempts -- as BURN rows baked for
            # this capacitor, or as one CALIB row whose burn count the scan
            # derives per lane -- in the first-use order the scalar executor
            # performs them.
            t = layer.w.shape[3] if isinstance(layer, Conv2D) else \
                1 if isinstance(layer, DenseFC) else None
            if t is not None and t not in calibrated:
                tile, burns = tails_tile_schedule(costs, capacity, t)
                calibrated[t] = burns
                if parametric:
                    buf.calib(t)
                else:
                    nv.alloc(f"tails/tile/{t}", (), np.int64, init=tile)
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
                segs = sonic_segments(nv, layer, names[pc], names[pc + 1],
                                      f"L{pc}")
            else:
                segs = build_layer_segments(nv, probe, layer, names[pc],
                                            names[pc + 1], f"L{pc}", strategy)
            if strategy in ("sonic", "tails"):
                for s in segs:
                    buf.work(s.n, s.iter_costs, s.seg_costs, _CURSOR_COMMIT)
            else:
                # Tile-k: enumerate the actual tasks (a task may span segment
                # boundaries), each an atomic redo-log + commit + transition.
                # The span-ordered dicts are the row's charge-segment list
                # (the scalar runner charges seg entry, then iters, per
                # span, then the commit walk).
                for u, hi, spans in iter_task_spans(segs, tile_k):
                    counts = {}
                    seq = []
                    for seg, lo_l, hi_l in spans:
                        _merge(counts, seg.seg_costs)
                        seq.append((seg.seg_costs, 1.0))
                        _merge(counts, seg.iter_costs, hi_l - lo_l)
                        seq.append((seg.iter_costs, float(hi_l - lo_l)))
                    tail = {"commit_word": hi - u, "task_transition": 1}
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


def _bucket_rows(rows: dict, lane_axis: bool) -> dict:
    """Pad the plan's row axis to a power-of-two bucket (>= 64) and the
    charge-segment axis to a power-of-two bucket (>= 4), the JAX
    package's shapes.  Padding rows are all-zero WORK rows -- both replay
    paths complete them for free without touching any output channel --
    and the event stream's ``s_real`` cursor bound never walks them
    anyway.  ``lane_axis`` is ``False`` for a single shared plan (row
    axis 0) and ``True`` for a leading per-lane axis."""
    ax = 1 if lane_axis else 0
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
        out[k] = np.pad(v, pads)
    return out


def _reboot_upper_bound(rows: dict, caps: np.ndarray,
                        lane_axis: bool) -> np.ndarray:
    """Cheap per-lane estimate of how many reboots a replay can plausibly
    take: nominal plan cycles over the nominal charge (with a 4x safety
    margin for jitter, torn-prefix re-execution and adaptive drains),
    plus one reboot per BURN row and a full ladder per CALIB row.  Used
    only to decide whether the event stream's all-nominal fast path is
    *reachable* (``reboots >= nominal_from``); an under-estimate never
    changes results, the charge-wise step just walks the nominal tail one
    charge at a time."""
    ax = 1 if lane_axis else 0
    work = np.sum(rows["entry_cycles"]
                  + rows["n"] * (rows["iter_cycles"]
                                 + rows["commit_cycles"]), axis=ax)
    if "tile_n" in rows:
        work = work + np.sum(
            np.max(rows["tile_n"] * rows["tile_iter_cycles"], axis=-1),
            axis=ax)
    burns = (np.sum(rows["kind"] == KIND_BURN, axis=ax)
             + _K_TILES * np.sum(rows["kind"] == KIND_CALIB, axis=ax))
    with np.errstate(invalid="ignore"):
        est = np.where(np.isinf(caps), 0.0, 4.0 * work / caps)
    return est + burns


# ==========================================================================
# Replay
# ==========================================================================

def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: see ROADMAP.md Queue 1, {item!r}")


def _scan_step(cap, trace_cum, tail_s, theta, conf, radio,
               adaptive: bool, parametric: bool, has_send: bool,
               st: dict, row: dict) -> dict:
    """Advance every lane over one plan row on the deterministic path:
    every charge delivers exactly ``cap``, so an ``n``-iteration row's
    reboots collapse to the closed form (the event stream's
    :func:`~repro_torch.kernels.charge_replay.fast_forward` applied to a
    fresh row), and BURN/CALIB rows burn whole nominal charges."""
    from ..kernels.charge_replay import (ChargeState, _add_at, _where,
                                         fast_forward, row_ctx,
                                         send_defer_wait, trace_window)

    ctx = row_ctx(row, cap, theta, adaptive, parametric,
                  conf=conf, radio=radio, has_send=has_send)
    zero = torch.zeros_like(cap)
    send_wait = torch.zeros_like(st["dead"])
    defer_now = torch.zeros_like(st["stuck"])
    if has_send:
        is_send = row["kind"] == KIND_SEND
        want_send = is_send & (ctx.send_bytes > 0.0) & ~ctx.row_stuck
        closed, wait = send_defer_wait(st["live"], st["dead"], radio)
        defer_now = want_send & closed
        send_wait = torch.where(defer_now, wait, zero)

    passthrough = row["kind"] != KIND_WORK
    if has_send:
        passthrough = passthrough & (row["kind"] != KIND_SEND)
    cs0 = ChargeState(
        rem=st["rem"], bel=st["bel"], left=ctx.n, live=st["live"],
        reboots=st["reboots"], classes=st["classes"], wasted=st["wasted"],
        pend=st["pend"], pend_class=st["pend_class"],
        pend_rows=st["pend_rows"], bhat=st["bhat"], chg=st["chg"],
        debt=torch.zeros_like(cap),
        debt_class=torch.zeros_like(st["pend_class"]),
        stuck=st["stuck"], done=passthrough)
    out = fast_forward(ctx, cap, theta, adaptive, cs0)
    rem, bel, live, reboots = st["rem"], st["bel"], st["live"], st["reboots"]
    classes, bhat = st["classes"], st["bhat"]
    new_rem, new_bel, new_live = out.rem, out.bel, out.live
    new_reboots, new_classes = out.reboots, out.classes
    new_stuck, new_wasted, new_chg = out.stuck, out.wasted, out.chg

    # BURN rows: a failed calibration attempt drains the whole buffer
    is_burn = row["kind"] == KIND_BURN
    new_rem = torch.where(is_burn, cap, new_rem)
    new_bel = torch.where(is_burn, bhat, new_bel)
    new_live = torch.where(is_burn, live + rem, new_live)
    new_reboots = torch.where(is_burn, reboots + 1.0, new_reboots)
    burn_vec = _add_at(torch.zeros_like(classes), _BURN_IDX, rem)
    new_classes = _where(is_burn, classes + burn_vec, new_classes)
    new_stuck = torch.where(is_burn, st["stuck"], new_stuck)
    new_wasted = torch.where(is_burn, st["wasted"], new_wasted)
    new_chg = torch.where(is_burn, zero, new_chg)

    # CALIB rows: per-lane burn count from the capacitor (Sec. 7.1)
    if parametric:
        is_calib = row["kind"] == KIND_CALIB
        burns = ctx.k.to(rem.dtype)
        calib_live = torch.where(burns > 0, rem + (burns - 1.0) * cap, zero)
        calib_rem = torch.where(burns > 0, cap, rem)
        new_rem = torch.where(is_calib, calib_rem, new_rem)
        new_bel = torch.where(is_calib, torch.where(burns > 0, bhat, bel),
                              new_bel)
        new_live = torch.where(is_calib, live + calib_live, new_live)
        new_reboots = torch.where(is_calib, reboots + burns, new_reboots)
        calib_vec = _add_at(torch.zeros_like(classes), _BURN_IDX, calib_live)
        new_classes = _where(is_calib, classes + calib_vec, new_classes)
        new_stuck = torch.where(is_calib, st["stuck"], new_stuck)
        new_wasted = torch.where(is_calib, st["wasted"], new_wasted)
        new_chg = torch.where(is_calib & (burns > 0), zero, new_chg)

    # decision 3: per-reboot dead time (the window wait adds first)
    new_dead = (st["dead"] + send_wait) + trace_window(
        trace_cum, reboots, new_reboots, tail_s)

    tx, sent, deferred = st["tx_bytes"], st["sent"], st["deferred"]
    if has_send:
        adv_tx = is_send & ~ctx.row_stuck
        tx = tx + torch.where(adv_tx, ctx.send_bytes, zero)
        sent = sent + torch.where(adv_tx & (ctx.send_bytes > 0.0),
                                  torch.ones_like(cap), zero)
        deferred = deferred + torch.where(defer_now, torch.ones_like(cap),
                                          zero)
    return dict(rem=new_rem, bel=new_bel, live=new_live,
                reboots=new_reboots, dead=new_dead, classes=new_classes,
                wasted=new_wasted, stuck=new_stuck, pend=out.pend,
                pend_class=out.pend_class, pend_rows=out.pend_rows,
                bhat=out.bhat, chg=new_chg, tx_bytes=tx, sent=sent,
                deferred=deferred)


def _scan_replay(rows: dict, cap, rem0, trace_cum, tail_s, theta, conf,
                 radio, *, adaptive: bool, parametric: bool,
                 shared_rows: bool, has_send: bool) -> dict:
    """The deterministic closed-form replay: :func:`_scan_step` over every
    row of the (padded) table, all lanes at once."""
    from ..kernels.charge_replay import pack_rows, unpack_row

    packed, layout = pack_rows(rows, shared_rows)
    n = cap.shape[0]
    zero = torch.zeros_like(rem0)
    zc = torch.zeros((n, _N_CLASSES), dtype=torch.float64,
                     device=cap.device)
    st = dict(rem=rem0, bel=rem0, live=zero, reboots=zero, dead=zero,
              classes=zc, wasted=zero,
              stuck=torch.zeros(n, dtype=torch.bool, device=cap.device),
              pend=zero, pend_class=zc, pend_rows=zero, bhat=cap + zero,
              chg=zero, tx_bytes=zero, sent=zero, deferred=zero)
    for s in range(packed.shape[-2]):
        row = unpack_row(packed, layout,
                         torch.full((n,), s, dtype=torch.int64,
                                    device=cap.device))
        st = _scan_step(cap, trace_cum, tail_s, theta, conf, radio,
                        adaptive, parametric, has_send, st, row)
    return dict(live=st["live"], reboots=st["reboots"], dead=st["dead"],
                classes=st["classes"], wasted=st["wasted"],
                stuck=st["stuck"], rem=st["rem"], belief=st["bhat"],
                tx_bytes=st["tx_bytes"], msgs_sent=st["sent"],
                msgs_deferred=st["deferred"])


def _validate_replay_knobs(policy: str, batch_rows: int,
                           belief_alpha: float, backend: str) -> None:
    if policy not in REPLAY_POLICIES:
        raise ValueError(f"unknown replay policy {policy!r}; "
                         f"expected one of {REPLAY_POLICIES}")
    if batch_rows < 1:
        raise ValueError(f"batch_rows must be >= 1, got {batch_rows}")
    if not 0.0 <= belief_alpha < 1.0:
        raise ValueError(f"belief_alpha must be in [0, 1), "
                         f"got {belief_alpha}")
    if backend == "_while":
        raise _not_ported("backend='_while'", "the legacy '_while' oracle")
    if backend not in REPLAY_BACKENDS:
        raise ValueError(f"unknown replay backend {backend!r}; "
                         f"expected one of {REPLAY_BACKENDS}")


def _check_unported(reduce: str = "none", lane_chunk=None, prefetch=None,
                    mesh=None) -> None:
    """Refuse the options of the JAX entry points that the port does not
    cover yet, rather than ignoring them."""
    if reduce == "stats":
        raise _not_ported("reduce='stats'", "reduce='stats' and fleetstats")
    if reduce != "none":
        raise ValueError(f"unknown reduce mode {reduce!r}")
    if lane_chunk is not None or prefetch is not None:
        raise _not_ported("lane_chunk/prefetch", "lane_chunk and prefetch")
    if mesh is not None:
        raise _not_ported("mesh=", "mesh sharding")


def _run_replay(rows: dict, caps: np.ndarray, rem0: np.ndarray,
                shared_rows: bool, trace_cum: np.ndarray | None = None,
                tail_s: np.ndarray | None = None, policy: str = "fixed",
                theta: float = 0.5, batch_rows: int = 1,
                belief_alpha: float = 0.0,
                charge_cum: np.ndarray | None = None,
                backend: str = "auto", n_rows=None, chunk=None,
                conf: np.ndarray | None = None, radio=None,
                device="cuda") -> dict:
    """Replay ``rows`` over every lane and return the per-lane channels as
    numpy arrays.  ``shared_rows=True``: one plan broadcast to every lane
    (fleet sweeps); ``False``: one plan per lane (``replay_plans``)."""
    from ..kernels.charge_replay import (EVENT_CHUNK, charge_replay,
                                         default_event_chunk, event_replay)
    from ..runtime.failures import (charge_trace_nominal_from,
                                    pad_charge_trace_columns)
    from ..runtime.radio import N_RADIO, radio_vector

    _validate_replay_knobs(policy, batch_rows, belief_alpha, backend)
    dev = resolve_device(device)
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError("backend='cuda' launches the CUDA kernel and "
                         "refuses CPU tensors; use device='cuda'")
    n_lanes = caps.shape[0]
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
    s_axis = 0 if shared_rows else 1
    s_real = np.broadcast_to(
        np.asarray(n_rows if n_rows is not None
                   else rows["kind"].shape[s_axis], np.int32), (n_lanes,))
    enable_fast = has_burn = False
    nominal_from = np.zeros(n_lanes, np.float64)
    if stochastic:
        has_burn = bool(np.any(rows["kind"] == KIND_BURN))
        rows = _bucket_rows(rows, lane_axis=not shared_rows)
        if charge_cum is not None:
            charge_cum = pad_charge_trace_columns(charge_cum, caps)
            nominal_from = charge_trace_nominal_from(charge_cum, caps)
            enable_fast = bool(np.any(
                _reboot_upper_bound(rows, caps, not shared_rows)
                >= nominal_from))
        else:
            enable_fast = True
    if chunk is None or chunk == "auto":
        chunk = (default_event_chunk(rows["kind"].shape[s_axis])
                 if stochastic else EVENT_CHUNK)
    if trace_cum is None:
        trace_cum = np.zeros((n_lanes, 1), np.float64)
    if charge_cum is None:
        charge_cum = np.zeros((n_lanes, 1), np.float64)
    if tail_s is None:
        tail_s = np.zeros(n_lanes, np.float64)

    def f64(a, shape=None):
        a = np.asarray(a, np.float64)
        if shape is not None:
            a = np.broadcast_to(a, shape)
        return torch.tensor(a, device=dev)

    t_rows = {k: torch.tensor(np.asarray(v), device=dev)
              for k, v in rows.items()}
    cap_t = f64(caps)
    rem0_t = f64(rem0)
    tc_t = f64(trace_cum)
    ts_t = f64(tail_s, (n_lanes,))
    conf_t = f64(conf, (n_lanes,))
    radio_t = f64(radio_vec)
    if not stochastic:
        out = _scan_replay(t_rows, cap_t, rem0_t, tc_t, ts_t, float(theta),
                           conf_t, radio_t, adaptive=adaptive,
                           parametric=parametric, shared_rows=shared_rows,
                           has_send=has_send)
    else:
        args = (t_rows, cap_t, rem0_t, tc_t, ts_t, f64(charge_cum),
                f64(nominal_from),
                torch.tensor(s_real, dtype=torch.int32, device=dev),
                float(theta), float(batch_rows), float(belief_alpha))
        kw = dict(adaptive=adaptive, parametric=parametric,
                  shared_rows=shared_rows, enable_fast=enable_fast,
                  has_burn=has_burn, has_send=has_send, conf=conf_t,
                  radio=radio_t)
        if backend == "torch":
            out = event_replay(*args, chunk=chunk, **kw)
        else:
            out = charge_replay(*args, chunk=chunk, **kw)
    return {k: v.cpu().numpy() for k, v in out.items()}


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
                 seed: int | None = None,
                 recharge_cv: float = 0.25, trace_reboots: int = 0,
                 charge_cv: float = 0.0, charge_bias_cv: float = 0.0,
                 charge_reboots: int = 0, lane_lo: int = 0,
                 event_chunk=None, lane_chunk: int | None = None,
                 prefetch: int | None = None,
                 radio=None, conf: np.ndarray | None = None,
                 device="cuda") -> list[ReplayOut]:
    """Replay many plans at once, one lane per plan (the JAX package's
    ``replay_plans`` with ``reduce="none"``).

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
    default); it never changes results.  ``device`` defaults to
    ``"cuda"``."""
    from ..runtime.failures import (charge_capacity_jitter_stream,
                                    charge_trace_cumulative,
                                    harvest_jitter_stream,
                                    inference_confidence_stream,
                                    initial_charge_fraction_stream,
                                    reboot_recharge_times_stream,
                                    recharge_trace_cumulative)

    resolve_device(device)
    _check_unported(reduce, lane_chunk, prefetch)
    if radio is not None:
        plans = [with_uplink(p) for p in plans]
        if conf is None and seed is not None:
            conf = inference_confidence_stream(len(plans), seed=seed,
                                               lane_lo=lane_lo)
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
    out = _run_replay(_pad_stack(plans), caps, rem0, shared_rows=False,
                      trace_cum=cum, tail_s=tail, policy=policy,
                      theta=theta, batch_rows=batch_rows,
                      belief_alpha=belief_alpha, charge_cum=ccum,
                      backend=backend, n_rows=n_rows_arr,
                      chunk=event_chunk, conf=conf, radio=radio,
                      device=device)
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


def fleet_sweep(net: SimNet | None = None, x: np.ndarray | None = None,
                strategy: str | None = None, power=None,
                n_devices: int = 1000, seed: int = 0,
                recharge_cv: float = 0.25,
                plan: FleetPlan | None = None,
                policy: str = "fixed", theta: float = 0.5,
                batch_rows: int = 1, belief_alpha: float = 0.0,
                trace_reboots: int = 0, charge_cv: float = 0.0,
                charge_bias_cv: float = 0.0,
                charge_reboots: int = 0, mesh=None,
                backend: str = "auto", reduce: str = "none",
                lane_chunk: int | None = None,
                event_chunk=None, prefetch: int | None = None,
                radio=None, conf=None, device="cuda") -> FleetSweepResult:
    """Replay one (strategy, power) plan across ``n_devices`` simulated
    devices with per-device harvest jitter (the JAX package's
    ``fleet_sweep`` with ``reduce="none"`` and no ``lane_chunk``).

    Each device wakes at a random buffer level and recharges at its own
    rate; ``trace_reboots > 0`` draws per-reboot recharge times,
    ``charge_cv``/``charge_bias_cv``/``charge_reboots`` a per-charge
    capacity trace (the stochastic path).  The inputs are the JAX
    package's legacy draws at the same seeds (fraction ``seed``, harvest
    ``seed + 1``, recharge ``seed + 2``, capacity ``seed + 3``, confidence
    ``seed + 4``), so the two packages replay identical fleets.  The plan
    is shared by every lane.  ``device`` defaults to ``"cuda"``."""
    from ..runtime.failures import (charge_capacity_jitter,
                                    charge_trace_cumulative,
                                    harvest_jitter, inference_confidence,
                                    initial_charge_fraction,
                                    reboot_recharge_times,
                                    recharge_trace_cumulative)

    resolve_device(device)
    _check_unported(reduce, lane_chunk, prefetch, mesh)
    t0 = time.perf_counter()
    if plan is not None and not isinstance(plan, FleetPlan):
        raise _not_ported(f"plan={type(plan).__name__}",
                          "PlanSet design sweeps")
    if plan is None:
        if net is None or x is None or strategy is None or power is None:
            raise ValueError("fleet_sweep needs (net, x, strategy, power) "
                             "to build a plan, or an explicit plan= "
                             "FleetPlan")
        plan = build_plan(net, x, strategy, power)
    if radio is not None:
        plan = with_uplink(plan)
    if strategy is None:
        strategy = plan.strategy
    if power is None:
        power = plan.power
    use_charge = charge_cv > 0 or charge_bias_cv > 0 or charge_reboots > 0
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
    out = _run_replay(_plan_rows(plan), caps, rem0, shared_rows=True,
                      trace_cum=cum, tail_s=tail, policy=policy,
                      theta=theta, batch_rows=batch_rows,
                      belief_alpha=belief_alpha, charge_cum=ccum,
                      backend=backend, n_rows=len(plan),
                      chunk=event_chunk, conf=conf, radio=radio,
                      device=device)
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


def capacitor_sweep(*_args, **_kwargs):
    """One parameterized plan over a (capacitors x devices) grid: not
    ported yet."""
    raise _not_ported("capacitor_sweep", "capacitor_sweep")
