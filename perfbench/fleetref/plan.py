"""The plan-row reference: a frozen copy of the port's row emission.

Copied from ``src/repro_torch/core/fleetsim.py`` (``KIND_*``, ``_RowBuffer``,
``_emit_parametric_tails_layer``, ``build_plan``, ``_plan_rows``,
``FleetPlan.total_cycles``) and ``src/repro_torch/core/intermittent.py``
(``_alloc_activations``) at commit f60fe63.  ``build_rows`` is
``build_plan`` without the continuous-power reference run: that run only
yields ``max_atomic`` and ``ref_output``, which no row depends on, so the
reference leaves it out.  Numpy only; the sibling modules are frozen copies
of the port's ``energy``, ``nvstore``, ``vecloop`` and ``inference``.
"""

from __future__ import annotations

import math

import numpy as np

from .energy import (Device, LEA_COSTS, OP_CLASSES, SOFTWARE_COSTS,
                     class_cycle_vector, make_power_system)
from .inference import (Conv2D, DenseFC, SimNet, TAILS_FC_ENTRY_COSTS,
                        build_layer_segments, iter_task_spans,
                        naive_layer_cycles, sonic_segments,
                        tails_conv_entry_costs, tails_stage_iter_costs,
                        tails_tile_candidates, tails_tile_cost_from,
                        tails_tile_index, tails_tile_schedule)
from .nvstore import NVStore

KIND_WORK = 0
KIND_BURN = 1
KIND_CALIB = 2
KIND_SEND = 3

STRATEGIES = ("naive", "tile-8", "tile-32", "tile-128", "sonic", "tails")

N_CLASSES = len(OP_CLASSES)
K_TILES = len(tails_tile_candidates())

ROW_FIELDS = ("kind", "n", "iter_cycles", "entry_cycles", "iter_class",
              "entry_class", "commit_cycles", "commit_class",
              "entry_seg_class", "entry_seg_cycles", "tile_flag")
TILE_FIELDS = ("tile_n", "tile_iter_cycles", "tile_iter_class",
               "tile_sel_cost")

_CURSOR_COMMIT = {"fram_write": 1}


class _RowBuffer:
    def __init__(self, costs, parametric: bool = False):
        self.costs = costs
        self.parametric = parametric
        self.rows: list[tuple] = []

    def _vec(self, counts: dict) -> np.ndarray:
        return np.asarray(class_cycle_vector(self.costs, counts))

    def _segments(self, entry_seq) -> tuple[list, list]:
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
            tile = (np.zeros(K_TILES), np.zeros(K_TILES),
                    np.zeros((K_TILES, N_CLASSES)), np.zeros(K_TILES))
        self.rows.append((kind, float(n), float(iv.sum()), float(ev.sum()),
                          iv, ev, float(cv.sum()), cv, segs,
                          int(tile_flag), *tile))

    def work(self, n: int, iter_counts: dict, entry_counts: dict,
             commit_counts: dict | None = None,
             entry_seq: list | None = None) -> None:
        self._append(KIND_WORK, n, self._vec(iter_counts),
                     self._vec(entry_counts), self._vec(commit_counts or {}),
                     self._segments(entry_seq or [(entry_counts, 1.0)]))

    def burn(self) -> None:
        z = np.zeros(N_CLASSES)
        self._append(KIND_BURN, 0.0, z, z, z, ([0], [0.0]))

    def calib(self, taps: int) -> None:
        z = np.zeros(N_CLASSES)
        sel = np.asarray([tails_tile_cost_from(self.costs, taps, c)
                          for c in tails_tile_candidates()])
        self._append(KIND_CALIB, 0.0, z, z, z, ([0], [0.0]),
                     tile=(np.zeros(K_TILES), np.zeros(K_TILES),
                           np.zeros((K_TILES, N_CLASSES)), sel))

    def tails_work(self, total: int, taps: int, stage: str,
                   entry_counts: dict, commit_counts: dict,
                   nominal_k: int) -> None:
        tile_n = np.zeros(K_TILES)
        tile_ic = np.zeros(K_TILES)
        tile_iv = np.zeros((K_TILES, N_CLASSES))
        sel = np.zeros(K_TILES)
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


def _merge(into: dict, counts: dict, times: float = 1.0) -> None:
    for op, k in counts.items():
        into[op] = into.get(op, 0.0) + k * times


def _alloc_activations(nv: NVStore, net: SimNet, x: np.ndarray) -> list[str]:
    names = []
    for i, s in enumerate(net.shapes()):
        name = f"act/{i}"
        nv.alloc(name, s)
        names.append(name)
    nv.raw(names[0])[...] = np.asarray(x, np.float32)
    return names


def _emit_parametric_tails_layer(buf: _RowBuffer, layer, in_shape,
                                 nominal_k: int) -> None:
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


def build_rows(net: SimNet, x: np.ndarray, strategy: str, power,
               parametric: bool = False) -> dict:
    """One (net, strategy, power) cell's rows: ``{"rows": {field: array},
    "capacity", "recharge_s", "total_cycles"}``."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    power_sys = make_power_system(power)
    costs = LEA_COSTS if strategy == "tails" else SOFTWARE_COSTS
    capacity = math.inf if power_sys.continuous else power_sys.cycles_per_charge
    buf = _RowBuffer(costs, parametric=parametric)

    if strategy == "naive":
        probe = Device(make_power_system("continuous"), costs)
        counts: dict = {}
        seq: list = []
        for layer, in_shape in zip(net.layers, net.shapes()):
            lc = naive_layer_cycles(probe, layer, in_shape)
            _merge(counts, lc)
            seq.append((lc, 1.0))
        buf.work(0, {}, counts, entry_seq=seq)
        return _plan(buf, capacity, power_sys.recharge_s, parametric)

    nv = NVStore(None)
    names = _alloc_activations(nv, net, x)
    probe = Device(make_power_system("continuous"), costs)
    tile_k = int(strategy.split("-")[1]) if strategy.startswith("tile") else 0
    calibrated: dict[int, int] = {}
    shapes = net.shapes()

    for pc, layer in enumerate(net.layers):
        if strategy == "tails":
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
        buf.work(0, {}, {"fram_write": 1})
    return _plan(buf, capacity, power_sys.recharge_s, parametric)


def _plan(buf: _RowBuffer, capacity: float, recharge_s: float,
          parametric: bool) -> dict:
    arrays = buf.arrays()
    fields = ROW_FIELDS + (TILE_FIELDS if parametric else ())
    rows = {k: arrays[k] for k in fields}
    total = float(np.sum(rows["entry_cycles"]
                         + rows["n"] * rows["iter_cycles"]))
    return dict(rows=rows, capacity=capacity, recharge_s=recharge_s,
                total_cycles=total)
