# Frozen copy of src/repro_torch/core/inference.py (the port at commit
# f60fe63), kept under perfbench/ so that the benchmark's plan-row reference
# cannot move with the program.  Imports only numpy and its sibling copies.
# Kept whole on purpose, so that a diff against the original at that commit
# shows these lines alone, though ``plan.build_rows`` uses its layer specs,
# segment builders and cost tables, not the intermittent runtimes
# (``FlatLoopRunner``, ``TiledTaskRunner``, ``run_naive``) nor the
# ``ref_forward`` methods.
"""Intermittent DNN inference runtime: layers x execution strategies.

Implements the paper's six implementations (Fig. 9) over a common layer set:

  naive     -- fastest code, accumulates in registers, tolerates NO
               intermittence (restarts from scratch; non-terminates when the
               network needs more energy than the device buffers).
  tile-k    -- Alpaca [52]: loops split into tasks of k iterations, writes
               redo-logged, commit + transition per task, task restarts on
               failure.  k in {8, 32, 128}.
  sonic     -- loop continuation + loop-ordered buffering (dense layers) +
               sparse undo-logging (sparse FC).  One flattened NV cursor per
               layer; buffer polarity is derived from the cursor, so every
               commit is a single atomic word write.
  tails     -- sonic + LEA/DMA acceleration with one-time tile calibration.

Every strategy computes the same numerical result; the intermittent execution
of each strategy is verified bit-identical to its own continuous execution.

Layer iteration orders follow Sec. 6.2 exactly:
  * conv / dense FC: loop-ordered buffering -- outer over filter elements
    (resp. input neurons), inner over output positions, A/B buffer parity
    flips per outer stage.  Weights are read once per stage (kept in a
    register), which is why SONIC's inner loop is only ~40% more expensive
    than naive's.
  * sparse FC: CSC traversal with sparse undo-logging; the undo log's write
    cursor is the loop-continuation cursor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .energy import Device, NonTermination, PowerFailure
from .nvstore import NVStore
from .vecloop import charge_bulk, per_iter_cycles

RELU = lambda v: np.maximum(v, 0.0)


# ==========================================================================
# Layer specs
# ==========================================================================

@dataclass
class Conv2D:
    """Dense or sparse-filter 2-D convolution (valid padding)."""

    w: np.ndarray                 # (Co, Ci, kh, kw)
    b: np.ndarray                 # (Co,)
    stride: int = 1
    relu: bool = True
    name: str = "conv"

    def out_shape(self, in_shape):
        ci, h, wdt = in_shape
        co, ci2, kh, kw = self.w.shape
        assert ci == ci2, f"{self.name}: Ci mismatch {ci} vs {ci2}"
        s = self.stride
        return (co, (h - kh) // s + 1, (wdt - kw) // s + 1)

    @property
    def density(self) -> float:
        return float(np.count_nonzero(self.w)) / self.w.size

    @property
    def sparse_iter(self) -> bool:
        return self.density < 0.5

    def nnz_elements(self, f: int):
        """Nonzero (ci, dy, dx, w) quadruples of filter f (sparse iteration)."""
        ci, dy, dx = np.nonzero(self.w[f])
        return list(zip(ci.tolist(), dy.tolist(), dx.tolist(),
                        self.w[f][ci, dy, dx].tolist()))

    def elements(self, f: int):
        if self.sparse_iter:
            return self.nnz_elements(f)
        co, ci, kh, kw = self.w.shape
        out = []
        for c in range(ci):
            for y in range(kh):
                for x in range(kw):
                    out.append((c, y, x, float(self.w[f, c, y, x])))
        return out

    def macs(self, in_shape) -> int:
        _, ho, wo = self.out_shape(in_shape)
        per_pos = int(np.count_nonzero(self.w)) if self.sparse_iter \
            else self.w[0].size * self.w.shape[0]
        if self.sparse_iter:
            return per_pos * ho * wo
        return self.w.shape[0] * self.w[0].size * ho * wo

    def n_params(self) -> int:
        if self.sparse_iter:   # stored compressed: value + packed index
            return int(np.count_nonzero(self.w)) * 2 + self.b.size
        return self.w.size + self.b.size

    def ref_forward(self, x: np.ndarray) -> np.ndarray:
        co, ho, wo = self.out_shape(x.shape)
        out = np.zeros((co, ho, wo), np.float32)
        s = self.stride
        _, kh, kw = self.w.shape[1:]
        for f in range(co):
            acc = np.full((ho, wo), self.b[f], np.float32)
            for (c, dy, dx, wv) in self.elements(f):
                win = x[c, dy:dy + ho * s:s, dx:dx + wo * s:s]
                acc = acc + np.float32(wv) * win
            out[f] = acc
        return RELU(out) if self.relu else out


@dataclass
class MaxPool2D:
    k: int = 2          # square pool, or set (kh, kw) separately
    kh: int = 0
    kw: int = 0
    name: str = "pool"

    def _ks(self):
        return (self.kh or self.k, self.kw or self.k)

    def out_shape(self, in_shape):
        c, h, w = in_shape
        kh, kw = self._ks()
        return (c, h // kh, w // kw)

    def macs(self, in_shape) -> int:
        return 0

    def n_params(self) -> int:
        return 0

    def ref_forward(self, x):
        c, h, w = x.shape
        kh, kw = self._ks()
        hh, ww = h // kh, w // kw
        v = x[:, :hh * kh, :ww * kw].reshape(c, hh, kh, ww, kw)
        return v.max(axis=(2, 4))


@dataclass
class DenseFC:
    w: np.ndarray                 # (m, n)
    b: np.ndarray                 # (m,)
    relu: bool = True
    name: str = "fc"

    def out_shape(self, in_shape):
        assert int(np.prod(in_shape)) == self.w.shape[1], \
            f"{self.name}: in {in_shape} vs n={self.w.shape[1]}"
        return (self.w.shape[0],)

    def macs(self, in_shape) -> int:
        return self.w.size

    def n_params(self) -> int:
        return self.w.size + self.b.size

    def ref_forward(self, x):
        y = self.w @ x.reshape(-1) + self.b
        return RELU(y) if self.relu else y


@dataclass
class SparseFC:
    """Pruned FC layer stored CSC (column = input neuron)."""

    w: np.ndarray                 # dense-with-zeros (m, n) master copy
    b: np.ndarray
    relu: bool = True
    name: str = "sfc"
    _csc: tuple = field(default=None, repr=False)

    def csc(self):
        if self._csc is None:
            cols, rows, vals = [], [], []
            for j in range(self.w.shape[1]):
                nz = np.nonzero(self.w[:, j])[0]
                cols.extend([j] * len(nz))
                rows.extend(nz.tolist())
                vals.extend(self.w[nz, j].tolist())
            object.__setattr__(self, "_csc", (
                np.asarray(rows, np.int64), np.asarray(cols, np.int64),
                np.asarray(vals, np.float32)))
        return self._csc

    @property
    def nnz(self) -> int:
        return int(np.count_nonzero(self.w))

    def out_shape(self, in_shape):
        assert int(np.prod(in_shape)) == self.w.shape[1]
        return (self.w.shape[0],)

    def macs(self, in_shape) -> int:
        return self.nnz

    def n_params(self) -> int:
        return self.nnz * 2 + self.b.size   # value + packed index

    def ref_forward(self, x):
        y = self.w @ x.reshape(-1) + self.b
        return RELU(y) if self.relu else y


Layer = Conv2D | MaxPool2D | DenseFC | SparseFC


@dataclass
class SimNet:
    """A network for the device simulator."""

    layers: list
    input_shape: tuple
    name: str = "net"

    def shapes(self):
        s = self.input_shape
        out = [s]
        for l in self.layers:
            s = l.out_shape(s)
            out.append(s)
        return out

    def ref_forward(self, x: np.ndarray) -> np.ndarray:
        for l in self.layers:
            x = l.ref_forward(np.asarray(x, np.float32))
        return x

    def total_macs(self) -> int:
        return sum(l.macs(s) for l, s in zip(self.layers, self.shapes()))

    def total_params(self) -> int:
        return sum(l.n_params() for l in self.layers)

    def params_bytes(self) -> int:
        return self.total_params() * 2     # Q15 fixed point on device


# ==========================================================================
# Segment plans: a layer is a list of (n, iter_costs, seg_costs, apply) run
# under one flattened NV cursor.
# ==========================================================================

@dataclass
class Segment:
    n: int
    iter_costs: dict
    apply: Callable[[int, int], None]     # segment-local [lo, hi)
    seg_costs: dict = field(default_factory=dict)  # charged on (re-)entry


class FlatLoopRunner:
    """Runs segments under a single flattened NV cursor (loop continuation).

    Buffer polarity and all derived state are pure functions of the cursor,
    so the per-iteration commit is one atomic NV word write.  Resumption
    re-enters the interrupted segment (recharging its per-segment setup,
    e.g. re-loading the filter weight into a register).
    """

    def __init__(self, nv: NVStore, device: Device, cursor: str):
        self.nv = nv
        self.device = device
        self.cursor = cursor
        if cursor not in nv:
            nv.write_scalar(cursor, 0)

    def run(self, segments: list[Segment]) -> None:
        bounds = np.cumsum([0] + [s.n for s in segments])
        total = int(bounds[-1])
        while True:
            u = int(self.nv.raw(self.cursor))
            if u >= total:
                return
            si = int(np.searchsorted(bounds, u, side="right") - 1)
            seg = segments[si]
            lo = u - int(bounds[si])
            charge_bulk(self.device, seg.seg_costs, 1)   # (re-)entry setup
            cyc = per_iter_cycles(self.device, seg.iter_costs)
            while lo < seg.n:
                rem = self.device.remaining
                afford = seg.n - lo if math.isinf(rem) else \
                    min(seg.n - lo, int(rem // max(cyc, 1e-9)))
                if afford <= 0:
                    self.device.drain()
                seg.apply(lo, lo + afford)
                charge_bulk(self.device, seg.iter_costs, afford)
                lo += afford
                self.nv.write_scalar(self.cursor, int(bounds[si]) + lo)

    def max_iter_cycles(self, segments) -> float:
        """Atomic-region size: one iteration (+ its segment re-entry)."""
        return max(per_iter_cycles(self.device, s.iter_costs)
                   + per_iter_cycles(self.device, s.seg_costs)
                   for s in segments)


# ==========================================================================
# SONIC segment plans (loop continuation + idempotence tricks)
# ==========================================================================

def _sonic_conv_segments(nv: NVStore, layer: Conv2D, in_name: str,
                         out_name: str, ln: str) -> list[Segment]:
    x = nv.raw(in_name)
    co, ho, wo = layer.out_shape(x.shape)
    hw = ho * wo
    a0, a1 = f"{ln}/acc0", f"{ln}/acc1"
    if a0 not in nv:
        nv.alloc(a0, (hw,))
        nv.alloc(a1, (hw,))
    out_flat = nv.raw(out_name).reshape(co, -1)
    st = layer.stride
    segs: list[Segment] = []
    act = RELU if layer.relu else (lambda v: v)

    for f in range(co):
        elems = layer.elements(f)
        n_e = len(elems)

        def buf(stage, f=f):
            # write_buf(s) = acc[(s+1)%2]; read_buf(s) = acc[s%2]
            return nv.raw(a0), nv.raw(a1)

        # stage 0: init back buffer with bias
        def init(lo, hi, f=f):
            wb = nv.raw(a1)           # write_buf(0) = acc[(0+1)%2] = acc1
            wb[lo:hi] = layer.b[f]
        segs.append(Segment(hw, {"fram_write": 2, "control": 1}, init))

        # stages 1..E: apply one filter element across all positions
        for s_idx, (ci, dy, dx, wv) in enumerate(elems, start=1):
            def acc(lo, hi, ci=ci, dy=dy, dx=dx, wv=wv, s=s_idx):
                rb = nv.raw(a0 if s % 2 == 0 else a1)
                wb = nv.raw(a1 if s % 2 == 0 else a0)
                win = x[ci, dy:dy + ho * st:st, dx:dx + wo * st:st].reshape(-1)
                wb[lo:hi] = rb[lo:hi] + np.float32(wv) * win[lo:hi]
            # weight (and its packed index, if sparse) loaded into a register
            # once per segment; re-loaded on re-entry after a failure.
            seg_entry = {"fram_read": 2 if layer.sparse_iter else 1,
                         "control": 4}
            segs.append(Segment(
                hw,
                {"fram_read": 2, "mac": 1, "fram_write": 2, "control": 1},
                acc, seg_entry))

        # stage E+1: store activation
        def store(lo, hi, f=f, s=n_e + 1):
            rb = nv.raw(a0 if s % 2 == 0 else a1)
            out_flat[f, lo:hi] = act(rb[lo:hi])
        segs.append(Segment(
            hw, {"fram_read": 1, "alu": 1, "fram_write": 2, "control": 1},
            store))
    return segs


def _sonic_fc_segments(nv: NVStore, layer: DenseFC, in_name: str,
                       out_name: str, ln: str) -> list[Segment]:
    x = nv.raw(in_name).reshape(-1)
    m, n = layer.w.shape
    a0, a1 = f"{ln}/acc0", f"{ln}/acc1"
    if a0 not in nv:
        nv.alloc(a0, (m,))
        nv.alloc(a1, (m,))
    y = nv.raw(out_name)
    act = RELU if layer.relu else (lambda v: v)
    segs: list[Segment] = []

    def init(lo, hi):
        nv.raw(a1)[lo:hi] = layer.b[lo:hi]
    segs.append(Segment(m, {"fram_read": 1, "fram_write": 2, "control": 1},
                        init))

    for j in range(n):
        def acc(lo, hi, j=j, s=j + 1):
            rb = nv.raw(a0 if s % 2 == 0 else a1)
            wb = nv.raw(a1 if s % 2 == 0 else a0)
            wb[lo:hi] = rb[lo:hi] + layer.w[lo:hi, j] * np.float32(x[j])
        # x[j] is loaded once per segment and held in a register.
        segs.append(Segment(
            m, {"fram_read": 3, "mac": 1, "fram_write": 2, "control": 1},
            acc, {"fram_read": 1, "control": 4}))

    def store(lo, hi, s=n + 1):
        rb = nv.raw(a0 if s % 2 == 0 else a1)
        y[lo:hi] = act(rb[lo:hi])
    segs.append(Segment(m, {"fram_read": 1, "alu": 1, "fram_write": 2,
                            "control": 1}, store))
    return segs


def _sonic_sparse_fc_segments(nv: NVStore, layer: SparseFC, in_name: str,
                              out_name: str, ln: str) -> list[Segment]:
    """Sparse undo-logging: in-place accumulation into the output activation;
    the undo-log's write cursor is the loop cursor (constant space)."""
    x = nv.raw(in_name).reshape(-1)
    rows, cols, vals = layer.csc()
    m = layer.w.shape[0]
    y = nv.raw(out_name)
    act = RELU if layer.relu else (lambda v: v)
    segs: list[Segment] = []

    def init(lo, hi):
        y[lo:hi] = layer.b[lo:hi]
    segs.append(Segment(m, {"fram_read": 1, "fram_write": 2, "control": 1},
                        init))

    def accum(lo, hi):
        np.add.at(y, rows[lo:hi], vals[lo:hi] * x[cols[lo:hi]])
    # per nonzero: value+index+x+orig reads; undo protocol = 5 NV writes
    # (slot idx, slot val, read cursor, data, write cursor).
    segs.append(Segment(len(vals),
                        {"fram_read": 4, "mac": 1, "fram_write": 5,
                         "control": 2}, accum))

    def store(lo, hi):
        y[lo:hi] = act(y[lo:hi])            # idempotent in-place rectify
    segs.append(Segment(m, {"fram_read": 1, "alu": 1, "fram_write": 2,
                            "control": 1}, store))
    return segs


def _sonic_pool_segments(nv: NVStore, layer: MaxPool2D, in_name: str,
                         out_name: str, ln: str) -> list[Segment]:
    x = nv.raw(in_name)
    out = nv.raw(out_name)
    kh, kw = layer._ks()
    kk = kh * kw
    n = out.size

    def apply(lo, hi):
        pooled = layer.ref_forward(x).reshape(-1)
        out.reshape(-1)[lo:hi] = pooled[lo:hi]
    return [Segment(n, {"fram_read": kk, "alu": kk - 1,
                        "fram_write": 2, "control": 1}, apply)]


def sonic_segments(nv, layer, in_name, out_name, ln) -> list[Segment]:
    if isinstance(layer, Conv2D):
        return _sonic_conv_segments(nv, layer, in_name, out_name, ln)
    if isinstance(layer, DenseFC):
        return _sonic_fc_segments(nv, layer, in_name, out_name, ln)
    if isinstance(layer, SparseFC):
        return _sonic_sparse_fc_segments(nv, layer, in_name, out_name, ln)
    if isinstance(layer, MaxPool2D):
        return _sonic_pool_segments(nv, layer, in_name, out_name, ln)
    raise TypeError(f"unsupported layer {layer!r}")


# ==========================================================================
# TAILS segment plans (LEA + DMA, tile-granular)
# ==========================================================================

#: LEA operates out of 4 KB SRAM; three staging buffers (input window, front,
#: back) of 16-bit words bound the tile size.
LEA_SRAM_WORDS = 2048
LEA_MAX_TILE = LEA_SRAM_WORDS // 3


def tails_tile_cost_from(costs, taps: int, tile: int) -> float:
    """Cycles for one calibrated FIR tile (pure function of the cost table)."""
    c = costs
    return (2 * c.dma_setup + 3 * tile * c.dma_word + c.lea_invoke
            + taps * tile * c.lea_mac + 2 * tile * c.shift_sw
            + c.fram_write + 2 * c.control)


def tails_stage_iter_costs(stage: str, tile: int, taps: int = 1) -> dict:
    """Per-iteration op counts of one TAILS stage at a given tile size.

    The single source of the per-tile cost dicts, shared by the live
    segment functions below and the fleet simulator's parameterized plan
    extraction (``fleetsim.build_plan(parametric=True)``) so the two
    cannot diverge.
    ``"mac"`` is one LEA FIR/vector-MAC invocation over a tile (``taps`` = kw
    for convolution rows, 1 for FC columns); ``"init"``/``"store"`` are the
    DMA-tiled bias fill and activation write-back.
    """
    if stage == "init":
        return {"dma_setup": 1, "dma_word": tile, "fram_write": 1,
                "control": 1}
    if stage == "mac":
        return {"dma_setup": 2, "dma_word": 3 * tile, "lea_invoke": 1,
                "lea_mac": taps * tile, "shift_sw": 2 * tile,
                "fram_write": 1, "control": 2}
    if stage == "store":
        return {"dma_setup": 1, "dma_word": tile, "shift_sw": tile,
                "fram_write": 1, "control": 1}
    raise KeyError(stage)


def tails_conv_entry_costs(kw: int) -> dict:
    """Segment (re-)entry cost of one conv FIR stage: DMA the kw-tap filter
    row into LEA SRAM plus dispatch bookkeeping."""
    return {"dma_setup": 1, "dma_word": kw, "control": 4}


#: Segment (re-)entry cost of one FC column stage: re-load ``x[j]``.
TAILS_FC_ENTRY_COSTS = {"fram_read": 1, "control": 4}


def tails_tile_candidates() -> tuple[int, ...]:
    """The Sec. 7.1 calibration ladder: ``LEA_MAX_TILE`` halved down to 1.

    ``tails_tile_schedule`` walks exactly this ladder, so the candidate at
    index ``i`` is the tile selected after ``i`` failed (charge-burning)
    attempts.
    """
    out, t = [], LEA_MAX_TILE
    while t > 1:
        out.append(t)
        t //= 2
    out.append(1)
    return tuple(out)


def tails_tile_index(costs, capacity: float, taps: int) -> int:
    """Index into :func:`tails_tile_candidates` that calibration selects for
    ``capacity`` -- equal to the number of failed attempts (burns)."""
    cands = tails_tile_candidates()
    for i, t in enumerate(cands[:-1]):
        if tails_tile_cost_from(costs, taps, t) <= capacity:
            return i
    return len(cands) - 1


def tails_tile_cost(device: Device, taps: int, tile: int) -> float:
    return tails_tile_cost_from(device.costs, taps, tile)


def tails_tile_schedule(costs, capacity: float, taps: int) -> tuple[int, int]:
    """Pure calibration schedule: the tile size that fits one charge, and the
    number of failed (charge-burning) attempts it takes to discover it.

    Separated from :func:`tails_calibrate` so the batched fleet simulator can
    emit the calibration burns as plan rows without a live device.
    """
    tile, burns = LEA_MAX_TILE, 0
    while tile > 1 and tails_tile_cost_from(costs, taps, tile) > capacity:
        burns += 1
        tile //= 2
    return tile, burns


def tails_calibrate(nv: NVStore, device: Device, taps: int) -> int:
    """One-time recursive calibration (Sec. 7.1): halve the tile until one
    tile's FIR invocation completes within a single charge.  Failed attempts
    burn a full charge cycle, which is accounted."""
    key = f"tails/tile/{taps}"
    if key in nv and int(nv.raw(key)) > 0:
        return int(nv.raw(key))
    tile, burns = tails_tile_schedule(device.costs, device.capacity, taps)
    if not device.power.continuous:
        for _ in range(burns):
            # a real device discovers this by dying mid-tile: burn a charge
            try:
                device.charge("lea_mac", device.capacity + 1)
            except PowerFailure:
                device.reboot()
    nv.alloc(key, (), np.int64, init=tile)
    return tile


def _tails_conv_segments(nv: NVStore, device: Device, layer: Conv2D,
                         in_name: str, out_name: str, ln: str
                         ) -> list[Segment]:
    """FIR-DTC convolution: each stage applies one kw-tap FIR row (one
    (ci, dy) pair of one filter) across all output positions, tile by tile.
    Sparse filters are zero-padded dense (Sec. 7.2), trading wasted MACs for
    LEA throughput."""
    x = nv.raw(in_name)
    co, ho, wo = layer.out_shape(x.shape)
    hw = ho * wo
    ci_n, kh, kw = layer.w.shape[1:]
    # DMA only what the workload needs: clamp the calibrated tile to the
    # feature-map size (TAILS configures LEA's vector length per invocation).
    tile = max(1, min(tails_calibrate(nv, device, kw), hw))
    n_tiles = -(-hw // tile)
    a0, a1 = f"{ln}/acc0", f"{ln}/acc1"
    if a0 not in nv:
        nv.alloc(a0, (hw,))
        nv.alloc(a1, (hw,))
    out_flat = nv.raw(out_name).reshape(co, -1)
    st = layer.stride
    act = RELU if layer.relu else (lambda v: v)
    per_tile = tails_stage_iter_costs("mac", tile, kw)
    segs: list[Segment] = []

    for f in range(co):
        def init(lo, hi, f=f):
            nv.raw(a1)[lo * tile:min(hi * tile, hw)] = layer.b[f]
        segs.append(Segment(n_tiles, tails_stage_iter_costs("init", tile),
                            init))
        s_idx = 0
        for c in range(ci_n):
            for dy in range(kh):
                s_idx += 1

                def fir(lo, hi, f=f, c=c, dy=dy, s=s_idx):
                    rb = nv.raw(a0 if s % 2 == 0 else a1)
                    wb = nv.raw(a1 if s % 2 == 0 else a0)
                    plo, phi = lo * tile, min(hi * tile, hw)
                    accum = rb[plo:phi].copy()
                    for dx in range(kw):
                        wv = np.float32(layer.w[f, c, dy, dx])
                        if wv == 0.0:
                            pass  # padded-dense: LEA still burns the MAC
                        win = x[c, dy:dy + ho * st:st,
                                dx:dx + wo * st:st].reshape(-1)
                        accum = accum + wv * win[plo:phi]
                    wb[plo:phi] = accum
                segs.append(Segment(n_tiles, dict(per_tile), fir,
                                    tails_conv_entry_costs(kw)))
        def store(lo, hi, f=f, s=ci_n * kh + 1):
            rb = nv.raw(a0 if s % 2 == 0 else a1)
            plo, phi = lo * tile, min(hi * tile, hw)
            out_flat[f, plo:phi] = act(rb[plo:phi])
        segs.append(Segment(n_tiles, tails_stage_iter_costs("store", tile),
                            store))
    return segs


def _tails_fc_segments(nv: NVStore, device: Device, layer: DenseFC,
                       in_name: str, out_name: str, ln: str
                       ) -> list[Segment]:
    """Dense FC on LEA's vector-MAC, tiled over outputs."""
    x = nv.raw(in_name).reshape(-1)
    m, n = layer.w.shape
    tile = max(1, min(tails_calibrate(nv, device, 1), m))
    n_tiles = -(-m // tile)
    a0, a1 = f"{ln}/acc0", f"{ln}/acc1"
    if a0 not in nv:
        nv.alloc(a0, (m,))
        nv.alloc(a1, (m,))
    y = nv.raw(out_name)
    act = RELU if layer.relu else (lambda v: v)
    segs: list[Segment] = []

    def init(lo, hi):
        plo, phi = lo * tile, min(hi * tile, m)
        nv.raw(a1)[plo:phi] = layer.b[plo:phi]
    segs.append(Segment(n_tiles, tails_stage_iter_costs("init", tile), init))

    for j in range(n):
        def acc(lo, hi, j=j, s=j + 1):
            rb = nv.raw(a0 if s % 2 == 0 else a1)
            wb = nv.raw(a1 if s % 2 == 0 else a0)
            plo, phi = lo * tile, min(hi * tile, m)
            wb[plo:phi] = rb[plo:phi] + layer.w[plo:phi, j] * np.float32(x[j])
        segs.append(Segment(n_tiles, tails_stage_iter_costs("mac", tile),
                            acc, dict(TAILS_FC_ENTRY_COSTS)))

    def store(lo, hi, s=n + 1):
        rb = nv.raw(a0 if s % 2 == 0 else a1)
        plo, phi = lo * tile, min(hi * tile, m)
        y[plo:phi] = act(rb[plo:phi])
    segs.append(Segment(n_tiles, tails_stage_iter_costs("store", tile),
                        store))
    return segs


def tails_segments(nv, device, layer, in_name, out_name, ln) -> list[Segment]:
    if isinstance(layer, Conv2D):
        return _tails_conv_segments(nv, device, layer, in_name, out_name, ln)
    if isinstance(layer, DenseFC):
        return _tails_fc_segments(nv, device, layer, in_name, out_name, ln)
    # Sparse FC stays in software (Sec. 7.2: no filter reuse on LEA);
    # pooling is not an LEA primitive either.
    return sonic_segments(nv, layer, in_name, out_name, ln)


def build_layer_segments(nv: NVStore, device: Device, layer, in_name: str,
                         out_name: str, ln: str, strategy: str
                         ) -> list[Segment]:
    """Segment plan for one layer under one strategy.

    The single entry point used by both the scalar executor
    (``intermittent._run_layer_chain``) and the batched fleet simulator's
    plan extraction (``fleetsim.build_plan``): a segment plan is pure data
    (iteration counts + per-class costs + apply closures), so the same plan
    can be executed one charge at a time or replayed vectorized.
    """
    if strategy == "sonic":
        return sonic_segments(nv, layer, in_name, out_name, ln)
    if strategy == "tails":
        return tails_segments(nv, device, layer, in_name, out_name, ln)
    return alpaca_segments(nv, layer, in_name, out_name, ln)


# ==========================================================================
# Alpaca baseline: in-place segment plans + tiled task execution
# ==========================================================================

def _alpaca_iter_costs(kind: str) -> dict:
    """Per-iteration costs under Alpaca semantics: task-shared reads pay a
    log lookup, every write is dynamically privatized (redo-logged)."""
    if kind == "conv_acc":
        return {"fram_read": 2, "log_lookup": 1, "mac": 1, "redo_log": 1,
                "control": 1}
    if kind == "fc_acc":
        return {"fram_read": 3, "log_lookup": 1, "mac": 1, "redo_log": 1,
                "control": 1}
    if kind == "sparse_acc":
        return {"fram_read": 4, "log_lookup": 1, "mac": 1, "redo_log": 1,
                "control": 2}
    if kind == "init":
        return {"fram_read": 1, "redo_log": 1, "control": 1}
    if kind == "store":
        return {"fram_read": 1, "log_lookup": 1, "alu": 1, "redo_log": 1,
                "control": 1}
    if kind == "pool":
        return {"fram_read": 4, "alu": 3, "redo_log": 1, "control": 1}
    raise KeyError(kind)


def alpaca_segments(nv: NVStore, layer, in_name: str, out_name: str,
                    ln: str) -> list[Segment]:
    """Same loop geometry as SONIC but in-place (the redo log resolves WAR),
    so there is no A/B buffer; effects are applied at task commit."""
    x = nv.raw(in_name)
    segs: list[Segment] = []
    if isinstance(layer, Conv2D):
        co, ho, wo = layer.out_shape(x.shape)
        hw = ho * wo
        acc_n = f"{ln}/acc"
        if acc_n not in nv:
            nv.alloc(acc_n, (hw,))
        out_flat = nv.raw(out_name).reshape(co, -1)
        st = layer.stride
        act = RELU if layer.relu else (lambda v: v)
        for f in range(co):
            def init(lo, hi, f=f):
                nv.raw(acc_n)[lo:hi] = layer.b[f]
            segs.append(Segment(hw, _alpaca_iter_costs("init"), init))
            for (ci, dy, dx, wv) in layer.elements(f):
                def acc(lo, hi, ci=ci, dy=dy, dx=dx, wv=wv):
                    a = nv.raw(acc_n)
                    win = x[ci, dy:dy + ho * st:st,
                            dx:dx + wo * st:st].reshape(-1)
                    a[lo:hi] = a[lo:hi] + np.float32(wv) * win[lo:hi]
                segs.append(Segment(hw, _alpaca_iter_costs("conv_acc"), acc,
                                    {"fram_read": 2, "control": 4}))
            def store(lo, hi, f=f):
                out_flat[f, lo:hi] = act(nv.raw(acc_n)[lo:hi])
            segs.append(Segment(hw, _alpaca_iter_costs("store"), store))
    elif isinstance(layer, DenseFC):
        m, n = layer.w.shape
        xf = x.reshape(-1)
        y = nv.raw(out_name)
        act = RELU if layer.relu else (lambda v: v)
        def init(lo, hi):
            y[lo:hi] = layer.b[lo:hi]
        segs.append(Segment(m, _alpaca_iter_costs("init"), init))
        for j in range(n):
            def acc(lo, hi, j=j):
                y[lo:hi] = y[lo:hi] + layer.w[lo:hi, j] * np.float32(xf[j])
            segs.append(Segment(m, _alpaca_iter_costs("fc_acc"), acc,
                                {"fram_read": 1, "control": 4}))
        def store(lo, hi):
            y[lo:hi] = act(y[lo:hi])
        segs.append(Segment(m, _alpaca_iter_costs("store"), store))
    elif isinstance(layer, SparseFC):
        rows, cols, vals = layer.csc()
        m = layer.w.shape[0]
        xf = x.reshape(-1)
        y = nv.raw(out_name)
        act = RELU if layer.relu else (lambda v: v)
        def init(lo, hi):
            y[lo:hi] = layer.b[lo:hi]
        segs.append(Segment(m, _alpaca_iter_costs("init"), init))
        def accum(lo, hi):
            np.add.at(y, rows[lo:hi], vals[lo:hi] * xf[cols[lo:hi]])
        segs.append(Segment(len(vals), _alpaca_iter_costs("sparse_acc"),
                            accum))
        def store(lo, hi):
            y[lo:hi] = act(y[lo:hi])
        segs.append(Segment(m, _alpaca_iter_costs("store"), store))
    elif isinstance(layer, MaxPool2D):
        out = nv.raw(out_name)
        n = out.size
        def apply(lo, hi):
            pooled = layer.ref_forward(x).reshape(-1)
            out.reshape(-1)[lo:hi] = pooled[lo:hi]
        segs.append(Segment(n, _alpaca_iter_costs("pool"), apply))
    else:
        raise TypeError(f"unsupported layer {layer!r}")
    return segs


def iter_task_spans(segments: list[Segment], k: int, start: int = 0):
    """Yield one Tile-k task at a time as ``(u, hi, spans)``: the task's
    global iteration range plus its segment-local ``(segment, lo, hi)``
    spans (a task may cross segment boundaries).

    The single source of the task-splitting geometry, shared by
    :class:`TiledTaskRunner` and the batched fleet simulator's plan
    extraction (``fleetsim.build_plan``) so the two stay bit-equivalent.
    """
    bounds = np.cumsum([0] + [s.n for s in segments])
    total = int(bounds[-1])
    u = start
    while u < total:
        hi = min(u + k, total)
        spans = []
        v = u
        while v < hi:
            si = int(np.searchsorted(bounds, v, side="right") - 1)
            lo_l = v - int(bounds[si])
            hi_l = min(lo_l + (hi - v), segments[si].n)
            spans.append((segments[si], lo_l, hi_l))
            v += hi_l - lo_l
        yield u, hi, spans
        u = hi


class TiledTaskRunner:
    """Executes segments as fixed tasks of k iterations (Fig. 6 Tile-k).

    A task: k redo-logged iterations + commit (copy log to NV) + transition.
    On power failure the current task restarts (its volatile log is lost),
    re-charging everything -- the wasted work the paper measures.  Effects
    are applied exactly once, at commit.
    """

    def __init__(self, nv: NVStore, device: Device, pc_name: str, k: int):
        self.nv = nv
        self.device = device
        self.pc = pc_name
        self.k = k
        if pc_name not in nv:
            nv.write_scalar(pc_name, 0)

    def task_cycles(self, seg: Segment, iters: int) -> float:
        c = self.device.costs
        return (per_iter_cycles(self.device, seg.iter_costs) * iters
                + per_iter_cycles(self.device, seg.seg_costs)
                + iters * c.commit_word + c.task_transition)

    def max_task_cycles(self, segments: list[Segment]) -> float:
        return max(self.task_cycles(s, min(self.k, s.n)) for s in segments)

    def run(self, segments: list[Segment]) -> None:
        start = int(self.nv.raw(self.pc)) * self.k
        for u, hi, spans in iter_task_spans(segments, self.k, start):
            # Phase 1: execute (charges may die mid-task; log is volatile --
            # a PowerFailure abandons the iterator and re-entry resumes
            # from the committed task cursor).
            for seg, lo_l, hi_l in spans:
                charge_bulk(self.device, seg.seg_costs, 1)
                charge_bulk(self.device, seg.iter_costs, hi_l - lo_l)
            # Phase 2: commit + transition, then apply effects exactly once.
            self.device.charge("commit_word", hi - u)
            self.device.charge("task_transition", 1)
            for seg, lo_l, hi_l in spans:
                seg.apply(lo_l, hi_l)
            self.nv.write_scalar(self.pc, -(-hi // self.k))


# ==========================================================================
# Naive implementation (no intermittence support)
# ==========================================================================

def naive_layer_cycles(device: Device, layer, in_shape) -> dict:
    """Op counts for the register-accumulating naive implementation."""
    if isinstance(layer, Conv2D):
        macs = layer.macs(in_shape)
        out_n = int(np.prod(layer.out_shape(in_shape)))
        extra = 2 if layer.sparse_iter else 0   # packed index reads
        return {"fram_read": 2 * macs + extra * macs, "mac": macs,
                "control": macs, "fram_write": out_n, "alu": out_n}
    if isinstance(layer, DenseFC):
        macs = layer.macs(in_shape)
        m = layer.w.shape[0]
        return {"fram_read": 2 * macs, "mac": macs, "control": macs,
                "fram_write": m, "alu": m}
    if isinstance(layer, SparseFC):
        macs = layer.nnz
        m = layer.w.shape[0]
        return {"fram_read": 4 * macs, "mac": macs, "control": macs,
                "fram_write": m, "alu": m}
    if isinstance(layer, MaxPool2D):
        out_n = int(np.prod(layer.out_shape(in_shape)))
        return {"fram_read": 4 * out_n, "alu": 3 * out_n,
                "fram_write": out_n, "control": out_n}
    raise TypeError(f"unsupported layer {layer!r}")


def run_naive(net: SimNet, x: np.ndarray, device: Device) -> np.ndarray:
    """Single pass; restarts from scratch on power failure."""
    act = np.asarray(x, np.float32)
    shapes = net.shapes()
    for layer, in_shape in zip(net.layers, shapes):
        for op, n in naive_layer_cycles(device, layer, in_shape).items():
            device.charge(op, n)
        act = layer.ref_forward(act)
    return act
