"""The fused stochastic charge replay: plain PyTorch version and CUDA kernel.

The JAX package replays the stochastic energy model as a masked event
stream (``repro/kernels/charge_replay.py``): one event is one charge of
the lane's current row, or the row's closed-form remainder when every
later refill is nominal, or a whole BURN/CALIB row.  This module keeps
that semantics in two forms:

* :func:`event_replay` -- the plain PyTorch version, vectorized over a
  lane axis in float64 with ``torch.where`` masks where the JAX package
  uses ``vmap``.  It runs on the CPU (the tests' path and the oracle) and
  on the card (the yardstick the kernel is held against).  Every float
  operation happens in the order the JAX package performs it, one rounding
  per operation, so results are bit-identical to the JAX replay and to
  the pure-Python reference interpreter.  It is never run under
  ``torch.compile``: fusion could contract a multiply and an add.
* :func:`charge_replay` -- the wrapper of the hand-written CUDA lane
  kernel (``csrc/charge_replay.cu``, one thread per lane).  CUDA tensors
  launch the kernel; CPU tensors take the plain version.  The kernel has
  two designs (:data:`DESIGNS`): ``"hoisted"``, the main path's, chooses
  the branch of each class loop once an event (so a class loop's loads
  issue together), takes ``parametric`` and ``has_send`` as template
  parameters (:func:`kernel_variant`) and sizes its blocks to cover the
  card (:func:`lane_block`); ``"direct"``, the first design, branches
  inside the class loop, takes every flag at run time and runs 128 lanes
  a block.  Both give the same bits.

Masking scheme
--------------
A lane whose row cursor ``i`` has reached its real row count ``s_real``
keeps its whole event state bitwise unchanged, so the plain version can
run every lane for the same number of events (checking for completion
every ``chunk`` events) and the kernel can loop each lane on its own, and
both give the same answer.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..core.fleetsim import (KIND_BURN, KIND_CALIB, KIND_SEND, KIND_WORK,
                             _BURN_IDX, _CONTROL_IDX, _K_TILES, _N_CLASSES,
                             _RADIO_IDX)
from ..runtime.radio import (N_RADIO, R_CLASS, R_CLK, R_CONF_HI, R_CONF_LO,
                             R_CPB, R_DUTY, R_HDR, R_PERIOD, R_TOPK,
                             R_WAKEUP)
from .calibrate import SMS

#: Events between two completion checks of the plain version (the floor of
#: :func:`default_event_chunk`'s clamp).  Results do not depend on it.
EVENT_CHUNK = 128

#: Clamp bounds of the plan-shape-derived chunk.
_MIN_EVENT_CHUNK, _MAX_EVENT_CHUNK = 64, 512

F64 = torch.float64


def default_event_chunk(plan_rows: int) -> int:
    """Plan-shape-derived events per completion check: the bucketed row
    count clamped to ``[64, 512]`` (the JAX package's rule, kept so the
    two replays walk the same number of masked events)."""
    if plan_rows < 1:
        raise ValueError(f"plan_rows must be >= 1, got {plan_rows}")
    return int(min(_MAX_EVENT_CHUNK,
                   max(_MIN_EVENT_CHUNK,
                       1 << (int(plan_rows) - 1).bit_length())))


def event_chunk_candidates(plan_rows: int) -> tuple:
    """The plan-shape default plus one octave either side, clamped to the
    same ``[64, 512]`` window and deduplicated."""
    base = default_event_chunk(plan_rows)
    return tuple(sorted({
        max(_MIN_EVENT_CHUNK, min(_MAX_EVENT_CHUNK, c))
        for c in (base // 2, base, base * 2)}))


# --------------------------------------------------------------------------
# Float helpers with jnp's semantics
# --------------------------------------------------------------------------

def _max(a, b):
    """``jnp.maximum``: NaN-propagating elementwise max (``clamp`` against
    a python scalar propagates NaN too)."""
    return torch.maximum(a, b) if torch.is_tensor(b) else \
        torch.clamp_min(a, b)


def _min(a, b):
    """``jnp.minimum``: NaN-propagating elementwise min."""
    return torch.minimum(a, b) if torch.is_tensor(b) else \
        torch.clamp_max(a, b)


def _clip(x, lo, hi):
    """``jnp.clip``: ``minimum(maximum(x, lo), hi)``."""
    return _min(_max(x, lo), hi)


def _where(pred, a, b):
    """``jnp.where`` with a lane mask ``pred`` of shape ``(N,)`` against
    ``(N,)`` or ``(N, C)`` tensors (one side may be a python scalar)."""
    ref = a if torch.is_tensor(a) else b
    if ref.dim() > pred.dim():
        pred = pred.reshape(pred.shape + (1,) * (ref.dim() - pred.dim()))
    return torch.where(pred, a, b)


def _f(mask):
    """``jnp.where(mask, 1.0, 0.0)`` as float64."""
    return mask.to(F64)


def _col(x):
    """A lane scalar ``(N,)`` as a column ``(N, 1)`` for class vectors."""
    return x.unsqueeze(-1)


def _add_at(vec, idx: int, val):
    """``vec.at[:, idx].add(val)`` without touching the input."""
    out = vec.clone()
    out[:, idx] = out[:, idx] + val
    return out


# --------------------------------------------------------------------------
# Row helpers
# --------------------------------------------------------------------------

def trace_window(cum, r0, r1, fallback):
    """Windowed sum of each lane's cumulative trace over reboots
    (r0, r1]: gather-subtract inside the trace, ``fallback`` per entry
    past its end.  ``cum`` is ``(N, R)``; ``r0``, ``r1``, ``fallback`` are
    ``(N,)``."""
    last = float(cum.shape[1] - 1)
    i0 = _clip(r0, 0.0, last).to(torch.int64)
    i1 = _clip(r1, 0.0, last).to(torch.int64)
    over = _max(r1 - last, 0.0) - _max(r0 - last, 0.0)
    c1 = cum.gather(1, i1.unsqueeze(1)).squeeze(1)
    c0 = cum.gather(1, i0.unsqueeze(1)).squeeze(1)
    return c1 - c0 + over * fallback


def torn_prefix(entry_class, seg_class, seg_cycles, p):
    """Charge-order attribution of a torn entry prefix: walk the row's
    charge-segment list and book ``clip(p - start, 0, len)`` of each block
    to its own class, in segment order."""
    starts = torch.cumsum(seg_cycles, dim=1) - seg_cycles
    amt = _min(_max(_col(p) - starts, 0.0), seg_cycles)
    out = torch.zeros_like(entry_class)
    if out.device.type == "cpu":
        # the CPU scatter adds along the segment axis in order
        out.scatter_add_(1, seg_class, amt)
    else:
        # a CUDA scatter adds with atomics in no fixed order
        for g in range(seg_class.shape[1]):
            out.scatter_add_(1, seg_class[:, g:g + 1], amt[:, g:g + 1])
    return out


def _torn_or_zero(ctx, entered, p):
    """``where(entered, 0, torn_prefix(..., p))``, skipping the walk on the
    CPU when no lane is torn (the walk is then discarded on every lane).
    On the card the walk always runs: testing for a torn lane would wait
    on the device at every row."""
    zc = torch.zeros_like(ctx.entry_class)
    if zc.device.type == "cpu" and not bool((~entered).any()):
        return zc
    return _where(entered, zc, torn_prefix(ctx.entry_class, ctx.seg_class,
                                           ctx.seg_cycles, p))


def send_message_bytes(conf, radio):
    """Bytes shipped for each lane's classifier confidence under the
    packed radio vector: argmax class above ``conf_hi``, top-k logits
    above ``conf_lo``, nothing below."""
    return torch.where(conf >= radio[R_CONF_HI], radio[R_HDR] + radio[R_CLASS],
                       torch.where(conf >= radio[R_CONF_LO],
                                   radio[R_HDR] + radio[R_TOPK],
                                   0.0))


def send_cost_cycles(send_bytes, radio):
    """Cycles one transmission costs: wakeup plus per-byte TX; a skipped
    send (0 bytes) never wakes the radio."""
    return torch.where(send_bytes > 0.0,
                       radio[R_WAKEUP] + send_bytes * radio[R_CPB], 0.0)


def send_defer_wait(live, dead, radio):
    """Is the duty-cycled basestation window closed at each lane's
    wall-clock ``live / clock + dead``, and how long until it reopens?
    The true division by ``radio[R_CLK]`` and the ``abs`` are the JAX
    package's pinned float-op sequence; every op here rounds once."""
    period = radio[R_PERIOD]
    t = live / radio[R_CLK] + dead
    ps = _max(period, 1e-30)
    phase = t - torch.abs(torch.floor(t / ps) * ps)
    closed = (period > 0.0) & (phase >= radio[R_DUTY] * period)
    return closed, period - phase


_INT_FIELDS = ("kind", "tile_flag", "entry_seg_class")

#: How the lanes find their rows (``shared_rows``: ``True``, ``False`` or
#: ``"plan"``): one ``(S, F)`` table for every lane (a fleet sweep), one
#: ``(N, S, F)`` table a lane (``replay_plans``), or a ``(P, S, F)`` pack of
#: candidate plans read through a per-lane plan index (a ``PlanSet`` design
#: sweep).
MODES = ("shared", "lane", "plan")


def row_mode(shared_rows) -> str:
    """The :data:`MODES` entry of a ``shared_rows`` argument."""
    if isinstance(shared_rows, str):
        if shared_rows == "plan":
            return "plan"
        raise ValueError(f"shared_rows must be True, False or 'plan', got "
                         f"{shared_rows!r}")
    return "shared" if shared_rows else "lane"


class PackedRows:
    """A row table packed once (:func:`pack_rows`) to be replayed many
    times: the chunks of a streamed sweep reuse it, and the hoisted
    design's layout of it (:func:`hoisted_table`) is made at its first
    launch and kept.  :func:`event_replay` and :func:`charge_replay` take
    it wherever they take a row dict."""

    def __init__(self, rows: dict, shared_rows):
        self.mode = row_mode(shared_rows)
        self.packed, self.layout = pack_rows(rows, shared_rows)
        self.hoisted = None

    @property
    def device(self):
        return self.packed.device


def pack_rows(rows: dict, shared_rows):
    """Flatten a plan's per-row field dict into one float64 row table,
    ``(S, F)`` for rows shared by every lane, ``(N, S, F)`` for one row
    table per lane or ``(P, S, F)`` for a pack of candidate plans
    (``shared_rows="plan"``), plus the static ``(key, offset, shape)``
    layout.  Keys are sorted (the JAX package's column order); integer
    fields are small whole numbers, exact in float64."""
    lead = 1 if row_mode(shared_rows) == "shared" else 2
    cols, layout, off = [], [], 0
    for k in sorted(rows):
        v = torch.as_tensor(rows[k])
        flat = v.reshape(tuple(v.shape[:lead]) + (-1,)).to(F64)
        layout.append((k, off, tuple(v.shape[lead:])))
        cols.append(flat)
        off += flat.shape[-1]
    return torch.cat(cols, dim=lead).contiguous(), tuple(layout)


def _packed(rows, shared_rows):
    """``(packed, layout)`` of a row dict or a :class:`PackedRows`."""
    if isinstance(rows, PackedRows):
        if rows.mode != row_mode(shared_rows):
            raise ValueError(f"rows were packed for {rows.mode!r} lanes, "
                             f"not {row_mode(shared_rows)!r}")
        return rows.packed, rows.layout
    return pack_rows(rows, shared_rows)


def unpack_row(packed, layout, i, plan=None) -> dict:
    """Gather every lane's current row: ``i`` is the ``(N,)`` row cursor;
    with a ``(P, S, F)`` pack, ``plan`` is the ``(N,)`` plan index (else a
    3-D table holds one plan a lane).  Integer fields come back as
    int64."""
    if packed.dim() == 3:
        if plan is None:
            plan = torch.arange(packed.shape[0], device=packed.device)
        stripe = packed[plan, i]
    else:
        stripe = packed[i]
    n = stripe.shape[0]
    row = {}
    for k, off, shape in layout:
        w = math.prod(shape) if shape else 1
        v = stripe[:, off:off + w]
        v = v.reshape((n,) + shape) if shape else v[:, 0]
        row[k] = v.to(torch.int64) if k in _INT_FIELDS else v
    return row


class RowCtx(NamedTuple):
    """State-independent per-row decisions: the lane's selected tile
    (decision 1) and the retry-side commit granularity."""
    kind: torch.Tensor
    n: torch.Tensor
    c: torch.Tensor
    e: torch.Tensor
    cc: torch.Tensor
    iter_class: torch.Tensor
    entry_class: torch.Tensor
    commit_class: torch.Tensor
    seg_class: torch.Tensor
    seg_cycles: torch.Tensor
    er: torch.Tensor
    cr: torch.Tensor
    crs: torch.Tensor
    iter_vecr: torch.Tensor
    batchr: torch.Tensor
    afford_nom: torch.Tensor
    row_stuck: torch.Tensor
    has_iters: torch.Tensor
    k: torch.Tensor
    send_bytes: torch.Tensor


def _take(table, k):
    """``table[lane, k[lane]]`` along axis 1."""
    idx = k.reshape(k.shape + (1,) * (table.dim() - 1))
    idx = idx.expand((table.shape[0], 1) + tuple(table.shape[2:]))
    return table.gather(1, idx).squeeze(1)


def row_ctx(row, cap, theta, adaptive: bool, parametric: bool,
            conf=None, radio=None, has_send: bool = False) -> RowCtx:
    """Decisions 1 + 2 (retry side) for one row on every lane, with a SEND
    row's cost fields overridden from the lane's confidence when
    ``has_send``."""
    if parametric:
        sel = row["tile_sel_cost"]
        k = torch.clamp((sel > _col(cap)).sum(1), 0, _K_TILES - 1)
        is_param = row["tile_flag"] > 0
        n = torch.where(is_param, _take(row["tile_n"], k), row["n"])
        c = torch.where(is_param, _take(row["tile_iter_cycles"], k),
                        row["iter_cycles"])
        iter_class = _where(is_param, _take(row["tile_iter_class"], k),
                            row["iter_class"])
    else:
        k = torch.zeros_like(row["kind"])
        n, c, iter_class = row["n"], row["iter_cycles"], row["iter_class"]
    e, entry_class = row["entry_cycles"], row["entry_class"]
    cc, commit_class = row["commit_cycles"], row["commit_class"]
    seg_cycles = row["entry_seg_cycles"]
    send_bytes = torch.zeros_like(e)
    if has_send:
        is_send = row["kind"] == KIND_SEND
        send_bytes = torch.where(is_send, send_message_bytes(conf, radio),
                                 0.0)
        cost = send_cost_cycles(send_bytes, radio)
        e = torch.where(is_send, cost, e)
        radio_vec = torch.zeros_like(entry_class)
        radio_vec[:, _RADIO_IDX] = cost
        entry_class = _where(is_send, radio_vec, entry_class)
        seg_vec = torch.zeros_like(seg_cycles)
        seg_vec[:, 0] = cost
        seg_cycles = _where(is_send, seg_vec, seg_cycles)
    has_iters = n > 0
    if adaptive:
        batchr = has_iters & (cc > 0.0) & (theta <= 1.0)
    else:
        batchr = torch.zeros_like(has_iters)
    er = torch.where(batchr, e + cc, e)
    cr = torch.where(batchr, c - cc, c)
    crs = _max(cr, 1e-30)
    iter_vecr = _where(batchr, iter_class - commit_class, iter_class)
    afford_nom = torch.floor((cap - er) / crs)
    row_stuck = torch.where(has_iters, afford_nom < 1.0, e > cap)
    return RowCtx(row["kind"], n, c, e, cc, iter_class, entry_class,
                  commit_class, row["entry_seg_class"], seg_cycles,
                  er, cr, crs, iter_vecr, batchr,
                  afford_nom, row_stuck, has_iters, k, send_bytes)


class ChargeState(NamedTuple):
    """Carry of the charge loop over one row."""
    rem: torch.Tensor          # actual deliverable left this charge
    bel: torch.Tensor          # believed budget left this charge
    left: torch.Tensor         # row iterations still to run
    live: torch.Tensor
    reboots: torch.Tensor
    classes: torch.Tensor
    wasted: torch.Tensor
    pend: torch.Tensor         # pending-window cycles
    pend_class: torch.Tensor
    pend_rows: torch.Tensor
    bhat: torch.Tensor         # EWMA believed per-charge budget
    chg: torch.Tensor          # cycles spent so far in the current charge
    debt: torch.Tensor         # torn pending work being replayed
    debt_class: torch.Tensor
    stuck: torch.Tensor
    done: torch.Tensor


def charge_once(ctx: RowCtx, cap, charge_cum, theta, window, alpha,
                adaptive: bool, s: ChargeState) -> ChargeState:
    """Exactly one charge of the row on every lane: rollback-debt replay,
    the batch/defer decision, the row phase scheduled from belief and
    executed against the actual delivery, and the EWMA belief update."""
    zc = torch.zeros_like(s.classes)
    a0 = s.rem
    est0 = s.bel

    # ---- phase 0: multi-row rollback replay
    have_debt = s.debt > 0.0
    debt_s = _max(s.debt, 1e-30)
    want = torch.where(have_debt,
                       _min(s.debt, _max(est0 - ctx.cc, 0.0)), 0.0)
    dok = have_debt & (want > 0.0) & (a0 >= want + ctx.cc)
    dfail = have_debt & ~dok
    dpart = dok & ((s.debt - want) > 0.0)
    dend = dfail | dpart
    d_exec = torch.where(dfail, _min(want, a0), 0.0)
    d_spend = torch.where(dok, want + ctx.cc, 0.0)
    a1 = a0 - d_spend
    est1 = _max(est0 - d_spend, 0.0)
    debt1 = torch.where(dok, s.debt - want, s.debt)
    dcls1 = _where(dok, s.debt_class * _col((s.debt - want) / debt_s),
                   s.debt_class)
    d_cls = _where(dok, s.debt_class * _col(want / debt_s) + ctx.commit_class,
                   zc)
    pnd1 = torch.where(dok, 0.0, s.pend)
    pcls1 = _where(dok, zc, s.pend_class)
    prw1 = torch.where(dok, 0.0, s.pend_rows)

    # ---- batch decision for this charge
    false = torch.zeros_like(have_debt)
    if adaptive:
        batch = (ctx.has_iters & (ctx.cc > 0.0)
                 & (torch.isinf(cap) | (est1 >= theta * s.bhat)))
        defer = batch & ((prw1 + 1.0) < window)
    else:
        batch = false
        defer = false
    e_b = torch.where(batch, ctx.e + ctx.cc, ctx.e)
    c_b = torch.where(batch, ctx.c - ctx.cc, ctx.c)
    c_bs = _max(c_b, 1e-30)
    iv = _where(batch, ctx.iter_class - ctx.commit_class, ctx.iter_class)

    # ---- row phase: schedule from belief, execute against actual
    entered = a1 >= ctx.e
    k_est = _clip(torch.where(est1 >= e_b, torch.floor((est1 - e_b) / c_bs),
                              0.0), 0.0, s.left)
    fin_cost = (ctx.e + s.left * c_b
                + torch.where(batch & ~defer, ctx.cc, 0.0))
    plan_fin = est1 >= fin_cost
    sched_i = torch.where(batch & plan_fin, s.left, k_est)
    k_act = _clip(torch.where(entered, torch.floor((a1 - e_b) / c_bs),
                              0.0), 0.0, s.left)
    k_exec = _clip(torch.where(entered, torch.floor((a1 - ctx.e) / c_bs),
                               0.0),
                   0.0, torch.where(batch, sched_i, s.left))
    fin = torch.where(batch, plan_fin & (a1 >= fin_cost),
                      a1 >= ctx.e + s.left * c_b)
    boundary = batch & ~plan_fin & (k_est == 0.0) & (prw1 > 0.0)
    sched_commit = torch.where(plan_fin, ~defer, (k_est > 0.0) | (prw1 > 0.0))
    commit_ok = torch.where(boundary, a1 >= ctx.cc,
                            a1 >= e_b + sched_i * c_b)
    land = batch & ~plan_fin & sched_commit & commit_ok

    exec_iters = torch.where(batch,
                             torch.where(land & ~boundary, sched_i, k_exec),
                             k_act)
    prog = torch.where(batch,
                       torch.where(land & ~boundary, sched_i, 0.0),
                       k_act)
    commit_n = _f(land)

    p_entry = torch.where(boundary,
                          torch.where(land, a1 - ctx.cc, -1.0), a1)
    entered_d = p_entry >= ctx.e
    torn_v = _torn_or_zero(ctx, entered_d, p_entry)
    entry_burn = torch.where(entered_d, ctx.e, _clip(p_entry, 0.0, ctx.e))
    cls_burn = (_where(entered_d, ctx.entry_class, zc)
                + torn_v + _col(exec_iters) * iv
                + _col(commit_n) * ctx.commit_class)
    residue = (a1 - entry_burn - exec_iters * c_b - commit_n * ctx.cc)
    cls_death = _add_at(cls_burn, _CONTROL_IDX, residue)
    spend_fin = fin_cost
    cls_fin = (ctx.entry_class + _col(s.left) * iv
               + _col(_f(batch & ~defer)) * ctx.commit_class)

    fin_ok = fin & ~dend
    committed = torch.where(batch, land, k_act > 0.0)
    tear = (~fin_ok) & ~dend & ~committed & (pnd1 > 0.0)
    waste_add = (torch.where((~fin_ok) & ~dend & batch & ~land,
                             k_exec * c_b, 0.0)
                 + torch.where(tear, pnd1, 0.0)
                 + torch.where(dfail, d_exec, 0.0))

    pnd_fin = torch.where(defer, pnd1 + spend_fin, 0.0)
    pcls_fin = _where(defer, pcls1 + ctx.entry_class + _col(s.left) * iv, zc)
    prw_fin = torch.where(defer, prw1 + 1.0, 0.0)

    died = dend | ~fin
    obs = s.chg + a0
    bh_new = torch.where((alpha > 0.0) & (s.reboots > 0.0) & died,
                         _max(torch.round(s.bhat + alpha * (obs - s.bhat)),
                              1.0),
                         s.bhat)

    stuck_now = (~fin_ok) & ctx.row_stuck
    dfail_cls = _add_at(s.debt_class * _col(d_exec / debt_s), _CONTROL_IDX,
                        a0 - d_exec)
    dpart_cls = _add_at(d_cls, _CONTROL_IDX, a1)
    dend_cls = _where(dfail, dfail_cls, dpart_cls)
    return ChargeState(
        rem=torch.where(fin_ok, a1 - spend_fin,
                        trace_window(charge_cum, s.reboots, s.reboots + 1.0,
                                     cap)),
        bel=torch.where(fin_ok, _max(est1 - spend_fin, 0.0), bh_new),
        left=torch.where(fin_ok, 0.0,
                         s.left - torch.where(dend, 0.0, prog)),
        live=s.live + torch.where(dend, a0,
                                  d_spend + torch.where(fin, spend_fin, a1)),
        reboots=s.reboots + _f(~fin_ok),
        classes=s.classes + _where(dend, dend_cls,
                                   d_cls + _where(fin, cls_fin, cls_death)),
        wasted=s.wasted + waste_add,
        pend=torch.where(dend, pnd1,
                         torch.where(fin, pnd_fin, 0.0)),
        pend_class=_where(dend, pcls1, _where(fin, pcls_fin, zc)),
        pend_rows=torch.where(dend, prw1,
                              torch.where(fin, prw_fin, 0.0)),
        bhat=bh_new,
        chg=torch.where(fin_ok, s.chg + d_spend + spend_fin, 0.0),
        debt=debt1 + torch.where(tear, pnd1, 0.0),
        debt_class=dcls1 + _where(tear, pcls1, zc),
        stuck=s.stuck | stuck_now,
        done=s.done | fin_ok | stuck_now)


def fast_forward(ctx: RowCtx, cap, theta, adaptive: bool,
                 s: ChargeState) -> ChargeState:
    """Closed-form completion of the row's remaining ``left`` iterations
    when every refill from here on delivers exactly ``cap`` (the
    deterministic path's chunk/retry algebra; ``fleetsim._scan_step`` calls
    it with a fresh row)."""
    rem, left = s.rem, s.left
    if adaptive:
        lvl0 = torch.where(torch.isinf(cap), torch.ones_like(ctx.has_iters),
                           s.bel >= theta * s.bhat)
        batch0 = ctx.has_iters & (ctx.cc > 0.0) & lvl0
    else:
        batch0 = torch.zeros_like(ctx.has_iters)
    e0 = torch.where(batch0, ctx.e + ctx.cc, ctx.e)
    c0 = torch.where(batch0, ctx.c - ctx.cc, ctx.c)
    c0s = _max(c0, 1e-30)
    iter_vec0 = _where(batch0, ctx.iter_class - ctx.commit_class,
                       ctx.iter_class)

    needed = e0 + left * c0
    ok = rem >= needed

    entered = rem >= ctx.e
    afford0 = _clip(torch.where(entered, torch.floor((rem - e0) / c0s), 0.0),
                    0.0, left)
    rem_iters = left - afford0
    afford_full = _max(ctx.afford_nom, 1.0)
    visits = torch.where(ctx.has_iters,
                         _max(torch.ceil(rem_iters / afford_full), 1.0), 1.0)
    n_last = torch.where(ctx.has_iters,
                         rem_iters - (visits - 1.0) * afford_full, 0.0)
    fail_live = rem + (visits - 1.0) * cap + ctx.er + n_last * ctx.cr
    fail_rem = cap - ctx.er - n_last * ctx.cr
    entries = visits + entered.to(rem.dtype)

    ok_commits = _f(batch0)
    fail_commits = (torch.where(ctx.batchr, visits, 0.0)
                    + _f(batch0 & (afford0 > 0)))

    fail_classes = (_col(entries) * ctx.entry_class
                    + _col(afford0) * iter_vec0
                    + _col(rem_iters) * ctx.iter_vecr
                    + _col(fail_commits) * ctx.commit_class)
    torn = _torn_or_zero(ctx, entered, rem)
    fail_classes = fail_classes + torn
    residue = (fail_live - entries * ctx.e - afford0 * c0
               - rem_iters * ctx.cr - fail_commits * ctx.cc
               - torch.where(entered, 0.0, rem))
    fail_classes = _add_at(fail_classes, _CONTROL_IDX, residue)

    ok_classes = (ctx.entry_class + _col(left) * iter_vec0
                  + _col(ok_commits) * ctx.commit_class)
    new_rem = torch.where(ok, rem - needed, fail_rem)
    return s._replace(
        rem=new_rem,
        bel=new_rem,
        left=torch.zeros_like(left),
        live=s.live + torch.where(ok, needed, fail_live),
        reboots=s.reboots + torch.where(ok, 0.0, visits),
        classes=s.classes + _where(ok, ok_classes, fail_classes),
        chg=torch.where(ok, s.chg + needed, ctx.er + n_last * ctx.cr),
        stuck=s.stuck | ((~ok) & ctx.row_stuck),
        done=torch.ones_like(s.done))


class EventState(NamedTuple):
    """Per-lane carry of the event stream: the row cursor, the charge-loop
    state, the per-row dead-time anchor and the uplink channels."""
    i: torch.Tensor            # row cursor (int64)
    fresh: torch.Tensor        # next event starts a new row
    row_r0: torch.Tensor       # reboot counter at the current row's entry
    dead: torch.Tensor
    rem: torch.Tensor
    bel: torch.Tensor
    left: torch.Tensor
    live: torch.Tensor
    reboots: torch.Tensor
    classes: torch.Tensor
    wasted: torch.Tensor
    pend: torch.Tensor
    pend_class: torch.Tensor
    pend_rows: torch.Tensor
    bhat: torch.Tensor
    chg: torch.Tensor
    debt: torch.Tensor
    debt_class: torch.Tensor
    stuck: torch.Tensor
    tx_bytes: torch.Tensor
    sent: torch.Tensor
    deferred: torch.Tensor


def _select(pred, a: NamedTuple, b: NamedTuple) -> NamedTuple:
    return type(a)(*(_where(pred, x, y) for x, y in zip(a, b)))


def event_step(packed, layout, cap, trace_cum, tail_s, charge_cum,
               nominal_from, theta, window, alpha, conf, radio,
               adaptive: bool, parametric: bool, enable_fast: bool,
               has_burn: bool, has_send: bool,
               st: EventState, active, plan=None) -> EventState:
    """One event on every lane: one charge of the current row, or the
    row's closed-form remainder when eligible, or a whole BURN/CALIB row.
    An inactive lane (``i >= s_real``) passes through bitwise.  With a
    ``(P, S, F)`` pack, ``plan`` is each lane's plan index."""
    s_pad = packed.shape[-2]
    i = torch.clamp(st.i, max=s_pad - 1)
    row = unpack_row(packed, layout, i, plan)
    ctx = row_ctx(row, cap, theta, adaptive, parametric,
                  conf=conf, radio=radio, has_send=has_send)
    fresh = st.fresh & active

    send_wait = torch.zeros_like(st.dead)
    defer_now = torch.zeros_like(fresh)
    if has_send:
        is_send = ctx.kind == KIND_SEND
        want_send = fresh & is_send & (ctx.send_bytes > 0.0) & ~ctx.row_stuck
        closed, wait = send_defer_wait(st.live, st.dead, radio)
        defer_now = want_send & closed
        send_wait = torch.where(defer_now, wait, 0.0)

    cs = ChargeState(
        rem=st.rem, bel=st.bel,
        left=torch.where(fresh, ctx.n, st.left),
        live=st.live, reboots=st.reboots, classes=st.classes,
        wasted=st.wasted, pend=st.pend, pend_class=st.pend_class,
        pend_rows=st.pend_rows, bhat=st.bhat, chg=st.chg,
        debt=torch.where(fresh, 0.0, st.debt),
        debt_class=_where(fresh, torch.zeros_like(st.debt_class),
                          st.debt_class),
        stuck=st.stuck, done=torch.zeros_like(fresh))

    slow = charge_once(ctx, cap, charge_cum, theta, window, alpha,
                       adaptive, cs)
    if enable_fast:
        # the closed form is exact iff every refill from here on is
        # nominal, the belief is exact and no cross-charge state is open
        elig = ((st.reboots >= nominal_from)
                & (cs.bel == cs.rem) & (cs.bhat == cap)
                & (cs.pend == 0.0) & (cs.pend_rows == 0.0)
                & (cs.debt == 0.0) & ~ctx.row_stuck
                & ((alpha <= 0.0) | (cs.chg + cs.rem == cap)
                   | (cs.reboots == 0.0)))
        if adaptive:
            elig = elig & (window <= 1.0)
    is_work = ctx.kind == KIND_WORK
    if has_send:
        is_work = is_work | (ctx.kind == KIND_SEND)
    work = slow
    # the closed form is computed only when some lane takes it
    if enable_fast and bool((elig & active & is_work).any()):
        work = _select(elig, fast_forward(ctx, cap, theta, adaptive, cs),
                       slow)
    out = _select(active & is_work, work, cs)

    # the BURN/CALIB overrides, where some lane is on such a row
    is_burn = active & (ctx.kind == KIND_BURN)
    if has_burn and bool(is_burn.any()):
        burn_vec = _add_at(torch.zeros_like(cs.classes), _BURN_IDX, cs.rem)
        out = out._replace(
            rem=torch.where(is_burn,
                            trace_window(charge_cum, st.reboots,
                                         st.reboots + 1.0, cap), out.rem),
            bel=torch.where(is_burn, st.bhat, out.bel),
            live=torch.where(is_burn, st.live + cs.rem, out.live),
            reboots=torch.where(is_burn, st.reboots + 1.0, out.reboots),
            classes=_where(is_burn, st.classes + burn_vec, out.classes),
            stuck=torch.where(is_burn, st.stuck, out.stuck),
            wasted=torch.where(is_burn, st.wasted, out.wasted),
            chg=torch.where(is_burn, 0.0, out.chg))

    is_calib = active & (ctx.kind == KIND_CALIB)
    if parametric and bool(is_calib.any()):
        burns = ctx.k.to(cs.rem.dtype)
        calib_live = torch.where(
            burns > 0,
            cs.rem + trace_window(charge_cum, st.reboots,
                                  st.reboots + burns - 1.0, cap), 0.0)
        calib_rem = torch.where(
            burns > 0,
            trace_window(charge_cum, st.reboots + burns - 1.0,
                         st.reboots + burns, cap), cs.rem)
        calib_vec = _add_at(torch.zeros_like(cs.classes), _BURN_IDX,
                            calib_live)
        out = out._replace(
            rem=torch.where(is_calib, calib_rem, out.rem),
            bel=torch.where(is_calib,
                            torch.where(burns > 0, st.bhat, cs.bel), out.bel),
            live=torch.where(is_calib, st.live + calib_live, out.live),
            reboots=torch.where(is_calib, st.reboots + burns, out.reboots),
            classes=_where(is_calib, st.classes + calib_vec, out.classes),
            stuck=torch.where(is_calib, st.stuck, out.stuck),
            wasted=torch.where(is_calib, st.wasted, out.wasted),
            chg=torch.where(is_calib & (burns > 0), 0.0, out.chg))

    advance = active & torch.where(is_work, out.done,
                                   torch.ones_like(out.done))
    # decision 3: per-reboot dead time, booked once per row; the window
    # wait is added first as its own float step
    dead_base = st.dead + send_wait
    dead = torch.where(advance,
                       dead_base + trace_window(trace_cum, st.row_r0,
                                                out.reboots, tail_s),
                       dead_base)
    tx_bytes, sent, deferred = st.tx_bytes, st.sent, st.deferred
    if has_send:
        adv_tx = advance & is_send & ~ctx.row_stuck
        tx_bytes = tx_bytes + torch.where(adv_tx, ctx.send_bytes, 0.0)
        sent = sent + _f(adv_tx & (ctx.send_bytes > 0.0))
        deferred = deferred + _f(defer_now)
    return EventState(
        i=st.i + advance.to(st.i.dtype),
        fresh=advance,
        row_r0=torch.where(advance, out.reboots, st.row_r0),
        dead=dead,
        rem=out.rem, bel=out.bel, left=out.left, live=out.live,
        reboots=out.reboots, classes=out.classes, wasted=out.wasted,
        pend=out.pend, pend_class=out.pend_class,
        pend_rows=out.pend_rows, bhat=out.bhat, chg=out.chg,
        debt=out.debt, debt_class=out.debt_class, stuck=out.stuck,
        tx_bytes=tx_bytes, sent=sent, deferred=deferred)


#: The output channels of one replay, in the kernel's argument order.
OUTPUTS = ("live", "reboots", "dead", "classes", "wasted", "stuck", "rem",
           "belief", "tx_bytes", "msgs_sent", "msgs_deferred")


def event_replay(rows, cap, rem0, trace_cum, tail_s, charge_cum,
                 nominal_from, s_real, theta, window, alpha, *,
                 adaptive: bool, parametric: bool, shared_rows,
                 enable_fast: bool = True, has_burn: bool = True,
                 has_send: bool = False, conf=None, radio=None,
                 chunk: int = EVENT_CHUNK, plan_idx=None) -> dict:
    """Replay every lane's plan as a masked event stream (the plain
    PyTorch version of the kernel).

    ``rows`` is the plan's field dict (or a :class:`PackedRows`),
    ``(S, ...)`` per field when ``shared_rows`` is ``True`` (one plan
    broadcast to every lane), ``(N, S, ...)`` when ``False`` (one plan per
    lane), or ``(P, S, ...)`` when ``"plan"``: a pack of candidate plans,
    lane ``l`` replaying plan ``plan_idx[l]`` (``(N,)`` integers), as the
    JAX package's ``event_replay(..., plan_idx=)``.  Every other per-lane
    input is ``(N,)`` or ``(N, R)`` float64 on the same device;
    ``theta``/``window``/``alpha`` are python floats.  The loop runs until
    every lane has ``i >= s_real``, checking every ``chunk`` events."""
    if (row_mode(shared_rows) == "plan") != (plan_idx is not None):
        raise ValueError("plan_idx goes with shared_rows='plan', and only "
                         "with it")
    packed, layout = _packed(rows, shared_rows)
    plan = None if plan_idx is None else plan_idx.to(torch.int64)
    if plan is not None and plan.numel() and not (
            0 <= int(plan.min()) and int(plan.max()) < packed.shape[0]):
        raise ValueError(f"plan_idx holds a plan out of "
                         f"[0, {packed.shape[0]})")
    n_lanes = cap.shape[0]
    if conf is None:
        conf = torch.zeros_like(cap)
    if radio is None:
        radio = torch.zeros(N_RADIO, dtype=F64, device=cap.device)
    zero = torch.zeros_like(rem0)
    zc = torch.zeros((n_lanes, _N_CLASSES), dtype=F64, device=cap.device)
    st = EventState(
        i=torch.zeros(n_lanes, dtype=torch.int64, device=cap.device),
        fresh=torch.ones(n_lanes, dtype=torch.bool, device=cap.device),
        row_r0=zero, dead=zero,
        rem=rem0, bel=rem0, left=zero, live=zero, reboots=zero,
        classes=zc, wasted=zero, pend=zero, pend_class=zc,
        pend_rows=zero, bhat=cap + zero, chg=zero, debt=zero,
        debt_class=zc,
        stuck=torch.zeros(n_lanes, dtype=torch.bool, device=cap.device),
        tx_bytes=zero, sent=zero, deferred=zero)
    s_real = s_real.to(torch.int64)
    while bool((st.i < s_real).any()):
        for _ in range(chunk):
            st = event_step(packed, layout, cap, trace_cum, tail_s,
                            charge_cum, nominal_from, theta, window, alpha,
                            conf, radio, adaptive, parametric, enable_fast,
                            has_burn, has_send, st, active=st.i < s_real,
                            plan=plan)
    return dict(live=st.live, reboots=st.reboots, dead=st.dead,
                classes=st.classes, wasted=st.wasted, stuck=st.stuck,
                rem=st.rem, belief=st.bhat,
                tx_bytes=st.tx_bytes, msgs_sent=st.sent,
                msgs_deferred=st.deferred)


# --------------------------------------------------------------------------
# The CUDA kernel and its wrapper
# --------------------------------------------------------------------------

#: Plan fields in the kernel's ``Layout`` order (csrc/charge_replay.cu).
_LAYOUT_FIELDS = ("kind", "n", "iter_cycles", "entry_cycles", "iter_class",
                  "entry_class", "commit_cycles", "commit_class",
                  "entry_seg_class", "entry_seg_cycles", "tile_flag",
                  "tile_n", "tile_iter_cycles", "tile_iter_class",
                  "tile_sel_cost")

#: The radio slots and row kinds the kernel hard-codes.
_KERNEL_CONSTANTS = dict(
    R_WAKEUP=0, R_CPB=1, R_HDR=2, R_CLASS=3, R_TOPK=4, R_CONF_HI=5,
    R_CONF_LO=6, R_PERIOD=7, R_DUTY=8, R_CLK=9, KIND_WORK=0, KIND_BURN=1,
    KIND_CALIB=2, KIND_SEND=3)


def _library():
    """Build (first use) and bind the kernel's C entry points."""
    from . import _build

    here = dict(R_WAKEUP=R_WAKEUP, R_CPB=R_CPB, R_HDR=R_HDR,
                R_CLASS=R_CLASS, R_TOPK=R_TOPK, R_CONF_HI=R_CONF_HI,
                R_CONF_LO=R_CONF_LO, R_PERIOD=R_PERIOD, R_DUTY=R_DUTY,
                R_CLK=R_CLK, KIND_WORK=KIND_WORK, KIND_BURN=KIND_BURN,
                KIND_CALIB=KIND_CALIB, KIND_SEND=KIND_SEND)
    if here != _KERNEL_CONSTANTS:
        raise RuntimeError("radio slots or row kinds moved; update "
                           "csrc/charge_replay.cu")
    lib = _build.load("charge_replay").lib
    if getattr(lib, "_bound", False):
        return lib
    lib.charge_replay_n_classes.restype = ctypes.c_int
    lib.charge_replay_n_classes.argtypes = []
    if lib.charge_replay_n_classes() != _N_CLASSES:
        raise RuntimeError("csrc/charge_replay.cu was built for another "
                           "number of op classes")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    common = ([p, ctypes.c_longlong, p, p]       # rows, lane stride, plan
              #                                    index, layout
              + [p, p, p, i, p, p, i, p, p]      # lane inputs and traces
              + [d, d, d, p, p]                  # theta, window, alpha, ...
              + [i] * 5                          # static flags
              + [p] * 11                         # outputs
              + [i])                             # n_lanes
    lib.charge_replay_launch.restype = i
    lib.charge_replay_launch.argtypes = common + [p]          # stream
    lib.charge_replay_hoisted_launch.restype = i
    lib.charge_replay_hoisted_launch.argtypes = (
        common + [i] * 4 + [p])      # variant, block, rs, cs, stream
    lib.charge_replay_f64_latency.restype = i
    lib.charge_replay_f64_latency.argtypes = [i, p, p, p]
    lib._bound = True
    return lib


#: The kernel's designs: ``"hoisted"`` (the default, the main path's) and
#: ``"direct"`` (the first design, kept to be timed beside it).
DESIGNS = ("hoisted", "direct")

#: The hoisted design's largest block (csrc/charge_replay.cu:
#: LANE_MAX_BLOCK): 255 registers a thread leave room for 256 threads an
#: SM.
LANE_MAX_BLOCK = 256


def lane_block(n_lanes: int) -> int:
    """Lanes a block of the hoisted design: the fewest that cover the card
    with one block an SM (a lane's events run in series, so a block an SM
    is all a launch can use), at most :data:`LANE_MAX_BLOCK`.  16,384
    lanes: 125 a block, 132 blocks."""
    return max(1, min(LANE_MAX_BLOCK, -(-n_lanes // SMS)))


def hoisted_table(packed, shared_rows):
    """The row table as the hoisted design reads it, with its strides:
    ``(table, lane_stride, rs, cs)``, element (i, j) of a lane's rows at
    ``table.view(-1)[base * lane_stride + i * rs + j * cs]``, where ``base``
    is the lane, or its plan index in ``"plan"`` mode.  The shared plan's
    ``(S, F)`` table goes column-major (rs = 1, cs = S): the lanes of a
    warp, a few rows apart, then read a column from a few cache lines.  A
    pack of candidate plans goes column-major plan by plan, ``(P, F, S)``.
    A lane's own ``(N, S, F)`` table stays row-major (rs = F, cs = 1)."""
    s_pad, f = packed.shape[-2:]
    mode = row_mode(shared_rows)
    if mode == "shared":
        return packed.T.contiguous(), 0, 1, s_pad
    if mode == "plan":
        return packed.transpose(1, 2).contiguous(), s_pad * f, 1, s_pad
    return packed, s_pad * f, f, 1


def kernel_variant(parametric: bool, has_send: bool) -> int:
    """The hoisted design's instantiation for these flags: ``parametric``
    and ``has_send`` are template parameters (``adaptive``,
    ``enable_fast`` and ``has_burn`` stay run-time arguments)."""
    return 2 * bool(parametric) + bool(has_send)


def f64_latency(device, n: int = 1 << 16) -> dict:
    """The dependent latency of f64 addition and multiplication on the
    card, from one thread running ``n`` of each in a chain: cycles per
    operation (``clock64``) and the SM clock over the run (cycles per
    ``%globaltimer`` nanosecond).  The second of two runs is kept."""
    lib = _library()
    out = torch.zeros(3, dtype=torch.int64, device=device)
    keep = torch.zeros(1, dtype=F64, device=device)
    for _ in range(2):
        err = lib.charge_replay_f64_latency(
            n, out.data_ptr(), keep.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"f64_latency_kernel launch failed: CUDA "
                               f"error {err}")
        torch.cuda.synchronize(device)
    add, mul, ns = (int(v) for v in out.cpu())
    return dict(add_cycles=add / n, mul_cycles=mul / n,
                sm_clock_ghz=(add + mul) / ns)


def _layout_ints(layout, f: int, g: int, k: int) -> list[int]:
    """The kernel's ``Layout``: field offsets (-1: absent), F, G, K and
    the op-class slots."""
    offs = {key: off for key, off, _shape in layout}
    return ([offs.get(name, -1) for name in _LAYOUT_FIELDS]
            + [f, g, k, _CONTROL_IDX, _BURN_IDX, _RADIO_IDX])


def _check_lane(name, t, n_lanes, dtype, device, ndim=1):
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim or t.shape[0] != n_lanes:
        raise ValueError(f"{name} must have {ndim} dims with {n_lanes} "
                         f"lanes first, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def charge_replay(rows, cap, rem0, trace_cum, tail_s, charge_cum,
                  nominal_from, s_real, theta, window, alpha, *,
                  adaptive: bool, parametric: bool, shared_rows,
                  enable_fast: bool = True, has_burn: bool = True,
                  has_send: bool = False, conf=None, radio=None,
                  chunk: int = EVENT_CHUNK, plan_idx=None,
                  design: str = "hoisted", host_checked: bool = False
                  ) -> dict:
    """The fused replay: the CUDA lane kernel for CUDA tensors, the plain
    PyTorch version (:func:`event_replay`) for CPU tensors.

    Arguments are :func:`event_replay`'s.  On the card the wrapper packs
    the row table (:func:`pack_rows`, unless ``rows`` is a
    :class:`PackedRows`), checks every input's device, dtype, shape and
    contiguity, allocates the 11 outputs, launches one thread per lane of
    kernel design ``design`` (:data:`DESIGNS`) on the current stream,
    raises if the launch failed, and counts the launch in
    ``charge_replay.launches``, ``launches_by_design`` and
    ``launches_by_mode`` (:data:`MODES`).  ``plan_idx`` must then be an
    int32 tensor on the device with every index in ``[0, P)``.  The checks
    of ``s_real``, ``plan_idx`` and the rows' op classes against the table
    read the tensors back, a wait on the card; ``host_checked=True`` says
    the caller has made them on the host before the upload (the streamed
    pipeline does, so its launches never wait).  ``chunk`` only paces the
    plain version."""
    if design not in DESIGNS:
        raise ValueError(f"no lane kernel design {design!r}; the designs "
                         f"are {DESIGNS}")
    if cap.device.type == "cpu":
        return event_replay(rows, cap, rem0, trace_cum, tail_s, charge_cum,
                            nominal_from, s_real, theta, window, alpha,
                            adaptive=adaptive, parametric=parametric,
                            shared_rows=shared_rows,
                            enable_fast=enable_fast, has_burn=has_burn,
                            has_send=has_send, conf=conf, radio=radio,
                            chunk=chunk, plan_idx=plan_idx)
    if cap.device.type != "cuda":
        raise ValueError(f"charge_replay runs on CUDA or CPU tensors, "
                         f"got {cap.device}")
    return _launch(rows, cap, rem0, trace_cum, tail_s, charge_cum,
                   nominal_from, s_real, theta, window, alpha,
                   adaptive=adaptive, parametric=parametric,
                   shared_rows=shared_rows, enable_fast=enable_fast,
                   has_burn=has_burn, has_send=has_send, conf=conf,
                   radio=radio, plan_idx=plan_idx, design=design,
                   host_checked=host_checked)


def _launch(rows, cap, rem0, trace_cum, tail_s, charge_cum, nominal_from,
            s_real, theta, window, alpha, *, adaptive, parametric,
            shared_rows, enable_fast, has_burn, has_send, conf, radio,
            design, plan_idx=None, host_checked=False):
    """The kernel half of :func:`charge_replay`: check, pack, allocate,
    launch and count, on the device of ``cap``."""
    device = cap.device
    n_lanes = cap.shape[0]
    mode = row_mode(shared_rows)
    if conf is None:
        conf = torch.zeros_like(cap)
    if radio is None:
        radio = torch.zeros(N_RADIO, dtype=F64, device=device)
    for name, t in (("cap", cap), ("rem0", rem0), ("tail_s", tail_s),
                    ("nominal_from", nominal_from), ("conf", conf)):
        _check_lane(name, t, n_lanes, F64, device)
    _check_lane("s_real", s_real, n_lanes, torch.int32, device)
    _check_lane("trace_cum", trace_cum, n_lanes, F64, device, ndim=2)
    _check_lane("charge_cum", charge_cum, n_lanes, F64, device, ndim=2)
    if (mode == "plan") != (plan_idx is not None):
        raise ValueError("plan_idx goes with shared_rows='plan', and only "
                         "with it")
    if plan_idx is not None:
        _check_lane("plan_idx", plan_idx, n_lanes, torch.int32, device)
    if radio.shape != (N_RADIO,) or radio.dtype != F64 \
            or radio.device != device or not radio.is_contiguous():
        raise ValueError(f"radio must be a contiguous ({N_RADIO},) float64 "
                         f"tensor on {device}")
    if trace_cum.shape[1] < 1 or charge_cum.shape[1] < 1:
        raise ValueError("trace tables need at least one column")
    if isinstance(rows, PackedRows):
        if rows.device != device:
            raise ValueError(f"rows are on {rows.device}, expected {device}")
    else:
        for k, v in rows.items():
            if v.device != device:
                raise ValueError(f"rows[{k!r}] is on {v.device}, "
                                 f"expected {device}")
        rows = PackedRows(rows, shared_rows)
    packed, layout = _packed(rows, shared_rows)
    shapes = {k: s for k, _off, s in layout}
    if shapes["entry_class"] != (_N_CLASSES,):
        raise ValueError(f"rows carry {shapes['entry_class']} op classes, "
                         f"the kernel {_N_CLASSES}")
    if parametric != ("tile_sel_cost" in shapes):
        raise ValueError("parametric must match the presence of tile tables")
    s_pad = packed.shape[-2]
    if mode == "lane" and packed.shape[0] != n_lanes:
        raise ValueError(f"per-lane rows hold {packed.shape[0]} lanes, "
                         f"expected {n_lanes}")
    g = shapes["entry_seg_cycles"][0]
    if not host_checked:
        if n_lanes and int(s_real.max()) > s_pad:
            raise ValueError(f"s_real exceeds the {s_pad}-row table")
        off = dict((k, o) for k, o, _s in layout)["entry_seg_class"]
        seg_cls = packed[..., off:off + g]
        if seg_cls.numel() and not (0 <= float(seg_cls.min())
                                    and float(seg_cls.max()) < _N_CLASSES):
            raise ValueError("entry_seg_class holds an op class out of "
                             "range")
        if plan_idx is not None and n_lanes and not (
                0 <= int(plan_idx.min())
                and int(plan_idx.max()) < packed.shape[0]):
            raise ValueError(f"plan_idx holds a plan out of "
                             f"[0, {packed.shape[0]})")
    k = shapes["tile_n"][0] if parametric else 0
    f = packed.shape[-1]
    layout_c = (ctypes.c_int * 21)(*_layout_ints(layout, f, g, k))
    if s_pad * f >= 2**31:
        raise ValueError("a lane's row table exceeds 2**31 elements")
    lane_stride = 0 if mode == "shared" else s_pad * f

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
    lib = _library()
    table = packed
    if design == "hoisted":
        if rows.hoisted is None:
            rows.hoisted = hoisted_table(packed, shared_rows)
        table, lane_stride, rs, cs = rows.hoisted
    args = (table.data_ptr(), lane_stride,
            None if plan_idx is None else plan_idx.data_ptr(), layout_c,
            cap.data_ptr(), rem0.data_ptr(), trace_cum.data_ptr(),
            trace_cum.shape[1], tail_s.data_ptr(), charge_cum.data_ptr(),
            charge_cum.shape[1], nominal_from.data_ptr(), s_real.data_ptr(),
            float(theta), float(window), float(alpha), conf.data_ptr(),
            radio.data_ptr(), int(adaptive), int(parametric),
            int(enable_fast), int(has_burn), int(has_send),
            *(out[name].data_ptr() for name in OUTPUTS), n_lanes)
    stream = torch.cuda.current_stream(device).cuda_stream
    if design == "hoisted":
        err = lib.charge_replay_hoisted_launch(
            *args, kernel_variant(parametric, has_send),
            lane_block(n_lanes), rs, cs, stream)
    else:
        err = lib.charge_replay_launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"charge_replay kernel ({design}) launch failed: "
                           f"CUDA error {err}")
    _wrapper.launches += 1
    _wrapper.launches_by_design[design] += 1
    _wrapper.launches_by_mode[mode] += 1
    # `table` may be freed now: PyTorch's caching allocator hands its
    # memory only to later work on the same stream, after the kernel.
    return out


#: ``charge_replay.launches`` counts launches of the CUDA kernel (calls that
#: take the plain version do not count), ``launches_by_design`` each
#: design's and ``launches_by_mode`` each row mode's (:data:`MODES`).  The
#: wrapper counts through this alias, so a caller that wraps
#: ``charge_replay`` still reads the counts off the original function.
_wrapper = charge_replay
charge_replay.launches = 0
charge_replay.launches_by_design = {d: 0 for d in DESIGNS}
charge_replay.launches_by_mode = {m: 0 for m in MODES}
