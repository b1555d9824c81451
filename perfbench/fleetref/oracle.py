"""The replay reference: a frozen copy of the pure-Python replay oracle.

Copied from ``tests/reference_replay.py`` at commit f60fe63 (the oracle the
repository's tests hold both packages' replays to), with its imports
replaced by the frozen constants of this package and the radio slots
inlined (``radio`` arrives packed), and otherwise kept line for line,
so that it stays comparable with the original: the radio and SEND rows'
branch and ``plan_net_work`` stay, though the cells of ``reduce="stats"``
mixes reach neither (an uplink cell would).  It replays one plan on one
lane, one charge at a time, in plain Python floats.  ``precision="float32"`` is the
benchmark's control: the same replay with the lane's state rounded to
float32 before every row.  The original's docstring follows.

Slow pure-Python reference interpreter for the fleet replay scan.

This is the *test oracle* for ``repro.core.fleetsim``: it replays one plan
on one lane, one charge at a time, in plain Python floats -- no JAX, no
closed forms, no vectorization -- implementing the documented semantics of
the scan directly:

* per-charge commit-granularity decision (``policy="adaptive"``/``theta``)
  with the cross-charge pending window (``batch_rows``) and multi-row
  rollback (torn pending work replayed as debt, one committed slice per
  charge),
* EWMA belief recalibration from observed charge lengths
  (``belief_alpha``),
* per-lane TAILS tile selection and calibration burns (parametric plans),
* trace-driven recharge dead time and stochastic per-charge capacities,
* charge-order attribution of torn entry burns via the row's
  charge-segment list.

The vectorized scan's charge-by-charge path must agree with this
interpreter *bit-identically* on every channel (live / reboots / per-class
/ wasted / stuck / belief / dead), and its deterministic closed form to
visit-collapse rounding -- ``tests/test_reference_replay.py`` asserts this
over hundreds of randomized (plan, trace, policy) configurations, which
subsumes the hand-pinned cv=0 equivalence cases.

Beyond mirroring the scan's outputs, the interpreter decomposes every live
cycle into ``useful + wasted_total + overhead`` (the ``failures.RunStats``
accounting, at device scale):

``useful``
    work that became durable exactly once: the completing entry of each
    row, committed iterations at their commit-free cost, committed
    rollback replay.
``wasted_total``
    everything executed more than once: re-paid entries, torn prefixes,
    uncommitted iterations, torn pending windows and their failed replays.
``overhead``
    the commit protocol and physics: cursor writes, chunk-boundary drains,
    calibration burns.

``wall == useful + wasted_total + overhead`` holds exactly at every step,
and a completed lane's ``useful`` equals the plan's net work
``sum(entry + n * (iter - commit))`` at the lane's selected tile,
independent of policy -- the property tests lean on both invariants.
"""

from __future__ import annotations

import math

import numpy as np

from .energy import OP_CLASSES
from .plan import KIND_BURN, KIND_CALIB, KIND_SEND, KIND_WORK
from .plan import K_TILES as _K_TILES

# the packed radio vector's slots (src/repro_torch/runtime/radio.py)
R_WAKEUP, R_CPB, R_HDR, R_CLASS, R_TOPK = 0, 1, 2, 3, 4
R_CONF_HI, R_CONF_LO, R_PERIOD, R_DUTY, R_CLK = 5, 6, 7, 8, 9

_C = len(OP_CLASSES)
_CONTROL = OP_CLASSES.index("control")
_BURN = OP_CLASSES.index("lea_mac")
_RADIO = OP_CLASSES.index("radio")


def trace_window(cum, r0, r1, fallback):
    """Windowed sum of a cumulative trace over (r0, r1] with per-entry
    fallback past the end -- the same gather/over arithmetic as the scan's
    ``trace_window`` so dead time matches to float identity."""
    if cum is None:
        return (r1 - r0) * fallback
    last = len(cum) - 1
    i0 = int(min(max(r0, 0.0), last))
    i1 = int(min(max(r1, 0.0), last))
    over = max(r1 - last, 0.0) - max(r0 - last, 0.0)
    return cum[i1] - cum[i0] + over * fallback


class _Lane:
    """Mutable per-lane interpreter state."""

    def __init__(self, cap, rem0):
        self.cap = cap
        self.rem = rem0            # actual remaining in current charge
        self.bel = rem0            # believed remaining
        self.live = 0.0
        self.reboots = 0.0
        self.dead = 0.0
        self.classes = np.zeros(_C)
        self.wasted = 0.0          # the scan's rollback-waste channel
        self.stuck = False
        self.pend = 0.0            # uncommitted deferred rows (cycles)
        self.pend_cls = np.zeros(_C)
        self.pend_rows = 0.0
        self.bhat = cap            # EWMA believed per-charge budget
        self.chg = 0.0             # spent in current charge (observation)
        self.tx = 0.0              # uplink bytes shipped
        self.sent = 0.0            # messages transmitted
        self.deferred = 0.0        # closed-window deferrals
        # decomposition channels (reference-only)
        self.useful = 0.0
        self.wasted_total = 0.0
        self.overhead = 0.0


def _narrow(s: _Lane) -> None:
    """The control's precision: every carried quantity of the lane rounded
    to float32 before each row, as a replay that kept its state in float32
    would hold it."""
    for k in ("rem", "bel", "live", "dead", "wasted", "pend", "bhat", "chg",
              "useful", "wasted_total", "overhead"):
        setattr(s, k, float(np.float32(getattr(s, k))))
    for k in ("classes", "pend_cls"):
        setattr(s, k, getattr(s, k).astype(np.float32).astype(np.float64))


def reference_replay(rows: dict, cap: float, rem0: float, *,
                     tail_s: float = 0.0,
                     recharge_cum: np.ndarray | None = None,
                     charge_cum: np.ndarray | None = None,
                     policy: str = "fixed", theta: float = 0.5,
                     batch_rows: int = 1,
                     belief_alpha: float = 0.0,
                     conf: float = 0.0, radio=None,
                     precision: str = "float64") -> dict:
    """Interpret one plan (``fleetsim._plan_rows`` dict) on one lane.

    ``recharge_cum``/``charge_cum`` are this lane's 1-D cumulative trace
    tables (``recharge_trace_cumulative``/``charge_trace_cumulative`` rows)
    or ``None`` for closed-form dead time / all-nominal charges.

    ``radio`` (packed vector or ``(RadioModel, SendPolicy)``) enables the
    uplink decision on ``KIND_SEND`` rows: ``conf`` is this lane's
    classifier confidence, thresholded into ship-class / ship-topk / skip;
    the send cost runs through the *same* atomic charge loop as a WORK
    entry (a torn send rolls back and retries the full preamble), a send
    waking into a closed basestation window first sleeps until the next
    window opens (dead time, counted in ``msgs_deferred``), and completed
    transmissions accumulate ``tx_bytes`` / ``msgs_sent``.
    """
    radio = None if radio is None else np.asarray(radio, np.float64)
    conf = float(conf)
    adaptive = policy == "adaptive"
    parametric = "tile_sel_cost" in rows
    window = float(batch_rows)
    alpha = float(belief_alpha)
    theta = float(theta)
    # Mirror _run_replay: on the charge-wise (stochastic) path the initial
    # charge is floored to whole cycles so every energy accumulator stays
    # integral (the fused fast path depends on grouping-independent
    # integer arithmetic).  The deterministic closed form keeps the
    # caller's fractional charge.
    stochastic = charge_cum is not None or (adaptive and batch_rows > 1)
    if stochastic and not np.isinf(rem0):
        rem0 = float(np.floor(rem0))
    s = _Lane(float(cap), float(rem0))
    n_rows = len(rows["kind"])

    def refill(r):
        if charge_cum is None:
            return s.cap
        return trace_window(charge_cum, r, r + 1.0, s.cap)

    narrow = precision == "float32"
    for i in range(n_rows):
        if narrow:
            _narrow(s)
        kind = int(rows["kind"][i])
        r0 = s.reboots

        # -- decision 1: TAILS tile from the carried capacitor ------------
        if parametric:
            sel = rows["tile_sel_cost"][i]
            k = int(np.clip(np.sum(sel > s.cap), 0, _K_TILES - 1))
            if int(rows["tile_flag"][i]) > 0:
                n = float(rows["tile_n"][i][k])
                c = float(rows["tile_iter_cycles"][i][k])
                iter_class = rows["tile_iter_class"][i][k]
            else:
                n = float(rows["n"][i])
                c = float(rows["iter_cycles"][i])
                iter_class = rows["iter_class"][i]
        else:
            k = 0
            n = float(rows["n"][i])
            c = float(rows["iter_cycles"][i])
            iter_class = rows["iter_class"][i]
        e = float(rows["entry_cycles"][i])
        entry_class = rows["entry_class"][i]
        cc = float(rows["commit_cycles"][i])
        commit_class = rows["commit_class"][i]
        seg_cls = rows["entry_seg_class"][i]
        seg_cyc = rows["entry_seg_cycles"][i]

        # -- decision 5: send / compress / skip (uplink rows) -------------
        is_send = kind == KIND_SEND and radio is not None
        send_b = 0.0
        if is_send:
            if conf >= radio[R_CONF_HI]:
                send_b = float(radio[R_HDR] + radio[R_CLASS])
            elif conf >= radio[R_CONF_LO]:
                send_b = float(radio[R_HDR] + radio[R_TOPK])
            cost = (float(radio[R_WAKEUP] + send_b * radio[R_CPB])
                    if send_b > 0.0 else 0.0)
            e = cost
            entry_class = np.zeros(_C)
            entry_class[_RADIO] = cost
            seg_cyc = np.zeros(len(seg_cyc))
            seg_cyc[0] = cost
        has_iters = n > 0

        def torn_prefix(p):
            out = np.zeros(_C)
            start = 0.0
            for g in range(len(seg_cyc)):
                amt = min(max(p - start, 0.0), seg_cyc[g])
                out[int(seg_cls[g])] += amt
                start = start + seg_cyc[g]
            return out

        if kind == KIND_BURN:
            s.live += s.rem
            s.classes[_BURN] += s.rem
            s.overhead += s.rem
            s.reboots += 1.0
            s.rem = refill(r0)
            s.bel = s.bhat
            s.chg = 0.0
            s.dead += trace_window(recharge_cum, r0, s.reboots, tail_s)
            continue
        if kind == KIND_CALIB:
            burns = float(k)
            if burns > 0:
                burned = s.rem + trace_window(
                    charge_cum, s.reboots, s.reboots + burns - 1.0, s.cap) \
                    if charge_cum is not None else \
                    s.rem + (burns - 1.0) * s.cap
                s.live += burned
                s.classes[_BURN] += burned
                s.overhead += burned
                s.rem = refill(s.reboots + burns - 1.0)
                s.bel = s.bhat
                s.chg = 0.0
                s.reboots += burns
            s.dead += trace_window(recharge_cum, r0, s.reboots, tail_s)
            continue
        if kind == KIND_SEND and radio is None:
            # ``has_send=False`` replays treat SEND rows as inert
            # passthrough (the scan skips them entirely).
            continue

        # nominal passability (the scalar simulator's atomic-region bound,
        # on the selected tile, with retry-batched costs)
        if adaptive and has_iters and cc > 0.0 and theta <= 1.0:
            er, cr = e + cc, c - cc
        else:
            er, cr = e, c
        crs = max(cr, 1e-30)
        if has_iters:
            row_stuck = math.floor((s.cap - er) / crs) < 1.0
        else:
            row_stuck = e > s.cap
        if math.isinf(s.cap):
            row_stuck = False

        # Duty-cycled basestation window, checked once on fresh entry to
        # the row: waking into a closed window sleeps (dead time, no
        # energy) until the next window opens.  A post-tear retry
        # transmits as soon as it is recharged (documented
        # simplification, mirrored by the scan's fresh-only gate).
        send_wait = 0.0
        if is_send and send_b > 0.0 and not row_stuck:
            period = float(radio[R_PERIOD])
            # R_CLK and fabs mirror the anti-FMA-contraction shape of
            # kernels.charge_replay.send_defer_wait (value identities here).
            t = s.live / float(radio[R_CLK]) + s.dead
            ps = max(period, 1e-30)
            phase = t - math.fabs(math.floor(t / ps) * ps)
            if period > 0.0 and phase >= float(radio[R_DUTY]) * period:
                send_wait = period - phase
                s.deferred += 1.0

        # The charge loop below mirrors the scan's ``charge_body`` term by
        # term, *including the float summation grouping* (contributions
        # are composed first, then added to the accumulators once), so
        # every channel matches the compiled scan to the last bit.
        left = n
        debt = 0.0
        debt_cls = np.zeros(_C)
        done = False
        while not done:
            a0, est0 = s.rem, s.bel

            # ---- phase 0: replay torn pending work (debt) ---------------
            have_debt = debt > 0.0
            debt_s = max(debt, 1e-30)
            want = min(debt, max(est0 - cc, 0.0)) if have_debt else 0.0
            dok = have_debt and want > 0.0 and a0 >= want + cc
            dfail = have_debt and not dok
            # a *partial* repay leaves the cursor still inside the rolled-
            # back rows: the rest of the charge drains, the next charge
            # keeps repaying, and the row phase never runs (dend).
            dpart = dok and (debt - want) > 0.0
            dend = dfail or dpart
            d_spend = want + cc if dok else 0.0
            if dok:
                d_cls = debt_cls * (want / debt_s) + commit_class
                debt_cls = debt_cls * ((debt - want) / debt_s)
                debt = debt - want
                s.useful += want
                s.overhead += cc
                # a cursor write covers the pending window too
                s.pend, s.pend_rows = 0.0, 0.0
                s.pend_cls = np.zeros(_C)
            else:
                d_cls = np.zeros(_C)
            a1 = a0 - d_spend
            est1 = max(est0 - d_spend, 0.0)

            if dend:
                if dfail:
                    d_exec = min(want, a0)
                    dend_cls = debt_cls * (d_exec / debt_s)
                    dend_cls[_CONTROL] += a0 - d_exec
                    s.wasted = s.wasted + d_exec
                    s.wasted_total += d_exec
                    s.overhead += a0 - d_exec
                else:
                    dend_cls = d_cls.copy()
                    dend_cls[_CONTROL] += a1
                    s.overhead += a1
                s.live = s.live + a0
                s.classes = s.classes + dend_cls
                obs = s.chg + a0
                if alpha > 0.0 and s.reboots > 0.0:
                    s.bhat = max(np.rint(s.bhat + alpha * (obs - s.bhat)),
                                 1.0)
                s.bel = s.bhat
                s.reboots = s.reboots + 1.0
                s.rem = refill(s.reboots - 1.0)
                s.chg = 0.0
                if row_stuck:
                    s.stuck = True
                    done = True
                continue

            # ---- batch / defer decision for this charge -----------------
            batch = (adaptive and has_iters and cc > 0.0
                     and (math.isinf(s.cap) or est1 >= theta * s.bhat))
            defer = batch and (s.pend_rows + 1.0) < window
            e_b = e + cc if batch else e
            c_b = c - cc if batch else c
            c_bs = max(c_b, 1e-30)
            iv = iter_class - commit_class if batch else iter_class

            entered = a1 >= e
            k_est = min(max(math.floor((est1 - e_b) / c_bs), 0.0)
                        if est1 >= e_b else 0.0, left)
            fin_cost = e + left * c_b + (cc if batch and not defer else 0.0)
            plan_fin = est1 >= fin_cost
            sched_i = left if (batch and plan_fin) else k_est
            k_exec = min(max(math.floor((a1 - e) / c_bs), 0.0)
                         if entered else 0.0,
                         sched_i if batch else left)
            k_act = min(max(math.floor((a1 - e_b) / c_bs), 0.0)
                        if entered else 0.0, left)
            fin = (plan_fin and a1 >= fin_cost) if batch \
                else a1 >= e + left * c_b

            if fin:
                spend = fin_cost
                cls_fin = entry_class + left * iv \
                    + (1.0 if batch and not defer else 0.0) * commit_class
                s.live = s.live + (d_spend + spend)
                s.classes = s.classes + (d_cls + cls_fin)
                s.chg = s.chg + d_spend + spend
                fin_u = e + left * c_b if batch \
                    else e + left * (c - cc)
                if is_send:
                    # A completed transmission is radio overhead, not
                    # net inference work: plan_net_work skips SEND rows.
                    s.overhead += fin_u
                else:
                    s.useful += fin_u
                if batch and not defer:
                    s.overhead += cc
                if not batch:
                    s.overhead += left * cc
                if defer:
                    s.pend = s.pend + spend
                    s.pend_cls = s.pend_cls + entry_class + left * iv
                    s.pend_rows = s.pend_rows + 1.0
                else:
                    s.pend, s.pend_rows = 0.0, 0.0
                    s.pend_cls = np.zeros(_C)
                s.rem = a1 - spend
                s.bel = max(est1 - spend, 0.0)
                left = 0.0
                done = True
                continue

            # ---- death paths (the whole remaining charge burns) ---------
            if batch:
                boundary = (not plan_fin) and k_est == 0.0 \
                    and s.pend_rows > 0.0
                sched_commit = (not defer) if plan_fin else \
                    (k_est > 0.0 or s.pend_rows > 0.0)
                commit_ok = (a1 >= cc) if boundary else \
                    (a1 >= e_b + sched_i * c_b)
                land = (not plan_fin) and sched_commit and commit_ok
                exec_iters = sched_i if (land and not boundary) else k_exec
                prog = sched_i if (land and not boundary) else 0.0
                commit_n = 1.0 if land else 0.0
            else:
                boundary = False
                land = k_act > 0.0     # per-iteration commits landed
                exec_iters = k_act
                prog = k_act
                commit_n = 0.0
            if boundary:
                p_entry = (a1 - cc) if (batch and land) else -1.0
            else:
                p_entry = a1
            entered_d = p_entry >= e
            entry_burn = e if entered_d else min(max(p_entry, 0.0), e)
            torn_v = np.zeros(_C) if entered_d else torn_prefix(p_entry)
            entry_v = entry_class if entered_d else np.zeros(_C)
            cls_burn = entry_v + torn_v + exec_iters * iv \
                + commit_n * commit_class
            residue = a1 - entry_burn - exec_iters * c_b - commit_n * cc
            cls_death = cls_burn.copy()
            cls_death[_CONTROL] += residue
            s.live = s.live + (d_spend + a1)
            s.classes = s.classes + (d_cls + cls_death)
            s.overhead += residue + commit_n * cc
            if batch and land and not boundary:
                s.useful += exec_iters * c_b
                s.wasted_total += entry_burn
            elif batch:
                s.wasted_total += entry_burn + exec_iters * c_b
            else:
                s.useful += k_act * (c - cc)
                s.overhead += k_act * cc
                s.wasted_total += entry_burn
            left = left - prog

            # pending window: any durable cursor write covers it, a death
            # without one tears it into replay debt (multi-row rollback)
            tear = (not land) and s.pend > 0.0
            waste_add = ((k_exec * c_b if batch and not land else 0.0)
                         + (s.pend if tear else 0.0))
            s.wasted = s.wasted + waste_add
            if tear:
                s.wasted_total += s.pend
                s.useful -= s.pend
                debt = debt + s.pend
                debt_cls = debt_cls + s.pend_cls
            s.pend, s.pend_rows = 0.0, 0.0
            s.pend_cls = np.zeros(_C)

            obs = s.chg + a0
            if alpha > 0.0 and s.reboots > 0.0:
                s.bhat = max(np.rint(s.bhat + alpha * (obs - s.bhat)), 1.0)
            s.bel = s.bhat
            s.reboots = s.reboots + 1.0
            s.rem = refill(s.reboots - 1.0)
            s.chg = 0.0
            if row_stuck:
                s.stuck = True
                done = True

        s.dead = (s.dead + send_wait) + trace_window(recharge_cum, r0,
                                                     s.reboots, tail_s)
        if is_send and not row_stuck:
            s.tx += send_b
            if send_b > 0.0:
                s.sent += 1.0

    if narrow:
        _narrow(s)
    return dict(live=s.live, reboots=s.reboots, dead=s.dead,
                classes=s.classes, wasted=s.wasted, stuck=s.stuck,
                belief=s.bhat, useful=s.useful,
                wasted_total=s.wasted_total, overhead=s.overhead,
                tx_bytes=s.tx, msgs_sent=s.sent,
                msgs_deferred=s.deferred, wall_cycles=s.live)


def plan_net_work(rows: dict, cap: float) -> float:
    """The plan's net useful work at the lane's selected tile:
    ``sum(entry + n * (iter - commit))`` over WORK rows -- what a completed
    lane's ``useful`` channel must equal under *any* commit policy."""
    parametric = "tile_sel_cost" in rows
    total = 0.0
    for i in range(len(rows["kind"])):
        if int(rows["kind"][i]) != KIND_WORK:
            continue
        if parametric and int(rows["tile_flag"][i]) > 0:
            sel = rows["tile_sel_cost"][i]
            k = int(np.clip(np.sum(sel > cap), 0, _K_TILES - 1))
            n = float(rows["tile_n"][i][k])
            c = float(rows["tile_iter_cycles"][i][k])
        else:
            n = float(rows["n"][i])
            c = float(rows["iter_cycles"][i])
        total += float(rows["entry_cycles"][i]) \
            + n * (c - float(rows["commit_cycles"][i]))
    return total
