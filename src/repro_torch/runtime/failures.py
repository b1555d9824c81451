"""Fleet intermittence model: node failures as the datacenter power trace.

Reproduces the paper's Fig. 6/9 trade-off at cluster scale:

  naive        -- no checkpoints: any failure restarts the whole job
                  (non-termination when MTBF < job length, exactly the
                  paper's naive baseline).
  interval-k   -- checkpoint every k steps (the Tile-k analogue): small k
                  pays checkpoint overhead, large k re-executes up to k
                  steps per failure and risks never finishing a window.
  continuation -- full checkpoint every k steps PLUS a per-microbatch
                  cursor + in-step re-execution idempotence (SONIC): after
                  a failure only the interrupted microbatch re-runs, at the
                  cost of one tiny cursor commit per microbatch.

The simulator is deterministic given a seed; times are in abstract seconds.
At fleet scale the failure rate is n_hosts/MTBF_host -- at 1000+ nodes with
a 30-day host MTBF that is one failure every ~43 minutes, which is why
fine-grained resumability matters.

The harvest-trace samplers below (the legacy sequential draws, the
chunk-invariant Philox ``*_stream`` draws, the cumulative trace tables the
fleet replay indexes and the trace-shape helpers) give the same arrays as
the JAX package's for the same seed, so the two replays can be held
against each other.  Numpy only, no framework.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .spans import traced

#: The samplers' spans: host work that launches nothing on the card.
_sampler = traced("samplers", host_only=True)


@dataclass(frozen=True)
class FleetSpec:
    n_hosts: int
    mtbf_host_s: float           # per-host mean time between failures
    restart_s: float = 120.0     # reboot + rejoin + JIT warmup

    @property
    def failure_rate(self) -> float:
        return self.n_hosts / self.mtbf_host_s


@dataclass(frozen=True)
class JobSpec:
    total_steps: int
    step_s: float
    microbatches: int = 8        # per step (grad accumulation loop)
    ckpt_write_s: float = 30.0   # full checkpoint wall time
    #: per-microbatch durable commit: cursor write + grad-accumulator flush
    #: to local NVMe (the A/B-buffered "FRAM write" of the fleet analogue)
    mb_commit_s: float = 0.3
    restore_s: float = 60.0      # checkpoint read + reshard


@dataclass
class RunStats:
    wall_s: float
    useful_s: float
    wasted_s: float              # re-executed compute
    overhead_s: float            # checkpoints + cursors + restarts
    failures: int
    completed: bool

    @property
    def goodput(self) -> float:
        return self.useful_s / self.wall_s if self.wall_s else 0.0


def _failure_times(spec: FleetSpec, horizon_s: float, seed: int):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    while t < horizon_s:
        t += rng.exponential(1.0 / spec.failure_rate)
        out.append(t)
    return out


# --------------------------------------------------------------------------
# Harvest-trace distributions (device-fleet analogue of the failure trace)
# --------------------------------------------------------------------------
# The same intermittence model at the other end of the scale: instead of a
# datacenter host dying, an energy-harvesting device's capacitor drains.
# These distributions parameterize the vectorized device simulator
# (``repro.core.fleetsim.fleet_sweep``): per-device harvest rates vary with
# antenna distance/orientation, and a device joins the fleet at an arbitrary
# point of its charge cycle.

@_sampler
def harvest_jitter(n_devices: int, seed: int = 0,
                   cv: float = 0.25) -> np.ndarray:
    """Per-device recharge-time multipliers: lognormal with mean 1 and
    coefficient of variation ``cv`` (RF harvest power spread)."""
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(np.log1p(cv * cv))
    return rng.lognormal(mean=-sigma * sigma / 2, sigma=sigma,
                         size=n_devices)


@_sampler
def initial_charge_fraction(n_devices: int, seed: int = 0) -> np.ndarray:
    """Buffer fill level at which each device wakes, uniform over the charge
    cycle (devices are not phase-aligned)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.05, 1.0, size=n_devices)


@_sampler
def reboot_recharge_times(n_devices: int, n_reboots: int,
                          mean_recharge_s: float, seed: int = 0) -> np.ndarray:
    """Exponential per-reboot recharge times, shape ``(n_devices,
    n_reboots)`` -- the device-level analogue of :func:`_failure_times` for
    trace-replay experiments that need full dead-time traces rather than
    per-device means."""
    rng = np.random.default_rng(seed)
    return rng.exponential(mean_recharge_s, size=(n_devices, n_reboots))


@_sampler
def recharge_trace_cumulative(traces: np.ndarray) -> np.ndarray:
    """Prefix-sum a ``(devices, reboots)`` recharge-trace matrix into the
    ``(devices, reboots + 1)`` float64 table the vectorized replay indexes
    by each lane's running reboot counter (``repro.core.fleetsim``).

    ``out[d, r]`` is device ``d``'s total dead time over its first ``r``
    reboots, so the dead time of reboots ``[r0, r1)`` is one gather and a
    subtraction inside the scan.  ``out[:, 0] == 0`` always.
    """
    traces = np.asarray(traces, np.float64)
    if traces.ndim != 2:
        raise ValueError(
            f"recharge trace must be (devices, reboots), got {traces.shape}")
    out = np.zeros((traces.shape[0], traces.shape[1] + 1), np.float64)
    np.cumsum(traces, axis=1, out=out[:, 1:])
    return out


@_sampler
def charge_capacity_jitter(n_devices: int, n_charges: int, nominal_cycles,
                           seed: int = 0, cv: float = 0.25,
                           bias_cv: float = 0.0,
                           lo: float = 0.25, hi: float = 4.0) -> np.ndarray:
    """Stochastic per-charge capacities: a ``(devices, charges)`` matrix of
    whole-cycle energy budgets, each a truncated-lognormal multiple of the
    capacitor's nominal ``cycles_per_charge``.

    This is the *surprise-failure* model the energy-adaptive commit policy
    must pay for (Islam et al. 2025): the device believes every fresh charge
    delivers the nominal budget, but charge ``r`` actually delivers
    ``trace[d, r]`` cycles -- load spikes, temperature, and converter
    efficiency make the usable energy of a "full" capacitor jitter.
    Multipliers are lognormal with mean 1 and coefficient of variation
    ``cv``, clipped to ``[lo, hi]`` (a dead-short or a super-charge are
    physically bounded), and capacities are rounded to whole cycles so the
    replay's integer-exact energy accounting is preserved.  ``cv=0`` (or a
    trace filled with the nominal capacity) reduces the stochastic replay
    bit-exactly to the deterministic closed form.

    ``bias_cv > 0`` adds a *persistent* per-device multiplier (lognormal,
    mean 1, coefficient of variation ``bias_cv``, one draw per device
    applied to all of its charges): a lane parked in a poor RF spot keeps
    drawing short charges while the fleet-nominal belief says otherwise.
    This is the regime EWMA belief recalibration
    (``fleetsim ... belief_alpha``) exists for -- per-charge iid jitter
    averages out to the nominal, a persistent bias does not.  The combined
    multiplier is clipped to ``[lo, hi]``.

    ``nominal_cycles`` may be a scalar (one capacitor fleet-wide) or a
    ``(devices,)`` vector (e.g. ``capacitor_sweep`` lanes).
    """
    if cv < 0:
        raise ValueError(f"cv must be >= 0, got {cv}")
    if bias_cv < 0:
        raise ValueError(f"bias_cv must be >= 0, got {bias_cv}")
    if not 0 < lo <= 1.0 <= hi:
        raise ValueError(f"need 0 < lo <= 1 <= hi, got lo={lo} hi={hi}")
    nominal = np.broadcast_to(
        np.asarray(nominal_cycles, np.float64).reshape(-1, 1),
        (n_devices, n_charges))
    if cv == 0 and bias_cv == 0:
        mult = np.ones((n_devices, n_charges))
    else:
        rng = np.random.default_rng(seed)
        if cv > 0:
            sigma = np.sqrt(np.log1p(cv * cv))
            mult = rng.lognormal(mean=-sigma * sigma / 2, sigma=sigma,
                                 size=(n_devices, n_charges))
        else:
            mult = np.ones((n_devices, n_charges))
        if bias_cv > 0:
            bsig = np.sqrt(np.log1p(bias_cv * bias_cv))
            bias = rng.lognormal(mean=-bsig * bsig / 2, sigma=bsig,
                                 size=n_devices)
            mult = mult * bias[:, None]
        mult = np.clip(mult, lo, hi)
    return np.maximum(np.rint(nominal * mult), 1.0)


@_sampler
def charge_trace_cumulative(traces: np.ndarray) -> np.ndarray:
    """Prefix-sum a ``(devices, charges)`` capacity trace into the
    ``(devices, charges + 1)`` table the stochastic replay indexes by each
    lane's running reboot counter (refill ``r``'s capacity is
    ``out[d, r] - out[d, r - 1]``; reboots past the trace fall back to the
    nominal capacity).  Same table layout as
    :func:`recharge_trace_cumulative` (which does it for per-reboot dead
    *time*), and deliberately the same implementation."""
    traces = np.asarray(traces, np.float64)
    if traces.ndim != 2:
        raise ValueError(
            f"charge trace must be (devices, charges), got {traces.shape}")
    return recharge_trace_cumulative(traces)


@_sampler
def charge_trace_nominal_from(charge_cum, caps) -> np.ndarray:
    """First trace index from which *every* subsequent charge delivers the
    nominal capacity, per lane: ``(devices,)`` float64.

    The fused replay (``repro.kernels.charge_replay``) switches a lane from
    charge-by-charge replay to the closed-form fast path once its reboot
    counter reaches this index -- from there on, refills inside the trace
    equal the nominal and refills past the trace fall back to it, so the
    deterministic algebra is exact.  Computed as the length of the trace's
    trailing all-nominal run.  Continuous (infinite-capacity) lanes compare
    unequal everywhere (``inf - inf`` is NaN), yielding the full trace
    length: they simply stay on the charge-wise path, which completes each
    of their rows in one event anyway.
    """
    cum = np.asarray(charge_cum, np.float64)
    caps = np.broadcast_to(np.asarray(caps, np.float64), (cum.shape[0],))
    deliv = cum[:, 1:] - cum[:, :-1]
    with np.errstate(invalid="ignore"):
        eq = deliv == caps[:, None]
    run = np.cumprod(eq[:, ::-1].astype(np.int64), axis=1).sum(axis=1)
    return (deliv.shape[1] - run).astype(np.float64)


@_sampler
def pad_charge_trace_columns(charge_cum: np.ndarray, caps,
                             min_cols: int = 8) -> np.ndarray:
    """Pad a cumulative charge-capacity table's column axis to the next
    power of two (at least ``min_cols``) by extending it with nominal
    charges: ``out[:, R + k] = out[:, R] + k * cap``.

    Shape-bucketing the trace axis lets sweeps with different trace
    lengths share one compiled replay.  The extension is *bitwise*
    transparent: capacities are whole cycles (integers exact in float64),
    so the windowed gather-subtract over the padded tail equals the
    ``overrun * nominal`` fallback term it replaces exactly.  (Dead-time
    traces are fractional seconds and must never be padded this way.)
    """
    cum = np.asarray(charge_cum, np.float64)
    cols = cum.shape[1]
    target = max(min_cols, 1 << max(cols - 1, 0).bit_length())
    if target == cols:
        return cum
    caps = np.broadcast_to(np.asarray(caps, np.float64),
                           (cum.shape[0],))
    k = np.arange(1, target - cols + 1, dtype=np.float64)
    ext = cum[:, -1:] + caps[:, None] * k[None, :]
    return np.concatenate([cum, ext], axis=1)


# --------------------------------------------------------------------------
# Lane-indexed streamed samplers (chunk-invariant counter-based RNG)
# --------------------------------------------------------------------------
# The legacy samplers above draw one sequential stream over the whole fleet,
# so a sweep that generates its inputs chunk-by-chunk (``fleet_sweep(...,
# lane_chunk=...)`` -- the memory-flat path) could never reproduce them: the
# draws for lane ``i`` would depend on where the chunk boundaries fell.
# These ``*_stream`` variants use a counter-based generator (Philox) keyed
# on ``(seed, stream)`` and *advanced* to ``lane_lo * draws_per_lane``, with
# a fixed number of draws per lane, so the values for any lane range are a
# pure function of ``(seed, lane index)`` -- generating lanes [0, 1e7) in
# one call or in 77 chunks yields bit-identical arrays, and peak host
# memory is the chunk, not the fleet.  Distributions match the legacy
# samplers (lognormal via Box-Muller, exponential via inverse CDF) but the
# draw streams are distinct, so seeds are not interchangeable across the
# two families.

_FRAC_STREAM, _HARVEST_STREAM, _RECHARGE_STREAM, _CHARGE_STREAM = 0, 1, 2, 3
_CONF_STREAM = 4


def _stream_uniforms(n_lanes: int, draws_per_lane: int, seed: int,
                     stream: int, lane_lo: int) -> np.ndarray:
    """``(n_lanes, draws_per_lane)`` doubles in [0, 1): draws
    ``[lane_lo * k, (lane_lo + n_lanes) * k)`` of the counter-based stream
    ``(seed, stream)`` -- lane ``i`` always sees the same ``k`` draws no
    matter how the fleet is chunked."""
    if seed < 0 or stream < 0 or lane_lo < 0:
        raise ValueError("seed, stream and lane_lo must be >= 0")
    # Philox.advance() moves whole 128-bit counter blocks (4 uint64 draws
    # = 4 doubles), so each lane's slot is padded to a multiple of 4 draws
    # to keep every lane boundary block-aligned.
    slot = -(-int(draws_per_lane) // 4) * 4
    bg = np.random.Philox(key=np.array([seed, stream], np.uint64))
    bg.advance(int(lane_lo) * slot // 4)
    u = np.random.Generator(bg).random(n_lanes * slot)
    return u.reshape(n_lanes, slot)[:, :draws_per_lane]


def _stream_normals(n_lanes: int, per_lane: int, seed: int, stream: int,
                    lane_lo: int) -> np.ndarray:
    """``(n_lanes, per_lane)`` standard normals via Box-Muller (two
    uniforms per normal, so 2 * per_lane draws per lane)."""
    u = _stream_uniforms(n_lanes, 2 * per_lane, seed, stream, lane_lo)
    u1, u2 = u[:, :per_lane], u[:, per_lane:]
    return np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)


@_sampler
def initial_charge_fraction_stream(n_devices: int, seed: int = 0,
                                   lane_lo: int = 0) -> np.ndarray:
    """Chunk-invariant :func:`initial_charge_fraction`: uniform [0.05, 1)
    wake fill levels for lanes ``[lane_lo, lane_lo + n_devices)``."""
    u = _stream_uniforms(n_devices, 1, seed, _FRAC_STREAM, lane_lo)
    return 0.05 + 0.95 * u[:, 0]


@_sampler
def harvest_jitter_stream(n_devices: int, seed: int = 0, cv: float = 0.25,
                          lane_lo: int = 0) -> np.ndarray:
    """Chunk-invariant :func:`harvest_jitter`: mean-1 lognormal recharge
    multipliers with coefficient of variation ``cv`` (2 draws/lane)."""
    z = _stream_normals(n_devices, 1, seed, _HARVEST_STREAM, lane_lo)[:, 0]
    sigma = np.sqrt(np.log1p(cv * cv))
    return np.exp(-sigma * sigma / 2 + sigma * z)


@_sampler
def reboot_recharge_times_stream(n_devices: int, n_reboots: int,
                                 mean_recharge_s, seed: int = 0,
                                 lane_lo: int = 0) -> np.ndarray:
    """Chunk-invariant :func:`reboot_recharge_times`: exponential
    per-reboot recharge times, ``n_reboots`` draws per lane.

    ``mean_recharge_s`` may be a scalar (one power system fleet-wide) or a
    ``(devices,)`` vector holding this lane range's per-lane means (e.g.
    ``replay_plans``' one-lane-per-plan layout, or a ``PlanSet`` design
    sweep where each candidate plan carries its own capacitor).  The
    underlying uniform draws depend only on ``(seed, lane index)``, so the
    mean scales the same stream -- lane draws are invariant under both
    chunking and the per-lane mean."""
    u = _stream_uniforms(n_devices, n_reboots, seed, _RECHARGE_STREAM,
                         lane_lo)
    mean = np.asarray(mean_recharge_s, np.float64)
    if mean.ndim == 1:
        mean = mean[:, None]
    return -mean * np.log1p(-u)


@_sampler
def charge_capacity_jitter_stream(n_devices: int, n_charges: int,
                                  nominal_cycles, seed: int = 0,
                                  cv: float = 0.25, bias_cv: float = 0.0,
                                  lane_lo: int = 0, lo: float = 0.25,
                                  hi: float = 4.0) -> np.ndarray:
    """Chunk-invariant :func:`charge_capacity_jitter`: truncated-lognormal
    per-charge capacity multiples (plus the optional persistent per-device
    bias), ``2 * (n_charges + 1)`` draws per lane regardless of ``cv`` so
    lane alignment never depends on the distribution parameters.
    ``nominal_cycles`` may be a scalar or a ``(devices,)`` vector holding
    this lane range's nominals."""
    if cv < 0:
        raise ValueError(f"cv must be >= 0, got {cv}")
    if bias_cv < 0:
        raise ValueError(f"bias_cv must be >= 0, got {bias_cv}")
    if not 0 < lo <= 1.0 <= hi:
        raise ValueError(f"need 0 < lo <= 1 <= hi, got lo={lo} hi={hi}")
    z = _stream_normals(n_devices, n_charges + 1, seed, _CHARGE_STREAM,
                        lane_lo)
    nominal = np.broadcast_to(
        np.asarray(nominal_cycles, np.float64).reshape(-1, 1),
        (n_devices, n_charges))
    if cv == 0 and bias_cv == 0:
        mult = np.ones((n_devices, n_charges))
    else:
        if cv > 0:
            sigma = np.sqrt(np.log1p(cv * cv))
            mult = np.exp(-sigma * sigma / 2 + sigma * z[:, :n_charges])
        else:
            mult = np.ones((n_devices, n_charges))
        if bias_cv > 0:
            bsig = np.sqrt(np.log1p(bias_cv * bias_cv))
            bias = np.exp(-bsig * bsig / 2 + bsig * z[:, n_charges])
            mult = mult * bias[:, None]
        mult = np.clip(mult, lo, hi)
    return np.maximum(np.rint(nominal * mult), 1.0)


@_sampler
def inference_confidence(n_devices: int, seed: int = 0) -> np.ndarray:
    """Per-device classifier confidence for the uplink send decision,
    uniform [0, 1): the top-softmax score each device observes for the
    inference its plan completes.  The radio row (``runtime.radio``)
    thresholds this against the send policy to pick ship-class /
    ship-top-k / ship-nothing.  Legacy sequential sampler; sweeps that
    stream the lane axis use :func:`inference_confidence_stream`."""
    rng = np.random.default_rng(seed)
    return rng.random(n_devices)


@_sampler
def inference_confidence_stream(n_devices: int, seed: int = 0,
                                lane_lo: int = 0) -> np.ndarray:
    """Chunk-invariant :func:`inference_confidence`: uniform [0, 1)
    confidences for lanes ``[lane_lo, lane_lo + n_devices)``
    (1 draw/lane)."""
    return _stream_uniforms(n_devices, 1, seed, _CONF_STREAM, lane_lo)[:, 0]


def simulate(policy: str, fleet: FleetSpec, job: JobSpec, interval: int = 50,
             seed: int = 0, horizon_factor: float = 50.0) -> RunStats:
    """Run the job under a fault-tolerance policy against a failure trace."""
    horizon = job.total_steps * job.step_s * horizon_factor
    failures = _failure_times(fleet, horizon, seed)
    fi = 0
    now = 0.0
    useful = wasted = overhead = 0.0
    mb_s = job.step_s / job.microbatches

    # progress state
    step = 0                  # committed full-checkpoint step
    done_steps = 0            # steps completed since ckpt (volatile unless
                              # continuation tracks them)
    done_mb = 0               # microbatches in current step (continuation)

    def interrupted(start: float, dur: float) -> bool:
        nonlocal fi
        # failures that fired during dead/restart time are absorbed by the
        # restart (the job was not computing); only a failure landing inside
        # [start, start+dur) interrupts this unit of work
        while fi < len(failures) and failures[fi] < start:
            fi += 1
        if fi < len(failures) and failures[fi] < start + dur:
            fi += 1
            return True
        return False

    n_fail = 0
    while step + done_steps < job.total_steps:
        if now > horizon:
            return RunStats(now, useful, wasted, overhead, n_fail, False)
        # run one microbatch
        if policy == "continuation":
            if interrupted(now, mb_s + job.mb_commit_s):
                n_fail += 1
                wasted += mb_s / 2            # half an mb lost on average
                now += mb_s / 2 + fleet.restart_s + job.restore_s
                overhead += fleet.restart_s + job.restore_s
                continue                       # resume at same microbatch
            now += mb_s + job.mb_commit_s
            useful += mb_s
            overhead += job.mb_commit_s
            done_mb += 1
            if done_mb == job.microbatches:
                done_mb = 0
                done_steps += 1
        else:
            # whole steps are the unit; a failure loses progress since the
            # last durable point.  Steps completed since that point were
            # booked as useful when they ran; once lost they move to wasted
            # (never double-counted), so on completion ``useful_s`` is
            # exactly ``total_steps * step_s`` and at every instant
            # ``wall_s == useful_s + wasted_s + overhead_s``.  For naive,
            # ``step`` is always 0 (it never checkpoints), so "since the
            # last durable point" is the whole job.
            if interrupted(now, job.step_s):
                n_fail += 1
                lost = done_steps * job.step_s
                useful -= lost
                wasted += lost + job.step_s / 2
                now += job.step_s / 2 + fleet.restart_s + job.restore_s
                overhead += fleet.restart_s + job.restore_s
                done_steps = 0
                continue
            now += job.step_s
            useful += job.step_s
            done_steps += 1

        # periodic full checkpoint (all policies except naive)
        if policy != "naive" and done_steps and done_steps % interval == 0:
            if interrupted(now, job.ckpt_write_s):
                n_fail += 1
                now += job.ckpt_write_s / 2 + fleet.restart_s + job.restore_s
                overhead += (job.ckpt_write_s / 2 + fleet.restart_s
                             + job.restore_s)
                if policy != "continuation":
                    # interval-k loses the uncheckpointed steps too
                    lost = done_steps * job.step_s
                    useful -= lost
                    wasted += lost
                    done_steps = 0
                continue
            now += job.ckpt_write_s
            overhead += job.ckpt_write_s
            step += done_steps
            done_steps = 0

    return RunStats(now, useful, wasted, overhead, n_fail, True)
