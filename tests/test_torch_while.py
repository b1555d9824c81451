"""The port's legacy ``backend="_while"`` oracle (``fleetsim._while_replay``:
a row scan with a data-dependent charge loop a row) on the CPU.

Mirrors ``tests/test_reference_replay.py:176``, ``tests/test_planset.py:116``
and ``tests/test_uplink.py:109``.  Every comparison is bitwise (``==`` on
floats):

* against the port's ``backend="torch"`` (the fused event stream's plain
  version), on every channel of every case;
* against ``tests/reference_replay.py``, the pure-Python oracle, on every
  charge-wise lane of the oracle grid and the uplink cases;
* against the JAX package's own ``backend="_while"``, run through the
  module-scoped ``enable_x64`` shim.  Where JAX's value differs from
  ``reference_replay`` by the FMA that XLA puts into ``trace_window``
  (``ROADMAP.md`` Queue 3 item 2), ``reference_replay`` is the pin: the
  port must then equal the oracle.
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from conftest import make_random_net
from reference_replay import reference_replay

from repro.core import fleetsim as jfs
from repro.core.energy import OP_CLASSES, rf_recharge_seconds
from repro.runtime.failures import (charge_capacity_jitter,
                                    charge_trace_cumulative,
                                    inference_confidence,
                                    reboot_recharge_times,
                                    recharge_trace_cumulative)
from repro.runtime.radio import RadioModel, SEND_POLICIES, pack_radio
from repro_torch.convert import plan_fields, plan_from_numpy
from repro_torch.core import fleetsim as tfs

LANES = 3
N_CHARGES = 48
N_RECHARGES = 16

#: The commit-decision surface of tests/test_reference_replay.py.
POLICIES = (
    ("fixed", 0.5, 1, 0.0),
    ("adaptive", 0.5, 1, 0.0),
    ("adaptive", 0.25, 4, 0.0),
    ("adaptive", 0.5, 1_000_000, 0.3),
    ("adaptive", 1.0, 2, 0.2),
    ("adaptive", 0.75, 1, 0.25),
)

#: (charge_cv, bias_cv, with_recharge_trace, n_charges)
JITTERS = ((0.4, 0.0, True, 48), (0.25, 0.5, False, 48),
           (0.5, 0.0, False, 6))

#: (net seed, strategy, capacity as a fraction of the plan's total cycles,
#: parametric)
PLANS = ((0, "sonic", 0.20, False), (2, "tile-8", 0.30, False),
         (4, "naive", 0.50, False), (1, "tails", 0.15, False),
         (1, "tails", 0.12, True))

#: (attribute of ReplayOut, key of the oracle's dict)
CHANNELS = (("live_cycles", "live"), ("dead_s", "dead"),
            ("wasted_cycles", "wasted"), ("belief_cycles", "belief"),
            ("tx_bytes", "tx_bytes"), ("msgs_sent", "msgs_sent"),
            ("msgs_deferred", "msgs_deferred"), ("reboots", "reboots"))

SWEEP_CHANNELS = ("completed", "live_s", "dead_s", "reboots", "energy_j",
                  "wasted_cycles", "belief_cycles", "tx_bytes", "msgs_sent",
                  "msgs_deferred")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The replays are a few lanes wide: intra-op threads only contend
    with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_x64():
    """Let the JAX reference run on the installed jax, whose
    ``jax.experimental`` no longer has ``enable_x64``; undone after this
    module so no other test file sees it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "enable_x64",
               lambda: jax.enable_x64(True), raising=False)
    yield
    mp.undo()


def _restamped(seed, strategy, cap_frac, parametric=False):
    """A JAX plan restamped to a capacitor sized from its total work, and
    its port twin."""
    net, x = make_random_net(seed)
    plan = jfs.build_plan(net, x, strategy, "1mF", parametric=parametric)
    cap = max(2000.0, float(np.rint(cap_frac * plan.total_cycles)))
    plan = dataclasses.replace(plan, capacity=cap,
                               recharge_s=float(rf_recharge_seconds(cap)))
    return plan, plan_from_numpy(plan_fields(plan))


@pytest.fixture(scope="module")
def grid_plans():
    return [_restamped(*p) for p in PLANS]


def _same(a, b, tag):
    for f in dataclasses.fields(a):
        assert getattr(a, f.name) == getattr(b, f.name), (tag, f.name)


def _oracle_channels(out, ref, tag):
    assert out.completed == (not ref["stuck"]), tag
    for attr, key in CHANNELS:
        assert float(getattr(out, attr)) == float(ref[key]), (tag, attr)
    want = {op: float(v) for op, v in zip(OP_CLASSES, ref["classes"])
            if v > 0.0}
    assert out.by_class == want, tag


@pytest.mark.parametrize("policy", POLICIES,
                         ids=lambda p: "-".join(map(str, p)))
def test_while_matches_fused_and_reference_oracle(grid_plans, policy):
    """Every lane of the oracle grid for one commit policy, through
    ``backend="_while"``: bitwise equal to ``backend="torch"`` on every
    ``ReplayOut`` field and to ``reference_replay`` on every channel.  The
    lanes of every plan and jitter share one call (per-lane rows) per
    recharge-trace layout."""
    pol, theta, w, alpha = policy
    groups = {True: [], False: []}
    for p_idx, (jplan, tplan) in enumerate(grid_plans):
        for j_idx, (cv, bias, with_recharge, n_ch) in enumerate(JITTERS):
            case_seed = 1 + (p_idx * len(JITTERS) + j_idx) * 7 \
                + POLICIES.index(policy)
            frac = np.random.default_rng(case_seed).uniform(0.02, 1.0,
                                                            LANES)
            ctr = charge_capacity_jitter(LANES, n_ch, jplan.capacity,
                                         seed=case_seed, cv=cv,
                                         bias_cv=bias)
            rtr = (reboot_recharge_times(LANES, N_RECHARGES,
                                         jplan.recharge_s,
                                         seed=case_seed + 1)
                   if with_recharge else None)
            groups[with_recharge].append((jplan, tplan, frac, ctr, rtr))
    before = tfs._while_replay.charge_steps
    seen = 0
    for with_recharge, lanes in groups.items():
        plans, fracs, traces, rtraces = [], [], [], []
        for jplan, tplan, frac, ctr, rtr in lanes:
            for i in range(LANES):
                plans.append(tplan)
                fracs.append(frac[i])
                # past its end a trace delivers the nominal capacity, so
                # extending it with nominal charges is exact
                row = np.full(N_CHARGES, tplan.capacity)
                row[:ctr.shape[1]] = ctr[i]
                traces.append(row)
                if rtr is not None:
                    rtraces.append(rtr[i])
        kw = dict(init_frac=np.asarray(fracs), policy=pol, theta=theta,
                  batch_rows=w, belief_alpha=alpha,
                  charge_traces=np.stack(traces),
                  recharge_traces=(np.stack(rtraces) if with_recharge
                                   else None), device="cpu")
        old = tfs.replay_plans(plans, backend="_while", **kw)
        new = tfs.replay_plans(plans, backend="torch", **kw)
        k = 0
        for jplan, tplan, frac, ctr, rtr in lanes:
            rows = jfs._plan_rows(jplan)
            cum = None if rtr is None else recharge_trace_cumulative(rtr)
            ccum = charge_trace_cumulative(ctr)
            for i in range(LANES):
                tag = (jplan.strategy, jplan.capacity, policy, i)
                _same(old[k], new[k], tag)
                ref = reference_replay(
                    rows, jplan.capacity, jplan.capacity * frac[i],
                    tail_s=jplan.recharge_s,
                    recharge_cum=None if cum is None else cum[i],
                    charge_cum=ccum[i], policy=pol, theta=theta,
                    batch_rows=w, belief_alpha=alpha)
                _oracle_channels(old[k], ref, tag)
                k += 1
                seen += 1
    assert seen == len(PLANS) * len(JITTERS) * LANES
    assert tfs._while_replay.charge_steps > before


#: (plan args, send policy index, commit policy, batch window, charge cv)
UPLINK_CASES = (
    ((7, "sonic", 0.20), 0, "adaptive", 2, 0.2),
    ((7, "sonic", 0.20), 1, "fixed", 1, 0.2),
    ((7, "sonic", 0.20), 2, "adaptive", 2, 0.0),
    ((7, "tails", 0.15), 1, "adaptive", 2, 0.2),
)
WINDOW = RadioModel(window_period_s=0.04, window_duty=0.4)


@pytest.mark.parametrize("case", UPLINK_CASES,
                         ids=lambda c: f"{c[0][1]}-sp{c[1]}-{c[2]}-cv{c[4]}")
def test_while_uplink_matches_jax_and_oracle(case):
    """The uplink's send/defer decision through ``_while``: bitwise equal
    to ``backend="torch"``, to ``reference_replay`` and to the JAX
    package's ``_while``, except where JAX differs from the oracle by the
    XLA FMA (Queue 3 item 2): there the oracle is the pin."""
    (seed, strategy, cap_frac), sp, policy, w, cv = case
    jplan, _ = _restamped(seed, strategy, cap_frac)
    jplan = jfs.with_uplink(jplan)
    tplan = plan_from_numpy(plan_fields(jplan))
    lanes = 6
    radio = pack_radio(WINDOW, SEND_POLICIES[sp])
    frac = np.random.default_rng(seed + sp).uniform(0.02, 1.0, lanes)
    ctr = (charge_capacity_jitter(lanes, N_CHARGES, jplan.capacity,
                                  seed=sp, cv=cv) if cv > 0 else None)
    rtr = reboot_recharge_times(lanes, N_RECHARGES, jplan.recharge_s,
                                seed=sp + 1)
    conf = inference_confidence(lanes, seed=sp + 2)
    kw = dict(init_frac=frac, policy=policy, batch_rows=w,
              recharge_traces=rtr, charge_traces=ctr, radio=radio,
              conf=conf)
    old = tfs.replay_plans([tplan] * lanes, backend="_while", device="cpu",
                           **kw)
    new = tfs.replay_plans([tplan] * lanes, backend="torch", device="cpu",
                           **kw)
    jold = jfs.replay_plans([jplan] * lanes, backend="_while", **kw)
    rows = jfs._plan_rows(jplan)
    cum = recharge_trace_cumulative(rtr)
    ccum = None if ctr is None else charge_trace_cumulative(ctr)
    pinned = 0
    for i in range(lanes):
        tag = (strategy, sp, policy, i)
        _same(old[i], new[i], tag)
        ref = reference_replay(
            rows, jplan.capacity, jplan.capacity * frac[i],
            tail_s=jplan.recharge_s, recharge_cum=cum[i],
            charge_cum=None if ccum is None else ccum[i], policy=policy,
            batch_rows=w, conf=float(conf[i]), radio=radio)
        _oracle_channels(old[i], ref, tag)
        for f in dataclasses.fields(old[i]):
            a, b = getattr(old[i], f.name), getattr(jold[i], f.name)
            if a != b:
                # the FMA of trace_window: JAX is one rounding off the
                # oracle on a dead-time channel, which the port matched
                assert f.name == "dead_s", (tag, f.name, a, b)
                assert b == pytest.approx(a, rel=1e-15, abs=0.0), tag
                pinned += 1
    assert pinned <= lanes


@pytest.fixture(scope="module")
def design():
    """3 candidates (sonic/100uF, tails/1mF, tile-8/1mF of one net) as a
    PlanSet in both packages."""
    net, x = make_random_net(1)
    jplans = [jfs.build_plan(net, x, s, p)
              for s, p in (("sonic", "100uF"), ("tails", "1mF"),
                           ("tile-8", "1mF"))]
    tplans = [plan_from_numpy(plan_fields(p)) for p in jplans]
    return (jfs.PlanSet.from_plans(jplans),
            tfs.PlanSet.from_plans(tplans))


DESIGN_KW = dict(n_devices=8, seed=3, charge_cv=0.3, charge_reboots=16,
                 trace_reboots=8)


def test_design_sweep_while_matches_fused_and_jax(design):
    """A PlanSet design sweep through ``_while`` (each lane's candidate
    rows gathered first): bitwise equal to the fused plan-mode replay and
    to the JAX package's ``_while`` design sweep."""
    jps, tps = design
    old = tfs.fleet_sweep(plan=tps, backend="_while", device="cpu",
                          **DESIGN_KW)
    new = tfs.fleet_sweep(plan=tps, backend="torch", device="cpu",
                          **DESIGN_KW)
    jold = jfs.fleet_sweep(plan=jps, backend="_while", **DESIGN_KW)
    for ch in SWEEP_CHANNELS:
        np.testing.assert_array_equal(getattr(old, ch), getattr(new, ch),
                                      err_msg=ch)
        np.testing.assert_array_equal(getattr(old, ch), getattr(jold, ch),
                                      err_msg=ch)
    assert old.completed.shape == (3, 8)


@pytest.mark.parametrize("prefetch", [0, 1])
def test_while_streamed_stats_match_fused(design, prefetch):
    """``_while`` under ``reduce="stats"``, ``lane_chunk`` and
    ``prefetch``: the same statistics as the fused replay, bitwise."""
    _jps, tps = design
    kw = dict(reduce="stats", lane_chunk=7, prefetch=prefetch,
              device="cpu", **DESIGN_KW)
    old = tfs.fleet_sweep(plan=tps, backend="_while", **kw)
    new = tfs.fleet_sweep(plan=tps, backend="torch", **kw)
    for name in ("count", "completed", "class_sums"):
        np.testing.assert_array_equal(getattr(old, name),
                                      getattr(new, name), err_msg=name)
    for d in ("sums", "sumsqs", "mins", "maxs", "hists"):
        for ch, v in getattr(new, d).items():
            np.testing.assert_array_equal(getattr(old, d)[ch], v,
                                          err_msg=(d, ch))


def test_capacitor_sweep_while_matches_fused():
    """The parametric plan's CALIB rows refill from the charge trace on
    the legacy path too."""
    net, x = make_random_net(2)
    from repro_torch.convert import numpy_layers, simnet_from_numpy
    tnet = simnet_from_numpy(numpy_layers(net), net.input_shape, net.name)
    kw = dict(n_devices=5, seed=1, charge_cv=0.3, charge_reboots=24,
              policy="adaptive", batch_rows=2, device="cpu")
    caps = np.asarray([3e3, 2e4, 1e6])
    old = tfs.capacitor_sweep(tnet, x, caps, backend="_while", **kw)
    new = tfs.capacitor_sweep(tnet, x, caps, backend="torch", **kw)
    for ch in ("completed", "live_s", "dead_s", "reboots", "energy_j",
               "wasted_cycles", "belief_cycles"):
        np.testing.assert_array_equal(getattr(old, ch), getattr(new, ch),
                                      err_msg=ch)


def test_deterministic_replay_under_while_is_the_closed_form(grid_plans):
    """A replay without charge jitter or a cross-charge window takes the
    closed-form scan whatever the backend: ``_while`` runs no charge
    loop and gives the same bits."""
    _jp, tplan = grid_plans[0]
    kw = dict(init_frac=[0.3, 0.9], device="cpu")
    before = tfs._while_replay.charge_steps
    old = tfs.replay_plans([tplan] * 2, backend="_while", **kw)
    new = tfs.replay_plans([tplan] * 2, **kw)
    assert tfs._while_replay.charge_steps == before
    for a, b in zip(old, new):
        _same(a, b, "closed form")


def test_while_is_never_auto_and_is_listed():
    assert "_while" in tfs.REPLAY_BACKENDS
    assert tfs.REPLAY_BACKENDS[0] == "auto"
    with pytest.raises(ValueError, match="backend"):
        tfs._validate_replay_knobs("fixed", 1, 0.0, "xla")
