"""The plain PyTorch charge replay against the JAX package, on the CPU.

* JAX ``replay_plans(backend="xla")`` on a subset of the oracle grid, the
  uplink cases of ``tests/test_uplink.py`` (with the oracle too on their
  charge-wise lanes) and a continuous-power lane: bit-identical on every
  channel.
* JAX ``backend="pallas"`` (the Pallas lane kernel in interpret mode) on
  two configurations, one with the radio: bit-identical.
* The row helpers against their JAX counterparts: bit-identical.

Every comparison here is bitwise (``==`` on floats).
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
from repro_torch.kernels import charge_replay as tcr


LANES = 3


N_CHARGES = 48


N_RECHARGES = 16


#: The oracle grid of tests/test_reference_replay.py.
POLICIES = (
    ("fixed", 0.5, 1, 0.0),
    ("adaptive", 0.5, 1, 0.0),
    ("adaptive", 0.25, 4, 0.0),
    ("adaptive", 0.5, 1_000_000, 0.3),
    ("adaptive", 1.0, 2, 0.2),
    ("adaptive", 0.75, 1, 0.25),
)


PLANS = (
    (0, "sonic", 0.20),
    (1, "sonic", 0.08),
    (2, "tile-8", 0.30),
    (3, "naive", 1.50),
    (4, "naive", 0.50),
    (1, "tails", 0.15),
)


#: (attribute of ReplayOut, key of the oracle's dict) for every channel.
CHANNELS = (("live_cycles", "live"), ("dead_s", "dead"),
            ("wasted_cycles", "wasted"), ("belief_cycles", "belief"),
            ("tx_bytes", "tx_bytes"), ("msgs_sent", "msgs_sent"),
            ("msgs_deferred", "msgs_deferred"), ("reboots", "reboots"))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The replay's tensors are a few lanes wide: intra-op threads only
    contend with the other test workers."""
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
    """The harness's plan: built by the JAX package, restamped to a
    capacitor sized from its total work; returned with its port twin."""
    net, x = make_random_net(seed)
    plan = jfs.build_plan(net, x, strategy, "1mF", parametric=parametric)
    cap = max(2000.0, float(np.rint(cap_frac * plan.total_cycles)))
    plan = dataclasses.replace(plan, capacity=cap,
                               recharge_s=float(rf_recharge_seconds(cap)))
    return plan, plan_from_numpy(plan_fields(plan))


@pytest.fixture(scope="module")
def grid_plans():
    plans = [_restamped(*p) for p in PLANS]
    plans.append(_restamped(1, "tails", 0.12, parametric=True))
    return plans


def _assert_matches_oracle(out, ref, tag):
    assert out.completed == (not ref["stuck"]), tag
    for attr, key in CHANNELS:
        assert float(getattr(out, attr)) == float(ref[key]), (tag, attr)
    want = {op: float(v) for op, v in zip(OP_CLASSES, ref["classes"])
            if v > 0.0}
    assert out.by_class == want, tag


def _assert_same_replay(a, b, tag):
    for f in dataclasses.fields(a):
        assert getattr(a, f.name) == getattr(b, f.name), (tag, f.name)


def _uplink_plan(seed, strategy, cap_frac):
    jplan, _ = _restamped(seed, strategy, cap_frac)
    jplan = jfs.with_uplink(jplan)
    return jplan, plan_from_numpy(plan_fields(jplan))


#: (plan args, send policy, commit policy, window, charge cv) -- the
#: uplink cases of tests/test_uplink.py.
UPLINK_CASES = tuple(
    ((7, "sonic", 0.20), sp, policy, w, cv)
    for sp in range(len(SEND_POLICIES))
    for policy, w in (("fixed", 1), ("adaptive", 2))
    for cv in (0.0, 0.2)
) + (((7, "tails", 0.15), 1, "adaptive", 2, 0.2),
     ((4, "naive", 0.50), 0, "fixed", 1, 0.0))


@pytest.mark.parametrize("case", range(len(UPLINK_CASES)))
def test_plain_replay_matches_jax_uplink(case):
    """The uplink cases: JAX ``backend="xla"`` and the port agree on every
    channel (charge-wise and closed-form lanes alike), and on the
    charge-wise path both agree with the oracle."""
    pargs, sp, policy, w, cv = UPLINK_CASES[case]
    jplan, tplan = _uplink_plan(*pargs)
    radio = pack_radio(RadioModel(window_period_s=0.04, window_duty=0.4),
                       SEND_POLICIES[sp])
    lanes = 6
    rng = np.random.default_rng(case)
    frac = rng.uniform(0.02, 1.0, lanes)
    ctr = None if cv == 0 else charge_capacity_jitter(
        lanes, N_CHARGES, jplan.capacity, seed=case, cv=cv)
    rtr = reboot_recharge_times(lanes, N_RECHARGES, jplan.recharge_s,
                                seed=case + 1)
    conf = inference_confidence(lanes, seed=case + 2)
    kw = dict(init_frac=frac, policy=policy, batch_rows=w,
              recharge_traces=rtr, charge_traces=ctr, radio=radio,
              conf=conf)
    want = jfs.replay_plans([jplan] * lanes, backend="xla", **kw)
    got = tfs.replay_plans([tplan] * lanes, device="cpu", **kw)
    for i in range(lanes):
        _assert_same_replay(got[i], want[i], (case, i))
    if ctr is not None or (policy == "adaptive" and w > 1):
        rows = jfs._plan_rows(jplan)
        cum = recharge_trace_cumulative(rtr)
        ccum = None if ctr is None else charge_trace_cumulative(ctr)
        for i in range(lanes):
            ref = reference_replay(
                rows, jplan.capacity, jplan.capacity * frac[i],
                tail_s=jplan.recharge_s, recharge_cum=cum[i],
                charge_cum=None if ccum is None else ccum[i],
                policy=policy, batch_rows=w, conf=float(conf[i]),
                radio=radio)
            _assert_matches_oracle(got[i], ref, (case, i))


@pytest.mark.parametrize("policy", POLICIES[:4],
                         ids=lambda p: "-".join(map(str, p)))
def test_plain_replay_matches_jax_xla(grid_plans, policy):
    """All grid plans in one call per policy, cv 0.4 plus a short trace
    (the fast path engages), against JAX ``backend="xla"``."""
    pol, theta, w, alpha = policy
    jplans = [jp for jp, _tp in grid_plans]
    tplans = [tp for _jp, tp in grid_plans]
    n = len(jplans)
    caps = np.asarray([p.capacity for p in jplans])
    for n_ch, cv in ((N_CHARGES, 0.4), (6, 0.5)):
        ctr = charge_capacity_jitter(n, n_ch, caps, seed=n_ch, cv=cv)
        rtr = reboot_recharge_times(n, N_RECHARGES, 0.01, seed=3)
        kw = dict(init_frac=np.linspace(0.05, 1.0, n), policy=pol,
                  theta=theta, batch_rows=w, belief_alpha=alpha,
                  charge_traces=ctr, recharge_traces=rtr)
        want = jfs.replay_plans(jplans, backend="xla", **kw)
        got = tfs.replay_plans(tplans, device="cpu", **kw)
        for i in range(n):
            _assert_same_replay(got[i], want[i], (policy, n_ch, i))


def test_continuous_lane_matches_jax():
    """A lane with cap = inf (continuous power) beside finite lanes, with
    the radio on, on the charge-wise path."""
    jplan, tplan = _restamped(0, "sonic", 0.2)
    jinf = dataclasses.replace(jplan, capacity=np.inf)
    tinf = dataclasses.replace(tplan, capacity=np.inf)
    caps = np.array([jplan.capacity, np.inf, jplan.capacity])
    ctr = charge_capacity_jitter(3, 12, caps, seed=1, cv=0.3)
    radio = pack_radio(RadioModel(window_period_s=0.04, window_duty=0.4),
                       SEND_POLICIES[0])
    kw = dict(charge_traces=ctr, policy="adaptive", batch_rows=2,
              belief_alpha=0.1, radio=radio,
              conf=np.array([0.95, 0.5, 0.99]))
    want = jfs.replay_plans([jplan, jinf, jplan], backend="xla", **kw)
    got = tfs.replay_plans([tplan, tinf, tplan], device="cpu", **kw)
    assert got[1].completed and got[1].reboots == 0
    for i in range(3):
        _assert_same_replay(got[i], want[i], i)


@pytest.mark.parametrize("with_radio", (False, True))
def test_plain_replay_matches_jax_pallas(with_radio):
    """The JAX Pallas lane kernel in interpret mode and the port agree."""
    jplan, tplan = _restamped(0, "sonic", 0.15)
    ctr = charge_capacity_jitter(2, 12, jplan.capacity, seed=11, cv=0.35)
    kw = dict(init_frac=[0.4, 0.9], policy="adaptive", theta=0.5,
              batch_rows=3, belief_alpha=0.2, charge_traces=ctr)
    if with_radio:
        kw.update(radio=pack_radio(RadioModel(window_period_s=0.04,
                                              window_duty=0.4),
                                   SEND_POLICIES[1]),
                  conf=np.array([0.95, 0.6]))
    want = jfs.replay_plans([jplan] * 2, backend="pallas", **kw)
    got = tfs.replay_plans([tplan] * 2, device="cpu", **kw)
    for i in range(2):
        _assert_same_replay(got[i], want[i], i)


def test_event_chunk_rules_match_jax():
    from repro.kernels import charge_replay as jcr

    for s in (1, 3, 64, 65, 200, 511, 513, 4096, 70000):
        assert tcr.default_event_chunk(s) == jcr.default_event_chunk(s)
        assert tcr.event_chunk_candidates(s) == \
            jcr.event_chunk_candidates(s)
    with pytest.raises(ValueError):
        tcr.default_event_chunk(0)


def test_trace_window_and_defer_match_jax():
    import jax.numpy as jnp

    from repro.kernels import charge_replay as jcr

    rng = np.random.default_rng(0)
    cum = np.cumsum(rng.exponential(0.02, size=(5, 9)), axis=1)
    cum = np.concatenate([np.zeros((5, 1)), cum], axis=1)
    r0 = np.array([0.0, 2.0, 7.0, 12.0, 3.0])
    r1 = np.array([1.0, 9.0, 15.0, 12.0, 30.0])
    fb = rng.uniform(0.01, 0.05, 5)
    radio = pack_radio(RadioModel(window_period_s=0.05, window_duty=0.3),
                       SEND_POLICIES[1])
    live = rng.uniform(0, 5e6, 5)
    dead = rng.uniform(0, 3.0, 5)
    with jax.enable_x64(True):
        want_tw = [float(jcr.trace_window(jnp.asarray(cum[i]), r0[i], r1[i],
                                          fb[i])) for i in range(5)]
        want_cl, want_wait = zip(*[
            (bool(c), float(w)) for c, w in
            (jcr.send_defer_wait(jnp.asarray(live[i]), jnp.asarray(dead[i]),
                                 jnp.asarray(radio)) for i in range(5))])
    t = torch.as_tensor
    got_tw = tcr.trace_window(t(cum), t(r0), t(r1), t(fb))
    assert got_tw.tolist() == want_tw
    cl, wait = tcr.send_defer_wait(t(live), t(dead), t(radio))
    assert cl.tolist() == list(want_cl)
    assert wait.tolist() == list(want_wait)


def test_torn_prefix_matches_jax():
    import jax.numpy as jnp

    from repro.kernels import charge_replay as jcr

    rng = np.random.default_rng(1)
    n, g, c = 6, 5, len(OP_CLASSES)
    seg_cls = rng.integers(0, c, size=(n, g))
    seg_cls[:, 2] = seg_cls[:, 0]                 # a class that recurs
    seg_cyc = rng.integers(0, 50, size=(n, g)).astype(np.float64)
    p = rng.uniform(-5, 260, n)
    with jax.enable_x64(True):
        want = np.stack([np.asarray(jcr.torn_prefix(
            jnp.zeros(c), jnp.asarray(seg_cls[i]), jnp.asarray(seg_cyc[i]),
            p[i])) for i in range(n)])
    got = tcr.torn_prefix(torch.zeros(n, c, dtype=torch.float64),
                          torch.as_tensor(seg_cls), torch.as_tensor(seg_cyc),
                          torch.as_tensor(p))
    np.testing.assert_array_equal(got.numpy(), want)


def test_pack_rows_layout_matches_jax(grid_plans):
    from repro.kernels import charge_replay as jcr

    jplan, tplan = grid_plans[-1]                  # parametric tails
    with jax.enable_x64(True):
        jpacked, jlayout = jcr.pack_rows(jfs._plan_rows(jplan))
        jpacked = np.asarray(jpacked)
    rows = {k: torch.as_tensor(v) for k, v in tfs._plan_rows(tplan).items()}
    tpacked, tlayout = tcr.pack_rows(rows, shared_rows=True)
    np.testing.assert_array_equal(tpacked.numpy(), jpacked)
    assert [(k, off, tuple(s)) for k, off, s, _dt in jlayout] == \
        list(tlayout)
    row = tcr.unpack_row(tpacked, tlayout, torch.tensor([3, 0]))
    np.testing.assert_array_equal(row["entry_class"][0].numpy(),
                                  tplan.entry_class[3])
    assert row["kind"].dtype == torch.int64
