"""The plain PyTorch charge replay (``repro_torch.kernels.charge_replay``)
against the pure-Python oracle ``tests/reference_replay.py``, on the CPU.

Every stochastic lane of the ``test_reference_replay.py`` grid (plans x
commit policies x charge jitters, 3 lanes each) must be bit-identical to
the oracle on every channel.  Every comparison here is bitwise (``==`` on
floats): both sides perform the same float operations in the same order,
one rounding each.  ``test_torch_charge_replay_jax.py`` holds the same
replay against the JAX package.
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
                                    reboot_recharge_times,
                                    recharge_trace_cumulative)
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


JITTERS = ((0.0, 0.0, False, 48), (0.4, 0.0, True, 48),
           (0.25, 0.5, False, 48), (0.5, 0.0, False, 6))


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


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: "-".join(map(str, p)))
def test_plain_replay_matches_reference_oracle(grid_plans, policy):
    """Every stochastic lane of the oracle grid for one commit policy:
    the lanes of every plan and jitter go through one ``replay_plans``
    call per recharge-trace layout (per-lane rows), and each lane is then
    interpreted alone by the oracle."""
    pol, theta, w, alpha = policy
    adaptive_window = pol == "adaptive" and w > 1
    groups = {True: [], False: []}      # with a recharge trace or not
    case_seed = 0
    for p_idx, (jplan, tplan) in enumerate(grid_plans):
        for j_idx, (cv, bias, with_recharge, n_ch) in enumerate(JITTERS):
            case_seed = 1 + ((p_idx * len(POLICIES)
                              + POLICIES.index(policy)) * len(JITTERS)
                             + j_idx)
            jittered = cv > 0 or bias > 0
            if not (jittered or adaptive_window):
                continue        # the closed form: not a charge-wise lane
            rng = np.random.default_rng(case_seed)
            frac = rng.uniform(0.02, 1.0, LANES)
            ctr = None
            if jittered:
                ctr = charge_capacity_jitter(LANES, n_ch, jplan.capacity,
                                             seed=case_seed, cv=cv,
                                             bias_cv=bias)
            rtr = None
            if with_recharge:
                rtr = reboot_recharge_times(LANES, N_RECHARGES,
                                            jplan.recharge_s,
                                            seed=case_seed + 1)
            groups[with_recharge].append((jplan, tplan, frac, ctr, rtr))
    seen = 0
    for with_recharge, lanes in groups.items():
        if not lanes:
            continue
        plans, fracs, traces, rtraces = [], [], [], []
        for jplan, tplan, frac, ctr, rtr in lanes:
            for i in range(LANES):
                plans.append(tplan)
                fracs.append(frac[i])
                # lanes without a capacity trace get an all-nominal one:
                # refills past a trace deliver the nominal capacity, so the
                # extension is exact
                row = np.full(N_CHARGES, tplan.capacity)
                if ctr is not None:
                    row[:ctr.shape[1]] = ctr[i]
                traces.append(row)
                if rtr is not None:
                    rtraces.append(rtr[i])
        outs = tfs.replay_plans(
            plans, init_frac=np.asarray(fracs), policy=pol, theta=theta,
            batch_rows=w, belief_alpha=alpha,
            charge_traces=np.stack(traces),
            recharge_traces=np.stack(rtraces) if with_recharge else None,
            device="cpu")
        k = 0
        for jplan, tplan, frac, ctr, rtr in lanes:
            rows = jfs._plan_rows(jplan)
            cum = None if rtr is None else recharge_trace_cumulative(rtr)
            ccum = None if ctr is None else charge_trace_cumulative(ctr)
            for i in range(LANES):
                ref = reference_replay(
                    rows, jplan.capacity, jplan.capacity * frac[i],
                    tail_s=jplan.recharge_s,
                    recharge_cum=None if cum is None else cum[i],
                    charge_cum=None if ccum is None else ccum[i],
                    policy=pol, theta=theta, batch_rows=w,
                    belief_alpha=alpha)
                _assert_matches_oracle(outs[k], ref,
                                       (jplan.strategy, jplan.capacity,
                                        policy, i))
                k += 1
                seen += 1
    assert seen >= 3 * len(grid_plans) * LANES


def test_chunk_does_not_change_results(grid_plans):
    """The plain version's completion-check period is pacing only."""
    _jp, tplan = grid_plans[2]
    ctr = charge_capacity_jitter(4, 20, tplan.capacity, seed=2, cv=0.4)
    kw = dict(init_frac=[0.1, 0.5, 0.7, 1.0], policy="adaptive",
              batch_rows=4, belief_alpha=0.2, charge_traces=ctr,
              device="cpu")
    a = tfs.replay_plans([tplan] * 4, event_chunk=1, **kw)
    b = tfs.replay_plans([tplan] * 4, event_chunk=512, **kw)
    for x, y in zip(a, b):
        _assert_same_replay(x, y, "chunk")


def test_wrapper_takes_plain_version_for_cpu_tensors(grid_plans):
    """On the CPU the wrapper runs the plain version and launches
    nothing."""
    _jp, tplan = grid_plans[0]
    before = tcr.charge_replay.launches
    ctr = charge_capacity_jitter(2, 12, tplan.capacity, seed=4, cv=0.3)
    a = tfs.replay_plans([tplan] * 2, charge_traces=ctr, device="cpu")
    b = tfs.replay_plans([tplan] * 2, charge_traces=ctr, device="cpu",
                         backend="torch")
    assert tcr.charge_replay.launches == before
    for x, y in zip(a, b):
        _assert_same_replay(x, y, "auto-vs-torch")
