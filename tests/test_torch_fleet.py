"""The port's entry points against the JAX package's, on the CPU.

``fleet_sweep(device="cpu")`` and ``replay_plans(device="cpu")`` must be
bit-identical to the JAX package's on every result array (sonic and
tails, fixed and adaptive commits, charge cv 0.3, 16-reboot recharge
traces, radio off and on); ``fleet_evaluate`` must equal the JAX
package's bitwise and the scalar ``evaluate`` to the tolerances of
``tests/test_fleetsim.py`` (the scalar simulator sums in another order).
Entry points refuse to run without a card unless asked for the CPU; the
options once refused (``mesh=`` and the legacy ``backend="_while"``) run
with the fused replay's bits.
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from conftest import make_random_net

from repro.core import fleetsim as jfs
from repro.core.intermittent import POWER_SYSTEMS, STRATEGIES, evaluate
from repro.runtime.radio import RadioModel, SEND_POLICIES, pack_radio
from repro_torch.convert import (numpy_layers, plan_fields, plan_from_numpy,
                                 simnet_from_numpy)
from repro_torch.core import fleetsim as tfs
from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D, SimNet,
                                        SparseFC)

SWEEP_ARRAYS = ("completed", "live_s", "dead_s", "reboots", "energy_j",
                "wasted_cycles", "belief_cycles", "tx_bytes", "msgs_sent",
                "msgs_deferred", "tx_joules")


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


def _nets(seed):
    net, x = make_random_net(seed)
    return net, simnet_from_numpy(numpy_layers(net), net.input_shape,
                                  net.name), x


@pytest.mark.parametrize("radio_on", (False, True), ids=("radio-off",
                                                          "radio-on"))
@pytest.mark.parametrize("policy", ("fixed", "adaptive"))
@pytest.mark.parametrize("strategy", ("sonic", "tails"))
def test_fleet_sweep_matches_jax(strategy, policy, radio_on):
    jnet, tnet, x = _nets(3)
    kw = dict(n_devices=24, seed=3, charge_cv=0.3, trace_reboots=16,
              policy=policy)
    if policy == "adaptive":
        kw.update(theta=0.5, batch_rows=4, belief_alpha=0.2)
    if radio_on:
        kw["radio"] = pack_radio(RadioModel(window_period_s=0.05,
                                            window_duty=0.3),
                                 SEND_POLICIES[1])
    want = jfs.fleet_sweep(jnet, x, strategy, "100uF", **kw)
    got = tfs.fleet_sweep(tnet, x, strategy, "100uF", device="cpu", **kw)
    for name in SWEEP_ARRAYS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (got.strategy, got.power, got.n_devices, got.policy) == \
        (want.strategy, want.power, want.n_devices, want.policy)
    s_got, s_want = got.summary(), want.summary()
    s_got.pop("wall_s")
    s_want.pop("wall_s")
    assert s_got == s_want


def test_fleet_sweep_deterministic_matches_jax():
    """No capacity trace: the closed-form scan, against JAX."""
    jnet, tnet, x = _nets(1)
    kw = dict(n_devices=16, seed=1, trace_reboots=16)
    for strategy in ("sonic", "tile-8", "naive"):
        want = jfs.fleet_sweep(jnet, x, strategy, "1mF", **kw)
        got = tfs.fleet_sweep(tnet, x, strategy, "1mF", device="cpu", **kw)
        for name in SWEEP_ARRAYS[:7]:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name),
                                          err_msg=(strategy, name))


@pytest.mark.parametrize("radio_on", (False, True), ids=("radio-off",
                                                          "radio-on"))
@pytest.mark.parametrize("policy", ("fixed", "adaptive"))
def test_replay_plans_matches_jax(policy, radio_on):
    """Per-lane plans of mixed strategies and capacitors, inputs drawn
    from the Philox streams (``seed=``)."""
    jplans = []
    for seed, strategy in ((0, "sonic"), (1, "tails"), (2, "tile-8")):
        net, x = make_random_net(seed)
        jplans.append(jfs.build_plan(net, x, strategy, "100uF"))
    jplans.append(dataclasses.replace(jplans[0], capacity=4.0e4))
    tplans = [plan_from_numpy(plan_fields(p)) for p in jplans]
    kw = dict(seed=11, charge_cv=0.3, trace_reboots=16, lane_lo=5,
              policy=policy)
    if policy == "adaptive":
        kw.update(batch_rows=2, belief_alpha=0.2)
    if radio_on:
        kw["radio"] = pack_radio(RadioModel(window_period_s=0.05,
                                            window_duty=0.3),
                                 SEND_POLICIES[0])
    want = jfs.replay_plans(jplans, **kw)
    got = tfs.replay_plans(tplans, device="cpu", **kw)
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(w) for w in want]


@pytest.fixture(scope="module")
def small_net():
    """The four layer types of ``tests/test_fleetsim.py``'s matrix net."""
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(3, 1, 3, 3)).astype(np.float32)
    wfc = (rng.normal(size=(8, 75)) * 0.1).astype(np.float32)
    wsp = (rng.normal(size=(5, 8)) * (rng.random((5, 8)) < 0.35)
           ).astype(np.float32)
    b1 = rng.normal(size=3).astype(np.float32)
    bfc = rng.normal(size=8).astype(np.float32)
    bsp = rng.normal(size=5).astype(np.float32)
    x = rng.normal(size=(1, 12, 12)).astype(np.float32)
    net = SimNet([Conv2D(w1, b1), MaxPool2D(2), DenseFC(wfc, bfc),
                  SparseFC(wsp, bsp, relu=False)],
                 input_shape=(1, 12, 12), name="diff")
    return net, x


@pytest.fixture(scope="module")
def matrices(small_net):
    net, x = small_net
    jnet = _jax_net(net)
    got = {(r.strategy, r.power): r
           for r in tfs.fleet_evaluate(net, x, device="cpu")}
    want = {(r.strategy, r.power): r for r in jfs.fleet_evaluate(jnet, x)}
    return got, want, jnet


def _jax_net(net):
    from repro.core.inference import (Conv2D as JC, DenseFC as JD,
                                      MaxPool2D as JM, SimNet as JS,
                                      SparseFC as JSp)
    kinds = {"Conv2D": JC, "DenseFC": JD, "MaxPool2D": JM, "SparseFC": JSp}
    layers = []
    for d in numpy_layers(net):
        d = dict(d)
        layers.append(kinds[d.pop("type")](**d))
    return JS(layers, input_shape=net.input_shape, name=net.name)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("power", POWER_SYSTEMS)
def test_fleet_evaluate_matches_jax_and_scalar(small_net, matrices,
                                               strategy, power):
    got, want, jnet = matrices
    v, w = got[(strategy, power)], want[(strategy, power)]
    # bitwise against the JAX package's replay
    for f in dataclasses.fields(v):
        a, b = getattr(v, f.name), getattr(w, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    # and against the scalar simulator, as tests/test_fleetsim.py holds it
    net, x = small_net
    s = evaluate(jnet, x, strategy, power)
    assert v.completed == s.completed
    if not s.completed:
        assert v.reboots == s.reboots == 0
        return
    assert v.reboots == s.reboots
    assert abs(v.energy_j - s.energy_j) < 1e-6      # scalar sums per op
    np.testing.assert_array_equal(v.output, s.output)
    assert np.isclose(v.live_time_s, s.live_time_s, rtol=1e-9, atol=0)
    assert np.isclose(v.dead_time_s, s.dead_time_s, rtol=1e-9, atol=1e-12)


# --------------------------------------------------------------------------
# Errors
# --------------------------------------------------------------------------

@pytest.fixture
def one_plan():
    _jnet, tnet, x = _nets(0)
    return tnet, x, tfs.build_plan(tnet, x, "sonic", "1mF")


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch,
                                                       one_plan):
    tnet, x, plan = one_plan
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfs.replay_plans([plan])
    with pytest.raises(RuntimeError, match="CUDA"):
        tfs.fleet_sweep(plan=plan, n_devices=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfs.fleet_evaluate(tnet, x, strategies=("sonic",),
                           powers=("1mF",))
    assert tfs.replay_plans([plan], device="cpu")[0].completed


@pytest.mark.parametrize("kw,item", [
    (dict(backend="_while"), "_while"),
])
def test_unported_options_raise(one_plan, kw, item):
    """The options the port once refused run now, and what is still
    wrong raises: ``backend="_while"`` replays through both entry points
    (a charge-wise replay and the closed form) with the same bits as the
    fused replay, and a backend the port has no such name for (the JAX
    package's ``"xla"`` and ``"pallas"``) is refused by name."""
    _tnet, _x, plan = one_plan
    ctr = np.full((2, 8), plan.capacity)
    ctr[:, 1::2] -= 1000.0
    for traces in (ctr, None):
        a = tfs.replay_plans([plan] * 2, init_frac=[0.3, 0.8],
                             charge_traces=traces, device="cpu", **kw)
        b = tfs.replay_plans([plan] * 2, init_frac=[0.3, 0.8],
                             charge_traces=traces, device="cpu")
        assert a == b
    sw = dict(plan=plan, n_devices=3, charge_cv=0.2, device="cpu")
    a = tfs.fleet_sweep(**sw, **kw)
    b = tfs.fleet_sweep(**sw)
    for name in SWEEP_ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=(item, name))
    for backend in ("xla", "pallas"):
        with pytest.raises(ValueError, match="backend"):
            tfs.replay_plans([plan], backend=backend, device="cpu")
        with pytest.raises(ValueError, match="backend"):
            tfs.fleet_sweep(plan=plan, n_devices=2, backend=backend,
                            device="cpu")


def test_unported_surfaces_raise(one_plan):
    """``mesh=`` runs now and refuses what is not a mesh of the call's
    device; a design sweep and a capacitor sweep raise where the JAX
    package's raise: a ``plan`` that is neither a ``FleetPlan`` nor a
    ``PlanSet``, an empty ``PlanSet``, a capacitor sweep of a plan without
    tile tables."""
    from repro_torch.launch.mesh import FleetMesh, make_fleet_mesh

    tnet, x, plan = one_plan
    with pytest.raises(TypeError, match="FleetMesh"):
        tfs.fleet_sweep(plan=plan, n_devices=2, mesh=object(),
                        device="cpu")
    with pytest.raises(ValueError, match="shards"):
        tfs.fleet_sweep(plan=plan, n_devices=2, device="cpu",
                        mesh=FleetMesh((torch.device("cuda", 0),)))
    sw = dict(plan=plan, n_devices=5, charge_cv=0.2, device="cpu")
    a = tfs.fleet_sweep(mesh=make_fleet_mesh(2, device="cpu"), **sw)
    b = tfs.fleet_sweep(**sw)
    for name in SWEEP_ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    with pytest.raises(AttributeError):
        jfs.fleet_sweep(plan=object(), n_devices=2)
    with pytest.raises(AttributeError):
        tfs.fleet_sweep(plan=object(), n_devices=2, device="cpu")
    for ps in (jfs.PlanSet, tfs.PlanSet):
        with pytest.raises(ValueError, match="at least one plan"):
            ps.from_plans(())
    with pytest.raises(ValueError, match="parametric"):
        tfs.capacitor_sweep(None, None, [1e4, 2e4], plan=plan,
                            device="cpu")


def test_bad_knobs_raise(one_plan):
    _tnet, _x, plan = one_plan
    for kw in (dict(backend="xla"), dict(policy="greedy"),
               dict(batch_rows=0), dict(belief_alpha=1.0)):
        with pytest.raises(ValueError):
            tfs.replay_plans([plan], device="cpu", **kw)
    with pytest.raises(ValueError, match="cuda"):
        tfs.replay_plans([plan], device="cpu", backend="cuda",
                         charge_traces=np.full((1, 4), plan.capacity))
    with pytest.raises(ValueError):
        tfs.replay_plans([plan], device="cpu",
                         charge_traces=np.ones((2, 4)))
