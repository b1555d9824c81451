"""The paper's end-to-end demonstration on the port
(``examples/intermittent_mnist_torch.py``) against the JAX package's
calls (``examples/intermittent_mnist.py``), on the CPU.

* ``compressed_net("mnist")``: every layer's weights bitwise against the
  JAX package's ``apply_config`` of ``mnist_net()`` under GENESIS's MNIST
  choices, written here as literals;
* ``sonic_risk_plan``: the plan's rows and header and the power system
  bitwise against the JAX package's ``build_plan`` and
  ``custom_power_system``, restamped the same way;
* each section (``matrix``, ``fleet``, ``uplink``, ``design_space``,
  ``risk``, ``stats_query``) at a few devices on small random networks
  (``tests/conftest.make_random_net``; MNIST's plans take the CPU's plain
  replay minutes), against the same JAX calls: what the section returns,
  bitwise, except the streamed statistics of ``total_s``, which the JAX
  package folds inside its jit where XLA rounds ``live / 16e6 + dead``
  differently; they are pinned to ``stats_from_outputs`` of the port's
  own lanes (``ROADMAP.md`` Queue 3 item 2).  The ``genesis`` section
  retrains the net, and two frameworks' training runs are not held to
  each other here (``tests/test_torch_train.py`` holds their steps).

The example runs whole on the CPU in ``tests/test_torch_examples.py``.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest

from conftest import make_random_net

from repro.compress import LayerChoice as JChoice
from repro.compress import apply_config as japply
from repro.core import fleetsim as jfs
from repro.core import fleetstats as jst
from repro.core.energy import custom_power_system as jcustom
from repro.core.energy import make_power_system as jpower
from repro.data import make_task as jtask
from repro.models.dnn import mnist_net as jmnist
from repro.runtime.radio import RadioModel as JRadio
from repro.runtime.radio import SEND_POLICIES as JPOLICIES
from repro.runtime.radio import pack_radio as jpack
from repro_torch.convert import numpy_layers, plan_fields, simnet_from_numpy
from repro_torch.core import fleetsim as tfs
from repro_torch.core.energy import OP_CLASSES
from repro_torch.core.fleetstats import STAT_CHANNELS

ROOT = Path(__file__).resolve().parents[1]
SECTIONS = ("matrix", "fleet", "uplink", "design_space", "risk",
            "stats_query")


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


@pytest.fixture(scope="module")
def ex():
    spec = importlib.util.spec_from_file_location(
        "intermittent_mnist_torch",
        ROOT / "examples" / "intermittent_mnist_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nets(seed):
    """A random net of the JAX package and its port twin, and an input."""
    jnet, x = make_random_net(seed)
    return jnet, simnet_from_numpy(numpy_layers(jnet), jnet.input_shape,
                                   jnet.name), x


def _same_layers(a, b):
    la, lb = numpy_layers(a), numpy_layers(b)
    assert len(la) == len(lb)
    for da, db in zip(la, lb):
        assert da.keys() == db.keys()
        for k in da:
            if isinstance(da[k], np.ndarray):
                assert da[k].dtype == db[k].dtype, k
                np.testing.assert_array_equal(da[k], db[k], err_msg=k)
            else:
                assert da[k] == db[k], k


#: GENESIS's MNIST choice, a layer of ``mnist_net()`` each: conv1
#: separated at rank 2 (min(1 x 5, 20 x 5) // 6, floored at 2), conv2
#: pruned to 90 %, fc1 and fc2 (over 20,000 weights) to 95 %, fc3 (5,000)
#: to 90 %, the pools kept.
MNIST_CHOICES = (JChoice("separate", 2), JChoice("keep"),
                 JChoice("prune", 0.9), JChoice("keep"),
                 JChoice("prune", 0.95), JChoice("prune", 0.95),
                 JChoice("prune", 0.9))


def test_compressed_net_matches_jax(ex):
    _same_layers(ex.compressed_net("mnist"), japply(jmnist(), MNIST_CHOICES))


def test_sonic_risk_plan_matches_jax(ex):
    net = ex.compressed_net("mnist")
    x = jtask("mnist", n_train=512, n_test=256, noise=0.85).x_test[0]
    plan, ps = ex.sonic_risk_plan(net, x)
    jnet = japply(jmnist(), MNIST_CHOICES)
    jplan = jfs.build_plan(jnet, x, "sonic", jcustom(1e5))
    jps = jcustom(max(1e5, jplan.total_cycles / 8.0))
    jplan = dataclasses.replace(jplan, power=jps.name,
                                capacity=jps.cycles_per_charge,
                                recharge_s=jps.recharge_s)
    got, want = plan_fields(plan), plan_fields(jplan)
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k
    assert (ps.name, ps.cycles_per_charge, ps.recharge_s) == \
        (jps.name, jps.cycles_per_charge, jps.recharge_s)


# --------------------------------------------------------------------------
# The sections, each against the JAX example's calls
# --------------------------------------------------------------------------

def _matrix(ex, capsys):
    jnet, net, x = _nets(0)
    got = ex.matrix(net, x, device="cpu")
    want = {(r.strategy, r.power): r for r in jfs.fleet_evaluate(jnet, x)}
    assert got.keys() == want.keys() and len(got) == 24
    for key, v in got.items():
        w = want[key]
        for f in dataclasses.fields(v):
            a, b = getattr(v, f.name), getattr(w, f.name)
            if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=str(key))
            else:
                assert a == b, (key, f.name)


def _fleet(ex, capsys):
    jnet, net, x = _nets(1)
    got = ex.fleet(net, x, 12, device="cpu")
    for strat in ("sonic", "tails"):
        want = jfs.fleet_sweep(jnet, x, strat, "1mF", n_devices=12, seed=42,
                               trace_reboots=64).summary()
        g = dict(got[strat])
        g.pop("wall_s")
        want.pop("wall_s")
        assert g == want, strat


def _uplink(ex, capsys):
    jnet, net, x = _nets(1)
    got = ex.uplink(net, x, 12, device="cpu")
    basestation = JRadio(window_period_s=0.05, window_duty=0.3)
    assert [p.name for p in JPOLICIES] == list(got)
    for pol in JPOLICIES:
        r = jfs.fleet_sweep(jnet, x, "sonic", "1mF", n_devices=12, seed=42,
                            trace_reboots=64, radio=jpack(basestation, pol))
        u = r.summary()["uplink"]
        bits = 8.0 * (u["tx_bytes"]
                      - basestation.header_bytes * u["msgs_sent"])
        assert got[pol.name] == dict(u, bits_per_j=bits / r.energy_j.sum())


def _design_space(ex, capsys):
    jorig, orig, x = _nets(0)
    jnet, net, x2 = _nets(2)
    assert x.shape == x2.shape

    def restamped(plan, power):
        p = jpower(power)
        return dataclasses.replace(plan, capacity=p.cycles_per_charge,
                                   recharge_s=p.recharge_s, power=p.name)

    plans, labels = [], []
    for nname, cnet in (("orig", jorig), ("genesis", jnet)):
        sonic = jfs.build_plan(cnet, x, "sonic", "1mF")
        for p in ("100uF", "1mF", "50mF"):
            plans.append(restamped(sonic, p))
            labels.append(f"{nname}/sonic/{p}")
            plans.append(jfs.build_plan(cnet, x, "tails", p))
            labels.append(f"{nname}/tails/{p}")
    tile8 = jfs.build_plan(jnet, x, "tile-8", "1mF")
    for p in ("100uF", "1mF", "50mF"):
        plans.append(restamped(tile8, p))
        labels.append(f"genesis/tile-8/{p}")
    jdesign = jfs.PlanSet.from_plans(plans, labels=labels)
    want = jfs.fleet_sweep(plan=jdesign, n_devices=6, seed=42,
                           charge_cv=0.2, charge_reboots=32).summary()
    got = ex.design_space(orig, net, x, 6, device="cpu")
    assert len(got["rows"]) == 15
    assert got["rows"] == want
    assert got["frontier"] == ex.pareto(want)
    assert got["plan_launches"] == 0          # no kernel on the CPU


def _risk(ex, capsys):
    jnet, net, x = _nets(3)
    got = ex.risk(net, x, 6, device="cpu")
    plan = jfs.build_plan(jnet, x, "sonic", jcustom(1e5))
    ps = jcustom(max(1e5, plan.total_cycles / 8.0))
    plan = dataclasses.replace(plan, power=ps.name,
                               capacity=ps.cycles_per_charge,
                               recharge_s=ps.recharge_s)
    assert list(got) == [0.0, 0.2, 0.4, 0.8]
    for cv, row in got.items():
        jitter = dict(charge_cv=cv, charge_bias_cv=cv, charge_reboots=160)
        fx = jfs.fleet_sweep(jnet, x, "sonic", ps, n_devices=6, seed=42,
                             plan=plan, **jitter)
        ads = [jfs.fleet_sweep(jnet, x, "sonic", ps, n_devices=6, seed=42,
                               plan=plan, policy="adaptive", theta=0.5,
                               **kn, **jitter) for kn in ex.RISK_VARIANTS]
        assert row == {"fixed_uj": fx.energy_j.mean() * 1e6,
                       "adaptive_uj": [a.energy_j.mean() * 1e6
                                       for a in ads],
                       "xchg_waste": float(ads[1].wasted_cycles.mean()),
                       "ewma_waste": float(ads[2].wasted_cycles.mean())}, cv


def _stats_query(ex, capsys, monkeypatch):
    jnet, net, x = _nets(4)
    monkeypatch.setattr(ex, "QUERY_CHUNK", 64)     # three chunks, one padded
    st = ex.stats_query(net, x, 150, device="cpu")
    kw = dict(n_devices=150, seed=42, lane_chunk=64)
    want = jfs.fleet_sweep(jnet, x, "sonic", "1mF", reduce="stats", **kw)
    assert np.array_equal(st.count, want.count)
    assert np.array_equal(st.completed, want.completed)
    assert np.array_equal(st.class_sums, want.class_sums)
    for ch in STAT_CHANNELS:
        assert np.array_equal(st.edges[ch], want.edges[ch]), ch
        if ch == "total_s":
            continue
        for f in ("sums", "sumsqs", "mins", "maxs", "hists"):
            assert np.array_equal(getattr(st, f)[ch], getattr(want, f)[ch]), \
                (f, ch)
    assert st.peak_lane_bytes == want.peak_lane_bytes
    # total_s against stats_from_outputs of the port's own lanes, a chunk
    # at a time, merged in chunk order as the stream merges its partials
    lanes = tfs.fleet_sweep(net, x, "sonic", "1mF", device="cpu", **kw)
    edges = dict(st.edges, dead_s=st.edges["total_s"])
    ref = None
    for lo in range(0, 150, 64):
        total, done = lanes.total_s[lo:lo + 64], lanes.completed[lo:lo + 64]
        n = total.shape[0]
        part = jst.stats_from_outputs(
            {"live": np.zeros(n), "dead": total, "reboots": np.zeros(n),
             "wasted": np.zeros(n), "belief": np.zeros(n), "stuck": ~done,
             "classes": np.zeros((n, len(OP_CLASSES)))}, edges)
        ref = part if ref is None else ref.merge(part)
    for f in ("sums", "sumsqs", "mins", "maxs", "hists"):
        assert np.array_equal(getattr(st, f)["total_s"],
                              getattr(ref, f)["dead_s"]), f


@pytest.mark.parametrize("section", SECTIONS)
def test_section_matches_jax(ex, section, capsys, monkeypatch):
    """Each section of the example on the CPU against the JAX example's
    calls on the same net, input and seeds, and its header printed."""
    run = globals()[f"_{section}"]
    if section == "stats_query":
        run(ex, capsys, monkeypatch)
    else:
        run(ex, capsys)
    header = ex.HEADERS[1 + SECTIONS.index(section)]
    assert header in capsys.readouterr().out


def test_scale_one_is_the_jax_example(ex):
    """At ``--scale 1.0`` the device counts are the JAX example's."""
    assert [ex.scaled(n, 1.0) for n in (
        ex.FLEET_DEVICES, ex.RISK_DEVICES, ex.DESIGN_DEVICES,
        ex.QUERY_DEVICES)] == [1000, 256, 64, 1_000_000]
    assert ex.QUERY_CHUNK == 8192
    assert ex.scaled(ex.DESIGN_DEVICES, 0.01) == 1
