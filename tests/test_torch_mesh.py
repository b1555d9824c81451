"""``mesh=`` sharding of the port's fleet sweeps on the CPU
(``repro_torch.launch.mesh``: ``make_fleet_mesh(device="cpu")`` shards on
the CPU, the twin of JAX's forced host device count).

Mirrors ``tests/test_fleet_replay_decisions.py:716-745`` and
``tests/test_fleetstats.py:200-214``.  The rules:

* a ``(1,)`` mesh is bitwise equal to the unmeshed call, with and without
  ``lane_chunk``, and to the JAX package's ``make_fleet_mesh()`` run;
* 2 and 3 shards with a fleet size that is not a multiple of the shard
  count: ``reduce="none"`` is bitwise equal;
* under ``reduce="stats"`` with several shards the counts, histograms,
  minima and maxima are exact and the f64 sums match to rtol 1e-12: the
  shard-order sum rounds differently, as JAX's ``psum`` does.
"""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import fleetsim as jfs
from repro.launch.mesh import make_fleet_mesh as jax_fleet_mesh
from repro_torch.convert import numpy_layers
from repro_torch.core import fleetsim as tfs
from repro_torch.core.fleetstats import STAT_CHANNELS
from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D, SimNet,
                                        SparseFC)
from repro_torch.launch.mesh import (FleetMesh, fleet_all_reduce,
                                     make_fleet_mesh, mesh_chips)

SWEEP = ("completed", "live_s", "dead_s", "reboots", "energy_j",
         "wasted_cycles", "belief_cycles", "tx_bytes", "msgs_sent",
         "msgs_deferred", "classes")
GRID = ("completed", "live_s", "dead_s", "reboots", "energy_j",
        "wasted_cycles", "belief_cycles")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def jax_x64():
    """Let the JAX reference run on the installed jax, whose
    ``jax.experimental`` no longer has ``enable_x64`` and whose
    ``shard_map`` checks the replay's scan carries for varying manual axes
    unless told not to (``check_vma=False``, the successor of the
    ``check_rep=False`` that ``repro.launch.mesh.compat_shard_map`` asks
    for); undone after this module so no other test file sees it."""
    import repro.launch.mesh as jmesh

    def shard_map(f, mesh, in_specs, out_specs):
        return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)

    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "enable_x64",
               lambda: jax.enable_x64(True), raising=False)
    mp.setattr(jmesh, "compat_shard_map", shard_map)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def small_net():
    """``tests/test_fleet_replay_decisions.py``'s net, in both packages."""
    from repro.core.inference import (Conv2D as JC, DenseFC as JD,
                                      MaxPool2D as JM, SimNet as JS,
                                      SparseFC as JSp)
    rng = np.random.default_rng(0)
    w1 = rng.normal(size=(3, 1, 3, 3)).astype(np.float32)
    wfc = (rng.normal(size=(8, 75)) * 0.1).astype(np.float32)
    wsp = (rng.normal(size=(5, 8))
           * (rng.random((5, 8)) < 0.35)).astype(np.float32)
    net = SimNet([
        Conv2D(w1, rng.normal(size=3).astype(np.float32)),
        MaxPool2D(2),
        DenseFC(wfc, rng.normal(size=8).astype(np.float32)),
        SparseFC(wsp, rng.normal(size=5).astype(np.float32), relu=False),
    ], input_shape=(1, 12, 12), name="decisions")
    x = rng.normal(size=(1, 12, 12)).astype(np.float32)
    kinds = {"Conv2D": JC, "DenseFC": JD, "MaxPool2D": JM, "SparseFC": JSp}
    layers = []
    for d in numpy_layers(net):
        d = dict(d)
        layers.append(kinds[d.pop("type")](**d))
    return net, JS(layers, input_shape=net.input_shape, name=net.name), x


def _same(a, b, names, tag=""):
    for ch in names:
        x, y = getattr(a, ch), getattr(b, ch)
        if x is None and y is None:
            continue
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} {ch}")


def _stats_rule(a, b, exact: bool, skip=()):
    """Counts, histograms and extremes exact; f64 moments bitwise when
    ``exact`` else to rtol 1e-12."""
    np.testing.assert_array_equal(a.count, b.count)
    np.testing.assert_array_equal(a.completed, b.completed)
    for ch in STAT_CHANNELS:
        if ch in skip:
            continue
        for f in ("mins", "maxs", "hists"):
            np.testing.assert_array_equal(getattr(a, f)[ch],
                                          getattr(b, f)[ch], err_msg=(f, ch))
        for f in ("sums", "sumsqs"):
            x, y = getattr(a, f)[ch], getattr(b, f)[ch]
            if exact:
                np.testing.assert_array_equal(x, y, err_msg=(f, ch))
            else:
                np.testing.assert_allclose(x, y, rtol=1e-12, atol=0,
                                           err_msg=(f, ch))
    if exact:
        np.testing.assert_array_equal(a.class_sums, b.class_sums)
    else:
        np.testing.assert_allclose(a.class_sums, b.class_sums, rtol=1e-12)


def test_one_shard_mesh_matches_unmeshed_and_jax(small_net):
    """The closed form over a (1,) mesh, 37 lanes."""
    net, jnet, x = small_net
    kw = dict(n_devices=37, seed=3)
    plain = tfs.fleet_sweep(net, x, "sonic", "1mF", device="cpu", **kw)
    shard = tfs.fleet_sweep(net, x, "sonic", "1mF", device="cpu",
                            mesh=make_fleet_mesh(device="cpu"), **kw)
    _same(plain, shard, SWEEP)
    jshard = jfs.fleet_sweep(jnet, x, "sonic", "1mF", mesh=jax_fleet_mesh(),
                             **kw)
    _same(shard, jshard, GRID)


def test_one_shard_mesh_capacitor_sweep(small_net):
    net, jnet, x = small_net
    caps = np.asarray([5e4, 1e6])
    plain = tfs.capacitor_sweep(net, x, caps, n_devices=9, seed=1,
                                device="cpu")
    shard = tfs.capacitor_sweep(net, x, caps, n_devices=9, seed=1,
                                device="cpu",
                                mesh=make_fleet_mesh(device="cpu"))
    _same(plain, shard, GRID)
    jshard = jfs.capacitor_sweep(jnet, x, caps, n_devices=9, seed=1,
                                 mesh=jax_fleet_mesh())
    _same(shard, jshard, GRID)


@pytest.mark.parametrize("lane_chunk", [None, 17])
def test_one_shard_mesh_stats_match_unmeshed_and_jax(small_net, lane_chunk):
    net, jnet, x = small_net
    kw = dict(n_devices=48, seed=3, charge_cv=0.25, charge_reboots=16,
              reduce="stats", lane_chunk=lane_chunk)
    st = tfs.fleet_sweep(net, x, "sonic", "1mF", device="cpu", **kw)
    sm = tfs.fleet_sweep(net, x, "sonic", "1mF", device="cpu",
                         mesh=make_fleet_mesh(device="cpu"), **kw)
    _stats_rule(st, sm, exact=True)
    jsm = jfs.fleet_sweep(jnet, x, "sonic", "1mF", mesh=jax_fleet_mesh(),
                          **kw)
    _stats_rule(sm, jsm, exact=True)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_shards_reduce_none_bitwise(small_net, n_shards):
    """A stochastic adaptive sweep with the radio on, 37 lanes (not a
    multiple of either shard count), the closed form, and a PlanSet design
    sweep: every array bitwise equal to the unmeshed call."""
    from repro_torch.runtime.radio import RadioModel, SEND_POLICIES, \
        pack_radio
    net, _jnet, x = small_net
    mesh = make_fleet_mesh(n_shards, device="cpu")
    radio = pack_radio(RadioModel(window_period_s=0.05, window_duty=0.3),
                       SEND_POLICIES[1])
    for kw in (dict(charge_cv=0.3, trace_reboots=8, policy="adaptive",
                    batch_rows=3, belief_alpha=0.2, radio=radio),
               dict(trace_reboots=4)):
        kw.update(n_devices=37, seed=5, device="cpu")
        plain = tfs.fleet_sweep(net, x, "tails", "100uF", **kw)
        shard = tfs.fleet_sweep(net, x, "tails", "100uF", mesh=mesh, **kw)
        _same(plain, shard, SWEEP, str(kw))
    plans = [tfs.build_plan(net, x, s, p)
             for s, p in (("sonic", "100uF"), ("tails", "1mF"),
                          ("tile-8", "1mF"))]
    ps = tfs.PlanSet.from_plans(plans)
    kw = dict(n_devices=7, seed=3, charge_cv=0.3, charge_reboots=16,
              device="cpu")
    plain = tfs.fleet_sweep(plan=ps, **kw)
    shard = tfs.fleet_sweep(plan=ps, mesh=mesh, **kw)
    _same(plain, shard, GRID + ("tx_bytes",), "design")


@pytest.mark.parametrize("n_shards", [2, 3])
def test_shards_capacitor_sweep_and_chunks(small_net, n_shards):
    net, _jnet, x = small_net
    mesh = make_fleet_mesh(n_shards, device="cpu")
    caps = np.asarray([5e4, 2e5, 1e6])
    kw = dict(n_devices=11, seed=1, charge_cv=0.2, device="cpu")
    plain = tfs.capacitor_sweep(net, x, caps, **kw)
    shard = tfs.capacitor_sweep(net, x, caps, mesh=mesh, **kw)
    _same(plain, shard, GRID)
    kw = dict(n_devices=40, seed=2, charge_cv=0.25, charge_reboots=16,
              lane_chunk=13, device="cpu")
    plain = tfs.fleet_sweep(net, x, "sonic", "1mF", **kw)
    shard = tfs.fleet_sweep(net, x, "sonic", "1mF", mesh=mesh, **kw)
    _same(plain, shard, SWEEP)


@pytest.mark.parametrize("n_shards", [2, 3])
def test_shards_stats_rule(small_net, n_shards):
    net, _jnet, x = small_net
    mesh = make_fleet_mesh(n_shards, device="cpu")
    kw = dict(n_devices=47, seed=3, charge_cv=0.25, charge_reboots=16,
              reduce="stats", device="cpu")
    _stats_rule(tfs.fleet_sweep(net, x, "sonic", "1mF", **kw),
                tfs.fleet_sweep(net, x, "sonic", "1mF", mesh=mesh, **kw),
                exact=False)
    kw["lane_chunk"] = 17
    _stats_rule(tfs.fleet_sweep(net, x, "sonic", "1mF", **kw),
                tfs.fleet_sweep(net, x, "sonic", "1mF", mesh=mesh, **kw),
                exact=False)
    caps = np.asarray([5e4, 1e6])
    ckw = dict(n_devices=9, seed=1, charge_cv=0.2, reduce="stats",
               device="cpu")
    a = tfs.capacitor_sweep(net, x, caps, **ckw)
    b = tfs.capacitor_sweep(net, x, caps, mesh=mesh, **ckw)
    _stats_rule(a, b, exact=False)
    np.testing.assert_array_equal(a.group_labels, b.group_labels)


def test_make_fleet_mesh_and_all_reduce():
    m = make_fleet_mesh(3, device="cpu")
    assert isinstance(m, FleetMesh) and mesh_chips(m) == 3
    assert m.axis_names == ("devices",)
    assert m.devices == (torch.device("cpu"),) * 3
    assert mesh_chips(make_fleet_mesh(device="cpu")) == 1
    with pytest.raises(ValueError, match="at least one shard"):
        make_fleet_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_fleet_mesh()
    part = ({"s": torch.tensor([1.0, 2.0])}, {"n": torch.tensor([3.0])},
            {"x": torch.tensor([4.0])})
    other = ({"s": torch.tensor([0.5, 0.25])}, {"n": torch.tensor([-1.0])},
             {"x": torch.tensor([9.0])})
    one = fleet_all_reduce([part])
    assert all(torch.equal(one[i][k], part[i][k])
               for i in range(3) for k in part[i])
    s, n, x = fleet_all_reduce([part, other])
    assert s["s"].tolist() == [1.5, 2.25]
    assert n["n"].tolist() == [-1.0] and x["x"].tolist() == [9.0]
    with pytest.raises(ValueError):
        fleet_all_reduce([])
