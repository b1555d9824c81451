"""GENESIS through the port (``repro_torch.compress``, ``core.imp``,
``data.synthetic``, ``kernels.ops.charge_replay``) against the JAX package,
on the CPU.

The rules, each stated where it is asserted:

* ``make_task``, ``svd_factor``, ``separate_conv_spatial``, ``hooi``,
  ``tucker2_conv``, ``layer_choices`` and ``apply_config`` (every layer's
  weights): bitwise -- numpy in both packages;
* ``AppModel``'s Eqs. 1-4 and ``accuracy_sweep``: bitwise;
* ``sweep``'s ``choices``, ``params``, ``params_bytes``, ``macs`` and
  ``feasible``: equal, with each package training its own nets;
* ``sweep``'s pricing (``e_infer_j``, ``completion``, ``impj``) with the
  JAX-trained nets carried across (the port's ``train`` and
  ``class_rates`` patched to return JAX's): bitwise;
* that pricing's ``latency_s`` (the mean ``total_s``): bitwise against the
  port's ``stats_from_outputs`` of its per-lane outputs, and within 2 ulp
  of JAX's, which folds ``total_s`` inside its jit (``ROADMAP.md`` Queue 3,
  item 2);
* ``estimate_energy`` in both modes, and ``pareto_frontier`` and ``select``
  on the same results: bitwise, the same candidates chosen;
* ``ops.charge_replay``: bitwise against the port's ``charge_replay`` and
  JAX's ``ops.charge_replay`` in interpret mode.

The port's own sweep is held only to what the JAX package's
``test_sweep_and_selection_small`` asserts: two frameworks' training runs
drift apart by more than this data can resolve.  The entry points that
make tensors raise without a card unless given ``device="cpu"``.
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from conftest import make_random_net
from repro.compress import genesis as jgen
from repro.compress import svd as jsvd, tucker as jtucker
from repro.core import AppModel as JAppModel, WILDLIFE as JWILD
from repro.core import accuracy_sweep as jaccuracy_sweep
from repro.core import fleetsim as jfs
from repro.core.inference import (Conv2D as JConv, DenseFC as JDense,
                                  MaxPool2D as JPool, SimNet as JNet,
                                  SparseFC as JSparse)
from repro.data import make_task as jmake_task, token_batches as jtokens
from repro.kernels import ops as jops
from repro_torch.compress import genesis as tgen
from repro_torch.compress import svd as tsvd, svm_baseline as tsvm
from repro_torch.compress import train_small as tts, tucker as ttucker
from repro_torch.convert import numpy_layers, plan_fields, plan_from_numpy
from repro_torch.core import AppModel, WILDLIFE, accuracy_sweep
from repro_torch.core import fleetsim as tfs
from repro_torch.core.fleetstats import stats_from_outputs
from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D, SimNet,
                                        SparseFC)
from repro_torch.data import make_task, token_batches
from repro_torch.kernels import charge_replay as tcr, ops as tops


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


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


_JCLS = {"Conv2D": JConv, "DenseFC": JDense, "MaxPool2D": JPool,
         "SparseFC": JSparse}
_TCLS = {"Conv2D": Conv2D, "DenseFC": DenseFC, "MaxPool2D": MaxPool2D,
         "SparseFC": SparseFC}


def _carry(net, classes, net_cls):
    """A simulator network rebuilt in the other package's classes."""
    layers = [classes[d.pop("type")](**d) for d in numpy_layers(net)]
    return net_cls(layers, net.input_shape, net.name)


def _same_layers(a, b, tag=""):
    assert len(a.layers) == len(b.layers), tag
    for i, (x, y) in enumerate(zip(numpy_layers(a), numpy_layers(b))):
        assert sorted(x) == sorted(y), (tag, i)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype, (tag, i, k)
                assert np.array_equal(x[k], y[k]), (tag, i, k)
            else:
                assert x[k] == y[k], (tag, i, k)


def _choices(cs):
    return [(c.kind, c.arg) for c in cs]


# ---------------------------------------------------------------- numpy half

@pytest.mark.parametrize("name", ["mnist", "har", "okg"])
@pytest.mark.parametrize("sign_flip", [False, True])
def test_make_task_bitwise(name, sign_flip):
    kw = dict(n_train=40, n_test=24, noise=0.7, seed=3, sign_flip=sign_flip)
    a, b = make_task(name, **kw), jmake_task(name, **kw)
    for f in ("x_train", "y_train", "x_test", "y_test"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.name == b.name and a.n_classes == b.n_classes


def test_token_batches_bitwise():
    for a, b in zip(token_batches(50, 2, 16, 3, seed=4),
                    jtokens(50, 2, 16, 3, seed=4)):
        assert np.array_equal(a["tokens"], b["tokens"])
        assert np.array_equal(a["labels"], b["labels"])


def _w(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


DECOMPOSITIONS = {
    "svd_factor": lambda m: m.svd_factor(_w(12, 20), 5),
    "svd_factor_full": lambda m: m.svd_factor(_w(7, 4, seed=1), 9),
    "separate_conv_spatial": lambda m: m.separate_conv_spatial(
        _w(6, 3, 5, 5, seed=2), 4),
    "hooi": lambda m: m.hooi(_w(8, 6, 5, 5, seed=3), [3, 4, 5, 5]),
    "tucker2_conv": lambda m: m.tucker2_conv(_w(8, 6, 3, 3, seed=4), 4, 3),
    "tucker_reconstruct": lambda m: m.tucker_reconstruct(
        *m.hooi(_w(5, 4, 3, 3, seed=5), [2, 2, 3, 3])),
}


def _flat(x):
    if isinstance(x, (list, tuple)):
        return [y for z in x for y in _flat(z)]
    return [x]


@pytest.mark.parametrize("name", sorted(DECOMPOSITIONS))
def test_decompositions_bitwise(name):
    mod = ttucker if name in ("hooi", "tucker2_conv", "tucker_reconstruct",
                              "separate_conv_spatial") else tsvd
    jmod = jtucker if mod is ttucker else jsvd
    got, want = _flat(DECOMPOSITIONS[name](mod)), \
        _flat(DECOMPOSITIONS[name](jmod))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _layers():
    """One layer of every kind GENESIS chooses for."""
    rng = np.random.default_rng(8)
    sp = rng.normal(size=(12, 30)).astype(np.float32)
    sp[rng.random(sp.shape) < 0.6] = 0.0
    return {
        "conv": Conv2D(rng.normal(size=(6, 1, 5, 5)).astype(np.float32),
                       rng.normal(size=6).astype(np.float32)),
        "deep_conv": Conv2D(rng.normal(size=(8, 4, 3, 3)).astype(np.float32),
                            rng.normal(size=8).astype(np.float32),
                            stride=2, relu=False),
        "pool": MaxPool2D(2),
        "dense": DenseFC(rng.normal(size=(40, 64)).astype(np.float32),
                         rng.normal(size=40).astype(np.float32)),
        "sparse": SparseFC(sp, rng.normal(size=12).astype(np.float32),
                           relu=False),
    }


@pytest.mark.parametrize("kind", sorted(_layers()))
def test_layer_choices_and_apply_bitwise(kind):
    """Every choice GENESIS offers for the layer (keep, prune, svd,
    separate), applied by both packages: the same replacement layers."""
    layer = _layers()[kind]
    net = SimNet([layer], (1, 8, 8), "one")
    jnet = _carry(net, _JCLS, JNet)
    got, want = tgen.layer_choices(layer), jgen.layer_choices(jnet.layers[0])
    assert _choices(got) == _choices(want)
    assert {c.kind for c in got} >= ({"keep"} if kind == "pool" else
                                     {"keep", "prune"})
    for c, jc in zip(got, want):
        _same_layers(tgen.apply_config(net, (c,)),
                     jgen.apply_config(jnet, (jc,)), (kind, c))


@pytest.mark.parametrize("kind", ["svd", "separate"])
def test_choice_kinds_apply_bitwise(kind):
    """The factorizing choices at ranks past the grid's."""
    layer = _layers()["dense" if kind == "svd" else "conv"]
    net = SimNet([layer], (1, 8, 8), "one")
    jnet = _carry(net, _JCLS, JNet)
    for rank in (1, 3, 64):
        _same_layers(tgen.apply_config(net, (tgen.LayerChoice(kind, rank),)),
                     jgen.apply_config(jnet, (jgen.LayerChoice(kind, rank),)),
                     rank)


def test_app_model_bitwise():
    models = [(AppModel(0.05, 1e-3, 2.3, 4e-3),
               JAppModel(0.05, 1e-3, 2.3, 4e-3)),
              (WILDLIFE, JWILD),
              (WILDLIFE.with_result_only_comm(98.0),
               JWILD.with_result_only_comm(98.0))]
    for m, jm in models:
        assert dataclasses.asdict(m) == dataclasses.asdict(jm)
        assert (m.baseline(), m.ideal(), m.oracle()) == \
            (jm.baseline(), jm.ideal(), jm.oracle())
        for tp, tn in ((0.9, 0.8), (0.5, 0.99), (1.0, 0.0)):
            assert m.inference(tp, tn) == jm.inference(tp, tn)
    accs = [0.5, 0.7, 0.9, 0.99]
    assert accuracy_sweep(WILDLIFE, accs) == jaccuracy_sweep(JWILD, accs)


# --------------------------------------------------------------- the sweep

def _mini():
    """``tests/test_compress.py``'s reduced MNIST net."""
    rng = np.random.default_rng(6)
    return SimNet([
        Conv2D(rng.normal(size=(6, 1, 5, 5)).astype(np.float32) * 0.3,
               np.zeros(6, np.float32)),
        MaxPool2D(2),
        DenseFC(rng.normal(size=(600, 864)).astype(np.float32) * 0.05,
                np.zeros(600, np.float32)),
        DenseFC(rng.normal(size=(10, 600)).astype(np.float32) * 0.1,
                np.zeros(10, np.float32), relu=False),
    ], (1, 28, 28), "mini")


SWEEP = dict(epochs=1, max_configs=6)


@pytest.fixture(scope="module")
def sweeps():
    """JAX's sweep; the port's own; and the port's with JAX's trained nets
    carried across, its PlanSet and statistics kept."""
    net = _mini()
    data = make_task("mnist", n_train=384, n_test=192, noise=0.8)
    jdata = jmake_task("mnist", n_train=384, n_test=192, noise=0.8)
    kept = {}
    jsweep = jfs.fleet_sweep

    def keep_jax(*a, **k):
        kept["jstats"] = jsweep(*a, **k)
        return kept["jstats"]

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jfs, "fleet_sweep", keep_jax)
        jres = jgen.sweep(_carry(net, _JCLS, JNet), jdata, JWILD, **SWEEP)
    finally:
        mp.undo()
    own = tgen.sweep(net, data, WILDLIFE, device="cpu", **SWEEP)

    # the JAX-trained nets, in training order, through the port's pricing
    trained = iter(jres)
    rates = iter(jres)
    tsweep = tfs.fleet_sweep

    def carried_train(cnet, data, **k):
        r = next(trained)
        _same_layers(_carry(cnet, _JCLS, JNet),
                     jgen.apply_config(_carry(net, _JCLS, JNet), r.choices))
        return _carry(r.net, _TCLS, SimNet), r.accuracy

    def carried_rates(tnet, data, positive, **k):
        r = next(rates)
        return r.tp, r.tn

    def keep_port(**k):
        kept["kw"] = k
        kept["stats"] = tsweep(**k)
        return kept["stats"]

    fold = tfs.reduce_lane_outputs

    def keep_lanes(out, *a):
        kept["lanes"] = {k: v.numpy() for k, v in out.items()}
        return fold(out, *a)

    try:
        mp.setattr(tts, "train", carried_train)
        mp.setattr(tts, "class_rates", carried_rates)
        mp.setattr(tfs, "fleet_sweep", keep_port)
        mp.setattr(tfs, "reduce_lane_outputs", keep_lanes)
        carried = tgen.sweep(net, data, WILDLIFE, device="cpu", **SWEEP)
    finally:
        mp.undo()
    return dict(jres=jres, own=own, carried=carried, **kept)


STRUCTURE = ("params", "params_bytes", "macs", "feasible")


@pytest.mark.parametrize("which", ["own", "carried"])
def test_sweep_structure_matches_jax(sweeps, which):
    res, jres = sweeps[which], sweeps["jres"]
    assert len(res) == len(jres) == 6
    for r, j in zip(res, jres):
        assert _choices(r.choices) == _choices(j.choices)
        assert [getattr(r, f) for f in STRUCTURE] == \
            [getattr(j, f) for f in STRUCTURE]


def test_sweep_pricing_bitwise_with_jax_nets(sweeps):
    for r, j in zip(sweeps["carried"], sweeps["jres"]):
        assert (r.accuracy, r.tp, r.tn) == (j.accuracy, j.tp, j.tn)
        assert (r.e_infer_j, r.completion, r.impj) == \
            (j.e_infer_j, j.completion, j.impj)
        _same_layers(r.net, j.net)


def test_sweep_latency_pinned_to_the_lanes(sweeps):
    """The mean ``total_s`` of each candidate equals the port's
    ``stats_from_outputs`` of the same sweep's per-lane outputs bitwise,
    and JAX's within 2 ulp."""
    kw, st = sweeps["kw"], sweeps["stats"]
    ps, n = kw["plan"], kw["n_devices"]
    ref = stats_from_outputs(sweeps["lanes"], st.edges,
                             group_id=np.repeat(np.arange(len(ps)), n),
                             n_groups=len(ps))
    assert np.array_equal(st.mean("live_cycles"), ref.mean("live_cycles"))
    want = ref.mean("total_s")
    got = np.asarray([r.latency_s for r in sweeps["carried"]])
    assert np.array_equal(got, want)
    jlat = np.asarray([r.latency_s for r in sweeps["jres"]])
    assert np.all(np.abs(got - jlat) <= 2 * np.spacing(jlat))


def test_sweep_selection_small(sweeps):
    """The JAX package's ``test_sweep_and_selection_small`` on the port's
    own sweep."""
    res = sweeps["own"]
    front = tgen.pareto_frontier(res)
    assert front, "empty Pareto frontier"
    accs = [r.accuracy for r in front]
    assert accs == sorted(accs)
    feasible = [r for r in res if r.feasible]
    if feasible:
        best = tgen.select(res)
        assert best.impj == max(r.impj for r in feasible)
        assert best.params_bytes <= tgen.DEVICE_WEIGHT_BYTES


def test_frontier_and_select_choose_the_same(sweeps):
    res, jres = sweeps["carried"], sweeps["jres"]
    front = [res.index(r) for r in tgen.pareto_frontier(res)]
    assert front == [jres.index(r) for r in jgen.pareto_frontier(jres)]
    feasible = [r for r in jres if r.feasible]
    if feasible:
        assert res.index(tgen.select(res)) == jres.index(jgen.select(jres))
    # and on results where every candidate fits, with ties broken alike
    for r, j in zip(res, jres):
        r.feasible = j.feasible = True
        r.impj = j.impj = round(r.e_infer_j * 1e6, 1)
    assert res.index(tgen.select(res)) == jres.index(jgen.select(jres))


def test_estimate_energy_stats_query_bitwise(sweeps):
    st, jst = sweeps["stats"], sweeps["jstats"]
    for g, r in enumerate(sweeps["carried"]):
        got = tgen.estimate_energy(None, stats=st, group=g, device="cpu")
        assert got == jgen.estimate_energy(None, stats=jst, group=g)
        assert got == r.e_infer_j
    with pytest.raises(ValueError, match="group"):
        tgen.estimate_energy(None, stats=st, device="cpu")


@pytest.mark.parametrize("runtime,power", [("tails", "continuous"),
                                           ("sonic", "1mF"),
                                           ("naive", "100uF")])
def test_estimate_energy_replay_bitwise(runtime, power):
    net, _x = make_random_net(2)
    tnet = _carry(net, _TCLS, SimNet)
    assert tgen.estimate_energy(tnet, runtime, power=power, device="cpu") \
        == jgen.estimate_energy(net, runtime, power=power)


# ------------------------------------------------------ ops.charge_replay

def test_ops_charge_replay_bitwise():
    """The thin entry point against the port's lane kernel wrapper and
    JAX's ``ops.charge_replay`` (Pallas, interpret mode), on the same
    prepared inputs: two jittered lanes of a sonic plan under adaptive
    commits."""
    from repro.runtime.failures import (charge_capacity_jitter,
                                        charge_trace_cumulative)

    net, x = make_random_net(0)
    plan = plan_from_numpy(plan_fields(jfs.build_plan(net, x, "sonic",
                                                      "1mF")))
    cap = max(2000.0, float(np.rint(0.15 * plan.total_cycles)))
    caps = np.full(2, cap)
    ccum = charge_trace_cumulative(
        charge_capacity_jitter(2, 12, cap, seed=11, cv=0.35))
    prep = tfs._prepare(tfs._plan_rows(plan), caps, caps * [0.4, 0.9], True,
                        None, None, "adaptive", 3, ccum, len(plan))
    args = [prep.caps, prep.rem0, prep.trace_cum, prep.tail_s,
            prep.charge_cum, prep.nominal_from, prep.s_real]
    flags = dict(adaptive=True, parametric=prep.parametric,
                 shared_rows=True, enable_fast=prep.enable_fast,
                 has_burn=prep.has_burn, has_send=False, chunk=prep.chunk)
    t_rows = {k: torch.tensor(np.asarray(v)) for k, v in prep.rows.items()}
    t_args = [torch.tensor(np.ascontiguousarray(a)) for a in args]
    got = tops.charge_replay(t_rows, *t_args, 0.5, 3, 0.2,
                             torch.tensor(prep.conf.copy()),
                             torch.tensor(prep.radio), interpret=True,
                             **flags)
    direct = tcr.charge_replay(t_rows, *t_args, 0.5, 3.0, 0.2,
                               conf=torch.tensor(prep.conf.copy()),
                               radio=torch.tensor(prep.radio), **flags)
    with jax.enable_x64(True):
        want = jops.charge_replay(prep.rows, *args, 0.5, 3.0, 0.2,
                                  prep.conf, prep.radio, interpret=True,
                                  **flags)
        want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want) == sorted(direct)
    for k in want:
        assert np.array_equal(got[k].numpy(), direct[k].numpy()), k
        assert np.array_equal(got[k].numpy(), want[k]), k


# --------------------------------------------------- no card, no fallback

ENTRY_POINTS = {
    "sweep": lambda: tgen.sweep(_mini(), make_task("mnist", 8, 8),
                                WILDLIFE, epochs=1, max_configs=1),
    "train": lambda: tts.train(_mini(), make_task("mnist", 8, 8), epochs=1),
    "train_svm": lambda: tsvm.train_svm(make_task("mnist", 8, 8)),
    "estimate_energy": lambda: tgen.estimate_energy(
        _carry(make_random_net(0)[0], _TCLS, SimNet)),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        ENTRY_POINTS[name]()
