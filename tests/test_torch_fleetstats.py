"""The port's streamed statistics (``reduce="stats"``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_fleetstats.py``: ``reduce="stats"`` must be bitwise
equal on counts, sums, extremes and histograms to ``stats_from_outputs``
over the materialized outputs, chunked streaming must not depend on the
chunk size, and the numpy half (edges, merges, queries) must behave as the
JAX package's.  Each port run is also held against the same JAX run: every
statistic bitwise, except those of ``total_s``, which the JAX package
computes inside its jit, where XLA's CPU backend rounds ``live / 16e6 +
dead`` differently from numpy (``ROADMAP.md`` Queue 3 item 2); the pin for
``total_s`` is ``stats_from_outputs`` over the port's own outputs.  The
fold's plain version is held bitwise against the JAX package's
``reduce_lane_outputs`` and ``stats_from_outputs``.
"""

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from repro.core import fleetsim as jfs
from repro.core import fleetstats as jst
from repro_torch.convert import numpy_layers
from repro_torch.core import fleetsim as tfs
from repro_torch.core import fleetstats as tst
from repro_torch.core.energy import JOULES_PER_CYCLE, OP_CLASSES
from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D, SimNet,
                                        SparseFC)
from repro_torch.kernels.stats_fold import stats_fold, stats_fold_plain

STAT_CHANNELS = tst.STAT_CHANNELS


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
def small_net():
    """``tests/test_fleetstats.py``'s net, in both packages."""
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
    ], input_shape=(1, 12, 12), name="statsnet")
    x = rng.normal(size=(1, 12, 12)).astype(np.float32)
    return net, _jax_net(net), x


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


def _assert_stats_equal(a, b, *, skip=(), approx=(),
                        skip_class_sums=False):
    """Bitwise equality on every statistic; channels in ``skip`` are not
    compared, those in ``approx`` to 1e-12 relative on the moments and
    extremes (the JAX package's own grant for chunk reassociation)."""
    assert np.array_equal(a.count, b.count)
    assert np.array_equal(a.completed, b.completed)
    for ch in STAT_CHANNELS:
        if ch in skip:
            continue
        for f in ("sums", "sumsqs", "mins", "maxs"):
            x, y = getattr(a, f)[ch], getattr(b, f)[ch]
            if ch in approx:
                assert np.allclose(x, y, rtol=1e-12), (f, ch)
            else:
                assert np.array_equal(x, y), (f, ch)
        assert np.array_equal(a.hists[ch], b.hists[ch]), ch
        assert np.array_equal(a.edges[ch], b.edges[ch]), ch
    if not skip_class_sums:
        if approx:
            assert np.allclose(a.class_sums, b.class_sums, rtol=1e-12)
        else:
            assert np.array_equal(a.class_sums, b.class_sums)


def _assert_total_s_pinned(st, total_s, done, group_id=None):
    """``total_s``'s statistics against ``stats_from_outputs``'s reduction
    of the lanes' own ``live / CLOCK_HZ + dead`` (what a result's
    ``live_s + dead_s`` is, bit for bit)."""
    n = total_s.shape[0]
    out = {"live": np.zeros(n), "dead": total_s, "reboots": np.zeros(n),
           "wasted": np.zeros(n), "belief": np.zeros(n), "stuck": ~done,
           "classes": np.zeros((n, len(OP_CLASSES)))}
    edges = dict(st.edges, dead_s=st.edges["total_s"])
    ref = jst.stats_from_outputs(out, edges, group_id=group_id,
                                 n_groups=st.n_groups)
    for f in ("sums", "sumsqs", "mins", "maxs", "hists"):
        assert np.array_equal(getattr(st, f)["total_s"],
                              getattr(ref, f)["dead_s"]), f


def _raw(outs):
    """The replay output dict of materialized ``ReplayOut`` lanes."""
    classes = np.zeros((len(outs), len(OP_CLASSES)))
    for i, o in enumerate(outs):
        for j, c in enumerate(OP_CLASSES):
            classes[i, j] = o.by_class.get(c, 0.0)
    return {
        "live": np.array([o.live_cycles for o in outs]),
        "dead": np.array([o.dead_s for o in outs]),
        "reboots": np.array([o.reboots for o in outs], float),
        "wasted": np.array([o.wasted_cycles for o in outs]),
        "belief": np.array([o.belief_cycles for o in outs]),
        "stuck": np.array([not o.completed for o in outs]),
        "classes": classes,
        "tx_bytes": np.array([o.tx_bytes for o in outs]),
        "msgs_sent": np.array([o.msgs_sent for o in outs], float),
        "msgs_deferred": np.array([o.msgs_deferred for o in outs], float),
    }


def test_replay_plans_stats_bitexact_raw(small_net):
    """Raw outputs: every streamed statistic -- class sums and total_s
    included -- bitwise against ``stats_from_outputs`` over the port's own
    ``ReplayOut`` lanes, and against the JAX package's run apart from
    total_s."""
    from repro_torch.runtime.failures import charge_capacity_jitter

    net, jnet, x = small_net
    plan = tfs.build_plan(net, x, "sonic", "1mF")
    n = 24
    rng = np.random.default_rng(5)
    frac = 0.05 + 0.95 * rng.random(n)
    traces = charge_capacity_jitter(n, 16, plan.capacity, seed=11, cv=0.3)
    kw = dict(init_frac=frac, charge_traces=traces)
    outs = tfs.replay_plans([plan] * n, device="cpu", **kw)
    st = tfs.replay_plans([plan] * n, reduce="stats", device="cpu", **kw)
    ref = tst.stats_from_outputs(_raw(outs), st.edges)
    _assert_stats_equal(st, ref)
    assert st.count[0] == n
    jplan = jfs.build_plan(jnet, x, "sonic", "1mF")
    want = jfs.replay_plans([jplan] * n, reduce="stats", **kw)
    _assert_stats_equal(st, want, skip=("total_s",))
    assert st.peak_lane_bytes == want.peak_lane_bytes


@pytest.mark.parametrize("strategy,policy,cv", [
    ("sonic", "fixed", 0.0),
    ("sonic", "fixed", 0.25),
    ("sonic", "adaptive", 0.3),
    ("tails", "fixed", 0.25),
])
def test_stats_bitexact_vs_materialized(small_net, strategy, policy, cv):
    """Unchunked ``reduce="stats"`` draws the inputs of ``reduce="none"``:
    its statistics equal the JAX package's (total_s apart), and total_s's
    equal ``stats_from_outputs`` over the materialized lanes."""
    net, jnet, x = small_net
    kw = dict(n_devices=48, seed=3, policy=policy,
              charge_cv=cv, charge_reboots=16 if cv > 0 else 0)
    if policy == "adaptive":
        kw.update(theta=0.5, batch_rows=4, belief_alpha=0.25)
    r = tfs.fleet_sweep(net, x, strategy, "1mF", device="cpu", **kw)
    st = tfs.fleet_sweep(net, x, strategy, "1mF", reduce="stats",
                         device="cpu", **kw)
    want = jfs.fleet_sweep(jnet, x, strategy, "1mF", reduce="stats", **kw)
    _assert_stats_equal(st, want, skip=("total_s",))
    _assert_total_s_pinned(st, r.live_s + r.dead_s, r.completed)
    assert np.allclose(st.energy_j_sum, r.energy_j[r.completed].sum(),
                       rtol=1e-12)
    assert st.summary()["devices"] == 48


def test_stats_summary_matches_materialized_summary(small_net):
    net, _jnet, x = small_net
    kw = dict(n_devices=48, seed=3, charge_cv=0.25, charge_reboots=16,
              device="cpu")
    r = tfs.fleet_sweep(net, x, "sonic", "1mF", **kw)
    st = tfs.fleet_sweep(net, x, "sonic", "1mF", reduce="stats", **kw)
    s, ss = r.summary(), st.summary()
    assert ss["completed"] == s["completed"]
    assert ss["mean_reboots"] == pytest.approx(s["mean_reboots"])
    assert ss["mean_total_s"] == pytest.approx(s["mean_total_s"])
    width = st.edges["total_s"][1] - st.edges["total_s"][0]
    assert abs(ss["p95_total_s"] - s["p95_total_s"]) <= width


def test_chunked_invariant_to_chunk_size(small_net):
    """Chunked replay does not depend on ``lane_chunk`` (a chunk that
    does not divide the fleet pads the last one with inert lanes), and
    equals the JAX package's chunked run (total_s apart)."""
    net, jnet, x = small_net
    kw = dict(n_devices=50, seed=3, charge_cv=0.25, charge_reboots=16,
              reduce="stats")
    a = tfs.fleet_sweep(net, x, "sonic", "1mF", lane_chunk=50,
                        device="cpu", **kw)
    b = tfs.fleet_sweep(net, x, "sonic", "1mF", lane_chunk=17,
                        device="cpu", **kw)
    _assert_stats_equal(a, b, approx=STAT_CHANNELS)
    assert 0 < b.peak_lane_bytes < a.peak_lane_bytes
    want = jfs.fleet_sweep(jnet, x, "sonic", "1mF", lane_chunk=17, **kw)
    _assert_stats_equal(b, want, skip=("total_s",))
    assert b.peak_lane_bytes == want.peak_lane_bytes


def test_chunked_none_reduce_concatenates_bitexact(small_net):
    net, jnet, x = small_net
    kw = dict(n_devices=50, seed=3, charge_cv=0.25, charge_reboots=16)
    rn = tfs.fleet_sweep(net, x, "sonic", "1mF", lane_chunk=50,
                         device="cpu", **kw)
    rc = tfs.fleet_sweep(net, x, "sonic", "1mF", lane_chunk=17,
                         device="cpu", **kw)
    want = jfs.fleet_sweep(jnet, x, "sonic", "1mF", lane_chunk=17, **kw)
    for name in ("live_s", "dead_s", "reboots", "completed",
                 "wasted_cycles", "belief_cycles", "energy_j"):
        assert np.array_equal(getattr(rn, name), getattr(rc, name)), name
        assert np.array_equal(getattr(rc, name), getattr(want, name)), name


def test_capacitor_sweep_stats_groups(small_net):
    """One stats group per capacitor, bitwise the JAX package's (total_s
    apart) and consistent with the materialized grid."""
    net, jnet, x = small_net
    caps = [2e4, 1e5, np.inf]
    kw = dict(n_devices=8, seed=1, charge_cv=0.2, charge_reboots=16)
    cs = tfs.capacitor_sweep(net, x, caps, reduce="stats", device="cpu",
                             **kw)
    cn = tfs.capacitor_sweep(net, x, caps, device="cpu", **kw)
    assert cs.n_groups == 3
    assert np.array_equal(cs.group_labels, np.asarray(caps))
    assert np.array_equal(cs.count, np.full(3, 8.0))
    assert np.array_equal(cs.completed, cn.completed.sum(axis=1))
    done = cn.completed
    for g in range(3):
        assert cs.mean("reboots")[g] == pytest.approx(
            cn.reboots[g][done[g]].mean())
    _assert_total_s_pinned(cs, (cn.live_s + cn.dead_s).ravel(),
                           done.ravel(), np.repeat(np.arange(3), 8))
    want = jfs.capacitor_sweep(jnet, x, caps, reduce="stats", **kw)
    _assert_stats_equal(cs, want, skip=("total_s",))
    # the materialized grid equals the JAX package's, charge-wise and on
    # the closed form (no charge trace)
    for grid_kw in (kw, dict(n_devices=8, seed=1)):
        got = tfs.capacitor_sweep(net, x, caps, device="cpu", **grid_kw)
        ref = jfs.capacitor_sweep(jnet, x, caps, **grid_kw)
        for name in ("completed", "live_s", "dead_s", "reboots", "energy_j",
                     "wasted_cycles", "belief_cycles"):
            assert np.array_equal(getattr(got, name), getattr(ref, name)), \
                name
        assert np.array_equal(got.capacities, ref.capacities)


def test_merge_is_associative_and_checks_edges(small_net):
    net, _jnet, x = small_net
    kw = dict(seed=3, charge_cv=0.25, charge_reboots=16, reduce="stats",
              device="cpu")
    parts = [tfs.fleet_sweep(net, x, "sonic", "1mF", n_devices=n, **kw)
             for n in (16, 16, 16)]
    ab_c = parts[0].merge(parts[1]).merge(parts[2])
    a_bc = parts[0].merge(parts[1].merge(parts[2]))
    _assert_stats_equal(ab_c, a_bc, approx=STAT_CHANNELS)
    assert ab_c.count.sum() == 48
    bad = parts[1]
    bad.edges = {ch: e * 2.0 for ch, e in bad.edges.items()}
    with pytest.raises(ValueError, match="edges"):
        parts[0].merge(bad)


def test_percentile_and_queries(small_net):
    net, _jnet, x = small_net
    kw = dict(n_devices=48, seed=3, charge_cv=0.25, charge_reboots=16,
              device="cpu")
    st = tfs.fleet_sweep(net, x, "sonic", "1mF", reduce="stats", **kw)
    r = tfs.fleet_sweep(net, x, "sonic", "1mF", **kw)
    ch = "total_s"
    p0, p50, p100 = (st.percentile(ch, q)[0] for q in (0.0, 50.0, 100.0))
    assert p0 <= p50 <= p100
    width = st.edges[ch][1] - st.edges[ch][0]
    assert abs(p50 - np.percentile(r.total_s[r.completed], 50)) <= width
    assert st.completion_rate[0] == pytest.approx(r.completed.mean())
    assert st.std(ch)[0] == pytest.approx(r.total_s[r.completed].std(),
                                          rel=1e-6)
    assert st.energy_percentile(50.0)[0] == pytest.approx(
        st.percentile("live_cycles", 50.0)[0] * JOULES_PER_CYCLE)
    assert st.overhead_cycles.shape == (1,)
    assert (st.overhead_cycles >= 0).all()
    # the numpy half is the JAX package's: the same queries on the same
    # statistics give the same numbers
    mirror = jst.FleetStats(**{f: getattr(st, f) for f in (
        "count", "completed", "sums", "sumsqs", "mins", "maxs", "hists",
        "edges", "class_sums", "group_labels", "wall_s",
        "peak_lane_bytes")})
    for q in (5.0, 50.0, 95.0):
        assert np.array_equal(st.percentile(ch, q), mirror.percentile(ch, q))
    assert st.summary() == mirror.summary()


def test_default_edges_match_jax():
    for args in ((5e5, 1e4, 0.5, 16), (3e6, np.array([2e4, np.inf]),
                                       np.array([0.1, 0.4]), 64),
                 (1e3, np.inf, 0.0, 8)):
        got, want = tst.default_stat_edges(*args), \
            jst.default_stat_edges(*args)
        assert got.keys() == want.keys()
        for k in got:
            assert np.array_equal(got[k], want[k]), k
    edges = tst.default_stat_edges(5e5, 1e4, 0.5, 16)
    assert tst.partial_nbytes(edges, 3) == jst.partial_nbytes(edges, 3)


def test_reduce_argument_validated(small_net):
    net, _jnet, x = small_net
    with pytest.raises(ValueError, match="reduce"):
        tfs.fleet_sweep(net, x, "sonic", "1mF", n_devices=4,
                        reduce="median", device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        tfs.capacitor_sweep(net, x, [1e5], n_devices=4, reduce="median",
                            device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        tfs.replay_plans([tfs.build_plan(net, x, "sonic", "1mF")],
                         reduce="median", device="cpu")


# --------------------------------------------------------------------------
# The fold's plain version
# --------------------------------------------------------------------------

def _fold_case(n, groups, seed):
    rng = np.random.default_rng(seed)
    out = {"live": rng.integers(1, 10**6, n) * 1.0 + rng.random(n),
           "dead": rng.random(n) * 50,
           "reboots": rng.integers(0, 99, n) * 1.0,
           "wasted": rng.integers(0, 500, n) * 1.0,
           "belief": rng.random(n) * 1e4,
           "stuck": rng.random(n) < 0.1,
           "classes": rng.random((n, len(OP_CLASSES))) * 100,
           "tx_bytes": rng.random(n) * 30,
           "msgs_sent": rng.integers(0, 3, n) * 1.0,
           "msgs_deferred": rng.integers(0, 3, n) * 1.0}
    gid = rng.integers(0, groups, n).astype(np.int32)
    edges = jst.default_stat_edges(5e5, 1e4, 0.5, 16)
    return out, gid, edges


def _parts_equal(a, b):
    for x, y in zip(a, b):
        assert x.keys() == y.keys()
        for k in x:
            assert np.array_equal(np.asarray(x[k]), np.asarray(y[k])), k


@pytest.mark.parametrize("n,groups", [(1, 1), (300, 1), (301, 3), (64, 7)])
def test_fold_plain_equals_jax_reduce_and_oracle(n, groups):
    """The plain fold is bitwise the JAX package's ``reduce_lane_outputs``
    and ``stats_from_outputs`` (both add in lane order)."""
    from repro.core.fleetsim import _x64

    out, gid, edges = _fold_case(n, groups, seed=n)
    t_out = {k: torch.as_tensor(v) for k, v in out.items()}
    valid = np.ones(n, bool)
    got = tst.parts_numpy(stats_fold_plain(
        t_out, torch.as_tensor(gid), torch.as_tensor(valid), edges,
        groups))
    with _x64():
        import jax.numpy as jnp
        want = jst.reduce_lane_outputs(
            {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(gid),
            jnp.asarray(valid), {k: jnp.asarray(e) for k, e in
                                 edges.items()}, groups)
        want = jax.tree_util.tree_map(np.asarray, want)
    _parts_equal(got, want)
    _assert_stats_equal(tst.FleetStats.from_parts(got, edges),
                        jst.stats_from_outputs(out, edges, group_id=gid,
                                               n_groups=groups))
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = stats_fold.launches
    _parts_equal(tst.parts_numpy(stats_fold(
        t_out, torch.as_tensor(gid), torch.as_tensor(valid), edges,
        groups)), got)
    assert stats_fold.launches == before


def test_fold_masks_padding_and_drops_foreign_groups():
    """``valid=False`` lanes count nowhere and lanes outside ``[0,
    n_groups)`` are dropped, as the JAX package's scatter drops them."""
    out, gid, edges = _fold_case(200, 2, seed=9)
    valid = np.random.default_rng(1).random(200) < 0.8
    gid_bad = gid.copy()
    gid_bad[::7] = 5
    t_out = {k: torch.as_tensor(v) for k, v in out.items()}
    got = tst.FleetStats.from_parts(tst.parts_numpy(stats_fold_plain(
        t_out, torch.as_tensor(gid_bad), torch.as_tensor(valid), edges,
        2)), edges)
    keep = valid & (gid_bad < 2)
    ref = jst.stats_from_outputs({k: v[keep] for k, v in out.items()},
                                 edges, group_id=gid_bad[keep], n_groups=2)
    _assert_stats_equal(got, ref)


def test_fold_extremes_follow_numpy_order():
    """Min and max as ``stats_from_outputs``' ``minimum.at`` /
    ``maximum.at`` leave them: a tie takes the later lane's value (-0.0
    after +0.0 gives -0.0, and the other way round), and the first NaN a
    group meets stays; a NaN counts in the last bin, where numpy's
    ``searchsorted`` puts it."""
    out, gid, edges = _fold_case(12, 2, seed=4)
    gid = np.asarray([0, 1] * 6, np.int32)
    out["stuck"][:] = False
    out["wasted"][:] = [0.0, -0.0, -0.0, 0.0, 1.0, 1.0, 0.0, 2.0, 3.0, -0.0,
                        5.0, 7.0]
    out["belief"][4] = np.nan
    out["belief"][8] = -np.nan
    got = tst.FleetStats.from_parts(tst.parts_numpy(stats_fold_plain(
        {k: torch.as_tensor(v) for k, v in out.items()},
        torch.as_tensor(gid), torch.ones(12, dtype=torch.bool), edges, 2)),
        edges)
    ref = jst.stats_from_outputs(out, edges, group_id=gid, n_groups=2)
    for ch in ("wasted_cycles", "belief_cycles"):
        for f in ("mins", "maxs", "hists"):
            assert getattr(got, f)[ch].tobytes() == \
                np.asarray(getattr(ref, f)[ch]).tobytes(), (f, ch)
    assert np.signbit(got.mins["wasted_cycles"]).tolist() == [False, True]


def test_merge_parts_matches_host_merge():
    """A left fold of ``merge_parts`` is the host ``FleetStats.merge``
    bit for bit."""
    parts = []
    for seed in range(3):
        out, gid, edges = _fold_case(60, 2, seed=seed)
        parts.append(stats_fold_plain(
            {k: torch.as_tensor(v) for k, v in out.items()},
            torch.as_tensor(gid), torch.ones(60, dtype=torch.bool), edges,
            2))
    a, b, c = parts
    folded = tst.FleetStats.from_parts(tst.parts_numpy(
        tst.merge_parts(tst.merge_parts(a, b), c)), edges)
    host = tst.FleetStats.from_parts(tst.parts_numpy(a), edges).merge(
        tst.FleetStats.from_parts(tst.parts_numpy(b), edges)).merge(
        tst.FleetStats.from_parts(tst.parts_numpy(c), edges))
    _assert_stats_equal(folded, host)
