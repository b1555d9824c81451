"""The port's streamed chunk pipeline (``lane_chunk`` with ``prefetch``)
against its synchronous loop and the JAX package's, on the CPU.

Mirrors ``tests/test_overlap_pipeline.py``: ``prefetch >= 1`` (a producer
thread building chunk k+1 while chunk k replays, the statistics partials
folded into one accumulator by ``merge_parts``) must be bitwise equal to
``prefetch=0`` on every output, for ``reduce="stats"`` and
``reduce="none"``, across the strategy x policy x charge-jitter grid, a
final chunk that does not fill, the ``PlanSet`` plan-mode chunks,
``capacitor_sweep`` and ``replay_plans``' explicit trace matrices; the
recorded peak is the documented bound.  The chunked runs are also held
against the JAX package's (statistics of ``total_s`` apart, pinned in
``tests/test_torch_fleetstats.py``).  On the card the same holds with
the side-stream uploads (``tests/test_torch_cuda.py``).
"""

import sys
import threading

import jax
import jax.experimental
import numpy as np
import pytest

from repro.core import fleetsim as jfs
from repro_torch.convert import numpy_layers
from repro_torch.core import fleetsim as tfs
from repro_torch.core.fleetstats import FleetStats, STAT_CHANNELS
from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D, SimNet,
                                        SparseFC)


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
    """``tests/test_overlap_pipeline.py``'s net, in both packages."""
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
    ], input_shape=(1, 12, 12), name="pipenet")
    x = rng.normal(size=(1, 12, 12)).astype(np.float32)
    kinds = {"Conv2D": JC, "DenseFC": JD, "MaxPool2D": JM, "SparseFC": JSp}
    layers = []
    for d in numpy_layers(net):
        d = dict(d)
        layers.append(kinds[d.pop("type")](**d))
    jnet = JS(layers, input_shape=net.input_shape, name=net.name)
    return net, jnet, x


def _assert_stats_bitexact(a, b, skip=()):
    """Bitwise equality on every statistic (channels in ``skip`` apart)."""
    assert np.array_equal(a.count, b.count)
    assert np.array_equal(a.completed, b.completed)
    assert np.array_equal(a.class_sums, b.class_sums)
    for ch in STAT_CHANNELS:
        if ch in skip:
            continue
        for f in ("sums", "sumsqs", "mins", "maxs", "hists", "edges"):
            assert np.array_equal(getattr(a, f)[ch], getattr(b, f)[ch]), \
                (f, ch)


_SWEEP_CHANNELS = ("completed", "live_s", "dead_s", "reboots",
                   "energy_j", "wasted_cycles", "belief_cycles")


def _assert_sweep_bitexact(a, b):
    for ch in _SWEEP_CHANNELS:
        va, vb = getattr(a, ch), getattr(b, ch)
        if va is None:
            assert vb is None, ch
        else:
            assert np.array_equal(va, vb), ch


#: strategy x policy x charge-jitter grid: cv > 0 rides the event stream,
#: cv = 0 the closed-form scan
GRID = [
    ("sonic", "fixed", 0.0),
    ("sonic", "adaptive", 0.3),
    ("tails", "fixed", 0.3),
    ("tails", "adaptive", 0.0),
    ("tile-8", "adaptive", 0.5),
]


@pytest.mark.parametrize("strategy,policy,cv", GRID)
def test_prefetch_bitexact_grid(small_net, strategy, policy, cv):
    net, jnet, x = small_net
    kw = dict(n_devices=96, seed=5, policy=policy, theta=0.5,
              batch_rows=4 if policy == "adaptive" else 1,
              belief_alpha=0.25 if cv > 0 else 0.0,
              charge_cv=cv, charge_reboots=16 if cv > 0 else 0,
              trace_reboots=8, lane_chunk=32)
    s0 = tfs.fleet_sweep(net, x, strategy, "1mF", reduce="stats",
                         prefetch=0, device="cpu", **kw)
    s1 = tfs.fleet_sweep(net, x, strategy, "1mF", reduce="stats",
                         prefetch=1, device="cpu", **kw)
    _assert_stats_bitexact(s0, s1)
    r0 = tfs.fleet_sweep(net, x, strategy, "1mF", prefetch=0, device="cpu",
                         **kw)
    r1 = tfs.fleet_sweep(net, x, strategy, "1mF", prefetch=1, device="cpu",
                         **kw)
    _assert_sweep_bitexact(r0, r1)
    want = jfs.fleet_sweep(jnet, x, strategy, "1mF", prefetch=1, **kw)
    _assert_sweep_bitexact(r1, want)


def test_prefetch_nondivisible_final_chunk(small_net):
    """77 lanes in 32-lane chunks: the padded final chunk goes through the
    pipeline bitwise (inert lanes masked, outputs sliced), at depths past
    double buffering too."""
    net, _jnet, x = small_net
    kw = dict(n_devices=77, seed=9, charge_cv=0.2, charge_reboots=16,
              lane_chunk=32, device="cpu")
    s0 = tfs.fleet_sweep(net, x, "sonic", "1mF", reduce="stats",
                         prefetch=0, **kw)
    for depth in (1, 3):
        sd = tfs.fleet_sweep(net, x, "sonic", "1mF", reduce="stats",
                             prefetch=depth, **kw)
        _assert_stats_bitexact(s0, sd)
    r0 = tfs.fleet_sweep(net, x, "sonic", "1mF", prefetch=0, **kw)
    r1 = tfs.fleet_sweep(net, x, "sonic", "1mF", prefetch=1, **kw)
    _assert_sweep_bitexact(r0, r1)
    assert int(s0.count.sum()) == 77


def test_prefetch_peak_bound(small_net):
    """The recorded peak is the pipeline's bound: ``prefetch + 1`` chunk
    buffers plus one stats partial, as the JAX package records it."""
    from repro_torch.core.fleetstats import partial_nbytes

    net, jnet, x = small_net
    kw = dict(n_devices=96, seed=5, charge_cv=0.2, charge_reboots=16,
              lane_chunk=32, reduce="stats")
    p0 = tfs.fleet_sweep(net, x, "sonic", "1mF", prefetch=0, device="cpu",
                         **kw)
    p1 = tfs.fleet_sweep(net, x, "sonic", "1mF", prefetch=1, device="cpu",
                         **kw)
    partial = partial_nbytes(p0.edges, 1)
    assert p0.peak_lane_bytes < p1.peak_lane_bytes
    assert p1.peak_lane_bytes == 2 * p0.peak_lane_bytes + partial
    want = jfs.fleet_sweep(jnet, x, "sonic", "1mF", prefetch=1, **kw)
    assert p1.peak_lane_bytes == want.peak_lane_bytes


def test_planset_plan_mode_prefetch_bitexact(small_net):
    net, jnet, x = small_net
    ps = tfs.PlanSet.from_plans([tfs.build_plan(net, x, s, "1mF")
                                 for s in ("sonic", "tails")])
    kw = dict(n_devices=40, seed=4, charge_cv=0.1, charge_reboots=8,
              lane_chunk=32)                    # 80 lanes, padded tail
    s0 = tfs.fleet_sweep(plan=ps, reduce="stats", prefetch=0, device="cpu",
                         **kw)
    s1 = tfs.fleet_sweep(plan=ps, reduce="stats", prefetch=1, device="cpu",
                         **kw)
    _assert_stats_bitexact(s0, s1)
    d0 = tfs.fleet_sweep(plan=ps, prefetch=0, device="cpu", **kw)
    d1 = tfs.fleet_sweep(plan=ps, prefetch=1, device="cpu", **kw)
    _assert_sweep_bitexact(d0, d1)
    jps = jfs.PlanSet.from_plans([jfs.build_plan(jnet, x, s, "1mF")
                                  for s in ("sonic", "tails")])
    _assert_sweep_bitexact(d1, jfs.fleet_sweep(plan=jps, **kw))
    _assert_stats_bitexact(s1, jfs.fleet_sweep(plan=jps, reduce="stats",
                                               **kw), skip=("total_s",))


def test_capacitor_sweep_prefetch_bitexact(small_net):
    net, jnet, x = small_net
    kw = dict(capacities=[2e4, 1e5, 5e6], n_devices=30, seed=2,
              charge_cv=0.15, charge_reboots=8, lane_chunk=32)
    s0 = tfs.capacitor_sweep(net, x, reduce="stats", prefetch=0,
                             device="cpu", **kw)
    s1 = tfs.capacitor_sweep(net, x, reduce="stats", prefetch=1,
                             device="cpu", **kw)
    _assert_stats_bitexact(s0, s1)
    r0 = tfs.capacitor_sweep(net, x, prefetch=0, device="cpu", **kw)
    r1 = tfs.capacitor_sweep(net, x, prefetch=1, device="cpu", **kw)
    _assert_sweep_bitexact(r0, r1)
    _assert_sweep_bitexact(r1, jfs.capacitor_sweep(jnet, x, **kw))
    _assert_stats_bitexact(s1, jfs.capacitor_sweep(jnet, x, reduce="stats",
                                                   **kw), skip=("total_s",))


def _plan_batch(net, x):
    return [tfs.build_plan(net, x, s, p)
            for s in ("sonic", "tails") for p in ("1mF", "100uF")] * 5


def test_replay_plans_explicit_traces_chunked_bitexact(small_net):
    """Explicit ``recharge_traces``/``charge_traces`` ride ``lane_chunk``
    by slicing and reproduce the unchunked call bit for bit (a 20-lane
    batch in 8-lane chunks), prefetch on or off."""
    net, _jnet, x = small_net
    plans = _plan_batch(net, x)
    n = len(plans)
    rng = np.random.default_rng(7)
    rtr = rng.exponential(0.1, (n, 6))
    caps = np.asarray([p.capacity for p in plans])
    ctr = caps[:, None] * rng.lognormal(0.0, 0.2, (n, 8))
    kw = dict(policy="adaptive", theta=0.4, batch_rows=2,
              belief_alpha=0.1, recharge_traces=rtr, charge_traces=ctr,
              device="cpu")
    base = tfs.replay_plans(plans, **kw)
    for prefetch in (0, 1):
        got = tfs.replay_plans(plans, lane_chunk=8, prefetch=prefetch, **kw)
        assert got == base
    s0 = tfs.replay_plans(plans, reduce="stats", lane_chunk=8, prefetch=0,
                          **kw)
    s1 = tfs.replay_plans(plans, reduce="stats", lane_chunk=8, prefetch=1,
                          **kw)
    _assert_stats_bitexact(s0, s1)
    su = tfs.replay_plans(plans, reduce="stats", **kw)
    assert np.array_equal(su.count, s1.count)
    assert np.array_equal(su.completed, s1.completed)
    for ch in STAT_CHANNELS:
        np.testing.assert_allclose(su.sums[ch], s1.sums[ch], rtol=1e-12)
        assert np.array_equal(su.hists[ch], s1.hists[ch]), ch


def test_replay_plans_seeded_chunked_bitexact(small_net):
    net, _jnet, x = small_net
    plans = _plan_batch(net, x)
    kw = dict(seed=11, trace_reboots=4, charge_cv=0.2, recharge_cv=0.25,
              device="cpu")
    base = tfs.replay_plans(plans, **kw)
    got = tfs.replay_plans(plans, lane_chunk=8, **kw)
    assert got == base


def test_event_chunk_auto_matches_default(small_net):
    """``event_chunk="auto"`` (the JAX package's measured tuner) takes the
    plan-shape default in the port; the chunk only paces the plain event
    stream, so every result is the same bits."""
    net, _jnet, x = small_net
    kw = dict(n_devices=64, seed=3, charge_cv=0.2, charge_reboots=8,
              lane_chunk=32, reduce="stats", device="cpu")
    auto = tfs.fleet_sweep(net, x, "sonic", "1mF", event_chunk="auto", **kw)
    default = tfs.fleet_sweep(net, x, "sonic", "1mF", **kw)
    short = tfs.fleet_sweep(net, x, "sonic", "1mF", event_chunk=7, **kw)
    _assert_stats_bitexact(auto, default)
    _assert_stats_bitexact(short, default)


def test_prefetch_validation(small_net):
    net, _jnet, x = small_net
    with pytest.raises(ValueError, match="prefetch"):
        tfs.fleet_sweep(net, x, "sonic", "1mF", n_devices=8, lane_chunk=4,
                        prefetch=-1, device="cpu")
    with pytest.raises(ValueError, match="lane_chunk"):
        tfs.fleet_sweep(net, x, "sonic", "1mF", n_devices=8, lane_chunk=0,
                        device="cpu")


def test_producer_exception_reaches_the_caller(small_net, monkeypatch):
    """An exception while building a later chunk on the producer thread is
    raised by the sweep, and the thread is gone when the sweep returns."""
    net, _jnet, x = small_net
    real = tfs._prepare
    calls = []

    def failing(*a, **kw):
        calls.append(threading.current_thread().name)
        if len(calls) == 3:
            raise RuntimeError("chunk build failed")
        return real(*a, **kw)

    monkeypatch.setattr(tfs, "_prepare", failing)
    with pytest.raises(RuntimeError, match="chunk build failed"):
        tfs.fleet_sweep(net, x, "sonic", "1mF", n_devices=96, seed=5,
                        charge_cv=0.2, charge_reboots=8, lane_chunk=16,
                        reduce="stats", prefetch=1, device="cpu")
    assert calls[2] == "fleetsim-prefetch"
    assert not any(t.name == "fleetsim-prefetch" and t.is_alive()
                   for t in threading.enumerate())


def test_deep_pipeline_under_thread_switching(small_net):
    """Many small chunks through a deep pipeline with the interpreter
    switching threads every few microseconds: the same bits as the
    synchronous loop, and no producer left running."""
    net, _jnet, x = small_net
    kw = dict(n_devices=120, seed=6, charge_cv=0.3, charge_reboots=8,
              lane_chunk=8, reduce="stats", device="cpu")
    s0 = tfs.fleet_sweep(net, x, "sonic", "1mF", prefetch=0, **kw)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        s4 = tfs.fleet_sweep(net, x, "sonic", "1mF", prefetch=4, **kw)
    finally:
        sys.setswitchinterval(old)
    _assert_stats_bitexact(s0, s4)
    assert isinstance(s4, FleetStats) and int(s4.count.sum()) == 120
    assert not any(t.name == "fleetsim-prefetch" and t.is_alive()
                   for t in threading.enumerate())
