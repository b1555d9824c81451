"""The port's ``PlanSet`` design sweeps against the JAX package's, on the
CPU.

Mirrors ``tests/test_planset.py`` (all but its ``backend="_while"`` case,
which the port does not have): one ``fleet_sweep`` over a ``PlanSet``
returns per-plan outputs bitwise equal to replaying every candidate alone
and to the JAX package's design sweep; its statistics groups, its
``lane_chunk`` invariance, the ``PlanSet`` header and ``from_plans``'
checks.  Below that the plain event stream's plan index
(``event_replay(..., plan_idx=)``) is held bitwise against the JAX
package's on the same packed candidates, and an index out of range is
refused.  Statistics of ``total_s`` are pinned to the port's own outputs,
as ``tests/test_torch_fleetstats.py`` explains.
"""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest
import torch

from conftest import make_random_net

from repro.core import fleetsim as jfs
from repro_torch.convert import plan_fields, plan_from_numpy
from repro_torch.core import fleetsim as tfs
from repro_torch.core.energy import JOULES_PER_CYCLE
from repro_torch.core.fleetstats import STAT_CHANNELS
from repro_torch.kernels import charge_replay as tcr

CHANNELS = ("completed", "live_s", "dead_s", "reboots", "energy_j",
            "wasted_cycles", "belief_cycles")

#: stochastic charges and recharge traces, so the design sweep runs the
#: event stream over the packed (P, S, F) candidates end to end
KW = dict(n_devices=8, seed=3, charge_cv=0.3, charge_reboots=16,
          trace_reboots=8)


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


def _design_plans():
    """8 candidates: 2 random nets x (sonic, tails) x (100uF, 1mF), built
    by the JAX package and carried across as numpy."""
    jplans = []
    for s in (0, 1):
        net, x = make_random_net(s)
        for strat in ("sonic", "tails"):
            for power in ("100uF", "1mF"):
                jplans.append(jfs.build_plan(net, x, strat, power))
    return jplans, [plan_from_numpy(plan_fields(p)) for p in jplans]


@pytest.fixture(scope="module")
def design():
    jplans, plans = _design_plans()
    ps = tfs.PlanSet.from_plans(plans)
    jps = jfs.PlanSet.from_plans(jplans)
    return plans, ps, tfs.fleet_sweep(plan=ps, device="cpu", **KW), jps


def test_planset_shapes_and_header(design):
    plans, ps, res, jps = design
    assert len(ps) == 8
    assert ps.rows["kind"].shape[0] == 8
    s_pad = ps.rows["kind"].shape[1]
    assert s_pad == tfs._bucket_target(max(len(p) for p in plans))
    assert np.array_equal(ps.n_rows, [len(p) for p in plans])
    assert ps.capacity.tolist() == [p.capacity for p in plans]
    assert ps.strategies == tuple(p.strategy for p in plans)
    assert res.completed.shape == (8, KW["n_devices"])
    # the same stacked tables and header as the JAX package's
    assert ps.rows.keys() == jps.rows.keys()
    for k in ps.rows:
        assert np.array_equal(ps.rows[k], jps.rows[k]), k
    for f in ("n_rows", "capacity", "recharge_s", "total_cycles"):
        assert np.array_equal(getattr(ps, f), getattr(jps, f)), f
    assert ps.labels == jps.labels and ps.strategies == jps.strategies
    assert not ps.parametric


def test_design_sweep_bit_exact_vs_individual_replays(design):
    """Every per-plan channel of the stacked sweep equals that plan's own
    fleet_sweep bit for bit."""
    plans, ps, res, _jps = design
    for p, plan in enumerate(plans):
        solo = tfs.fleet_sweep(plan=plan, device="cpu", **KW)
        for ch in CHANNELS:
            assert np.array_equal(getattr(res, ch)[p], getattr(solo, ch)), \
                (ch, ps.labels[p])


def test_design_sweep_matches_jax(design):
    plans, ps, res, jps = design
    want = jfs.fleet_sweep(plan=jps, **KW)
    for ch in CHANNELS + ("tx_bytes", "msgs_sent", "msgs_deferred",
                          "total_s"):
        assert np.array_equal(getattr(res, ch), getattr(want, ch)), ch
    assert res.labels == want.labels
    assert np.array_equal(res.capacities, want.capacities)
    assert res.replay_config[0] == "plan"
    got_rows, want_rows = res.summary(), want.summary()
    assert got_rows == want_rows


def test_design_sweep_stats_groups_match(design):
    """reduce='stats' gives one group per candidate, consistent with the
    materialized result and bitwise the JAX package's statistics (total_s
    pinned to the port's own lanes)."""
    from repro.core.fleetstats import stats_from_outputs

    plans, ps, res, jps = design
    st = tfs.fleet_sweep(plan=ps, reduce="stats", device="cpu", **KW)
    assert list(st.group_labels) == list(ps.labels)
    np.testing.assert_array_equal(st.completion_rate, res.completion_rate)
    np.testing.assert_allclose(
        st.mean("live_cycles"),
        res.energy_j.mean(axis=1) / JOULES_PER_CYCLE,
        rtol=1e-12)
    want = jfs.fleet_sweep(plan=jps, reduce="stats", **KW)
    for f in ("count", "completed", "class_sums"):
        assert np.array_equal(getattr(st, f), getattr(want, f)), f
    for ch in STAT_CHANNELS:
        if ch == "total_s":
            continue
        for f in ("sums", "sumsqs", "mins", "maxs", "hists"):
            assert np.array_equal(getattr(st, f)[ch],
                                  getattr(want, f)[ch]), (f, ch)
    n = res.completed.size
    out = {"live": np.zeros(n), "dead": res.total_s.ravel(),
           "reboots": np.zeros(n), "wasted": np.zeros(n),
           "belief": np.zeros(n), "stuck": ~res.completed.ravel(),
           "classes": np.zeros((n, tfs._N_CLASSES))}
    ref = stats_from_outputs(out, dict(st.edges, dead_s=st.edges["total_s"]),
                             group_id=np.repeat(np.arange(len(ps)),
                                                KW["n_devices"]),
                             n_groups=len(ps))
    for f in ("sums", "sumsqs", "mins", "maxs", "hists"):
        assert np.array_equal(getattr(st, f)["total_s"],
                              getattr(ref, f)["dead_s"]), f


def test_design_sweep_lane_chunk_invariant(design):
    """Streaming the plan-major lane axis in chunks does not change the
    per-plan statistics, and the chunked sweep equals the JAX package's
    (the ``*_stream`` draws)."""
    plans, ps, _res, jps = design
    a = tfs.fleet_sweep(plan=ps, reduce="stats", lane_chunk=16,
                        device="cpu", **KW)
    b = tfs.fleet_sweep(plan=ps, reduce="stats", lane_chunk=64,
                        device="cpu", **KW)
    for ch in ("live_cycles", "total_s"):
        np.testing.assert_array_equal(a.sums[ch], b.sums[ch])
    np.testing.assert_array_equal(a.completion_rate, b.completion_rate)
    jr = jfs.fleet_sweep(plan=jps, lane_chunk=24, **KW)
    tr = tfs.fleet_sweep(plan=ps, lane_chunk=24, device="cpu", **KW)
    for ch in CHANNELS:
        assert np.array_equal(getattr(tr, ch), getattr(jr, ch)), ch


def test_from_plans_validation(design):
    with pytest.raises(ValueError, match="at least one plan"):
        tfs.PlanSet.from_plans([])
    with pytest.raises(ValueError, match="at least one plan"):
        jfs.PlanSet.from_plans(())
    plan = design[0][0]
    with pytest.raises(ValueError, match="labels"):
        tfs.PlanSet.from_plans([plan, plan], labels=("only-one",))
    ps = tfs.PlanSet.from_plans([plan], labels=["solo"])
    assert ps.labels == ("solo",) and len(ps) == 1


def test_planset_requires_plan_or_net_args():
    with pytest.raises(ValueError):
        tfs.fleet_sweep(strategy="sonic", device="cpu")


def test_replay_plans_stream_draws_are_chunk_invariant(design):
    """replay_plans(seed=...) rides the Philox ``*_stream`` samplers, so
    splitting the plan batch at any ``lane_lo`` offset reproduces the
    whole-batch draws bit for bit."""
    plans = design[0][:6]
    kw = dict(seed=7, trace_reboots=8, charge_cv=0.3, charge_reboots=12,
              recharge_cv=0.4, device="cpu")
    whole = tfs.replay_plans(plans, **kw)
    split = (tfs.replay_plans(plans[:2], **kw)
             + tfs.replay_plans(plans[2:5], lane_lo=2, **kw)
             + tfs.replay_plans(plans[5:], lane_lo=5, **kw))
    for a, b in zip(whole, split):
        assert a == b


# --------------------------------------------------------------------------
# The plan index of the event stream
# --------------------------------------------------------------------------

def _plan_mode_inputs(ps, policy):
    """Seeded per-lane inputs of a plan-mode replay over ``ps``: 3 lanes a
    plan, plan-major, a capacity trace each."""
    from repro.runtime.failures import (charge_capacity_jitter,
                                        charge_trace_cumulative)

    pidx = np.repeat(np.arange(len(ps), dtype=np.int32), 3)
    caps = ps.capacity[pidx]
    rng = np.random.default_rng(4)
    rem0 = np.floor(caps * rng.uniform(0.05, 1.0, caps.shape[0]))
    ccum = charge_trace_cumulative(np.concatenate(
        [charge_capacity_jitter(3, 24, float(ps.capacity[p]), seed=p,
                                cv=0.3) for p in range(len(ps))]))
    kw = dict(policy=policy[0], theta=policy[1], batch_rows=policy[2],
              belief_alpha=policy[3])
    return pidx, caps, rem0, ccum, kw


@pytest.mark.parametrize("policy", [("fixed", 0.5, 1, 0.0),
                                    ("adaptive", 0.5, 4, 0.2)])
def test_event_replay_plan_idx_matches_jax(design, policy):
    """``event_replay(..., shared_rows="plan", plan_idx=)`` on the packed
    candidates, against the JAX package's event stream with the same plan
    index (its ``_run_replay`` in plan mode), every channel bitwise; and
    against the same lanes each given its own table."""
    jplans, _plans = _design_plans()
    plans, ps = design[0], design[1]
    jps = jfs.PlanSet.from_plans(jplans)
    pidx, caps, rem0, ccum, kw = _plan_mode_inputs(ps, policy)
    want = jfs._run_replay(jps.rows, caps, rem0, "plan", charge_cum=ccum,
                           n_rows=jps.n_rows[pidx], plan_idx=pidx, **kw)
    prep = tfs._prepare(ps.rows, caps, rem0, "plan", charge_cum=ccum,
                        n_rows=ps.n_rows[pidx], plan_idx=pidx,
                        policy=kw["policy"], batch_rows=kw["batch_rows"])
    t = tfs._upload(prep, torch.device("cpu"))
    rows = {k: torch.as_tensor(v) for k, v in prep.rows.items()}
    args = (rows, t["caps"], t["rem0"], t["trace_cum"], t["tail_s"],
            t["charge_cum"], t["nominal_from"], t["s_real"], kw["theta"],
            float(kw["batch_rows"]), kw["belief_alpha"])
    flags = dict(adaptive=prep.adaptive, parametric=prep.parametric,
                 enable_fast=prep.enable_fast, has_burn=prep.has_burn,
                 conf=t["conf"], radio=t["radio"])
    got = tcr.event_replay(*args, shared_rows="plan",
                           plan_idx=t["plan_idx"], **flags)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    # the same lanes, each with its candidate's table as its own
    own = {k: v[pidx.astype(np.int64)] for k, v in rows.items()}
    lane = tcr.event_replay(own, *args[1:], shared_rows=False, **flags)
    for k, v in got.items():
        assert torch.equal(v, lane[k]), k


def test_plan_index_out_of_range_raises(design):
    ps = design[1]
    pidx, caps, rem0, ccum, kw = _plan_mode_inputs(
        ps, ("fixed", 0.5, 1, 0.0))
    prep = tfs._prepare(ps.rows, caps, rem0, "plan", charge_cum=ccum,
                        n_rows=ps.n_rows[pidx], plan_idx=pidx)
    t = tfs._upload(prep, torch.device("cpu"))
    rows = {k: torch.as_tensor(v) for k, v in prep.rows.items()}
    args = (rows, t["caps"], t["rem0"], t["trace_cum"], t["tail_s"],
            t["charge_cum"], t["nominal_from"], t["s_real"], 0.5, 1.0, 0.0)
    flags = dict(adaptive=False, parametric=False, shared_rows="plan")
    for bad in (len(ps), -1):
        idx = t["plan_idx"].clone()
        idx[-1] = bad
        with pytest.raises(ValueError, match="plan_idx"):
            tcr.event_replay(*args, plan_idx=idx, **flags)
        with pytest.raises(ValueError, match="plan_idx"):
            tcr.charge_replay(*args, plan_idx=idx, **flags)
    with pytest.raises(ValueError, match="plan_idx"):
        tcr.event_replay(*args, **flags)          # plan mode needs it
    with pytest.raises(ValueError, match="plan_idx"):
        tfs._prepare(ps.rows, caps, rem0, "plan")
    # the streamed pipeline's launches skip the wrapper's read-back checks:
    # the host half refuses the same bounds before the upload
    bad = pidx.copy()
    bad[0] = len(ps)
    with pytest.raises(ValueError, match="plan_idx"):
        tfs._prepare(ps.rows, caps, rem0, "plan", charge_cum=ccum,
                     n_rows=ps.n_rows[pidx], plan_idx=bad)
    with pytest.raises(ValueError, match="n_rows"):
        tfs._prepare(ps.rows, caps, rem0, "plan", charge_cum=ccum,
                     n_rows=np.full(pidx.shape, 10**6), plan_idx=pidx)


def test_parametric_planset_matches_jax():
    """A pack of parametric (TAILS, tile tables) candidates restamped over
    capacitors: the stacked tile tables replay in plan mode bitwise as the
    JAX package replays them."""
    net, x = make_random_net(1)
    jbase = jfs.build_plan(net, x, "tails", "1mF", parametric=True)
    jplans = [dataclasses.replace(jbase, capacity=c)
              for c in (3000.0, 8000.0, 2.0e4)]
    plans = [plan_from_numpy(plan_fields(p)) for p in jplans]
    kw = dict(n_devices=6, seed=2, charge_cv=0.3, charge_reboots=16,
              policy="adaptive", batch_rows=2, belief_alpha=0.2)
    ps = tfs.PlanSet.from_plans(plans)
    assert ps.parametric
    got = tfs.fleet_sweep(plan=ps, device="cpu", **kw)
    want = jfs.fleet_sweep(plan=jfs.PlanSet.from_plans(jplans), **kw)
    for ch in CHANNELS:
        assert np.array_equal(getattr(got, ch), getattr(want, ch)), ch
