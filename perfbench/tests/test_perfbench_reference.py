"""The reference against ``repro_torch``'s CPU path: the network, the plan
rows, each lane's inputs, and whole runs of each cell's traffic at a small
size."""

import json

import numpy as np
import pytest

from perfbench_support import CELLS, ROOT, cpu_run, result, tiny_cell
from fleetbench import check, program
from fleetref import inference as ref_inference
from fleetref import inputs as RI

from repro_torch.core import fleetsim
from repro_torch.core import inference as prog_inference
from repro_torch.core.energy import make_power_system
from repro_torch.models import dnn
from repro_torch.runtime import failures


def config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


@pytest.mark.parametrize("name", ["mnist", "har"])
def test_network_is_the_papers(name):
    cfg = config(name)
    got = RI.build_net(cfg, RI.network_arrays(cfg), prog_inference)
    want = dnn.NETWORKS[name](cfg["weights_seed"])
    assert got.name == want.name and got.input_shape == want.input_shape
    assert len(got.layers) == len(want.layers)
    for a, b in zip(got.layers, want.layers):
        assert type(a) is type(b)
        for k, v in vars(b).items():
            if isinstance(v, np.ndarray):
                assert np.array_equal(getattr(a, k), v), k
            else:
                assert getattr(a, k) == v, k
    assert got.shapes() == want.shapes()


def _rows_equal(plan, ref):
    assert set(ref["rows"]) == set(fleetsim._plan_rows(plan))
    for k, v in ref["rows"].items():
        assert np.array_equal(getattr(plan, k), v), k
    assert plan.capacity == ref["capacity"]
    assert plan.recharge_s == ref["recharge_s"]
    assert plan.total_cycles == ref["total_cycles"]


@pytest.mark.parametrize("workload", CELLS)
def test_plan_rows_of_the_tiny_net(workload):
    cell = tiny_cell(workload)
    arrays = RI.network_arrays(cell.config)
    x = RI.network_input(cell.config)
    net = RI.build_net(cell.config, arrays, prog_inference)
    parametric = bool(cell.traffic.get("capacities"))
    plans = program.build_plans(fleetsim, make_power_system, net, x,
                                cell.traffic["candidates"], parametric)
    refs = check.reference_plans(cell.config, arrays, x,
                                 cell.traffic["candidates"], parametric)
    assert all(p.parametric == parametric for p in plans)
    for p, r in zip(plans, refs):
        _rows_equal(p, r)
    assert check.plan_mismatches(plans, refs) == 0


@pytest.mark.parametrize("name,strategy,power", [
    ("har", "tails", "100uF"), ("har", "sonic", "1mF"),
    ("mnist", "tails", "1mF")])
def test_plan_rows_at_published_widths(name, strategy, power):
    cfg = config(name)
    arrays = RI.network_arrays(cfg)
    x = RI.network_input(cfg)
    plan = fleetsim.build_plan(RI.build_net(cfg, arrays, prog_inference), x,
                               strategy, power)
    from fleetref.plan import build_rows
    _rows_equal(plan, build_rows(RI.build_net(cfg, arrays, ref_inference),
                                 x, strategy, power))


@pytest.mark.parametrize("chunked", [False, True])
def test_lane_inputs_are_the_programs_draws(chunked):
    seed, dev = 2**40 + 3, 16
    sweep = dict(n_devices=dev, recharge_cv=0.25, charge_cv=0.25,
                 charge_reboots=8, trace_reboots=4)
    heads = [dict(capacity=1e5, recharge_s=0.03),
             dict(capacity=1e6, recharge_s=0.3)]
    if chunked:
        sweep["lane_chunk"] = 8
        lanes = np.arange(2 * dev)
        p = lanes // dev
        caps = np.asarray([h["capacity"] for h in heads])[p]
        rs = np.asarray([h["recharge_s"] for h in heads])[p]
        frac = failures.initial_charge_fraction_stream(2 * dev, seed=seed)
        jm = failures.harvest_jitter_stream(2 * dev, seed=seed)
        cum = failures.recharge_trace_cumulative(
            failures.reboot_recharge_times_stream(2 * dev, 4, rs, seed=seed)
            * jm[:, None])
        ccum = failures.charge_trace_cumulative(
            failures.charge_capacity_jitter_stream(2 * dev, 8, caps,
                                                   seed=seed))
    else:
        caps = np.repeat([1e5, 1e6], dev)
        rs = np.repeat([0.03, 0.3], dev)
        frac = np.tile(failures.initial_charge_fraction(dev, seed=seed), 2)
        jm = np.tile(failures.harvest_jitter(dev, seed=seed + 1), 2)
        cum = failures.recharge_trace_cumulative(np.concatenate([
            failures.reboot_recharge_times(dev, 4, r, seed=seed + 2)
            * jm[:dev, None] for r in (0.03, 0.3)]))
        ccum = failures.charge_trace_cumulative(np.concatenate([
            failures.charge_capacity_jitter(dev, 8, c, seed=seed + 3)
            for c in (1e5, 1e6)]))
    for lane in (0, 5, dev, 2 * dev - 1):
        li = RI.lane_inputs(sweep, heads, seed, lane, design=True)
        assert li["plan"] == lane // dev and li["cap"] == caps[lane]
        assert li["rem0"] == caps[lane] * frac[lane]
        assert li["tail_s"] == rs[lane] * jm[lane]
        assert np.array_equal(li["recharge_cum"], cum[lane])
        assert np.array_equal(li["charge_cum"], ccum[lane])


@pytest.mark.parametrize("workload", CELLS)
def test_a_run_on_the_cpu_is_correct(workload):
    rc, lines, err = cpu_run(tiny_cell(workload))
    assert rc == 0, err
    res = result(lines)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert all(c["value"] <= c["limit"] for c in res["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check lanes ")


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("charges", [False, True])
def test_capacitor_lanes_are_capacitor_sweeps_draws(chunked, charges):
    """Each lane of a capacitor sweep, capacitor-major, as
    ``capacitor_sweep`` draws it: its capacitor, ``rf_recharge_seconds``
    of it times the lane's jitter, and (with stochastic charges) its
    charge trace, from ``seed``, ``seed + 1`` and ``seed + 3`` unchunked
    and the counter-based streams chunked."""
    from repro_torch.core.energy import rf_recharge_seconds

    seed, dev = 2**40 + 7, 8
    caps = np.asarray([6e3, 2e4, 1e5, 1e6, 5e7])
    sweep = dict(n_devices=dev, recharge_cv=0.25)
    if charges:
        sweep.update(charge_cv=0.25, charge_reboots=8)
    if chunked:
        sweep["lane_chunk"] = 8
    lanes = caps.size * dev
    lane_caps = np.repeat(caps, dev)
    if chunked:
        frac = failures.initial_charge_fraction_stream(lanes, seed=seed)
        jm = failures.harvest_jitter_stream(lanes, seed=seed)
        ccum = failures.charge_trace_cumulative(
            failures.charge_capacity_jitter_stream(
                lanes, 8, lane_caps, seed=seed, cv=0.25))
    else:
        frac = failures.initial_charge_fraction(lanes, seed=seed)
        jm = failures.harvest_jitter(lanes, seed=seed + 1)
        ccum = failures.charge_trace_cumulative(
            failures.charge_capacity_jitter(lanes, 8, lane_caps,
                                            seed=seed + 3, cv=0.25))
    for lane in (0, 5, dev, 3 * dev + 1, lanes - 1):
        li = RI.capacitor_lane_inputs(sweep, caps, seed, lane)
        assert li["plan"] == 0 and li["cap"] == lane_caps[lane]
        assert li["rem0"] == lane_caps[lane] * frac[lane]
        assert li["tail_s"] == rf_recharge_seconds(lane_caps[lane]) * jm[lane]
        assert li["recharge_cum"] is None
        if charges:
            assert np.array_equal(li["charge_cum"], ccum[lane])
        else:
            assert li["charge_cum"] is None


def test_capacitor_sweep_answer_counts_every_capacitor():
    """A run of the capacitor mix replays the closed form once a call and
    never the lane kernel, and folds one group a capacitor."""
    cell = tiny_cell("har.capacitor-sweep")
    rc, lines, err = cpu_run(cell)
    assert rc == 0, err
    paths = json.loads(lines[0])["paths"]
    assert paths["charge_replay.launches"] == 0
    assert paths["closed_form.replays"] == json.loads(lines[0])["calls"]
    assert result(lines)["checks"]["count"]["value"] == 0
