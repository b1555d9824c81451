"""The yardstick's bounds, floors and byte counts against hand counts, and
the metric readers and the trace reduction on made-up inputs."""

from types import SimpleNamespace

import numpy as np
import pytest

from perfbench_support import CELLS, runner, spec, tiny_cell
from benchcore import trace
from fleetbench import kernels, peaks
from fleetref import inputs as RI


def test_floors_and_peaks():
    assert peaks.MIN_F64_OPS_PER_EVENT == 140          # chip_smoke's floor
    assert peaks.MIN_F64_OPS_PER_ROW_CLOSED_FORM == 94
    assert peaks.PEAK_F64_OPS == 34e12 and peaks.PEAK_BYTES == 3.35e12
    assert peaks.LANE_OUT_BYTES == 8 * 26 + 1


def test_replay_bound_by_hand():
    t, by, info = peaks.replay_bound_s(1000, 500, 10, 100)
    assert info["f64_ops"] == 140_000 and info["bytes"] == 5000
    assert by == "operations" and t == pytest.approx(140_000 / 34e12)
    t, by, _ = peaks.replay_bound_s(1, 10**9, 10, 100)
    assert by == "bytes" and t == pytest.approx((8e9 + 1000) / 3.35e12)


def test_lane_and_fold_bytes_by_hand():
    assert peaks.lane_in_bytes(16, 65) == 40 + 8 + 8 * 17 + 8 * 65
    # 4 lanes x (8 x 25 + 6), edges 10 x 4 x 8, partial 2 x 89 x 8
    assert peaks.fold_bytes(4, 2, 3) == 4 * 206 + 320 + 1424


@pytest.mark.parametrize("workload", CELLS)
def test_traced_work_counts_real_rows(workload):
    cell = tiny_cell(workload)
    run = runner.Run(cell, None, 0.0, device="cpu")
    run.load_program()
    arrays = RI.network_arrays(cell.config)
    net = RI.build_net(cell.config, arrays, run.inference)
    from fleetbench import program
    caps = cell.traffic.get("capacities")
    plans = program.build_plans(run.fleetsim,
                                run.energy.make_power_system, net,
                                RI.network_input(cell.config),
                                cell.traffic["candidates"],
                                parametric=bool(caps))
    chunks = [dict(valid=np.ones(8, bool)), dict(valid=np.r_[[True] * 4,
                                                             [False] * 4])]
    w = run.traced_work(plans, chunks)
    sw = cell.traffic["sweep"]
    rows = [len(p) for p in plans]
    groups = len(caps) if caps else len(plans)
    assert w["lanes"] == sw["n_devices"] * groups
    assert w["lane_rows"] == sw["n_devices"] * (
        rows[0] * groups if caps else sum(rows))
    assert w["n_groups"] == groups
    # a parametric plan's tile tables: n, iter cycles and the selection
    # cost a candidate tile, and its 17-class iteration vector
    k_tiles = 20 * plans[0].tile_n.shape[1] if caps else 0
    width = [57 + 2 * p.entry_seg_class.shape[1] + k_tiles for p in plans]
    assert w["table_values"] == sum(r * k for r, k in zip(rows, width))
    assert w["fold_lanes"] == 12 and w["folds"] == 2
    if workload == "har.design-space":
        assert w["charge_wise"] and w["rows_replayed"] == 0
        assert w["lane_bytes"] == peaks.lane_in_bytes(16, 65) + 209
    else:
        assert not w["charge_wise"] and w["rows_replayed"] == 2 * rows[0]


class Ev:
    def __init__(self, name, s, d, cuda=True, ann=False, tid=1):
        self._n, self._s, self._d = name, s, d
        self._cuda, self._ann, self._tid = cuda, ann, tid

    def device_type(self):
        import torch
        return torch.autograd.DeviceType.CUDA if self._cuda \
            else torch.autograd.DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def end_ns(self):
        return self._s + self._d

    def is_user_annotation(self):
        return self._ann

    def start_thread_id(self):
        return self._tid


def test_trace_union_gaps_and_labels():
    ev = [Ev("perfbench:call", 0, 1000, cuda=False, ann=True),
          Ev("perfbench:_prepare", 0, 300, cuda=False, ann=True),
          Ev("perfbench:harvest_jitter", 600, 100, cuda=False, ann=True,
             tid=2),
          Ev("void charge_replay_kernel<1>(...)", 300, 200),
          Ev("perfbench:_dispatch", 0, 1000, ann=True),  # card-side copy
          Ev("fold_hist_kernel", 450, 100),
          Ev("Memcpy HtoD", 800, 100),
          Ev("aten::mul", 5000, 10)]                  # outside the window
    s = trace.summarize(ev)
    assert s["window_s"] == pytest.approx(1e-6)
    assert s["busy_s"] == pytest.approx(350e-9)       # 300-550, 800-900
    assert s["kernels"]["fold_hist_kernel"] == (1, pytest.approx(1e-7))
    assert "aten::mul" not in s["kernels"]
    assert [g[0] for g in s["idle_gaps"]] == [
        "caller:_prepare", "producer:harvest_jitter",
        "host outside the program's timed functions"]
    assert [g[1] for g in s["idle_gaps"]] == pytest.approx(
        [300e-9, 250e-9, 100e-9])
    assert kernels.kernel_time(s, lambda n: kernels.LANE_KERNEL in n) == \
        (1, pytest.approx(2e-7))


def fake_run(charge_wise):
    summary = dict(window_s=2.0, busy_s=1.5, kernels={
        "void charge_replay_kernel<3>": (1, 1.0),
        "fold_ordered_kernel": (2, 0.001),
        "void at::elementwise_kernel<...>": (300, 0.3),
        "Memcpy HtoD": (4, 0.01)})
    return SimpleNamespace(
        setup_s=12.5, plan_build_s=3.0, peaks=peaks, trace_module=kernels,
        calls=[dict(t0=1.0, t1=2.0, lanes=100), dict(t0=2.0, t1=5.0,
                                                     lanes=100)],
        host={"entry": 0.05, "samplers": 0.2}, trace=summary,
        traced=dict(charge_wise=charge_wise, lanes=100, lane_rows=10**6,
                    table_values=1000, lane_bytes=700, rows_replayed=100,
                    fold_lanes=100, folds=2, n_groups=1, bins=64))


def test_readers_by_hand():
    r = fake_run(True)
    val = {m: spec.reader(m)(r) for m in (
        "lanes_per_s", "setup_s", "plan_build_s", "host_ms_per_call",
        "sampler_ms_per_call", "device_idle", "replay_mfu",
        "charge_replay_roofline", "stats_fold_roofline",
        "closed_form.us_per_row", "closed_form.kernels_per_row")}
    assert val["lanes_per_s"] == pytest.approx(200 / 4.0)
    assert val["setup_s"] == 12.5 and val["plan_build_s"] == 3.0
    assert val["host_ms_per_call"] == pytest.approx(50.0)
    assert val["sampler_ms_per_call"] == pytest.approx(200.0)
    assert val["device_idle"] == pytest.approx(25.0)
    assert val["replay_mfu"] == pytest.approx(
        100 * 1.4e8 / 2.0 / 34e12)
    bound = max(1.4e8 / 34e12, (8000 + 70_000) / 3.35e12)
    assert val["charge_replay_roofline"] == pytest.approx(100 * bound)
    assert val["stats_fold_roofline"] == pytest.approx(
        100 * 2 * peaks.fold_bytes(50, 1, 64) / 3.35e12 / 0.001)
    assert val["closed_form.us_per_row"] is None      # charge-wise cell
    c = fake_run(False)
    assert spec.reader("charge_replay_roofline")(c) is None
    assert spec.reader("closed_form.us_per_row")(c) == pytest.approx(
        0.3e6 / 100)
    assert spec.reader("closed_form.kernels_per_row")(c) == 3.0
    assert spec.reader("replay_mfu")(c) == pytest.approx(
        100 * 9.4e7 / 2.0 / 34e12)


def test_readers_without_a_trace_read_nothing():
    r = fake_run(True)
    r.trace, r.host = None, None
    for m in ("host_ms_per_call", "sampler_ms_per_call", "device_idle",
              "replay_mfu", "charge_replay_roofline", "stats_fold_roofline",
              "closed_form.us_per_row", "closed_form.kernels_per_row"):
        assert spec.reader(m)(r) is None, m


@pytest.mark.parametrize("base", ["lanes_per_s", "host_ms_per_call",
                                  "sampler_ms_per_call",
                                  "stats_fold_roofline", "replay_mfu"])
def test_query_readers_read_as_their_base(base):
    """The query cells' metrics, split off for their own bound and moves,
    read exactly what their base reads, and nothing where it reads
    nothing."""
    name = "query_" + base if base == "lanes_per_s" else "query." + base
    for r in (fake_run(True), fake_run(False)):
        assert spec.reader(name)(r) == spec.reader(base)(r)
        r.trace, r.host = None, None
        assert spec.reader(name)(r) == spec.reader(base)(r)
