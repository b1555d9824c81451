"""The port's span registry (``repro_torch.runtime.spans``) on the CPU.

Off, a sweep records nothing and makes no CUDA event and no profiler
range; on, nested spans give the self time ``perfbench``'s host timer
gives, the overlapped pipeline's waits land on their threads, every
documented span of a design sweep, a chunked statistics sweep and the plan
build is recorded, no span count grows with a plan's rows, and the outputs
are bitwise those of spans off.  The card's side (events on the replay
stream and the stretches they time) runs here against
a fake CUDA clock; on the card the same sweeps run for real (``gpu``
marker, skipped without a card).
"""

import importlib.util
import threading
import time
from pathlib import Path
from types import ModuleType

import numpy as np
import pytest
import torch

from repro_torch.core import fleetsim as tfs
from repro_torch.core.inference import Conv2D, DenseFC, MaxPool2D, SimNet
from repro_torch.kernels import closed_form as cf
from repro_torch.runtime import spans

ROOT = Path(__file__).resolve().parents[1]

#: The spans a CPU run of each path records (on the card the closed form
#: is one kernel launch, with no ``closed_form/replay_loop``).
DESIGN_SPANS = {
    "entry/fleet_sweep", "entry/_design_sweep", "entry/legacy_draws",
    "entry/_run_replay", "entry/_prepare", "entry/_bucket_rows",
    "entry/_upload", "entry/_device_rows", "entry/_stats_inputs",
    "entry/_dispatch", "lane_kernel/charge_replay",
    "stats_fold/reduce_lane_outputs", "device_wait/parts_numpy",
    "samplers/initial_charge_fraction", "samplers/harvest_jitter",
    "samplers/reboot_recharge_times", "samplers/recharge_trace_cumulative",
    "samplers/charge_capacity_jitter", "samplers/charge_trace_cumulative",
    "samplers/pad_charge_trace_columns",
    "samplers/charge_trace_nominal_from"}
CHUNKED_SPANS = {
    "entry/fleet_sweep", "entry/_chunked_replay", "entry/_overlapped_replay",
    "entry/_prepare", "entry/_chunk_tensors", "entry/_upload",
    "entry/_stats_inputs", "entry/_device_rows", "entry/_dispatch",
    "entry/merge_parts", "entry/queue_wait", "entry/thread_join",
    "pipeline/setup_wait", "pipeline/slot_wait",
    "closed_form/_scan_replay", "closed_form/replay_loop",
    "stats_fold/reduce_lane_outputs",
    "device_wait/parts_numpy", "samplers/initial_charge_fraction_stream",
    "samplers/harvest_jitter_stream",
    "samplers/reboot_recharge_times_stream",
    "samplers/recharge_trace_cumulative"}
PLAN_SPANS = {"plan_build/build_plan", "plan_build/reference_run",
              "plan_build/rows", "plan_build/from_plans",
              "entry/_bucket_rows"}


@pytest.fixture(autouse=True)
def clean_registry():
    """Each test starts and ends with spans off and nothing recorded (a
    test worker runs other files in the same process)."""
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


def _net(width=3, side=12):
    rng = np.random.default_rng(0)
    feat = width * ((side - 2) // 2) ** 2
    net = SimNet([
        Conv2D((rng.normal(size=(width, 1, 3, 3)) * 0.3).astype(np.float32),
               rng.normal(size=width).astype(np.float32)),
        MaxPool2D(2),
        DenseFC((rng.normal(size=(5, feat)) * 0.1).astype(np.float32),
                rng.normal(size=5).astype(np.float32), relu=False),
    ], input_shape=(1, side, side), name=f"spans{width}")
    x = rng.normal(size=(1, side, side)).astype(np.float32)
    return net, x


@pytest.fixture(scope="module")
def plans():
    net, x = _net()
    tails = tfs.build_plan(net, x, "tails", "1mF")
    return tails, tfs.PlanSet.from_plans(
        [tails, tfs.build_plan(net, x, "sonic", "100uF")])


def _design(plans, device="cpu"):
    return tfs.fleet_sweep(plan=plans[1], n_devices=12, seed=5,
                           charge_cv=0.25, charge_reboots=8,
                           trace_reboots=4, reduce="stats", device=device)


def _chunked(plans, device="cpu", prefetch=1):
    return tfs.fleet_sweep(plan=plans[0], n_devices=40, seed=5,
                           trace_reboots=4, lane_chunk=8,
                           prefetch=prefetch, reduce="stats", device=device)


def _stats_equal(a, b):
    for f in ("count", "completed", "class_sums"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for d in ("sums", "sumsqs", "mins", "maxs", "hists", "edges"):
        for k, v in getattr(a, d).items():
            np.testing.assert_array_equal(v, getattr(b, d)[k], err_msg=k)


def _role(snap, key, role="caller"):
    return snap[key][role]


def test_off_records_nothing(plans, monkeypatch):
    """Spans off (the default): a design sweep and a chunked sweep under
    the profiler leave ``snapshot()`` empty, construct no CUDA event and
    no ``record_function``, and the trace holds no ``repro_torch:``
    range."""
    made = []

    def counting(real):
        def make(*a, **k):
            made.append(real)
            return real(*a, **k)
        return make

    monkeypatch.setattr(torch.cuda, "Event", counting(torch.cuda.Event))
    monkeypatch.setattr(torch.profiler, "record_function",
                        counting(torch.profiler.record_function))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _design(plans)
        _chunked(plans)
    assert spans.snapshot() == {}
    assert made == []
    assert not [e for e in prof.events()
                if e.name.startswith(spans.RANGE_PREFIX)]


def test_on_under_the_profiler_opens_ranges(plans):
    """Spans on while the profiler runs: the caller's spans are
    ``repro_torch:<layer>/<name>`` ranges."""
    spans.enable()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _chunked(plans)
    names = {e.name[len(spans.RANGE_PREFIX):] for e in prof.events()
             if e.name.startswith(spans.RANGE_PREFIX)}
    assert {"entry/fleet_sweep", "entry/queue_wait",
            "closed_form/replay_loop", "device_wait/parts_numpy"} <= names


def _load_hosttimer():
    path = ROOT / "perfbench" / "fleetbench" / "hosttimer.py"
    spec = importlib.util.spec_from_file_location("spans_hosttimer", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_self_time_as_the_host_timer_counts_it():
    """Nested spans: a span's self time is its wall time less the wall
    time of the spans nested in it, layer by layer as the benchmark's
    host timer counts the same calls from outside."""
    mod = ModuleType("spans_nested")

    @spans.traced("outer_layer")
    def outer():
        time.sleep(0.02)
        mod.inner()
        mod.inner()

    @spans.traced("inner_layer")
    def inner():
        time.sleep(0.005)
        with spans.span("inner_layer", "part"):
            time.sleep(0.005)

    mod.outer, mod.inner = outer, inner
    timer = _load_hosttimer().HostTimer(
        {"outer_layer": [(mod, "outer")], "inner_layer": [(mod, "inner")]})
    spans.enable()
    with timer:
        for _ in range(3):
            mod.outer()
    snap = spans.snapshot()
    o, i, p = (_role(snap, k) for k in (
        "outer_layer/outer", "inner_layer/inner", "inner_layer/part"))
    assert (o["calls"], i["calls"], p["calls"]) == (3, 6, 6)
    assert o["wall_s"] - o["self_s"] == pytest.approx(i["wall_s"], abs=1e-9)
    assert i["wall_s"] - i["self_s"] == pytest.approx(p["wall_s"], abs=1e-9)
    assert o["self_s"] >= 0.06 and p["self_s"] >= 0.03
    assert o["self_s"] == pytest.approx(timer.layer_s["outer_layer"],
                                        abs=5e-3)
    assert i["self_s"] + p["self_s"] == pytest.approx(
        timer.layer_s["inner_layer"], abs=5e-3)
    assert 0 <= o["self_cpu_s"] <= o["cpu_s"]


def test_pipeline_waits_by_thread(plans):
    """A CPU ``fleet_sweep`` in five chunks at ``prefetch=1``: the caller
    waits for each chunk (``queue_wait``) and joins the producer once; the
    producer waits for the sweep's tables and, from chunk 2 on, for a
    retired chunk's slot; the samplers run on both threads."""
    spans.enable()
    _chunked(plans)
    snap = spans.snapshot()
    assert set(snap["entry/queue_wait"]) & {"caller", "producer"} == \
        {"caller"}
    assert _role(snap, "entry/queue_wait")["calls"] == 5
    assert _role(snap, "entry/thread_join")["calls"] == 1
    assert set(snap["pipeline/slot_wait"]) & {"caller", "producer"} == \
        {"producer"}
    assert _role(snap, "pipeline/slot_wait", "producer")["calls"] == 3
    assert _role(snap, "pipeline/setup_wait", "producer")["calls"] == 4
    draw = snap["samplers/harvest_jitter_stream"]
    assert draw["caller"]["calls"] == 1 and draw["producer"]["calls"] == 4
    assert all("device_s" not in v for v in snap.values())


@pytest.mark.parametrize("path,expected", [
    ("design", DESIGN_SPANS), ("chunked", CHUNKED_SPANS),
    ("plan", PLAN_SPANS)])
def test_every_documented_span_is_recorded(plans, path, expected):
    """A design sweep (the lane kernel's path, the legacy draws), a chunked
    statistics sweep (the closed form, the pipeline) and a plan build
    record every span their path documents, and no other."""
    spans.enable()
    if path == "design":
        _design(plans)
    elif path == "chunked":
        _chunked(plans)
    else:
        net, x = _net()
        tfs.PlanSet.from_plans([tfs.build_plan(net, x, "tails", "1mF"),
                                tfs.build_plan(net, x, "sonic", "1mF")])
    snap = spans.snapshot()
    assert set(snap) == expected
    for key, v in snap.items():
        assert key == f"{v['layer']}/{v['name']}"
    host_only = {k for k, v in snap.items() if v["host_only"]}
    assert host_only == {k for k in expected if k.startswith("samplers/")
                         or k in ("entry/_prepare", "entry/_bucket_rows",
                                  "entry/legacy_draws", "entry/queue_wait")}


@pytest.mark.parametrize("path", ["design", "chunked"])
def test_outputs_bitwise_with_spans_on_and_off(plans, path):
    run = _design if path == "design" else _chunked
    off = run(plans)
    spans.enable()
    on = run(plans)
    spans.disable()
    _stats_equal(off, on)
    assert spans.snapshot()


def test_replay_rows_counts_rows_and_no_span_scales_with_them():
    """``_replay_rows.rows`` adds each closed-form call's rows (a chunk's
    plan rows); on the CPU the kernel is not launched; and every span's
    count is the same for a plan of a few hundred rows and one of
    thousands."""
    counts = []
    for width in (1, 6):
        net, x = _net(width=width)
        plan = tfs.build_plan(net, x, "tails", "1mF")
        rows0 = tfs._replay_rows.rows
        launches0 = cf.closed_form.launches
        spans.reset()
        spans.enable()
        tfs.fleet_sweep(plan=plan, n_devices=16, seed=1, lane_chunk=8,
                        prefetch=1, reduce="stats", device="cpu")
        spans.disable()
        assert tfs._replay_rows.rows - rows0 == 2 * len(plan)
        assert cf.closed_form.launches == launches0
        counts.append({k: {r: v[r]["calls"] for r in ("caller", "producer")
                           if r in v} for k, v in spans.snapshot().items()})
        counts[-1]["rows"] = len(plan)
    small, large = counts
    assert large.pop("rows") > 4 * small.pop("rows")
    assert small == large


# -- the operator's readings: chip_smoke.py and tools/smoke_phases.py --------

def _load(rel: str, name: str):
    """A script of the repo as a module (their module levels import the
    standard library only)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cs():
    return _load("chip_smoke.py", "spans_chip_smoke")


def test_host_report_reads_a_chunked_pipeline_snapshot(plans, cs):
    """``chip_smoke.host_report`` on a real snapshot of a five-chunk
    ``prefetch=1`` sweep: the caller's host work and its waits add up to
    its outermost span's wall time, the producer did host work, and each
    thread lists its own waits by name."""
    spans.enable()
    _chunked(plans)
    snap = spans.snapshot()
    rep = cs.host_report(snap)
    waits = sum(v["caller"]["self_s"] for k, v in snap.items()
                if k in cs.PIPELINE_WAITS and "caller" in v)
    assert rep["caller"]["s"] + waits == pytest.approx(
        _role(snap, "entry/fleet_sweep")["wall_s"], rel=1e-9)
    assert rep["producer"]["s"] > 0
    assert 0 <= rep["caller"]["cpu_s"] <= _role(
        snap, "entry/fleet_sweep")["cpu_s"] + 1e-9
    assert {"queue_wait", "thread_join", "fleet_sweep"} <= \
        set(rep["caller"]["by_function"])
    assert {"slot_wait", "setup_wait", "harvest_jitter_stream"} <= \
        set(rep["producer"]["by_function"])
    assert rep["producer"]["by_function"]["slot_wait"]["calls"] == 3


def test_span_report_of_a_cpu_sweep(plans, cs):
    """On the CPU no card times a span: ``host_gap_share`` is ``None``,
    the report has no replay loop reading, and every layer the chunked
    sweep ran reads its own host ms."""
    spans.enable()
    _chunked(plans)
    rep = cs.span_report(spans.snapshot(), 1, 1.0)
    assert rep["host_gap_share"] is None and rep["host_gap_ms_per_call"] \
        == {}
    assert "replay_loop" not in rep
    assert set(rep["self_ms_per_call"]) == {
        "entry", "samplers", "closed_form", "stats_fold", "device_wait"}
    assert all(v >= 0 for v in rep["self_ms_per_call"].values())
    assert set(rep["wait_ms_per_call"]) == set(cs.PIPELINE_WAITS)


def _hand_snapshot():
    """Two calls' worth of spans, as ``snapshot()`` gives them (the replay
    loop's block fields as the closed form's graph loop once gave them)."""
    def host(calls, wall, self_s):
        return dict(calls=calls, wall_s=wall, self_s=self_s, cpu_s=wall,
                    self_cpu_s=self_s)

    return {
        "entry/fleet_sweep": dict(layer="entry", name="fleet_sweep",
                                  host_only=False,
                                  caller=host(2, 4.0, 0.1), device_s=0.2),
        "entry/_prepare": dict(layer="entry", name="_prepare",
                               host_only=True, caller=host(4, 0.3, 0.1),
                               producer=host(2, 0.2, 0.1), device_s=0.05),
        "entry/queue_wait": dict(layer="entry", name="queue_wait",
                                 host_only=True, caller=host(4, 0.5, 0.5),
                                 device_s=0.01),
        "pipeline/slot_wait": dict(layer="pipeline", name="slot_wait",
                                   host_only=False,
                                   producer=host(2, 0.3, 0.3)),
        "samplers/harvest_jitter_stream": dict(
            layer="samplers", name="harvest_jitter_stream", host_only=True,
            caller=host(2, 0.2, 0.2), producer=host(2, 0.2, 0.2),
            device_s=0.14),
        "closed_form/replay_loop": dict(
            layer="closed_form", name="replay_loop", host_only=False,
            caller=host(4, 3.0, 3.0), device_s=3.2, blocks=10,
            block_rows=2500, block_s=3.2, fastest_s_per_row=1.2e-3,
            stall_s=0.2)}


@pytest.mark.parametrize("path,value", [
    (("self_ms_per_call", "entry"), 1e3 * (0.1 + 0.1 + 0.1) / 2),
    (("self_ms_per_call", "samplers"), 1e3 * 0.4 / 2),
    (("self_ms_per_call", "closed_form"), 1e3 * 3.0 / 2),
    (("wait_ms_per_call", "entry/queue_wait"), 1e3 * 0.5 / 2),
    (("wait_ms_per_call", "pipeline/slot_wait"), 1e3 * 0.3 / 2),
    (("host_gap_ms_per_call", "entry/_prepare"), 1e3 * 0.05 / 2),
    (("host_gap_share",), 100.0 * (0.05 + 0.01 + 0.14) / 5.0),
    (("replay_loop", "stall_ms_per_call"), None),
    (("replay_loop", "device_ms_per_call"), None),
])
def test_span_report_by_hand(cs, path, value):
    """Each reading of ``chip_smoke.span_report`` on a snapshot by hand:
    two calls of 5 s in all; the waits' time is no layer's host work, a
    span that is not ``host_only`` gives no host gap, and block fields
    give no ``replay_loop`` reading (``None``: the path is absent)."""
    got = cs.span_report(_hand_snapshot(), 2, 5.0)
    if value is None:
        assert path[0] not in got
        return
    for k in path:
        got = got[k]
    assert got == pytest.approx(value, rel=1e-12)
    assert "pipeline" not in cs.span_report(_hand_snapshot(), 2, 5.0)[
        "self_ms_per_call"]


def test_span_report_of_nothing(cs):
    rep = cs.span_report({}, 3, 1.0)
    assert rep == {"self_ms_per_call": {}, "wait_ms_per_call": {},
                   "host_gap_ms_per_call": {}, "host_gap_share": None}


def test_span_probe_on_the_cpu(cs):
    """``tools/smoke_phases.py spans`` at a toy size on the CPU: both
    paths' answers with spans on equal those off, the closed form counted
    each chunk's rows and launched no kernel, the plan build's parts are
    read, and spans are off and empty afterwards."""
    sp = _load("tools/smoke_phases.py", "spans_smoke_phases")
    net, x = _net()
    line = sp.span_probe(torch, np, cs, tfs, net, x, device="cpu",
                         devices=(12, 20), chunk=8, calls=2)
    plan = tfs.build_plan(net, x, "tails", "1mF")
    assert line["query"]["replay_rows"] == 2 * 3 * len(plan)
    assert line["query"]["kernel_launches"] == 0
    assert line["design"]["replay_rows"] == 0
    assert set(line["plan_build_spans_s"]) == {
        "build_plan", "reference_run", "rows", "from_plans"}
    assert line["plan_build_spans_s"]["reference_run"] < \
        line["plan_build_spans_s"]["build_plan"]
    for path in ("design", "query"):
        assert len(line[path]["wall_s"]) == 2
        assert line[path]["self_ms_per_call"]["entry"] > 0
        assert line[path]["self_ms_per_call"]["samplers"] > 0
    assert "entry/queue_wait" in line["query"]["wait_ms_per_call"]
    assert not spans.enabled() and spans.snapshot() == {}


# -- the card's side, against a fake CUDA clock ------------------------------

class FakeStream:
    """A card that runs queued work in order: ``busy_until`` is the host
    clock at which its queued work ends."""

    def __init__(self):
        self.device = torch.device("cuda", 0)
        self.cuda_stream = 7
        self.busy_until = 0.0

    def launch(self, seconds):
        self.busy_until = max(time.perf_counter(), self.busy_until) + seconds


class FakeEvent:
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at = None

    def record(self, stream):
        self.at = max(time.perf_counter(), stream.busy_until)

    def query(self):
        return self.at <= time.perf_counter()

    def synchronize(self):
        time.sleep(max(0.0, self.at - time.perf_counter()))

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


@pytest.fixture
def fake_card(monkeypatch):
    stream = FakeStream()
    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: stream)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    yield stream
    spans.reset()
    with spans._lock:
        spans._chains.clear()


@spans.traced("test", "sweep", device_arg="device")
def _sweep(body, device="cuda"):
    body()


def test_card_idle_goes_to_the_host_only_span_that_caused_it(fake_card):
    """The card's seconds between consecutive events go to the innermost
    open span: a host-only step on an idle card gets its whole length, one
    behind 50 ms of queued work gets none of it, and the launching span
    the work's length."""
    def body():
        with spans.span("test", "idle_host", host_only=True):
            time.sleep(0.03)
        with spans.span("test", "launch"):
            fake_card.launch(0.05)
        with spans.span("test", "hidden_host", host_only=True):
            time.sleep(0.02)
        time.sleep(0.04)                    # the card catches up

    spans.enable()
    _sweep(body)
    snap = spans.snapshot()
    idle = snap["test/idle_host"]
    assert idle["device_s"] == pytest.approx(idle["caller"]["wall_s"],
                                             abs=1e-3)
    assert snap["test/hidden_host"]["device_s"] == pytest.approx(0.0,
                                                                 abs=1e-3)
    assert snap["test/launch"]["device_s"] == pytest.approx(0.05, abs=1e-3)
    # the outermost span owns the stretches between its children (the
    # card idles after its work ends), and the stretches cover the sweep
    assert snap["test/sweep"]["device_s"] > 0
    assert sum(v["device_s"] for v in snap.values()) == pytest.approx(
        snap["test/sweep"]["caller"]["wall_s"], abs=2e-3)
    assert FakeEvent.made > 0


def test_no_event_without_a_card_from_the_producer_or_while_capturing(
        fake_card, monkeypatch):
    """No event where the outermost span names the CPU, on the pipeline's
    producer thread, or while the current stream captures a graph; spans
    off record none either."""
    def body():
        with spans.span("test", "part", host_only=True):
            pass

    spans.enable()
    _sweep(body, device="cpu")
    t = threading.Thread(target=_sweep, args=(body,),
                         name=spans.PRODUCER_THREAD)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    _sweep(body)
    spans.disable()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    _sweep(body)
    assert FakeEvent.made == 0
    snap = spans.snapshot()
    assert snap["test/part"]["caller"]["calls"] == 2
    assert snap["test/part"]["producer"]["calls"] == 1
    assert "device_s" not in snap["test/part"]


def test_blocks_give_the_stall_against_the_fastest(fake_card):
    """Launches in a loop inside a span, one of them 20 ms after the card
    ran out of queued work: the span reads the card's seconds of its
    launches, and carries no blocks and no stall (they went with the
    closed form's graph loop: ``spans`` has no ``block`` any longer)."""
    def body():
        with spans.span("test", "loop"):
            for k in range(4):
                if k == 2:
                    time.sleep(0.04)    # 20 ms past the queued work
                fake_card.launch(0.01)
            time.sleep(0.02)

    spans.enable()
    _sweep(body)
    loop = spans.snapshot()["test/loop"]
    assert not hasattr(spans, "block")
    assert {"blocks", "block_rows", "block_s", "fastest_s_per_row",
            "stall_s"}.isdisjoint(loop)
    assert loop["caller"]["calls"] == 1
    assert loop["device_s"] >= 0.04 - 1e-3


def test_pending_events_stay_bounded(fake_card):
    """Resolved on the way once ``RESOLVE_AT`` are pending, the events of
    a long span are reused from the pool."""
    def body():
        for _ in range(3 * spans.RESOLVE_AT):
            with spans.span("test", "tiny"):
                pass

    spans.enable()
    _sweep(body)
    (chain,) = spans._chains.values()
    assert len(chain.pending) < spans.RESOLVE_AT
    assert FakeEvent.made < 2 * spans.RESOLVE_AT
    assert spans.snapshot()["test/tiny"]["caller"]["calls"] == \
        3 * spans.RESOLVE_AT


# -- on the card -------------------------------------------------------------

@pytest.mark.gpu
def test_card_sweeps_time_the_card(plans):
    """On the card: a chunked closed-form sweep and a design sweep give
    the same bits with spans on and off; the host-only spans and the
    closed form's launches are timed on the card, and the closed form
    launched its kernel once a chunk, over the chunk's rows, and ran no
    row loop."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for run in (_chunked, _design):
        off = run(plans, device="cuda")
        launches = cf.closed_form.launches
        rows = tfs._replay_rows.rows
        spans.reset()
        spans.enable()
        on = run(plans, device="cuda")
        spans.disable()
        torch.cuda.synchronize()
        _stats_equal(off, on)
        snap = spans.snapshot()
        assert snap["entry/_prepare"]["device_s"] >= 0
        assert snap["entry/fleet_sweep"]["device_s"] > 0
        if run is _chunked:
            assert cf.closed_form.launches - launches == 5
            assert tfs._replay_rows.rows - rows == 5 * len(plans[0])
            assert snap["closed_form/_scan_replay"]["device_s"] > 0
            assert "closed_form/replay_loop" not in snap
        else:
            assert snap["lane_kernel/charge_replay"]["device_s"] > 0
