"""The closed form (``fleetsim._scan_replay``, deterministic replays): on
the CPU the plain loop of ``_scan_step`` a row, on the card one launch of
``closed_form_kernel`` (``csrc/closed_form.cu``).

On the CPU: the plain path is the row loop and counts its rows; the
kernel's wrapper (``kernels.closed_form.closed_form``) hands the library
the strides, flags and block each row mode needs and counts one launch,
refuses every tensor it does not take before any launch, and a CUDA
tensor never takes the CPU path (the table's rows counted all the
same); and ``_dispatch`` reaches the closed form through the module, so
a stand-in swapped there sees every call.  On the card
(``gpu`` marker, skipped without one): the kernel equals the aten closed
form (``chip_smoke.aten_graph_scan``: ``_scan_step`` on the card, a row's
launches replayed from a CUDA graph) bitwise on every channel, in each
row mode, policy and row kind, and counts its launches and rows exactly.
"""

import importlib.util
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import fleetsim as tfs
from repro_torch.core.energy import custom_power_system
from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D, SimNet,
                                        SparseFC)
from repro_torch.kernels import charge_replay as cr
from repro_torch.kernels import closed_form as cf
from repro_torch.runtime.failures import recharge_trace_cumulative
from repro_torch.runtime.radio import RadioModel, SEND_POLICIES, pack_radio

ROOT = Path(__file__).resolve().parents[1]

RADIO = pack_radio(RadioModel(window_period_s=0.05, window_duty=0.3),
                   SEND_POLICIES[1])


def _net(seed=3):
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(3, 1, 3, 3)) * 0.5).astype(np.float32)
    wfc = (rng.normal(size=(6, 48)) * 0.2).astype(np.float32)
    wsp = (rng.normal(size=(4, 6)) * (rng.random((4, 6)) < 0.5)
           ).astype(np.float32)
    net = SimNet([Conv2D(w1, rng.normal(size=3).astype(np.float32)),
                  MaxPool2D(2),
                  DenseFC(wfc, rng.normal(size=6).astype(np.float32)),
                  SparseFC(wsp, rng.normal(size=4).astype(np.float32),
                           relu=False)],
                 input_shape=(1, 10, 10), name=f"closed{seed}")
    return net, rng.normal(size=(1, 10, 10)).astype(np.float32)


@pytest.fixture(scope="module")
def plans():
    """A shared tails plan, its parametric twin and a plan with BURN
    rows."""
    net, x = _net(1)
    return dict(tails=tfs.build_plan(net, x, "tails", "1mF"),
                param=tfs.build_plan(net, x, "tails", "1mF",
                                     parametric=True),
                burn=tfs.build_plan(net, x, "tails",
                                    custom_power_system(3000)))


def _inputs(rows, caps, shared_rows, plan_idx=None, policy="fixed",
            radio=None, device="cpu", seed=0):
    """One closed-form call's prepared inputs, as ``_dispatch`` gets them:
    ``(prep, tensors, device rows)``."""
    rng = np.random.default_rng(seed)
    n = caps.shape[0]
    cum = recharge_trace_cumulative(rng.exponential(0.01, (n, 9)))
    prep = tfs._prepare(rows, caps, caps * rng.uniform(0.05, 1.0, n),
                        shared_rows, cum, rng.uniform(1e-3, 1e-2, n), policy,
                        1, None, None, None, rng.uniform(0.0, 1.0, n),
                        radio, plan_idx)
    assert not prep.stochastic
    dev = torch.device(device)
    return (prep, tfs._upload(prep, dev),
            tfs._device_rows(prep.rows, dev, shared_rows, False))


def _scan_args(prep, t, rows, shared_rows):
    args = (rows, t["caps"], t["rem0"], t["trace_cum"], t["tail_s"], 0.5,
            t["conf"], t["radio"])
    kw = dict(adaptive=prep.adaptive, parametric=prep.parametric,
              shared_rows=shared_rows, has_send=prep.has_send,
              plan_idx=t.get("plan_idx"))
    return args, kw


def _mode_case(plans, mode, uplink=False):
    """Rows, capacities, ``shared_rows`` and plan index of a row mode over
    the three plans (a lane of continuous power among them), with the
    uplink's SEND rows where ``uplink``."""
    ps = tfs.PlanSet.from_plans([
        tfs.with_uplink(p) if uplink else p
        for p in (plans["tails"], plans["param"], plans["burn"])])
    n = 11
    pidx = (np.arange(n) % 3).astype(np.int32)
    caps = ps.capacity[pidx].copy()
    caps[4] = np.inf
    if mode == "plan":
        return ps.rows, caps, "plan", pidx
    if mode == "lane":
        return {k: v[pidx] for k, v in ps.rows.items()}, caps, False, None
    return {k: v[1] for k, v in ps.rows.items()}, caps, True, None


def _same(a, b, tag=""):
    assert set(a) == set(b)
    for k in a:
        x, y = a[k].cpu(), b[k].cpu()
        assert x.dtype == y.dtype and x.shape == y.shape, (tag, k)
        if x.dtype == torch.float64:
            x, y = x.view(torch.int64), y.view(torch.int64)
        assert torch.equal(x, y), (tag, k)


# -- on the CPU ---------------------------------------------------------------

def test_cpu_path_is_the_row_loop_and_counts_rows(plans, monkeypatch):
    """CPU tensors take the plain version: ``_scan_step`` once a row of the
    table, the same bits as stepping it by hand, ``_replay_rows.rows``
    adds the table's rows and no kernel launch is counted."""
    rows, caps, shared_rows, pidx = _mode_case(plans, "lane")
    prep, t, drows = _inputs(rows, caps, shared_rows, policy="adaptive")
    args, kw = _scan_args(prep, t, drows, shared_rows)
    s_pad = rows["kind"].shape[1]

    steps = []
    step = tfs._scan_step
    monkeypatch.setattr(tfs, "_scan_step",
                        lambda *a, **k: steps.append(1) or step(*a, **k))
    launches, counted = cf.closed_form.launches, tfs._replay_rows.rows
    got = tfs._scan_replay(*args, **kw)
    assert len(steps) == s_pad
    assert tfs._replay_rows.rows - counted == s_pad
    assert cf.closed_form.launches == launches

    packed, layout = cr._packed(drows, shared_rows)
    st = tfs._scan_state0(t["caps"], t["rem0"])
    for i in range(s_pad):
        cursor = torch.full((caps.shape[0],), i, dtype=torch.int64)
        st = step(t["caps"], t["trace_cum"], t["tail_s"], 0.5, t["conf"],
                  t["radio"], prep.adaptive, prep.parametric, prep.has_send,
                  st, cr.unpack_row(packed, layout, cursor))
    _same(got, tfs._scan_outputs(st))


class _Library:
    """Stands in for the built library: records ``closed_form_launch``'s
    arguments and returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def closed_form_launch(self, *a):
        self.calls.append(a)
        return self.err


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(cf, "_library", lambda: lib)
    monkeypatch.setattr(cf, "stream", lambda dev: 0)
    return lib


def _launch(args, kw, table=None):
    packed, layout = cr._packed(args[0], kw["shared_rows"])
    if table is not None:
        packed = table(packed)
    return cf.closed_form(
        packed, layout, *args[1:], adaptive=kw["adaptive"],
        parametric=kw["parametric"], mode=cr.row_mode(kw["shared_rows"]),
        has_send=kw["has_send"], plan_idx=kw["plan_idx"])


@pytest.mark.parametrize("mode", ["shared", "lane", "plan"])
@pytest.mark.parametrize("policy,radio", [("fixed", None),
                                          ("adaptive", RADIO)])
def test_wrapper_hands_the_kernel_its_layout(plans, fake_lib, mode, policy,
                                             radio):
    """The wrapper's launch in each row mode: the row-major table, a lane
    stride of 0 (one shared table) or S * F, the plan index only in plan
    mode, every row of the table, the flags, ``lane_block`` lanes a block,
    the 11 outputs; one launch counted (its S rows are counted by
    ``_scan_replay``, which calls it)."""
    rows, caps, shared_rows, pidx = _mode_case(plans, mode,
                                               uplink=radio is not None)
    prep, t, drows = _inputs(rows, caps, shared_rows, pidx, policy, radio)
    assert prep.has_send == (radio is not None)
    drows = cr.PackedRows(drows, shared_rows)
    args, kw = _scan_args(prep, t, drows, shared_rows)
    packed, layout = cr._packed(drows, shared_rows)
    s_pad, f = packed.shape[-2:]
    launches, counted = cf.closed_form.launches, tfs._replay_rows.rows
    out = _launch(args, kw)
    assert cf.closed_form.launches - launches == 1
    assert tfs._replay_rows.rows == counted     # _scan_replay counts rows
    (a,) = fake_lib.calls
    n = caps.shape[0]
    assert a[0] == packed.data_ptr()
    assert a[1] == (0 if mode == "shared" else s_pad * f)
    assert a[2] == s_pad
    assert (a[3] is None) == (mode != "plan")
    assert list(a[4]) == cr._layout_ints(
        layout, f, dict((k, s) for k, _o, s in layout)[
            "entry_seg_cycles"][0], cr._K_TILES if prep.parametric else 0)
    assert a[13:16] == (int(prep.adaptive), int(prep.parametric),
                        int(prep.has_send))
    assert a[10] == 0.5 and a[8] == t["trace_cum"].shape[1]
    assert a[-3:] == (n, cr.lane_block(n), 0)
    assert list(out) == list(cr.OUTPUTS)
    assert [v.data_ptr() for v in out.values()] == list(a[16:27])
    assert out["classes"].shape == (n, tfs._N_CLASSES)
    assert out["stuck"].dtype == torch.bool


def test_wrapper_counts_no_launch_without_lanes(plans, fake_lib):
    """No lanes: nothing to run, no launch counted, empty outputs."""
    rows, caps, shared_rows, _ = _mode_case(plans, "shared")
    prep, t, drows = _inputs(rows, caps[:0], shared_rows)
    args, kw = _scan_args(prep, t, drows, shared_rows)
    launches = cf.closed_form.launches
    out = _launch(args, kw)
    assert cf.closed_form.launches == launches
    assert all(v.shape[0] == 0 for v in out.values())


def test_wrapper_raises_when_the_launch_fails(plans, fake_lib):
    """A refused launch raises and is not counted."""
    fake_lib.err = 1
    rows, caps, shared_rows, _ = _mode_case(plans, "shared")
    prep, t, drows = _inputs(rows, caps, shared_rows)
    args, kw = _scan_args(prep, t, drows, shared_rows)
    launches = cf.closed_form.launches
    with pytest.raises(RuntimeError, match="closed_form kernel launch"):
        _launch(args, kw)
    assert cf.closed_form.launches == launches


def _bad(fault, args, kw):
    """``args``/``kw`` of a closed-form call with one fault planted, and
    what becomes of its packed table."""
    args, kw, table = list(args), dict(kw), None
    rows, cap, rem0, trace_cum, tail_s, theta, conf, radio = args
    if fault == "f32_cap":
        args[1] = cap.float()
    elif fault == "short_rem0":
        args[2] = rem0[:-1]
    elif fault == "list_rem0":
        args[2] = rem0.tolist()
    elif fault == "rem0_elsewhere":
        args[2] = rem0.to("meta")
    elif fault == "strided_trace":
        args[3] = torch.cat([trace_cum, trace_cum], 1)[:, ::2]
    elif fault == "empty_trace":
        args[3] = trace_cum[:, :0]
    elif fault == "int_tail":
        args[4] = tail_s.to(torch.int64)
    elif fault == "conf_2d":
        args[6] = conf[:, None]
    elif fault == "radio_short":
        args[7] = radio[:-1]
    elif fault == "plan_idx_without_plan":
        kw["plan_idx"] = torch.zeros(cap.shape[0], dtype=torch.int32)
    elif fault == "f32_table":
        table = lambda p: p.float()                     # noqa: E731
    elif fault == "strided_table":
        table = lambda p: p.T.contiguous().T            # noqa: E731
    elif fault == "table_of_a_pack":
        table = lambda p: p[None]                       # noqa: E731
    elif fault == "wrong_classes":
        args[0] = dict(rows, entry_class=rows["entry_class"][:, :-1])
    elif fault == "parametric_flag_flipped":
        kw["parametric"] = not kw["parametric"]
    return tuple(args), kw, table


FAULTS = ("f32_cap", "short_rem0", "list_rem0", "rem0_elsewhere",
          "strided_trace", "empty_trace", "int_tail", "conf_2d",
          "radio_short", "plan_idx_without_plan", "f32_table",
          "strided_table", "table_of_a_pack", "wrong_classes",
          "parametric_flag_flipped")


@pytest.mark.parametrize("fault", FAULTS)
def test_wrapper_refuses_what_the_kernel_does_not_take(plans, fake_lib,
                                                       fault):
    """Every tensor the kernel does not take raises before the launch:
    nothing reaches the library and no launch is counted."""
    rows, caps, shared_rows, _ = _mode_case(plans, "shared")
    prep, t, drows = _inputs(rows, caps, shared_rows)
    args, kw, table = _bad(fault, *_scan_args(prep, t, drows, shared_rows))
    launches, counted = cf.closed_form.launches, tfs._replay_rows.rows
    with pytest.raises((TypeError, ValueError)):
        _launch(args, kw, table)
    assert fake_lib.calls == []
    assert cf.closed_form.launches == launches
    assert tfs._replay_rows.rows == counted


def test_wrapper_refuses_per_lane_rows_of_another_fleet(plans, fake_lib):
    """Per-lane rows must hold one table a lane; a plan index must be
    int32."""
    rows, caps, shared_rows, _ = _mode_case(plans, "lane")
    prep, t, drows = _inputs(rows, caps, shared_rows)
    args, kw = _scan_args(prep, t, drows, shared_rows)
    cut = ({k: v[:-1] for k, v in drows.items()},) + args[1:]
    with pytest.raises(ValueError, match="per-lane rows"):
        _launch(cut, kw)
    rows, caps, shared_rows, pidx = _mode_case(plans, "plan")
    prep, t, drows = _inputs(rows, caps, shared_rows, pidx)
    args, kw = _scan_args(prep, t, drows, shared_rows)
    with pytest.raises(TypeError, match="plan_idx"):
        _launch(args, dict(kw, plan_idx=kw["plan_idx"].long()))
    assert fake_lib.calls == []


def test_other_devices_are_refused_and_cuda_never_takes_the_loop(
        plans, monkeypatch):
    """Tensors on neither the CPU nor a card raise; CUDA tensors go to the
    kernel's launch, never to the row loop (here the launch is a stand-in,
    as no card is asked for), and the table's rows are counted."""
    rows, caps, shared_rows, _ = _mode_case(plans, "shared")
    prep, t, drows = _inputs(rows, caps, shared_rows)
    args, kw = _scan_args(prep, t, drows, shared_rows)
    meta = (args[0], args[1].to("meta")) + args[2:]
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfs._scan_replay(*meta, **kw)

    launched = []
    monkeypatch.setattr(cf, "closed_form",
                        lambda *a, **k: launched.append(k["mode"]) or {})
    rows_before = tfs._replay_rows.rows
    monkeypatch.setattr(tfs, "_replay_rows",
                        lambda *a, **k: pytest.fail("the row loop ran"))
    tfs._replay_rows.rows = rows_before
    cuda_cap = types.SimpleNamespace(device=torch.device("cuda", 0),
                                     shape=args[1].shape)
    tfs._scan_replay(args[0], cuda_cap, *args[2:], **kw)
    assert launched == ["shared"]
    assert tfs._replay_rows.rows - rows_before == \
        cr._packed(args[0], shared_rows)[0].shape[-2]


@pytest.mark.parametrize("entry", ["chunked", "replay_plans",
                                   "capacitor_sweep", "radio"])
def test_dispatch_reaches_the_closed_form_through_the_module(plans,
                                                             monkeypatch,
                                                             entry):
    """``_dispatch`` calls ``fleetsim._scan_replay`` through the module:
    a stand-in swapped there (as the benchmark's harness swaps one) sees
    every closed-form call of a deterministic entry point, a chunk at a
    time, and the answers are those without it."""
    net, x = _net(1)
    run = {
        "chunked": lambda: tfs.fleet_sweep(
            plan=plans["tails"], n_devices=20, seed=3, lane_chunk=8,
            prefetch=1, reduce="stats", device="cpu"),
        "replay_plans": lambda: tfs.replay_plans(
            [plans["tails"], plans["param"]], policy="adaptive",
            device="cpu"),
        "capacitor_sweep": lambda: tfs.capacitor_sweep(
            net, x, [6e3, 2e4, 1e5], n_devices=4, seed=2, device="cpu"),
        "radio": lambda: tfs.fleet_sweep(
            plan=plans["tails"], n_devices=6, seed=4, radio=RADIO,
            device="cpu"),
    }[entry]
    calls = {"chunked": 3, "replay_plans": 1, "capacitor_sweep": 1,
             "radio": 1}[entry]
    want = run()
    seen = []
    real = tfs._scan_replay

    def stand_in(*a, **k):
        seen.append(a[1].shape[0])
        return real(*a, **k)

    monkeypatch.setattr(tfs, "_scan_replay", stand_in)
    got = run()
    assert len(seen) == calls
    if entry == "chunked":
        assert seen == [8, 8, 8]        # the last chunk padded to 8
        for f in ("count", "completed", "class_sums"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        for k, v in want.sums.items():
            np.testing.assert_array_equal(got.sums[k], v)
    elif entry == "replay_plans":
        assert got == want
    else:
        for k in ("completed", "live_s", "dead_s", "reboots"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))


def _load(rel: str, name: str):
    """A file of the repo as a module (its module level imports the
    standard library only)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_operation_floor_is_the_benchmarks():
    """The kernel's floor on f64 operations a lane and row (five a class,
    nine scalar) is the one the benchmark's ``replay_mfu`` counts with,
    which keeps its own copy."""
    peaks = _load("perfbench/fleetbench/peaks.py", "closed_form_peaks")
    assert cf.MIN_F64_OPS_PER_ROW == 5 * tfs._N_CLASSES + 9 == 94
    assert cf.MIN_F64_OPS_PER_ROW == peaks.MIN_F64_OPS_PER_ROW_CLOSED_FORM


def test_kernels_line_entry_of_the_closed_form():
    """``chip_smoke.closed_form_entry``: the first lane count's times,
    bound and plain version, the launches of every phase summed and kept
    by phase, no library call, and each lane count's times."""
    cs = _load("chip_smoke.py", "closed_form_entry_chip_smoke")
    lines = [dict(lanes=8192, rows=12655, ms=6.8, previous_ms=4450.0,
                  bound_ms=0.29, bound_by="operations", plain_ms=21000.0,
                  max_abs_err=0.0, launches=1),
             dict(lanes=16384, rows=12655, ms=6.7, previous_ms=4500.0,
                  bound_ms=0.58, bound_by="operations", launches=1)]
    entry = cs.closed_form_entry(lines, {"closed_form": 2, "genesis": 1,
                                         "paper_demo": 40})
    assert entry["name"] == "closed_form" and entry["route"] == "cuda"
    assert entry["source"] == "src/repro_torch/kernels/csrc/closed_form.cu"
    assert (ROOT / entry["source"]).is_file()
    assert entry["launches"] == 43
    assert entry["launches_by_phase"] == {"closed_form": 2, "genesis": 1,
                                          "paper_demo": 40}
    assert (entry["ms"], entry["previous_ms"], entry["plain_ms"],
            entry["bound_ms"]) == (6.8, 4450.0, 21000.0, 0.29)
    assert entry["library_ms"] is None and entry["max_abs_err"] == 0.0
    assert entry["shape"] == "12655 rows x 8192 lanes"
    assert [b["lanes"] for b in entry["by_lanes"]] == [8192, 16384]
    assert (ROOT / "src/repro/core/fleetsim.py").read_text().split("\n")[
        int(entry["replaces"].rsplit(":", 1)[1]) - 1].startswith(
        "def _scan_one(")


# -- on the card ----------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _chip_smoke():
    """``chip_smoke.py`` as a module: the aten closed form on the card,
    ``aten_graph_scan``."""
    return _load("chip_smoke.py", "closed_form_chip_smoke")


def _held_against_aten(run, monkeypatch):
    """Run ``run`` (an entry point on the card) with every closed-form call
    captured; hold each call's kernel outputs bitwise against the aten
    closed form on its arguments, and its launches and rows exactly."""
    cs = _chip_smoke()
    calls = []
    real = tfs._scan_replay

    def capture(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(tfs, "_scan_replay", capture)
    launches, rows = cf.closed_form.launches, tfs._replay_rows.rows
    result = run()
    torch.cuda.synchronize()
    monkeypatch.setattr(tfs, "_scan_replay", real)
    assert calls
    table_rows = [cr._packed(a[0], k["shared_rows"])[0].shape[-2]
                  for a, k, _ in calls]
    assert cf.closed_form.launches - launches == len(calls)
    assert tfs._replay_rows.rows - rows == sum(table_rows)
    for a, k, out in calls:
        _same(out, cs.aten_graph_scan(torch, tfs, *a, **k))
    return result, calls


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "adaptive"])
@pytest.mark.parametrize("mode", ["shared", "lane", "plan"])
def test_kernel_equals_aten_in_every_row_mode(plans, monkeypatch, mode,
                                              policy):
    """Each row mode and policy over the tails, parametric (CALIB) and
    BURN plans, with recharge traces and a lane of continuous power."""
    _need_card()
    rows, caps, shared_rows, pidx = _mode_case(plans, mode)

    def run():
        prep, t, drows = _inputs(rows, caps, shared_rows, pidx, policy,
                                 device="cuda")
        return tfs._dispatch(prep, t, drows, shared_rows, 0.5, 1, 0.0,
                             "auto")

    _held_against_aten(run, monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "adaptive"])
def test_kernel_equals_aten_on_calib_and_burn_rows(plans, monkeypatch,
                                                   policy):
    """A parametric tails plan over capacitors (CALIB rows, each lane its
    own burns) and a plan with BURN rows, through the entry points."""
    _need_card()
    net, x = _net(1)
    _held_against_aten(lambda: tfs.capacitor_sweep(
        net, x, [2e3, 6e3, 2e4, 1e5, 1e6], n_devices=40, seed=5,
        policy=policy, device="cuda"), monkeypatch)
    _held_against_aten(lambda: tfs.fleet_sweep(
        plan=plans["burn"], n_devices=70, seed=6, trace_reboots=8,
        policy=policy, device="cuda"), monkeypatch)


@pytest.mark.gpu
@pytest.mark.parametrize("policy", ["fixed", "adaptive"])
def test_kernel_equals_aten_on_send_rows(plans, monkeypatch, policy):
    """The uplink's SEND rows with a duty-cycled radio: deferrals, bytes
    and messages."""
    _need_card()
    res, _ = _held_against_aten(lambda: tfs.fleet_sweep(
        plan=plans["tails"], n_devices=300, seed=8, trace_reboots=8,
        policy=policy, radio=RADIO, device="cuda"), monkeypatch)
    assert float(np.sum(res.msgs_sent)) > 0


@pytest.mark.gpu
def test_kernel_equals_aten_on_mnist_tails_query(monkeypatch):
    """MNIST's tails/1mF plan at 8,192 lanes with ``recharge_cv`` 0.25 (the
    benchmark's query chunk), and a lane count that is no multiple of the
    block (8,192 + 37 lanes)."""
    _need_card()
    from repro_torch.models.dnn import mnist_net

    x = np.random.default_rng(42).normal(size=(1, 28, 28)).astype(np.float32)
    plan = tfs.build_plan(mnist_net(), x, "tails", "1mF")
    for lanes in (8192, 8192 + 37):
        assert lanes % cr.lane_block(lanes) or lanes == 8192
        _held_against_aten(lambda: tfs.fleet_sweep(
            plan=plan, n_devices=lanes, seed=3000000001, recharge_cv=0.25,
            reduce="stats", device="cuda"), monkeypatch)
