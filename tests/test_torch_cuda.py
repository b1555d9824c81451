"""The CUDA kernels on the card.  The lane kernel must equal the plain
PyTorch version bitwise on every output channel, count its launches, and
refuse CPU tensors; the compute kernels (dense matmul, block-sparse FC,
FIR) must agree with their plain versions -- the FIR bitwise, the f32
products within the tolerance of ``tests/test_kernels.py``, the bf16 ones
under ``chip_smoke.py``'s per-element rule -- count only their own
launches, and send CPU tensors to the plain versions; so must the
attention and SSD kernels, and the LM forward with the attention kernel
must launch it once a layer and agree with the blockwise path.  The bf16
attention has two kernels, the matmul and the block-sparse FC three each
(bf16 and 3xTF32 on the tensor cores, the rest on the CUDA cores): each
case checks which one its operands take and counts that one's launch.
The 3xTF32 outputs are also held to ``chip_smoke.py``'s ``tf32x3`` rule
against the f64 product, and the matmul's are run twice to show they are
the same bit for bit.  The lane kernel in plan mode (a ``PlanSet``
design sweep) must equal the plain version, the direct design and every
candidate's own sweep; the statistics fold kernel its plain version
bitwise; a streamed ``reduce="stats"`` sweep on the card the same sweep on
the CPU, whatever its prefetch depth; the closed-form scan (its kernel)
the CPU's loop bitwise.  Serving: ``prefill`` must launch
the attention kernel once a layer, and prefill and decode agree with the
forward; mamba2's forward must launch the SSD kernel once a layer (on its
wgmma design) and agree with the plain cell's, and its decode with its
forward; zamba2's forward must launch the attention kernel on its
``wgmma`` path at heads of 112 and the SSD kernel on wgmma, whisper's
the attention kernel once an encoder and a decoder layer, both agree with
the plain versions and their decode with their forward; the engine's
tokens must be the same on a second run and after preemption and
resumption.  Every test skips, from
inside the test, where no card is visible; run them on the card with
``python -m pytest -m gpu``."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.core import fleetsim as tfs
from repro_torch.core.energy import custom_power_system, rf_recharge_seconds
from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D, SimNet,
                                        SparseFC)
from repro_torch.kernels import charge_replay as cr
from repro_torch.runtime.failures import charge_capacity_jitter
from repro_torch.runtime.radio import RadioModel, SEND_POLICIES, pack_radio

pytestmark = pytest.mark.gpu

ARRAYS = ("completed", "live_s", "dead_s", "reboots", "energy_j",
          "wasted_cycles", "belief_cycles", "tx_bytes", "msgs_sent",
          "msgs_deferred", "classes")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


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
                 input_shape=(1, 10, 10), name=f"card{seed}")
    return net, rng.normal(size=(1, 10, 10)).astype(np.float32)


def _same(a, b, tag):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=(tag, name))


@pytest.mark.parametrize("strategy,policy", [
    ("sonic", "fixed"), ("sonic", "adaptive"), ("tile-8", "adaptive"),
    ("tails", "adaptive"), ("tails-burn", "adaptive")])
def test_kernel_equals_plain_fleet_sweep(strategy, policy):
    _need_card()
    net, x = _net()
    if strategy == "tails-burn":
        plan = tfs.build_plan(net, x, "tails", custom_power_system(3000))
    else:
        plan = tfs.build_plan(net, x, strategy, "100uF")
    kw = dict(plan=plan, n_devices=300, seed=2, charge_cv=0.4,
              trace_reboots=8, policy=policy, device="cuda",
              radio=pack_radio(RadioModel(window_period_s=0.05,
                                          window_duty=0.3),
                               SEND_POLICIES[1]))
    if policy == "adaptive":
        kw.update(batch_rows=4, belief_alpha=0.2)
    _same(tfs.fleet_sweep(backend="cuda", **kw),
          tfs.fleet_sweep(backend="torch", **kw), strategy)


@pytest.mark.parametrize("strategy,policy", [
    ("sonic", "fixed"), ("tails", "adaptive"), ("tile-8", "adaptive"),
    ("naive", "fixed")])
def test_closed_form_on_card_equals_the_cpu(strategy, policy):
    """A deterministic sweep (no charge jitter) runs the closed-form scan,
    on the card one launch of its kernel: every channel equals
    the CPU's loop bitwise, for a shared plan with recharge traces and for
    one plan a lane (``replay_plans``, 100uF)."""
    _need_card()
    net, x = _net(5)
    kw = dict(n_devices=200, seed=4, trace_reboots=12, policy=policy,
              theta=0.5)
    _same(tfs.fleet_sweep(net, x, strategy, "1mF", device="cuda", **kw),
          tfs.fleet_sweep(net, x, strategy, "1mF", device="cpu", **kw),
          strategy)
    plans = [tfs.build_plan(net, x, strategy, "100uF")] * 3
    frac = np.array([0.2, 0.6, 1.0])
    for a, b in zip(tfs.replay_plans(plans, init_frac=frac, policy=policy,
                                     device="cuda"),
                    tfs.replay_plans(plans, init_frac=frac, policy=policy,
                                     device="cpu")):
        assert a == b


def test_kernel_equals_plain_per_lane_rows():
    """Per-lane rows (``replay_plans``): parametric tails over several
    capacitors, a short trace so the closed-form fast path engages, and a
    continuous-power lane."""
    _need_card()
    net, x = _net(1)
    base = tfs.build_plan(net, x, "tails", "1mF", parametric=True)
    plans = []
    for frac in (0.05, 0.12, 0.3, 0.6):
        cap = max(2000.0, float(np.rint(frac * base.total_cycles)))
        plans.append(dataclasses.replace(
            base, capacity=cap, recharge_s=float(rf_recharge_seconds(cap))))
    plans.append(dataclasses.replace(base, capacity=np.inf))
    caps = np.asarray([p.capacity for p in plans])
    for n_ch in (48, 6):
        ctr = charge_capacity_jitter(len(plans), n_ch, caps, seed=n_ch,
                                     cv=0.4)
        kw = dict(charge_traces=ctr, policy="adaptive", batch_rows=1,
                  belief_alpha=0.0, init_frac=np.linspace(0.2, 1, 5),
                  device="cuda")
        a = tfs.replay_plans(plans, backend="cuda", **kw)
        b = tfs.replay_plans(plans, backend="torch", **kw)
        assert [dataclasses.asdict(o) for o in a] == \
            [dataclasses.asdict(o) for o in b]


def test_launches_count_kernel_launches_only():
    _need_card()
    net, x = _net()
    plan = tfs.build_plan(net, x, "sonic", "100uF")
    kw = dict(plan=plan, n_devices=64, seed=1, charge_cv=0.3,
              device="cuda")
    before = cr.charge_replay.launches
    by_design = dict(cr.charge_replay.launches_by_design)
    tfs.fleet_sweep(**kw)
    assert cr.charge_replay.launches == before + 1
    assert cr.charge_replay.launches_by_design == dict(
        by_design, hoisted=by_design["hoisted"] + 1)
    tfs.fleet_sweep(backend="torch", **kw)
    tfs.fleet_sweep(plan=plan, n_devices=8, seed=1, device="cuda")
    assert cr.charge_replay.launches == before + 1


def _both_designs(monkeypatch, run):
    """Run ``run()`` with every lane-kernel launch made by both designs,
    and return the pairs of outputs."""
    wrapper, pairs = cr._wrapper, []

    def both(*a, **kw):
        out = wrapper(*a, **kw)
        pairs.append((out, wrapper(*a, **kw, design="direct")))
        return out

    monkeypatch.setattr(cr, "charge_replay", both)
    run()
    torch.cuda.synchronize()
    assert pairs
    return pairs


@pytest.mark.parametrize("rows", ["shared", "per-lane"])
def test_hoisted_design_equals_direct(rows, monkeypatch):
    """The hoisted design (the main path's) and the direct one give the
    same bits on every channel: shared rows (a fleet sweep with the uplink
    radio, adaptive, and sonic fixed) and per-lane rows (parametric tails
    over several capacitors with a short trace, so the closed-form fast
    path runs, and a continuous-power lane)."""
    _need_card()
    net, x = _net()
    if rows == "shared":
        radio = pack_radio(RadioModel(window_period_s=0.05,
                                      window_duty=0.3), SEND_POLICIES[1])
        runs = [lambda: tfs.fleet_sweep(
                    net, x, "tails", "100uF", n_devices=300, seed=2,
                    charge_cv=0.4, trace_reboots=8, policy="adaptive",
                    batch_rows=4, belief_alpha=0.2, radio=radio,
                    device="cuda"),
                lambda: tfs.fleet_sweep(
                    net, x, "sonic", "100uF", n_devices=300, seed=3,
                    charge_cv=0.4, trace_reboots=8, device="cuda")]
    else:
        base = tfs.build_plan(net, x, "tails", "1mF", parametric=True)
        plans = [dataclasses.replace(
            base, capacity=max(2000.0, float(np.rint(f * base.total_cycles))))
            for f in (0.05, 0.12, 0.3, 0.6)]
        plans.append(dataclasses.replace(base, capacity=np.inf))
        caps = np.asarray([p.capacity for p in plans])
        ctr = charge_capacity_jitter(len(plans), 6, caps, seed=6, cv=0.4)
        runs = [lambda: tfs.replay_plans(
            plans, charge_traces=ctr, policy="adaptive", batch_rows=1,
            init_frac=np.linspace(0.2, 1, 5), device="cuda")]
    for run in runs:
        for hoisted, direct in _both_designs(monkeypatch, run):
            for k, a in hoisted.items():
                b = direct[k]
                same = a == b
                if a.is_floating_point():
                    same |= a.isnan() & b.isnan()   # NaN in both is equal
                assert bool(same.all()), k


def test_cpu_tensors_with_cuda_backend_raise():
    _need_card()
    net, x = _net()
    plan = tfs.build_plan(net, x, "sonic", "100uF")
    with pytest.raises(ValueError, match="cuda"):
        tfs.replay_plans([plan], backend="cuda", device="cpu",
                         charge_traces=np.full((1, 4), plan.capacity))
    n = 2
    dev = torch.device("cuda")
    rows = {k: torch.as_tensor(v, device=dev)
            for k, v in tfs._plan_rows(plan).items()}
    f = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=dev)
    args = [rows, f(n) + plan.capacity, f(n) + plan.capacity, f(n, 1),
            f(n), f(n, 1), f(n),
            torch.full((n,), len(plan), dtype=torch.int32, device=dev),
            0.5, 1.0, 0.0]
    kw = dict(adaptive=False, parametric=False, shared_rows=True)
    out = cr.charge_replay(*args, **kw)
    torch.cuda.synchronize()
    assert bool((~out["stuck"]).all())
    bad = list(args)
    bad[2] = bad[2].cpu()                          # rem0 on the CPU
    with pytest.raises(ValueError, match="rem0"):
        cr.charge_replay(*bad, **kw)
    bad = list(args)
    bad[7] = bad[7].to(torch.int64)                # s_real of the wrong type
    with pytest.raises(TypeError, match="s_real"):
        cr.charge_replay(*bad, **kw)


# --------------------------------------------------------------------------
# the compute kernels: dense matmul, block-sparse FC, FIR
# --------------------------------------------------------------------------

DESIGN_ARRAYS = ("completed", "live_s", "dead_s", "reboots", "energy_j",
                 "wasted_cycles", "belief_cycles", "tx_bytes", "msgs_sent",
                 "msgs_deferred")


def _planset(net, x):
    plans = [tfs.build_plan(net, x, s, p) for s in ("sonic", "tails", "tile-8")
             for p in ("100uF", "1mF")]
    return plans, tfs.PlanSet.from_plans(plans)


def test_plan_mode_kernel_equals_plain_direct_and_solo(monkeypatch):
    """A ``PlanSet`` design sweep launches the hoisted design once in
    ``"plan"`` mode (a per-lane plan index into one ``(P, S, F)`` pack);
    the plain version, the direct design in plan mode and every
    candidate's own fleet sweep give the same bits."""
    _need_card()
    net, x = _net()
    plans, ps = _planset(net, x)
    kw = dict(n_devices=64, seed=7, charge_cv=0.25, charge_reboots=16,
              trace_reboots=8, policy="adaptive", batch_rows=4,
              belief_alpha=0.2, device="cuda")
    by_mode = dict(cr.charge_replay.launches_by_mode)
    res = tfs.fleet_sweep(plan=ps, **kw)
    assert cr.charge_replay.launches_by_mode == dict(
        by_mode, plan=by_mode["plan"] + 1)
    plain = tfs.fleet_sweep(plan=ps, backend="torch", **kw)
    for name in DESIGN_ARRAYS:
        np.testing.assert_array_equal(getattr(res, name),
                                      getattr(plain, name), err_msg=name)
    for p, plan in enumerate(plans):
        solo = tfs.fleet_sweep(plan=plan, **kw)
        for name in DESIGN_ARRAYS[:7]:
            np.testing.assert_array_equal(getattr(res, name)[p],
                                          getattr(solo, name), err_msg=name)
    pairs = _both_designs(monkeypatch, lambda: tfs.fleet_sweep(plan=ps, **kw))
    for hoisted, direct in pairs:
        for k, a in hoisted.items():
            b = direct[k]
            same = a == b
            if a.is_floating_point():
                same |= a.isnan() & b.isnan()
            assert bool(same.all()), k


def test_plan_index_out_of_range_raises():
    _need_card()
    net, x = _net()
    _plans, ps = _planset(net, x)
    dev = torch.device("cuda")
    rows = {k: torch.as_tensor(v, device=dev) for k, v in ps.rows.items()}
    n = 4
    f = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=dev)
    args = (rows, f(n) + 1e5, f(n) + 1e5, f(n, 1), f(n), f(n, 1), f(n),
            torch.ones(n, dtype=torch.int32, device=dev), 0.5, 1.0, 0.0)
    kw = dict(adaptive=False, parametric=False, shared_rows="plan")
    for bad in ([0, 1, 2, len(ps)], [-1, 0, 0, 0]):
        idx = torch.tensor(bad, dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="plan_idx"):
            cr.charge_replay(*args, plan_idx=idx, **kw)
    with pytest.raises(TypeError, match="plan_idx"):
        cr.charge_replay(*args, plan_idx=torch.zeros(n, dtype=torch.int64,
                                                     device=dev), **kw)


def _fold_inputs(n, groups, seed):
    from repro_torch.core.fleetstats import default_stat_edges

    rng = np.random.default_rng(seed)
    out = {"live": rng.integers(1, 10**6, n) * 1.0 + rng.random(n),
           "dead": rng.random(n) * 50,
           "reboots": rng.integers(0, 99, n) * 1.0,
           "wasted": rng.integers(0, 500, n) * 1.0,
           "belief": rng.random(n) * 1e4,
           "tx_bytes": rng.random(n) * 30,
           "msgs_sent": rng.integers(0, 3, n) * 1.0,
           "msgs_deferred": rng.integers(0, 3, n) * 1.0,
           "stuck": rng.random(n) < 0.1,
           "classes": rng.random((n, tfs._N_CLASSES)) * 100}
    gid = rng.integers(-1, groups + 1, n).astype(np.int32)  # some dropped
    valid = rng.random(n) < 0.9
    edges = default_stat_edges(5e5, 1e4, 0.5, 16)
    edges["reboots"] = np.asarray([0.0, 10.0, 40.0, 98.0])   # 3 bins
    if n >= 300:
        # signed zeros and NaNs, which numpy's minimum.at / maximum.at
        # order their own way (a tie takes the later lane, the first NaN
        # stays)
        out["wasted"][::3] = 0.0
        out["wasted"][1::3] = -0.0
        out["tx_bytes"][[17, 101, 240]] = np.nan
    return out, gid, valid, edges


def _same_bits(a, b) -> bool:
    """Equal bit for bit (NaNs and the sign of zero included)."""
    if a.dtype == torch.float64:
        return torch.equal(a.contiguous().view(torch.int64),
                           b.contiguous().view(torch.int64))
    return torch.equal(a, b)


@pytest.mark.parametrize("n,groups", [(0, 1), (1, 1), (300, 1), (5000, 3),
                                      (777, 6), (4000, 200)])
def test_stats_fold_kernel_bitwise_equals_plain(n, groups):
    """The fold kernel against its plain version on the host (whose sums
    run in lane order): every statistic bitwise, one launch counted.  The
    last case's histograms do not fit a block's shared memory and count in
    device memory."""
    _need_card()
    from repro_torch.kernels import stats_fold as sf

    out, gid, valid, edges = _fold_inputs(n, groups, seed=n + groups)
    dev = torch.device("cuda")
    t_out = {k: torch.as_tensor(v, device=dev) for k, v in out.items()}
    t_edges = {k: torch.as_tensor(v, dtype=torch.float64, device=dev)
               for k, v in edges.items()}
    before = sf.stats_fold.launches
    got = sf.stats_fold(t_out, torch.as_tensor(gid, device=dev),
                        torch.as_tensor(valid, device=dev), t_edges, groups)
    torch.cuda.synchronize()
    assert sf.stats_fold.launches == before + 1
    want = sf.stats_fold_plain(
        {k: torch.as_tensor(v) for k, v in out.items()},
        torch.as_tensor(gid), torch.as_tensor(valid), edges, groups)
    for g_part, w_part in zip(got, want):
        assert g_part.keys() == w_part.keys()
        for k in g_part:
            assert _same_bits(g_part[k].cpu(), w_part[k]), k


def test_streamed_stats_on_card_equal_the_cpu_run():
    """``reduce="stats"`` with ``lane_chunk`` on the card: prefetch 0, 1
    and 2 give the same bits, and so does the same sweep on the CPU (the
    lane kernel and the fold kernel each equal their plain versions); one
    fold launch a chunk."""
    _need_card()
    from repro_torch.core.fleetstats import STAT_CHANNELS
    from repro_torch.kernels import stats_fold as sf

    net, x = _net()
    plan = tfs.build_plan(net, x, "tails", "100uF")
    kw = dict(plan=plan, n_devices=250, seed=4, charge_cv=0.25,
              charge_reboots=16, policy="adaptive", batch_rows=4,
              belief_alpha=0.2, reduce="stats", lane_chunk=64)
    runs = []
    for prefetch in (0, 1, 2):
        before = sf.stats_fold.launches
        runs.append(tfs.fleet_sweep(prefetch=prefetch, device="cuda", **kw))
        assert sf.stats_fold.launches == before + 4
    runs.append(tfs.fleet_sweep(device="cpu", **kw))
    for st in runs[1:]:
        for f in ("count", "completed", "class_sums"):
            np.testing.assert_array_equal(getattr(st, f),
                                          getattr(runs[0], f), err_msg=f)
        for f in ("sums", "sumsqs", "mins", "maxs", "hists"):
            for ch in STAT_CHANNELS:
                np.testing.assert_array_equal(getattr(st, f)[ch],
                                              getattr(runs[0], f)[ch],
                                              err_msg=(f, ch))


def _kmod(name):
    """A kernel module by its full path (``repro_torch.kernels`` exports
    functions named ``dense_matmul`` and ``fir_conv1d``)."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _cuda(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype).cuda()


def _bf16_matmul_holds(got, want):
    """chip_smoke.py's bf16 rule: one rounding apart, sums reordered."""
    w = want.float()
    limit = 2.0 ** -7 * w.abs() + 2.0 ** -12 * w.square().mean().sqrt()
    return bool(((got.float() - w).abs() <= limit).all())


def _tf32x3_holds(got, plain, exact):
    """chip_smoke.py's tf32x3 rule: max |got - f64| <= 4 max |plain - f64|
    + 2^-24 max |f64|."""
    limit = 4 * float((plain.double() - exact).abs().max()) \
        + 2.0 ** -24 * float(exact.abs().max())
    return float((got.double() - exact).abs().max()) <= limit


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("shape,dtype,tiles", [
    ((13, 57, 31), torch.float32, None), ((1, 1, 1), torch.float32, None),
    ((64, 512, 384), torch.float32, (8, 128, 128)),
    ((64, 512, 384), torch.float32, (16, 256, 128)),
    ((300, 1000, 200), torch.float32, None),
    ((13, 57, 31), torch.bfloat16, None),
    ((300, 1000, 200), torch.bfloat16, None),
    ((128, 256, 192), torch.bfloat16, None),
    ((200, 296, 104), torch.bfloat16, (16, 256, 128)),
    ((64, 520, 136), torch.bfloat16, None),
    ((1000, 1024, 512), torch.bfloat16, None),
    # a mixed pair: the f32 kernel on the bf16 operand widened
    ((200, 296, 104), (torch.float32, torch.bfloat16), None),
    ((13, 57, 31), (torch.bfloat16, torch.float32), None)])
def test_dense_matmul_kernel_equals_plain(shape, dtype, tiles):
    _need_card()
    from repro_torch.kernels import MatmulTiles, dense_matmul, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    x_dtype, w_dtype = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    x = _cuda(rng.normal(size=(m, k)), x_dtype)
    w = _cuda(rng.normal(size=(k, n)), w_dtype)
    mod = _kmod("dense_matmul")
    path = mod.matmul_path(x.float(), w.float()) if x_dtype != w_dtype \
        else mod.matmul_path(x, w)
    assert path == ("wgmma" if x_dtype == w_dtype == torch.bfloat16
                    and k % 8 == 0 and n % 8 == 0 else "tf32x3"
                    if torch.float32 in (x_dtype, w_dtype)
                    and k % 4 == 0 and n % 4 == 0 else "narrow"
                    if n <= mod.NARROW_MAX_N else "simt")
    before = mod.matmul.launches
    on_path = mod.matmul.launches_by_path[path]
    got = dense_matmul(x, w, tiles=tiles and MatmulTiles(*tiles))
    torch.cuda.synchronize()
    assert mod.matmul.launches == before + 1
    assert mod.matmul.launches_by_path[path] == on_path + 1
    want = ref.matmul_ref(x, w)
    assert got.dtype == x_dtype and got.device == x.device
    if x_dtype == torch.float32:    # tests/test_kernels.py's tolerance
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        if path == "tf32x3":
            exact = x.double() @ w.double()
            assert _tf32x3_holds(got, want, exact)
            if tiles and w_dtype == torch.float32:
                # the CUDA-core kernel at these tiles, on the same operands
                bm, bk, bn = tiles
                simt = mod.launch(x, w, "simt", bm=bm, bk=bk, bn=bn)
                torch.testing.assert_close(simt, want, rtol=2e-4,
                                           atol=2e-4)
    else:                           # one bf16 rounding of the output
        assert _bf16_matmul_holds(got, want)


@pytest.mark.parametrize("shape", [
    (200, 300, 100),     # ragged M, N and K (a K tail of 12)
    (64, 4, 64), (13, 4, 36),         # K = 4: one slice, mostly zeros
    (130, 36, 132),      # one row and four columns past a tile
    (1, 4, 4),
    (64, 60, 64),        # K split 2 ways, one slice each
    (128, 1024, 256),    # K split 4 ways
    (512, 160, 768),     # K split 2 ways, 5 slices: 3 and 2
    (512, 1024, 768),    # the benchmark shape: 96 CTAs, split 4
    (1024, 200, 500),    # MNIST's fc2: split 4, slices 2, 2, 2, 1
    (1000, 1024, 512)])
def test_tf32x3_kernel_equals_plain(shape):
    """The 3xTF32 kernel on f32 operands TMA reads: within
    tests/test_kernels.py's tolerance of the plain version and under
    chip_smoke.py's tf32x3 rule against the f64 product, counted on its
    own path, and bitwise the same when run again (the split-K partials
    are added in a fixed order)."""
    _need_card()
    from repro_torch.kernels import dense_matmul, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    mod = _kmod("dense_matmul")
    rng = np.random.default_rng(m + 3 * k + 7 * n)
    x = _cuda(rng.normal(size=(m, k)))
    w = _cuda(rng.normal(size=(k, n)))
    assert mod.matmul_path(x, w) == "tf32x3"
    on_path = mod.matmul.launches_by_path["tf32x3"]
    got = dense_matmul(x, w)
    again = dense_matmul(x, w)
    torch.cuda.synchronize()
    assert mod.matmul.launches_by_path["tf32x3"] == on_path + 2
    want = ref.matmul_ref(x, w)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    assert _tf32x3_holds(got, want, x.double() @ w.double())
    assert torch.equal(got, again)


def test_dense_matmul_kernels_side_by_side():
    """Both kernels on operands the wgmma kernel takes agree with the
    plain version; the wgmma kernel refuses operands TMA cannot read."""
    _need_card()
    from repro_torch.kernels import ref
    mod = _kmod("dense_matmul")
    rng = np.random.default_rng(9)
    x = _cuda(rng.normal(size=(256, 512)), torch.bfloat16)
    w = _cuda(rng.normal(size=(512, 384)), torch.bfloat16)
    want = ref.matmul_ref(x, w)
    for path in ("wgmma", "simt"):
        assert _bf16_matmul_holds(mod.launch(x, w, path), want)
    x_off = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    x_off = x_off[1:].view(x.shape)                 # 2 bytes off 16
    x_off.copy_(x)
    assert mod.matmul_path(x_off, w) == "simt"
    assert _bf16_matmul_holds(mod.matmul(x_off, w, bm=64, bk=64, bn=64),
                              want)
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        mod.launch(x_off, w, "wgmma")
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        mod.launch(x.float(), w.float(), "wgmma")


@pytest.mark.parametrize("shape,dtype", [
    ((1024, 500, 10), F32), ((13, 57, 31), F32), ((1, 1, 1), F32),
    ((1000, 333, 10), F32), ((300, 70, 17), F32), ((1025, 5, 3), F32),
    ((2, 700, 1), F32), ((64, 64, 64), F32), ((1024, 4096, 64), F32),
    ((77, 130, 64), BF16), ((13, 57, 31), BF16), ((1024, 500, 10), BF16)])
def test_narrow_kernel_bitwise_equals_simt(shape, dtype):
    """The narrow kernel sums each output over K in order as the CUDA-core
    kernel does, so the two give the same bits, ragged M and K, K in one
    slice or several, f32 and bf16; both within the f32 (or bf16) rule of
    the plain version."""
    _need_card()
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    m, k, n = shape
    mod = _kmod("dense_matmul")
    rng = np.random.default_rng(m + 3 * k + 7 * n)
    x = _cuda(rng.normal(size=(m, k)), dtype)
    w = _cuda(rng.normal(size=(k, n)), dtype)
    on_path = mod.matmul.launches_by_path["narrow"]
    got = mod.launch(x, w, "narrow")
    simt = mod.launch(x, w, "simt")
    torch.cuda.synchronize()
    assert mod.matmul.launches_by_path["narrow"] == on_path + 1
    assert torch.equal(got, simt)
    want = ref.matmul_ref(x, w)
    if dtype == F32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert _bf16_matmul_holds(got, want)


def test_tf32x3_and_simt_side_by_side():
    """Both f32 kernels on operands the tf32x3 kernel takes agree with the
    plain version; the tf32x3 kernel refuses operands TMA cannot read, and
    bf16 ones."""
    _need_card()
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = _kmod("dense_matmul")
    rng = np.random.default_rng(10)
    x = _cuda(rng.normal(size=(256, 512)))
    w = _cuda(rng.normal(size=(512, 384)))
    want = ref.matmul_ref(x, w)
    for path in ("tf32x3", "simt"):
        torch.testing.assert_close(mod.launch(x, w, path), want, rtol=2e-4,
                                   atol=2e-4)
    w_off = torch.empty(w.numel() + 2, dtype=w.dtype, device=w.device)
    w_off = w_off[2:].view(w.shape)                 # 8 bytes off 16
    w_off.copy_(w)
    assert mod.matmul_path(x, w_off) == "simt"
    torch.testing.assert_close(mod.matmul(x, w_off, bm=64, bk=64, bn=64),
                               want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="tf32x3 kernel does not take"):
        mod.launch(x, w_off, "tf32x3")
    with pytest.raises(ValueError, match="tf32x3 kernel does not take"):
        mod.launch(x.bfloat16(), w.bfloat16(), "tf32x3")


def _fc_exact(fc, x):
    """x @ W^T in f64 from the layer's own bundle."""
    vals, row_ptr, col_idx = fc._bundle
    nbr = row_ptr.numel() - 1
    nbc = fc.padded_k // fc.bk
    rows = torch.repeat_interleave(torch.arange(nbr, device=x.device),
                                   torch.diff(row_ptr.long()))
    w = torch.zeros((nbr, nbc, fc.bm, fc.bk), dtype=torch.float64,
                    device=x.device)
    w.index_put_((rows, col_idx.long()), vals.double(), accumulate=True)
    w = w.permute(0, 2, 1, 3).reshape(nbr * fc.bm, nbc * fc.bk)
    return x.double() @ w[:fc.m, :fc.k].T


@pytest.mark.parametrize("batch,bn,blocks,x_dtype,w_dtype,path", [
    (1, 8, (128, 128), F32, F32, "tf32x3"),
    (7, 8, (128, 128), F32, F32, "tf32x3"),
    (17, 8, (128, 128), F32, F32, "tf32x3"),
    (33, 32, (128, 128), F32, F32, "tf32x3"),
    (5, 1, (128, 128), F32, F32, "tf32x3"),
    (129, 8, (128, 128), F32, F32, "tf32x3"),
    (200, 8, (128, 64), F32, F32, "tf32x3"),
    (1, 8, (128, 128), BF16, BF16, "wgmma"),
    (17, 8, (128, 128), BF16, BF16, "wgmma"),
    (129, 8, (128, 128), BF16, BF16, "wgmma"),
    (200, 8, (128, 64), BF16, BF16, "wgmma"),
    (9, 4, (64, 48), F32, F32, "simt"),
    (9, 4, (64, 48), BF16, BF16, "simt"),
    (17, 8, (128, 128), BF16, F32, "tf32x3"),
    (17, 8, (128, 128), F32, BF16, "tf32x3")])
def test_block_sparse_kernel_equals_plain(batch, bn, blocks, x_dtype, w_dtype,
                                          path):
    """Each kernel on the ragged weight with an empty row-block: f32
    outputs within tests/test_kernels.py's tolerance (and, from 3xTF32,
    the tf32x3 rule), bf16 ones within chip_smoke.py's bf16 rule."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import BlockSparseFC
    rng = np.random.default_rng(batch)
    w = rng.normal(size=(300, 200)).astype(np.float32)
    w[128:256] = 0                                  # an empty row-block
    w[:, 60:] *= rng.random((300, 140)) < 0.05
    bm, bk = blocks
    fc = BlockSparseFC(w, bm=bm, bk=bk, bn=bn)
    if w_dtype == BF16:
        fc = BlockSparseFC.from_block_csr(
            torch.from_numpy(fc.vals).to(BF16), fc.row_ptr, fc.col_idx,
            300, 200, bm, bk, bn)
    x = _cuda(rng.normal(size=(batch, 200)), x_dtype)
    mod = _kmod("sparse_fc")
    assert mod.fc_path(x, fc._bundle[0], bm, bk) == path
    before = mod.block_sparse_matvec.launches
    on_path = mod.block_sparse_matvec.launches_by_path[path]
    got = fc(x)
    torch.cuda.synchronize()
    assert mod.block_sparse_matvec.launches == before + 1
    assert mod.block_sparse_matvec.launches_by_path[path] == on_path + 1
    want = mod.block_sparse_matvec_plain(x, *fc._bundle, fc.m, bm=fc.bm,
                                         bk=fc.bk)
    assert got.dtype == x_dtype
    if x_dtype == F32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
        if path == "tf32x3":
            assert _tf32x3_holds(got, want, _fc_exact(fc, x))
    else:
        assert _bf16_matmul_holds(got, want)


def test_block_sparse_kernels_side_by_side():
    """The tensor-core and CUDA-core kernels on the same f32 operands each
    agree with the plain version; the tensor-core kernels refuse what TMA
    or their tiles cannot take, and nothing falls back."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import BlockSparseFC
    mod = _kmod("sparse_fc")
    rng = np.random.default_rng(11)
    w = rng.normal(size=(512, 512)).astype(np.float32)
    w[:128, 256:] = 0
    fc = BlockSparseFC(w)
    x = _cuda(rng.normal(size=(64, 512)))
    want = mod.block_sparse_matvec_plain(x, *fc._bundle, fc.m, bm=128,
                                         bk=128)
    for path in ("tf32x3", "simt"):
        got = mod.launch(x, *fc._bundle, fc.m, path, bm=128, bk=128)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    x_off = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    x_off = x_off[1:].view(x.shape)                 # 4 bytes off 16
    x_off.copy_(x)
    assert mod.fc_path(x_off, fc._bundle[0], 128, 128) == "simt"
    torch.testing.assert_close(fc(x_off), want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="tf32x3 kernel does not take"):
        mod.launch(x_off, *fc._bundle, fc.m, "tf32x3", bm=128, bk=128)
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        mod.launch(x, *fc._bundle, fc.m, "wgmma", bm=128, bk=128)


#: FIR cases: the tests' shapes, L = 1, K = L, a K past the flat design's
#: stage, tiles that end mid-row with spans off 16-byte boundaries and a
#: last chunk past the end of x (999 x 13; 40000 x 13, on the flat design
#: through the entry point in f32 only: its 88 bf16 tiles are fewer than
#: FLAT_MIN_TILES, so bf16 takes the tiled design there and the flat one by
#: name), and MNIST's two convolutions as
#: chip_smoke.py's conv_by_fir stacks them (1024 x 20 x 24 rows of 28,
#: 1024 x 100 x 8 rows of 12).
_FIR_CASES = [(37, 101, 7), (5, 12, 1), (5, 12, 12), (3, 300, 70),
              (4000, 28, 5), (2, 9000, 5), (1, 1, 1), (999, 13, 5),
              (3, 8192, 5), (2, 300, 300), (40000, 13, 5), (491520, 28, 5),
              (819200, 12, 5)]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("c,length,k", _FIR_CASES)
def test_fir_kernel_bitwise_equals_plain(c, length, k, dtype):
    """The kernel ``fir_path`` names, through the entry point (its launch
    counted on its path), bitwise equal to the plain version; the other
    design, launched by name where it takes the operands, too."""
    _need_card()
    from repro_torch.kernels import fir_conv1d, ref
    rng = np.random.default_rng(c + length + k)
    x = _cuda(rng.normal(size=(c, length)), dtype)
    taps = _cuda(rng.normal(size=(c, k)), dtype)
    mod = _kmod("fir_conv1d")
    path = mod.fir_path(x, taps)
    if c in (491520, 819200) or (c == 40000 and dtype == F32):
        assert path == "flat"             # at least 132 tiles
    before = dict(mod.fir_conv1d.launches_by_path)
    got = fir_conv1d(x, taps)
    torch.cuda.synchronize()
    assert mod.fir_conv1d.launches_by_path == {
        p: n + (p == path) for p, n in before.items()}
    assert got.dtype == dtype
    want = ref.fir_conv1d_ref(x, taps)
    assert torch.equal(got, want)
    if path == "flat":
        assert torch.equal(mod.launch(x, taps, "tiled"), want)
        if k == 5:
            assert torch.equal(mod.launch(x, taps, "flat", looped=True),
                               want)
    elif mod.flat_takes(x, taps):
        assert torch.equal(mod.launch(x, taps, "flat"), want)


@pytest.mark.parametrize("x_dtype,taps_dtype", [(F32, BF16), (BF16, F32)])
def test_fir_flat_mixed_dtypes_bitwise(x_dtype, taps_dtype):
    """A mixed pair on the flat design, MNIST's conv1 rows: bitwise equal
    to the plain version and to the first design."""
    _need_card()
    from repro_torch.kernels import ref
    rng = np.random.default_rng(12)
    x = _cuda(rng.normal(size=(40000, 28)), x_dtype)
    taps = _cuda(rng.normal(size=(40000, 5)), taps_dtype)
    mod = _kmod("fir_conv1d")
    assert mod.fir_path(x, taps) == "flat"
    got = mod.launch(x, taps, "flat")
    assert torch.equal(got, ref.fir_conv1d_ref(x, taps))
    assert torch.equal(got, mod.launch(x, taps, "tiled"))


def test_fir_paths_refuse_what_they_do_not_take():
    """x off a 16-byte boundary takes the first design; the flat one named
    for it, or for a K whose span does not fit, is refused; so is a CPU
    tensor."""
    _need_card()
    mod = _kmod("fir_conv1d")
    x = torch.randn(4 * 12 + 1, device="cuda")[1:].view(4, 12)
    taps = torch.randn(4, 5, device="cuda")
    assert mod.fir_path(x, taps) == "tiled"
    with pytest.raises(ValueError, match="flat kernel does not take"):
        mod.launch(x, taps, "flat")
    big = torch.randn(2, 300, device="cuda")
    with pytest.raises(ValueError, match="flat kernel does not take"):
        mod.launch(big, torch.randn(2, 300, device="cuda"), "flat")
    with pytest.raises(ValueError, match="runs on CUDA"):
        mod.launch(x.cpu(), taps.cpu(), "tiled")


def test_compute_kernels_count_only_cuda_launches():
    """CPU tensors go to the plain versions and launch nothing."""
    _need_card()
    from repro_torch.kernels import BlockSparseFC, dense_matmul, fir_conv1d
    mods = [(_kmod("dense_matmul"), "matmul"),
            (_kmod("sparse_fc"), "block_sparse_matvec"),
            (_kmod("fir_conv1d"), "fir_conv1d")]
    count = lambda: [getattr(m, f).launches for m, f in mods]
    before = count()
    x = torch.randn(9, 20)
    dense_matmul(x, torch.randn(20, 3))
    BlockSparseFC(np.ones((5, 20), np.float32), device="cpu")(x)
    fir_conv1d(x, torch.randn(9, 4))
    assert count() == before
    xc = x.cuda()
    dense_matmul(xc, torch.randn(20, 3, device="cuda"))
    BlockSparseFC(np.ones((5, 20), np.float32))(xc)
    fir_conv1d(xc, torch.randn(9, 4, device="cuda"))
    torch.cuda.synchronize()
    assert count() == [b + 1 for b in before]


def test_compute_kernels_refuse_what_they_do_not_take():
    _need_card()
    from repro_torch.kernels import BlockSparseFC, dense_matmul, fir_conv1d
    x = torch.randn(16, 32, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        dense_matmul(x, torch.randn(16, 32, device="cuda").T)
    # a mixed pair is computed (in f32, as JAX promotes it), not refused
    w16 = torch.randn(32, 8, device="cuda", dtype=torch.bfloat16)
    from repro_torch.kernels import ref
    torch.testing.assert_close(dense_matmul(x, w16), ref.matmul_ref(x, w16),
                               rtol=2e-4, atol=2e-4)
    with pytest.raises(TypeError, match="w must be"):
        dense_matmul(x, torch.randn(32, 8, device="cuda").half())
    with pytest.raises(ValueError, match="but w on"):
        dense_matmul(x, torch.randn(32, 8))
    with pytest.raises(TypeError, match="x must be"):
        fir_conv1d(x.double(), torch.randn(16, 3, device="cuda").double())
    fc = BlockSparseFC(np.ones((8, 32), np.float32))
    with pytest.raises(ValueError, match="the layer on"):
        fc(x.cpu())
    with pytest.raises(TypeError, match="x must be"):
        fc(x.half())


# --------------------------------------------------------------------------
# the LM slice: flash attention, the SSD cell, the forward
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bh,sq,sk,d,group,causal", [
    (2, 37, 37, 64, 1, True), (4, 300, 300, 128, 2, True),
    (2, 1, 1, 128, 1, True), (4, 70, 130, 128, 2, False),
    (2, 130, 70, 32, 1, True), (2, 65, 200, 100, 2, False),
    (4, 700, 700, 128, 2, True), (2, 257, 129, 64, 2, False),
    (4, 300, 300, 112, 1, True), (4, 300, 300, 112, 1, False),
    (4, 37, 1500, 64, 1, False)])
def test_flash_kernel_equals_plain(bh, sq, sk, d, group, causal, dtype):
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = _kmod("flash_attention")
    rng = np.random.default_rng(bh + sq + sk + d)
    q = _cuda(rng.normal(size=(bh, sq, d)), dtype)
    k = _cuda(rng.normal(size=(bh // group, sk, d)), dtype)
    v = _cuda(rng.normal(size=(bh // group, sk, d)), dtype)
    path = mod.attention_path(q, k, v)
    assert path == ("f32" if dtype == torch.float32 else
                    "wgmma" if d % 8 == 0 else "mma_sync")
    before = mod.flash_attention.launches
    on_path = mod.flash_attention.launches_by_path[path]
    got = mod.flash_attention(q, k, v, causal=causal, group=group)
    torch.cuda.synchronize()
    assert mod.flash_attention.launches == before + 1
    assert mod.flash_attention.launches_by_path[path] == on_path + 1
    bq, bk = mod.kernel_tiles(path)
    want = mod.flash_attention_plain(q, k, v, causal=causal, group=group,
                                     bq=bq, bk=bk)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    if dtype == torch.float32:      # tests/test_kernels.py's tolerance
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:   # chip_smoke.py's attn_bf16: one bf16 unit, 2^-6 of a row's rms
        w = want.float()
        limit = 2.0 ** -7 * w.abs() \
            + 2.0 ** -6 * w.square().mean(-1, keepdim=True).sqrt()
        assert bool(((got.float() - w).abs() <= limit).all())


def test_flash_kernels_side_by_side():
    """The wgmma and mma.sync kernels on the same bf16 operands, at heads
    of 128 and of 112 (zamba2-7b's, zero-filled by TMA to a 128-wide
    tile), each agree with the plain version at their own tiles; the
    wgmma kernel refuses a head width it does not take (d % 8 != 0)."""
    _need_card()
    mod = _kmod("flash_attention")
    rng = np.random.default_rng(21)
    for d in (128, 112):
        q = _cuda(rng.normal(size=(4, 300, d)), torch.bfloat16)
        k, v = (_cuda(rng.normal(size=(2, 300, d)), torch.bfloat16)
                for _ in range(2))
        for path in ("wgmma", "mma_sync"):
            got = mod.launch(q, k, v, path, causal=True, group=2)
            bq, bk = mod.kernel_tiles(path)
            w = mod.flash_attention_plain(q, k, v, causal=True, group=2,
                                          bq=bq, bk=bk).float()
            limit = 2.0 ** -7 * w.abs() \
                + 2.0 ** -6 * w.square().mean(-1, keepdim=True).sqrt()
            assert bool(((got.float() - w).abs() <= limit).all()), (d, path)
    with pytest.raises(ValueError, match="wgmma kernel does not take"):
        mod.launch(q[..., :36].contiguous(), k[..., :36].contiguous(),
                   v[..., :36].contiguous(), "wgmma", causal=True, group=2)


def _ssd_args(bc, h, q, p, n, steep, dtypes):
    """Seeded inputs of one SSD call, each in its own dtype (xdt, bb, cc,
    cs); the steep ones overflow exp(cs_i - cs_j) above the diagonal."""
    rng = np.random.default_rng(q + n)
    step = rng.uniform(1.0, 4.0, (bc, h, q)) if steep else \
        rng.uniform(0.005, 1.0, (bc, h, q))
    return (_cuda(rng.normal(size=(bc, h, q, p)), dtypes[0]),
            _cuda(rng.normal(size=(bc, q, n)), dtypes[1]),
            _cuda(rng.normal(size=(bc, q, n)), dtypes[2]),
            _cuda(np.cumsum(-step, axis=-1), dtypes[3]))


def _ssd_f64_share(got, plain, exact):
    """chip_smoke.py's tf32x3 rule on one SSD output: max |got - f64| over
    4 max |plain f32 - f64| + 2^-24 max |f64|."""
    limit = 4 * float((plain.double() - exact).abs().max()) \
        + 2.0 ** -24 * float(exact.abs().max())
    return float((got.double() - exact).abs().max()) / limit


def _ssd_holds(args, outs, wgmma):
    """Both outputs f32, finite, within 1e-5 max |ref| of the plain
    version; a wgmma output also within the tf32x3 rule of the f64 cell."""
    from repro_torch.kernels import ref
    plain = ref.ssd_intra_ref(*args)
    exact = ref.ssd_intra_ref(*args, dtype=torch.float64)
    for got, want, ex in zip(outs, plain, exact):
        assert got.dtype == F32 and torch.isfinite(got).all()
        diff = float((got - want).abs().max())
        assert diff <= 1e-5 * float(want.abs().max())
        if wgmma:
            assert _ssd_f64_share(got, want, ex) <= 1.0


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("bc,h,q,p,n,steep", [
    (2, 3, 8, 4, 5, False), (1, 2, 64, 8, 6, True), (2, 4, 256, 64, 128, True),
    (1, 2, 100, 70, 70, False), (3, 5, 128, 64, 64, False),
    (2, 17, 256, 64, 192, False), (1, 1, 64, 64, 64, False),
    (2, 3, 192, 64, 128, True), (4, 1, 256, 64, 128, True)])
def test_ssd_kernel_equals_plain(bc, h, q, p, n, steep, dtype):
    """The kernel ``ssd_path`` names (its launch counted on its path)
    against the plain version, max |d| <= 1e-5 max |ref| per output, in
    f32 from f32 or bf16 inputs, and a wgmma one also within the tf32x3
    rule of the f64 cell; the first design, the thread-fed variant and the
    wgmma design at other heads a CTA on the same inputs hold too (Q = 64:
    one row tile; one head: a warpgroup without heads)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ssd_intra
    mod = _kmod("ssd_intra")
    args = _ssd_args(bc, h, q, p, n, steep, [dtype] * 4)
    path = mod.ssd_path(*args)
    assert path == ("wgmma" if p == 64 and q % 64 == 0 and n % 64 == 0
                    else "simt")
    before = dict(mod.ssd_intra.launches_by_path)
    y, s = ssd_intra(*args)
    torch.cuda.synchronize()
    assert mod.ssd_intra.launches_by_path == {
        k: v + (k == path) for k, v in before.items()}
    _ssd_holds(args, (y, s), path == "wgmma")
    if path == "wgmma":
        _ssd_holds(args, mod.launch(*args, "simt"), False)
        _ssd_holds(args, mod.launch(*args, "wgmma_thread_fed"), True)
        for heads in {1, min(h, 3), min(h, 8)}:   # not ssd_plan's choice
            _ssd_holds(args, mod.launch(*args, "wgmma", heads=heads), True)
        with pytest.raises(ValueError, match="heads a CTA"):
            mod.launch(*args, "wgmma", heads=9)


@pytest.mark.parametrize("mask", range(16))
def test_ssd_wgmma_dtype_mixes(mask):
    """Every mix of f32 and bf16 inputs (bit 0 xdt, 1 bb, 2 cc, 3 cs), one
    instantiation each, at mamba2-370m's cell widths with a steep decay:
    both rules, and run again for the same bits."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    mod = _kmod("ssd_intra")
    args = _ssd_args(2, 9, 256, 64, 128, True,
                     [BF16 if mask >> i & 1 else F32 for i in range(4)])
    assert mod.ssd_path(*args) == "wgmma"
    got = mod.launch(*args, "wgmma")
    _ssd_holds(args, got, True)
    again = mod.launch(*args, "wgmma")
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_lm_forward_launches_flash_once_a_layer():
    """qwen3-0.6b scaled down on the card: 2 launches in one forward, and
    logits within 2e-5 max |logit| of the blockwise path (f32)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config("qwen3-0.6b").scaled_down(use_pallas_attention=True)
    params = transformer.init_params(cfg, seed=0)
    toks = torch.tensor(np.random.default_rng(0).integers(0, 256, (2, 77)),
                        device="cuda")
    mod = _kmod("flash_attention")
    mod.flash_attention.launches = 0
    got = transformer.forward(cfg, params, toks)
    torch.cuda.synchronize()
    assert mod.flash_attention.launches == cfg.num_layers
    want = transformer.forward(dataclasses.replace(
        cfg, use_pallas_attention=False), params, toks)
    assert float((got - want).abs().max()) <= 2e-5 * float(want.abs().max())


def test_lm_kernels_refuse_what_they_do_not_take():
    _need_card()
    mod = _kmod("flash_attention")
    q = torch.randn(2, 8, 256, device="cuda")
    with pytest.raises(ValueError, match="d <= 128"):
        mod.flash_attention(q, q, q)
    q = torch.randn(2, 8, 16, device="cuda")
    with pytest.raises(TypeError, match="k must be"):
        mod.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="lie on"):
        mod.flash_attention(q, q.cpu(), q.cpu())
    from repro_torch.kernels import ssd_intra
    x = torch.randn(1, 2, 4, 3, device="cuda")
    bb = torch.randn(1, 4, 5, device="cuda")
    with pytest.raises(TypeError, match="cs must be"):
        ssd_intra(x, bb, bb, torch.randn(1, 2, 4, device="cuda").double())


def test_prefill_launches_flash_once_a_layer_and_decode_agrees():
    """qwen3-0.6b scaled down on the card, f32: 2 launches in prefill, its
    logits and 6 decode steps' within 2e-5 max |logit| of the forward's."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = get_config("qwen3-0.6b").scaled_down(use_pallas_attention=True)
    params = transformer.init_params(cfg, seed=0)
    toks = torch.tensor(np.random.default_rng(0).integers(0, 256, (2, 40)),
                        device="cuda")
    full = transformer.forward(cfg, params, toks)
    mod = _kmod("flash_attention")
    mod.flash_attention.launches = 0
    got, cache = transformer.prefill(cfg, params, toks[:, :34], 48)
    torch.cuda.synchronize()
    assert mod.flash_attention.launches == cfg.num_layers
    scale = float(full.abs().max())
    assert float((got - full[:, 33]).abs().max()) <= 2e-5 * scale
    for pos in range(34, 40):
        got, cache = transformer.decode_step(cfg, params, cache,
                                             toks[:, pos], pos)
        assert float((got - full[:, pos]).abs().max()) <= 2e-5 * scale
    assert cache["k"].device.type == "cuda"


def _mamba2_on_card():
    """mamba2-370m at small widths the SSD kernel's wgmma design takes
    (P = 64, N = 64, chunk 64), f32, on the card, with the conv taps x 500
    and ``dt_bias`` 0 so that the SSD's output matters to the logits (the
    init recipe leaves it 1e-6 of the skip path's)."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba2
    cfg = get_config("mamba2-370m").scaled_down(ssm_headdim=64,
                                                ssm_state=64, ssm_chunk=64)
    params = mamba2.init_params(cfg, seed=0)
    layers = params["layers"]
    layers["conv_w"] = layers["conv_w"] * 500.0
    layers["dt_bias"] = torch.zeros_like(layers["dt_bias"])
    return cfg, params


def test_mamba2_forward_launches_ssd_once_a_layer_and_decode_agrees():
    """Two launches of the wgmma SSD kernel in one forward over 2 chunks;
    logits within 2e-5 max |logit| of the same forward with the plain cell
    (3xTF32 keeps f32 accuracy) and 16 decode steps within 1e-4 (the
    recurrent form)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ref
    from repro_torch.models import mamba2
    cfg, params = _mamba2_on_card()
    toks = torch.tensor(np.random.default_rng(1).integers(0, 256, (2, 128)),
                        device="cuda")
    mod = _kmod("ssd_intra")
    mod.ssd_intra.launches = 0
    for p in mod.ssd_intra.launches_by_path:
        mod.ssd_intra.launches_by_path[p] = 0
    got = mamba2.forward(cfg, params, toks)
    torch.cuda.synchronize()
    assert mod.ssd_intra.launches == cfg.num_layers
    assert mod.ssd_intra.launches_by_path["wgmma"] == cfg.num_layers
    kernel = mamba2.ssd_intra
    mamba2.ssd_intra = ref.ssd_intra_ref
    try:
        want = mamba2.forward(cfg, params, toks)
    finally:
        mamba2.ssd_intra = kernel
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-5 * scale
    cache = mamba2.init_cache(cfg, 2)
    for pos in range(16):
        step, cache = mamba2.decode_step(cfg, params, cache, toks[:, pos],
                                         pos)
        assert float((step - got[:, pos]).abs().max()) <= 1e-4 * scale


def _plain_logits(cfg, fn, *args):
    """``fn`` with the plain attention and the plain SSD cell."""
    from repro_torch.kernels import ref
    from repro_torch.models import mamba2
    kernel = mamba2.ssd_intra
    mamba2.ssd_intra = ref.ssd_intra_ref
    try:
        return fn(dataclasses.replace(cfg, use_pallas_attention=False),
                  *args)
    finally:
        mamba2.ssd_intra = kernel


def _count(mod, name):
    wrapper = getattr(mod, name)
    wrapper.launches = 0
    for p in wrapper.launches_by_path:
        wrapper.launches_by_path[p] = 0
    return wrapper


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_on_card_launches_by_path_and_decode_agrees(dtype):
    """zamba2 at small widths on the card, 3 layers (one super-block of 2
    and one trailing block), heads of 112 as zamba2-7b's and SSD cells the
    wgmma kernel takes (P = N = 64, chunk 64): one forward launches the
    attention kernel once (``wgmma`` in bf16, ``f32`` in f32) and the
    SSD kernel 3 times on wgmma; its logits agree with the plain versions'
    (f32: 2e-5 max |logit|; bf16: lm_bf16's 5e-2), and in f32 16 decode
    steps with the forward (1e-4).  Conv taps x 50 so that the SSD's
    output matters."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import zamba2
    cfg = get_config("zamba2-7b").scaled_down(
        num_layers=3, attn_every=2, d_model=224, num_heads=2,
        num_kv_heads=2, ssm_headdim=64, ssm_state=64, ssm_chunk=64,
        use_pallas_attention=True, param_dtype=dtype, compute_dtype=dtype)
    assert cfg.hd == 112
    params = zamba2.init_params(cfg, seed=0)
    for group in ("mamba_main", "mamba_tail"):
        params[group]["conv_w"] = params[group]["conv_w"] * 50.0
    toks = torch.tensor(np.random.default_rng(1).integers(0, 256, (2, 128)),
                        device="cuda")
    flash = _count(_kmod("flash_attention"), "flash_attention")
    ssd = _count(_kmod("ssd_intra"), "ssd_intra")
    got = zamba2.forward(cfg, params, toks)
    torch.cuda.synchronize()
    path = "f32" if dtype == "float32" else "wgmma"
    assert flash.launches == flash.launches_by_path[path] == 1
    assert ssd.launches == ssd.launches_by_path["wgmma"] == 3
    want = _plain_logits(cfg, zamba2.forward, params, toks)
    scale = float(want.abs().max())
    rel = 2e-5 if dtype == "float32" else 5e-2
    assert float((got - want).abs().max()) <= rel * scale
    if dtype == "float32":
        cache = zamba2.init_cache(cfg, 2, 16)
        for pos in range(16):
            step, cache = zamba2.decode_step(cfg, params, cache,
                                             toks[:, pos], pos)
            assert float((step - got[:, pos]).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_on_card_launches_by_path_and_decode_agrees(dtype):
    """whisper at small widths on the card (2 + 2 layers, heads of 64, 37
    frames): one forward launches the attention kernel 4 times (the
    encoder's non-causal and the decoder's causal ones; ``wgmma`` in bf16,
    ``f32`` in f32), its logits agree with the plain attention's (f32:
    2e-5 max |logit|; bf16: 5e-2), and in f32 ``prefill_cross`` and 12
    decode steps with the forward (1e-4)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import whisper
    cfg = get_config("whisper-small").scaled_down(
        d_model=128, num_heads=2, num_kv_heads=2, encoder_seq=37,
        use_pallas_attention=True, param_dtype=dtype, compute_dtype=dtype)
    params = whisper.init_params(cfg, seed=0)
    rng = np.random.default_rng(2)
    frames = torch.tensor(rng.normal(size=(2, 37, 128)),
                          dtype=getattr(torch, dtype), device="cuda")
    toks = torch.tensor(rng.integers(0, 256, (2, 12)), device="cuda")
    batch = {"frames": frames, "tokens": toks}
    flash = _count(_kmod("flash_attention"), "flash_attention")
    got = whisper.forward(cfg, params, batch)
    torch.cuda.synchronize()
    path = "f32" if dtype == "float32" else "wgmma"
    n = cfg.encoder_layers + cfg.num_layers
    assert flash.launches == flash.launches_by_path[path] == n
    want = _plain_logits(cfg, whisper.forward, params, batch)
    scale = float(want.abs().max())
    rel = 2e-5 if dtype == "float32" else 5e-2
    assert float((got - want).abs().max()) <= rel * scale
    if dtype == "float32":
        cache = whisper.prefill_cross(cfg, params,
                                      whisper.init_cache(cfg, 2, 12), frames)
        for pos in range(12):
            step, cache = whisper.decode_step(cfg, params, cache,
                                              toks[:, pos], pos)
            assert float((step - got[:, pos]).abs().max()) <= 1e-4 * scale


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m", "zamba2-7b"])
def test_engine_on_card_repeats_and_resumes_bitwise(arch, tmp_path):
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serving import Request, ServeEngine
    cfg = get_config(arch).scaled_down(param_dtype="bfloat16",
                                       compute_dtype="bfloat16")
    params = get_model(cfg).init_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, 6).tolist() for _ in range(3)]

    def reqs():
        return [Request(f"r{i}", p, 8) for i, p in enumerate(prompts)]

    ref = ServeEngine(cfg, params, tmp_path / "a", max_len=16).run(reqs())
    assert ServeEngine(cfg, params, tmp_path / "b", max_len=16).run(
        reqs()) == ref
    with pytest.raises(RuntimeError, match="preempted"):
        ServeEngine(cfg, params, tmp_path / "c", max_len=16).run(
            reqs(), fail_after_tokens=3)
    assert ServeEngine(cfg, params, tmp_path / "c", max_len=16).run(
        reqs()) == ref


# --------------------------------------------------------------------------
# Training: the kernels under autograd, the MoE block, the trainer
# --------------------------------------------------------------------------

def _grad_rel(got, want):
    return float((got.float() - want.float()).norm()) / float(
        want.float().norm())


@pytest.mark.parametrize("dtype,rel", [(F32, 1e-4), (BF16, 2e-2)])
def test_flash_autograd_gradient_matches_plain(dtype, rel):
    """A loss through ``ops.flash_attention`` on the card (the kernel under
    its ``autograd.Function``: one launch, none in the backward) has the
    gradient of the same loss through the plain version, within ``rel`` of
    its norm (the backward is the plain version's own product; only the
    forward's roundings, which feed the loss, differ)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.ops import flash_attention
    mod = _kmod("flash_attention")
    rng = np.random.default_rng(0)
    q, k, v = (_cuda(rng.normal(size=shape), dtype).requires_grad_()
               for shape in ((2, 4, 200, 128), (2, 2, 200, 128),
                             (2, 2, 200, 128)))
    before = mod.flash_attention.launches
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out.float() ** 2).sum(), (q, k, v))
    torch.cuda.synchronize()
    assert mod.flash_attention.launches == before + 1
    plain = flash_attention_plain(q.reshape(8, 200, 128),
                                  k.reshape(4, 200, 128),
                                  v.reshape(4, 200, 128), causal=True,
                                  group=2).reshape(2, 4, 200, 128)
    want = torch.autograd.grad((plain.float() ** 2).sum(), (q, k, v))
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert _grad_rel(a, b) <= rel


@pytest.mark.parametrize("dtype,rel", [(F32, 1e-4), (BF16, 2e-2)])
@pytest.mark.parametrize("bc,h,q,p,n", [(2, 4, 64, 64, 64), (2, 3, 8, 4, 5)])
def test_ssd_autograd_gradient_matches_plain(bc, h, q, p, n, dtype, rel):
    """A loss through ``kernels.ssd_intra`` on the card (the wgmma or the
    first design under its ``autograd.Function``: one launch) has the
    plain cell's gradient within ``rel`` of its norm, for every input."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_intra import ssd_intra
    mod = _kmod("ssd_intra")
    args = [a.requires_grad_() for a in
            _ssd_args(bc, h, q, p, n, False, [dtype] * 4)]
    before = mod.ssd_intra.launches
    y, s = ssd_intra(*args)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y ** 2).sum() + (s ** 2).sum(), args)
    torch.cuda.synchronize()
    assert mod.ssd_intra.launches == before + 1
    y2, s2 = ref.ssd_intra_ref(*args)
    want = torch.autograd.grad((y2 ** 2).sum() + (s2 ** 2).sum(), args)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a).all()
        assert _grad_rel(a, b) <= rel


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e"])
def test_moe_block_on_card_equals_cpu(arch):
    """A scaled-down MoE block (f32) on the card against the same block on
    the CPU: identical routing, outputs within rtol 1e-5 and 1e-6 of the
    largest output (f32 sums over D and F in another order; weights at std
    0.2 give outputs of some tens)."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch).scaled_down(capacity_factor=0.5)
    rng = np.random.default_rng(1)
    p = {k: torch.tensor(rng.normal(size=s) * 0.2, dtype=F32)
         for k, s in moe.moe_param_shapes(cfg).items()}
    x = torch.tensor(rng.normal(size=(2, 32, cfg.d_model)), dtype=F32)
    want = moe.moe_block(cfg, p, x)
    got = moe.moe_block(cfg, {k: v.cuda() for k, v in p.items()}, x.cuda())
    cap = moe.expert_capacity(cfg, 32)
    r_cpu = moe._route(cfg, p["router"], x.reshape(2, 32, -1), cap)
    r_card = moe._route(cfg, p["router"].cuda(),
                        x.cuda().reshape(2, 32, -1), cap)
    for a, b in zip(r_cpu[1:], r_card[1:]):
        assert torch.equal(a, b.cpu())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b",
                                  "mamba2-370m"])
def test_loss_through_the_kernels_has_the_plain_gradient(arch):
    """``loss_fn`` of a scaled-down model on the card (f32) through the
    flash kernel or the SSD cell's kernel: every leaf's gradient within
    1e-4 of the same loss's through the plain versions, in norm."""
    _need_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.launch.train import make_grad_fn
    from repro_torch.models import get_model, mamba2
    from repro_torch.optim.adamw import _leaves
    cfg = get_config(arch).scaled_down(use_pallas_attention=True,
                                       ssm_headdim=64, ssm_state=64,
                                       ssm_chunk=64)
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0)
    if cfg.family == "ssm":
        params["layers"]["conv_w"] = params["layers"]["conv_w"] * 50.0
    toks = torch.tensor(np.random.default_rng(0).integers(0, 256, (2, 128)),
                        device="cuda")
    batch = {"tokens": toks, "labels": toks}
    flash, ssd = _kmod("flash_attention"), _kmod("ssd_intra")
    f0, s0 = flash.flash_attention.launches, ssd.ssd_intra.launches
    _, got = make_grad_fn(cfg, api)(params, batch)
    torch.cuda.synchronize()
    if cfg.family == "ssm":
        assert ssd.ssd_intra.launches - s0 == 2 * cfg.num_layers
        kernel = mamba2.ssd_intra
        mamba2.ssd_intra = ref.ssd_intra_ref
        try:
            _, want = make_grad_fn(cfg, api)(params, batch)
        finally:
            mamba2.ssd_intra = kernel
    else:
        assert flash.flash_attention.launches - f0 == 2 * cfg.num_layers
        _, want = make_grad_fn(dataclasses.replace(
            cfg, use_pallas_attention=False), api)(params, batch)
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.isfinite(a).all()
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12


def test_train_on_card_resumes_bitwise(tmp_path):
    """The trainer on the card (scaled-down qwen3-moe in bf16, the flash
    kernel): failed at step 3 and resumed, its final parameter and
    optimizer files equal the uninterrupted run's byte for byte."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.launch.train import SimulatedFailure, train
    cfg = get_config("qwen3-moe-30b-a3b").scaled_down(
        param_dtype="bfloat16", compute_dtype="bfloat16",
        use_pallas_attention=True)
    kw = dict(steps=6, batch=2, seq=64, ckpt_interval=2, log_every=0)
    ref = train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(SimulatedFailure):
        train(cfg, ckpt_dir=str(tmp_path / "b"), fail_at_step=3, **kw)
    res = train(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert res.losses == ref.losses[2:]
    for name in sorted((tmp_path / "a" / "state" / "A").iterdir()):
        for slot in ("A", "B"):
            a = tmp_path / "a" / "state" / slot / name.name
            b = tmp_path / "b" / "state" / slot / name.name
            if b.exists():
                assert a.read_bytes() == b.read_bytes(), (slot, name.name)


def test_mesh_train_on_card_is_bitwise_the_unmeshed_run(tmp_path):
    """``train(mesh=make_host_mesh((1, 1)))`` on the card (scaled-down
    qwen3-moe in bf16, the flash kernel) against ``mesh=None``: the same
    losses and checkpoint files byte for byte; a mesh of more cards than
    are visible raises."""
    _need_card()
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    cfg = get_config("qwen3-moe-30b-a3b").scaled_down(
        param_dtype="bfloat16", compute_dtype="bfloat16",
        use_pallas_attention=True)
    kw = dict(steps=3, batch=2, seq=64, ckpt_interval=3, log_every=0)
    ref = train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    res = train(cfg, ckpt_dir=str(tmp_path / "b"),
                mesh=make_host_mesh((1, 1)), **kw)
    assert res.losses == ref.losses
    from repro_torch.checkpoint import SlotStore
    ma = SlotStore(tmp_path / "a" / "state").manifest()
    mb = SlotStore(tmp_path / "b" / "state").manifest()
    assert ma["leaves"] == mb["leaves"] and ma["meta"] == mb["meta"]
    for name in ma["leaves"]:
        fa = tmp_path / "a" / "state" / ma["slot"] / name
        fb = tmp_path / "b" / "state" / mb["slot"] / name
        assert fa.read_bytes() == fb.read_bytes(), name
    with pytest.raises(ValueError, match="cards"):
        make_host_mesh((torch.cuda.device_count() + 1, 1))


def test_train_step_on_card_runs_no_nondeterministic_op():
    """One training step of scaled-down qwen3-moe and mamba2 (bf16, the
    kernels) under ``torch.use_deterministic_algorithms(True,
    warn_only=True)``: no operation warns that it has no deterministic
    implementation (the embedding's index accumulation among the
    suspects)."""
    _need_card()
    import warnings
    from repro_torch.configs import get_config
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import get_model
    from repro_torch.optim import adamw
    for arch in ("qwen3-moe-30b-a3b", "mamba2-370m"):
        cfg = get_config(arch).scaled_down(
            param_dtype="bfloat16", compute_dtype="bfloat16",
            use_pallas_attention=True, ssm_headdim=64, ssm_state=64,
            ssm_chunk=64)
        api, opt = get_model(cfg), adamw(lr=1e-3)
        params = api.init_params(cfg, seed=0)
        toks = torch.tensor(np.random.default_rng(0).integers(
            0, 256, (2, 64)), device="cuda")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                make_train_step(cfg, api, opt)(
                    params, opt.init(params),
                    {"tokens": toks, "labels": toks})
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        bad = [str(w.message) for w in caught
               if "does not have a deterministic implementation"
               in str(w.message)]
        assert not bad, (arch, bad)
