"""The CUDA lane kernel on the card: it must equal the plain PyTorch
version bitwise on every output channel, count its launches, and refuse
CPU tensors.  Every test skips, from inside the test, where no card is
visible; run them on the card with ``python -m pytest -m gpu``."""

import dataclasses

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
    tfs.fleet_sweep(**kw)
    assert cr.charge_replay.launches == before + 1
    tfs.fleet_sweep(backend="torch", **kw)
    tfs.fleet_sweep(plan=plan, n_devices=8, seed=1, device="cuda")
    assert cr.charge_replay.launches == before + 1


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
