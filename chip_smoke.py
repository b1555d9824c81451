#!/usr/bin/env python3
"""Drive the PyTorch port's fleet replay on one CUDA card and check it.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py

It imports the port (``src/repro_torch``), torch and numpy only, and
prints one JSON line per phase; any failure exits non-zero.

1. device  -- the card's name and count, and its ``nvidia-smi`` name and
   power limit.  With no card visible the script exits non-zero at once.
2. build   -- nvcc builds every kernel from the checkout's sources (one
   nvcc per source, all started together) and prints the ptxas register
   and spill lines.
3. kernel_vs_plain -- small random networks (seeded numpy) through the
   entry points, covering the flag combinations the tests cover; every
   kernel launch's inputs are replayed through the plain PyTorch version
   on the card and every output channel must agree bitwise.
4. full_width -- the main path at the published widths: ``fleet_sweep``
   of ``mnist_net()`` under tails/adaptive, sonic/fixed and tails with the
   uplink radio, over thousands of devices.  Launch counts are zeroed
   just before and read just after; every kernel must have launched.  The
   kernel is held against the plain version on the first run's inputs,
   and the first 4 lanes of a full-width ``har_net()`` replay are held
   bitwise too.
5. the kernels line, the ``nvidia-smi`` line, and the result line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: H100 SXM peaks (NVIDIA data sheet): FP64 outside the tensor cores, and
#: HBM3 bandwidth.
PEAK_F64_OPS = 34e12
PEAK_BYTES = 3.35e12

#: A floor on the f64 operations of one event, counted from
#: csrc/charge_replay.cu: the row context (~12), the phase-0 and row-phase
#: scalar arithmetic of charge_once (~60) and the 17-wide class update
#: (at least 4 operations per class).  Every row costs at least one event.
MIN_F64_OPS_PER_EVENT = 12 + 60 + 4 * 17

#: Lanes of the full-width sweeps; lower them if the time limit forces it.
FULL_LANES = 16384
RADIO_LANES = 4096
HAR_LANES = 4096


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def random_net(seed: int, classes):
    """A random small network and input, deterministic in ``seed`` (the
    recipe of the tests' ``make_random_net``)."""
    import numpy as np

    Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC = classes
    rng = np.random.default_rng(seed)
    ci, h = 1, int(rng.integers(8, 12))
    co = int(rng.integers(2, 5))
    k = int(rng.integers(2, 4))
    w1 = (rng.normal(size=(co, ci, k, k)) * 0.5).astype(np.float32)
    if rng.random() < 0.5:
        w1 *= (rng.random(w1.shape) < 0.4)
    layers = [Conv2D(w1, rng.normal(size=co).astype(np.float32))]
    oh = h - k + 1
    if oh % 2 == 0 and rng.random() < 0.7:
        layers.append(MaxPool2D(2))
        oh //= 2
    feat = co * oh * oh
    m = int(rng.integers(4, 9))
    layers.append(DenseFC((rng.normal(size=(m, feat)) * 0.2
                           ).astype(np.float32),
                          rng.normal(size=m).astype(np.float32)))
    out = int(rng.integers(3, 6))
    wsp = (rng.normal(size=(out, m)) * (rng.random((out, m)) < 0.4)
           ).astype(np.float32)
    layers.append(SparseFC(wsp, rng.normal(size=out).astype(np.float32),
                           relu=False))
    net = SimNet(layers, input_shape=(ci, h, h), name=f"rand{seed}")
    x = rng.normal(size=(ci, h, h)).astype(np.float32)
    return net, x


class Recorder:
    """Stands in for the kernel wrapper while the entry points run: times
    each launch with CUDA events and keeps its inputs, so the same inputs
    can be replayed through the plain version.  The launch count stays on
    the wrapper itself."""

    def __init__(self, torch, wrapper):
        self.torch, self.wrapper = torch, wrapper
        self.calls = []

    def __call__(self, *args, **kw):
        ev0 = self.torch.cuda.Event(enable_timing=True)
        ev1 = self.torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = self.wrapper(*args, **kw)
        ev1.record()
        self.calls.append(dict(args=args, kw=kw, events=(ev0, ev1),
                               out=out))
        return out


def compare(torch, a: dict, b: dict) -> tuple[bool, float, list]:
    """Bitwise comparison of two replays' output channels (NaN == NaN);
    returns (equal, max abs difference over finite entries, bad channels)."""
    bad, err = [], 0.0
    for k, x in a.items():
        y = b[k]
        if x.dtype == torch.bool:
            same = torch.equal(x, y)
            diff = float((x != y).sum())
        else:
            same = bool(((x == y) | (torch.isnan(x) & torch.isnan(y))).all())
            fin = torch.isfinite(x) & torch.isfinite(y)
            diff = float((x - y).abs()[fin].max()) if bool(fin.any()) \
                else 0.0
        if not same:
            bad.append(k)
        err = max(err, diff)
    return not bad, err, bad


def lane_slice(args, kw, n: int, shared_rows: bool):
    """The first ``n`` lanes of a captured wrapper call."""
    rows, rest = args[0], args[1:]
    if not shared_rows:
        rows = {k: v[:n] for k, v in rows.items()}
    rest = tuple(a[:n].contiguous() if hasattr(a, "dim") and a.dim() >= 1
                 else a for a in rest)
    kw = dict(kw, conf=kw["conf"][:n].contiguous())
    return (rows,) + rest, kw


def replay_bound_ms(args, kw, out, torch) -> tuple[float, str, dict]:
    """The least time the card could take for one replay: bytes (each
    input read once, each output written once) over HBM bandwidth, and a
    floor on the f64 operations (one event per real row) over the FP64
    peak; the larger bounds it."""
    rows = args[0]
    s_real = args[7]
    n_lanes = int(s_real.shape[0])
    in_bytes = sum(v.numel() * 8 for v in rows.values())   # packed f64
    in_bytes += sum(a.numel() * a.element_size() for a in args[1:8])
    in_bytes += kw["conf"].numel() * 8 + kw["radio"].numel() * 8
    out_bytes = sum(v.numel() * v.element_size() for v in out.values())
    events = int(s_real.to(torch.int64).sum())
    ops = events * MIN_F64_OPS_PER_EVENT
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_F64_OPS * 1e3
    info = dict(lanes=n_lanes, bytes=in_bytes + out_bytes,
                f64_ops_floor=ops, bytes_ms=t_bytes, ops_ms=t_ops)
    if t_ops >= t_bytes:
        return t_ops, "operations", info
    return t_bytes, "bytes", info


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import fleetsim
    from repro_torch.core.energy import custom_power_system, \
        rf_recharge_seconds
    from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D,
                                            SimNet, SparseFC)
    from repro_torch.kernels import _build
    from repro_torch.kernels import charge_replay as cr
    from repro_torch.models.dnn import har_net, mnist_net
    from repro_torch.runtime.failures import (charge_capacity_jitter,
                                              reboot_recharge_times)
    from repro_torch.runtime.radio import (RadioModel, SEND_POLICIES,
                                           pack_radio)

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "not measured"
    emit({"phase": "device", "name": name, "count": count,
          "nvidia_smi": smi_line, "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- 2. build every kernel of the path
    built = _build.build("charge_replay")
    for b in built.values():
        ptxas = [ln.strip() for ln in b.log.splitlines()
                 if "registers" in ln or "spill" in ln or "stack" in ln]
        emit({"phase": "build", "kernel": b.name, "seconds": b.seconds,
              "flags": " ".join(_build.NVCC_FLAGS), "ptxas": ptxas})

    wrapper = cr.charge_replay
    rec = Recorder(torch, wrapper)
    cr.charge_replay = rec
    classes = (Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC)
    max_err = 0.0

    def check_calls(label, calls):
        nonlocal max_err
        for c in calls:
            a, kw = c["args"], c["kw"]
            plain = cr.event_replay(*a, **kw)
            again = wrapper(*a, **kw)
            torch.cuda.synchronize()
            for ref_name, ref in (("plain", plain), ("relaunch", again)):
                ok, err, bad = compare(torch, c["out"], ref)
                max_err = max(max_err, err)
                if not ok:
                    raise SystemExit(f"{label}: kernel != {ref_name} on "
                                     f"{bad} (max abs diff {err})")

    # ---- 3. kernel against the plain version on small random nets
    def restamp(seed, strat, frac, parametric=False):
        net, x = random_net(seed, classes)
        p = fleetsim.build_plan(net, x, strat, "1mF", parametric=parametric)
        cap = max(2000.0, float(np.rint(frac * p.total_cycles)))
        return fleetsim.dataclasses.replace(
            p, capacity=cap, recharge_s=float(rf_recharge_seconds(cap)))

    def per_lane(plans, policy, theta, w, alpha, cv, n_ch, seed, **kw):
        n = len(plans)
        rng = np.random.default_rng(seed)
        caps = np.asarray([p.capacity for p in plans])
        ctr = charge_capacity_jitter(n, n_ch, caps, seed=seed, cv=cv)
        rtr = reboot_recharge_times(n, 16, plans[0].recharge_s,
                                    seed=seed + 1)
        return fleetsim.replay_plans(
            plans, init_frac=rng.uniform(0.02, 1.0, n), policy=policy,
            theta=theta, batch_rows=w, belief_alpha=alpha,
            charge_traces=ctr, recharge_traces=rtr, **kw)

    def burn_plan():
        net, x = random_net(3, classes)
        for cyc in (2000, 3000, 5000, 8000, 12000):
            p = fleetsim.build_plan(net, x, "tails", custom_power_system(cyc))
            if (p.kind == fleetsim.KIND_BURN).any():
                return p
        raise SystemExit("kernel_vs_plain: no tails plan with BURN rows")

    window = RadioModel(window_period_s=0.05, window_duty=0.3)
    sonic = restamp(0, "sonic", 0.2)
    sonic_small = restamp(1, "sonic", 0.08)
    tile8 = restamp(2, "tile-8", 0.3)
    tails = restamp(1, "tails", 0.15)
    ptails = [restamp(1, "tails", f, parametric=True)
              for f in (0.05, 0.12, 0.3, 0.6)]
    burn = burn_plan()
    net3, x3 = random_net(3, classes)
    policies = (("fixed", 0.5, 1, 0.0), ("adaptive", 0.5, 1, 0.0),
                ("adaptive", 0.5, 4, 0.0), ("adaptive", 0.5, 1, 0.2),
                ("adaptive", 0.25, 4, 0.2))
    cases = []
    for pol in policies:
        for plan, n_ch in ((sonic, 48), (sonic_small, 6), (tile8, 48),
                           (tails, 48)):
            cases.append((f"{plan.strategy}/{pol}/{n_ch}",
                          lambda plan=plan, pol=pol, n_ch=n_ch: per_lane(
                              [plan] * 6, *pol, 0.4, n_ch, seed=n_ch,
                              device="cuda")))
        cases.append((f"tails-param/{pol}",
                      lambda pol=pol: per_lane(ptails * 2, *pol, 0.4, 48,
                                               seed=9, device="cuda")))
        cases.append((f"tails-burn/{pol}",
                      lambda pol=pol: fleetsim.fleet_sweep(
                          plan=burn, n_devices=64, seed=5, charge_cv=0.4,
                          trace_reboots=8, policy=pol[0], theta=pol[1],
                          batch_rows=pol[2], belief_alpha=pol[3],
                          device="cuda")))
        cases.append((f"sonic-radio/{pol}",
                      lambda pol=pol: fleetsim.fleet_sweep(
                          net3, x3, "sonic", "100uF", n_devices=64, seed=3,
                          charge_cv=0.4, trace_reboots=8, policy=pol[0],
                          theta=pol[1], batch_rows=pol[2],
                          belief_alpha=pol[3],
                          radio=pack_radio(window, SEND_POLICIES[1]),
                          device="cuda")))
    inf_plan = fleetsim.dataclasses.replace(sonic, capacity=np.inf)
    cases.append(("cap-inf/radio", lambda: per_lane(
        [sonic, inf_plan, sonic, inf_plan], "adaptive", 0.5, 2, 0.1, 0.4, 12,
        seed=4, radio=pack_radio(window, SEND_POLICIES[0]),
        conf=np.array([0.95, 0.5, 0.99, 0.2]), device="cuda")))
    t0 = time.perf_counter()
    n_calls = n_lanes = 0
    flags = set()
    for label, run in cases:
        rec.calls = []
        run()
        torch.cuda.synchronize()
        if not rec.calls:
            raise SystemExit(f"kernel_vs_plain: {label} launched no kernel")
        check_calls(label, rec.calls)
        for c in rec.calls:
            n_calls += 1
            n_lanes += int(c["args"][1].shape[0])
            kw = c["kw"]
            flags.add((kw["adaptive"], kw["parametric"], kw["shared_rows"],
                       kw["enable_fast"], kw["has_burn"], kw["has_send"]))
    for need in ("adaptive", "parametric", "shared_rows", "enable_fast",
                 "has_burn", "has_send"):
        j = ("adaptive", "parametric", "shared_rows", "enable_fast",
             "has_burn", "has_send").index(need)
        if not any(f[j] for f in flags) or all(f[j] for f in flags):
            raise SystemExit(f"kernel_vs_plain: flag {need} not covered "
                             "both ways")
    emit({"phase": "kernel_vs_plain", "configs": len(cases),
          "launches": n_calls, "lanes": n_lanes,
          "flag_combinations": len(flags), "bitwise_equal": True,
          "max_abs_err": max_err,
          "seconds": time.perf_counter() - t0})

    # ---- 4. the main path at full width
    x = np.random.default_rng(42).normal(size=(1, 28, 28)).astype(np.float32)
    net = mnist_net()
    t0 = time.perf_counter()
    plan_tails = fleetsim.build_plan(net, x, "tails", "1mF")
    build_tails = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan_sonic = fleetsim.build_plan(net, x, "sonic", "1mF")
    build_sonic = time.perf_counter() - t0
    runs = (
        ("mnist/tails/adaptive", plan_tails, build_tails, FULL_LANES,
         dict(policy="adaptive", theta=0.5, batch_rows=4, belief_alpha=0.2)),
        ("mnist/sonic/fixed", plan_sonic, build_sonic, FULL_LANES,
         dict(policy="fixed")),
        ("mnist/tails/adaptive/radio-topk-hedge", plan_tails, build_tails,
         RADIO_LANES,
         dict(policy="adaptive", theta=0.5, batch_rows=4, belief_alpha=0.2,
              radio=pack_radio(window, SEND_POLICIES[1]))),
    )
    rec.calls = []
    wrapper.launches = 0                  # zero just before the main path
    results = []
    for label, plan, build_s, lanes, kw in runs:
        before = wrapper.launches
        res = fleetsim.fleet_sweep(plan=plan, n_devices=lanes, seed=42,
                                   charge_cv=0.25, trace_reboots=64,
                                   device="cuda", **kw)
        torch.cuda.synchronize()
        results.append((label, plan, build_s, lanes, kw, res,
                        wrapper.launches - before))
    main_launches = wrapper.launches      # read just after
    main_calls = rec.calls
    for (label, plan, build_s, lanes, kw, res, delta), call in zip(
            results, main_calls):
        ev0, ev1 = call["events"]
        ms = ev0.elapsed_time(ev1)
        classes_sum = res.classes.sum(-1)
        live = res.energy_j / fleetsim.JOULES_PER_CYCLE
        if delta <= 0:
            raise SystemExit(f"{label}: the kernel did not launch")
        if not np.array_equal(classes_sum, call["out"]["live"].cpu().numpy()):
            raise SystemExit(f"{label}: classes.sum(-1) != live")
        if kw["policy"] == "fixed" and np.any(res.wasted_cycles != 0.0):
            raise SystemExit(f"{label}: wasted != 0 under fixed commits")
        done = res.completed
        if not (np.isfinite(live[done]).all()
                and np.isfinite(res.dead_s[done]).all()):
            raise SystemExit(f"{label}: non-finite channels")
        line = {"phase": "full_width", "run": label, "plan_rows": len(plan),
                "lanes": lanes, "plan_build_s": build_s, "kernel_ms": ms,
                "lanes_per_s": lanes / (ms / 1e3), "launches": delta,
                "completion_rate": float(done.mean()),
                "mean_reboots": float(res.reboots.mean()),
                "classes_sum_equals_live": True}
        if "radio" in kw:
            line["tx_bytes"] = float(res.tx_bytes.sum())
            line["msgs_deferred"] = float(res.msgs_deferred.sum())
        emit(line)
    if main_launches < len(runs):
        raise SystemExit("full_width: fewer launches than runs")

    # kernel against plain on the first run's full-width inputs, and timing
    first = main_calls[0]
    a, kw = first["args"], first["kw"]
    t0 = time.perf_counter()
    plain = cr.event_replay(*a, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    ok, err, bad = compare(torch, first["out"], plain)
    max_err = max(max_err, err)
    if not ok:
        raise SystemExit(f"full_width: kernel != plain on {bad}")
    times = []
    for _ in range(3):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        wrapper(*a, **kw)
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1))
    bound_ms, bound_by, bound_info = replay_bound_ms(a, kw, first["out"],
                                                     torch)
    emit({"phase": "full_width_vs_plain", "run": results[0][0],
          "lanes": int(a[1].shape[0]), "bitwise_equal": True,
          "kernel_ms": times, "plain_ms": plain_ms, "bound_ms": bound_ms,
          "bound_by": bound_by, **bound_info})

    # the first 4 lanes of a full-width har_net tails replay, bitwise
    x_har = np.random.default_rng(7).normal(size=(3, 1, 112)).astype(
        np.float32)
    rec.calls = []
    fleetsim.fleet_sweep(har_net(), x_har, "tails", "1mF",
                         n_devices=HAR_LANES, seed=7, charge_cv=0.25,
                         trace_reboots=64, policy="adaptive", theta=0.5,
                         batch_rows=4, belief_alpha=0.2, device="cuda")
    torch.cuda.synchronize()
    har = rec.calls[0]
    a4, kw4 = lane_slice(har["args"], har["kw"], 4,
                         har["kw"]["shared_rows"])
    t0 = time.perf_counter()
    plain4 = cr.event_replay(*a4, **kw4)
    torch.cuda.synchronize()
    har_plain_ms = (time.perf_counter() - t0) * 1e3
    full4 = {k: v[:4] for k, v in har["out"].items()}
    ok, err, bad = compare(torch, full4, plain4)
    max_err = max(max_err, err)
    if not ok:
        raise SystemExit(f"har: kernel != plain on {bad}")
    emit({"phase": "har_first_lanes", "plan_rows": int(a4[7].max()),
          "lanes": HAR_LANES, "checked_lanes": 4, "bitwise_equal": True,
          "plain_ms": har_plain_ms})
    cr.charge_replay = wrapper

    # ---- 5. the kernels line, the card, the result
    emit({"kernels": [{
        "name": "charge_replay", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/charge_replay.cu",
        "replaces": "src/repro/kernels/charge_replay.py:907",
        "replaces_function": "pallas_replay",
        "launches": main_launches, "max_abs_err": max_err,
        "max_abs_diff_vs_plain": max_err,
        "ms": min(times), "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "shape": f"{results[0][0]}: {len(results[0][1])} rows x "
                 f"{int(a[1].shape[0])} lanes"}]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
