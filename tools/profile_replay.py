#!/usr/bin/env python3
"""Profile the fleet replay's lane kernel on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 tools/profile_replay.py [--design hoisted|direct]

It builds ``csrc/charge_replay.cu`` a second time with ``-DREPLAY_PROFILE``
(``_build``'s ``charge_replay_profile``), in which either design of the
lane kernel (``--design``; the wrapper's default, the main path's, when
omitted) stamps ``clock64()`` laps around its regions (the row context,
the event head, ``charge_once``'s scalar part, class loop and rest,
``fast_forward``, BURN/CALIB rows, the dead-time tail), counts events, and
samples each warp's active lanes where a region starts.
Then it drives ``chip_smoke.py``'s two 16,384-lane runs (mnist tails
adaptive, mnist sonic fixed) through ``fleet_sweep`` on that build and
prints, per run, one JSON line: cycles and laps per event, event counts,
the share of a warp's 32 lanes active at each site (branch efficiency),
the blocks and SMs the grid used, and the SM clock (cycles over
``%globaltimer`` nanoseconds).  The stamps serialize the code around them,
so the laps are a breakdown, not the normal build's time: the normal
build's time is printed beside them.  Also printed: ptxas's registers,
stack and spills of both builds, each kernel's SASS instruction count
(where ``cuobjdump`` is in the toolkit), and the dependent f64 add and
multiply latency.  Everything goes to stdout, a JSON object a line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

REGIONS = ("ctx", "head", "charge_once_rest", "fast_forward", "burn_calib",
           "tail", "charge_once_scalar", "charge_once_classes")
COUNTS = ("events", "charge_once", "fast_forward", "burn_calib", "torn")
SITES = ("loop", "charge_once", "fast_forward", "torn")
SLOTS, SMS = 64, 256


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sass_sizes(lib_path) -> dict:
    """Instructions in each kernel's SASS, by mangled name."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        text = subprocess.run([tool, "-sass", str(lib_path)],
                              capture_output=True, text=True,
                              timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    sizes, name = {}, None
    for ln in text.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            sizes[name] = 0
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln):
            sizes[name] += 1
    return sizes


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--design", default=None,
                    help="the lane kernel design to launch (the wrapper's "
                         "default when omitted)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_replay: no CUDA card is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.core import fleetsim
    from repro_torch.kernels import _build
    from repro_torch.kernels import charge_replay as cr
    from repro_torch.models.dnn import mnist_net

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    built = _build.build("charge_replay", "charge_replay_profile")
    for b in built.values():
        emit({"phase": "build", "library": b.name, "seconds": b.seconds,
              "ptxas": [ln.strip() for ln in b.log.splitlines()
                        if "registers" in ln or "stack" in ln
                        or "spill" in ln],
              "sass_instructions": sass_sizes(b.path)})

    # the dependent f64 latency, on the normal build
    emit({"phase": "f64_latency", "ops": 1 << 16,
          **cr.f64_latency(torch.device("cuda"))})

    prof = built["charge_replay_profile"].lib
    prof.charge_replay_profile_reset.restype = ctypes.c_int
    prof.charge_replay_profile_read.restype = ctypes.c_int
    prof.charge_replay_profile_read.argtypes = [ctypes.c_void_p]
    real_load = _build.load

    def load(name):
        return built["charge_replay_profile"] if name == "charge_replay" \
            else real_load(name)

    x = np.random.default_rng(42).normal(size=(1, 28, 28)).astype(np.float32)
    net = mnist_net()
    runs = (("mnist/tails/adaptive", "tails",
             dict(policy="adaptive", theta=0.5, batch_rows=4,
                  belief_alpha=0.2)),
            ("mnist/sonic/fixed", "sonic", dict(policy="fixed")))
    kw_design = {} if args.design is None else {"design": args.design}
    for label, strategy, kw in runs:
        plan = fleetsim.build_plan(net, x, strategy, "1mF")
        sweep = dict(plan=plan, n_devices=16384, seed=42, charge_cv=0.25,
                     trace_reboots=64, device="cuda", **kw)
        # the normal build's time first, then the profile build's counters
        times = {}
        for lib_name in ("charge_replay", "charge_replay_profile"):
            _build.load = load if lib_name != "charge_replay" else real_load
            calls = []
            wrapper = cr.charge_replay

            def timed(*a, **k):
                k.update(kw_design)
                ev0 = torch.cuda.Event(enable_timing=True)
                ev1 = torch.cuda.Event(enable_timing=True)
                ev0.record()
                o = wrapper(*a, **k)
                ev1.record()
                calls.append((ev0, ev1))
                return o

            cr.charge_replay = timed
            # the normal build twice (the first launch of a process is
            # slower), the profile build once, its counters zeroed first
            for _ in range(2 if lib_name == "charge_replay" else 1):
                if lib_name == "charge_replay_profile":
                    prof.charge_replay_profile_reset()
                fleetsim.fleet_sweep(**sweep)
                torch.cuda.synchronize()
            cr.charge_replay = wrapper
            times[lib_name] = calls[-1][0].elapsed_time(calls[-1][1])
        _build.load = real_load
        raw = (ctypes.c_ulonglong * (SLOTS + SMS))()
        if prof.charge_replay_profile_read(raw):
            raise SystemExit("profile_replay: reading the counters failed")
        acc = list(raw)
        lanes, total, events = acc[0], acc[1], acc[16]
        blocks = [b for b in acc[SLOTS:] if b]
        emit({"phase": "profile", "run": label, "lanes": lanes,
              "kernel_ms": times["charge_replay"],
              "profile_build_ms": times["charge_replay_profile"],
              "events_per_lane": events / lanes,
              "cycles_per_event": total / events,
              "max_lane_cycles": acc[2],
              "sm_clock_ghz": total / acc[12],
              "laps_per_event": {r: acc[3 + i] / events
                                 for i, r in enumerate(REGIONS)},
              "lap_shares": {r: acc[3 + i] / total
                             for i, r in enumerate(REGIONS)},
              "counts": {c: acc[16 + i] for i, c in enumerate(COUNTS)},
              "active_lane_share": {
                  s: (acc[48 + i] / (32 * acc[32 + i]) if acc[32 + i]
                      else None) for i, s in enumerate(SITES)},
              "warp_executions": {s: acc[32 + i]
                                  for i, s in enumerate(SITES)},
              "sms_used": len(blocks), "max_blocks_per_sm": max(blocks)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
