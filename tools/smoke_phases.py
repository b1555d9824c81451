"""Run some of ``chip_smoke.py``'s phases alone on the card.

    python3 tools/smoke_phases.py [--tree TREE] PHASE [PHASE ...]

PHASE is one of ``overlap`` (the JAX package's overlap protocol through the
port), ``streamed_stats`` (the streamed sweep of ``mnist_net()``),
``genesis`` (GENESIS end to end), ``while_oracle`` (the legacy
``backend="_while"`` oracle against the lane kernel), ``mesh``
(``mesh=`` sweeps against unmeshed ones), ``paper_demo``
(``examples/intermittent_mnist_torch.py`` on the card at ``--scale 1.0``,
the JAX example's sizes, where ``chip_smoke.py`` runs it at a tenth; its
Fig. 9 matrix and design space against the CPU's), ``serving (qwen3-0.6b's
prefill, decode and engine, and mamba2-370m's forward, decode and engine),
``moe`` (qwen3-moe-30b-a3b and llama4-scout-17b-a16e at full width, depth
cut), ``vlm`` (internvl2-26b, depth cut), ``train`` (qwen3-0.6b and
mamba2-370m training, the resume and gradient checks), ``hybrid``
(zamba2-7b at full width, depth cut: the attention kernel at heads of
112, the SSD cell at 112 heads) and ``encdec`` (whisper-small as
published: the encoder's non-causal attention over 1,500 keys) and
``lm_mesh`` (qwen3-0.6b trained unmeshed and on a (1, 1) mesh, bitwise;
a dry-run record; the three LM examples) -- these seven build the
attention and SSD kernels only -- or one of two
diagnostics of the
streamed pipeline's producer thread:

* ``host_alone``: three 65,536-lane chunks' host work (the samplers and
  ``_prepare``) timed on the main thread, on a second thread while the
  main one waits on a queue, and on a second thread while the main one
  runs Python (as the closed-form scan's caller does), wall and CPU
  seconds;
* ``unpinned``: the 262,144-lane streamed sweep at prefetch=1 with its
  uploads made through pinned memory and without, in turns.

Each phase prints its JSON lines as ``chip_smoke.py`` does.  TREE (default:
this checkout) is the root of a checkout whose ``src/repro_torch`` is
imported, for example the parent commit unpacked with ``git archive`` into
a directory that ``.gitignore`` lists; the phases' code is this
checkout's.  Two trees compare only within one call on one card, in turns
(parent, change, change, parent).  It needs one card and builds the lane
kernel and the statistics fold for the fleet phases.
"""

import json
import queue
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("overlap", "streamed_stats", "genesis", "while_oracle", "mesh",
          "paper_demo", "serving", "moe", "vlm", "train", "hybrid", "encdec",
          "lm_mesh", "host_alone", "unpinned")
#: The LM phases, each a function of chip_smoke.py taking (torch, np,
#: emit, smi).
LM_PHASES = {"serving": "serving", "moe": "moe_phase", "vlm": "vlm_phase",
             "train": "train_phase", "hybrid": "hybrid_phase",
             "encdec": "encdec_phase", "lm_mesh": "lm_mesh_phase"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def host_alone(np, fleetsim, failures, plan, lanes: int) -> dict:
    """A chunk's host half on three threads' terms."""
    rows = fleetsim._bucket_rows(fleetsim._plan_rows(plan), lane_axis=False)

    def chunk(lo):
        frac = failures.initial_charge_fraction_stream(lanes, seed=42,
                                                       lane_lo=lo)
        jm = failures.harvest_jitter_stream(lanes, seed=42, lane_lo=lo)
        caps = np.full(lanes, plan.capacity)
        tr = failures.reboot_recharge_times_stream(
            lanes, 64, plan.recharge_s, seed=42, lane_lo=lo)
        cum = failures.recharge_trace_cumulative(tr * jm[:, None])
        ctr = failures.charge_capacity_jitter_stream(
            lanes, 64, plan.capacity, seed=42, cv=0.25, lane_lo=lo)
        ccum = failures.charge_trace_cumulative(ctr)
        fleetsim._prepare(rows, caps, caps * frac, True, cum,
                          plan.recharge_s * jm, "adaptive", 4, ccum,
                          len(plan), None, None, None, None, bucketed=True)

    def timed(n=3):
        t, c = time.perf_counter(), time.thread_time()
        for i in range(n):
            chunk(i * lanes)
        return time.perf_counter() - t, time.thread_time() - c

    def on_thread(busy: bool):
        q = queue.Queue()
        th = threading.Thread(target=lambda: q.put(timed()),
                              name="fleetsim-prefetch")
        th.start()
        if busy:
            while th.is_alive():
                sum(i * i for i in range(200))  # Python, the lock held
        out = q.get()
        th.join()
        return out

    chunk(0)
    res = {}
    for _ in range(2):
        res.setdefault("main", []).append(timed())
        res.setdefault("thread_main_waits", []).append(on_thread(False))
        res.setdefault("thread_main_runs_python", []).append(on_thread(True))
    return {k: [{"s": s, "cpu_s": c} for s, c in v] for k, v in res.items()}


def main() -> int:
    args = sys.argv[1:]
    tree = ROOT
    if args[:1] == ["--tree"]:
        tree, args = Path(args[1]).resolve(), args[2:]
    if not args or any(p not in PHASES for p in args):
        print(f"usage: smoke_phases.py [--tree TREE] PHASE ...; phases: "
              f"{PHASES}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import fleetsim
    from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D,
                                            SimNet, SparseFC)
    from repro_torch.kernels import _build
    from repro_torch.kernels import charge_replay as cr
    from repro_torch.models.dnn import mnist_net
    from repro_torch.runtime import failures

    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA card is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    emit({"tool": "smoke_phases", "tree": str(tree), "phases": args,
          "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          **cs.host_threads(torch, np)})
    if any(p not in LM_PHASES for p in args):
        _build.build("charge_replay", "stats_fold")
    wrapper = cr.charge_replay
    x = np.random.default_rng(42).normal(size=(1, 28, 28)).astype(np.float32)
    net = mnist_net()
    classes = (Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC)
    plan = None
    for phase in args:
        t0 = time.perf_counter()
        if phase == "overlap":
            cs.overlap(torch, np, emit, fleetsim, classes)
        elif phase == "genesis":
            cs.genesis(torch, np, emit, fleetsim, cr, wrapper)
        elif phase == "while_oracle":
            emit({"phase": "while_oracle", **cs.while_oracle(
                torch, np, emit, fleetsim, wrapper, classes)})
        elif phase == "paper_demo":
            emit({"phase": "paper_demo", "launches": cs.paper_demo(
                torch, np, emit, fleetsim, smi, scale=1.0)["launches"]})
        elif phase in LM_PHASES:
            _build.build("flash_attention", "ssd_intra")
            getattr(cs, LM_PHASES[phase])(torch, np, emit, smi)
        else:
            if plan is None:
                plan = fleetsim.build_plan(net, x, "tails", "1mF")
            if phase == "mesh":
                emit({"phase": "mesh", "launches": cs.mesh(
                    torch, np, emit, fleetsim, wrapper, net, x, plan)})
            elif phase == "streamed_stats":
                lat = cr.f64_latency(torch.device("cuda"))
                cs.streamed_stats(torch, np, emit, fleetsim, cr,
                                  cs.Recorder(torch, wrapper), wrapper, net,
                                  x, plan, lat)
                cr.charge_replay = wrapper
            elif phase == "host_alone":
                emit({"probe": "host_alone", "lanes": cs.STREAM_CHUNK,
                      **host_alone(np, fleetsim, failures, plan,
                                   cs.STREAM_CHUNK)})
            else:
                emit({"probe": "unpinned", **unpinned(torch, np, cs,
                                                      fleetsim, failures,
                                                      plan)})
        emit({"tool": "smoke_phases", "phase": phase,
              "seconds": time.perf_counter() - t0})
    print(smi, flush=True)
    return 0


def unpinned(torch, np, cs, fleetsim, failures, plan) -> dict:
    """The streamed sweep at prefetch=1, its uploads pinned or not."""
    kw = dict(plan=plan, seed=42, charge_cv=0.25, charge_reboots=64,
              trace_reboots=64, policy="adaptive", theta=0.5, batch_rows=4,
              belief_alpha=0.2, reduce="stats", lane_chunk=cs.STREAM_CHUNK,
              n_devices=cs.STREAM_LANES[0], device="cuda")
    timer = cs.HostTimer(fleetsim, failures)
    pinned_tensor = fleetsim._tensor

    def plain_tensor(a, dev, pinned=False):
        return pinned_tensor(a, dev, False)

    out = {"lanes": cs.STREAM_LANES[0]}
    with timer:
        for label in ("pinned", "unpinned", "unpinned", "pinned"):
            fleetsim._tensor = plain_tensor if label == "unpinned" \
                else pinned_tensor
            try:
                _st, m = cs.timed_sweep(torch, fleetsim, timer, prefetch=1,
                                        **kw)
            finally:
                fleetsim._tensor = pinned_tensor
            out.setdefault(label, []).append(
                {"wall_s": m["wall_s"],
                 "producer_s": m["host"]["producer"]["s"],
                 "producer_cpu_s": m["host"]["producer"]["cpu_s"]})
    return out


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        if "chip_smoke" in sys.modules:
            sys.modules["chip_smoke"].stop_workers()
