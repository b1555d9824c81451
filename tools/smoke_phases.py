"""Run some of ``chip_smoke.py``'s phases alone on the card.

    python3 tools/smoke_phases.py [--tree TREE] PHASE [PHASE ...]

PHASE is one of ``overlap`` (the JAX package's overlap protocol through the
port), ``streamed_stats`` (the streamed sweep of ``mnist_net()``),
``genesis`` (GENESIS end to end), ``closed_form`` (the closed form's
kernel beside the aten per-row graph it replaced, bitwise, at 8,192 and
16,384 lanes of MNIST's tails/1mF query, then the kernels line's
``closed_form`` entry with the launches of this run's phases),
``while_oracle`` (the legacy ``backend="_while"`` oracle against the lane
kernel), ``mesh``
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
diagnostics of the streamed pipeline's producer thread:

* ``host_alone``: three 65,536-lane chunks' host work (the samplers and
  ``_prepare``) timed on the main thread, on a second thread while the
  main one waits on a queue, and on a second thread while the main one
  runs Python (as the closed-form scan's caller does), wall and CPU
  seconds;
* ``unpinned``: the 262,144-lane streamed sweep at prefetch=1 with its
  uploads made through pinned memory and without, in turns;

or ``spans``: the program's spans (``repro_torch.runtime.spans``) on
MNIST's tails plans, over a design sweep and a two-chunk closed-form
statistics query, each off and then on: the plan build's parts, each
layer's host ms a call, the pipeline's waits, the card's idle by host
step (``host_gap_share``), and the closed form's counters
``fleetsim._replay_rows.rows`` and ``closed_form.launches``
(``span_probe``).

Each phase prints its JSON lines as ``chip_smoke.py`` does.  TREE (default:
this checkout) is the root of a checkout whose ``src/repro_torch`` is
imported, for example the parent commit unpacked with ``git archive`` into
a directory that ``.gitignore`` lists; the phases' code is this
checkout's (``overlap``, ``streamed_stats``, ``unpinned`` and ``spans``
read the tree's ``repro_torch.runtime.spans``).  Two trees
compare only within one call on one card, in turns (parent, change,
change, parent).  It needs one card and builds the lane
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
PHASES = ("overlap", "streamed_stats", "genesis", "closed_form",
          "while_oracle", "mesh",
          "paper_demo", "serving", "moe", "vlm", "train", "hybrid", "encdec",
          "lm_mesh", "host_alone", "unpinned", "spans")
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
        _build.build("charge_replay", "closed_form", "stats_fold")
    wrapper = cr.charge_replay
    x = np.random.default_rng(42).normal(size=(1, 28, 28)).astype(np.float32)
    net = mnist_net()
    classes = (Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC)
    plan = None
    closed_lines, closed_launches = None, {}
    for phase in args:
        t0 = time.perf_counter()
        if phase == "overlap":
            cs.overlap(torch, np, emit, fleetsim, classes)
        elif phase == "genesis":
            closed_launches["genesis"] = cs.genesis(
                torch, np, emit, fleetsim, cr, wrapper)[
                "closed_form_launches"]
        elif phase == "while_oracle":
            emit({"phase": "while_oracle", **cs.while_oracle(
                torch, np, emit, fleetsim, wrapper, classes)})
        elif phase == "paper_demo":
            demo = cs.paper_demo(torch, np, emit, fleetsim, smi, scale=1.0)
            closed_launches["paper_demo"] = demo["closed_form_launches"]
            emit({"phase": "paper_demo", "launches": demo["launches"]})
        elif phase in LM_PHASES:
            _build.build("flash_attention", "ssd_intra")
            getattr(cs, LM_PHASES[phase])(torch, np, emit, smi)
        elif phase == "spans":
            emit(span_probe(torch, np, cs, fleetsim, net, x))
        else:
            if plan is None:
                plan = fleetsim.build_plan(net, x, "tails", "1mF")
            if phase == "closed_form":
                closed_lines = cs.closed_form_phase(torch, np, emit,
                                                    fleetsim, plan)
                closed_launches["closed_form"] = sum(
                    ln["launches"] for ln in closed_lines)
            elif phase == "mesh":
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
                                                      fleetsim, plan)})
        emit({"tool": "smoke_phases", "phase": phase,
              "seconds": time.perf_counter() - t0})
    if closed_lines is not None:
        emit({"kernels": [cs.closed_form_entry(closed_lines,
                                               closed_launches)]})
    print(smi, flush=True)
    return 0


#: The ``spans`` probe: devices of the design sweep (a candidate) and of
#: the closed-form query, the query's chunk, timed calls a path, the seed.
SPAN_DEVICES = (8192, 16384)
SPAN_CHUNK = 8192
SPAN_CALLS = 2
SPAN_SEED = 3000000001


def span_probe(torch, np, cs, fleetsim, net, x, device="cuda",
               devices=SPAN_DEVICES, chunk=SPAN_CHUNK,
               calls=SPAN_CALLS) -> dict:
    """The program's spans over the two paths the benchmark's cells run:
    a design sweep (tails at 100uF and 1mF in one ``PlanSet``, jittered
    charges and recharge traces: the lane kernel in plan mode) and a
    closed-form statistics query (tails at 1mF, nominal charges, in
    chunks through the overlapped pipeline).  The plans are built with
    spans on (the ``plan_build`` spans' seconds).  Each path runs once
    with spans off, then ``calls`` times with spans on (CUDA events on a
    card), each answer bitwise that of spans off; the closed form's
    counters, zeroed just before, must count each chunk's rows and, on a
    card, one kernel launch a chunk.  Gives
    ``chip_smoke.span_report`` for each path."""
    from repro_torch.kernels import closed_form as cf
    from repro_torch.runtime import spans

    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    spans.reset()
    spans.enable()
    try:
        t0 = time.perf_counter()
        query = fleetsim.build_plan(net, x, "tails", "1mF")
        design = fleetsim.PlanSet.from_plans([fleetsim.build_plan(
            net, x, "tails", "100uF",
            ref=(query.ref_output, query.max_atomic)), query])
        build_s = time.perf_counter() - t0
    finally:
        spans.disable()
    out = {"probe": "spans", "device": device, "plan_build_s": build_s,
           "plan_build_spans_s": {
               v["name"]: v["caller"]["wall_s"]
               for v in spans.snapshot().values()
               if v["layer"] == "plan_build"}}
    paths = {"design": dict(plan=design, n_devices=devices[0],
                            charge_cv=0.25, charge_reboots=64,
                            trace_reboots=16),
             "query": dict(plan=query, n_devices=devices[1],
                           lane_chunk=chunk)}
    rr, scan = fleetsim._replay_rows, cf.closed_form
    for name, kw in paths.items():
        kw.update(seed=SPAN_SEED, recharge_cv=0.25, reduce="stats",
                  device=device)
        off = fleetsim.fleet_sweep(**kw)         # also the warm-up
        sync()
        spans.reset()
        spans.enable()
        rr.rows = scan.launches = 0              # just before
        walls = []
        try:
            for _ in range(calls):
                t0 = time.perf_counter()
                on = fleetsim.fleet_sweep(**kw)
                sync()
                walls.append(time.perf_counter() - t0)
                bad = cs.stats_equal(np, off, on)
                if bad:
                    raise SystemExit(f"spans: the {name} sweep with spans "
                                     f"on != off on {bad}")
        finally:
            spans.disable()
        counted = (rr.rows, scan.launches)       # just after
        line = {"wall_s": walls, "replay_rows": counted[0],
                "kernel_launches": counted[1],
                **cs.span_report(spans.snapshot(), calls, sum(walls))}
        if name == "query":
            chunks = -(-devices[1] // chunk)
            want = (calls * chunks * len(query),
                    calls * chunks if device == "cuda" else 0)
            if counted != want:
                raise SystemExit(f"spans: the closed form counted (rows, "
                                 f"launches) {counted}, not {want}")
        out[name] = line
    spans.reset()
    return out


def unpinned(torch, np, cs, fleetsim, plan) -> dict:
    """The streamed sweep at prefetch=1, its uploads pinned or not; the
    producer's host seconds from the program's spans."""
    from repro_torch.runtime import spans

    kw = dict(plan=plan, seed=42, charge_cv=0.25, charge_reboots=64,
              trace_reboots=64, policy="adaptive", theta=0.5, batch_rows=4,
              belief_alpha=0.2, reduce="stats", lane_chunk=cs.STREAM_CHUNK,
              n_devices=cs.STREAM_LANES[0], device="cuda")
    pinned_tensor = fleetsim._tensor

    def plain_tensor(a, dev, pinned=False):
        return pinned_tensor(a, dev, False)

    out = {"lanes": cs.STREAM_LANES[0]}
    spans.enable(events=False)
    try:
        for label in ("pinned", "unpinned", "unpinned", "pinned"):
            fleetsim._tensor = plain_tensor if label == "unpinned" \
                else pinned_tensor
            try:
                _st, m = cs.timed_sweep(torch, fleetsim, prefetch=1, **kw)
            finally:
                fleetsim._tensor = pinned_tensor
            out.setdefault(label, []).append(
                {"wall_s": m["wall_s"],
                 "producer_s": m["host"]["producer"]["s"],
                 "producer_cpu_s": m["host"]["producer"]["cpu_s"]})
    finally:
        spans.disable()
    return out


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        if "chip_smoke" in sys.modules:
            sys.modules["chip_smoke"].stop_workers()
