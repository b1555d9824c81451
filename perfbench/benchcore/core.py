"""The command's entry for every cell, and what every kind of run shares.

``main`` finds the cell, fixes the program's cache directories, checks for
the cards and hands the cell to its kind's run: a configuration file's
``kind`` (absent: ``"fleet"``) names the package ``perfbench/<kind>bench/``,
whose ``runner.Run`` runs it, so a new kind is a package of its own and no
edit here.  ``control_main`` hands ``perfbench/control.py``'s cell to that
package's ``control.main`` alike.  A run ends in :func:`finish`, which
prints the compared numbers and the result line.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys

from . import spec, trace

#: Top-level module names that must not be loaded when the window closes:
#: JAX and the JAX package (``repro``), compared whole (``repro_torch``
#: starts with ``repro`` and is the program).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def parse(argv):
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def forbidden_modules(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def kind_module(cell, name: str):
    """``perfbench/<kind>bench/<name>.py`` of ``cell``'s configuration."""
    kind = cell.config.get("kind", "fleet")
    if not (spec.HERE / f"{kind}bench" / f"{name}.py").is_file():
        raise SystemExit(f"perfbench: {cell.name}'s configuration has an "
                         f"unknown kind {kind!r}")
    return importlib.import_module(f"{kind}bench.{name}")


def run_class(cell):
    """The run of ``cell``'s kind of configuration."""
    return kind_module(cell, "runner").Run


def main(argv, t_start: float) -> int:
    args = parse(argv)
    root = spec.ROOT
    cell = spec.find_cell(spec.load_benchmark(root), args.workload,
                          bool(args.trace), root)
    # every build and kernel cache of the program inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(root / "src"))
    return run_class(cell)(cell, args, t_start).execute()


def control_main(argv=None) -> int:
    """``perfbench/control.py``: ``--workload`` and ``--seed`` here, the
    rest of the arguments for the kind's ``control.main(cell, seeds,
    rest)``."""
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    args, rest = ap.parse_known_args(argv)
    cell = spec.find_cell(spec.load_benchmark(), args.workload, False)
    sys.path.insert(0, str(spec.ROOT / "src"))
    return kind_module(cell, "control").main(cell, args.seed, rest)


def finish(run, correct: bool, attempted: int, failed: int, metrics: dict,
           checks: list, mem_peak: int, summary, cuda: bool) -> int:
    """The run's last lines: exit 4 with no result where a forbidden module
    was loaded (and not ``run.preloaded``), 5 where a traced run's trace
    held no device event; else the compared numbers beside their limits
    on standard error, and the result line last on standard output."""
    import torch

    bad = [m for m in forbidden_modules() if m not in run.preloaded]
    if bad:
        print(f"perfbench: loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": run.cell.chips, "memory_peak_bytes": mem_peak}
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device}
    if run.args.trace and cuda:
        if summary is None:
            print("perfbench: the profiler's trace held no device "
                  "event", file=sys.stderr)
            return 5
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    emit(result)
    return 0


def start_trace(timer):
    """The profiler on, the host timer's ranges on, and the traced call's
    range open."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA])
    prof.__enter__()
    timer.annotate = True
    rng = torch.profiler.record_function(trace.CALL_RANGE)
    rng.__enter__()
    return prof, rng


def stop_trace(prof, rng, timer):
    """The traced call's range closed, the profiler off: its events."""
    rng.__exit__(None, None, None)
    timer.annotate = False
    prof.__exit__(None, None, None)
    return prof.profiler.kineto_results.events()


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
