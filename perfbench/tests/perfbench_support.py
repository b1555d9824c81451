"""Shared pieces of the benchmark's tests: the harness on the import path,
a tiny network in place of the configuration's, the cells' own traffic at
a few lanes, and a run on the CPU with its output captured."""

from __future__ import annotations

import contextlib
import io
import json
import sys
import time
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
for p in (PERFBENCH, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from fleetbench import runner, spec  # noqa: E402

#: A network of the configurations' layer kinds with a few hundred rows a
#: plan, so a replay on the CPU takes well under a second.
TINY = {"name": "tiny", "network": "tiny", "input_shape": [1, 12, 12],
        "layers": [
            {"type": "conv", "name": "conv1", "out": 2, "in": 1, "kh": 3,
             "kw": 3},
            {"type": "pool", "kh": 2, "kw": 2},
            {"type": "fc", "name": "fc1", "out": 6, "in": 50, "relu": True},
            {"type": "fc", "name": "fc2", "out": 3, "in": 6,
             "relu": False}],
        "weights_seed": 0, "input_seed": 42}

#: A network whose TAILS plan outlasts a 1mF charge (711 rows, 1.28e6
#: cycles), so the closed form's lanes reboot and a lower precision shows.
TINY_REBOOTS = {"name": "tiny", "network": "tiny", "input_shape": [1, 64, 64],
                "layers": [
                    {"type": "conv", "name": "conv1", "out": 3, "in": 1,
                     "kh": 5, "kw": 5},
                    {"type": "pool", "kh": 4, "kw": 4},
                    {"type": "fc", "name": "fc1", "out": 6, "in": 675,
                     "relu": True},
                    {"type": "fc", "name": "fc2", "out": 3, "in": 6,
                     "relu": False}],
                "weights_seed": 0, "input_seed": 42}

CELLS = ("har.design-space", "mnist.stats-query")


def tiny_cell(workload: str, trace: bool = False):
    """``workload``'s cell with a tiny network, its own traffic mix at a
    few devices (the chunked mixes in chunks of 8) and two checked lanes a
    candidate."""
    cell = spec.find_cell(spec.load_benchmark(), workload, trace)
    design = len(cell.traffic["candidates"]) > 1
    cell.config = TINY if design else TINY_REBOOTS
    sweep = cell.traffic["sweep"]
    sweep["n_devices"] = 6 if design else 16
    if "lane_chunk" in sweep:
        sweep["lane_chunk"] = 8
    cell.traffic["check"]["lanes_per_candidate"] = 2
    return cell


def cpu_run(cell, seed: int = 2**31 + 11, seconds: float = 0.2,
            trace: int = 0) -> tuple[int, list, str]:
    """One run of ``cell`` on the CPU: ``(exit code, stdout lines,
    stderr)``."""
    args = runner.parse(["--workload", cell.name, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = runner.Run(cell, args, time.perf_counter(), device="cpu",
                        preloaded=runner.forbidden_modules()).execute()
    return rc, out.getvalue().splitlines(), err.getvalue()


def result(lines: list) -> dict:
    return json.loads(lines[-1])
