"""The shape of a run's output: the result is the last line, its keys as
the contract has them, the compared numbers last on standard error and
under their own key last in the line."""

import json
import subprocess
import sys

import pytest

from perfbench_support import (CELLS, ROOT, cpu_run, fleet_rate, result,
                               tiny_cell)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_last_line(workload, trace):
    rc, lines, err = cpu_run(tiny_cell(workload, bool(trace)), trace=trace)
    assert rc == 0, err
    res = result(lines)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    names = set(res["metrics"])
    rate, pre = fleet_rate(workload)
    if trace:
        assert {"plan_build_s", pre + "host_ms_per_call",
                pre + "sampler_ms_per_call"} <= names
    else:
        assert names == {rate, "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    tail = err.strip().splitlines()[-len(res["checks"]):]
    for line, (name, c) in zip(tail, res["checks"].items()):
        assert line == f"check {name} {c['value']!r} limit {c['limit']!r}"
    for line in lines[:-1]:
        json.loads(line)


def test_no_card_no_result():
    """Without CUDA (or in a tree without the program) the command exits
    non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert not out.stdout.strip()
