"""The check's control (the reference in the program's place, in float32)
comes out not correct, at a size a test run can hold; on the card, at the
cells' own size, by ``perfbench/control.py``."""

import json
import subprocess
import sys

import pytest

from perfbench_support import CELLS, FLEET_CELLS, PERFBENCH, ROOT, tiny_cell
from fleetbench import control


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("seed", [5, 2**31 + 17, 2**40 + 1])
def test_control_fails_the_lanes_check(workload, seed):
    r = control.reading(tiny_cell(workload), seed, calls=2)
    assert r["lanes"] > r["limit"]
    assert r["lanes"] >= 3 * max(r["limit"], 1e-16)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read on the chip's "
                    "host at the cells' own size")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", FLEET_CELLS)
def test_control_at_the_cells_size(card, workload):
    out = subprocess.run(
        [sys.executable, str(PERFBENCH / "control.py"), "--workload",
         workload, "--seed", "11", "12", "13"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr
    for line in out.stdout.splitlines():
        assert json.loads(line)["control_fails"]
