"""The port's examples (``examples/quickstart_torch.py``,
``serve_preemptible_torch.py``, ``train_llm_torch.py`` and
``intermittent_mnist_torch.py``, the twins of the JAX package's) run to
their end on the CPU in a subprocess with ``--device cpu``, each printing
what its JAX twin prints; the paper's demonstration at ``--scale 0.01
--smoke`` (MNIST's layers at a few channels: the published widths take
the CPU's plain replay many minutes)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run_example(name, *args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                          "--device", "cpu", *args], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_quickstart_trains_resumes_and_serves():
    out = run_example("quickstart_torch.py")
    assert "!! injected failure at step 17" in out
    assert "resumed and finished: ran 20 more steps" in out
    assert "generated: [" in out and out.rstrip().endswith("done.")


def test_serve_preemptible_resumes_identically():
    out = run_example("serve_preemptible_torch.py")
    assert "!! preempted" in out
    assert "identical to an unpreempted run: True" in out


def test_train_llm_runs(tmp_path):
    out = run_example("train_llm_torch.py", "--steps", "3", "--batch", "4",
                      "--seq", "32", "--ckpt-dir", str(tmp_path))
    assert "config: 4L d=256 vocab=32768" in out
    assert "trained 3 steps" in out


def test_intermittent_mnist_runs():
    out = run_example("intermittent_mnist_torch.py", "--scale", "0.01",
                      "--smoke")
    lines = out.splitlines()
    at = []
    for header in ("GENESIS: ", "impl          continuous",
                   "10-device fleet on the 1 mF capacitor",
                   "uplink co-simulation: 10 sonic devices",
                   "design-space sweep: 15 candidates x 1 devices",
                   "adaptive-commit risk on a ",
                   "10000-device fleet-level query"):
        hits = [i for i, ln in enumerate(lines) if header in ln]
        assert hits, header
        at.append(hits[0])
    assert at == sorted(at)
    assert "peak lane buffer: " in out
    assert lines[-2].startswith("section walls: genesis=")
    assert lines[-1].startswith("kernel launches: charge_replay/shared=0")


def test_examples_default_to_the_card():
    for name in ("quickstart_torch.py", "serve_preemptible_torch.py",
                 "train_llm_torch.py", "intermittent_mnist_torch.py"):
        text = (ROOT / "examples" / name).read_text()
        assert 'ap.add_argument("--device", default="cuda")' in text
        assert "import jax" not in text and "from repro." not in text
        tops = set()
        for node in ast.walk(ast.parse(text)):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops.add((node.module or "").split(".")[0])
        assert not tops & {"jax", "jaxlib", "repro", "benchmarks"}, name
