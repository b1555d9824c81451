"""The port's three LM examples (``examples/quickstart_torch.py``,
``serve_preemptible_torch.py``, ``train_llm_torch.py``, the twins of the
JAX package's) run to their end on the CPU in a subprocess with
``--device cpu``, each printing what its JAX twin prints."""

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


def test_examples_default_to_the_card():
    for name in ("quickstart_torch.py", "serve_preemptible_torch.py",
                 "train_llm_torch.py"):
        text = (ROOT / "examples" / name).read_text()
        assert 'ap.add_argument("--device", default="cuda")' in text
        assert "import jax" not in text and "from repro." not in text
