"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package ``repro``, nor ``ml_dtypes`` (which JAX brings; an install of the
port without JAX need not have it), in any module."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT_FILES = sorted(p.relative_to(SRC).as_posix()
                    for p in (SRC / "repro_torch").rglob("*.py"))

#: An import statement naming jax, jaxlib, ml_dtypes or repro (not
#: repro_torch).
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|ml_dtypes|repro)(?:\.|\s|$)",
    re.M)


def test_import_loads_no_jax_and_no_repro():
    """Importing the package and every module of the slice loads no
    ``jax*``, no ``ml_dtypes`` and no ``repro``/``repro.*`` module."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.device\n"
        "import repro_torch.core, repro_torch.core.fleetsim\n"
        "import repro_torch.core.fleetstats\n"
        "import repro_torch.kernels.stats_fold\n"
        "import repro_torch.kernels, repro_torch.kernels.charge_replay\n"
        "import repro_torch.kernels._build, repro_torch.kernels._launch\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.calibrate\n"
        "import repro_torch.kernels.ref, repro_torch.kernels.dense_matmul\n"
        "import repro_torch.kernels.sparse_fc\n"
        "import repro_torch.kernels.fir_conv1d\n"
        "import repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.ssd_intra\n"
        "import repro_torch.configs, repro_torch.models.config\n"
        "import repro_torch.models.layers, repro_torch.models.transformer\n"
        "import repro_torch.models.api, repro_torch.models.counting\n"
        "from repro_torch.configs import ARCHS, get_config\n"
        "[get_config(a) for a in ARCHS]\n"
        "import repro_torch.compress, repro_torch.compress.prune\n"
        "import repro_torch.compress.genesis, repro_torch.compress.svd\n"
        "import repro_torch.compress.tucker\n"
        "import repro_torch.compress.train_small\n"
        "import repro_torch.compress.svm_baseline\n"
        "import repro_torch.core.imp, repro_torch.data\n"
        "import repro_torch.data.synthetic\n"
        "import repro_torch.optim, repro_torch.optim.adamw\n"
        "import repro_torch.models, repro_torch.runtime\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'repro'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_port_files_found():
    assert "repro_torch/kernels/charge_replay.py" in PORT_FILES
    assert "repro_torch/core/fleetsim.py" in PORT_FILES
    assert "repro_torch/core/fleetstats.py" in PORT_FILES
    for name in ("ops", "calibrate", "ref", "dense_matmul", "sparse_fc",
                 "fir_conv1d", "_launch", "flash_attention", "ssd_intra",
                 "stats_fold"):
        assert f"repro_torch/kernels/{name}.py" in PORT_FILES
    for name in ("prune", "genesis", "svd", "tucker", "train_small",
                 "svm_baseline"):
        assert f"repro_torch/compress/{name}.py" in PORT_FILES
    for name in ("core/imp", "data/__init__", "data/synthetic",
                 "optim/__init__", "optim/adamw"):
        assert f"repro_torch/{name}.py" in PORT_FILES
    for name in ("config", "layers", "transformer", "api", "counting"):
        assert f"repro_torch/models/{name}.py" in PORT_FILES
    for name in ("__init__", "qwen3_0_6b", "qwen1_5_0_5b", "mamba2_370m"):
        assert f"repro_torch/configs/{name}.py" in PORT_FILES


@pytest.mark.parametrize("rel", PORT_FILES)
def test_source_imports_no_jax_and_no_repro(rel):
    text = (SRC / rel).read_text()
    hits = _FORBIDDEN.findall(text)
    assert not hits, f"{rel} imports {hits}"
