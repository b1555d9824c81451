"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package ``repro``, in any module."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
PORT_FILES = sorted(p.relative_to(SRC).as_posix()
                    for p in (SRC / "repro_torch").rglob("*.py"))

#: An import statement naming jax, jaxlib or repro (not repro_torch).
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:\.|\s|$)", re.M)


def test_import_loads_no_jax_and_no_repro():
    """Importing the package and every module of the slice loads no
    ``jax*`` and no ``repro``/``repro.*`` module."""
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.device\n"
        "import repro_torch.core, repro_torch.core.fleetsim\n"
        "import repro_torch.kernels, repro_torch.kernels.charge_replay\n"
        "import repro_torch.kernels._build\n"
        "import repro_torch.models, repro_torch.runtime\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_port_files_found():
    assert "repro_torch/kernels/charge_replay.py" in PORT_FILES
    assert "repro_torch/core/fleetsim.py" in PORT_FILES


@pytest.mark.parametrize("rel", PORT_FILES)
def test_source_imports_no_jax_and_no_repro(rel):
    text = (SRC / rel).read_text()
    hits = _FORBIDDEN.findall(text)
    assert not hits, f"{rel} imports {hits}"
