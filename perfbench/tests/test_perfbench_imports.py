"""Nothing the runner loads is JAX or the JAX package, compared by whole
top-level name; the reference loads nothing of the program either."""

import ast
import os
import subprocess
import sys

import pytest

from perfbench_support import PERFBENCH, ROOT, core

STDLIB = set(sys.stdlib_module_names)


@pytest.mark.parametrize("modules,bad", [
    (["repro_torch", "repro_torch.core.fleetsim", "torch"], []),
    (["reproduce", "jaxtyping", "flaxen"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.fleetsim"], ["repro"]),
    (["jax._src.core", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen", "numpy"], ["flax"]),
])
def test_forbidden_by_whole_top_level_name(modules, bad):
    assert core.forbidden_modules(modules) == bad


def _loaded(code: str) -> list:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
        capture_output=True, text=True, timeout=120).stdout
    return out.split()


def test_what_the_runner_loads():
    code = (
        "import sys; sys.path[:0] = ['perfbench', 'src']\n"
        "import importlib, torch.profiler\n"
        "from benchcore import core, spec, trace\n"
        "from fleetbench import runner, check, hosttimer, kernels\n"
        "for m in ('core.fleetsim', 'core.inference', 'core.energy',\n"
        "          'runtime.failures', 'kernels.charge_replay',\n"
        "          'kernels.stats_fold'):\n"
        "    importlib.import_module('repro_torch.' + m)\n"
        "print(*core.forbidden_modules() or ['none'])\n")
    assert _loaded(code) == ["none"]


def test_what_the_lm_runner_loads():
    code = (
        "import sys; sys.path[:0] = ['perfbench', 'src']\n"
        "import torch.profiler\n"
        "from benchcore import core, spec\n"
        "from lmbench import runner as lm, check, control, peaks, program\n"
        "c = lm.Run(spec.find_cell(spec.load_benchmark(),\n"
        "           'qwen3-0.6b.chat', True), None, 0.0, 'cpu')\n"
        "c.load_program()\n"
        "program.reference('dense', lm.LMREF)\n"
        "print(*core.forbidden_modules() or ['none'])\n")
    assert _loaded(code) == ["none"]


def test_the_lm_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = ['perfbench']\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('d', 'perfbench/lmref/dense.py')\n"
        "s.loader.exec_module(u.module_from_spec(s))\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(*sorted(top & {'jax', 'jaxlib', 'flax', 'repro',\n"
        "                     'repro_torch', 'fleetbench', 'lmbench',\n"
        "                     'benchcore'})\n"
        "      or ['none'])\n")
    assert _loaded(code) == ["none"]


@pytest.mark.parametrize("path", sorted(
    (PERFBENCH / "lmref").glob("*.py")), ids=lambda p: p.name)
def test_lm_reference_sources_import_torch_and_stdlib_only(path):
    for n in _imports(path):
        top = n.split(".")[0]
        assert top == "torch" or top in STDLIB, (path.name, n)


def _imports(path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names.append(node.module)
    return names


def test_the_reference_loads_nothing_of_the_program():
    code = (
        "import sys; sys.path[:0] = ['perfbench']\n"
        "from fleetref import energy, fold, inference, inputs, nvstore\n"
        "from fleetref import oracle, plan, samplers, vecloop\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(*sorted(top & {'jax', 'jaxlib', 'flax', 'repro',\n"
        "                     'repro_torch', 'torch'}) or ['none'])\n")
    assert _loaded(code) == ["none"]


@pytest.mark.parametrize("path", sorted(
    (PERFBENCH / "fleetref").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_numpy_and_stdlib_only(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                continue
            names = [node.module]
        else:
            continue
        for n in names:
            top = n.split(".")[0]
            assert top == "numpy" or top in STDLIB, (path.name, n)


def test_nothing_reads_the_jax_benchmark_folder():
    """No import of it and no string naming it outside comments and
    docstrings (the frozen copies cite their origins)."""
    folder = "bench" + "marks"
    for path in PERFBENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        docs = {id(n.value) for n in ast.walk(tree)
                if isinstance(n, ast.Expr) and isinstance(n.value,
                                                          ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                assert all(a.name.split(".")[0] != folder
                           for a in node.names), path
            elif isinstance(node, ast.ImportFrom):
                assert (node.module or "").split(".")[0] != folder, path
            elif isinstance(node, ast.Constant) and id(node) not in docs \
                    and isinstance(node.value, str):
                assert folder + "/" not in node.value, path


def test_a_run_that_loads_jax_prints_no_result(monkeypatch):
    """A forbidden module that appears during the run: exit 4, no result
    line (``flax`` unless this worker loaded it already)."""
    from types import ModuleType

    from perfbench_support import CELLS, cpu_run, tiny_cell
    from repro_torch.core import fleetsim

    loaded = core.forbidden_modules()
    name = next((n for n in ("flax", "jaxlib", "jax", "repro")
                 if n not in loaded), None)
    if name is None:
        pytest.skip("every forbidden name is loaded in this worker")
    real = fleetsim.fleet_sweep

    def sweep(*a, **k):
        sys.modules.setdefault(name, ModuleType(name))
        return real(*a, **k)

    monkeypatch.setattr(fleetsim, "fleet_sweep", sweep)
    monkeypatch.delitem(sys.modules, name, raising=False)
    rc, lines, err = cpu_run(tiny_cell(CELLS[1]))
    monkeypatch.delitem(sys.modules, name, raising=False)
    assert rc == 4 and f"loaded ['{name}']" in err
    assert not any('"correct"' in line for line in lines)
