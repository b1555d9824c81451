"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's.

The JAX dry run is run in a subprocess, because importing
``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices, which
would change the other test files of an xdist worker.  It prints its
``cell_list()`` and, for every applicable cell on both production meshes
under the three strategies, the state bytes its ``run_cell`` records
(``sharded_bytes`` of the parameters, plus the AdamW state under ZeRO-1
for a train cell or the caches for a decode cell), from ``build_cell``
without compiling.  The port's records must give the same cells, the same
skip reasons (``repro.models.cell_applicable``) and the same bytes.

The step's FLOPs are traced on meta tensors.  The count extrapolated from
one and two layers of each stack equals the full-depth trace exactly on
small shapes of every family.  The trace is integer-exact, so qwen3-0.6b's
full-width counts are pinned to the figure: its train_4k step counts
1.54x ``counting.model_flops`` (6 N tokens; the remat recompute adds a
forward, 8/6, and the attention scores the rest), its prefill_32k 3.37x
(2 N tokens, and attention over 32K keys at d_model 1,024).  A trace that
lost the recompute or counted the backward twice would move them.
"""

import json
import os
import subprocess
import sys

import pytest

from repro.configs import get_config as jax_config
from repro.models import cell_applicable as jax_applicable
from repro_torch.configs import get_config
from repro_torch.launch import dryrun
from repro_torch.launch.shardings import set_strategy
from repro_torch.models import SHAPES
from repro_torch.models.config import ShapeCell

SCRIPT = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
from repro.launch.shardings import set_strategy
from repro.configs import get_config
from repro.models import cell_applicable
from repro.models.config import SHAPES

state = {}
for strategy in ("tp", "dp", "ep"):
    set_strategy(strategy)
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        for arch, shape in dryrun.cell_list():
            cfg, cell = get_config(arch), SHAPES[shape]
            if not cell_applicable(cfg, cell)[0]:
                continue
            built = dryrun.build_cell(cfg, cell, mesh)
            b = dryrun.sharded_bytes(built[1][0], built[2][0])
            if cell.kind in ("train", "decode"):
                b += dryrun.sharded_bytes(built[1][1], built[2][1])
            state[f"{strategy}/{int(mp)}/{arch}/{shape}"] = int(b)
print(json.dumps({"cells": dryrun.cell_list(), "state": state}))
"""


@pytest.fixture(scope="module")
def jax_dryrun():
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", SCRIPT, src], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(autouse=True)
def _reset_strategy():
    set_strategy("tp")
    yield
    set_strategy("tp")


def test_cell_list_equals_jax_s(jax_dryrun):
    assert [list(c) for c in dryrun.cell_list()] == jax_dryrun["cells"]


@pytest.mark.parametrize("strategy", ["tp", "dp", "ep"])
def test_every_cell_status_and_state_bytes_equal_jax_s(jax_dryrun,
                                                       monkeypatch,
                                                       strategy):
    """Every cell of ``cell_list()`` on both meshes (the trace stubbed
    out: it is checked below): ``skipped`` with JAX's reason or ``ok``
    with JAX's state bytes."""
    monkeypatch.setattr(dryrun, "step_flops", lambda cfg, cell: 1)
    n_ok = n_skip = 0
    for mp in (False, True):
        for arch, shape in dryrun.cell_list():
            rec = dryrun.run_cell(arch, shape, mp, strategy=strategy)
            ok, reason = jax_applicable(jax_config(arch), SHAPES[shape])
            assert rec["chips"] == (512 if mp else 256)
            assert rec["mesh"] == ("2x16x16" if mp else "16x16")
            if not ok:
                assert rec["status"] == "skipped"
                assert rec["skip_reason"] == reason
                n_skip += 1
                continue
            assert rec["status"] == "ok"
            key = f"{strategy}/{int(mp)}/{arch}/{shape}"
            assert rec["memory"]["state_bytes_per_device"] == \
                jax_dryrun["state"][key], key
            n_ok += 1
    assert n_ok == len([k for k in jax_dryrun["state"]
                        if k.startswith(strategy + "/")])
    assert n_skip == 2 * 8             # long_500k for the 8 quadratic archs


#: qwen3-0.6b's traced step FLOPs on the 16 x 16 mesh (remat "full").
QWEN3_FLOPS = {"train_4k": 7277667464249344,
               "prefill_32k": 5313664819134464,
               "decode_32k": 1114644676608}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_qwen3_cells(shape):
    rec = dryrun.run_cell("qwen3-0.6b", shape, False)
    ok, reason = jax_applicable(jax_config("qwen3-0.6b"), SHAPES[shape])
    if not ok:
        assert rec["status"] == "skipped" and rec["skip_reason"] == reason
        return
    assert rec["status"] == "ok" and rec["kind"] == SHAPES[shape].kind
    assert rec["flops_global"] == QWEN3_FLOPS[shape]
    ratio = rec["flops_global"] / rec["model_flops"]
    assert ratio == rec["flops_over_model_flops"]
    if rec["kind"] in ("train", "prefill"):
        assert round(ratio, 2) == {"train": 1.54, "prefill": 3.37}[
            rec["kind"]], ratio
    assert rec["memory"]["fits_hbm"] is None or isinstance(
        rec["memory"]["fits_hbm"], bool)
    for key in ("live_bytes_per_device", "fits_16GB_hbm"):
        assert key not in rec["memory"]
    for key in ("xla_cost", "hlo", "compile_s"):
        assert key not in rec


#: qwen3-0.6b's traced train_4k step FLOPs under each remat policy.
REMAT_FLOPS = {"none": 5923069138829312, "dots": 6538795650383872,
               "full": QWEN3_FLOPS["train_4k"]}


@pytest.mark.parametrize("remat", list(REMAT_FLOPS))
def test_train_flops_grow_with_what_remat_recomputes(remat):
    """A train step recomputes nothing under remat "none", the matmuls
    under "dots" and the whole forward under "full": the trace counts
    each, so "none" < "dots" < "full"."""
    rec = dryrun.run_cell("qwen3-0.6b", "train_4k", False, remat=remat)
    assert rec["remat"] == remat
    assert rec["flops_global"] == REMAT_FLOPS[remat]
    assert REMAT_FLOPS["none"] < REMAT_FLOPS["dots"] < REMAT_FLOPS["full"]


@pytest.mark.parametrize("arch,shape", [("mamba2-370m", "train_4k"),
                                        ("mamba2-370m", "long_500k"),
                                        ("whisper-small", "decode_32k"),
                                        ("whisper-small", "long_500k")])
def test_ssm_and_encdec_cells(arch, shape):
    rec = dryrun.run_cell(arch, shape, True)
    ok, reason = jax_applicable(jax_config(arch), SHAPES[shape])
    assert rec["status"] == ("ok" if ok else "skipped")
    if ok:
        assert rec["flops_global"] > 0 and rec["model_flops"] > 0
    else:
        assert rec["skip_reason"] == reason


@pytest.mark.parametrize("arch,over", [
    ("qwen3-0.6b", dict(num_layers=4)),
    ("qwen3-moe-30b-a3b", dict(num_layers=3)),
    ("mamba2-370m", dict(num_layers=4)),
    ("zamba2-7b", dict(num_layers=8, attn_every=3)),
    ("whisper-small", dict(num_layers=3, encoder_layers=4)),
])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_extrapolated_flops_equal_the_full_depth_trace(arch, over, kind):
    cfg = get_config(arch).scaled_down(**over)
    cell = ShapeCell("tiny", 64, 2, kind)
    got = dryrun.step_flops(cfg, cell)
    assert got == dryrun.step_flops(cfg, cell, extrapolate=False) > 0


def test_main_writes_records_and_errors(tmp_path, monkeypatch, capsys):
    out = tmp_path / "dry"
    recs = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--out", str(out)])
    assert recs[0]["status"] == "ok"
    path = out / "qwen3-0.6b__decode_32k__pod1.json"
    assert json.loads(path.read_text()) == recs[0]
    recs = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k",
                        "--out", str(out)])
    assert "[cached]" in capsys.readouterr().out

    def broken(cfg, cell):
        raise RuntimeError("trace failed")
    monkeypatch.setattr(dryrun, "step_flops", broken)
    recs = dryrun.main(["--arch", "mamba2-370m", "--shape", "decode_32k",
                        "--multi-pod", "--strategy", "dp", "--out",
                        str(out)])
    assert recs[0]["status"] == "error"
    assert recs[0]["error"] == "RuntimeError: trace failed"
    assert (out / "mamba2-370m__decode_32k__pod2__dp.json").exists()
    assert "done: 0 ok, 0 skipped, 1 failed" in capsys.readouterr().out


def test_default_out_is_a_temporary_directory():
    import tempfile

    assert str(dryrun.RESULTS_DIR).startswith(tempfile.gettempdir())
    assert "benchmarks" not in dryrun.RESULTS_DIR.parts


def test_importing_sets_no_environment_variable():
    code = ("import os; before = dict(os.environ)\n"
            "import repro_torch.launch.dryrun\n"
            "print(dict(os.environ) == before)")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


def test_state_bytes_on_a_host_mesh_match_the_placement():
    """On a real (CPU) mesh the dry run's arithmetic is the bytes the
    placement puts on each device."""
    from repro_torch.launch import shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import get_model
    from repro_torch.optim import adamw

    cfg = get_config("qwen3-0.6b").scaled_down()
    mesh = make_host_mesh((2, 2), device="cpu")
    params = get_model(cfg).init_params(cfg, seed=0, device="cpu")
    opt = adamw(lr=3e-4).init(params)
    placed = shardings.device_bytes(shardings.shard_tree(
        params, shardings.tree_specs(params, mesh), mesh)) + \
        shardings.device_bytes(shardings.shard_tree(
            opt, shardings.tree_specs(opt, mesh, zero1=True), mesh))
    assert (placed == dryrun.state_bytes(cfg, SHAPES["train_4k"],
                                         mesh)).all()
