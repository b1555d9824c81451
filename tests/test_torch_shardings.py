"""The port's sharding rules (``repro_torch.launch.shardings``) against the
JAX package's (``repro.launch.shardings``), the LM mesh, the placement of
a tree on a CPU mesh, and ``models.shardctx``.

The specs are compared leaf by leaf, each side padded with None to the
leaf's rank (``P() != P(None, None)``), for every config's full-width
parameters and AdamW state (the JAX package's from ``jax.eval_shape``,
the port's on ``meta`` tensors: neither allocates), under the three
strategies, on both production meshes, with and without ZeRO-1; and the
input and cache specs for every applicable (arch, shape).  The per-device
bytes are checked against the JAX dry run's arithmetic in
``tests/test_torch_dryrun.py`` (in a subprocess: importing
``repro.launch.dryrun`` sets ``XLA_FLAGS``).
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get_config as jax_config
from repro.launch import shardings as jsh
from repro.models import api as japi
from repro.models import cache_spec_shapes as jcache_shapes
from repro.models import input_spec_shapes as jinput_shapes
from repro.optim import adamw as jadamw
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import shardings
from repro_torch.launch.shardings import (pad_spec, param_spec,
                                          set_strategy)
from repro_torch.models import (SHAPES, cache_spec_shapes, cell_applicable,
                                get_model, input_spec_shapes, shardctx)
from repro_torch.models.api import abstract_params
from repro_torch.optim import adamw


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape

    @property
    def axis_names(self):
        return tuple(self.shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESHES = {"16x16": lmesh.make_production_mesh(),
          "2x16x16": lmesh.make_production_mesh(multi_pod=True)}


@pytest.fixture(autouse=True)
def _reset_strategy():
    set_strategy("tp")
    jsh.set_strategy("tp")
    yield
    set_strategy("tp")
    jsh.set_strategy("tp")


def _both(name):
    set_strategy(name)
    jsh.set_strategy(name)


# --------------------------------------------------------------------------
# tests/test_shardings.py's cases, as twins
# --------------------------------------------------------------------------

def test_tp_rules_basic():
    assert param_spec("wq", (48, 2048, 4096), MESH) == \
        ("data", None, "model")          # FSDP lead + column parallel
    assert param_spec("wo", (2048, 1024), MESH) == ("model", None)
    assert param_spec("we_gate", (48, 128, 2048, 768), MESH) == \
        ("data", "model", None, None)
    assert param_spec("ln1", (48, 1024), MESH) == (None, None)


def test_divisibility_fallback():
    # vocab 50280 % 16 != 0 -> model axis dropped
    assert param_spec("lm_head", (1024, 50280), MESH) == (None, None)
    assert param_spec("lm_head", (1024, 151936), MESH) == (None, "model")


def test_fsdp_only_for_large_stacked():
    small = param_spec("A_log", (48, 32), MESH)
    assert small == (None, "model")       # too small for FSDP lead
    big = param_spec("w_gate", (48, 4096, 14336), MESH)
    assert big[0] == "data"


def test_zero1_spreads_optimizer_state():
    spec = param_spec("final_norm", (4096,), MESH, zero1=True)
    assert "data" in spec


def test_dp_strategy_replicates():
    set_strategy("dp")
    assert param_spec("wq", (48, 2048, 4096), MESH) == ()
    assert param_spec("we_gate", (48, 128, 2048, 768), MESH) == ()


def test_ep_strategy_keeps_expert_sharding_only():
    set_strategy("ep")
    assert param_spec("we_gate", (48, 128, 2048, 768), MESH) == \
        ("data", "model", None, None)
    wq = param_spec("wq", (48, 2048, 4096), MESH)
    assert "model" not in wq and wq[0] == "data"
    assert param_spec("embed", (151936, 1024), MESH) == ("data", None)


def test_batch_spec_strategies():
    set_strategy("tp")
    assert shardings.batch_spec(MESH, 256) == ("data",)
    set_strategy("dp")
    assert shardings.batch_spec(MESH, 256) == ("data", "model")
    assert shardings.batch_spec(MESH, 100) == ()   # 100 % 16 != 0


def test_unknown_strategy_raises():
    with pytest.raises(ValueError, match="strategy"):
        set_strategy("fsdp")


# --------------------------------------------------------------------------
# Every config's parameter and optimizer specs against the JAX package's
# --------------------------------------------------------------------------

_JAX_TREES = {}


def _jax_trees(arch):
    """The JAX package's abstract (params, AdamW state) of ``arch``."""
    if arch not in _JAX_TREES:
        cfg = jax_config(arch)
        params = jax.eval_shape(
            lambda: japi.get_model(cfg).init_params(cfg, jax.random.key(0)))
        _JAX_TREES[arch] = (params,
                            jax.eval_shape(jadamw(lr=3e-4).init, params))
    return _JAX_TREES[arch]


def _port_trees(arch):
    params = abstract_params(get_config(arch))
    return params, adamw(lr=3e-4).init(params)


def _key(k):
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(k)


def _jax_leaves(tree, specs) -> dict:
    """path -> (shape, spec padded to rank)."""
    shapes = {tuple(_key(k) for k in path): tuple(leaf.shape) for path, leaf
              in jax.tree_util.tree_flatten_with_path(tree)[0]}
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, P))[0]:
        path = tuple(_key(k) for k in path)
        out[path] = (shapes[path], pad_spec(tuple(spec), len(shapes[path])))
    return out


def _port_leaves(tree, specs, path=()) -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            out |= _port_leaves(tree[k], specs[k], path + (str(k),))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f, t, s in zip(tree._fields, tree, specs):
            out |= _port_leaves(t, s, path + (f,))
        return out
    shape = tuple(tree.shape)
    return {path: (shape, pad_spec(specs, len(shape)))}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_optimizer_specs_equal_jax_s(arch):
    jparams, jopt = _jax_trees(arch)
    params, opt = _port_trees(arch)
    n = 0
    for strategy in ("tp", "dp", "ep"):
        _both(strategy)
        for name, mesh in MESHES.items():
            for zero1 in (False, True):
                for jt, pt in ((jparams, params), (jopt, opt)):
                    want = _jax_leaves(jt, jsh.tree_pspecs(jt, mesh, zero1))
                    got = _port_leaves(pt, shardings.tree_specs(pt, mesh,
                                                                zero1))
                    assert got == want, (strategy, name, zero1)
                    n += len(got)
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_input_and_cache_specs_equal_jax_s(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    cells = 0
    for strategy in ("tp", "dp", "ep"):
        _both(strategy)
        for mesh in MESHES.values():
            for cell in SHAPES.values():
                if not cell_applicable(cfg, cell)[0]:
                    continue
                cells += 1
                assert shardings.batch_spec(mesh, cell.global_batch) == \
                    tuple(jsh.batch_pspec(mesh, cell.global_batch))
                for ours, theirs, port_shapes, jax_shapes in (
                        (shardings.input_specs, jsh.input_pspecs,
                         input_spec_shapes, jinput_shapes),
                        (shardings.cache_specs, jsh.cache_pspecs,
                         cache_spec_shapes, jcache_shapes)):
                    shapes = port_shapes(cfg, cell)
                    assert shapes == jax_shapes(jcfg, cell)
                    got = ours(cfg, cell, mesh, shapes)
                    want = theirs(jcfg, cell, mesh, shapes)
                    assert set(got) == set(want)
                    for k in got:
                        rank = len(shapes[k][0])
                        assert pad_spec(got[k], rank) == \
                            pad_spec(tuple(want[k]), rank), (k, cell.name)
    assert cells >= 3 * 2 * 3        # 3 or 4 shapes, 2 meshes, 3 strategies


def test_logical_summary_equals_jax_s():
    for arch in ("qwen3-0.6b", "qwen3-moe-30b-a3b"):
        for mesh in MESHES.values():
            assert shardings.logical_summary(get_config(arch), mesh) == \
                jsh.logical_summary(jax_config(arch), mesh)


# --------------------------------------------------------------------------
# The LM mesh and placement on CPU shards
# --------------------------------------------------------------------------

def test_production_meshes_are_abstract():
    m = lmesh.make_production_mesh()
    assert m.axis_names == ("data", "model") and m.devices is None
    assert m.shape == {"data": 16, "model": 16}
    assert list(m.shape) == list(m.axis_names)
    assert lmesh.mesh_chips(m) == 256
    pod = lmesh.make_production_mesh(multi_pod=True)
    assert pod.shape == {"pod": 2, "data": 16, "model": 16}
    assert lmesh.dp_axes(pod) == ("pod", "data")
    assert lmesh.mesh_chips(pod) == 512
    assert lmesh.mesh_chips(lmesh.make_fleet_mesh(3, device="cpu")) == 3


def test_host_mesh_on_cpu_shards():
    m = lmesh.make_host_mesh((2, 3), device="cpu")
    assert m.devices.shape == (2, 3)
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert lmesh.mesh_chips(m) == 6 and lmesh.dp_axes(m) == ("data",)
    with pytest.raises(ValueError):
        lmesh.make_host_mesh((2, 0), device="cpu")
    with pytest.raises(ValueError):
        lmesh.compat_make_mesh((2, 2), ("data",), device="cpu")


def test_a_cuda_mesh_needs_its_cards(monkeypatch):
    """More cards than are visible raise; nothing moves to the CPU."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            lmesh.make_host_mesh((2, 1), device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 cards; 1 are visible"):
        lmesh.make_host_mesh((2, 1), device="cuda")
    m = lmesh.make_host_mesh((1, 1), device="cuda")
    assert m.devices[0, 0] == torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(1, 1), (1, 2), (2, 1), (2, 2)])
def test_shard_and_gather_are_exact(shape):
    """Each device's block has the shape its spec gives and the values of
    its slice; each device holds ``sharded_bytes``; gathering gives every
    leaf back bit for bit."""
    mesh = lmesh.make_host_mesh(shape, device="cpu")
    cfg = get_config("qwen3-0.6b").scaled_down(num_layers=2, d_model=32,
                                               vocab_size=128, d_ff=64)
    params = get_model(cfg).init_params(cfg, seed=1, device="cpu")
    opt = adamw().init(params)
    opt = opt._replace(m=shardings.tree_map(torch.randn_like, opt.m))
    for tree, zero1 in ((params, False), (opt, True)):
        specs = shardings.tree_specs(tree, mesh, zero1)
        placed = shardings.shard_tree(tree, specs, mesh)
        for leaf, spec, x in zip(shardings.tree_leaves(placed),
                                 shardings._spec_leaves(specs, tree),
                                 shardings.tree_leaves(tree)):
            assert leaf.spec == spec
            for idx in np.ndindex(mesh.devices.shape):
                block = leaf.blocks[idx]
                want = tuple(
                    n // math.prod(mesh.shape[a] for a in shardings._axes(e))
                    for n, e in zip(x.shape, pad_spec(spec, x.dim())))
                assert tuple(block.shape) == want
                assert torch.equal(block, x[leaf.slices(idx)])
        per_device = shardings.device_bytes(placed)
        assert (per_device == shardings.sharded_bytes(tree, specs,
                                                      mesh)).all()
        back = shardings.gather_tree(placed)
        for a, b in zip(shardings.tree_leaves(back),
                        shardings.tree_leaves(tree)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_model_axis_shards_on_two_devices():
    """On a (1, 2) mesh the column-parallel weights split over model."""
    mesh = lmesh.make_host_mesh((1, 2), device="cpu")
    w = torch.arange(24.0).reshape(2, 3, 4)
    leaf = shardings.shard(w, shardings.param_spec("wq", w.shape, mesh),
                           mesh)
    assert leaf.spec == (None, None, "model")
    assert torch.equal(leaf.blocks[0, 0], w[..., :2])
    assert torch.equal(leaf.blocks[0, 1], w[..., 2:])
    assert leaf.blocks[0, 0] is not w
    one = lmesh.make_host_mesh((1, 1), device="cpu")
    assert shardings.shard(w, (), one).blocks[0, 0] is w   # no copy
    assert shardings.gather(shardings.shard(w, (), one)) is w
    with pytest.raises(ValueError, match="split"):
        shardings.shard(torch.zeros(3), ("model",), mesh)
    with pytest.raises(ValueError, match="abstract"):
        shardings.shard(w, (), lmesh.make_production_mesh())


# --------------------------------------------------------------------------
# shardctx
# --------------------------------------------------------------------------

def test_constrain_returns_its_input():
    x = torch.zeros(2, 3, 4)
    assert shardctx.constrain(x, "residual") is x
    with shardctx.rules(residual=(("data",), None, "model")):
        assert shardctx.constrain(x, "residual") is x
        assert shardctx.constrain(x, "logits") is x
    assert shardctx._RULES == {}


def test_constrain_checks_the_rank():
    shardctx.set_rules(heads=("data", "model", None, None))
    try:
        with pytest.raises(ValueError, match="heads"):
            shardctx.constrain(torch.zeros(2, 3, 4), "heads")
        x = torch.zeros(2, 3, 4, 5)
        assert shardctx.constrain(x, "heads") is x
    finally:
        shardctx.clear()
    assert shardctx._RULES == {}


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m", "zamba2-7b",
                                  "whisper-small"])
def test_rules_move_no_number(arch):
    """A forward with the dry run's tp rules installed is bitwise the one
    without them."""
    from repro_torch.launch.dryrun import _rules

    cfg = get_config(arch).scaled_down()
    api = get_model(cfg)
    params = api.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16)))
    if cfg.family == "encdec":
        frames = torch.as_tensor(rng.normal(
            size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
        run = lambda: api.forward(cfg, params, {"frames": frames,
                                                "tokens": tokens})
    else:
        run = lambda: api.forward(cfg, params, tokens)
    with torch.no_grad():
        plain = run()
        for strategy in ("tp", "dp", "ep"):
            with shardctx.rules(**_rules(strategy, SHAPES["train_4k"],
                                         MESHES["16x16"])):
                ruled = run()
            assert torch.equal(plain, ruled), strategy
