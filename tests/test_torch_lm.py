"""The port's LM full-sequence forward (``repro_torch.models``) against the
JAX package's ``repro.models.transformer.forward`` on the CPU.

Weights are made by the JAX package from a seed and carried across as numpy
with ``repro_torch.convert.lm_params_from_numpy``; tokens are made by numpy
from a seed.  Both sides run in f32 on the CPU: the JAX side's
``use_pallas_attention`` falls back to its blockwise path off the TPU, the
port's runs the flash kernel's plain version (True) or its own blockwise
path (False).  Tolerance: max |d| <= 2e-5 max |logit|, the bound
``tests/test_models.py`` holds its own forward comparisons to (sums over
the model widths taken in another order).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.models import counting as jcounting
from repro.models import transformer as jt
from repro.models.api import input_spec_shapes as jax_input_specs
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.models import SHAPES, counting, get_model, transformer
from repro_torch.models.api import cell_applicable, input_spec_shapes

REL = 2e-5


def _case(name):
    """(JAX config, sequence length) of a named comparison."""
    if name == "qwen3-0.6b-smoke":
        return jax_config("qwen3-0.6b").scaled_down(), 19
    if name == "qwen1.5-0.5b-smoke":
        return jax_config("qwen1.5-0.5b").scaled_down(), 19
    # one layer of qwen3-0.6b at its published widths (d_model 1024, 16
    # heads over 8 kv heads of 128, d_ff 3072), vocab cut to 512
    return dataclasses.replace(jax_config("qwen3-0.6b"), num_layers=1,
                               vocab_size=512, param_dtype="float32",
                               compute_dtype="float32"), 32


def _forward_pair(jcfg, seq, seed=0):
    params = jt.init_params(jcfg, jax.random.key(seed))
    toks = np.random.default_rng(42).integers(
        0, jcfg.vocab_size, size=(2, seq)).astype(np.int32)
    want = np.asarray(jt.forward(jcfg, params, jnp.asarray(toks)))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    got = get_model(cfg).forward(cfg, tparams,
                                 torch.tensor(toks, dtype=torch.long))
    return got, want


@pytest.mark.parametrize("flash", [True, False])
@pytest.mark.parametrize("name", ["qwen3-0.6b-smoke", "qwen1.5-0.5b-smoke",
                                  "qwen3-0.6b-one-layer"])
def test_forward_matches_jax(name, flash):
    jcfg, seq = _case(name)
    jcfg = dataclasses.replace(jcfg, use_pallas_attention=flash)
    got, want = _forward_pair(jcfg, seq)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, seq, jcfg.vocab_padded)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=REL * scale)


def test_forward_flash_and_blockwise_paths_agree():
    """The flash path and the blockwise path of the port give the same
    logits (f32, chunks smaller than the sequence so both tile it)."""
    cfg = get_config("qwen3-0.6b").scaled_down(q_chunk=8, k_chunk=8)
    params = transformer.init_params(cfg, seed=3, device="cpu")
    toks = torch.tensor(np.random.default_rng(1).integers(0, 256, (2, 21)))
    a = transformer.forward(dataclasses.replace(
        cfg, use_pallas_attention=True), params, toks)
    b = transformer.forward(cfg, params, toks)
    assert float((a - b).abs().max()) <= REL * float(b.abs().max())


def test_forward_pads_vocab_logits():
    """A vocab that is not a multiple of 16 is padded, and the padded
    columns are pushed to -1e30, as in the JAX package."""
    jcfg = jax_config("qwen3-0.6b").scaled_down(vocab_size=250)
    got, want = _forward_pair(jcfg, 7)
    assert got.shape[-1] == 256
    assert torch.all(got[..., 250:] == -1e30)
    np.testing.assert_allclose(got[..., :250].numpy(), want[..., :250],
                               rtol=0, atol=REL * float(np.abs(
                                   want[..., :250]).max()))


def test_bf16_forward_runs_and_stays_finite():
    """The published dtypes (bf16 parameters and compute) through the plain
    path on the CPU: f32 logits, finite, and close to the f32 forward of
    the same weights (one bf16 rounding per layer boundary)."""
    cfg = get_config("qwen3-0.6b").scaled_down(param_dtype="bfloat16",
                                               compute_dtype="bfloat16",
                                               use_pallas_attention=True)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    toks = torch.tensor(np.random.default_rng(2).integers(0, 256, (2, 16)))
    got = transformer.forward(cfg, params, toks)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    ref = transformer.forward(f32, {k: v for k, v in _to_f32(params).items()},
                              toks)
    assert float((got - ref).abs().max()) <= 5e-2 * float(ref.abs().max())


def _to_f32(tree):
    return {k: _to_f32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def test_convert_copies_the_weights():
    """Editing the numpy tree after the conversion changes nothing in the
    port's parameters."""
    jcfg = jax_config("qwen3-0.6b").scaled_down()
    tree = jax.tree.map(lambda a: np.array(a),
                        jt.init_params(jcfg, jax.random.key(0)))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    params = lm_params_from_numpy(cfg, tree, device="cpu")
    before = params["layers"]["attn"]["wq"].clone()
    tree["layers"]["attn"]["wq"][...] = 7.0
    tree["embed"][...] = 7.0
    assert torch.equal(params["layers"]["attn"]["wq"], before)
    assert not torch.any(params["embed"] == 7.0)


def test_convert_refuses_a_tree_of_another_config():
    jcfg = jax_config("qwen3-0.6b").scaled_down()
    tree = jax.tree.map(np.asarray, jt.init_params(jcfg, jax.random.key(0)))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    other = dataclasses.replace(cfg, d_ff=64)
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(other, tree, device="cpu")
    del tree["layers"]["ln2"]
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_numpy(cfg, tree, device="cpu")
    with pytest.raises(ValueError, match="unknown ModelConfig fields"):
        model_config_from_fields({**dataclasses.asdict(cfg), "bogus": 1})


def test_init_params_names_and_shapes_match_jax():
    """The port's random parameters carry the JAX tree's names and shapes
    and its recipe (norms ones, biases zeros, weights at std 0.02)."""
    for arch in ("qwen3-0.6b", "qwen1.5-0.5b"):
        jcfg = jax_config(arch).scaled_down()
        jtree = jt.init_params(jcfg, jax.random.key(0))
        cfg = model_config_from_fields(dataclasses.asdict(jcfg))
        tree = transformer.init_params(cfg, seed=0, device="cpu")
        jflat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
                 for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
        flat = {}

        def walk(t, pre):
            for k, v in t.items():
                if isinstance(v, dict):
                    walk(v, f"{pre}{k}/")
                else:
                    flat[f"{pre}{k}"] = tuple(v.shape)
        walk(tree, "")
        assert flat == jflat
        assert torch.all(tree["layers"]["ln1"] == 1)
        if cfg.qkv_bias:
            assert torch.all(tree["layers"]["attn"]["bq"] == 0)
        assert abs(float(tree["layers"]["mlp"]["w_up"].std()) - 0.0176) < 3e-3
        assert tree["embed"].device.type == "cpu"


def test_registry_matches_jax():
    assert ARCHS == JAX_ARCHS
    for arch in ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch))
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen1.5-0.5b", "llama3-8b",
                                  "qwen2.5-14b", "mamba2-370m",
                                  "qwen3-moe-30b-a3b",
                                  "llama4-scout-17b-a16e", "internvl2-26b",
                                  "zamba2-7b", "whisper-small"])
def test_counting_matches_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert counting.param_count(cfg) == jcounting.param_count(jcfg)
    assert counting.active_param_count(cfg) == \
        jcounting.active_param_count(jcfg)
    assert counting.model_flops(cfg, 8192, "prefill") == \
        jcounting.model_flops(jcfg, 8192, "prefill")


def test_input_specs_and_cells_match_jax():
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        for cell in SHAPES.values():
            assert input_spec_shapes(cfg, cell) == jax_input_specs(jcfg, cell)
            ok, _ = cell_applicable(cfg, cell)
            assert ok == (cell.name != "long_500k"
                          or cfg.family in ("ssm", "hybrid"))


@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-small"])
def test_families_not_ported_are_refused(arch):
    """The two families that were refused until ROADMAP Queue 1 item 17
    (hybrid, encdec) are served now: ``get_model`` gives the module's
    entry points, and ``param_count`` and ``model_flops`` equal the JAX
    package's."""
    cfg, jcfg = get_config(arch), jax_config(arch)
    api = get_model(cfg)
    module = importlib.import_module(
        f"repro_torch.models.{arch.split('-')[0]}")
    assert (api.init_params, api.loss_fn, api.forward, api.init_cache,
            api.decode_step) == (module.init_params, module.loss_fn,
                                 module.forward, module.init_cache,
                                 module.decode_step)
    assert counting.param_count(cfg) == jcounting.param_count(jcfg)
    assert counting.active_param_count(cfg) == \
        jcounting.active_param_count(jcfg)
    assert counting.model_flops(cfg, 4096, "train") == \
        jcounting.model_flops(jcfg, 4096, "train")


def test_forward_on_cpu_launches_no_kernel():
    """The CPU path takes the flash kernel's plain version: no launch."""
    mod = importlib.import_module("repro_torch.kernels.flash_attention")
    before = mod.flash_attention.launches
    cfg = get_config("qwen3-0.6b").scaled_down(use_pallas_attention=True)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    transformer.forward(cfg, params, torch.zeros((1, 5), dtype=torch.long))
    assert mod.flash_attention.launches == before
