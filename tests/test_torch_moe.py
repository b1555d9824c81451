"""The port's MoE block (``repro_torch.models.moe``) and the MoE and vlm
families through ``repro_torch.models.transformer`` against the JAX
package's on the CPU, at ``scaled_down()`` widths (d_model 64, 4 experts,
top-2 for qwen3-moe, top-1 with the shared expert for llama4-scout,
groups of 32 tokens), in f32.

Weights are made by the JAX package from a seed and carried across with
``repro_torch.convert.lm_params_from_numpy``; inputs are made by numpy
from a seed.  Routing -- each slot's expert (``gate_i``), its place in
the expert (``pos``) and whether it fits (``keep``) -- must be identical;
the JAX side's routing is taken from the lines of
``repro.models.moe.moe_block`` run with ``jax.lax.top_k``.  Tolerances:
``moe_block`` and ``moe_block_dense_ref`` rtol 1e-5, atol 1e-6 (f32 sums
over D and F in another order); logits max |d| <= 2e-5 max |logit|, the
bound of ``tests/test_torch_decode.py`` and ``tests/test_torch_lm.py``.
MoE decode routes the batch as one group, whose capacity drops slots that
the full-sequence forward keeps, so decode is held to JAX's decode, not to
the forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import counting as jcounting
from repro.models import moe as jmoe
from repro.models import transformer as jt
from repro.models.layers import init_from_shapes as jinit
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.models import counting, get_model, moe, transformer
from repro_torch.models.api import param_shapes

REL = 2e-5
MOE_ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-a16e"]


def _close(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _tokens(vocab, shape, seed=42):
    return np.random.default_rng(seed).integers(0, vocab, size=shape
                                                ).astype(np.int32)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def lm(request):
    """(JAX config, port config, JAX params, port params) of a scaled-down
    MoE model in f32."""
    jcfg = jax_config(request.param).scaled_down()
    params = jt.init_params(jcfg, jax.random.key(0))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return jcfg, cfg, params, tparams


# --------------------------------------------------------------------------
# The block
# --------------------------------------------------------------------------

def _block_pair(arch, capacity_factor, seed=0):
    """(JAX config, port config, JAX block params, port block params,
    x numpy (2, 32, 64))."""
    jcfg = jax_config(arch).scaled_down(capacity_factor=capacity_factor)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    p = jinit(jax.random.key(seed), jmoe.moe_param_shapes(jcfg), jnp.float32)
    tp = {k: torch.tensor(np.asarray(v)) for k, v in p.items()}
    x = np.random.default_rng(seed).normal(size=(2, 32, 64)).astype(
        np.float32)
    return jcfg, cfg, p, tp, x


def _jax_routing(jcfg, p, x):
    """gate_i, pos and keep of ``repro.models.moe.moe_block``'s lines."""
    b, s, d = x.shape
    e, k = jcfg.num_experts, jcfg.experts_per_tok
    g_sz = min(jcfg.moe_group_size, b * s)
    n_g = b * s // g_sz
    cap = jmoe.expert_capacity(jcfg, g_sz)
    xg = jnp.asarray(x).reshape(n_g, g_sz, d)
    logits = jnp.einsum("gtd,de->gte", xg, p["router"],
                        preferred_element_type=jnp.float32)
    _, gate_i = jax.lax.top_k(logits, k)
    sel = jax.nn.one_hot(gate_i, e, dtype=jnp.int32)
    sel_tk = sel.transpose(0, 2, 1, 3).reshape(n_g, k * g_sz, e)
    pos = (jnp.cumsum(sel_tk, axis=1) - 1).reshape(n_g, k, g_sz, e
                                                   ).transpose(0, 2, 1, 3)
    pos = jnp.sum(pos * sel, axis=-1)
    return np.asarray(gate_i), np.asarray(pos), np.asarray(pos < cap), cap


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25],
                         ids=["default_capacity", "dropping"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_jax_with_identical_routing(arch, capacity_factor):
    jcfg, cfg, p, tp, x = _block_pair(arch, capacity_factor)
    gate_i, pos, keep, cap = _jax_routing(jcfg, p, x)
    assert cap == moe.expert_capacity(cfg, 32)
    _, tgate_i, tpos, tkeep = moe._route(cfg, tp["router"],
                                         torch.tensor(x).reshape(2, 32, 64),
                                         cap)
    np.testing.assert_array_equal(tgate_i.numpy(), gate_i)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    np.testing.assert_array_equal(tkeep.numpy(), keep)
    if capacity_factor < 1:
        assert not keep.all()              # the case drops slots
    want = np.asarray(jmoe.moe_block(jcfg, p, jnp.asarray(x)))
    got = moe.moe_block(cfg, tp, torch.tensor(x))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_dense_ref_matches_jax(arch):
    jcfg, cfg, p, tp, x = _block_pair(arch, 1.25, seed=1)
    want = np.asarray(jmoe.moe_block_dense_ref(jcfg, p, jnp.asarray(x)))
    got = moe.moe_block_dense_ref(cfg, tp, torch.tensor(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_matches_dense_reference_without_drops(arch):
    """Capacity for every slot of a group: the dispatch drops nothing and
    equals every expert on every token (``tests/test_models.py``)."""
    _, cfg, _, tp, x = _block_pair(arch, 8.0, seed=2)
    assert moe.expert_capacity(cfg, 32) >= 32
    np.testing.assert_allclose(
        moe.moe_block(cfg, tp, torch.tensor(x)).numpy(),
        moe.moe_block_dense_ref(cfg, tp, torch.tensor(x)).numpy(),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("capacity_factor", [0.05, 0.25, 0.5, 1.0, 2.0])
def test_dropped_tokens_give_zeros_never_garbage(capacity_factor):
    """With tight capacity the output is a damped version of the dense
    reference (``tests/test_models.py``): finite, no larger in norm, and a
    token all of whose slots were dropped gets exactly zero."""
    arch = "qwen3-moe-30b-a3b"
    _, cfg, _, tp, x = _block_pair(arch, capacity_factor, seed=3)
    xt = torch.tensor(x)
    y = moe.moe_block(cfg, tp, xt)
    yd = moe.moe_block_dense_ref(cfg, tp, xt)
    assert torch.isfinite(y).all()
    assert float(y.norm()) <= float(yd.norm()) * 1.5 + 1e-3
    cap = moe.expert_capacity(cfg, 32)
    _, _, _, keep = moe._route(cfg, tp["router"], xt.reshape(2, 32, 64), cap)
    dropped = ~keep.any(-1).reshape(2, 32)
    if capacity_factor <= 0.25:
        assert dropped.any()
    assert torch.equal(y[dropped], torch.zeros_like(y[dropped]))


def test_top_k_takes_the_lower_expert_first_on_ties():
    """Equal router logits route to the lower expert index first, as
    ``jax.lax.top_k`` does."""
    logits = torch.tensor([[0.5, 2.0, 2.0, 0.5, 2.0, 1.0]])
    vals, idx = moe._top_k(logits, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 4)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 4, 5]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_group_size_that_does_not_divide_the_tokens_raises():
    _, cfg, _, tp, x = _block_pair("qwen3-moe-30b-a3b", 1.25)
    with pytest.raises(ValueError, match="not divisible by group"):
        moe.moe_block(cfg, tp, torch.tensor(x[:, :19]).reshape(1, 38, 64))


def test_moe_param_shapes_and_capacity_match_jax():
    for arch in MOE_ARCHS:
        cfg, jcfg = get_config(arch), jax_config(arch)
        assert moe.moe_param_shapes(cfg) == jmoe.moe_param_shapes(jcfg)
        for group in (1, 4, 256, 4096):
            assert moe.expert_capacity(cfg, group) == \
                jmoe.expert_capacity(jcfg, group)
    # decode at batch 4, top-8 over 128 experts: one slot an expert
    assert moe.expert_capacity(get_config("qwen3-moe-30b-a3b"), 4) == 1


# --------------------------------------------------------------------------
# The MoE and vlm families through the transformer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("flash", [True, False])
def test_moe_forward_matches_jax(lm, flash):
    jcfg, cfg, params, tparams = lm
    jcfg = dataclasses.replace(jcfg, use_pallas_attention=flash)
    cfg = dataclasses.replace(cfg, use_pallas_attention=flash)
    toks = _tokens(cfg.vocab_size, (2, 32))
    want = np.asarray(jt.forward(jcfg, params, jnp.asarray(toks)))
    got = get_model(cfg).forward(cfg, tparams, torch.tensor(toks))
    assert got.shape == want.shape == (2, 32, cfg.vocab_padded)
    _close(got, want, REL)


def test_moe_prefill_then_decode_matches_jax(lm):
    """A 16-token prompt prefilled into a 24-slot cache, then 6 decode
    steps (batch 2: one group of 2 tokens, capacity 1): the prefill's last
    logits, its cache and each step's logits."""
    jcfg, cfg, params, tparams = lm
    toks = _tokens(cfg.vocab_size, (2, 22), seed=3)
    want, jcache = jt.prefill(jcfg, params, jnp.asarray(toks[:, :16]), 24)
    got, cache = transformer.prefill(cfg, tparams, torch.tensor(toks[:, :16]),
                                     24)
    _close(got, want, REL)
    for name in ("k", "v"):
        _close(cache[name], np.asarray(jcache[name]), REL)
    jdecode = jax.jit(lambda p, c, t, pos: jt.decode_step(jcfg, p, c, t, pos))
    for pos in range(16, 22):
        want, jcache = jdecode(params, jcache, jnp.asarray(toks[:, pos]), pos)
        got, cache = transformer.decode_step(cfg, tparams, cache,
                                             torch.tensor(toks[:, pos]), pos)
        _close(got, want, REL)


def test_moe_decode_matches_jax_from_an_empty_cache(lm):
    """Ten tokens fed one at a time at batch 4 (a group of 4 tokens)."""
    jcfg, cfg, params, tparams = lm
    toks = _tokens(cfg.vocab_size, (4, 10), seed=5)
    jcache = jt.init_cache(jcfg, 4, 12)
    cache = get_model(cfg).init_cache(cfg, 4, 12, device="cpu")
    jdecode = jax.jit(lambda p, c, t, pos: jt.decode_step(jcfg, p, c, t, pos))
    for pos in range(10):
        want, jcache = jdecode(params, jcache, jnp.asarray(toks[:, pos]), pos)
        got, cache = transformer.decode_step(cfg, tparams, cache,
                                             torch.tensor(toks[:, pos]), pos)
        _close(got, want, REL)
    _close(cache["k"], np.asarray(jcache["k"]), REL)


def test_moe_decode_refuses_a_position_past_the_cache(lm):
    _, cfg, _, tparams = lm
    cache = transformer.init_cache(cfg, 2, 4, device="cpu")
    with pytest.raises(ValueError, match="outside the KV cache"):
        transformer.decode_step(cfg, tparams, cache,
                                torch.zeros(2, dtype=torch.long), 4)


def test_vlm_forward_with_patches_matches_jax():
    """internvl2's LM with 8 patch embeddings prepended (``extra_embeds``):
    logits over the patches and the text."""
    jcfg = jax_config("internvl2-26b").scaled_down()
    params = jt.init_params(jcfg, jax.random.key(0))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    toks = _tokens(cfg.vocab_size, (2, 12))
    patches = np.random.default_rng(7).normal(
        size=(2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    want = np.asarray(jt.forward(jcfg, params, jnp.asarray(toks),
                                 jnp.asarray(patches)))
    got = get_model(cfg).forward(cfg, tparams, torch.tensor(toks),
                                 torch.tensor(patches))
    assert got.shape == want.shape == (2, 20, cfg.vocab_padded)
    _close(got, want, REL)


@pytest.mark.parametrize("arch", MOE_ARCHS + ["internvl2-26b"])
def test_get_model_runs_moe_and_vlm_through_the_transformer(arch):
    api = get_model(get_config(arch))
    assert api.forward is transformer.forward
    assert api.loss_fn is transformer.loss_fn
    assert api.decode_step is transformer.decode_step
    shapes = param_shapes(get_config(arch))
    if arch in MOE_ARCHS:
        assert "layers.moe.router" in shapes and "layers.mlp.w_up" not in \
            shapes
    else:
        assert "layers.mlp.w_up" in shapes


@pytest.mark.parametrize("arch", MOE_ARCHS + ["internvl2-26b"])
def test_counting_of_moe_and_vlm_matches_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert counting.param_count(cfg) == jcounting.param_count(jcfg)
    assert counting.active_param_count(cfg) == \
        jcounting.active_param_count(jcfg)
    assert counting.model_flops(cfg, 4096, "train") == \
        jcounting.model_flops(jcfg, 4096, "train")


def test_init_params_of_moe_match_jax_names_and_shapes(lm):
    jcfg, cfg, params, _ = lm
    tree = transformer.init_params(cfg, seed=0, device="cpu")
    jflat = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
             for path, leaf in jax.tree_util.tree_leaves_with_path(params)}
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                flat[f"{pre}{k}"] = tuple(v.shape)
    walk(tree, "")
    assert flat == jflat
