"""The port's KV-cache serving path (``repro_torch.models``: ``prefill``,
``init_cache``, ``decode_step``, ``layers.cached_decode_attention``,
``attention_decode``, ``blockwise_attention`` with ``q_offset``, and
``api.cache_spec_shapes``) against the JAX package's on the CPU.

Weights are made by the JAX package from a seed and carried across as numpy
with ``repro_torch.convert.lm_params_from_numpy``; inputs are made by numpy
from a seed.  Tolerances (f32 unless said): attention outputs max |d| <=
1e-5 max |ref| (f32 sums over at most 40 keys in another order); logits
max |d| <= 2e-5 max |logit|, the bound ``tests/test_torch_lm.py`` and
``tests/test_models.py`` hold the forward to; caches written from the
same f32 K/V, 1e-5 of their largest entry; bf16 attention |d| <= 2^-7
|ref| + 2^-9 max |ref| (one bf16 rounding of the output may flip, and a
p rounded to bf16 may flip by one unit)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import layers as jl
from repro.models import transformer as jt
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.models import SHAPES, cache_spec_shapes, get_model, layers
from repro_torch.models import mamba2, transformer

REL = 2e-5
ATTN_REL = 1e-5


def _close(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _pair(name, **overrides):
    """(JAX config, port config, JAX params, port params) of a named
    small model in f32."""
    arch = {"qwen3": "qwen3-0.6b", "qwen1.5": "qwen1.5-0.5b"}[name]
    jcfg = jax_config(arch).scaled_down(**overrides)
    params = jt.init_params(jcfg, jax.random.key(0))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    return jcfg, cfg, params, tparams


def _jax_decode(jcfg):
    """The JAX package's decode_step, jitted as its engine jits it (one
    trace for every position)."""
    return jax.jit(lambda p, c, t, pos: jt.decode_step(jcfg, p, c, t, pos))


def _tokens(vocab, shape, seed=42):
    return np.random.default_rng(seed).integers(0, vocab, size=shape
                                                ).astype(np.int32)


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("q_offset,sq", [(0, 13), (7, 13), (24, 5), (3, 1)])
def test_blockwise_attention_q_offset_matches_jax(q_offset, sq):
    """Queries at absolute positions q_offset.. over keys from 0, GQA group
    2, chunks smaller than both sequences."""
    rng = np.random.default_rng(q_offset)
    sk = q_offset + sq
    q = rng.normal(size=(2, 4, sq, 16)).astype(np.float32)
    k = rng.normal(size=(2, 2, sk, 16)).astype(np.float32)
    v = rng.normal(size=(2, 2, sk, 16)).astype(np.float32)
    want = jl.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, q_chunk=4,
                                  k_chunk=8, q_offset=q_offset)
    got = layers.blockwise_attention(torch.tensor(q), torch.tensor(k),
                                     torch.tensor(v), causal=True, q_chunk=4,
                                     k_chunk=8, q_offset=q_offset)
    _close(got, want, ATTN_REL)
    # the last query sees every key: q_offset + sq - 1 = sk - 1
    full = layers.blockwise_attention(
        torch.tensor(q[:, :, -1:]), torch.tensor(k), torch.tensor(v),
        causal=False, q_chunk=4, k_chunk=8)
    _close(got[:, :, -1:], full.numpy(), ATTN_REL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_len", [1, 11, 40])
def test_cached_decode_attention_matches_jax(dtype, cache_len):
    """One query a head over a 40-slot cache of which ``cache_len`` are
    valid (the rest hold garbage that the mask must hide), GQA group 4."""
    rng = np.random.default_rng(cache_len)
    q = rng.normal(size=(2, 8, 1, 32)).astype(np.float32)
    k = rng.normal(size=(2, 2, 40, 32)).astype(np.float32)
    v = rng.normal(size=(2, 2, 40, 32)).astype(np.float32)
    k[:, :, cache_len:] *= 50.0
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jl.cached_decode_attention(jnp.asarray(q, jd), jnp.asarray(k, jd),
                                      jnp.asarray(v, jd), cache_len)
    got = layers.cached_decode_attention(
        torch.tensor(q).to(td), torch.tensor(k).to(td),
        torch.tensor(v).to(td), cache_len)
    assert got.dtype == td and got.shape == (2, 8, 1, 32)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        _close(got, want, ATTN_REL)
    else:
        limit = 2.0 ** -7 * np.abs(want) + 2.0 ** -9 * np.abs(want).max()
        assert np.all(np.abs(got.float().numpy() - want) <= limit)


def test_attention_decode_matches_jax_and_writes_in_place():
    jcfg, cfg, params, tparams = _pair("qwen3")
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    tp = transformer._layer(tparams["layers"], 0)["attn"]
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    ck = rng.normal(size=(2, cfg.num_kv_heads, 12, cfg.hd)).astype(np.float32)
    cv = rng.normal(size=(2, cfg.num_kv_heads, 12, cfg.hd)).astype(np.float32)
    want, wk, wv = jl.attention_decode(jcfg, jp, jnp.asarray(x),
                                       jnp.asarray(ck), jnp.asarray(cv), 6)
    tk, tv = torch.tensor(ck), torch.tensor(cv)
    got, gk, gv = layers.attention_decode(cfg, tp, torch.tensor(x), tk, tv, 6)
    assert gk is tk and gv is tv          # the caches were written in place
    _close(got, want, REL)
    _close(gk, wk, REL)
    _close(gv, wv, REL)
    assert torch.equal(gk[:, :, :6], torch.tensor(ck[:, :, :6]))
    assert torch.equal(gk[:, :, 7:], torch.tensor(ck[:, :, 7:]))


def test_attention_decode_refuses_a_position_past_the_cache():
    """JAX's dynamic_update_slice clamps pos = Smax onto the last slot; the
    port raises instead."""
    jcfg, cfg, params, tparams = _pair("qwen3")
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    x = np.ones((1, 1, cfg.d_model), np.float32)
    zeros = np.zeros((1, cfg.num_kv_heads, 4, cfg.hd), np.float32)
    _, wk, _ = jl.attention_decode(jcfg, jp, jnp.asarray(x),
                                   jnp.asarray(zeros), jnp.asarray(zeros), 4)
    assert np.any(np.asarray(wk)[:, :, 3] != 0)   # the silent clamp
    tp = transformer._layer(tparams["layers"], 0)["attn"]
    for pos in (4, 9, -1):
        with pytest.raises(ValueError, match="outside the KV cache"):
            layers.attention_decode(cfg, tp, torch.tensor(x),
                                    torch.tensor(zeros), torch.tensor(zeros),
                                    pos)


# --------------------------------------------------------------------------
# Transformer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["", "float8_e4m3fn"])
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_init_cache_shapes_and_dtypes_match_jax(kv_dtype, compute):
    jcfg = jax_config("qwen3-0.6b").scaled_down(kv_dtype=kv_dtype,
                                                compute_dtype=compute)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    want = jt.init_cache(jcfg, 3, 17)
    got = get_model(cfg).init_cache(cfg, 3, 17, device="cpu")
    assert set(got) == set(want) == {"k", "v"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape
        assert str(got[name].dtype) == f"torch.{want[name].dtype}"
        assert got[name].device.type == "cpu"
        assert not torch.any(got[name].float() != 0)


@pytest.mark.parametrize("name,overrides", [
    ("qwen3", {}), ("qwen1.5", {}), ("qwen3", {"kv_dtype": "float8_e4m3fn"})])
def test_decode_step_matches_jax_step_by_step(name, overrides):
    """Twelve tokens fed one at a time from an empty cache: every step's
    logits and the final caches, f32 compute (an fp8 cache rounds K/V the
    same way in both packages)."""
    jcfg, cfg, params, tparams = _pair(name, **overrides)
    toks = _tokens(cfg.vocab_size, (2, 12))
    jcache = jt.init_cache(jcfg, 2, 16)
    cache = transformer.init_cache(cfg, 2, 16, device="cpu")
    k_before = cache["k"]
    jdecode = _jax_decode(jcfg)
    for pos in range(12):
        want, jcache = jdecode(params, jcache, jnp.asarray(toks[:, pos]), pos)
        got, cache = transformer.decode_step(
            cfg, tparams, cache, torch.tensor(toks[:, pos]), pos)
        assert got.shape == (2, cfg.vocab_padded) and got.dtype == torch.float32
        _close(got, want, REL)
    assert cache["k"] is k_before
    _close(cache["k"], np.asarray(jcache["k"].astype(jnp.float32)), REL)
    _close(cache["v"], np.asarray(jcache["v"].astype(jnp.float32)), REL)


@pytest.mark.parametrize("flash", [True, False])
def test_prefill_then_decode_matches_jax(flash):
    """A 9-token prompt prefilled into a 16-slot cache, then 5 decode
    steps: the prefill's last logits, its cache and each step's logits."""
    jcfg, cfg, params, tparams = _pair("qwen3", q_chunk=4, k_chunk=4,
                                       use_pallas_attention=flash)
    toks = _tokens(cfg.vocab_size, (2, 14), seed=3)
    want, jcache = jt.prefill(jcfg, params, jnp.asarray(toks[:, :9]), 16)
    got, cache = transformer.prefill(cfg, tparams, torch.tensor(toks[:, :9]),
                                     16)
    _close(got, want, REL)
    for name in ("k", "v"):
        assert cache[name].shape == jcache[name].shape
        assert not torch.any(cache[name][:, :, :, 9:] != 0)
        _close(cache[name], np.asarray(jcache[name]), REL)
    jdecode = _jax_decode(jcfg)
    for pos in range(9, 14):
        want, jcache = jdecode(params, jcache, jnp.asarray(toks[:, pos]), pos)
        got, cache = transformer.decode_step(
            cfg, tparams, cache, torch.tensor(toks[:, pos]), pos)
        _close(got, want, REL)


def test_prefill_and_decode_agree_with_forward():
    """The port alone: prefill's logits are forward's at the last prompt
    position, and each decode step's are forward's at its position."""
    cfg = get_config("qwen3-0.6b").scaled_down(q_chunk=8, k_chunk=8)
    params = transformer.init_params(cfg, seed=1, device="cpu")
    toks = torch.tensor(_tokens(cfg.vocab_size, (2, 20), seed=9))
    full = transformer.forward(cfg, params, toks)
    got, cache = transformer.prefill(cfg, params, toks[:, :12], 24)
    _close(got, full[:, 11].numpy(), REL)
    for pos in range(12, 20):
        got, cache = transformer.decode_step(cfg, params, cache, toks[:, pos],
                                             pos)
        _close(got, full[:, pos].numpy(), REL)


def test_prefill_refuses_a_prompt_longer_than_the_cache():
    cfg = get_config("qwen3-0.6b").scaled_down()
    params = transformer.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        transformer.prefill(cfg, params, torch.zeros((1, 9), dtype=torch.long),
                            8)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_spec_shapes_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_config(arch)
    for cell in SHAPES.values():
        assert cache_spec_shapes(cfg, cell) == \
            japi.cache_spec_shapes(jcfg, cell)


def test_get_model_serves_the_dense_and_ssm_families():
    dense = get_model(get_config("qwen3-0.6b"))
    assert dense.init_cache is transformer.init_cache
    assert dense.decode_step is transformer.decode_step
    ssm = get_model(get_config("mamba2-370m"))
    assert ssm.forward is mamba2.forward
    assert ssm.init_cache is mamba2.init_cache
    assert ssm.decode_step is mamba2.decode_step
