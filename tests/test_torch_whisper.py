"""The port's encdec family (``repro_torch.models.whisper``) against the
JAX package's ``repro.models.whisper`` on the CPU, in f32, at the shape of
the JAX package's own decode test (``tests/test_models.py``: 2 encoder and
2 decoder layers, d_model 32, 4 heads of 8, attention chunks of 4) with
6 frames and with a ragged 37 (the encoder's and the cross-attention's
last key chunk of 1).

Weights are made by the JAX package from a seed and carried across with
``repro_torch.convert.lm_params_from_numpy``; frames and tokens are made
by numpy from a seed.  Tolerances: logits, hidden states, the encoder
output and the cross K/V max |d| <= 2e-5 max |ref| (``REL``, the forward's
bound in ``tests/test_torch_lm.py``); the loss rtol 1e-5 and every leaf's
gradient rtol 1e-4, atol 1e-6 (``tests/test_torch_loss.py``); the port's
own decode against its own forward 1e-4 max |logit|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import counting as jcounting
from repro.models import whisper as jw
from repro.models import zamba2 as jz
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.models import counting, get_model, whisper
from repro_torch.models.api import param_shapes
from repro_torch.optim.adamw import _leaves

REL = 2e-5
SELF_REL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
FRAMES = [6, 37]


@pytest.fixture(scope="module", autouse=True)
def jax_x64():
    """Let the JAX reference run on the installed jax, whose
    ``jax.experimental`` no longer has ``enable_x64``; undone after this
    module so no other test file sees it."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "enable_x64",
               lambda: jax.enable_x64(True), raising=False)
    yield
    mp.undo()


def _jcfg(encoder_seq=6, **kw):
    base = dict(name="w", family="encdec", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=64,
                encoder_layers=2, encoder_seq=encoder_seq, q_chunk=4,
                k_chunk=4, param_dtype="float32", compute_dtype="float32",
                remat="none")
    return JaxModelConfig(**(base | kw))


def _pair(encoder_seq=6, **kw):
    """(JAX config, port config, JAX params, port params, frames, tokens)."""
    jcfg = _jcfg(encoder_seq, **kw)
    tree = jax.tree.map(np.asarray, jw.init_params(jcfg, jax.random.key(1)))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(2)
    frames = rng.normal(size=(2, encoder_seq, 32)).astype(np.float32)
    toks = rng.integers(0, 64, (2, 10)).astype(np.int32)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        lm_params_from_numpy(cfg, tree, device="cpu"), frames, toks


def _close(got, want, rel):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _flat_shapes(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out |= _flat_shapes(v, f"{pre}{k}.")
        else:
            out[f"{pre}{k}"] = tuple(v.shape)
    return out


@pytest.mark.parametrize("encoder_seq", FRAMES)
def test_param_shapes_match_jax_eval_shape(encoder_seq):
    jcfg = _jcfg(encoder_seq, encoder_layers=3)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    want = _flat_shapes(jax.eval_shape(
        lambda: jw.init_params(jcfg, jax.random.key(0))))
    assert param_shapes(cfg) == want
    assert _flat_shapes(whisper.init_params(cfg, seed=0, device="cpu")) == \
        want


def test_published_config_counts_match_jax():
    cfg, jcfg = get_config("whisper-small"), jax_config("whisper-small")
    assert get_model(cfg).forward is whisper.forward
    assert counting.param_count(cfg) == jcounting.param_count(jcfg)
    assert counting.model_flops(cfg, 8192, "prefill") == \
        jcounting.model_flops(jcfg, 8192, "prefill")


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("encoder_seq", FRAMES)
def test_encode_forward_and_hidden_match_jax(encoder_seq, flash):
    jcfg, cfg, params, tparams, frames, toks = _pair(
        encoder_seq, use_pallas_attention=flash)
    jf, tf = jnp.asarray(frames), torch.tensor(frames)
    enc = whisper.encode(cfg, tparams, tf)
    jenc = jw.encode(jcfg, params, jf)
    _close(enc, jenc, REL)
    want = np.asarray(jw.forward(jcfg, params,
                                 {"frames": jf, "tokens": jnp.asarray(toks)}))
    got = get_model(cfg).forward(cfg, tparams, {"frames": tf,
                                                "tokens": torch.tensor(toks)})
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 10, cfg.vocab_padded)
    _close(got, want, REL)
    _close(whisper.dec_hidden(cfg, tparams, torch.tensor(toks), enc),
           jw.dec_hidden(jcfg, params, jnp.asarray(toks), jenc), REL)


@pytest.mark.parametrize("encoder_seq", FRAMES)
def test_loss_and_every_gradient_match_jax(encoder_seq):
    jcfg, cfg, params, tparams, frames, toks = _pair(encoder_seq)
    jb = {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks),
          "labels": jnp.asarray(toks)}
    want, wgrad = jax.value_and_grad(
        lambda p: jw.loss_fn(jcfg, p, jb))(params)
    leaves = _leaves(tparams)
    for x in leaves:
        x.requires_grad_(True)
    tb = {"frames": torch.tensor(frames), "tokens": torch.tensor(toks),
          "labels": torch.tensor(toks)}
    loss = get_model(cfg).loss_fn(cfg, tparams, tb)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    wl = jax.tree.leaves(wgrad)
    assert len(wl) == len(leaves)
    for g, w in zip(grads, wl):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_init_cache_matches_jax():
    for frames in FRAMES:
        jcfg = _jcfg(frames)
        cfg = model_config_from_fields(dataclasses.asdict(jcfg))
        want = jw.init_cache(jcfg, 3, 11)
        got = whisper.init_cache(cfg, 3, 11, device="cpu")
        assert set(got) == set(want) == {"k", "v", "xk", "xv"}
        for name in got:
            assert tuple(got[name].shape) == want[name].shape
            assert str(got[name].dtype) == f"torch.{want[name].dtype}"
            assert not torch.any(got[name] != 0)


@pytest.mark.parametrize("encoder_seq", FRAMES)
def test_prefill_cross_and_decode_match_jax_and_the_forward(encoder_seq):
    """``prefill_cross``'s cross K/V against JAX's, then ten tokens one at
    a time: every step's logits against JAX's, the self-attention cache
    they leave (written in place), and the port's steps against its own
    forward at each position."""
    jcfg, cfg, params, tparams, frames, toks = _pair(encoder_seq)
    jcache = jw.prefill_cross(jcfg, params, jw.init_cache(jcfg, 2, 16),
                              jnp.asarray(frames))
    cache = whisper.init_cache(cfg, 2, 16, device="cpu")
    k_before = cache["k"]
    cache = whisper.prefill_cross(cfg, tparams, cache, torch.tensor(frames))
    _close(cache["xk"], jcache["xk"], REL)
    _close(cache["xv"], jcache["xv"], REL)
    jdecode = jax.jit(lambda p, c, t, pos: jw.decode_step(jcfg, p, c, t,
                                                           pos))
    steps = []
    for pos in range(10):
        want, jcache = jdecode(params, jcache, jnp.asarray(toks[:, pos]), pos)
        got, cache = whisper.decode_step(cfg, tparams, cache,
                                         torch.tensor(toks[:, pos]), pos)
        assert got.shape == (2, cfg.vocab_padded) and got.dtype == torch.float32
        _close(got, want, REL)
        steps.append(got)
    assert cache["k"] is k_before
    _close(cache["k"], jcache["k"], REL)
    _close(cache["v"], jcache["v"], REL)
    full = whisper.forward(cfg, tparams, {"frames": torch.tensor(frames),
                                          "tokens": torch.tensor(toks)})
    _close(torch.stack(steps, 1), full.numpy(), SELF_REL)


def test_lm_params_from_numpy_refuses_another_family():
    cfg = model_config_from_fields(dataclasses.asdict(_jcfg()))
    zcfg = JaxModelConfig(name="z", family="hybrid", num_layers=5,
                          d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                          vocab_size=64, ssm_state=8, ssm_headdim=8,
                          ssm_chunk=4, attn_every=2)
    ztree = jax.tree.map(np.asarray, jz.init_params(zcfg, jax.random.key(0)))
    with pytest.raises(ValueError, match="parameter names differ"):
        lm_params_from_numpy(cfg, ztree, device="cpu")
    wtree = jax.tree.map(np.asarray, jw.init_params(
        _jcfg(encoder_layers=3), jax.random.key(1)))
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(cfg, wtree, device="cpu")


def test_bf16_forward_and_decode_run_and_stay_finite():
    """The published dtypes on the CPU: finite f32 logits close to the
    f32 model's on the same weights (lm_bf16's 5e-2 of the largest
    logit), and finite decode steps after ``prefill_cross``."""
    cfg = get_config("whisper-small").scaled_down(
        param_dtype="bfloat16", compute_dtype="bfloat16")
    params = whisper.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    frames = torch.tensor(rng.normal(size=(2, cfg.encoder_seq,
                                           cfg.d_model)).astype(np.float32))
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, 12)))
    got = whisper.forward(cfg, params, {"frames": frames, "tokens": toks})
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params32 = {k: ({n: {m: a.float() for m, a in b.items()}
                     if isinstance(b, dict) else b.float()
                     for n, b in v.items()} if isinstance(v, dict)
                    else v.float()) for k, v in params.items()}
    ref = whisper.forward(f32, params32, {"frames": frames, "tokens": toks})
    assert float((got - ref).abs().max()) <= 5e-2 * float(ref.abs().max())
    cache = whisper.prefill_cross(cfg, params, whisper.init_cache(
        cfg, 2, 12, device="cpu"), frames)
    assert cache["xk"].dtype == torch.bfloat16
    for pos in range(12):
        step, cache = whisper.decode_step(cfg, params, cache, toks[:, pos],
                                          pos)
        assert torch.isfinite(step).all()
