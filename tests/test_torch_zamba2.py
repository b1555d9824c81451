"""The port's hybrid family (``repro_torch.models.zamba2``) against the JAX
package's ``repro.models.zamba2`` on the CPU, in f32, at the shape of the
JAX package's own decode test (``tests/test_models.py``: d_model 32, 4
heads of 8, ssm_state 8, ssm_headdim 8, chunk 4, attn_every 2) with 5
layers (two super-blocks and one trailing block), 4 (no tail) and 1 (no
super-block).

Weights are made by the JAX package from a seed and carried across with
``repro_torch.convert.lm_params_from_numpy``; inputs are made by numpy
from a seed.  With the init recipe the SSD's output is some 1e-6 of the
skip path's, so the tests scale the conv taps by 500 and set ``dt_bias``
to 0 (``live``, as ``tests/test_torch_mamba2.py`` does); the gradient test
by 50 (``GRAD_TAPS``, as ``chip_smoke.live_ssd`` does), where the SSD
still moves the logits by some 1 %: at 500 the gradient is past f32's
reach at 4 layers (a 1-ulp change of every weight moves the JAX package's
own embedding gradient by 4.5e-6, over the rule's atol).  Tolerances:
logits, hidden states max |d| <= 2e-5 max |ref| (``REL``, the forward's
bound in ``tests/test_torch_lm.py``); the loss rtol 1e-5 and every leaf's
gradient rtol 1e-4, atol 1e-6 (``tests/test_torch_loss.py``); the port's
own decode against its own forward 1e-4 max |logit| (the recurrent and
the chunked forms of the same f32 function).  The engine and the
trainer's resume are bitwise.
"""

import dataclasses
import filecmp

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
from repro_torch.checkpoint import SlotStore
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.launch import train
from repro_torch.launch.train import SimulatedFailure
from repro_torch.models import counting, get_model, zamba2
from repro_torch.models.api import param_shapes
from repro_torch.optim.adamw import _leaves
from repro_torch.serving import Request, ServeEngine

REL = 2e-5
SELF_REL = 1e-4
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
LAYERS = [5, 4, 1]
GRAD_TAPS = 50.0


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


def _jcfg(num_layers=5, **kw):
    base = dict(name="z", family="hybrid", num_layers=num_layers,
                d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                vocab_size=64, ssm_state=8, ssm_headdim=8, ssm_chunk=4,
                attn_every=2, q_chunk=4, k_chunk=4, param_dtype="float32",
                compute_dtype="float32", remat="none")
    return JaxModelConfig(**(base | kw))


def live(tree, taps=500.0):
    """A numpy parameter tree with the SSD path made to matter: conv taps
    x ``taps``, ``dt_bias`` 0 (softplus(dt) about 0.7)."""
    out = dict(tree)
    for group in ("mamba_main", "mamba_tail"):
        out[group] = dict(tree[group], conv_w=tree[group]["conv_w"] * taps,
                          dt_bias=np.zeros_like(tree[group]["dt_bias"]))
    return out


def _pair(num_layers=5, taps=500.0, **kw):
    """(JAX config, port config, JAX params, port params), ``live``."""
    jcfg = _jcfg(num_layers, **kw)
    tree = live(jax.tree.map(np.asarray,
                             jz.init_params(jcfg, jax.random.key(0))), taps)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        lm_params_from_numpy(cfg, tree, device="cpu")


def _tokens(vocab, shape, seed=42):
    return np.random.default_rng(seed).integers(0, vocab, size=shape
                                                ).astype(np.int32)


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


@pytest.mark.parametrize("num_layers", LAYERS)
def test_param_shapes_match_jax_eval_shape(num_layers):
    jcfg = _jcfg(num_layers)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    want = _flat_shapes(jax.eval_shape(
        lambda: jz.init_params(jcfg, jax.random.key(0))))
    assert param_shapes(cfg) == want
    assert _flat_shapes(zamba2.init_params(cfg, seed=0, device="cpu")) == \
        want


def test_published_config_counts_match_jax():
    cfg, jcfg = get_config("zamba2-7b"), jax_config("zamba2-7b")
    assert get_model(cfg).forward is zamba2.forward
    assert counting.param_count(cfg) == jcounting.param_count(jcfg)
    assert counting.model_flops(cfg, 8192, "train") == \
        jcounting.model_flops(jcfg, 8192, "train")


def test_the_test_weights_make_the_ssd_and_the_shared_block_matter():
    """Zeroing the SSD's output, or the shared block's attention, moves
    the logits by more than 1e-2 of their largest value, 500 times
    ``REL``."""
    _, cfg, _, params = _pair()
    toks = torch.tensor(_tokens(cfg.vocab_size, (2, 8)))
    base = zamba2.forward(cfg, params, toks)
    scale = float(base.abs().max())
    chunked = zamba2.mamba2.ssd_chunked
    zamba2.mamba2.ssd_chunked = lambda *a: (chunked(*a)[0] * 0, None)
    try:
        cut = zamba2.forward(cfg, params, toks)
    finally:
        zamba2.mamba2.ssd_chunked = chunked
    assert float((cut - base).abs().max()) > 1e-2 * scale
    wo = params["shared"]["attn"]["wo"]
    params["shared"]["attn"]["wo"] = torch.zeros_like(wo)
    try:
        cut = zamba2.forward(cfg, params, toks)
    finally:
        params["shared"]["attn"]["wo"] = wo
    assert float((cut - base).abs().max()) > 1e-2 * scale


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("num_layers", LAYERS)
def test_forward_and_hidden_match_jax(num_layers, flash):
    jcfg, cfg, params, tparams = _pair(num_layers,
                                       use_pallas_attention=flash)
    toks = _tokens(cfg.vocab_size, (2, 12))
    want = np.asarray(jz.forward(jcfg, params, jnp.asarray(toks)))
    got = get_model(cfg).forward(cfg, tparams, torch.tensor(toks))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 12, cfg.vocab_padded)
    _close(got, want, REL)
    _close(zamba2.hidden_fn(cfg, tparams, torch.tensor(toks)),
           jz.hidden_fn(jcfg, params, jnp.asarray(toks)), REL)


@pytest.mark.parametrize("num_layers", LAYERS)
def test_loss_and_every_gradient_match_jax(num_layers):
    jcfg, cfg, params, tparams = _pair(num_layers, taps=GRAD_TAPS)
    toks = _tokens(cfg.vocab_size, (2, 12), seed=3)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
    want, wgrad = jax.value_and_grad(
        lambda p: jz.loss_fn(jcfg, p, jb))(params)
    leaves = _leaves(tparams)
    for x in leaves:
        x.requires_grad_(True)
    tb = {"tokens": torch.tensor(toks), "labels": torch.tensor(toks)}
    loss = zamba2.loss_fn(cfg, tparams, tb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=LOSS_RTOL)
    wl = jax.tree.leaves(wgrad)
    assert len(wl) == len(leaves)
    for x, g, w in zip(leaves, grads, wl):
        g = torch.zeros_like(x) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_init_cache_matches_jax():
    for layers in LAYERS:
        jcfg = _jcfg(layers)
        cfg = model_config_from_fields(dataclasses.asdict(jcfg))
        want = jz.init_cache(jcfg, 3, 11)
        got = zamba2.init_cache(cfg, 3, 11, device="cpu")
        assert set(got) == set(want) == {"ssm", "conv", "k", "v"}
        for name in got:
            assert tuple(got[name].shape) == want[name].shape
            assert str(got[name].dtype) == f"torch.{want[name].dtype}"
            assert not torch.any(got[name] != 0)


@pytest.mark.parametrize("num_layers", LAYERS)
def test_decode_step_matches_jax_and_the_forward(num_layers):
    """Eight tokens one at a time from an empty cache: every step's logits
    against JAX's, then the cache it leaves (advanced in place); then the
    port's steps against its own forward at each position."""
    jcfg, cfg, params, tparams = _pair(num_layers)
    toks = _tokens(cfg.vocab_size, (2, 8), seed=7)
    jdecode = jax.jit(lambda p, c, t, pos: jz.decode_step(jcfg, p, c, t,
                                                           pos))
    jcache = jz.init_cache(jcfg, 2, 16)
    cache = zamba2.init_cache(cfg, 2, 16, device="cpu")
    before = {k: v for k, v in cache.items()}
    steps = []
    for pos in range(8):
        want, jcache = jdecode(params, jcache, jnp.asarray(toks[:, pos]), pos)
        got, cache = zamba2.decode_step(cfg, tparams, cache,
                                        torch.tensor(toks[:, pos]), pos)
        assert got.shape == (2, cfg.vocab_padded) and got.dtype == torch.float32
        _close(got, want, REL)
        steps.append(got)
    for name in ("ssm", "conv", "k", "v"):
        assert cache[name] is before[name]
        if cache[name].numel():
            _close(cache[name], jcache[name], REL)
    full = zamba2.forward(cfg, tparams, torch.tensor(toks))
    _close(torch.stack(steps, 1), full.numpy(), SELF_REL)


def test_lm_params_from_numpy_refuses_another_family():
    jcfg = _jcfg()
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    wcfg = JaxModelConfig(name="w", family="encdec", num_layers=2,
                          d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                          vocab_size=64, encoder_layers=2, encoder_seq=6)
    wtree = jax.tree.map(np.asarray, jw.init_params(wcfg, jax.random.key(1)))
    with pytest.raises(ValueError, match="parameter names differ"):
        lm_params_from_numpy(cfg, wtree, device="cpu")
    ztree = jax.tree.map(np.asarray, jz.init_params(_jcfg(4),
                                                    jax.random.key(0)))
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(cfg, ztree, device="cpu")


def test_engine_repeats_and_resumes_bitwise(tmp_path):
    """``ServeEngine`` on the port's zamba2 (bf16 weights, CPU): a second
    run and a run preempted after 3 tokens then resumed give the first
    run's tokens bit for bit."""
    cfg = dataclasses.replace(model_config_from_fields(
        dataclasses.asdict(_jcfg())), param_dtype="bfloat16",
        compute_dtype="bfloat16")
    params = zamba2.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 64, 6).tolist() for _ in range(3)]

    def reqs():
        return [Request(f"r{i}", p, 8) for i, p in enumerate(prompts)]

    ref = ServeEngine(cfg, params, tmp_path / "a", max_len=16).run(reqs())
    assert all(len(t) == 8 for t in ref.values())
    assert ServeEngine(cfg, params, tmp_path / "b", max_len=16).run(
        reqs()) == ref
    with pytest.raises(RuntimeError, match="preempted"):
        ServeEngine(cfg, params, tmp_path / "c", max_len=16).run(
            reqs(), fail_after_tokens=3)
    assert ServeEngine(cfg, params, tmp_path / "c", max_len=16).run(
        reqs()) == ref


def test_two_train_steps_resume_byte_for_byte(tmp_path):
    """``launch.train.train`` on a scaled-down zamba2-7b (bf16, remat
    "full", one super-block of 2 and one trailing block): two steps, and
    the same run failed before its second step and resumed, end on the
    same parameter and optimizer leaves bit for bit."""
    cfg = get_config("zamba2-7b").scaled_down(
        num_layers=3, attn_every=2, param_dtype="bfloat16",
        compute_dtype="bfloat16")
    kw = dict(steps=2, batch=2, seq=16, ckpt_interval=1, seed=0,
              log_every=0, device="cpu")
    ref = train.train(cfg, ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(SimulatedFailure):
        train.train(cfg, ckpt_dir=str(tmp_path / "b"), fail_at_step=1, **kw)
    res = train.train(cfg, ckpt_dir=str(tmp_path / "b"), **kw)
    assert res.steps_run == 1 and res.final_step == 2
    assert res.losses == ref.losses[1:] and np.isfinite(ref.losses).all()
    files = []
    for run in ("a", "b"):
        store = SlotStore(tmp_path / run / "state")
        m = store.manifest()
        files.append((store.root / m["slot"], m))
    (da, ma), (db, mb) = files
    assert ma["meta"] == mb["meta"] and ma["meta"]["step"] == 2
    assert ma["leaves"] == mb["leaves"] and ma["dtypes"] == mb["dtypes"]
    for name in ma["leaves"]:
        assert filecmp.cmp(da / name, db / name, shallow=False), name
