"""The port's ssm family (``repro_torch.models.mamba2``) against the JAX
package's ``repro.models.mamba2`` on the CPU: ``ssd_chunked`` (whose cell
is ``kernels.ssd_intra``, on the CPU its plain version), ``forward``,
``decode_step`` and ``init_cache`` at ``scaled_down()`` widths (d_model 64,
8 heads of 16, state 16, chunk 8), in f32.

Weights are made by the JAX package from a seed and carried across with
``repro_torch.convert.lm_params_from_numpy``; inputs are made by numpy
from a seed.  With the init recipe (``dt_bias`` -4, conv taps at std
0.02) the SSD's output is some 1e-6 of the skip path's, so no logit could
show a fault in it: the model tests scale the conv taps by 500 and set
``dt_bias`` to 0 (``live``), after which zeroing the SSD's output moves
the logits by more than their largest value.  Tolerances:
``ssd_chunked``'s y and state max |d| <= 1e-5 max |ref| (f32 sums over a
chunk's N and Q terms and the chunk recurrence
in another order); logits max |d| <= 2e-5 max |logit|, the forward's bound
in ``tests/test_torch_lm.py``; the port's own decode against its own
forward 1e-4 max |logit| (the recurrent and the chunked forms of the same
f32 function)."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import mamba2 as jm
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.models import get_model, mamba2

REL = 2e-5
SSD_REL = 1e-5
SELF_REL = 1e-4


def _close(got, want, rel):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _tokens(vocab, shape, seed=42):
    return np.random.default_rng(seed).integers(0, vocab, size=shape
                                                ).astype(np.int32)


def live(tree):
    """A numpy parameter tree with the SSD path made to matter: conv taps
    x 500, ``dt_bias`` 0 (softplus(dt) about 0.7)."""
    layers = dict(tree["layers"], conv_w=tree["layers"]["conv_w"] * 500.0,
                  dt_bias=np.zeros_like(tree["layers"]["dt_bias"]))
    return dict(tree, layers=layers)


def _pair(**overrides):
    """(JAX config, port config, JAX params, port params), ``live``."""
    jcfg = jax_config("mamba2-370m").scaled_down(**overrides)
    tree = live(jax.tree.map(np.asarray,
                             jm.init_params(jcfg, jax.random.key(0))))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(cfg, tree, device="cpu")
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), tparams


def test_the_test_weights_make_the_ssd_matter():
    """Zeroing the SSD's output moves ``live`` weights' logits by more
    than their largest value (the init recipe's by 2e-6 of it)."""
    _, cfg, _, tparams = _pair()
    toks = torch.tensor(_tokens(cfg.vocab_size, (2, 24)))
    base = mamba2.forward(cfg, tparams, toks)
    chunked = mamba2.ssd_chunked
    mamba2.ssd_chunked = lambda *a: (chunked(*a)[0] * 0, None)
    try:
        cut = mamba2.forward(cfg, tparams, toks)
    finally:
        mamba2.ssd_chunked = chunked
    assert float((cut - base).abs().max()) > float(base.abs().max())


@pytest.mark.parametrize("s,chunk", [(32, 8), (24, 24), (5, 8), (64, 16)])
def test_ssd_chunked_matches_jax(s, chunk):
    """y and the final state, with decays as the model makes them
    (softplus'd dt, A from 1 to 16)."""
    rng = np.random.default_rng(s + chunk)
    b, h, p, n = 2, 4, 8, 6
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    dtv = np.log1p(np.exp(rng.normal(-2.0, 1.0, size=(b, s, h)))
                   ).astype(np.float32)
    a_neg = -np.linspace(1.0, 16.0, h).astype(np.float32)
    wy, ws = jm.ssd_chunked(*(jnp.asarray(a) for a in (xh, bb, cc, dtv,
                                                          a_neg)), chunk)
    gy, gs = mamba2.ssd_chunked(*(torch.tensor(a) for a in (xh, bb, cc, dtv,
                                                            a_neg)), chunk)
    assert gy.shape == (b, s, h, p) and gs.shape == (b, h, n, p)
    _close(gy, wy, SSD_REL)
    _close(gs, ws, SSD_REL)


def test_ssd_chunked_refuses_a_ragged_sequence():
    z = torch.zeros((1, 12, 2, 4))
    with pytest.raises(ValueError, match="not divisible"):
        mamba2.ssd_chunked(z, torch.zeros((1, 12, 3)), torch.zeros((1, 12, 3)),
                           torch.zeros((1, 12, 2)), -torch.ones(2), 8)


def test_init_params_names_shapes_and_recipe_match_jax():
    jcfg = jax_config("mamba2-370m").scaled_down()
    jtree = jm.init_params(jcfg, jax.random.key(0))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    tree = mamba2.init_params(cfg, seed=0, device="cpu")
    jflat = {"/".join(str(k.key) for k in path): leaf
             for path, leaf in jax.tree_util.tree_leaves_with_path(jtree)}
    flat = {}

    def walk(t, pre):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}/")
            else:
                flat[f"{pre}{k}"] = v
    walk(tree, "")
    assert {k: tuple(v.shape) for k, v in flat.items()} == \
        {k: tuple(v.shape) for k, v in jflat.items()}
    for name in ("layers/A_log", "layers/Dskip", "layers/dt_bias",
                 "layers/gnorm", "layers/ln", "layers/conv_b", "final_norm"):
        np.testing.assert_allclose(flat[name].numpy(), np.asarray(jflat[name]),
                                   rtol=1e-6, err_msg=name)
    assert abs(float(flat["layers/in_proj"].std()) - 0.0176) < 3e-3


@pytest.mark.parametrize("seq", [16, 24, 5])
def test_forward_matches_jax(seq):
    jcfg, cfg, params, tparams = _pair()
    toks = _tokens(cfg.vocab_size, (2, seq))
    want = np.asarray(jm.forward(jcfg, params, jnp.asarray(toks)))
    got = get_model(cfg).forward(cfg, tparams, torch.tensor(toks))
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, seq, cfg.vocab_padded)
    _close(got, want, REL)


def test_forward_pads_vocab_logits():
    jcfg, cfg, params, tparams = _pair(vocab_size=250)
    toks = _tokens(250, (1, 8))
    want = np.asarray(jm.forward(jcfg, params, jnp.asarray(toks)))
    got = mamba2.forward(cfg, tparams, torch.tensor(toks))
    assert got.shape[-1] == 256 and torch.all(got[..., 250:] == -1e30)
    _close(got[..., :250], want[..., :250], REL)


def test_init_cache_matches_jax():
    for compute in ("float32", "bfloat16"):
        jcfg = jax_config("mamba2-370m").scaled_down(compute_dtype=compute)
        cfg = model_config_from_fields(dataclasses.asdict(jcfg))
        want = jm.init_cache(jcfg, 3, 99)
        got = mamba2.init_cache(cfg, 3, 99, device="cpu")
        assert set(got) == set(want) == {"ssm", "conv"}
        for name in got:
            assert tuple(got[name].shape) == want[name].shape
            assert str(got[name].dtype) == f"torch.{want[name].dtype}"
            assert not torch.any(got[name] != 0)


def test_decode_step_matches_jax_step_by_step():
    """Twelve tokens one at a time from an empty state: every step's
    logits, then the final ssm state and conv window; the state is advanced
    in place."""
    jcfg, cfg, params, tparams = _pair()
    toks = _tokens(cfg.vocab_size, (2, 12), seed=7)
    jdecode = jax.jit(lambda p, c, t: jm.decode_step(jcfg, p, c, t, 0))
    jcache = jm.init_cache(jcfg, 2)
    cache = mamba2.init_cache(cfg, 2, device="cpu")
    ssm_before = cache["ssm"]
    for pos in range(12):
        want, jcache = jdecode(params, jcache, jnp.asarray(toks[:, pos]))
        got, cache = mamba2.decode_step(cfg, tparams, cache,
                                        torch.tensor(toks[:, pos]), pos)
        assert got.shape == (2, cfg.vocab_padded) and got.dtype == torch.float32
        _close(got, want, REL)
    assert cache["ssm"] is ssm_before
    _close(cache["ssm"], jcache["ssm"], REL)
    _close(cache["conv"], jcache["conv"], REL)


def test_decode_agrees_with_forward():
    """The port alone: teacher-forced decode gives forward's logits at every
    position (the recurrent form against the chunked one, 3 chunks)."""
    _, cfg, _, params = _pair()
    toks = torch.tensor(_tokens(cfg.vocab_size, (2, 24), seed=11))
    full = mamba2.forward(cfg, params, toks)
    cache = mamba2.init_cache(cfg, 2, device="cpu")
    for pos in range(24):
        got, cache = mamba2.decode_step(cfg, params, cache, toks[:, pos], pos)
        _close(got, full[:, pos].numpy(), SELF_REL)


def test_bf16_forward_and_decode_run_and_stay_finite():
    """The published dtypes through the plain path on the CPU: finite f32
    logits close to the f32 model's on the same weights (lm_bf16's 5e-2 of
    the largest logit: bf16 roundings part ways layer by layer)."""
    cfg = get_config("mamba2-370m").scaled_down(param_dtype="bfloat16",
                                                compute_dtype="bfloat16")
    params = mamba2.init_params(cfg, seed=0, device="cpu")
    toks = torch.tensor(_tokens(cfg.vocab_size, (2, 16), seed=2))
    got = mamba2.forward(cfg, params, toks)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    params32 = {k: ({n: a.float() for n, a in v.items()}
                    if isinstance(v, dict) else v.float())
                for k, v in params.items()}
    ref = mamba2.forward(f32, params32, toks)
    assert float((got - ref).abs().max()) <= 5e-2 * float(ref.abs().max())
    cache = mamba2.init_cache(cfg, 2, device="cpu")
    assert cache["conv"].dtype == torch.bfloat16
    for pos in range(16):
        step, cache = mamba2.decode_step(cfg, params, cache, toks[:, pos], pos)
        assert torch.isfinite(step).all()
    assert float((step - ref[:, -1]).abs().max()) <= \
        5e-2 * float(ref.abs().max())


def test_forward_on_cpu_launches_no_kernel():
    """The CPU path takes the SSD cell's plain version: no launch."""
    mod = importlib.import_module("repro_torch.kernels.ssd_intra")
    before = mod.ssd_intra.launches
    cfg = get_config("mamba2-370m").scaled_down()
    params = mamba2.init_params(cfg, seed=0, device="cpu")
    mamba2.forward(cfg, params, torch.zeros((1, 8), dtype=torch.long))
    assert mod.ssd_intra.launches == before


def test_ssd_cell_gradient_is_finite_where_a_masked_decay_overflows():
    """A steep decay overflows exp(cs_i - cs_j) above the diagonal (cs_i -
    cs_j past 88 in a 64-token chunk): ``ssd_chunked``'s value is the JAX
    package's and its gradient in dt finite, where the JAX package's
    (``where(causal, g * exp(..), 0)``, whose gradient multiplies 0 by the
    infinity) is NaN."""
    from repro.models import mamba2 as jm
    rng = np.random.default_rng(3)
    b, s, h, p, n = 1, 64, 2, 4, 3
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    dtv = rng.uniform(1.0, 2.0, size=(b, s, h)).astype(np.float32)
    a_neg = -np.array([2.0, 3.0], np.float32)        # cs spans over 100
    args = [jnp.asarray(a) for a in (xh, bb, cc)]

    def jy(d):
        return jm.ssd_chunked(*args, d, jnp.asarray(a_neg), 64)[0]

    want = np.asarray(jy(jnp.asarray(dtv)))
    jgrad = jax.grad(lambda d: jy(d).sum())(jnp.asarray(dtv))
    assert np.isnan(np.asarray(jgrad)).any()
    td = torch.tensor(dtv, requires_grad=True)
    y, _ = mamba2.ssd_chunked(torch.tensor(xh), torch.tensor(bb),
                              torch.tensor(cc), td, torch.tensor(a_neg), 64)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    (g,) = torch.autograd.grad(y.sum(), td)
    assert torch.isfinite(g).all() and g.abs().max() > 0
