"""The port's losses (``repro_torch.models.transformer``: ``xent_loss``,
``lm_xent_from_hidden``, ``lm_loss``, ``loss_fn``; ``mamba2.loss_fn``)
and their gradients against the JAX package's on the CPU, at
``scaled_down()`` widths in f32, and the ``remat`` policies.

Weights are made by the JAX package from a seed and carried across with
``repro_torch.convert.lm_params_from_numpy``; inputs are made by numpy
from a seed.  Tolerances: a loss rtol 1e-5 (f32 sums in another order);
``jax.grad`` against autograd per leaf rtol 1e-4, atol 1e-6.  The remat
policies recompute the same operations on the same inputs, so they are
held bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import api as japi
from repro.models import transformer as jt
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, model_config_from_fields
from repro_torch.kernels import ops
from repro_torch.models import get_model, mamba2, transformer
from repro_torch.optim.adamw import _leaves

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def _grads_close(got, want):
    """Autograd's per-leaf gradients against ``jax.grad``'s, leaf for leaf
    in the JAX package's order."""
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def _torch_grads(fn, tree):
    """(fn(tree), the gradient of each leaf of ``tree`` in the JAX
    package's order) by autograd."""
    leaves = _leaves(tree)
    for x in leaves:
        x.requires_grad_(True)
    loss = fn(tree)
    grads = torch.autograd.grad(loss, leaves)
    for x in leaves:
        x.requires_grad_(False)
    return loss.detach(), list(grads)


# --------------------------------------------------------------------------
# The cross-entropy and the streamed head
# --------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_xent_loss_matches_jax(masked):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 7, 40)).astype(np.float32) * 3
    labels = rng.integers(0, 40, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    want, wgrad = jax.value_and_grad(
        lambda lg: jt.xent_loss(lg, jnp.asarray(labels), jm))(
            jnp.asarray(logits))
    tl = torch.tensor(logits, requires_grad=True)
    got = transformer.xent_loss(tl, torch.tensor(labels),
                                None if mask is None else torch.tensor(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(wgrad),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_xent_loss_of_an_empty_mask_is_zero():
    logits = torch.zeros((1, 3, 8))
    got = transformer.xent_loss(logits, torch.zeros((1, 3), dtype=torch.long),
                                torch.zeros((1, 3)))
    assert float(got) == 0.0


@pytest.mark.parametrize("seq", [600, 512, 300],
                         ids=["padded_last_chunk", "one_full_chunk",
                              "one_short_chunk"])
def test_lm_xent_from_hidden_matches_jax(seq):
    """The streamed head and loss: at S = 600 two 512-token chunks, the
    second padded by 424 masked positions; at S <= 512 one chunk.  The
    loss and its gradient in x and the head (vocab padded, so the padded
    columns' -1e30 pass through the log-sum-exp)."""
    jcfg = jax_config("qwen3-0.6b").scaled_down(vocab_size=250)
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(seq)
    x = rng.normal(size=(2, seq, cfg.d_model)).astype(np.float32)
    head = (rng.normal(size=(cfg.d_model, cfg.vocab_padded)) * 0.1).astype(
        np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    mask = (rng.random((2, seq)) < 0.8).astype(np.float32)
    want, (gx, gh) = jax.value_and_grad(
        lambda a, b: jt.lm_xent_from_hidden(jcfg, a, b, jnp.asarray(labels),
                                            jnp.asarray(mask)),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(head))
    tx = torch.tensor(x, requires_grad=True)
    th = torch.tensor(head, requires_grad=True)
    got = transformer.lm_xent_from_hidden(cfg, tx, th, torch.tensor(labels),
                                          torch.tensor(mask))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_lm_xent_without_a_mask_is_the_plain_mean():
    cfg = get_config("qwen3-0.6b").scaled_down()
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 530, cfg.d_model, generator=g)
    head = torch.randn(cfg.d_model, cfg.vocab_padded, generator=g) * 0.1
    labels = torch.randint(0, cfg.vocab_size, (2, 530), generator=g)
    got = transformer.lm_xent_from_hidden(cfg, x, head, labels)
    want = transformer.xent_loss(transformer.logits_fn(
        cfg, {"lm_head": head}, x), labels)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


def test_lm_loss_matches_jax():
    jcfg = jax_config("qwen3-0.6b").scaled_down()
    params = jt.init_params(jcfg, jax.random.key(1))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want = jt.lm_loss(jcfg, params, jnp.asarray(x), jnp.asarray(toks))
    got = transformer.lm_loss(cfg, tparams, torch.tensor(x),
                              torch.tensor(toks))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


# --------------------------------------------------------------------------
# loss_fn of every family the port trains
# --------------------------------------------------------------------------

#: (arch, overrides, sequence length)
FAMILIES = {
    "dense": ("qwen3-0.6b", {}, 20),
    "dense-tied-bias": ("qwen1.5-0.5b", {"tie_embeddings": True}, 20),
    "moe": ("qwen3-moe-30b-a3b", {}, 32),
    "moe-shared": ("llama4-scout-17b-a16e", {}, 32),
    "vlm": ("internvl2-26b", {}, 24),
    "ssm": ("mamba2-370m", {}, 24),
}


def _live(tree):
    """mamba2's tree with the SSD path made to matter (conv taps x 500,
    ``dt_bias`` 0), as ``tests/test_torch_mamba2.py`` does."""
    if "conv_w" not in tree["layers"]:
        return tree
    layers = dict(tree["layers"], conv_w=tree["layers"]["conv_w"] * 500.0,
                  dt_bias=np.zeros_like(tree["layers"]["dt_bias"]))
    return dict(tree, layers=layers)


def _family_case(name):
    arch, overrides, seq = FAMILIES[name]
    jcfg = jax_config(arch).scaled_down(**overrides)
    tree = _live(jax.tree.map(np.asarray, japi.get_model(jcfg).init_params(
        jcfg, jax.random.key(0))))
    cfg = model_config_from_fields(dataclasses.asdict(jcfg))
    tparams = lm_params_from_numpy(cfg, tree, device="cpu")
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(2, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), tparams, batch


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_loss_fn_and_its_gradient_match_jax(name):
    jcfg, cfg, params, tparams, batch = _family_case(name)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, wgrad = jax.value_and_grad(
        lambda p: japi.get_model(jcfg).loss_fn(jcfg, p, jbatch))(params)
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    api = get_model(cfg)
    got, grads = _torch_grads(lambda p: api.loss_fn(cfg, p, tbatch),
                              tparams)
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    _grads_close(grads, wgrad)


def test_vlm_loss_drops_the_patch_positions():
    """The labels align with the text: the vlm loss is the text positions'
    loss of the hidden states computed over patches and text."""
    _, cfg, _, tparams, batch = _family_case("vlm")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    x = transformer.hidden_states(cfg, tparams, tb["tokens"], tb["patches"])
    want = transformer.lm_loss(cfg, tparams, x[:, cfg.num_patches:],
                               tb["labels"])
    assert float(transformer.loss_fn(cfg, tparams, tb)) == float(want)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen3-moe-30b-a3b",
                                  "mamba2-370m"])
def test_remat_policies_give_bitwise_equal_gradients(arch):
    base = get_config(arch).scaled_down()
    mod = mamba2 if base.family == "ssm" else transformer
    toks = torch.tensor(np.random.default_rng(2).integers(
        0, base.vocab_size, (2, 32)))
    batch = {"tokens": toks, "labels": toks}
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        params = mod.init_params(cfg, seed=0, device="cpu")
        out[remat] = _torch_grads(lambda p: mod.loss_fn(cfg, p, batch),
                                  params)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(out[remat][1],
                                                     out["none"][1]))


def test_unknown_remat_policy_is_refused():
    cfg = get_config("qwen3-0.6b").scaled_down(remat="some")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        transformer.forward(cfg, params, torch.zeros((1, 4),
                                                     dtype=torch.long))


def test_full_remat_recomputes_the_attention_in_the_backward():
    """Under ``remat="full"`` the backward runs each layer's forward again
    (the attention wrapper is called twice a layer), under ``"none"``
    once."""
    calls = []
    real = ops._flash

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    toks = torch.zeros((1, 16), dtype=torch.long)
    n = {}
    for remat in ("none", "full"):
        cfg = get_config("qwen3-0.6b").scaled_down(
            remat=remat, use_pallas_attention=True)
        params = transformer.init_params(cfg, seed=0, device="cpu")
        calls.clear()
        ops._flash = counting
        try:
            _torch_grads(lambda p: transformer.loss_fn(
                cfg, p, {"tokens": toks, "labels": toks}), params)
        finally:
            ops._flash = real
        n[remat] = len(calls)
    assert n == {"none": cfg.num_layers, "full": 2 * cfg.num_layers}


def test_mamba2_loss_through_the_ssd_cell_has_a_gradient_in_every_leaf():
    """The SSD cell's inputs reach every mamba2 leaf; on live weights each
    leaf's gradient is finite and not all zero."""
    _, cfg, _, tparams, batch = _family_case("ssm")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    _, grads = _torch_grads(lambda p: mamba2.loss_fn(cfg, p, tb), tparams)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)


def test_remat_checkpoints_only_what_autograd_records(monkeypatch):
    """Under ``remat="full"`` a forward that autograd does not record (no
    parameter requiring a gradient, or grad mode off) runs the layers as
    they are; a loss whose parameters require one checkpoints every
    layer."""
    calls = []
    real = transformer.ckpt.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(transformer.ckpt, "checkpoint", counting)
    cfg = get_config("qwen3-0.6b").scaled_down(remat="full")
    params = transformer.init_params(cfg, seed=0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    transformer.forward(cfg, params, toks)
    assert calls == []
    params["layers"]["ln1"].requires_grad_(True)
    with torch.no_grad():
        transformer.forward(cfg, params, toks)
    assert calls == []
    transformer.loss_fn(cfg, params, {"tokens": toks, "labels": toks})
    # the layers and the streamed loss's one chunk
    assert len(calls) == cfg.num_layers + 1
