"""Zamba2-style hybrid in PyTorch: a Mamba2 backbone with a *shared*
attention + MLP block applied after every ``attn_every`` mamba blocks --
the counterpart of the JAX package's ``repro.models.zamba2``.

The shared block's weights are reused at every application; each
application keeps its own KV cache.  As in the JAX package, Zamba2's
per-invocation LoRA deltas and embedding-concat input are omitted.

Layer layout for L layers and attn_every = a: ``n_super = L // a``
super-blocks of (a mamba blocks + 1 shared-block application), then
``L % a`` trailing mamba blocks.  The parameter tree is the JAX package's:
``mamba_main`` leaves of shape (n_super, a, ...), ``mamba_tail`` leaves of
shape (trailing, ...), one ``shared`` block, ``embed``, ``final_norm`` and
``lm_head``.  The JAX package's ``lax.scan``s become Python loops over
layer slices, each layer under ``cfg.remat``'s checkpointing.  The mamba
blocks run ``mamba2.layer_fn`` (the SSD cell on ``kernels.ssd_intra``),
the shared block ``layers.attention_block`` (the flash kernel on the card
with ``cfg.use_pallas_attention``).  ``decode_step`` advances the cache in
place and returns it.
"""

from __future__ import annotations

import functools

import torch

from . import mamba2, shardctx
from .config import ModelConfig
from .layers import (F32, attn_param_shapes, attention_block,
                     attention_decode, dt, init_from_shapes, mlp_block,
                     mlp_param_shapes, rms_norm)
from .transformer import _layer, _nest, _remat, lm_loss, mask_pad_logits


def _splits(cfg: ModelConfig):
    a = cfg.attn_every
    n_super = cfg.num_layers // a
    trailing = cfg.num_layers - n_super * a
    return a, n_super, trailing


def shared_param_shapes(cfg: ModelConfig) -> dict:
    shapes = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    shapes |= {f"attn.{k}": v for k, v in attn_param_shapes(cfg).items()}
    shapes |= {f"mlp.{k}": v for k, v in mlp_param_shapes(cfg).items()}
    return shapes


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, by its dotted name: ``mamba_main.in_proj``
    (n_super, a, ...), ``mamba_tail.in_proj`` (trailing, ...),
    ``shared.attn.wq`` ...; the head is never tied."""
    a, n_super, trailing = _splits(cfg)
    layer = mamba2.layer_param_shapes(cfg)
    shapes = {f"mamba_main.{k}": (n_super, a, *v) for k, v in layer.items()}
    shapes |= {f"mamba_tail.{k}": (trailing, *v) for k, v in layer.items()}
    shapes |= {f"shared.{k}": v for k, v in shared_param_shapes(cfg).items()}
    shapes["embed"] = (cfg.vocab_padded, cfg.d_model)
    shapes["final_norm"] = (cfg.d_model,)
    shapes["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` on ``device`` in
    ``cfg.param_dtype``, by the JAX package's recipe (the draws differ from
    ``jax.random``'s): the L mamba blocks as ``mamba2.init_params`` makes
    them, split into the super-blocks and the tail; the shared block's
    matrices truncated normal at std 0.02, its norms ones."""
    from ..device import resolve_device

    dev = resolve_device(device)
    kd = dt(cfg.param_dtype)
    a, n_super, _ = _splits(cfg)
    mamba = mamba2.init_params(cfg, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    main = n_super * a
    layers = mamba["layers"]
    return {
        "embed": mamba["embed"],
        "mamba_main": {k: v[:main].reshape(n_super, a, *v.shape[1:]).clone()
                       for k, v in layers.items()},
        "mamba_tail": {k: v[main:].clone() for k, v in layers.items()},
        "shared": _nest(init_from_shapes(gen, shared_param_shapes(cfg), kd,
                                         device=dev)),
        "final_norm": mamba["final_norm"],
        "lm_head": mamba["lm_head"],
    }


def _shared_block(cfg: ModelConfig, ps: dict, x, positions):
    h = rms_norm(x, ps["ln1"], cfg.norm_eps)
    x = x + attention_block(cfg, ps["attn"], h, positions)
    h = rms_norm(x, ps["ln2"], cfg.norm_eps)
    return shardctx.constrain(x + mlp_block(ps["mlp"], h), "residual")


def _main_layer(tree: dict, s: int, j: int) -> dict:
    """Mamba block ``j`` of super-block ``s`` (views, no copy)."""
    return _layer(_layer(tree, s), j)


def hidden_fn(cfg: ModelConfig, params: dict, tokens):
    """tokens: (B, S) integer, S a multiple of ``min(cfg.ssm_chunk, S)``
    -> final-normed hidden states (B, S, D)."""
    a, n_super, trailing = _splits(cfg)
    x = params["embed"].to(dt(cfg.compute_dtype))[tokens]
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    mamba_body = _remat(cfg, functools.partial(mamba2.layer_fn, cfg))
    shared_body = _remat(cfg, functools.partial(_shared_block, cfg))
    for si in range(n_super):
        for j in range(a):
            x = mamba_body(_main_layer(params["mamba_main"], si, j), x)
        x = shared_body(params["shared"], x, positions)
    for t in range(trailing):
        x = mamba_body(_layer(params["mamba_tail"], t), x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, params: dict, tokens):
    """tokens: (B, S) integer -> f32 logits (B, S, vocab_padded): the
    head's operands widened to f32 (the JAX package's
    ``preferred_element_type=float32``)."""
    x = hidden_fn(cfg, params, tokens)
    logits = torch.matmul(x.to(F32), params["lm_head"].to(x.dtype).to(F32))
    return shardctx.constrain(mask_pad_logits(cfg, logits), "logits")


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """The next-token loss of ``batch`` (``tokens``, ``labels``: (B, S)
    integer tensors), through the streamed head and loss."""
    x = hidden_fn(cfg, params, batch["tokens"])
    return lm_loss(cfg, params, x, batch["labels"])


# --------------------------------------------------------------------------
# Decode: the mamba blocks' recurrent state, one KV cache an application
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """The decode state on ``device``, zero: every mamba block's ssm state
    (L, B, H, N, P) in f32 and conv window (L, B, K-1, conv_dim), and one
    K and V cache (n_super, B, KV, max_len, hd) a shared-block
    application, in the compute dtype."""
    from ..device import resolve_device

    dev = resolve_device(device)
    kd = dt(cfg.compute_dtype)
    n_super = _splits(cfg)[1]
    cache = mamba2.init_cache(cfg, batch, device=dev)
    shape = (n_super, batch, cfg.num_kv_heads, max_len, cfg.hd)
    cache["k"] = torch.zeros(shape, dtype=kd, device=dev)
    cache["v"] = torch.zeros(shape, dtype=kd, device=dev)
    return cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, token,
                pos: int):
    """token: (B,) integer; ``pos``: the new token's position (the shared
    block's K/V slot).  Returns (logits (B, V) f32, cache).  Unlike the JAX
    package, which returns a new cache, each mamba block's ssm state and
    conv window and each application's K/V row are written into ``cache``
    in place and the same dict is returned.  The head is a product in the
    compute dtype, then widened to f32, as in the JAX package."""
    a, n_super, trailing = _splits(cfg)
    x = params["embed"].to(dt(cfg.compute_dtype))[token]        # (B, D)
    ps = params["shared"]

    def mamba_step(pl, i, x):
        h = rms_norm(x, pl["ln"], cfg.norm_eps)
        y, _, _ = mamba2.mamba_decode_mix(cfg, pl, h, cache["ssm"][i],
                                          cache["conv"][i])
        return x + y

    for si in range(n_super):
        for j in range(a):
            x = mamba_step(_main_layer(params["mamba_main"], si, j),
                           si * a + j, x)
        h = rms_norm(x, ps["ln1"], cfg.norm_eps)[:, None, :]
        y, _, _ = attention_decode(cfg, ps["attn"], h, cache["k"][si],
                                   cache["v"][si], pos)
        x = x + y[:, 0, :]
        h = rms_norm(x, ps["ln2"], cfg.norm_eps)
        x = x + mlp_block(ps["mlp"], h)
    for t in range(trailing):
        x = mamba_step(_layer(params["mamba_tail"], t), n_super * a + t, x)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(x.dtype)).to(F32)
    return mask_pad_logits(cfg, logits), cache
