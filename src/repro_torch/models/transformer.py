"""Decoder-only transformer LM (dense GQA): the full-sequence forward and
KV-cache serving (``prefill``, ``init_cache``, ``decode_step``), the
counterpart of the JAX package's ``repro.models.transformer``.

Covers the dense configs (llama3, qwen1.5, qwen2.5, qwen3).  Parameters
are a dict tree named as the JAX package's (``embed``, ``final_norm``,
``lm_head``, ``layers`` with ``ln1``, ``ln2``, ``attn.wq`` ...,
``mlp.w_gate`` ...), every layer leaf carrying a leading L dimension, so a
JAX tree carries across leaf for leaf (``repro_torch.convert``).  The
stack is a Python loop over the layers in place of ``lax.scan``; ``remat``
has no meaning without a backward pass.  ``decode_step`` writes the cache
in place (see :func:`decode_step`).  The MoE block and the losses belong
to later slices (``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import (F32, attn_param_shapes, attn_qkv, attention_block,
                     attention_decode, attention_out, dt, init_from_shapes,
                     mlp_block, mlp_param_shapes, rms_norm)

#: Where the MoE block waits in ``ROADMAP.md``.
MOE_ITEM = "ROADMAP.md Queue 1 item 15 (the MoE block)"


def _refuse_moe(cfg: ModelConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError(
            f"{cfg.name}: the MoE block is not ported yet: {MOE_ITEM}")


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def layer_param_shapes(cfg: ModelConfig) -> dict:
    _refuse_moe(cfg)
    shapes = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    shapes |= {f"attn.{k}": v for k, v in attn_param_shapes(cfg).items()}
    shapes |= {f"mlp.{k}": v for k, v in mlp_param_shapes(cfg).items()}
    return shapes


def _nest(flat: dict) -> dict:
    out: dict = {}
    for k, v in flat.items():
        parts = k.split(".")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, by its dotted name (``layers.attn.wq`` with
    the leading L dimension)."""
    shapes = {f"layers.{k}": (cfg.num_layers, *v)
              for k, v in layer_param_shapes(cfg).items()}
    shapes["embed"] = (cfg.vocab_padded, cfg.d_model)
    shapes["final_norm"] = (cfg.d_model,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` on ``device``, in
    ``cfg.param_dtype``: embedding and head normal at std 0.02, matrices
    truncated normal at std 0.02, norms ones, biases zeros (the JAX
    package's recipe; the draws differ from ``jax.random``'s)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    kd = dt(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = init_from_shapes(gen, layer_param_shapes(cfg), kd,
                            stacked=cfg.num_layers, device=dev)

    def normal(shape):
        w = torch.empty(shape, dtype=F32, device=dev)
        w.normal_(generator=gen)
        return (w * 0.02).to(kd)

    params = {
        "embed": normal((cfg.vocab_padded, cfg.d_model)),
        "layers": _nest(flat),
        "final_norm": torch.ones((cfg.d_model,), dtype=kd, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((cfg.d_model, cfg.vocab_padded))
    return params


def mask_pad_logits(cfg: ModelConfig, logits):
    """Push padded vocab columns to -1e30."""
    if cfg.vocab_padded == cfg.vocab_size:
        return logits
    idx = torch.arange(logits.shape[-1], device=logits.device)
    return torch.where(idx < cfg.vocab_size, logits, -1e30)


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def layer_fn(cfg: ModelConfig, pl: dict, x, positions):
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + attention_block(cfg, pl["attn"], h, positions)
    h = rms_norm(x, pl["ln2"], cfg.norm_eps)
    return x + mlp_block(pl["mlp"], h)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def stack_forward(cfg: ModelConfig, layers: dict, x, positions):
    _refuse_moe(cfg)
    for i in range(cfg.num_layers):
        x = layer_fn(cfg, _layer(layers, i), x, positions)
    return x


def hidden_states(cfg: ModelConfig, params: dict, tokens):
    """tokens: (B, S) integer -> final-normed hidden states (B, S, D).
    (The JAX package's ``extra_embeds``, internvl's patch embeddings,
    waits for the vlm family.)"""
    x = params["embed"].to(dt(cfg.compute_dtype))[tokens]
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    x = stack_forward(cfg, params["layers"], x, positions)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_fn(cfg: ModelConfig, params: dict, x):
    """f32 logits (B, S, V) from hidden states in the compute dtype: the
    operands are widened to f32 so a bf16 model's logits are not rounded to
    bf16 (the JAX package's ``preferred_element_type=float32``); the
    products of bf16 values are exact in f32."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.matmul(x.to(F32), head.to(x.dtype).to(F32))
    return mask_pad_logits(cfg, logits)


def forward(cfg: ModelConfig, params: dict, tokens):
    """tokens: (B, S) integer -> f32 logits (B, S, vocab_padded)."""
    return logits_fn(cfg, params, hidden_states(cfg, params, tokens))


# --------------------------------------------------------------------------
# KV-cache serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zero K and V caches (L, B, KV, max_len, hd) on ``device``, in
    ``cfg.kv_dtype`` (float8_e4m3fn halves them) or the compute dtype."""
    from ..device import resolve_device

    _refuse_moe(cfg)
    kd = dt(cfg.kv_dtype or cfg.compute_dtype)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=kd, device=dev),
            "v": torch.zeros(shape, dtype=kd, device=dev)}


def decode_step(cfg: ModelConfig, params: dict, cache: dict, token,
                pos: int):
    """token: (B,) integer; ``pos``: the position of the new token.  One
    new token against the cache; returns (logits (B, V) f32, cache).

    Unlike the JAX package, which returns a new cache and leaves the old
    one as it was, the new K/V rows are written into ``cache`` in place and
    the same dict is returned (a functional copy would move the whole
    cache every token); a ``pos`` past the cache raises ``ValueError``
    where ``dynamic_update_slice`` would clamp it onto the last slot
    (``layers.attention_decode``)."""
    _refuse_moe(cfg)
    x = params["embed"].to(dt(cfg.compute_dtype))[token][:, None, :]
    layers = params["layers"]
    for i in range(cfg.num_layers):
        pl = _layer(layers, i)
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        a, _, _ = attention_decode(cfg, pl["attn"], h, cache["k"][i],
                                   cache["v"][i], pos)
        x = x + a
        h = rms_norm(x, pl["ln2"], cfg.norm_eps)
        x = x + mlp_block(pl["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x)[:, 0, :], cache


def prefill(cfg: ModelConfig, params: dict, tokens, max_len: int):
    """Run the prompt, returning (last-position logits (B, V) f32, filled
    cache).  tokens: (B, S) integer, S <= ``max_len``.

    Attention takes the forward's choice (``layers.attention_out``): with
    ``cfg.use_pallas_attention`` the flash kernel on CUDA tensors, once a
    layer; the JAX package always calls ``blockwise_attention``, which is
    the same causal function from position 0.  The cache holds each
    layer's K/V in the compute dtype (the JAX package pads them, whatever
    ``kv_dtype`` says), zero past S."""
    _refuse_moe(cfg)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"a prompt of {s} tokens does not fit a cache of "
                         f"{max_len} slots")
    x = params["embed"].to(dt(cfg.compute_dtype))[tokens]
    positions = torch.arange(s, device=x.device).expand(b, s)
    shape = (cfg.num_layers, b, cfg.num_kv_heads, max_len, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
             "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
    layers = params["layers"]
    for i in range(cfg.num_layers):
        pl = _layer(layers, i)
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        q, k, v = attn_qkv(cfg, pl["attn"], h, positions)
        x = x + attention_out(cfg, pl["attn"], q, k, v)
        h = rms_norm(x, pl["ln2"], cfg.norm_eps)
        x = x + mlp_block(pl["mlp"], h)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x[:, -1:, :])[:, 0, :], cache
