"""Decoder-only transformer LM (dense GQA): the full-sequence forward, the
counterpart of the JAX package's ``repro.models.transformer``.

Covers the dense configs (llama3, qwen1.5, qwen2.5, qwen3).  Parameters
are a dict tree named as the JAX package's (``embed``, ``final_norm``,
``lm_head``, ``layers`` with ``ln1``, ``ln2``, ``attn.wq`` ...,
``mlp.w_gate`` ...), every layer leaf carrying a leading L dimension, so a
JAX tree carries across leaf for leaf (``repro_torch.convert``).  The
stack is a Python loop over the layers in place of ``lax.scan``; ``remat``
has no meaning without a backward pass.  The MoE block, ``prefill``,
``decode_step``, ``init_cache`` and the losses belong to later slices
(``ROADMAP.md``).
"""

from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import (F32, attn_param_shapes, attention_block, dt,
                     init_from_shapes, mlp_block, mlp_param_shapes, rms_norm)

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
