"""Whisper-style encoder-decoder backbone in PyTorch: the counterpart of
the JAX package's ``repro.models.whisper``.

The conv audio frontend is a stub, as in the JAX package: the inputs are
precomputed frame embeddings (B, S_enc, D).  The bidirectional encoder runs
``layers.attention_block(causal=False)`` and the decoder's self-attention
``attention_block(causal=True)`` (the flash kernel on the card with
``cfg.use_pallas_attention``); the decoder's cross-attention runs
``layers.blockwise_attention(causal=False)`` against K/V projected from the
encoder output, the plain version on either device, as the JAX package
runs it.  RoPE stands in for Whisper's absolute positions.  The parameter
tree is the JAX package's (``embed``, ``encoder``, ``decoder`` with a
leading layer dimension on every leaf, ``enc_norm``, ``final_norm``,
``lm_head``); its ``lax.scan``s become Python loops, each layer under
``cfg.remat``'s checkpointing.  ``decode_step`` writes the self-attention
K/V into the cache in place and returns it.
"""

from __future__ import annotations

import functools
import math

import torch

from . import shardctx
from .config import ModelConfig
from .layers import (F32, attn_param_shapes, attention_block,
                     attention_decode, blockwise_attention, dt,
                     init_from_shapes, mlp_block, mlp_param_shapes, rms_norm)
from .transformer import _layer, _nest, _remat, lm_loss, mask_pad_logits


def enc_layer_shapes(cfg: ModelConfig) -> dict:
    shapes = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    shapes |= {f"attn.{k}": v for k, v in attn_param_shapes(cfg).items()}
    shapes |= {f"mlp.{k}": v for k, v in mlp_param_shapes(cfg).items()}
    return shapes


def dec_layer_shapes(cfg: ModelConfig) -> dict:
    shapes = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,),
              "ln3": (cfg.d_model,)}
    shapes |= {f"attn.{k}": v for k, v in attn_param_shapes(cfg).items()}
    shapes |= {f"xattn.{k}": v for k, v in attn_param_shapes(cfg).items()}
    shapes |= {f"mlp.{k}": v for k, v in mlp_param_shapes(cfg).items()}
    return shapes


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, by its dotted name (``encoder.attn.wq``
    with the leading encoder-layer dimension, ``decoder.xattn.wq`` with
    the decoder's); the head is never tied."""
    shapes = {f"encoder.{k}": (cfg.encoder_layers, *v)
              for k, v in enc_layer_shapes(cfg).items()}
    shapes |= {f"decoder.{k}": (cfg.num_layers, *v)
               for k, v in dec_layer_shapes(cfg).items()}
    shapes["embed"] = (cfg.vocab_padded, cfg.d_model)
    shapes["enc_norm"] = (cfg.d_model,)
    shapes["final_norm"] = (cfg.d_model,)
    shapes["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` on ``device`` in
    ``cfg.param_dtype``, by the JAX package's recipe (the draws differ from
    ``jax.random``'s): embedding and head normal at std 0.02, matrices
    truncated normal at std 0.02, norms ones, biases zeros."""
    from ..device import resolve_device

    dev = resolve_device(device)
    kd = dt(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(shape):
        w = torch.empty(shape, dtype=F32, device=dev)
        w.normal_(generator=gen)
        return (w * 0.02).to(kd)

    return {
        "embed": normal((cfg.vocab_padded, cfg.d_model)),
        "encoder": _nest(init_from_shapes(gen, enc_layer_shapes(cfg), kd,
                                          stacked=cfg.encoder_layers,
                                          device=dev)),
        "decoder": _nest(init_from_shapes(gen, dec_layer_shapes(cfg), kd,
                                          stacked=cfg.num_layers,
                                          device=dev)),
        "enc_norm": torch.ones((cfg.d_model,), dtype=kd, device=dev),
        "final_norm": torch.ones((cfg.d_model,), dtype=kd, device=dev),
        "lm_head": normal((cfg.d_model, cfg.vocab_padded)),
    }


def _cross_attention(cfg: ModelConfig, p: dict, x, enc_kv):
    """Queries from the decoder, K/V precomputed from the encoder output:
    the plain blockwise attention, non-causal."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.hd
    q = x @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k, v = enc_kv
    out = blockwise_attention(q, k, v, causal=False,
                              q_chunk=min(cfg.q_chunk, s),
                              k_chunk=min(cfg.k_chunk, k.shape[2]))
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p["wo"]


def _enc_kv(cfg: ModelConfig, p: dict, enc_out):
    b, s, _ = enc_out.shape
    kv, hd = cfg.num_kv_heads, cfg.hd
    k = enc_out @ p["wk"]
    v = enc_out @ p["wv"]
    if cfg.qkv_bias:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, s, kv, hd).transpose(1, 2)
    v = v.reshape(b, s, kv, hd).transpose(1, 2)
    return k, v


def _enc_layer(cfg: ModelConfig, pl: dict, x, positions):
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + attention_block(cfg, pl["attn"], h, positions, causal=False)
    h = rms_norm(x, pl["ln2"], cfg.norm_eps)
    return shardctx.constrain(x + mlp_block(pl["mlp"], h), "residual")


def _dec_layer(cfg: ModelConfig, pl: dict, x, positions, enc_out):
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + attention_block(cfg, pl["attn"], h, positions, causal=True)
    h = rms_norm(x, pl["ln2"], cfg.norm_eps)
    x = x + _cross_attention(cfg, pl["xattn"], h,
                             _enc_kv(cfg, pl["xattn"], enc_out))
    h = rms_norm(x, pl["ln3"], cfg.norm_eps)
    return shardctx.constrain(x + mlp_block(pl["mlp"], h), "residual")


def _positions(x):
    b, s, _ = x.shape
    return torch.arange(s, device=x.device).expand(b, s)


def encode(cfg: ModelConfig, params: dict, frames):
    """frames: (B, S_enc, D) stub frontend embeddings -> the normed
    encoder output (B, S_enc, D) in the compute dtype."""
    x = frames.to(dt(cfg.compute_dtype))
    positions = _positions(x)
    body = _remat(cfg, functools.partial(_enc_layer, cfg))
    for i in range(cfg.encoder_layers):
        x = body(_layer(params["encoder"], i), x, positions)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def dec_hidden(cfg: ModelConfig, params: dict, tokens, enc_out):
    """tokens: (B, S) integer; enc_out: (B, S_enc, D) -> the decoder's
    final-normed hidden states (B, S, D)."""
    x = params["embed"].to(dt(cfg.compute_dtype))[tokens]
    positions = _positions(x)
    body = _remat(cfg, functools.partial(_dec_layer, cfg))
    for i in range(cfg.num_layers):
        x = body(_layer(params["decoder"], i), x, positions, enc_out)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _logits(cfg: ModelConfig, params: dict, x):
    """f32 logits from hidden states in the compute dtype: the head's
    operands widened to f32 (the JAX package's
    ``preferred_element_type=float32``)."""
    logits = torch.matmul(x.to(F32), params["lm_head"].to(x.dtype).to(F32))
    return shardctx.constrain(mask_pad_logits(cfg, logits), "logits")


def decode_stack(cfg: ModelConfig, params: dict, tokens, enc_out):
    """f32 logits (B, S, vocab_padded) of the decoder over ``tokens``."""
    return _logits(cfg, params, dec_hidden(cfg, params, tokens, enc_out))


def forward(cfg: ModelConfig, params: dict, batch: dict):
    """batch: ``frames`` (B, S_enc, D) and ``tokens`` (B, S) integer ->
    f32 logits (B, S, vocab_padded)."""
    enc_out = encode(cfg, params, batch["frames"])
    return decode_stack(cfg, params, batch["tokens"], enc_out)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """The next-token loss of ``batch`` (``frames``, ``tokens``,
    ``labels``), through the streamed head and loss."""
    enc_out = encode(cfg, params, batch["frames"])
    x = dec_hidden(cfg, params, batch["tokens"], enc_out)
    return lm_loss(cfg, params, x, batch["labels"])


# --------------------------------------------------------------------------
# Serving: self-attention KV cache + precomputed cross K/V
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zero caches on ``device`` in the compute dtype: the self-attention
    K and V (L, B, KV, max_len, hd) and the cross-attention K and V (L, B,
    KV, encoder_seq, hd), which :func:`prefill_cross` fills."""
    from ..device import resolve_device

    dev = resolve_device(device)
    kd = dt(cfg.compute_dtype)
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd

    def zeros(s):
        return torch.zeros((L, batch, kv, s, hd), dtype=kd, device=dev)

    return {"k": zeros(max_len), "v": zeros(max_len),
            "xk": zeros(cfg.encoder_seq), "xv": zeros(cfg.encoder_seq)}


def prefill_cross(cfg: ModelConfig, params: dict, cache: dict, frames):
    """Encode ``frames`` and set every decoder layer's cross K/V (once a
    request).  The JAX package returns a new dict; here ``cache["xk"]``
    and ``cache["xv"]`` are replaced in the same dict, which is
    returned."""
    enc_out = encode(cfg, params, frames)
    kv = [_enc_kv(cfg, _layer(params["decoder"], i)["xattn"], enc_out)
          for i in range(cfg.num_layers)]
    cache["xk"] = torch.stack([k for k, _ in kv])
    cache["xv"] = torch.stack([v for _, v in kv])
    return cache


def _cross_decode(cfg: ModelConfig, p: dict, h, xk, xv):
    """One token's cross-attention against the fixed encoder K/V, at the
    JAX package's rounding points: f32 scores (products of the compute
    dtype summed in f32) scaled after the product, an f32 softmax, p
    rounded to the cache's dtype before the p v product."""
    b = h.shape[0]
    hq, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = h @ p["wq"]
    if cfg.qkv_bias:
        q = q + p["bq"]
    qg = q.reshape(b, kv, hq // kv, hd)
    s = torch.matmul(qg.to(F32), xk.to(F32).transpose(-1, -2)) \
        * (1.0 / math.sqrt(hd))                     # (B, KV, G, S_enc)
    pr = torch.softmax(s, dim=-1)
    o = torch.matmul(pr.to(xv.dtype).to(F32), xv.to(F32)).to(xv.dtype)
    o = o.reshape(b, 1, hq * hd)
    return (o @ p["wo"]).to(h.dtype)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, token,
                pos: int):
    """token: (B,) integer; ``pos``: the new token's position.  Returns
    (logits (B, V) f32, cache).  Unlike the JAX package, which returns a
    new cache, each layer's new self-attention K/V row is written into
    ``cache`` in place and the same dict is returned; the cross K/V are
    read as :func:`prefill_cross` (or :func:`init_cache`) left them."""
    x = params["embed"].to(dt(cfg.compute_dtype))[token][:, None, :]
    for i in range(cfg.num_layers):
        pl = _layer(params["decoder"], i)
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        a, _, _ = attention_decode(cfg, pl["attn"], h, cache["k"][i],
                                   cache["v"][i], pos)
        x = x + a
        h = rms_norm(x, pl["ln2"], cfg.norm_eps)
        x = x + _cross_decode(cfg, pl["xattn"], h, cache["xk"][i],
                              cache["xv"][i])
        h = rms_norm(x, pl["ln3"], cfg.norm_eps)
        x = x + mlp_block(pl["mlp"], h)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(cfg, params, x)[:, 0, :], cache
