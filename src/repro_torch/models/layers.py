"""Common neural layers in PyTorch: norms, RoPE, attention (blockwise
flash-style, or the CUDA flash kernel), SwiGLU MLP -- the counterpart of
the JAX package's ``repro.models.layers`` for the full-sequence forward.

Every function here operates on a *single* layer's params; the model loops
over the layers.  The bf16 rounding points are the JAX package's: norms
and RoPE compute in f32 and cast back, attention scores and accumulators
are f32, and p is rounded to v's dtype before the p v product.

The JAX package's ``shardctx.constrain`` calls are dropped: with no
launcher rules installed (one device) they return their input unchanged.
``cached_decode_attention`` and ``attention_decode`` belong to the decode
slice (``ROADMAP.md``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention_plain
from ..kernels.ops import flash_attention
from .config import ModelConfig

F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dt(cfg_dtype: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    if cfg_dtype not in _DTYPES:
        raise ValueError(f"unsupported dtype {cfg_dtype!r}; expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[cfg_dtype]


# --------------------------------------------------------------------------
# Norms
# --------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    xf = x.to(F32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(F32)).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary position embeddings
# --------------------------------------------------------------------------

def rope_frequencies(hd: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32, device=device)
                            / hd))


def apply_rope(x, positions, theta: float):
    """x: (..., S, hd); positions: (..., S) integer.  Split-halves layout:
    the first half of hd rotates against the second."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)       # (hd/2,)
    angles = positions[..., None].to(F32) * freqs              # (..., S, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.to(F32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------

def blockwise_attention(q, k, v, *, causal: bool, q_chunk: int,
                        k_chunk: int):
    """Flash-style online-softmax attention with O(chunk^2) memory, in
    plain PyTorch on either device: the attention kernel's plain version
    (``kernels.flash_attention.flash_attention_plain``) with the chunks as
    its tiles.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d); query head h reads kv head
    h // g.  The causal mask is start-aligned (the JAX package's
    ``q_offset`` = 0; decode continuation waits for its slice).  The JAX
    package computes every (query chunk, key chunk) pair; the pairs wholly
    above the causal diagonal are skipped here, which changes no bit: their
    p are exp(-1e30 - m) = 0 and their correction exp(m - m) = 1."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    out = flash_attention_plain(
        q.reshape(b * hq, sq, d), k.reshape(b * hkv, sk, d),
        v.reshape(b * hkv, sk, d), causal=causal, group=hq // hkv,
        bq=q_chunk, bk=k_chunk)
    return out.reshape(b, hq, sq, d)


# --------------------------------------------------------------------------
# Attention block (one layer): params + apply for the full sequence
# --------------------------------------------------------------------------

def attn_param_shapes(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    shapes = {
        "wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
        "wo": (h * hd, d),
    }
    if cfg.qkv_bias:
        shapes |= {"bq": (h * hd,), "bk": (kv * hd,), "bv": (kv * hd,)}
    if cfg.qk_norm:
        shapes |= {"q_norm": (hd,), "k_norm": (hd,)}
    return shapes


def attn_qkv(cfg: ModelConfig, p: dict, x, positions):
    """Project and rotate; returns q (B,H,S,hd), k/v (B,KV,S,hd)."""
    b, s, _ = x.shape
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd).transpose(1, 2)
    k = k.reshape(b, s, kv, hd).transpose(1, 2)
    v = v.reshape(b, s, kv, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def attention_block(cfg: ModelConfig, p: dict, x, positions, *,
                    causal: bool = True):
    """One layer's attention over the full sequence.  With
    ``cfg.use_pallas_attention`` it runs ``kernels.flash_attention`` --
    the CUDA kernel for CUDA tensors, its plain version for CPU tensors
    (there is no silent fallback to the blockwise path on the card);
    otherwise :func:`blockwise_attention`."""
    q, k, v = attn_qkv(cfg, p, x, positions)
    if cfg.use_pallas_attention:
        out = flash_attention(q, k, v, causal=causal,
                              bq=min(cfg.q_chunk, 128),
                              bk=min(cfg.k_chunk, 128))
    else:
        out = blockwise_attention(q, k, v, causal=causal,
                                  q_chunk=min(cfg.q_chunk, x.shape[1]),
                                  k_chunk=min(cfg.k_chunk, x.shape[1]))
    b, s, _ = x.shape
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p["wo"]


# --------------------------------------------------------------------------
# MLP (SwiGLU)
# --------------------------------------------------------------------------

def mlp_param_shapes(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": (d, f), "w_up": (d, f), "w_down": (f, d)}


def mlp_block(p: dict, x):
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# --------------------------------------------------------------------------
# Param init helpers
# --------------------------------------------------------------------------

def init_from_shapes(generator: torch.Generator, shapes: dict, dtype,
                     scale: float = 0.02, stacked: int = 0, device=None):
    """Initialize a {name: shape} dict; vectors -> ones/zeros, matrices ->
    truncated normal (at +-2 std), drawn from ``generator`` in sorted-name
    order.  ``stacked`` prepends a layer dimension.  The draws differ from
    ``jax.random``'s; weights are carried across with
    ``repro_torch.convert`` where the two packages must agree."""
    leaves = {}
    for name in sorted(shapes):
        shape = shapes[name]
        full = (stacked, *shape) if stacked else shape
        base = name.split(".")[-1]
        if "norm" in base or base.startswith("ln") or base == "scale":
            leaves[name] = torch.ones(full, dtype=dtype, device=device)
        elif len(shape) == 1:
            leaves[name] = torch.zeros(full, dtype=dtype, device=device)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[0]
            std = scale if scale else 1.0 / math.sqrt(fan_in)
            w = torch.empty(full, dtype=F32, device=device)
            torch.nn.init.trunc_normal_(w, a=-2.0, b=2.0,
                                        generator=generator)
            leaves[name] = (w * std).to(dtype)
    return leaves
