"""Common neural layers in PyTorch: norms, RoPE, attention (blockwise
flash-style, or the CUDA flash kernel, and cached single-token decode),
SwiGLU MLP -- the counterpart of the JAX package's ``repro.models.layers``.

Every function here operates on a *single* layer's params; the model loops
over the layers.  The bf16 rounding points are the JAX package's: norms
and RoPE compute in f32 and cast back, attention scores and accumulators
are f32, and p is rounded to v's dtype before the p v product.

The JAX package's ``shardctx.constrain`` points are kept (q, k and v here;
the residual and the logits in the families): the layout belongs to the
launcher, so they return their input (``models.shardctx``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import flash_attention_plain
from ..kernels.ops import flash_attention
from . import shardctx
from .config import ModelConfig

F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}


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
                        k_chunk: int, q_offset: int = 0):
    """Flash-style online-softmax attention with O(chunk^2) memory, in
    plain PyTorch on either device: the attention kernel's plain version
    (``kernels.flash_attention.flash_attention_plain``) with the chunks as
    its tiles.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d); query head h reads kv head
    h // g.  ``q_offset`` is the absolute position of q[0] (for decode or
    prefill continuation): query i sees keys j <= q_offset + i.  The JAX
    package computes every (query chunk, key chunk) pair; the pairs wholly
    above the causal diagonal are skipped here, which changes no bit: their
    p are exp(-1e30 - m) = 0 and their correction exp(m - m) = 1."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    out = flash_attention_plain(
        q.reshape(b * hq, sq, d), k.reshape(b * hkv, sk, d),
        v.reshape(b * hkv, sk, d), causal=causal, group=hq // hkv,
        bq=q_chunk, bk=k_chunk, q_offset=q_offset)
    return out.reshape(b, hq, sq, d)


def cached_decode_attention(q, k_cache, v_cache, cache_len: int):
    """Single-token attention against a fixed-size KV cache.

    q: (B, Hq, 1, d); caches: (B, Hkv, Smax, d); ``cache_len``: the number
    of valid cache entries (the new token's K/V already inserted).  Plain
    PyTorch, as XLA computes it in the JAX package: the caches are cast to
    q's dtype (an fp8 cache dequantizes here), the scores are products of
    q's dtype summed in f32 (both operands widened, so a bf16 model's
    scores are not rounded to bf16) and divided by sqrt(d), the entries at
    ``cache_len`` and beyond are set to -1e30, and p is rounded to the
    cache's (cast) dtype before the p v product in f32."""
    b, hq, _, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d).to(F32)
    kc = k_cache.to(q.dtype)
    s = torch.matmul(qg, kc.to(F32).transpose(-1, -2)) / math.sqrt(d)
    mask = torch.arange(smax, device=q.device) < cache_len
    s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    vc = v_cache.to(q.dtype)
    out = torch.matmul(p.to(vc.dtype).to(F32), vc.to(F32))  # (B,Hkv,g,d)
    return out.reshape(b, hq, 1, d).to(q.dtype)


# --------------------------------------------------------------------------
# Attention block (one layer): params + apply for full-seq and decode
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
    # Megatron-SP hand-off: residuals are sequence-sharded between blocks;
    # attention runs head-sharded with the full sequence.
    q = shardctx.constrain(q, "heads")
    k = shardctx.constrain(k, "heads_kv")
    v = shardctx.constrain(v, "heads_kv")
    return q, k, v


def attention_out(cfg: ModelConfig, p: dict, q, k, v, *,
                  causal: bool = True):
    """Attention of q (B,H,S,hd) over k, v (B,KV,S,hd) from position 0,
    then the output projection: (B, S, D).  With
    ``cfg.use_pallas_attention`` it runs ``kernels.flash_attention`` --
    the CUDA kernel for CUDA tensors, its plain version for CPU tensors
    (there is no silent fallback to the blockwise path on the card);
    otherwise :func:`blockwise_attention`.  The full-sequence forward and
    ``transformer.prefill`` both take this choice."""
    b, _, s, _ = q.shape
    if cfg.use_pallas_attention:
        out = flash_attention(q, k, v, causal=causal,
                              bq=min(cfg.q_chunk, 128),
                              bk=min(cfg.k_chunk, 128))
    else:
        out = blockwise_attention(q, k, v, causal=causal,
                                  q_chunk=min(cfg.q_chunk, s),
                                  k_chunk=min(cfg.k_chunk, s))
    out = out.transpose(1, 2).reshape(b, s, -1)
    return out @ p["wo"]


def attention_block(cfg: ModelConfig, p: dict, x, positions, *,
                    causal: bool = True):
    """One layer's attention over the full sequence
    (:func:`attention_out` of :func:`attn_qkv`)."""
    q, k, v = attn_qkv(cfg, p, x, positions)
    return attention_out(cfg, p, q, k, v, causal=causal)


def attention_decode(cfg: ModelConfig, p: dict, x, cache_k, cache_v,
                     pos: int):
    """x: (B, 1, D); caches (B, KV, Smax, hd); ``pos``: the index of the
    new token.  Returns (out, cache_k, cache_v).

    The new K/V rows are written into the caches **in place** (a slice
    assignment) and the same tensors are returned: the JAX package's
    ``dynamic_update_slice`` returns new caches and leaves the old ones as
    they were, which here would copy the whole cache every token.  Where
    ``dynamic_update_slice`` clamps a ``pos`` >= Smax and silently
    overwrites the last slot, this raises ``ValueError``."""
    pos = int(pos)
    smax = cache_k.shape[2]
    if not 0 <= pos < smax:
        raise ValueError(f"decode position {pos} is outside the KV cache's "
                         f"{smax} slots")
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    q, k, v = attn_qkv(cfg, p, x, positions)
    cache_k[:, :, pos] = k[:, :, 0].to(cache_k.dtype)
    cache_v[:, :, pos] = v[:, :, 0].to(cache_v.dtype)
    out = cached_decode_attention(q, cache_k, cache_v, pos + 1)
    out = out.transpose(1, 2).reshape(b, 1, -1)
    return out @ p["wo"], cache_k, cache_v


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
