"""Mamba2 (state-space duality / SSD) language model in PyTorch: the
counterpart of the JAX package's ``repro.models.mamba2``.

The forward uses the chunked SSD algorithm: each chunk's intra-chunk cell
and chunk state come from ``kernels.ssd_intra`` (the CUDA kernel for CUDA
tensors, its plain version ``ssd_intra_ref`` for CPU tensors), and the
inter-chunk recurrence is a loop over the chunks.  Decode uses the O(1)
recurrent update, writing the ssm state and the conv window into the cache
in place.  The bf16 rounding points are the JAX package's, line by line:
the conv's K shifted products and their sum in the compute dtype, the SSD
output rounded to x's dtype before the Dskip add, the gate's ``silu(z)``
in f32 cast back, and decode's logits a product in the compute dtype
widened after.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..kernels.ssd_intra import ssd_intra
from . import shardctx
from .config import ModelConfig
from .layers import F32, dt, init_from_shapes, rms_norm
from .transformer import _layer, _nest, _remat, lm_loss, mask_pad_logits


def _dims(cfg: ModelConfig):
    d_in = cfg.d_inner
    h = cfg.ssm_heads
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n          # x, B, C all pass the causal conv
    return d_in, h, n, conv_dim


def layer_param_shapes(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    d_in, h, n, conv_dim = _dims(cfg)
    return {
        "ln": (d,),
        "in_proj": (d, 2 * d_in + 2 * n + h),
        "conv_w": (cfg.conv_kernel, conv_dim),
        "conv_b": (conv_dim,),
        "A_log": (h,),
        "Dskip": (h,),
        "dt_bias": (h,),
        "gnorm": (d_in,),
        "out_proj": (d_in, d),
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, by its dotted name (``layers.in_proj``
    with the leading L dimension); the head is never tied."""
    shapes = {f"layers.{k}": (cfg.num_layers, *v)
              for k, v in layer_param_shapes(cfg).items()}
    shapes["embed"] = (cfg.vocab_padded, cfg.d_model)
    shapes["final_norm"] = (cfg.d_model,)
    shapes["lm_head"] = (cfg.d_model, cfg.vocab_padded)
    return shapes


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` on ``device`` in
    ``cfg.param_dtype``, by the JAX package's recipe (the draws differ from
    ``jax.random``'s): matrices truncated normal at std 0.02, norms ones,
    and the SSD-specific values -- A = 1 to 16 over the heads (``A_log``
    its log), ``Dskip`` ones, ``dt_bias`` -4 (softplus(dt) about 1e-3 to
    0.1)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    kd = dt(cfg.param_dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = init_from_shapes(gen, layer_param_shapes(cfg), kd,
                            stacked=cfg.num_layers, device=dev)
    L, h = cfg.num_layers, cfg.ssm_heads
    flat["A_log"] = torch.log(torch.linspace(
        1.0, 16.0, h, dtype=F32, device=dev))[None].repeat(L, 1).to(kd)
    flat["Dskip"] = torch.ones((L, h), dtype=kd, device=dev)
    flat["dt_bias"] = torch.full((L, h), -4.0, dtype=kd, device=dev)
    flat["gnorm"] = torch.ones((L, cfg.d_inner), dtype=kd, device=dev)

    def normal(shape):
        w = torch.empty(shape, dtype=F32, device=dev)
        w.normal_(generator=gen)
        return (w * 0.02).to(kd)

    return {
        "embed": normal((cfg.vocab_padded, cfg.d_model)),
        "layers": _nest(flat),
        "final_norm": torch.ones((cfg.d_model,), dtype=kd, device=dev),
        "lm_head": normal((cfg.d_model, cfg.vocab_padded)),
    }


# --------------------------------------------------------------------------
# Chunked SSD
# --------------------------------------------------------------------------

def _causal_conv(xbc, w, b):
    """Depthwise causal conv along time. xbc: (B,S,C); w: (K,C).  The K
    shifted products summed in the JAX package's order, in xbc's dtype."""
    k = w.shape[0]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + b)


def _split_proj(cfg: ModelConfig, zxbcdt):
    d_in, h, n, _ = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * n]
    dtr = zxbcdt[..., 2 * d_in + 2 * n:]
    return z, xbc, dtr


def ssd_chunked(xh, bb, cc, dtv, a_neg, chunk: int):
    """Chunked SSD scan.

    xh: (B,S,H,P); bb/cc: (B,S,N); dtv: (B,S,H); a_neg: (H,) negative.
    Returns (y (B,S,H,P) in xh's dtype, final_state (B,H,N,P) f32).

    Each chunk's cell -- ``y_intra = (C B^T o exp(cs_i - cs_j) o causal)
    (x dt)`` and the chunk state ``B^T (exp(cs_Q - cs) o x dt)`` -- is one
    call of ``kernels.ssd_intra`` over every (batch*chunk, head) at once, on
    f32 operands in the kernel's layout: x dt (B*NC, H, Q, P), B and C
    (B*NC, Q, N), cs (B*NC, H, Q).  The inter-chunk recurrence and the
    inter-chunk output follow in PyTorch."""
    b, s, h, p = xh.shape
    n = bb.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by ssd chunk {q}")
    nc = s // q

    xc = xh.reshape(b, nc, q, h, p)
    bc = bb.reshape(b, nc, q, n).to(F32)
    ccc = cc.reshape(b, nc, q, n).to(F32)
    dtc = dtv.reshape(b, nc, q, h).to(F32)
    da = dtc * a_neg.to(F32)                       # (B,NC,Q,H) log-decays
    cs = torch.cumsum(da, dim=2)                   # inclusive cumsum
    xdt = xc.to(F32) * dtc[..., None]              # (B,NC,Q,H,P)

    # the intra-chunk cell and the chunk states: the kernel's layout
    y_cell, s_cell = ssd_intra(
        xdt.permute(0, 1, 3, 2, 4).reshape(b * nc, h, q, p).contiguous(),
        bc.reshape(b * nc, q, n).contiguous(),
        ccc.reshape(b * nc, q, n).contiguous(),
        cs.permute(0, 1, 3, 2).reshape(b * nc, h, q).contiguous())
    y_intra = y_cell.reshape(b, nc, h, q, p).permute(0, 1, 3, 2, 4)
    s_chunk = s_cell.reshape(b, nc, h, n, p)       # (B,NC,H,N,P)
    chunk_decay = torch.exp(cs[:, :, -1, :])       # (B,NC,H)

    r = torch.zeros((b, h, n, p), dtype=F32, device=xh.device)
    r_before = []                                  # the state BEFORE chunk
    for c in range(nc):
        r_before.append(r)
        r = r * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    r_before = torch.stack(r_before, dim=1)        # (B,NC,H,N,P)

    y_inter = torch.einsum("bcin,bchnp->bcihp", ccc, r_before) \
        * torch.exp(cs)[..., None]
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y.to(xh.dtype), r


def mamba_mix(cfg: ModelConfig, pl: dict, x):
    """One Mamba2 mixer on (B,S,D) (pre-norm residual added by caller)."""
    d_in, h, n, _ = _dims(cfg)
    z, xbc, dtr = _split_proj(cfg, x @ pl["in_proj"])
    xbc = _causal_conv(xbc, pl["conv_w"], pl["conv_b"])
    xs, bb, cc = (xbc[..., :d_in], xbc[..., d_in:d_in + n],
                  xbc[..., d_in + n:])
    dtv = F.softplus(dtr.to(F32) + pl["dt_bias"].to(F32))
    a_neg = -torch.exp(pl["A_log"].to(F32))
    xh = xs.reshape(*xs.shape[:2], h, cfg.ssm_headdim)
    xh = shardctx.constrain(xh, "ssm_heads")
    y, _ = ssd_chunked(xh, bb, cc, dtv, a_neg, cfg.ssm_chunk)
    y = y + xh * pl["Dskip"].to(y.dtype)[None, None, :, None]
    y = y.reshape(*x.shape[:2], d_in)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), pl["gnorm"],
                 cfg.norm_eps)
    return y @ pl["out_proj"]


def layer_fn(cfg: ModelConfig, pl: dict, x, positions=None):
    x = x + mamba_mix(cfg, pl, rms_norm(x, pl["ln"], cfg.norm_eps))
    return shardctx.constrain(x, "residual")


def hidden_fn(cfg: ModelConfig, params: dict, tokens):
    """tokens: (B, S) integer -> final-normed hidden states (B, S, D);
    each layer under ``cfg.remat``'s checkpointing
    (``transformer._remat``)."""
    x = params["embed"].to(dt(cfg.compute_dtype))[tokens]
    layers = params["layers"]
    body = _remat(cfg, functools.partial(layer_fn, cfg))
    for i in range(cfg.num_layers):
        x = body(_layer(layers, i), x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """The next-token loss of ``batch`` (``tokens``, ``labels``: (B, S)
    integer tensors), through the streamed head and loss
    (``transformer.lm_loss``)."""
    x = hidden_fn(cfg, params, batch["tokens"])
    return lm_loss(cfg, params, x, batch["labels"])


def forward(cfg: ModelConfig, params: dict, tokens):
    """tokens: (B, S) integer, S a multiple of ``min(cfg.ssm_chunk, S)``
    -> f32 logits (B, S, vocab_padded): the head's operands widened to f32
    (the JAX package's ``preferred_element_type=float32``)."""
    x = hidden_fn(cfg, params, tokens)
    logits = torch.matmul(x.to(F32), params["lm_head"].to(x.dtype).to(F32))
    return shardctx.constrain(mask_pad_logits(cfg, logits), "logits")


# --------------------------------------------------------------------------
# Recurrent decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int = 0,
               device="cuda") -> dict:
    """The decode state on ``device``: the ssm state (L, B, H, N, P) in f32
    and the conv window (L, B, K-1, conv_dim) in the compute dtype, zero.
    ``max_len`` is unused (the state does not grow with the sequence)."""
    from ..device import resolve_device

    dev = resolve_device(device)
    d_in, h, n, conv_dim = _dims(cfg)
    return {
        "ssm": torch.zeros((cfg.num_layers, batch, h, n, cfg.ssm_headdim),
                           dtype=F32, device=dev),
        "conv": torch.zeros((cfg.num_layers, batch, cfg.conv_kernel - 1,
                             conv_dim), dtype=dt(cfg.compute_dtype),
                            device=dev),
    }


def mamba_decode_mix(cfg: ModelConfig, pl: dict, x1, ssm, conv):
    """x1: (B, D) single token; ``ssm`` (B,H,N,P) and ``conv`` (B,K-1,C)
    are one layer's views of the cache, advanced in place.  Returns
    (y, ssm, conv)."""
    d_in, h, n, conv_dim = _dims(cfg)
    z, xbc, dtr = _split_proj(cfg, x1 @ pl["in_proj"])
    window = torch.cat([conv, xbc[:, None, :]], dim=1)         # (B,K,C)
    xbc = F.silu(torch.einsum("bkc,kc->bc", window, pl["conv_w"])
                 + pl["conv_b"])
    conv.copy_(window[:, 1:, :])
    xs, bb, cc = (xbc[..., :d_in], xbc[..., d_in:d_in + n],
                  xbc[..., d_in + n:])
    dtv = F.softplus(dtr.to(F32) + pl["dt_bias"].to(F32))       # (B,H)
    a_neg = -torch.exp(pl["A_log"].to(F32))
    xh = xs.reshape(-1, h, cfg.ssm_headdim).to(F32)
    decay = torch.exp(dtv * a_neg)                              # (B,H)
    ssm_new = (ssm * decay[:, :, None, None]
               + torch.einsum("bh,bn,bhp->bhnp", dtv, bb.to(F32), xh))
    ssm.copy_(ssm_new)
    y = torch.einsum("bn,bhnp->bhp", cc.to(F32), ssm)
    y = y + xh * pl["Dskip"].to(F32)[None, :, None]
    y = y.reshape(-1, d_in).to(x1.dtype)
    y = rms_norm(y * F.silu(z.to(F32)).to(y.dtype), pl["gnorm"],
                 cfg.norm_eps)
    return y @ pl["out_proj"], ssm, conv


def decode_step(cfg: ModelConfig, params: dict, cache: dict, token,
                pos: int = 0):
    """token: (B,) integer -> (logits (B, V) f32, cache).  ``pos`` is
    unused (the recurrent state carries the position).  Unlike the JAX
    package, which returns a new state, the ssm state and the conv window
    are advanced in ``cache`` in place and the same dict is returned."""
    x = params["embed"].to(dt(cfg.compute_dtype))[token]        # (B, D)
    layers = params["layers"]
    for i in range(cfg.num_layers):
        pl = _layer(layers, i)
        h = rms_norm(x, pl["ln"], cfg.norm_eps)
        y, _, _ = mamba_decode_mix(cfg, pl, h, cache["ssm"][i],
                                   cache["conv"][i])
        x = x + y
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(x.dtype)).to(F32)
    return mask_pad_logits(cfg, logits), cache
