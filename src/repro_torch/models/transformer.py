"""Decoder-only transformer LM (dense GQA or MoE): the full-sequence
forward, the losses and KV-cache serving (``prefill``, ``init_cache``,
``decode_step``), the counterpart of the JAX package's
``repro.models.transformer``.

Covers llama3/llama4-scout/qwen1.5/qwen2.5/qwen3/qwen3-moe and the LM
backbone of internvl2 (its patch embeddings prepended through
``extra_embeds``).  Parameters are a dict tree named as the JAX package's
(``embed``, ``final_norm``, ``lm_head``, ``layers`` with ``ln1``, ``ln2``,
``attn.wq`` ..., ``mlp.w_gate`` ... or ``moe.router`` ...), every layer
leaf carrying a leading L dimension, so a JAX tree carries across leaf for
leaf (``repro_torch.convert``).  The stack is a Python loop over the
layers in place of ``lax.scan``, each layer under ``cfg.remat``'s
checkpointing (:func:`_remat`).  ``decode_step`` writes the cache in place
(see :func:`decode_step`).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from . import shardctx
from .config import ModelConfig
from .layers import (F32, attn_param_shapes, attn_qkv, attention_block,
                     attention_decode, attention_out, dt, init_from_shapes,
                     mlp_block, mlp_param_shapes, rms_norm)
from .moe import moe_block, moe_param_shapes


# --------------------------------------------------------------------------
# Params
# --------------------------------------------------------------------------

def layer_param_shapes(cfg: ModelConfig) -> dict:
    shapes = {"ln1": (cfg.d_model,), "ln2": (cfg.d_model,)}
    shapes |= {f"attn.{k}": v for k, v in attn_param_shapes(cfg).items()}
    if cfg.is_moe:
        shapes |= {f"moe.{k}": v for k, v in moe_param_shapes(cfg).items()}
    else:
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

def _ffn(cfg: ModelConfig, pl: dict, h):
    """The layer's feed-forward half: the MoE block or the SwiGLU MLP."""
    if cfg.is_moe:
        return moe_block(cfg, pl["moe"], h)
    return mlp_block(pl["mlp"], h)


def layer_fn(cfg: ModelConfig, pl: dict, x, positions):
    h = rms_norm(x, pl["ln1"], cfg.norm_eps)
    x = x + attention_block(cfg, pl["attn"], h, positions)
    h = rms_norm(x, pl["ln2"], cfg.norm_eps)
    # Sequence-parallel residual: between blocks the activations shard over
    # the model axis where the launcher says so.
    return shardctx.constrain(x + _ffn(cfg, pl, h), "residual")


#: The products whose outputs ``remat="dots"`` keeps (the matmuls without
#: batch dimensions, as ``jax.checkpoint_policies.
#: dots_with_no_batch_dims_saveable`` keeps ``dot_general``'s).
_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _requires_grad(tree) -> bool:
    if isinstance(tree, dict):
        return any(_requires_grad(v) for v in tree.values())
    return tree.requires_grad


def _remat(cfg: ModelConfig, fn):
    """``fn(pl, x, ...)`` under ``cfg.remat``'s checkpointing, the JAX
    package's ``jax.checkpoint`` policies: ``"none"`` keeps every
    activation; ``"full"`` keeps only ``fn``'s inputs and recomputes the
    rest in the backward (``torch.utils.checkpoint``, non-reentrant);
    ``"dots"`` keeps the outputs of the products without batch dimensions
    and recomputes the rest (selective checkpointing).  No policy changes
    a value: the recompute runs the same operations on the same inputs.
    A call that autograd does not record (grad mode off, or neither the
    layer's parameters nor x requiring a gradient) runs ``fn`` as it is:
    there is nothing to keep, and the checkpoint's own host time (some
    0.1 ms a call) would only slow inference."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("full", "dots"):
        raise ValueError(f"unknown remat policy {cfg.remat!r}; expected "
                         f"'none', 'full' or 'dots'")
    kw = {} if cfg.remat == "full" else {
        "context_fn": functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)}

    def body(pl, x, *rest):
        if torch.is_grad_enabled() and (x.requires_grad
                                        or _requires_grad(pl)):
            return ckpt.checkpoint(fn, pl, x, *rest, use_reentrant=False,
                                   **kw)
        return fn(pl, x, *rest)
    return body


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree (views, no copy)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def stack_forward(cfg: ModelConfig, layers: dict, x, positions):
    body = _remat(cfg, functools.partial(layer_fn, cfg))
    for i in range(cfg.num_layers):
        x = body(_layer(layers, i), x, positions)
    return x


def hidden_states(cfg: ModelConfig, params: dict, tokens,
                  extra_embeds=None):
    """tokens: (B, S) integer; extra_embeds: optional (B, P, D) prepended
    (internvl's patch embeddings) -> final-normed hidden states
    (B, P + S, D)."""
    cd = dt(cfg.compute_dtype)
    x = params["embed"].to(cd)[tokens]
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cd), x], dim=1)
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
    # Keep logits vocab-sharded through the loss where the launcher says so.
    return shardctx.constrain(mask_pad_logits(cfg, logits), "logits")


def forward(cfg: ModelConfig, params: dict, tokens, extra_embeds=None):
    """tokens: (B, S) integer (and optional (B, P, D) ``extra_embeds``)
    -> f32 logits (B, P + S, vocab_padded)."""
    return logits_fn(cfg, params,
                     hidden_states(cfg, params, tokens, extra_embeds))


def _nll(logits, labels):
    """Each position's negative log-likelihood of its label.  The gold
    logit is gathered where the JAX package contracts with a one-hot (its
    vocab may be sharded): every other term of that sum is an exact zero,
    so both give the same value and gradient."""
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def xent_loss(logits, labels, mask=None):
    """Mean softmax cross-entropy of f32 ``logits`` (B, S, V) at integer
    ``labels`` (B, S), over the positions where ``mask`` (B, S) is 1 if it
    is given."""
    nll = _nll(logits, labels)
    if mask is None:
        return nll.mean()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)


#: sequence-chunk length for the streamed LM head + loss
LOSS_CHUNK = 512


def _chunk_nll(cfg: ModelConfig, xi, head, li, mi):
    """The masked nll sum of one sequence chunk (its logits in f32)."""
    logits = shardctx.constrain(mask_pad_logits(cfg, torch.matmul(
        xi.to(F32), head.to(xi.dtype).to(F32))), "logits")
    return (_nll(logits, li) * mi).sum()


def lm_xent_from_hidden(cfg: ModelConfig, x, head, labels, mask=None):
    """Streamed LM head + cross-entropy: logits are materialized one
    sequence chunk of :data:`LOSS_CHUNK` at a time, checkpointed so the
    backward recomputes each chunk's logits instead of keeping B x S x V
    alive; the last chunk is padded and its padding masked.  x: (B, S, D)
    hidden states; head (D, V); labels (B, S) integer; mask (B, S) or
    None (every position)."""
    b, s, d = x.shape
    c = min(LOSS_CHUNK, s)
    nc = -(-s // c)
    pad = nc * c - s
    if mask is None:
        mask = torch.ones((b, s), dtype=F32, device=x.device)
    xp = F.pad(x, (0, 0, 0, pad))
    lp = F.pad(labels, (0, pad))
    mp = F.pad(mask.to(F32), (0, pad))
    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=F32, device=x.device)
    chunk = functools.partial(ckpt.checkpoint,
                              functools.partial(_chunk_nll, cfg),
                              use_reentrant=False)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        tot = tot + chunk(xp[:, sl], head, lp[:, sl], mp[:, sl])
        cnt = cnt + mp[:, sl].sum()
    return tot / torch.clamp(cnt, min=1.0)


def lm_loss(cfg: ModelConfig, params: dict, x_hidden, tokens):
    """Next-token loss from final hidden states (B,S,D) and the target token
    ids (B,S): position t predicts token t+1."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    b, s, _ = x_hidden.shape
    labels_next = torch.cat(
        [tokens[:, 1:], torch.zeros((b, 1), dtype=tokens.dtype,
                                    device=tokens.device)], dim=1)
    mask = torch.cat([torch.ones((b, s - 1), dtype=F32,
                                 device=x_hidden.device),
                      torch.zeros((b, 1), dtype=F32,
                                  device=x_hidden.device)], dim=1)
    return lm_xent_from_hidden(cfg, x_hidden, head, labels_next, mask)


def loss_fn(cfg: ModelConfig, params: dict, batch: dict):
    """The training loss of ``batch``: ``tokens`` and ``labels`` (B, S)
    integer tensors, and for the vlm family ``patches`` (B, P, D), whose
    positions are dropped before the loss (labels align with the text)."""
    x = hidden_states(cfg, params, batch["tokens"], batch.get("patches"))
    if "patches" in batch:   # labels align with the text positions only
        x = x[:, batch["patches"].shape[1]:, :]
    return lm_loss(cfg, params, x, batch["labels"])


# --------------------------------------------------------------------------
# KV-cache serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zero K and V caches (L, B, KV, max_len, hd) on ``device``, in
    ``cfg.kv_dtype`` (float8_e4m3fn halves them) or the compute dtype."""
    from ..device import resolve_device

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
    (``layers.attention_decode``).  The MoE block routes the batch's B
    tokens as one group, so its capacity is that of a group of B
    (``moe.expert_capacity``), as in the JAX package: decode may drop
    slots that the full-sequence forward keeps."""
    x = params["embed"].to(dt(cfg.compute_dtype))[token][:, None, :]
    layers = params["layers"]
    for i in range(cfg.num_layers):
        pl = _layer(layers, i)
        h = rms_norm(x, pl["ln1"], cfg.norm_eps)
        a, _, _ = attention_decode(cfg, pl["attn"], h, cache["k"][i],
                                   cache["v"][i], pos)
        x = x + a
        h = rms_norm(x, pl["ln2"], cfg.norm_eps)
        x = x + _ffn(cfg, pl, h)
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
        x = x + _ffn(cfg, pl, h)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x[:, -1:, :])[:, 0, :], cache
