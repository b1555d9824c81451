"""Mixture-of-Experts layer: GShard-style capacity-bounded dispatch, the
counterpart of the JAX package's ``repro.models.moe``.

Tokens are processed in fixed-size *groups*; within a group, top-k routing
builds one-hot dispatch/combine tensors and the expert FFNs run as an
expert-batched product.  Tokens beyond an expert's capacity are dropped
(their residual passes through) -- the standard GShard/Switch trade-off.

The steps and rounding points are the JAX package's, line by line: the
router product in f32 (bf16 operands widened, so the products are exact
and only the sums are f32), a softmax over the top-k values, each
(token, slot)'s place in its expert from a cumulative sum taken slot-major,
the combine weights cast to the compute dtype before the combine product,
and the expert products in the compute dtype.  Top-k is a stable
descending sort, so equal router logits go to the lower expert first as
``jax.lax.top_k`` sends them.  The JAX package runs all of this as XLA
einsums (no Pallas kernel), so the port runs it as PyTorch products.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig

F32 = torch.float32


def moe_param_shapes(cfg: ModelConfig) -> dict:
    d, fe, e = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    shapes = {
        "router": (d, e),
        "we_gate": (e, d, fe), "we_up": (e, d, fe), "we_down": (e, fe, d),
    }
    if cfg.shared_expert:
        f = cfg.d_ff
        shapes |= {"ws_gate": (d, f), "ws_up": (d, f), "ws_down": (f, d)}
    return shapes


def expert_capacity(cfg: ModelConfig, group: int) -> int:
    cap = int(group * cfg.experts_per_tok * cfg.capacity_factor
              / cfg.num_experts)
    return max(cap, 1)


def _top_k(logits, k: int):
    """The k largest values along the last axis and their indices, equal
    values in ascending index order (``jax.lax.top_k``'s order; a stable
    descending sort)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_logits(x, router):
    """f32 router logits: x's and the router's values widened, so a bf16
    model's products are exact and only the sums are f32 (the JAX
    package's ``preferred_element_type=float32``)."""
    return torch.matmul(x.to(F32), router.to(x.dtype).to(F32))


def _route(cfg: ModelConfig, router, xg, cap: int):
    """The routing of groups ``xg`` (G, T, D) with capacity ``cap``:
    (gates (G, T, k) f32, zero where dropped; gate_i (G, T, k) the experts;
    pos (G, T, k) each slot's place in its expert; keep (G, T, k))."""
    n_g, g_sz, _ = xg.shape
    e, k = cfg.num_experts, cfg.experts_per_tok
    gate_v, gate_i = _top_k(_router_logits(xg, router), k)    # (G, T, k)
    gates = torch.softmax(gate_v, dim=-1)          # normalize over top-k
    # Position of each (token, slot) within its expert, computed per slot
    # in routing priority order (slot 0 routed first, as in GShard).
    sel = F.one_hot(gate_i, e)                               # (G, T, k, E)
    sel_tk = sel.permute(0, 2, 1, 3).reshape(n_g, k * g_sz, e)
    pos_flat = torch.cumsum(sel_tk, dim=1) - 1               # (G, k*T, E)
    pos = pos_flat.reshape(n_g, k, g_sz, e).permute(0, 2, 1, 3)
    pos = torch.sum(pos * sel, dim=-1)                       # (G, T, k)
    keep = pos < cap
    return gates * keep, gate_i, pos, keep


def moe_block(cfg: ModelConfig, p: dict, x):
    """x: (B, S, D) -> (B, S, D).  B * S must be a multiple of the group,
    ``min(cfg.moe_group_size, B * S)`` tokens (``ValueError`` where the JAX
    package asserts)."""
    b, s, d = x.shape
    e = cfg.num_experts
    t = b * s
    g_sz = min(cfg.moe_group_size, t)
    n_g = t // g_sz
    if n_g * g_sz != t:
        raise ValueError(f"tokens {t} not divisible by group {g_sz}")
    cap = expert_capacity(cfg, g_sz)

    xg = x.reshape(n_g, g_sz, d)
    gates, gate_i, pos, keep = _route(cfg, p["router"], xg, cap)

    # One-hot dispatch (G,T,E,C) and combine tensors.
    cap_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1
                       ).to(xg.dtype)[..., :cap]             # (G, T, k, C)
    exp_oh = F.one_hot(gate_i, e).to(xg.dtype)               # (G, T, k, E)
    dispatch = torch.einsum("gtke,gtkc->gtec", exp_oh, cap_oh)
    combine = torch.einsum("gtk,gtke,gtkc->gtec", gates.to(xg.dtype),
                           exp_oh, cap_oh)

    xe = torch.einsum("gtec,gtd->gecd", dispatch, xg)        # (G, E, C, D)
    h = torch.einsum("gecd,edf->gecf", xe, p["we_gate"])
    u = torch.einsum("gecd,edf->gecf", xe, p["we_up"])
    ye = torch.einsum("gecf,efd->gecd", F.silu(h) * u, p["we_down"])
    y = torch.einsum("gtec,gecd->gtd", combine, ye)          # (G, T, D)
    y = y.reshape(b, s, d)

    if cfg.shared_expert:
        y = y + (F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])) @ p["ws_down"]
    return y


def moe_block_dense_ref(cfg: ModelConfig, p: dict, x):
    """Reference: every expert processes every token (no dropping).  Used by
    tests to bound the dropped-token deviation on small configs."""
    gate_v, gate_i = _top_k(_router_logits(x, p["router"]),
                            cfg.experts_per_tok)
    gates = torch.softmax(gate_v, dim=-1)
    full = torch.sum(F.one_hot(gate_i, cfg.num_experts).to(gates.dtype)
                     * gates[..., None], dim=-2)             # (B, S, E)
    h = torch.einsum("bsd,edf->bsef", x, p["we_gate"])
    u = torch.einsum("bsd,edf->bsef", x, p["we_up"])
    ye = torch.einsum("bsef,efd->bsed", F.silu(h) * u, p["we_down"])
    y = torch.einsum("bse,bsed->bsd", full.to(x.dtype), ye)
    if cfg.shared_expert:
        y = y + (F.silu(x @ p["ws_gate"]) * (x @ p["ws_up"])) @ p["ws_down"]
    return y
