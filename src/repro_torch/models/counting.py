"""Exact parameter counts (total and active) per config and the model
FLOPs convention, counted from the shape dicts (the JAX package's
``repro.models.counting`` counts the same through ``eval_shape``)."""

from __future__ import annotations

import math

from .api import param_shapes
from .config import ModelConfig


def param_count(cfg: ModelConfig) -> int:
    return sum(math.prod(s) for s in param_shapes(cfg).values())


def expert_params_per_layer(cfg: ModelConfig) -> int:
    if not cfg.is_moe:
        return 0
    return 3 * cfg.d_model * cfg.moe_d_ff        # gate, up, down


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token (MoE: top-k experts instead of all)."""
    total = param_count(cfg)
    if not cfg.is_moe:
        return total
    inactive = (cfg.num_experts - cfg.experts_per_tok) * \
        expert_params_per_layer(cfg) * cfg.num_layers
    return total - inactive


def model_flops(cfg: ModelConfig, tokens: int, kind: str) -> float:
    """The 6*N*D / 2*N*D convention (N = active params incl embeddings and
    head; the attention quadratic term excluded -- callers add it)."""
    n = active_param_count(cfg)
    per_tok = 6.0 * n if kind == "train" else 2.0 * n
    return per_tok * tokens
