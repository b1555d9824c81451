"""Unified model API across families: the counterpart of the JAX package's
``repro.models.api``.

Every family exposes the same entry points:

  init_params(cfg, seed, device)              -> params tree
  loss_fn(cfg, params, batch)                 -> scalar loss (train shapes)
  forward(cfg, params, tokens)                -> logits (B, S, V) f32
  init_cache(cfg, batch, max_len, device)     -> cache dict (decode state)
  decode_step(cfg, params, cache, tok, pos)   -> (logits (B, V), cache)
  input_spec_shapes(cfg, cell)                -> {name: (shape, dtype)}
  cache_spec_shapes(cfg, cell)                -> {name: (shape, dtype)}

The port runs every family of the JAX package: dense, moe and vlm
(``transformer``), ssm (``mamba2``), hybrid (``zamba2``) and encdec
(``whisper``, whose ``forward`` takes a batch dict with ``frames`` and
``tokens``); ``decode_step`` advances the cache in place and returns it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from . import mamba2, transformer, whisper, zamba2
from .config import ModelConfig, SUBQUADRATIC, ShapeCell

#: The module of each family.
_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "ssm": mamba2, "hybrid": zamba2, "encdec": whisper}


@dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    loss_fn: Callable
    forward: Callable
    init_cache: Callable
    decode_step: Callable


def _family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family]


def get_model(cfg: ModelConfig) -> ModelAPI:
    m = _family(cfg)
    return ModelAPI(m.init_params, m.loss_fn, m.forward, m.init_cache,
                    m.decode_step)


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape by its dotted name."""
    return _family(cfg).param_shapes(cfg)


def abstract_params(cfg: ModelConfig) -> dict:
    """The parameter tree of ``init_params`` as ``meta`` tensors in
    ``cfg.param_dtype``: every leaf's shape and dtype, nothing allocated
    (the counterpart of ``jax.eval_shape`` of the init)."""
    import torch

    from .layers import dt
    from .transformer import _nest

    kd = dt(cfg.param_dtype)
    return _nest({k: torch.empty(v, dtype=kd, device="meta")
                  for k, v in param_shapes(cfg).items()})


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """Whether an (arch x shape) cell runs; else the documented reason."""
    if cell.name == "long_500k" and cfg.family not in SUBQUADRATIC:
        return False, ("full quadratic attention at 512K context; "
                       "assigned only to ssm/hybrid families")
    return True, ""


def input_spec_shapes(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Abstract input shapes for one cell: {name: (shape, dtype name)}."""
    b, s = cell.global_batch, cell.seq_len
    if cell.kind == "train":
        if cfg.family == "encdec":
            return {
                "frames": ((b, cfg.encoder_seq, cfg.d_model),
                           cfg.compute_dtype),
                "tokens": ((b, s), "int32"),
                "labels": ((b, s), "int32"),
            }
        if cfg.family == "vlm":
            p = cfg.num_patches
            return {
                "patches": ((b, p, cfg.d_model), cfg.compute_dtype),
                "tokens": ((b, s - p), "int32"),
                "labels": ((b, s - p), "int32"),
            }
        return {"tokens": ((b, s), "int32"), "labels": ((b, s), "int32")}
    if cell.kind == "prefill":
        if cfg.family == "encdec":
            return {
                "frames": ((b, cfg.encoder_seq, cfg.d_model),
                           cfg.compute_dtype),
                "tokens": ((b, s), "int32"),
            }
        if cfg.family == "vlm":
            p = cfg.num_patches
            return {
                "patches": ((b, p, cfg.d_model), cfg.compute_dtype),
                "tokens": ((b, s - p), "int32"),
            }
        return {"tokens": ((b, s), "int32")}
    # decode: one new token against a seq_len cache
    return {"token": ((b,), "int32")}


def cache_spec_shapes(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Shapes of the decode-state dict for a cell (leading dim layers):
    {name: (shape, dtype name)}, for every family."""
    b, s = cell.global_batch, cell.seq_len
    kd = cfg.kv_dtype or cfg.compute_dtype
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
        return {"k": ((L, b, kv, s, hd), kd), "v": ((L, b, kv, s, hd), kd)}
    if fam == "ssm":
        d_in, h, n, conv_dim = mamba2._dims(cfg)
        return {
            "ssm": ((cfg.num_layers, b, h, n, cfg.ssm_headdim), "float32"),
            "conv": ((cfg.num_layers, b, cfg.conv_kernel - 1, conv_dim), kd),
        }
    if fam == "hybrid":
        a = cfg.attn_every
        n_super = cfg.num_layers // a
        d_in, h, n, conv_dim = mamba2._dims(cfg)
        return {
            "ssm": ((cfg.num_layers, b, h, n, cfg.ssm_headdim), "float32"),
            "conv": ((cfg.num_layers, b, cfg.conv_kernel - 1, conv_dim), kd),
            "k": ((n_super, b, cfg.num_kv_heads, s, cfg.hd), kd),
            "v": ((n_super, b, cfg.num_kv_heads, s, cfg.hd), kd),
        }
    if fam == "encdec":
        L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
        return {
            "k": ((L, b, kv, s, hd), kd), "v": ((L, b, kv, s, hd), kd),
            "xk": ((L, b, kv, cfg.encoder_seq, hd), kd),
            "xv": ((L, b, kv, cfg.encoder_seq, hd), kd),
        }
    raise ValueError(fam)
