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

The port runs the dense, moe and vlm families (``transformer``) and the
ssm family (``mamba2``); ``decode_step`` advances the cache in place and
returns it.  The hybrid and encdec families raise
``NotImplementedError`` naming their item in ``ROADMAP.md``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from . import mamba2, transformer
from .config import ModelConfig, SUBQUADRATIC, ShapeCell

#: ROADMAP.md Queue 1 items of the LM stack that the port does not run yet.
NOT_PORTED = {
    "families": "ROADMAP.md Queue 1 item 17 (the hybrid and encdec "
                "families)",
}


@dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    loss_fn: Callable
    forward: Callable
    init_cache: Callable
    decode_step: Callable


def get_model(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        return ModelAPI(transformer.init_params, transformer.loss_fn,
                        transformer.forward, transformer.init_cache,
                        transformer.decode_step)
    if fam == "ssm":
        return ModelAPI(mamba2.init_params, mamba2.loss_fn, mamba2.forward,
                        mamba2.init_cache, mamba2.decode_step)
    if fam in ("hybrid", "encdec"):
        raise NotImplementedError(f"{cfg.name}: the {fam} family is not "
                                  f"ported yet: {NOT_PORTED['families']}")
    raise ValueError(f"unknown family {fam!r}")


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape by its dotted name, for the families the
    port runs (the others are refused as :func:`get_model` refuses
    them)."""
    get_model(cfg)
    family = mamba2 if cfg.family == "ssm" else transformer
    return family.param_shapes(cfg)


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
    {name: (shape, dtype name)}, for every family (shape arithmetic only,
    so the families not ported yet have theirs too)."""
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
