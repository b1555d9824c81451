"""Unified model API across families: the counterpart of the JAX package's
``repro.models.api``.

Every family exposes the same entry points:

  init_params(cfg, seed, device)            -> params tree
  forward(cfg, params, tokens)              -> logits (B, S, V) f32
  loss_fn / init_cache / decode_step        -> later slices
  input_spec_shapes(cfg, cell)              -> {name: (shape, dtype)}

The port runs the dense family's full-sequence forward so far.  The other
families, and the entry points of later slices, raise
``NotImplementedError`` naming their item in ``ROADMAP.md``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from . import transformer
from .config import ModelConfig, SUBQUADRATIC, ShapeCell

#: ROADMAP.md Queue 1 items of the LM stack that the port does not run yet.
NOT_PORTED = {
    "decode_step": "ROADMAP.md Queue 1 item 13 (decode_step / init_cache)",
    "init_cache": "ROADMAP.md Queue 1 item 13 (decode_step / init_cache)",
    "moe": transformer.MOE_ITEM,
    "loss_fn": "ROADMAP.md Queue 1 item 16 (the losses and training)",
    "families": "ROADMAP.md Queue 1 item 17 (the ssm, hybrid, encdec and "
                "vlm families)",
}


def not_ported(what: str) -> Callable:
    """An entry point that raises ``NotImplementedError`` naming its
    ROADMAP item."""
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{what} is not ported yet: "
                                  f"{NOT_PORTED[what]}")
    refuse.__name__ = what
    return refuse


@dataclass(frozen=True)
class ModelAPI:
    init_params: Callable
    loss_fn: Callable
    forward: Callable
    init_cache: Callable
    decode_step: Callable


def get_model(cfg: ModelConfig) -> ModelAPI:
    fam = cfg.family
    if fam not in ("dense", "moe", "vlm", "ssm", "hybrid", "encdec"):
        raise ValueError(f"unknown family {fam!r}")
    if cfg.is_moe or fam == "moe":
        raise NotImplementedError(f"{cfg.name}: the MoE block is not ported "
                                  f"yet: {NOT_PORTED['moe']}")
    if fam != "dense":
        raise NotImplementedError(f"{cfg.name}: the {fam} family is not "
                                  f"ported yet: {NOT_PORTED['families']}")
    return ModelAPI(transformer.init_params, not_ported("loss_fn"),
                    transformer.forward, not_ported("init_cache"),
                    not_ported("decode_step"))


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
