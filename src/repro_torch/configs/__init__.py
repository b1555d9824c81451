"""Architecture registry: the 10 assigned configs + the paper's networks.

A copy of the JAX package's ``repro.configs`` (the same ids, the same
fields); the port runs the dense family's forward so far
(``models.api.get_model``).
"""

from __future__ import annotations

import importlib

from ..models.config import ModelConfig

_MODULES = {
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2.5-14b": "qwen2_5_14b",
    "qwen3-0.6b": "qwen3_0_6b",
    "llama3-8b": "llama3_8b",
    "internvl2-26b": "internvl2_26b",
    "mamba2-370m": "mamba2_370m",
    "whisper-small": "whisper_small",
    "zamba2-7b": "zamba2_7b",
}

ARCHS = tuple(_MODULES)

#: The paper's own networks (device-simulator side).
PAPER_NETS = ("mnist", "har", "okg")


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
