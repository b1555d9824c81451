"""Optimizers from scratch on trees of tensors: AdamW, SGD-momentum,
schedules and global-norm clipping (the JAX package's ``repro.optim``).

Its int8 gradient compression (``compress_grads``) is not ported yet: see
``ROADMAP.md`` Queue 1, item 16.
"""

from .adamw import (OptState, Optimizer, adamw, clip_by_global_norm,
                    cosine_schedule, sgd_momentum)

__all__ = [
    "OptState", "Optimizer", "adamw", "clip_by_global_norm",
    "cosine_schedule", "sgd_momentum",
]
