"""Optimizers from scratch on trees of tensors: AdamW, SGD-momentum,
schedules, global-norm clipping, and int8 gradient compression with error
feedback (the JAX package's ``repro.optim``).

Optimizer states mirror the parameter tree and live on their parameters'
device.
"""

from .adamw import (OptState, Optimizer, adamw, clip_by_global_norm,
                    cosine_schedule, sgd_momentum)
from .compress_grads import (compress_int8, decompress_int8,
                             ErrorFeedbackState, compressed_allreduce_ref)

__all__ = [
    "ErrorFeedbackState", "OptState", "Optimizer", "adamw",
    "clip_by_global_norm", "compress_int8", "compressed_allreduce_ref",
    "cosine_schedule", "decompress_int8", "sgd_momentum",
]
