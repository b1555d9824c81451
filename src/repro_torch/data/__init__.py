"""Deterministic synthetic data pipeline (classification + LM tokens).

A copy of the JAX package's ``repro.data`` (numpy).
"""

from .synthetic import Dataset, make_task, token_batches

__all__ = ["Dataset", "make_task", "token_batches"]
