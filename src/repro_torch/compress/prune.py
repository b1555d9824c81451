"""Magnitude pruning (GENESIS building block).

Weights below a magnitude threshold are zeroed [32, 57]; the network is
retrained afterwards to recover accuracy.  Thresholds are chosen per-layer
by sparsity target (the GENESIS sweep explores the target grid).

A numpy copy of the JAX package's ``repro/compress/prune.py``: the port
imports nothing of that package.
"""

from __future__ import annotations

import numpy as np


def prune_by_sparsity(w: np.ndarray, sparsity: float) -> np.ndarray:
    """Zero the smallest-|w| entries so that `sparsity` of them are zero."""
    if sparsity <= 0:
        return w.copy()
    flat = np.abs(w).reshape(-1)
    k = int(np.clip(sparsity, 0, 1) * flat.size)
    if k == 0:
        return w.copy()
    thresh = np.partition(flat, k - 1)[k - 1]
    out = w.copy()
    out[np.abs(out) <= thresh] = 0.0
    return out


def prune_by_threshold(w: np.ndarray, thresh: float) -> np.ndarray:
    out = w.copy()
    out[np.abs(out) < thresh] = 0.0
    return out


def sparsity_of(w: np.ndarray) -> float:
    return 1.0 - np.count_nonzero(w) / w.size


def nnz(w: np.ndarray) -> int:
    return int(np.count_nonzero(w))
