"""Separation of fully-connected layers by rank decomposition (SVD).

An (m x n) FC layer factors into (m x k)(k x n); parameters shrink from
m*n to k*(m+n) whenever k < mn/(m+n) [9, 14].  GENESIS sweeps k and lets
retraining recover accuracy.

A numpy copy of the JAX package's ``repro/compress/svd.py``: the port
imports nothing of that package.
"""

from __future__ import annotations

import numpy as np


def svd_factor(w: np.ndarray, rank: int) -> tuple[np.ndarray, np.ndarray]:
    """w (m, n) ~= a @ b with a (m, rank), b (rank, n)."""
    u, s, vt = np.linalg.svd(w, full_matrices=False)
    rank = int(min(rank, s.size))
    root = np.sqrt(s[:rank])
    a = u[:, :rank] * root[None, :]
    b = root[:, None] * vt[:rank, :]
    return a.astype(w.dtype), b.astype(w.dtype)


def svd_params(m: int, n: int, rank: int) -> int:
    return rank * (m + n)


def svd_worthwhile(m: int, n: int, rank: int) -> bool:
    return svd_params(m, n, rank) < m * n


def reconstruction_error(w: np.ndarray, a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(w - a @ b) / max(np.linalg.norm(w), 1e-12))
