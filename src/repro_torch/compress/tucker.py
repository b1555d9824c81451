"""Tucker decomposition via higher-order orthogonal iteration (HOOI)
[20, 21, 73] and the conv-filter separations built on it (Sec. 5.2).

``separate_conv_spatial`` is the paper's "3x1D conv" output: a KxK filter
bank factors into a vertical (kh x 1), horizontal (1 x kw) pair (plus the
implicit channel mixing inside the factors); ``tucker2_conv`` reduces
channel ranks with 1x1 convs around a small core.

A numpy copy of the JAX package's ``repro/compress/tucker.py``: the
port imports nothing of that package.
"""

from __future__ import annotations

import numpy as np


def _unfold(t: np.ndarray, mode: int) -> np.ndarray:
    return np.moveaxis(t, mode, 0).reshape(t.shape[mode], -1)


def _fold(m: np.ndarray, mode: int, shape) -> np.ndarray:
    full = [shape[mode]] + [s for i, s in enumerate(shape) if i != mode]
    return np.moveaxis(m.reshape(full), 0, mode)


def _mode_dot(t: np.ndarray, m: np.ndarray, mode: int) -> np.ndarray:
    return _fold(m @ _unfold(t, mode), mode,
                 t.shape[:mode] + (m.shape[0],) + t.shape[mode + 1:])


def hooi(t: np.ndarray, ranks, iters: int = 6):
    """HOOI Tucker: returns (core, factors) with t ~= core x_n factors[n].

    Factors are column-orthonormal (Co x r_n); init by HOSVD, refined by
    alternating SVDs of the partially-contracted tensor.
    """
    ranks = [min(r, s) for r, s in zip(ranks, t.shape)]
    factors = []
    for n in range(t.ndim):
        u, _, _ = np.linalg.svd(_unfold(t, n), full_matrices=False)
        factors.append(u[:, :ranks[n]])
    for _ in range(iters):
        for n in range(t.ndim):
            y = t
            for m in range(t.ndim):
                if m != n:
                    y = _mode_dot(y, factors[m].T, m)
            u, _, _ = np.linalg.svd(_unfold(y, n), full_matrices=False)
            factors[n] = u[:, :ranks[n]]
    core = t
    for n in range(t.ndim):
        core = _mode_dot(core, factors[n].T, n)
    return core, factors


def tucker_reconstruct(core: np.ndarray, factors) -> np.ndarray:
    t = core
    for n, f in enumerate(factors):
        t = _mode_dot(t, f, n)
    return t


def separate_conv_spatial(w: np.ndarray, rank: int):
    """(Co,Ci,kh,kw) -> [v (r,Ci,kh,1), h (Co,r,1,kw)]; exact at full rank.

    Derivation: unfold W into ((Ci,kh) x (Co,kw)) and truncate its SVD; the
    composition of the two separable convs reproduces the original conv."""
    co, ci, kh, kw = w.shape
    m = w.transpose(1, 2, 0, 3).reshape(ci * kh, co * kw)
    u, s, vt = np.linalg.svd(m, full_matrices=False)
    r = int(min(rank, s.size))
    root = np.sqrt(s[:r])
    a = (u[:, :r] * root[None, :])            # (Ci*kh, r)
    b = (root[:, None] * vt[:r, :])           # (r, Co*kw)
    v = a.reshape(ci, kh, r).transpose(2, 0, 1)[..., None]       # (r,Ci,kh,1)
    h = b.reshape(r, co, kw).transpose(1, 0, 2)[:, :, None, :]   # (Co,r,1,kw)
    return [v.astype(w.dtype), h.astype(w.dtype)]


def tucker2_conv(w: np.ndarray, r_out: int, r_in: int):
    """(Co,Ci,kh,kw) -> [pw_in (r_in,Ci,1,1), core (r_out,r_in,kh,kw),
    pw_out (Co,r_out,1,1)] via HOOI on the channel modes."""
    co, ci, kh, kw = w.shape
    core, factors = hooi(w, [r_out, r_in, kh, kw])
    u_out, u_in = factors[0], factors[1]      # (Co,r_out), (Ci,r_in)
    pw_in = u_in.T[:, :, None, None]                       # (r_in, Ci, 1, 1)
    pw_out = u_out[:, :, None, None]                       # (Co, r_out, 1, 1)
    return [pw_in.astype(w.dtype), core.astype(w.dtype),
            pw_out.astype(w.dtype)]


def separation_params(w_shape, rank: int) -> int:
    co, ci, kh, kw = w_shape
    return rank * (ci * kh + co * kw)


def tucker2_params(w_shape, r_out: int, r_in: int) -> int:
    co, ci, kh, kw = w_shape
    return r_in * ci + r_out * r_in * kh * kw + co * r_out
