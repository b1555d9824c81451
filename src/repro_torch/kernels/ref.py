"""Plain PyTorch oracles for the port's kernels (the correctness ground
truth), in f32 on whatever device the inputs lie.

The dense product and the FIR are also the kernels' plain versions: the
wrappers call them for CPU tensors, and ``chip_smoke.py`` holds the
kernels against them on the card.  The FIR sums its taps in order t = 0 ..
K-1 with one rounding per multiply and per add, as the kernel does.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) in f32, returned in x's dtype."""
    return torch.matmul(x.to(F32), w.to(F32)).to(x.dtype)


def block_sparse_matvec_ref(x: torch.Tensor, w_dense) -> torch.Tensor:
    """y = x @ W^T against the dense master copy (zeros included)."""
    w = torch.as_tensor(w_dense, device=x.device).to(F32)
    return torch.matmul(x.to(F32), w.T).to(x.dtype)


def fir_conv1d_ref(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise valid FIR: x (C, L), taps (C, K) -> (C, L-K+1)."""
    c, length = x.shape
    k = taps.shape[1]
    n = length - k + 1
    xf, tf = x.to(F32), taps.to(F32)
    out = torch.zeros((c, n), dtype=F32, device=x.device)
    for t in range(k):
        out += xf[:, t:t + n] * tf[:, t:t + 1]
    return out.to(x.dtype)
