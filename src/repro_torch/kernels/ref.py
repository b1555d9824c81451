"""Plain PyTorch oracles for the port's kernels (the correctness ground
truth), in f32 on whatever device the inputs lie.

The dense product, the FIR and the SSD cell are also the kernels' plain
versions: the wrappers call them for CPU tensors, and ``chip_smoke.py``
holds the kernels against them on the card.  Attention's plain version is
the tile-by-tile online softmax in ``flash_attention``; the naive form
here is its oracle.  The FIR sums its taps in order t = 0 ..
K-1 with one rounding per multiply and per add, as the kernel does.
"""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) in f32, returned in x's dtype."""
    return torch.matmul(x.to(F32), w.to(F32)).to(x.dtype)


def matmul_in_order(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) summed as the narrow and CUDA-core kernels sum
    it: for each output, one multiply-add a term over K in order from 0,
    in f32, returned in x's dtype.  Each fused multiply-add is emulated in
    f64 (the product of two f32 is exact there) and rounded to f32, so a
    step can differ from ``fmaf`` by a double rounding; slow (a loop over
    K), for tests at small K."""
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=F32, device=x.device)
    x64, w64 = x.to(torch.float64), w.to(torch.float64)
    for k in range(x.shape[1]):
        acc = (acc.to(torch.float64) + x64[:, k, None] * w64[None, k]).to(F32)
    return acc.to(x.dtype)


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


#: The score given to masked (query, key) pairs, as in the Pallas kernel.
NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Naive softmax attention in f32 over (B, H, S, d), returned in f32.

    Under ``causal`` the mask is start-aligned: query i attends keys
    j <= i, also when Sq != Sk, as in ``models.layers.blockwise_attention``."""
    qf, kf, vf = q.to(F32), k.to(F32), v.to(F32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / math.sqrt(q.shape[-1])
    if causal:
        sq, sk = s.shape[-2:]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril()
        s = torch.where(mask, s, NEG_INF)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf)


def ssd_intra_ref(xdt: torch.Tensor, bb: torch.Tensor, cc: torch.Tensor,
                  cs: torch.Tensor, dtype: torch.dtype = F32
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """One Mamba2 SSD intra-chunk cell per (batch*chunk, head), in f32 (or
    in ``dtype``: float64 gives the exact cell that the 3xTF32 kernel's
    ``tf32x3`` rule is held to).

    xdt (BC, H, Q, P), bb/cc (BC, Q, N), cs (BC, H, Q) -> y (BC, H, Q, P),
    s (BC, H, N, P): ``G = C B^T``, ``M = G * exp(cs_i - cs_j)`` for
    j <= i (else 0), ``y = M xdt``, ``s = B^T (exp(cs_Q - cs) * xdt)``.
    The exponent of a masked pair (j > i) is set to -inf before the
    exponential: where a steep decay would overflow it (cs_i - cs_j past
    88 at realistic chunk lengths), the JAX package's ``where`` drops the
    infinity from the value but its gradient multiplies 0 by it and is
    NaN; here the value is the same bit for bit and the gradient finite.

    bf16 inputs are widened (every bf16 product is exact in f32).  A bf16
    cs is rounded to bf16 where the JAX kernel's arithmetic rounds it: its
    differences of a bf16 cs are bf16 arrays, so ``cs_i - cs_j`` and
    ``cs_Q - cs`` are rounded before their exponentials, and the
    end-of-chunk decay ``exp(cs_Q - cs)`` after its own (the decay of G
    feeds an f32 product at once and stays f32 there; measured against
    the Pallas kernel in interpret mode)."""
    if cs.dtype == torch.bfloat16:
        def in_cs(t):
            return t.to(torch.bfloat16).to(dtype)
    else:
        def in_cs(t):
            return t
    xdt, bb, cc, cs = (t.to(dtype) for t in (xdt, bb, cc, cs))
    q = xdt.shape[2]
    g = torch.matmul(cc, bb.transpose(-1, -2))[:, None]       # (BC,1,Q,Q)
    causal = torch.ones((q, q), dtype=torch.bool, device=xdt.device).tril()
    l_log = torch.where(causal, in_cs(cs[..., :, None] - cs[..., None, :]),
                        -math.inf)                             # (BC,H,Q,Q)
    m = torch.where(causal, g * torch.exp(l_log), 0.0)
    y = torch.matmul(m, xdt)
    decay_end = in_cs(torch.exp(in_cs(cs[..., -1:] - cs)))     # (BC,H,Q)
    s = torch.matmul(bb.transpose(-1, -2)[:, None],
                     decay_end[..., None] * xdt)
    return y, s
