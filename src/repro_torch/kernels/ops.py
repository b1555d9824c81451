"""Public entry points of the port's compute kernels (the counterpart of
the JAX package's ``repro.kernels.ops``).

Same arguments, layouts and output dtypes as that module (attention also
takes k and v with fewer heads than q).  Its
``interpret=`` argument gives way to the port's rule: a CPU tensor takes
the kernel's plain version, a CUDA tensor the hand-written kernel (or an
exception; nothing falls back).  Tiles come from :mod:`.calibrate`, which
budgets the H100's shared memory; the kernels mask ragged edges, so no
operand is padded.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import PLAIN_DEVICES, resolve_device
from .calibrate import MatmulTiles, fir_tiles, matmul_tiles
from .dense_matmul import matmul as _matmul
from .fir_conv1d import fir_conv1d as _fir
from .flash_attention import flash_attention as _flash
from .sparse_fc import block_sparse_matvec as _bsmv, check_tiles, \
    to_block_csr


def dense_matmul(x: torch.Tensor, w: torch.Tensor,
                 tiles: MatmulTiles | None = None) -> torch.Tensor:
    """x (M, K) @ w (K, N) through the tiled kernels.  ``tiles`` (by
    default :func:`~.calibrate.matmul_tiles`'s) are the CUDA-core kernel's:
    it honours them as given on the card, and they are refused with
    ``ValueError`` if it cannot launch with them.  Operands that a
    tensor-core kernel takes (``dense_matmul.matmul_path``) run on it with
    its own 128 x 128 tiles: bf16 on the wgmma kernel (64-wide K slices),
    f32 on the 3xTF32 one (32-wide K slices, K split over a cluster as
    ``dense_matmul.tf32x3_plan`` chooses); other operands with N up to
    ``dense_matmul.NARROW_MAX_N`` run on the narrow kernel with its own
    bands and slices (``dense_matmul.narrow_plan``); on those paths the
    given tiles are still checked.  A pair of one f32 and one bf16 operand is computed in f32,
    as the JAX package promotes it, and returned in x's dtype."""
    m, k = x.shape
    n = w.shape[-1]
    t = tiles or matmul_tiles(m, k, n, max(x.element_size(),
                                           w.element_size()))
    return _matmul(x, w, bm=t.bm, bk=t.bk, bn=t.bn)


def _values(vals) -> torch.Tensor:
    """A bundle's values as a CPU tensor in their own dtype, f32 or bf16.

    numpy has no bf16 of its own: the JAX package's is ``ml_dtypes``'s,
    which the port does not import, so such an array is recognised by its
    dtype's name and read bit for bit through its 16-bit words.  A torch
    tensor is taken as it is; any other float array becomes f32."""
    if torch.is_tensor(vals):
        if vals.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"block values must be f32 or bf16, got "
                            f"{vals.dtype}")
        return vals
    vals = np.ascontiguousarray(vals)
    if vals.dtype.name == "bfloat16":
        bits = torch.from_numpy(vals.view(np.uint16).copy())
        return bits.view(torch.bfloat16)
    return torch.as_tensor(vals, dtype=torch.float32)


class BlockSparseFC:
    """Pruned FC layer compiled to the block-CSR kernel.

    Build once from the dense-with-zeros master weight (M, K); call on
    activations (N, K) -> (N, M), in the activations' dtype.  ``vals``,
    ``row_ptr`` and ``col_idx`` are the numpy bundle (the JAX package's,
    bit for bit); the layer keeps a copy of it on ``device`` (default the
    card) in the weight's own dtype, f32 or bf16 (any other float becomes
    f32), and takes inputs there.
    """

    def __init__(self, w_dense, bm: int = 128, bk: int = 128, bn: int = 8,
                 device="cuda"):
        w_dense = np.asarray(w_dense)
        m, k = w_dense.shape
        mp, kp = -(-m // bm) * bm, -(-k // bk) * bk
        wp = np.zeros((mp, kp), w_dense.dtype)
        wp[:m, :k] = w_dense
        self._set(*to_block_csr(wp, bm, bk), m, k, bm, bk, bn, device)

    @classmethod
    def from_block_csr(cls, vals, row_ptr, col_idx, m: int, k: int,
                       bm: int, bk: int, bn: int = 8,
                       device="cuda") -> "BlockSparseFC":
        """A layer from a bundle already made (for example the JAX
        package's, carried across as numpy by ``repro_torch.convert``);
        ``vals`` may also be a torch tensor, f32 or bf16, kept as it is."""
        fc = cls.__new__(cls)
        vals = vals.detach().clone() if torch.is_tensor(vals) \
            else np.array(vals, copy=True)
        fc._set(vals, np.array(row_ptr, np.int32),
                np.array(col_idx, np.int32), m, k, bm, bk, bn, device)
        return fc

    def _set(self, vals, row_ptr, col_idx, m, k, bm, bk, bn, device):
        check_tiles(bm, bk, bn)
        nbr = -(-m // bm)
        nnzb = vals.shape[0]
        if tuple(vals.shape[1:]) != (bm, bk) \
                or row_ptr.shape != (nbr + 1,) \
                or col_idx.shape != (nnzb,) or row_ptr[0] != 0 \
                or row_ptr[-1] != nnzb or np.any(np.diff(row_ptr) < 0) \
                or np.any(col_idx < 0) \
                or np.any(col_idx >= -(-k // bk)):
            raise ValueError(f"not a block-CSR bundle of a ({m}, {k}) "
                             f"weight in ({bm}, {bk}) blocks")
        self.m, self.k = m, k
        self.bm, self.bk, self.bn = bm, bk, bn
        self.padded_m, self.padded_k = nbr * bm, -(-k // bk) * bk
        self.vals, self.row_ptr, self.col_idx = vals, row_ptr, col_idx
        dev = resolve_device(device)
        self._bundle = (
            _values(vals).to(dev),
            torch.as_tensor(row_ptr, device=dev),
            torch.as_tensor(col_idx, device=dev))
        self.device = self._bundle[0].device      # with its index

    @property
    def density(self) -> float:
        nbr = (self.padded_m // self.bm) * (self.padded_k // self.bk)
        return self.vals.shape[0] / nbr

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 2 or x.shape[1] != self.k:
            raise ValueError(f"expected (N, {self.k}) activations, got "
                             f"{tuple(x.shape)}")
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the layer on "
                             f"{self.device}")
        return _bsmv(x, *self._bundle, self.m, bm=self.bm, bk=self.bk,
                     bn=self.bn)


def fir_conv1d(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Depthwise valid FIR conv: x (C, L), taps (C, K)."""
    c, length = x.shape
    return _fir(x, taps, cb=fir_tiles(c, length, x.element_size()))


def charge_replay(rows, caps, rem0, trace_cum, tail_s, charge_cum,
                  nominal_from, s_real, theta, window, alpha,
                  conf=None, radio=None, *,
                  adaptive: bool, parametric: bool, shared_rows: bool,
                  enable_fast: bool = True, has_burn: bool = True,
                  has_send: bool = False, chunk: int = 128,
                  interpret: bool | None = None) -> dict:
    """The fused stochastic charge-loop replay, one lane a device (the JAX
    package's ``ops.charge_replay``, same arguments): a thin wrapper over
    :func:`repro_torch.kernels.charge_replay.charge_replay`, the CUDA lane
    kernel for CUDA tensors and its plain PyTorch version for CPU tensors.
    ``rows`` maps the plan's fields to tensors; the scalar knobs ``theta``,
    ``window`` (cross-charge ``batch_rows``) and ``alpha`` may be numbers
    or one-element arrays.  ``interpret`` is the JAX package's Pallas
    switch: it is accepted and ignored, since the tensors' device chooses
    the path here.  Returns the 11 per-lane output tensors by name."""
    from .charge_replay import charge_replay as _replay

    del interpret
    return _replay(rows, caps, rem0, trace_cum, tail_s, charge_cum,
                   nominal_from, s_real, float(theta), float(window),
                   float(alpha), adaptive=adaptive, parametric=parametric,
                   shared_rows=shared_rows, enable_fast=enable_fast,
                   has_burn=has_burn, has_send=has_send, conf=conf,
                   radio=radio, chunk=chunk)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q: (B, H, Sq, d); k, v: (B, Hkv, Sk, d) with Hkv dividing H -- the
    MHA layout when Hkv == H.  Query head h reads kv head h // (H / Hkv),
    the order in which ``models.layers.blockwise_attention`` expands GQA;
    the kernel indexes it without copying k and v out.  ``bq`` and ``bk``
    are the tiles of the plain version (CPU tensors), the Pallas kernel's;
    the CUDA kernel runs its own.  Returns (B, H, Sq, d) in q's dtype.
    On CUDA tensors the kernel runs under :class:`FlashAttentionFunction`,
    so a loss through it has a gradient (the plain version's); on CPU
    tensors the plain version is differentiated as it is."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[1] < 1 \
            or q.shape[1] % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, H, Sq, d) and "
                         f"(B, Hkv, Sk, d) with Hkv dividing H")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    args = (q.reshape(b * h, sq, d).contiguous(),
            k.reshape(b * hkv, sk, d).contiguous(),
            v.reshape(b * hkv, sk, d).contiguous())
    if q.device.type in PLAIN_DEVICES:
        out = _flash(*args, causal=causal, group=h // hkv, bq=bq, bk=bk)
    else:
        out = FlashAttentionFunction.apply(*args, causal, h // hkv, bq, bk)
    return out.reshape(b, h, sq, d)


#: The tiles at which :class:`FlashAttentionFunction`'s backward
#: recomputes the plain version.  Its autograd keeps every tile pair's
#: scores, some S^2 / 2 f32 a head whatever the tiles, so larger tiles
#: cost little memory and cut the eager operations a pair takes (36 pairs
#: a head at 128-wide tiles over 1,024 tokens, 3 at 512).
BACKWARD_TILE = 512


class FlashAttentionFunction(torch.autograd.Function):
    """The attention kernel under autograd: the forward is the CUDA kernel
    (``kernels.flash_attention.flash_attention``, counted there) exactly
    as without a gradient; the backward recomputes the plain version
    (``flash_attention_plain`` at :data:`BACKWARD_TILE` tiles) from the
    saved q, k and v and returns its vector-Jacobian product.  That is the
    function the JAX package differentiates (XLA autodiff of its blockwise
    attention, which recomputes in the backward); the Pallas kernel has no
    backward.  ``apply(q, k, v, causal, group, bq, bk)`` on (BH, S, d)
    operands; on CPU tensors the forward is the plain version at tiles
    ``bq`` x ``bk``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, group, bq, bk):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.group = causal, group
        return _flash(q, k, v, causal=causal, group=group, bq=bq, bk=bk)

    @staticmethod
    def backward(ctx, d_out):
        from .flash_attention import flash_attention_plain

        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = flash_attention_plain(*ins, causal=ctx.causal,
                                        group=ctx.group, bq=BACKWARD_TILE,
                                        bk=BACKWARD_TILE)
            grads = torch.autograd.grad(out, ins, d_out)
        return (*grads, None, None, None, None)
