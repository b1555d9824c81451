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

from ..device import resolve_device
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q: (B, H, Sq, d); k, v: (B, Hkv, Sk, d) with Hkv dividing H -- the
    MHA layout when Hkv == H.  Query head h reads kv head h // (H / Hkv),
    the order in which ``models.layers.blockwise_attention`` expands GQA;
    the kernel indexes it without copying k and v out.  ``bq`` and ``bk``
    are the tiles of the plain version (CPU tensors), the Pallas kernel's;
    the CUDA kernel runs its own.  Returns (B, H, Sq, d) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape \
            or k.shape[0] != q.shape[0] or k.shape[1] < 1 \
            or q.shape[1] % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, H, Sq, d) and "
                         f"(B, Hkv, Sk, d) with Hkv dividing H")
    b, h, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    out = _flash(q.reshape(b * h, sq, d).contiguous(),
                 k.reshape(b * hkv, sk, d).contiguous(),
                 v.reshape(b * hkv, sk, d).contiguous(), causal=causal,
                 group=h // hkv, bq=bq, bk=bk)
    return out.reshape(b, h, sq, d)
