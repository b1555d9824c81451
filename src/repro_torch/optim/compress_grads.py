"""Gradient compression with error feedback (distributed-optimization trick).

int8 block-quantized gradients cut cross-pod all-reduce bytes 4x (bf16->int8
plus one f32 scale per block); the residual quantization error is carried in
an error-feedback accumulator so the optimizer sees an unbiased-in-the-limit
gradient stream (EF-SGD / 1-bit-Adam style).

The PyTorch counterpart of the JAX package's ``optim/compress_grads.py``:
the same f32 operations in the same order (the block's max-abs over 127,
``round`` half to even, a clip to +-127, int8), so values and scales come
out bitwise equal.  This module provides the quantize/dequantize pair and a
reference all-reduce for unit tests; trees are walked in the JAX package's
order (:mod:`.adamw`'s helpers).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .adamw import _map


class ErrorFeedbackState(NamedTuple):
    residual: dict     # same tree as grads, f32


BLOCK = 256


def _pad_to(x, mult):
    n = x.numel()
    pad = (-n) % mult
    return torch.nn.functional.pad(x.reshape(-1), (0, pad)), n


def compress_int8(g):
    """g: any-shape float tensor -> (int8 values, f32 per-block scales)."""
    flat, n = _pad_to(g.to(torch.float32), BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    q = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)),
                    -127, 127).to(torch.int8)
    return q, scale, n


def decompress_int8(q, scale, n, shape):
    flat = (q.to(torch.float32) * scale).reshape(-1)[:n]
    return flat.reshape(shape)


class _Packed(tuple):
    """One leaf's ``((q, scale, n), residual)``."""


def compress_tree(grads, ef: ErrorFeedbackState | None):
    """Quantize a grad tree, folding in and updating error feedback."""
    def one(g, r=None):
        gf = g.to(torch.float32) + (r if r is not None else 0.0)
        q, s, n = compress_int8(gf)
        deq = decompress_int8(q, s, n, g.shape)
        return _Packed(((q, s, n), gf - deq))

    pairs = (_map(one, grads) if ef is None
             else _map(one, grads, ef.residual))
    packed = _unzip(pairs, 0)
    resid = _unzip(pairs, 1)
    return packed, ErrorFeedbackState(resid)


def _unzip(tree, i: int):
    """Part ``i`` of every leaf's :class:`_Packed` in ``tree``."""
    if isinstance(tree, _Packed):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _unzip(v, i) for k, v in tree.items()}
    return type(tree)(_unzip(t, i) for t in tree)


def decompress_tree(packed, shapes):
    """The dequantized tree of ``packed``, whose leaves are ``(q, scale,
    n)`` triples; ``shapes`` holds each leaf's shape at the same place."""
    if _is_triple(packed):
        return decompress_int8(*packed, shapes)
    if isinstance(packed, dict):
        return {k: decompress_tree(v, shapes[k]) for k, v in packed.items()}
    return type(packed)(decompress_tree(p, s)
                        for p, s in zip(packed, shapes))


def _is_triple(t) -> bool:
    return isinstance(t, tuple) and len(t) == 3 and torch.is_tensor(t[0])


def compressed_allreduce_ref(grads_per_worker: list):
    """Reference semantics for tests: quantize each worker's grad, sum the
    dequantized streams (what the wire carries), average."""
    n = len(grads_per_worker)
    total = None
    for g in grads_per_worker:
        q, s, sz = compress_int8(g)
        d = decompress_int8(q, s, sz, g.shape)
        total = d if total is None else total + d
    return total / n
