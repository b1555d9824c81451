"""AdamW / SGD with decoupled weight decay on trees of tensors (PyTorch).

The counterpart of the JAX package's ``optim/adamw.py``.  A parameter
tree is a list, tuple or dict of tensors (GENESIS's ``train`` passes a list
of ``{"w", "b"}`` dicts); leaves are visited in the JAX package's order --
sequences in order, dict keys sorted -- so the global norm adds its
per-leaf sums in the same order.  Every update runs under
``torch.no_grad()`` with that module's arithmetic in its order: the norm
as a Python sum of per-leaf f32 sums, then ``sqrt``; ``b1 ** step`` in
f32; ``mh / (sqrt(vh) + eps) + wd * p``, then ``p - lr * step_p``.
(``torch.optim.AdamW`` decays before the moment update and divides in
another order, so it is not used.)  Optimizer states live on their
parameters' device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch


class OptState(NamedTuple):
    step: torch.Tensor
    m: object
    v: object        # empty dict for sgd


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable     # (grads, state, params) -> (new_params, new_state)


def _leaves(tree) -> list:
    """The tensors of ``tree`` in the JAX package's flattening order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping the structure (named tuples too)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return fn(tree, *rest)


class _Step(tuple):
    """One leaf's results of an update (new parameter, new moments)."""


def _pick(tree, i: int):
    """Result ``i`` of every leaf's :class:`_Step` in ``tree``."""
    if isinstance(tree, _Step):
        return tree[i]
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return type(tree)(_pick(t, i) for t in tree)


def _first_device(tree) -> torch.device:
    leaves = _leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    final_frac: float = 0.1):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        one = torch.ones((), dtype=torch.float32, device=step.device)
        warm = base_lr * torch.minimum(step / max(warmup, 1), one)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, base_lr * cos)
    return lr


def clip_by_global_norm(grads, max_norm: float):
    with torch.no_grad():
        leaves = _leaves(grads)
        gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                            for g in leaves))
        scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
        return _map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


def adamw(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01,
          max_grad_norm: float = 1.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device)
        return OptState(torch.zeros((), dtype=torch.int32,
                                    device=_first_device(params)),
                        _map(zeros, params), _map(zeros, params))

    def update(grads, state, params):
        with torch.no_grad():
            if max_grad_norm:
                grads, _ = clip_by_global_norm(grads, max_grad_norm)
            step = state.step + 1
            stepf = step.to(torch.float32)
            lr_t = lr_fn(stepf)
            c1 = 1.0 - b1 ** stepf
            c2 = 1.0 - b2 ** stepf

            def upd(p, g, m, v):
                g = g.to(torch.float32)
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * torch.square(g)
                mh = m / c1
                vh = v / c2
                step_p = mh / (torch.sqrt(vh) + eps) + weight_decay * \
                    p.to(torch.float32)
                return _Step(((p.to(torch.float32) - lr_t * step_p)
                               .to(p.dtype), m, v))

            out = _map(upd, params, grads, state.m, state.v)
            return _pick(out, 0), OptState(step, _pick(out, 1),
                                           _pick(out, 2))

    return Optimizer(init, update)


def sgd_momentum(lr=1e-2, momentum=0.9, weight_decay=0.0,
                 max_grad_norm: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return OptState(torch.zeros((), dtype=torch.int32,
                                    device=_first_device(params)),
                        _map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device),
                             params), {})

    def update(grads, state, params):
        with torch.no_grad():
            if max_grad_norm:
                grads, _ = clip_by_global_norm(grads, max_grad_norm)
            step = state.step + 1
            lr_t = lr_fn(step.to(torch.float32))

            def upd(p, g, m):
                g = g.to(torch.float32) + weight_decay * p.to(torch.float32)
                m = momentum * m + g
                return _Step(((p.to(torch.float32) - lr_t * m).to(p.dtype),
                              m))

            out = _map(upd, params, grads, state.m)
            return _pick(out, 0), OptState(step, _pick(out, 1), {})

    return Optimizer(init, update)
