"""Optional sharding-constraint context for model internals: the
counterpart of the JAX package's ``repro.models.shardctx``.

The launcher installs specs for a few well-known activation keys
(``logits``, ``residual``, ``heads``, ``heads_kv``, ``ssm_heads``,
``moe_xe``); model code calls :func:`constrain` at those points.  A spec
is a tuple with one entry per dimension, as ``launch.shardings`` writes
them.  In eager single-controller code the layout of an activation
belongs to the launcher, which places the state and splits the batch, so
``constrain`` moves nothing: with no rule for the key it returns its input
itself, and with one it checks that the spec's rank fits the activation
(what ``jax.lax.with_sharding_constraint`` checks first) and returns the
input unchanged.  No number depends on the rules.
"""

from __future__ import annotations

from contextlib import contextmanager

_RULES: dict = {}


def set_rules(**rules) -> None:
    _RULES.update(rules)


def clear() -> None:
    _RULES.clear()


@contextmanager
def rules(**kw):
    old = dict(_RULES)
    _RULES.update(kw)
    try:
        yield
    finally:
        _RULES.clear()
        _RULES.update(old)


def constrain(x, key: str):
    """``x`` itself; where a rule for ``key`` is installed, its spec must
    not name more dimensions than ``x`` has (``ValueError``)."""
    spec = _RULES.get(key)
    if spec is None:
        return x
    if len(tuple(spec)) > x.dim():
        raise ValueError(f"the {key!r} rule {tuple(spec)} names "
                         f"{len(tuple(spec))} dimensions; the activation "
                         f"has {x.dim()} ({tuple(x.shape)})")
    return x
