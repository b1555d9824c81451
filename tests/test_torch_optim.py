"""The port's optimizers (``repro_torch.optim``) against the JAX package's
``repro.optim``, on the CPU.

From the same gradients, state and parameters, one ``adamw`` or
``sgd_momentum`` update, ``clip_by_global_norm`` and ``cosine_schedule``
agree within ``rtol=1e-6, atol=1e-7``: the arithmetic is the same in the
same order, but XLA's CPU backend may fuse a multiply and an add into an
FMA where PyTorch rounds twice (``ROADMAP.md`` Queue 3, item 2), and its
reductions add in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro_torch import optim as topt

RTOL, ATOL = 1e-6, 1e-7


def _tree(seed, scale=1.0, positive=False):
    """A GENESIS-shaped parameter tree: a conv, a pool (no parameters), a
    dense layer; numpy f32."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        x = rng.normal(size=shape) * scale
        return (np.abs(x) if positive else x).astype(np.float32)

    return [{"w": a(4, 1, 3, 3), "b": a(4)}, {},
            {"w": a(10, 36), "b": a(10)}]


def _to(tree, fn):
    return [{k: fn(v) for k, v in d.items()} for d in tree]


def _jax(tree):
    return _to(tree, jnp.asarray)


def _torch(tree):
    return _to(tree, torch.tensor)


def _assert_trees_close(got, want, tag):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), tag
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{tag}:{k}")


OPTIMIZERS = {
    "adamw": lambda m: m.adamw(lr=2e-3, weight_decay=1e-4,
                               max_grad_norm=1.0),
    "adamw_no_clip": lambda m: m.adamw(lr=1e-2, b1=0.8, b2=0.99,
                                       weight_decay=0.05,
                                       max_grad_norm=0.0),
    "adamw_cosine": lambda m: m.adamw(lr=m.cosine_schedule(3e-3, 2, 10),
                                      max_grad_norm=0.5),
    "sgd_momentum": lambda m: m.sgd_momentum(lr=1e-2, momentum=0.9,
                                             weight_decay=1e-3),
    "sgd_clip_cosine": lambda m: m.sgd_momentum(
        lr=m.cosine_schedule(5e-2, 3, 12), max_grad_norm=0.25),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
@pytest.mark.parametrize("step", [0, 4])
def test_one_update_matches_jax(name, step):
    """One update from the same grads, state and params (the state's
    moments drawn at random, ``step`` updates already taken)."""
    params, grads = _tree(0), _tree(1, scale=0.7)
    m, v = _tree(2, scale=0.1), _tree(3, scale=0.01, positive=True)
    sgd = name.startswith("sgd")
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    js = jopt.OptState(jnp.asarray(step, jnp.int32), _jax(m),
                       {} if sgd else _jax(v))
    ts = topt.OptState(torch.tensor(step, dtype=torch.int32), _torch(m),
                       {} if sgd else _torch(v))
    jp, js2 = jo.update(_jax(grads), js, _jax(params))
    tp, ts2 = to.update(_torch(grads), ts, _torch(params))
    assert int(ts2.step) == int(js2.step) == step + 1
    _assert_trees_close(tp, jp, "params")
    _assert_trees_close(ts2.m, js2.m, "m")
    if not sgd:
        _assert_trees_close(ts2.v, js2.v, "v")


def test_init_matches_jax():
    params = _tree(0)
    js = jopt.adamw().init(_jax(params))
    ts = topt.adamw().init(_torch(params))
    assert int(ts.step) == int(js.step) == 0
    _assert_trees_close(ts.m, js.m, "m")
    _assert_trees_close(ts.v, js.v, "v")
    assert topt.sgd_momentum().init(_torch(params)).v == {}


@pytest.mark.parametrize("max_norm", [0.3, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    """Clipping (a norm above ``max_norm``) and passing through."""
    grads = _tree(5, scale=0.4)
    jg, jn = jopt.clip_by_global_norm(_jax(grads), max_norm)
    tg, tn = topt.clip_by_global_norm(_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL, atol=ATOL)
    _assert_trees_close(tg, jg, "grads")


@pytest.mark.parametrize("warmup,total,final", [(3, 10, 0.1), (0, 7, 0.0),
                                                (5, 5, 0.2)])
def test_cosine_schedule_matches_jax(warmup, total, final):
    js = jopt.cosine_schedule(1e-3, warmup, total, final)
    ts = topt.cosine_schedule(1e-3, warmup, total, final)
    for step in range(total + 4):
        np.testing.assert_allclose(float(ts(step)), float(js(step)),
                                   rtol=RTOL, atol=ATOL, err_msg=str(step))
