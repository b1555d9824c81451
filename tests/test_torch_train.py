"""The port's GENESIS trainer and SVM baseline (``repro_torch.compress.
train_small``, ``svm_baseline``) against the JAX package's, on the CPU.

The rules, each stated where it is asserted:

* ``forward``'s logits, the training loss and its gradient, from the same
  parameters and batch: ``rtol=1e-5, atol=1e-6`` (f32 products that XLA
  and PyTorch add in different orders);
* ``train``'s parameters after its first 8 steps, from the same weights
  and batches: ``rtol=1e-4, atol=1e-5``, held on float64 weights and
  inputs (see the test), and every pruned entry exactly 0 in both;
* ``train_svm``'s ``W`` and ``b`` after its 20 full-batch steps:
  ``rtol=1e-4, atol=1e-6``; ``svm_rates`` and ``svm_impj`` bitwise on the
  same ``W`` and ``b``;
* ``class_rates`` on the same weights equal; ``accuracy`` the correctly
  rounded f32 quotient of the same count, JAX's within an ulp of it.

No test holds two whole independent training runs to each other's
accuracy: two frameworks' runs drift apart by more than the data can
resolve.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import svm_baseline as jsvm, train_small as jts
from repro.core import WILDLIFE as JWILD
from repro.core.inference import (Conv2D as JConv, DenseFC as JDense,
                                  MaxPool2D as JPool, SimNet as JNet,
                                  SparseFC as JSparse)
from repro.data import make_task as jmake_task
from repro_torch.compress import svm_baseline as tsvm, train_small as tts
from repro_torch.compress.prune import prune_by_sparsity
from repro_torch.convert import numpy_layers
from repro_torch.core import WILDLIFE
from repro_torch.core.inference import (Conv2D, DenseFC, MaxPool2D, SimNet,
                                        SparseFC)
from repro_torch.data import make_task

FWD = dict(rtol=1e-5, atol=1e-6)
TRAIN = dict(rtol=1e-4, atol=1e-5)
SVM = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nets():
    """Small nets over every layer kind the trainer maps: a conv with and
    without ReLU, at stride 1 and 2, GENESIS's separated conv pair, a
    square and a rectangular pool, a dense and a pruned sparse FC."""
    rng = np.random.default_rng(11)

    def a(*shape, s=0.3):
        return (rng.normal(size=shape) * s).astype(np.float32)

    sparse = prune_by_sparsity(a(24, 36, s=0.2), 0.8)
    return {
        "conv_pool_dense": SimNet([
            Conv2D(a(4, 1, 5, 5), a(4)), MaxPool2D(2),
            DenseFC(a(24, 4 * 12 * 12, s=0.05), a(24)),
            DenseFC(a(10, 24), a(10), relu=False)], (1, 28, 28), "a"),
        "separated_stride2": SimNet([
            Conv2D(a(2, 1, 5, 1), np.zeros(2, np.float32), relu=False),
            Conv2D(a(3, 2, 1, 5), a(3)),
            Conv2D(a(4, 3, 3, 3), a(4), stride=2), MaxPool2D(2),
            DenseFC(a(10, 4 * 5 * 5, s=0.1), a(10), relu=False)],
            (1, 28, 28), "b"),
        "rect_pool_sparse": SimNet([
            Conv2D(a(4, 3, 1, 5), a(4)), MaxPool2D(kh=1, kw=4),
            SparseFC(sparse, a(24)),
            DenseFC(a(6, 24), a(6), relu=False)], (3, 1, 40), "c"),
    }


def _jax_net(net):
    """The same net in the JAX package's classes."""
    cls = {"Conv2D": JConv, "DenseFC": JDense, "MaxPool2D": JPool,
           "SparseFC": JSparse}
    layers = [cls[d.pop("type")](**d) for d in numpy_layers(net)]
    return JNet(layers, net.input_shape, net.name)


def _jax_loss(params, masks, structure, xb, yb):
    """The JAX package's training loss (``train_small.train``'s
    ``loss_fn``), masks applied inside it."""
    ps = [{k: (v * m[k] if k in m else v) for k, v in p.items()}
          for p, m in zip(params, masks)]
    logp = jax.nn.log_softmax(jts.forward(ps, structure, xb))
    return -jnp.take_along_axis(logp, yb[:, None], axis=1).mean()


@pytest.mark.parametrize("name", sorted(_nets()))
def test_forward_loss_and_gradient_match_jax(name):
    net = _nets()[name]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(16, *net.input_shape)).astype(np.float32)
    y = rng.integers(0, 6, size=16).astype(np.int32)
    jp, jm, js = jts.net_to_params(_jax_net(net))
    tp, tm, ts = tts.net_to_params(net, device="cpu")
    assert ts == js
    want = np.asarray(jts.forward(jp, js, jnp.asarray(x)))
    got = tts.forward(tp, ts, torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **FWD)
    jloss, jgrad = jax.value_and_grad(_jax_loss)(jp, jm, js, jnp.asarray(x),
                                                 jnp.asarray(y))
    tloss, tgrad = tts.loss_and_grads(tp, tm, ts, torch.tensor(x),
                                      torch.tensor(y))
    np.testing.assert_allclose(float(tloss), float(jloss), **FWD)
    for i, (g, w) in enumerate(zip(tgrad, jgrad)):
        assert sorted(g) == sorted(w)
        for k in g:
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       **FWD, err_msg=f"layer {i} {k}")


def _mini():
    """``tests/test_compress.py``'s reduced MNIST net, fc1 pruned to 80 %."""
    rng = np.random.default_rng(6)
    return SimNet([
        Conv2D(rng.normal(size=(6, 1, 5, 5)).astype(np.float32) * 0.3,
               np.zeros(6, np.float32)),
        MaxPool2D(2),
        SparseFC(prune_by_sparsity(
            rng.normal(size=(600, 864)).astype(np.float32) * 0.05, 0.8),
            np.zeros(600, np.float32)),
        DenseFC(rng.normal(size=(10, 600)).astype(np.float32) * 0.1,
                np.zeros(10, np.float32), relu=False),
    ], (1, 28, 28), "mini")


@pytest.fixture(scope="module")
def task():
    """The same task from both packages (one process: one ``hash``)."""
    data = make_task("mnist", n_train=384, n_test=192, noise=0.8)
    jdata = jmake_task("mnist", n_train=384, n_test=192, noise=0.8)
    assert np.array_equal(data.x_train, jdata.x_train)
    return data, jdata


def _f64(net, data):
    """The net and task with float64 weights and inputs."""
    layers = [dataclasses.replace(
        l, **{k: getattr(l, k).astype(np.float64) for k in ("w", "b")})
        if hasattr(l, "w") else l for l in net.layers]
    return (SimNet(layers, net.input_shape, net.name),
            dataclasses.replace(data, x_train=data.x_train.astype(np.float64),
                                x_test=data.x_test.astype(np.float64)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_train_first_8_steps_match_jax(task, dtype):
    """384 samples in batches of 48: one epoch is 8 steps, from the same
    weights and the same permutation.  The rule is held on float64 weights
    and inputs, where the two frameworks' forward and backward passes
    agree to float64 rounding (the optimizer still steps in f32, as the
    JAX module does): in float32, a max-pool or ReLU decision that one
    rounding flips, or a gradient near AdamW's eps, makes a step differ by
    up to the learning rate, so on some tasks (``make_task``'s data change
    from one process to the next) no elementwise rule holds there.  Both
    dtypes keep every pruned entry exactly 0."""
    data, jdata = task
    net = _mini()
    jnet0 = _jax_net(net)
    if dtype == "float64":
        net, data = _f64(net, data)
        jnet0, jdata = _f64(jnet0, jdata)
    tnet, tacc = tts.train(net, data, epochs=1, batch=48, device="cpu")
    with jax.enable_x64(dtype == "float64"):
        jnet, jacc = jts.train(jnet0, jdata, epochs=1, batch=48)
    for i, (lt, lj) in enumerate(zip(tnet.layers, jnet.layers)):
        assert type(lt).__name__ == type(lj).__name__
        if not hasattr(lt, "w"):
            continue
        assert lt.w.dtype == lj.w.dtype == np.dtype(dtype)
        if dtype == "float64":
            np.testing.assert_allclose(lt.w, lj.w, **TRAIN,
                                       err_msg=f"layer {i} w")
            np.testing.assert_allclose(lt.b, lj.b, **TRAIN,
                                       err_msg=f"layer {i} b")
        pruned = net.layers[i].w == 0
        assert (lt.w[pruned] == 0).all() and (lj.w[pruned] == 0).all()
        assert np.isfinite(lt.w).all() and np.isfinite(lj.w).all()
    assert 0.0 <= tacc <= 1.0 and 0.0 <= jacc <= 1.0


def test_rates_and_accuracy_match_jax_on_the_same_weights(task):
    """The same weights: the same class rates (numpy over the same
    predictions), and the accuracy the f32 quotient of the same count --
    rounded once by the port, within an ulp of it by XLA, which divides
    its mean by multiplying by 1 / n."""
    data, jdata = task
    net = _mini()
    assert tts.class_rates(net, data, 0, device="cpu") == \
        jts.class_rates(_jax_net(net), jdata, 0)
    params, _, structure = tts.net_to_params(net, device="cpu")
    hits = int((tts.forward(params, structure, torch.tensor(data.x_test))
                .argmax(-1).numpy() == data.y_test).sum())
    want = np.float32(hits) / np.float32(len(data.y_test))
    got = tts.net_accuracy(net, data, device="cpu")
    assert got == float(want)
    jgot = float(jts.net_accuracy(_jax_net(net), jdata))
    assert abs(jgot - got) <= float(np.spacing(want))


def test_train_svm_matches_jax_and_rates_bitwise(task):
    data, jdata = task
    tw, tb, tacc = tsvm.train_svm(data, device="cpu")
    jw, jb, jacc = jsvm.train_svm(jdata)
    np.testing.assert_allclose(tw, jw, **SVM)
    np.testing.assert_allclose(tb, jb, **SVM)
    assert 0.0 <= tacc <= 1.0
    for w, b in ((jw, jb), (tw, tb)):
        assert tsvm.svm_rates(w, b, data, 0) == jsvm.svm_rates(w, b, jdata,
                                                               0)
        assert tsvm.svm_impj(w, b, data, WILDLIFE) == \
            jsvm.svm_impj(w, b, jdata, JWILD)
