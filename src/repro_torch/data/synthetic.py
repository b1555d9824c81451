"""Deterministic synthetic datasets shaped like the paper's tasks.

MNIST/HAR/OkG are not redistributable offline, so the pipeline generates
classification tasks with identical tensor shapes and a controllable
difficulty (noise level -> Bayes error), letting GENESIS's
accuracy-vs-compression trade-offs be measured end to end.  Class
prototypes are smooth random fields; samples are prototypes + white noise
with per-sample random gain/shift, which gives conv nets real structure to
exploit (and makes over-compression visibly lose accuracy).

A numpy copy of the JAX package's ``repro/data/synthetic.py``, seeded
the same way: ``make_task`` offsets its seed by ``hash(name)``, which
changes from one process to the next unless ``PYTHONHASHSEED`` is set, so
the two packages make the same data only within one process.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..models.dnn import INPUT_SHAPES, N_CLASSES


def _smooth(a: np.ndarray, k: int = 5, axes=(-2, -1)) -> np.ndarray:
    for ax in axes:
        if a.shape[ax] >= k:
            kernel = np.ones(k) / k
            a = np.apply_along_axis(
                lambda v: np.convolve(v, kernel, mode="same"), ax, a)
    return a


@dataclass
class Dataset:
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    name: str

    @property
    def n_classes(self) -> int:
        return int(self.y_train.max()) + 1


def make_task(name: str, n_train: int = 2048, n_test: int = 512,
              noise: float = 0.9, seed: int = 0,
              sign_flip: bool = False) -> Dataset:
    """A k-way task with the tensor shape of `name` in {mnist, har, okg}.

    ``sign_flip=True`` multiplies every sample by a random +-1, making the
    class means zero: linear classifiers drop to chance while conv nets
    (which can detect pattern *magnitude*) still learn -- the regime behind
    the paper's Sec. 5.1 SVM-vs-DNN comparison."""
    shape = INPUT_SHAPES[name]
    k = N_CLASSES[name]
    rng = np.random.default_rng(seed + hash(name) % 65536)
    protos = _smooth(rng.normal(size=(k, *shape)).astype(np.float32))
    protos /= np.abs(protos).max(axis=tuple(range(1, protos.ndim)),
                                 keepdims=True) + 1e-6

    def sample(n, rs):
        y = rs.integers(0, k, size=n)
        gain = rs.uniform(0.7, 1.3, size=(n,) + (1,) * len(shape)
                          ).astype(np.float32)
        if sign_flip:
            gain = gain * rs.choice([-1.0, 1.0], size=gain.shape
                                    ).astype(np.float32)
        x = protos[y] * gain + noise * rs.normal(size=(n, *shape)
                                                 ).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train, np.random.default_rng(seed * 2 + 1))
    x_te, y_te = sample(n_test, np.random.default_rng(seed * 2 + 2))
    return Dataset(x_tr, y_tr, x_te, y_te, name)


def token_batches(vocab: int, batch: int, seq: int, steps: int,
                  seed: int = 0):
    """Deterministic synthetic LM token stream (power-law unigram with
    local repetition structure), shardable by step index."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    for step in range(steps):
        rs = np.random.default_rng(seed + 7919 * step)
        toks = rs.choice(vocab, size=(batch, seq), p=probs).astype(np.int32)
        # inject copy structure so a real LM can learn something
        toks[:, 1::2] = toks[:, 0:-1:2]
        yield {"tokens": toks, "labels": toks}
