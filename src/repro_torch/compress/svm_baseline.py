"""Linear multiclass SVM baseline (Sec. 5.1's comparison point).

The paper evaluates SVM models and finds none competitive with the DNNs on
IMpJ (2x worse on MNIST, 8x on HAR, no viable OkG model).  This module
trains a one-vs-rest linear SVM (hinge loss, full-batch gradient descent)
on the same synthetic tasks so the benchmark can reproduce the comparison:
the SVM's inference is cheap (one matvec) but its accuracy ceiling on
structured inputs drags the end-to-end IMpJ below the compressed DNN's.

The counterpart of the JAX package's ``compress/svm_baseline.py``: the
gradient comes from autograd in place of ``jax.grad``, with the same
``lr * 100`` step; ``svm_rates`` and ``svm_impj`` are numpy, as there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.energy import JOULES_PER_CYCLE
from ..core.imp import AppModel
from ..data.synthetic import Dataset
from ..device import resolve_device
from .genesis import CYCLES_PER_MAC, DEVICE_WEIGHT_BYTES


def train_svm(data: Dataset, epochs: int = 20, lr: float = 5e-3,
              reg: float = 1e-4, seed: int = 0, *, device="cuda"):
    """One-vs-rest linear SVM; returns (W (k, d), b (k,), accuracy)."""
    dev = resolve_device(device)
    x_tr = data.x_train.reshape(data.x_train.shape[0], -1)
    k = data.n_classes
    d = x_tr.shape[1]
    w = torch.zeros((k, d), dtype=torch.float32, device=dev)
    b = torch.zeros((k,), dtype=torch.float32, device=dev)
    y = torch.tensor(data.y_train, device=dev).to(torch.int64)
    y_pm = 2.0 * torch.nn.functional.one_hot(y, k).to(torch.float32) - 1.0
    xj = torch.tensor(x_tr, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    def loss_fn(w_, b_):
        scores = xj @ w_.T + b_                     # (n, k)
        hinge = torch.maximum(zero, 1.0 - y_pm * scores).mean()
        return hinge + reg * torch.sum(w_ * w_)

    for _ in range(epochs):
        w_, b_ = w.requires_grad_(True), b.requires_grad_(True)
        gw, gb = torch.autograd.grad(loss_fn(w_, b_), (w_, b_))
        with torch.no_grad():
            w, b = w - lr * 100 * gw, b - lr * 100 * gb
    with torch.no_grad():
        x_te = torch.tensor(data.x_test.reshape(data.x_test.shape[0], -1),
                            device=dev)
        pred = torch.argmax(x_te @ w.T + b, dim=1)
        acc = float((pred == torch.tensor(data.y_test, device=dev)
                     ).to(torch.float32).mean())
    return w.cpu().numpy(), b.cpu().numpy(), acc


def svm_rates(w, b, data: Dataset, positive: int) -> tuple[float, float]:
    x_te = data.x_test.reshape(data.x_test.shape[0], -1)
    pred = np.argmax(x_te @ w.T + b, axis=1)
    pos = data.y_test == positive
    neg = ~pos
    tp = float((pred[pos] == positive).mean()) if pos.any() else 1.0
    tn = float((pred[neg] != positive).mean()) if neg.any() else 1.0
    return tp, tn


def svm_impj(w, b, data: Dataset, app: AppModel, positive: int = 0,
             runtime: str = "tails") -> dict:
    macs = w.size
    e_infer = macs * CYCLES_PER_MAC[runtime] * JOULES_PER_CYCLE
    tp, tn = svm_rates(w, b, data, positive)
    m = AppModel(app.p, app.e_sense, app.e_comm, e_infer)
    feasible = w.size * 2 <= DEVICE_WEIGHT_BYTES
    return {"impj": m.inference(tp, tn) if feasible else 0.0,
            "tp": tp, "tn": tn, "macs": macs, "feasible": feasible}
