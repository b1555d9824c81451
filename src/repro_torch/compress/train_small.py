"""PyTorch trainer for the paper's networks (and their compressed variants).

The counterpart of the JAX package's ``compress/train_small.py``.  It
mirrors the device simulator's layer semantics exactly (valid-padding
conv, rectangular max-pool, masked sparse FC), so weights trained here
drop straight into ``repro_torch.core.inference.SimNet`` for intermittent
execution.  Pruning masks are applied inside the loss at every step (dense
gradients, masked updates), so pruned weights stay exactly zero.  The
forward pass follows the JAX module step by step (the conv, then its bias
as its own add; the max-pool with a stride equal to its window; the dense
product, then its bias), the batches come from the same numpy permutation,
the gradient from autograd, and the update from ``repro_torch.optim.adamw``.
These products are PyTorch's own (``F.conv2d``, ``F.max_pool2d``, ``@``):
the JAX module runs XLA's, and no Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.inference import Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC
from ..data.synthetic import Dataset
from ..device import resolve_device
from ..optim import adamw


def net_to_params(net: SimNet, *, device="cuda"):
    """Extract (params, masks, structure) from a SimNet, as tensors on
    ``device``."""
    dev = resolve_device(device)
    params, masks, structure = [], [], []
    for l in net.layers:
        if isinstance(l, Conv2D):
            params.append({"w": torch.tensor(l.w, device=dev),
                           "b": torch.tensor(l.b, device=dev)})
            masks.append({"w": torch.tensor(
                (l.w != 0).astype(np.float32), device=dev)})
            structure.append(("conv", {"stride": l.stride, "relu": l.relu}))
        elif isinstance(l, (DenseFC, SparseFC)):
            params.append({"w": torch.tensor(l.w, device=dev),
                           "b": torch.tensor(l.b, device=dev)})
            masks.append({"w": torch.tensor(
                (l.w != 0).astype(np.float32), device=dev)})
            structure.append(("fc", {"relu": l.relu,
                                     "sparse": isinstance(l, SparseFC)}))
        elif isinstance(l, MaxPool2D):
            params.append({})
            masks.append({})
            structure.append(("pool", {"kh": l._ks()[0], "kw": l._ks()[1]}))
        else:
            raise TypeError(l)
    return params, masks, structure


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_to_net(net: SimNet, params) -> SimNet:
    """Write trained weights back into a copy of the SimNet."""
    layers = []
    for l, p in zip(net.layers, params):
        if isinstance(l, Conv2D):
            layers.append(Conv2D(_numpy(p["w"]), _numpy(p["b"]),
                                 stride=l.stride, relu=l.relu, name=l.name))
        elif isinstance(l, SparseFC):
            layers.append(SparseFC(_numpy(p["w"]), _numpy(p["b"]),
                                   relu=l.relu, name=l.name))
        elif isinstance(l, DenseFC):
            layers.append(DenseFC(_numpy(p["w"]), _numpy(p["b"]),
                                  relu=l.relu, name=l.name))
        else:
            layers.append(l)
    return SimNet(layers, net.input_shape, net.name)


def forward(params, structure, x):
    """x: (N, C, H, W) -> logits (N, k)."""
    for p, (kind, meta) in zip(params, structure):
        if kind == "conv":
            s = meta["stride"]
            x = F.conv2d(x, p["w"], stride=(s, s))
            x = x + p["b"][None, :, None, None]
            if meta["relu"]:
                x = torch.relu(x)
        elif kind == "pool":
            kh, kw = meta["kh"], meta["kw"]
            x = F.max_pool2d(x, (kh, kw), stride=(kh, kw))
        elif kind == "fc":
            x = x.reshape(x.shape[0], -1) @ p["w"].T + p["b"]
            if meta["relu"]:
                x = torch.relu(x)
    return x


def _apply_masks(ps, masks):
    return [{k: (v * m[k] if k in m else v) for k, v in p.items()}
            for p, m in zip(ps, masks)]


def loss_and_grads(params, masks, structure, xb, yb):
    """The training loss of one batch (masks applied inside it) and its
    gradient with respect to every parameter, by autograd."""
    ps = [{k: v.detach().requires_grad_(True) for k, v in p.items()}
          for p in params]
    logits = forward(_apply_masks(ps, masks), structure, xb)
    logp = F.log_softmax(logits, dim=-1)
    loss = -torch.gather(logp, 1, yb[:, None].to(torch.int64)).mean()
    leaves = [v for p in ps for v in p.values()]
    grads = iter(torch.autograd.grad(loss, leaves)) if leaves else iter(())
    return loss.detach(), [{k: next(grads) for k in p} for p in ps]


def train(net: SimNet, data: Dataset, epochs: int = 6, batch: int = 64,
          lr: float = 2e-3, seed: int = 0, *, device="cuda"):
    """Train (or retrain a compressed) net; returns (net', accuracy)."""
    dev = resolve_device(device)
    params, masks, structure = net_to_params(net, device=dev)
    opt = adamw(lr=lr, weight_decay=1e-4, max_grad_norm=1.0)
    state = opt.init(params)

    n = data.x_train.shape[0]
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - batch + 1, batch):
            idx = order[i:i + batch]
            _, grads = loss_and_grads(
                params, masks, structure,
                torch.tensor(data.x_train[idx], device=dev),
                torch.tensor(data.y_train[idx], device=dev))
            params, state = opt.update(grads, state, params)
    params = _apply_masks(params, masks)
    acc = accuracy(params, structure, data)
    return params_to_net(net, params), float(acc)


def _test_logits(params, structure, data: Dataset):
    leaves = [v for p in params for v in p.values()]
    dev = leaves[0].device if leaves else torch.device("cpu")
    with torch.no_grad():
        return forward(params, structure,
                       torch.tensor(data.x_test, device=dev))


def accuracy(params, structure, data: Dataset) -> float:
    """Test accuracy, on the device the parameters lie on."""
    logits = _test_logits(params, structure, data)
    y = torch.tensor(data.y_test, device=logits.device)
    return float((torch.argmax(logits, -1) == y).to(torch.float32).mean())


def net_accuracy(net: SimNet, data: Dataset, *, device="cuda") -> float:
    params, masks, structure = net_to_params(net, device=device)
    return accuracy(params, structure, data)


def class_rates(net: SimNet, data: Dataset, positive: int, *,
                device="cuda") -> tuple[float, float]:
    """(true-positive, true-negative) treating `positive` as interesting."""
    params, _, structure = net_to_params(net, device=device)
    pred = torch.argmax(_test_logits(params, structure, data),
                        -1).cpu().numpy()
    y = data.y_test
    pos = y == positive
    neg = ~pos
    tp = float((pred[pos] == positive).mean()) if pos.any() else 1.0
    tn = float((pred[neg] != positive).mean()) if neg.any() else 1.0
    return tp, tn
