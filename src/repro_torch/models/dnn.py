"""The paper's three networks (Table 2) as simulator networks, at the
published widths.

  MNIST: 28x28x1 -> Conv 20@5x5 -> pool2 -> Conv 100@5x5 -> pool2
         -> FC 1600->200 -> FC 200->500 -> FC 500->10
  HAR:   3x1x112 accel window -> Conv 98@(1x12) -> pool(1,4)
         -> FC 2450->192 -> FC 192->256 -> FC 256->6
  OkG:   1x98x16 spectrogram -> Conv 186@(98x8)
         -> FC 1674->96 -> FC 96->128 -> FC 128->32 -> FC 32->128
         -> FC 128->12

(The real MNIST/HAR/OkG weights are not redistributable offline; the
weights here are seeded random draws with the published tensor shapes.)
"""

from __future__ import annotations

import numpy as np

from ..core.inference import Conv2D, DenseFC, MaxPool2D, SimNet

INPUT_SHAPES = {
    "mnist": (1, 28, 28),
    "har": (3, 1, 112),
    "okg": (1, 98, 16),
}

N_CLASSES = {"mnist": 10, "har": 6, "okg": 12}


def _conv(rng, co, ci, kh, kw, name):
    w = (rng.normal(size=(co, ci, kh, kw)) / np.sqrt(ci * kh * kw)
         ).astype(np.float32)
    return Conv2D(w, np.zeros(co, np.float32), name=name)


def _fc(rng, m, n, name, relu=True):
    w = (rng.normal(size=(m, n)) / np.sqrt(n)).astype(np.float32)
    return DenseFC(w, np.zeros(m, np.float32), relu=relu, name=name)


def mnist_net(seed: int = 0) -> SimNet:
    rng = np.random.default_rng(seed)
    return SimNet([
        _conv(rng, 20, 1, 5, 5, "conv1"),
        MaxPool2D(2),
        _conv(rng, 100, 20, 5, 5, "conv2"),
        MaxPool2D(2),
        _fc(rng, 200, 1600, "fc1"),
        _fc(rng, 500, 200, "fc2"),
        _fc(rng, 10, 500, "fc3", relu=False),
    ], input_shape=INPUT_SHAPES["mnist"], name="mnist")


def har_net(seed: int = 0) -> SimNet:
    rng = np.random.default_rng(seed)
    return SimNet([
        _conv(rng, 98, 3, 1, 12, "conv1"),
        MaxPool2D(kh=1, kw=4),
        _fc(rng, 192, 2450, "fc1"),
        _fc(rng, 256, 192, "fc2"),
        _fc(rng, 6, 256, "fc3", relu=False),
    ], input_shape=INPUT_SHAPES["har"], name="har")


def okg_net(seed: int = 0) -> SimNet:
    rng = np.random.default_rng(seed)
    return SimNet([
        _conv(rng, 186, 1, 98, 8, "conv1"),
        _fc(rng, 96, 1674, "fc1"),
        _fc(rng, 128, 96, "fc2"),
        _fc(rng, 32, 128, "fc3"),
        _fc(rng, 128, 32, "fc4"),
        _fc(rng, 12, 128, "fc5", relu=False),
    ], input_shape=INPUT_SHAPES["okg"], name="okg")


NETWORKS = {"mnist": mnist_net, "har": har_net, "okg": okg_net}
