"""Shared fixtures: seeded random small networks for property-style tests,
and the optional-hypothesis shim.

``seeded_net`` parametrizes over :data:`NET_SEEDS`, giving every test that
requests it a deterministic sweep of randomized small networks (random conv
width/kernel, pooling on/off, random FC sizes, random sparsity) covering all
four layer types of the device simulator.

``given``/``settings``/``st`` re-export hypothesis when it is installed;
otherwise they are stubs that make every ``@given`` test skip at run time
(via ``pytest.importorskip``) while the deterministic tests in the same
files still collect and run.
"""

import numpy as np
import pytest

from repro.core import Conv2D, DenseFC, MaxPool2D, SimNet, SparseFC

try:
    from hypothesis import given, settings, strategies as st  # noqa: F401
except ImportError:
    def settings(**_kw):
        return lambda fn: fn

    def given(*_a, **_kw):
        def deco(fn):
            def _skipped():
                pytest.importorskip("hypothesis")
            _skipped.__name__ = fn.__name__
            _skipped.__doc__ = fn.__doc__
            return _skipped
        return deco

    class _AnyStrategy:
        def __getattr__(self, _name):
            return lambda *_a, **_kw: None

    st = _AnyStrategy()

NET_SEEDS = (0, 1, 2, 3, 4)


def make_random_net(seed: int):
    """A random small SimNet + input, deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    ci, h = 1, int(rng.integers(8, 12))
    co = int(rng.integers(2, 5))
    k = int(rng.integers(2, 4))
    w1 = (rng.normal(size=(co, ci, k, k)) * 0.5).astype(np.float32)
    if rng.random() < 0.5:      # sparse conv exercises sparse iteration
        w1 *= (rng.random(w1.shape) < 0.4)
    layers = [Conv2D(w1, rng.normal(size=co).astype(np.float32))]
    oh = h - k + 1
    if oh % 2 == 0 and rng.random() < 0.7:
        layers.append(MaxPool2D(2))
        oh //= 2
    feat = co * oh * oh
    m = int(rng.integers(4, 9))
    layers.append(DenseFC((rng.normal(size=(m, feat)) * 0.2
                           ).astype(np.float32),
                          rng.normal(size=m).astype(np.float32)))
    out = int(rng.integers(3, 6))
    wsp = (rng.normal(size=(out, m)) * (rng.random((out, m)) < 0.4)
           ).astype(np.float32)
    layers.append(SparseFC(wsp, rng.normal(size=out).astype(np.float32),
                           relu=False))
    net = SimNet(layers, input_shape=(ci, h, h), name=f"rand{seed}")
    x = rng.normal(size=(ci, h, h)).astype(np.float32)
    return net, x


@pytest.fixture(params=NET_SEEDS)
def seeded_net(request):
    return make_random_net(request.param)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; each test skips without one")
