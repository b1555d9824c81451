"""The port's cluster runtime models and int8 gradient compression
(``repro_torch.runtime``: ``simulate``, stragglers, elastic rescale;
``repro_torch.optim.compress_grads``) against the JAX package's, on the
CPU.

The runtime models are numpy and pure Python in both packages, so every
result is equal.  The compression runs the same f32 operations in the
same order (max-abs / 127, round half to even, clip, int8), so the int8
values, the scales and the dequantized values are bitwise equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim.compress_grads as jcg
import repro.runtime as jrt
import repro_torch.optim.compress_grads as tcg
import repro_torch.runtime as trt

JOB = dict(total_steps=40, step_s=60.0, microbatches=8, mb_commit_s=0.5)


@pytest.mark.parametrize("policy,interval", [
    ("naive", 1), ("interval", 2), ("interval", 10), ("continuation", 5)])
def test_simulate_matches_jax(policy, interval):
    for seed in range(3):
        got = trt.simulate(policy, trt.FleetSpec(2000, 30 * 86400),
                           trt.JobSpec(**JOB), interval=interval, seed=seed,
                           horizon_factor=50)
        want = jrt.simulate(policy, jrt.FleetSpec(2000, 30 * 86400),
                            jrt.JobSpec(**JOB), interval=interval,
                            seed=seed, horizon_factor=50)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.goodput == want.goodput
        assert got.wall_s == pytest.approx(
            got.useful_s + got.wasted_s + got.overhead_s, rel=1e-9)


def test_failure_times_match_jax():
    got = trt.failures._failure_times(trt.FleetSpec(500, 86400.0), 1e4, 7)
    want = jrt.failures._failure_times(jrt.FleetSpec(500, 86400.0), 1e4, 7)
    assert got == want and len(got) > 10


@pytest.mark.parametrize("policy", ["sync", "backup", "quorum"])
def test_straggler_efficiency_matches_jax(policy):
    spec = dict(n_hosts=64, slow_frac=0.02)
    got = trt.efficiency(policy, trt.StragglerSpec(**spec), steps=200)
    want = jrt.efficiency(policy, jrt.StragglerSpec(**spec), steps=200)
    assert got == want
    times = trt.host_times(trt.StragglerSpec(**spec), 20, seed=3)
    np.testing.assert_array_equal(
        times, jrt.host_times(jrt.StragglerSpec(**spec), 20, seed=3))
    np.testing.assert_array_equal(trt.step_times(policy, times),
                                  jrt.step_times(policy, times))
    with pytest.raises(ValueError):
        trt.step_times("none", times)


def test_elastic_matches_jax():
    assert trt.choose_mesh(255, tp=16) == trt.MeshChoice(15, 16)
    assert trt.choose_mesh(15, tp=16) is None
    raw = [(0, 256), (1000, 240), (2000, 15), (2500, 256), (3000, 256)]
    for rescale_s in (300.0, 5000.0):
        got = trt.simulate_elastic([trt.ElasticEvent(*e) for e in raw],
                                   tp=16, step_s=2.0, horizon_s=4000,
                                   rescale_s=rescale_s)
        want = jrt.simulate_elastic([jrt.ElasticEvent(*e) for e in raw],
                                    tp=16, step_s=2.0, horizon_s=4000,
                                    rescale_s=rescale_s)
        assert got == want
        assert got["work_s"] + got["idle_s"] == pytest.approx(got["wall_s"])


@pytest.mark.parametrize("n", [1, 255, 256, 1000])
def test_int8_compression_bitwise_to_jax(n):
    rng = np.random.default_rng(n)
    g = (rng.normal(size=(n,)) * 0.01).astype(np.float32)
    g[: n // 3] *= 1e3                       # blocks of different scales
    q, s, m = tcg.compress_int8(torch.from_numpy(g))
    jq, js, jm = jcg.compress_int8(jnp.asarray(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert m == jm == n
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    d = tcg.decompress_int8(q, s, m, g.shape)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jcg.decompress_int8(jq, js, jm, g.shape)))
    assert float((d - torch.from_numpy(g)).abs().max()) <= \
        float(s.max()) / 2 + 1e-12


def test_compress_tree_with_error_feedback_bitwise_to_jax():
    rng = np.random.default_rng(2)
    tree = {"w": rng.normal(size=(3, 100)).astype(np.float32),
            "layers": [rng.normal(size=(300,)).astype(np.float32)]}
    ttree = {"w": torch.from_numpy(tree["w"]),
             "layers": [torch.from_numpy(tree["layers"][0])]}
    jtree = {"w": jnp.asarray(tree["w"]),
             "layers": [jnp.asarray(tree["layers"][0])]}
    tef = jef = None
    for _ in range(2):                    # the second step folds residuals
        tp, tef = tcg.compress_tree(ttree, tef)
        jp, jef = jcg.compress_tree(jtree, jef)
        for got, want in ((tp["w"], jp["w"]),
                          (tp["layers"][0], jp["layers"][0])):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            assert got[2] == want[2]
        np.testing.assert_array_equal(tef.residual["w"].numpy(),
                                      np.asarray(jef.residual["w"]))
    shapes = {"w": (3, 100), "layers": [(300,)]}
    td = tcg.decompress_tree(tp, shapes)
    jd = jcg.decompress_tree(jp, shapes)
    np.testing.assert_array_equal(td["w"].numpy(), np.asarray(jd["w"]))
    np.testing.assert_array_equal(td["layers"][0].numpy(),
                                  np.asarray(jd["layers"][0]))


def test_compressed_allreduce_ref_bitwise_to_jax():
    rng = np.random.default_rng(1)
    grads = [rng.normal(size=(512,)).astype(np.float32) for _ in range(4)]
    got = tcg.compressed_allreduce_ref([torch.from_numpy(g) for g in grads])
    want = jcg.compressed_allreduce_ref([jnp.asarray(g) for g in grads])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    exact = np.mean(grads, axis=0)
    assert np.abs(got.numpy() - exact).max() < \
        0.02 * np.abs(exact).max() + 1e-3
