"""The port's ``repro_torch.kernels`` entry points against the JAX package's
``repro.kernels`` on the CPU.

On CPU tensors the port's wrappers take their kernels' plain PyTorch
versions; the JAX side runs its Pallas kernels in interpret mode, as its own
tests do.  Inputs are made by numpy from a seed and handed to both.
Tolerances: the f32 products are those of ``tests/test_kernels.py``
(rtol = atol = 2e-4: the sums are taken in another order); bf16 that test's
3e-2, one bf16 rounding of an O(1) output; the block-CSR bundles, the
pruning and the FIR against its own plain oracle are exact.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import prune as jprune
from repro.kernels import BlockSparseFC as JaxBlockSparseFC
from repro.kernels import MatmulTiles as JaxTiles
from repro.kernels import dense_matmul as jax_dense_matmul
from repro.kernels import fir_conv1d as jax_fir
from repro.kernels import ref as jref
from repro_torch.compress import prune as tprune
from repro_torch.convert import (block_sparse_fc_fields,
                                 block_sparse_fc_from_numpy)
from repro_torch.kernels import (BlockSparseFC, MatmulTiles, calibrate,
                                 dense_matmul, fir_conv1d, fir_tiles,
                                 matmul_tiles, ref)
from repro_torch.kernels.sparse_fc import (block_sparse_matvec_plain,
                                           to_block_csr)

TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
CPU = torch.device("cpu")


def _module(name):
    """A kernel module by its full path (the package exports functions
    named ``dense_matmul`` and ``fir_conv1d``)."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _launches():
    return (_module("dense_matmul").matmul.launches,
            _module("sparse_fc").block_sparse_matvec.launches,
            _module("fir_conv1d").fir_conv1d.launches)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def _checkerboard(n, blk, rng):
    w = rng.normal(size=(n, n)).astype(np.float32)
    for i in range(n // blk):
        for j in range(n // blk):
            if (i + j) % 2:
                w[i * blk:(i + 1) * blk, j * blk:(j + 1) * blk] = 0
    return w


# --------------------------------------------------------------------------
# dense matmul
# --------------------------------------------------------------------------

def test_dense_matmul_fixed_case():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(13, 57)).astype(np.float32)
    w = rng.normal(size=(57, 31)).astype(np.float32)
    want = np.asarray(jax_dense_matmul(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True))
    got = dense_matmul(_t(x), _t(w))
    assert got.dtype == torch.float32 and got.shape == (13, 31)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("tiles", [(8, 128, 128), (16, 256, 128)])
def test_dense_matmul_explicit_tiles(tiles):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 512)).astype(np.float32)
    w = rng.normal(size=(512, 384)).astype(np.float32)
    want = np.asarray(jax_dense_matmul(jnp.asarray(x), jnp.asarray(w),
                                       tiles=JaxTiles(*tiles),
                                       interpret=True))
    got = dense_matmul(_t(x), _t(w), tiles=MatmulTiles(*tiles))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(13, 57, 31), (1, 1, 1), (40, 9, 70)])
def test_dense_matmul_bf16(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * 7919 + k * 31 + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    want = jax_dense_matmul(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(w, jnp.bfloat16), interpret=True)
    got = dense_matmul(_t(x, torch.bfloat16), _t(w, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)


@pytest.mark.parametrize("tiles", [(12, 64, 64), (8, 0, 8), (256, 32, 128),
                                   (128, 4096, 128)])
def test_dense_matmul_refuses_tiles_the_kernel_cannot_take(tiles):
    x, w = torch.ones(16, 32), torch.ones(32, 16)
    with pytest.raises(ValueError, match="tiles"):
        dense_matmul(x, w, tiles=MatmulTiles(*tiles))


def test_cpu_tensors_take_the_plain_versions():
    """CPU tensors reach the plain versions, which launch nothing."""
    before = _launches()
    x = torch.randn(9, 20)
    assert torch.equal(dense_matmul(x, torch.ones(20, 3)),
                       ref.matmul_ref(x, torch.ones(20, 3)))
    fc = BlockSparseFC(np.ones((5, 20), np.float32), device="cpu")
    fc(x)
    taps = torch.randn(9, 4)
    assert torch.equal(fir_conv1d(x, taps), ref.fir_conv1d_ref(x, taps))
    assert _launches() == before


# --------------------------------------------------------------------------
# block-sparse FC
# --------------------------------------------------------------------------

def _bundles(seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(300, 200)).astype(np.float32)
    w[:, 60:] *= rng.random((300, 140)) < 0.05
    w[128:256] = 0
    return {"checkerboard": (_checkerboard(512, 128, rng), 128, 128),
            "ragged": (w, 128, 128), "small-blocks": (w, 64, 32)}


@pytest.mark.parametrize("case", ["checkerboard", "ragged", "small-blocks"])
def test_block_csr_bundle_equals_jax(case):
    w, bm, bk = _bundles(3)[case]
    jfc = JaxBlockSparseFC(w, bm=bm, bk=bk)
    tfc = BlockSparseFC(w, bm=bm, bk=bk, device="cpu")
    for name in ("vals", "row_ptr", "col_idx"):
        a, b = np.asarray(getattr(jfc, name)), getattr(tfc, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (tfc.padded_m, tfc.padded_k) == (jfc.padded_m, jfc.padded_k)
    assert tfc.density == jfc.density


def test_block_sparse_skips_zero_blocks():
    rng = np.random.default_rng(5)
    w = rng.normal(size=(512, 512)).astype(np.float32)
    w[128:, :] = 0          # 3 of 4 row-blocks empty
    w[:128, 256:] = 0       # half the remaining row pruned
    fc = BlockSparseFC(w, device="cpu")
    assert fc.vals.shape[0] == 2 + 3   # 2 real + 3 padding blocks
    x = rng.normal(size=(8, 512)).astype(np.float32)
    want = np.asarray(JaxBlockSparseFC(w)(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(fc(_t(x)).numpy(), want, **TOL)


@pytest.mark.parametrize("batch", [1, 7, 17])
def test_block_sparse_batches_not_multiple_of_bn(batch):
    w, bm, bk = _bundles(4)["ragged"]
    x = np.random.default_rng(batch).normal(size=(batch, 200)).astype(
        np.float32)
    want = np.asarray(JaxBlockSparseFC(w, bm=bm, bk=bk)(jnp.asarray(x),
                                                        interpret=True))
    got = BlockSparseFC(w, bm=bm, bk=bk, device="cpu")(_t(x))
    assert got.shape == (batch, 300)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        got.numpy(), jref.block_sparse_matvec_ref(jnp.asarray(x), w), **TOL)


def test_block_sparse_plain_sums_blocks_that_share_a_position():
    """The plain version on a raw bundle sums repeated blocks, as the
    kernel's walk over ``row_ptr`` does."""
    vals = torch.ones(3, 2, 2)
    row_ptr = torch.tensor([0, 2, 3], dtype=torch.int32)
    col_idx = torch.tensor([0, 0, 1], dtype=torch.int32)
    y = block_sparse_matvec_plain(torch.ones(1, 4), vals, row_ptr, col_idx,
                                  4, bm=2, bk=2)
    assert y.tolist() == [[4.0, 4.0, 2.0, 2.0]]


def test_block_sparse_refuses_bad_layers():
    w = np.ones((10, 10), np.float32)
    with pytest.raises(ValueError, match="bn"):
        BlockSparseFC(w, bn=3, device="cpu")
    fc = BlockSparseFC(w, device="cpu")
    with pytest.raises(ValueError, match="activations"):
        fc(torch.ones(2, 9))
    with pytest.raises(ValueError, match="bundle"):
        BlockSparseFC.from_block_csr(fc.vals, fc.row_ptr, fc.col_idx + 1,
                                     10, 10, 128, 128, device="cpu")


# --------------------------------------------------------------------------
# FIR conv1d
# --------------------------------------------------------------------------

@pytest.mark.parametrize("c,length,k", [(37, 101, 7), (5, 12, 1),
                                        (5, 12, 12), (3, 300, 70),
                                        (1, 1, 1)])
def test_fir_conv1d_matches_jax(c, length, k):
    rng = np.random.default_rng(c * 31 + length)
    x = rng.normal(size=(c, length)).astype(np.float32)
    taps = rng.normal(size=(c, k)).astype(np.float32)
    want = np.asarray(jax_fir(jnp.asarray(x), jnp.asarray(taps),
                              interpret=True))
    got = fir_conv1d(_t(x), _t(taps))
    assert got.shape == (c, length - k + 1)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same order of operations as the JAX package's numpy oracle
    np.testing.assert_array_equal(got.numpy(),
                                  jref.fir_conv1d_ref(x, taps))


def _conv_by_fir(fir, x, filt):
    """TAILS's composition: x (B, ci, h, w), filt (co, ci, kh, kw) ->
    (B, co, ho, wo), one FIR per (ci, dy) over the B * co * ho rows."""
    b, ci, h, w_ = x.shape
    co, _, kh, kw = filt.shape
    ho, wo = h - kh + 1, w_ - kw + 1
    out = np.zeros((b, co, ho, wo), np.float32)
    for c in range(ci):
        for dy in range(kh):
            rows = np.broadcast_to(x[:, None, c, dy:dy + ho, :],
                                   (b, co, ho, w_)).reshape(-1, w_)
            taps = np.broadcast_to(filt[None, :, c, dy, None, :],
                                   (b, co, ho, kw)).reshape(-1, kw)
            out += np.asarray(fir(np.ascontiguousarray(rows),
                                  np.ascontiguousarray(taps))
                              ).reshape(b, co, ho, wo)
    return out


def _port_fir(rows, taps):
    return fir_conv1d(_t(rows), _t(taps)).numpy()


def _jax_fir(rows, taps):
    return jax_fir(jnp.asarray(rows), jnp.asarray(taps), interpret=True)


def test_fir_composes_2d_convolution():
    rng = np.random.default_rng(9)
    ci, h, w_, kh, kw = 3, 12, 16, 3, 5
    x = rng.normal(size=(1, ci, h, w_)).astype(np.float32)
    filt = rng.normal(size=(1, ci, kh, kw)).astype(np.float32)
    ho, wo = h - kh + 1, w_ - kw + 1
    want = np.zeros((ho, wo), np.float32)
    for c in range(ci):
        for dy in range(kh):
            for dx in range(kw):
                want += filt[0, c, dy, dx] * x[0, c, dy:dy + ho, dx:dx + wo]
    got = _conv_by_fir(_port_fir, x, filt)[0, 0]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got, _conv_by_fir(_jax_fir, x, filt)[0, 0],
                               **TOL)


# --------------------------------------------------------------------------
# calibration (its numbers differ from the JAX package's by design)
# --------------------------------------------------------------------------

BUDGETS = (4 << 10, 16 << 10, calibrate.SMEM_BUDGET_BYTES,
           calibrate.SMEM_MAX_BYTES)


@pytest.mark.parametrize("bytes_per_el", [4, 2])
@pytest.mark.parametrize("dims", [(8192, 8192, 8192), (13, 57, 31),
                                  (1, 1, 1), (4096, 200, 10)])
def test_matmul_tiles_fit_budget_align_and_grow(dims, bytes_per_el):
    prev = None
    for budget in BUDGETS:
        t = matmul_tiles(*dims, bytes_per_el=bytes_per_el, budget=budget)
        assert t.working_set(bytes_per_el) <= budget
        assert t.bm % calibrate.TILE == 0 and t.bn % calibrate.TILE == 0
        assert t.bk % calibrate.TILE == 0
        assert t.threads <= calibrate.MATMUL_MAX_THREADS
        # no tile is wider than the (aligned) matrix
        m, k, n = dims
        assert t.bm <= max(8, -(-m // 8) * 8) and t.bn <= max(8, -(-n // 8) * 8)
        # a larger budget never picks smaller tiles
        if prev is not None:
            assert (t.bm, t.bk, t.bn) >= (prev.bm, prev.bk, prev.bn)
            assert t.bm >= prev.bm and t.bk >= prev.bk and t.bn >= prev.bn
        prev = t
    big = matmul_tiles(8192, 8192, 8192, bytes_per_el=bytes_per_el)
    assert (big.bm, big.bn) == (calibrate.MAX_BMN, calibrate.MAX_BMN)


@pytest.mark.parametrize("channels,length", [(8192, 8192), (819200, 12),
                                             (1, 1), (37, 101)])
def test_fir_tiles_fit_budget_and_fill_a_block(channels, length):
    tw = calibrate.fir_width(length)
    assert calibrate.WARP <= tw <= calibrate.FIR_THREADS
    assert tw >= min(length, calibrate.FIR_THREADS)
    prev = 0
    for budget in BUDGETS:
        cb = fir_tiles(channels, length, budget=budget)
        assert 1 <= cb * tw <= calibrate.FIR_THREADS
        assert cb <= max(1, 2 * channels)
        assert cb == 1 or calibrate.fir_working_set(cb, tw) <= budget
        assert cb >= prev
        prev = cb


# --------------------------------------------------------------------------
# carried across, pruned, and chained
# --------------------------------------------------------------------------

def test_convert_carries_a_jax_block_sparse_fc():
    w, bm, bk = _bundles(6)["small-blocks"]
    jfc = JaxBlockSparseFC(w, bm=bm, bk=bk, bn=4)
    fields = block_sparse_fc_fields(jfc)
    assert set(fields) == {"vals", "row_ptr", "col_idx", "m", "k", "bm",
                           "bk", "bn"}
    tfc = block_sparse_fc_from_numpy(fields, device="cpu")
    for name in ("vals", "row_ptr", "col_idx"):
        np.testing.assert_array_equal(getattr(tfc, name),
                                      np.asarray(getattr(jfc, name)))
    assert (tfc.m, tfc.k, tfc.bm, tfc.bk, tfc.bn) == (300, 200, bm, bk, 4)
    x = np.random.default_rng(1).normal(size=(6, 200)).astype(np.float32)
    np.testing.assert_allclose(
        tfc(_t(x)).numpy(), np.asarray(jfc(jnp.asarray(x), interpret=True)),
        **TOL)
    fields["vals"][0] += 1.0          # the port's bundle is a copy
    assert not np.array_equal(fields["vals"], tfc.vals)


@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.9, 1.0])
def test_prune_matches_jax(sparsity):
    w = np.random.default_rng(2).normal(size=(64, 48)).astype(np.float32)
    got, want = (tprune.prune_by_sparsity(w, sparsity),
                 jprune.prune_by_sparsity(w, sparsity))
    np.testing.assert_array_equal(got, want)
    assert tprune.sparsity_of(got) == jprune.sparsity_of(want)
    assert tprune.nnz(got) == jprune.nnz(want)
    np.testing.assert_array_equal(tprune.prune_by_threshold(w, 0.5),
                                  jprune.prune_by_threshold(w, 0.5))


def test_two_layer_chain_matches_jax():
    """FIR conv -> ReLU -> block-sparse FC -> ReLU -> dense FC, through the
    port's entry points and through ``repro.kernels``."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(2, 2, 10, 10)).astype(np.float32)
    filt = (rng.normal(size=(3, 2, 3, 3)) / 3).astype(np.float32)
    w1 = tprune.prune_by_sparsity(
        (rng.normal(size=(150, 192)) / 14).astype(np.float32), 0.7)
    w2 = (rng.normal(size=(150, 5)) / 12).astype(np.float32)

    h = np.maximum(_conv_by_fir(_port_fir, x, filt), 0).reshape(2, -1)
    h = torch.relu(BlockSparseFC(w1, device="cpu")(_t(h)))
    got = dense_matmul(h, _t(w2)).numpy()

    hj = np.maximum(_conv_by_fir(_jax_fir, x, filt), 0).reshape(2, -1)
    hj = jnp.maximum(JaxBlockSparseFC(w1)(jnp.asarray(hj), interpret=True),
                     0)
    want = np.asarray(jax_dense_matmul(hj, jnp.asarray(w2), interpret=True))
    assert got.shape == (2, 5)
    np.testing.assert_allclose(got, want, **TOL)


def test_ref_matches_jax_ref():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(6, 40)).astype(np.float32)
    w = rng.normal(size=(40, 9)).astype(np.float32)
    wd = rng.normal(size=(7, 40)).astype(np.float32)
    taps = rng.normal(size=(6, 4)).astype(np.float32)
    np.testing.assert_allclose(ref.matmul_ref(_t(x), _t(w)).numpy(),
                               np.asarray(jref.matmul_ref(jnp.asarray(x),
                                                          jnp.asarray(w))),
                               **TOL)
    np.testing.assert_allclose(
        ref.block_sparse_matvec_ref(_t(x), wd).numpy(),
        np.asarray(jref.block_sparse_matvec_ref(jnp.asarray(x), wd)), **TOL)
    np.testing.assert_array_equal(ref.fir_conv1d_ref(_t(x), _t(taps)).numpy(),
                                  jref.fir_conv1d_ref(x, taps))
    vals, row_ptr, col_idx = to_block_csr(np.pad(wd, ((0, 1), (0, 0))), 8, 8)
    np.testing.assert_allclose(
        block_sparse_matvec_plain(_t(x), _t(vals), torch.tensor(row_ptr),
                                  torch.tensor(col_idx), 7, bm=8, bk=8),
        ref.block_sparse_matvec_ref(_t(x), wd), **TOL)
