"""The port's ``repro_torch.kernels`` entry points against the JAX package's
``repro.kernels`` on the CPU.

On CPU tensors the port's wrappers take their kernels' plain PyTorch
versions; the JAX side runs its Pallas kernels in interpret mode, as its own
tests do.  Inputs are made by numpy from a seed and handed to both.
Tolerances: the f32 products and attention are those of
``tests/test_kernels.py`` (rtol = atol = 2e-4: the sums are taken in
another order); bf16 that test's 3e-2, one bf16 rounding of an O(1) output;
the block-sparse FC with a bf16 output one bf16 unit (both sum in f32 and
round once); the SSD cell that test's rtol 3e-4, atol 3e-5, and with bf16
inputs max |d| <= 1e-5 max |ref|; the block-CSR bundles, the pruning and
the FIR (also in bf16) are exact.
"""

import functools
import importlib
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.compress import prune as jprune
from repro.kernels import BlockSparseFC as JaxBlockSparseFC
from repro.kernels import MatmulTiles as JaxTiles
from repro.kernels import dense_matmul as jax_dense_matmul
from repro.kernels import fir_conv1d as jax_fir
from repro.kernels import flash_attention as jax_flash
from repro.kernels import ssd_intra as jax_ssd
from repro.models import layers as jlayers
from repro.models.config import ModelConfig as JaxModelConfig
from repro.kernels import ref as jref
from repro_torch.compress import prune as tprune
from repro_torch.convert import (block_sparse_fc_fields,
                                 block_sparse_fc_from_numpy)
from repro_torch.kernels import (BlockSparseFC, MatmulTiles, calibrate,
                                 dense_matmul, fir_conv1d, fir_tiles,
                                 flash_attention, matmul_tiles, ref,
                                 ssd_intra)
from repro_torch.models import layers as tlayers
from repro_torch.models.config import ModelConfig
from repro_torch.kernels.sparse_fc import (block_sparse_matvec_plain,
                                           to_block_csr)
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ssd_intra import SSDIntraFunction

TOL = dict(rtol=2e-4, atol=2e-4)
#: numpy's bf16 (the JAX package's, from ml_dtypes) and the test's names
#: for the two dtypes on each side.
NP_BF16 = ml_dtypes.bfloat16
DTYPES = {"f32": (np.float32, torch.float32), "bf16": (NP_BF16, torch.bfloat16)}
BF16_TOL = dict(rtol=3e-2, atol=3e-2)
CPU = torch.device("cpu")


def _module(name):
    """A kernel module by its full path (the package exports functions
    named ``dense_matmul`` and ``fir_conv1d``)."""
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _launches():
    return (_module("dense_matmul").matmul.launches,
            _module("sparse_fc").block_sparse_matvec.launches,
            _module("fir_conv1d").fir_conv1d.launches,
            _module("flash_attention").flash_attention.launches,
            _module("ssd_intra").ssd_intra.launches)


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


@pytest.mark.parametrize("x_dtype,w_dtype", [("f32", "bf16"), ("bf16", "f32")])
@pytest.mark.parametrize("shape", [(13, 57, 31), (128, 256, 192)])
def test_dense_matmul_mixed_dtypes_match_jax(shape, x_dtype, w_dtype):
    """One f32 and one bf16 operand: computed in f32, as JAX promotes the
    pair, and returned in x's dtype, as the Pallas kernel's output."""
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    (xn, xt), (wn, wt) = DTYPES[x_dtype], DTYPES[w_dtype]
    x = rng.normal(size=(m, k)).astype(np.float32).astype(xn)
    w = rng.normal(size=(k, n)).astype(np.float32).astype(wn)
    want = np.asarray(jax_dense_matmul(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True))
    got = dense_matmul(_t(x, xt), _t(w, wt))
    assert got.dtype == xt and want.dtype == xn
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32),
                               **(TOL if x_dtype == "f32" else BF16_TOL))


@pytest.mark.parametrize("tiles", [(12, 64, 64), (8, 0, 8), (256, 32, 128),
                                   (128, 4096, 128)])
def test_dense_matmul_refuses_tiles_the_kernel_cannot_take(tiles):
    x, w = torch.ones(16, 32), torch.ones(32, 16)
    with pytest.raises(ValueError, match="tiles"):
        dense_matmul(x, w, tiles=MatmulTiles(*tiles))


# the narrow kernel (N up to NARROW_MAX_N where no tensor-core kernel
# reads the operands): (m, k, n), dtype, x offset in elements, the path
_NARROW_PATHS = {
    "f32 fc3": ((1024, 500, 10), torch.float32, 0, "narrow"),
    "f32 N = 1": ((7, 33, 1), torch.float32, 0, "narrow"),
    "f32 N = 17, ragged": ((13, 57, 17), torch.float32, 0, "narrow"),
    "f32 N at the threshold, x misaligned": ((64, 64, 64), torch.float32,
                                             1, "narrow"),
    "f32 N past the threshold": ((64, 63, 65), torch.float32, 0, "simt"),
    "f32 N = 16, aligned": ((64, 64, 16), torch.float32, 0, "tf32x3"),
    "f32 N = 64, aligned": ((64, 64, 64), torch.float32, 0, "tf32x3"),
    "bf16 N = 10": ((1024, 500, 10), torch.bfloat16, 0, "narrow"),
    "bf16 N = 16, aligned": ((64, 64, 16), torch.bfloat16, 0, "wgmma"),
    "bf16 N = 64, K = 60": ((64, 60, 64), torch.bfloat16, 0, "narrow"),
    "f32 K = 0": ((8, 0, 10), torch.float32, 0, "simt"),
    "f32 M = 0": ((0, 8, 10), torch.float32, 0, "simt"),
}


@pytest.mark.parametrize("case", sorted(_NARROW_PATHS))
def test_matmul_path_takes_narrow_below_the_threshold(case):
    """``matmul_path`` sends N up to ``NARROW_MAX_N`` to the narrow kernel
    only where neither tensor-core kernel reads the operands: those keep
    their path, and wider N stays on the CUDA cores."""
    (m, k, n), dtype, off, want = _NARROW_PATHS[case]
    mod = _module("dense_matmul")
    x = torch.zeros(m * k + off, dtype=dtype)[off:].view(m, k)
    w = torch.zeros(k, n, dtype=dtype)
    assert mod.matmul_path(x, w) == want


@pytest.mark.parametrize("n", [1, 10, 17])
@pytest.mark.parametrize("m,k", [(13, 57), (130, 300), (1, 5)])
def test_narrow_order_matches_jax(m, k, n):
    """The narrow kernel's sum (each output over K in order, one
    multiply-add a term: ``ref.matmul_in_order``) against the Pallas
    kernel in interpret mode, ragged M and K, within tests/test_kernels.py's
    f32 tolerance."""
    rng = np.random.default_rng(m * k + n)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = rng.normal(size=(k, n)).astype(np.float32)
    want = np.asarray(jax_dense_matmul(jnp.asarray(x), jnp.asarray(w),
                                       interpret=True))
    got = ref.matmul_in_order(_t(x), _t(w))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("m,k,n,size,bm,bk", [
    (1024, 500, 10, 4, 8, 500),     # MNIST's fc3: 128 CTAs, K in one slice
    (1024, 500, 10, 2, 8, 500),
    (1024, 4096, 64, 4, 8, 170),    # two stages of 8 + 64 rows fill 96 KB
    (13, 57, 31, 4, 1, 57),
    (100000, 64, 64, 4, 16, 64),    # bm capped by the threads (1024 // 64)
    (100000, 64, 1, 4, 64, 64)])    # ... and by NARROW_MAX_ROWS
def test_narrow_plan(m, k, n, size, bm, bk):
    """The narrow kernel's plan: rows of x a CTA covering the card in one
    wave where M allows (at most 64, a thread an output up to 1024), K
    slices as long as two stages allow in 96 KB."""
    mod = _module("dense_matmul")
    plan = mod.narrow_plan(m, k, n, size)
    assert plan == (bm, bk)
    assert plan.bm * n <= mod.NARROW_MAX_THREADS
    assert 2 * size * (plan.bm * (plan.bk + 1) + plan.bk * n) \
        <= mod.NARROW_SMEM_MAX
    if plan.bm < min(mod.NARROW_MAX_ROWS, mod.NARROW_MAX_THREADS // n):
        assert -(-m // plan.bm) <= mod.SMS


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
    q = torch.randn(1, 2, 5, 8)
    flash_attention(q, q, q)
    xdt = torch.randn(1, 2, 4, 3)
    cs = torch.randn(1, 2, 4)
    bb = torch.randn(1, 4, 5)
    assert all(torch.equal(a, b) for a, b in zip(
        ssd_intra(xdt, bb, bb, cs), ref.ssd_intra_ref(xdt, bb, bb, cs)))
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


def _bf16_units(got, want):
    """|got - want| in units of the last place of bf16 at ``want``."""
    w = np.abs(np.asarray(want, np.float32))
    ulp = np.exp2(np.floor(np.log2(np.maximum(w, 2.0 ** -100))) - 7)
    return np.abs(np.asarray(got, np.float32) - want.astype(np.float32)) / ulp


@pytest.mark.parametrize("case", ["ragged", "small-blocks"])
@pytest.mark.parametrize("x_dtype,w_dtype", [("bf16", "f32"), ("f32", "bf16"),
                                             ("bf16", "bf16")])
def test_block_sparse_bf16_matches_jax(case, x_dtype, w_dtype):
    """A bf16 activation, a bf16 master weight, or both: the output has the
    JAX package's dtype (x's), the layer keeps its weight's dtype, and the
    values agree with the Pallas kernel in interpret mode within one bf16
    unit (a bf16 output) or at the f32 tolerance."""
    w, bm, bk = _bundles(8)[case]
    (xn, xt), (wn, wt) = DTYPES[x_dtype], DTYPES[w_dtype]
    x = np.random.default_rng(2).normal(size=(17, w.shape[1])).astype(
        np.float32)
    jfc = JaxBlockSparseFC(w.astype(wn), bm=bm, bk=bk)
    want = np.asarray(jfc(jnp.asarray(x.astype(xn)), interpret=True))
    tfc = BlockSparseFC(w.astype(wn), bm=bm, bk=bk, device="cpu")
    assert tfc._bundle[0].dtype == wt and tfc.vals.dtype == wn
    got = tfc(_t(x, xt))
    assert got.dtype == xt and want.dtype == xn and got.shape == want.shape
    if x_dtype == "bf16":
        assert _bf16_units(got.float().numpy(), want).max() <= 1.0
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_convert_carries_a_jax_bf16_block_sparse_fc():
    """A JAX layer on a bf16 master weight reaches the port with the same
    16-bit words, read without ``ml_dtypes``, and computes in bf16."""
    w, bm, bk = _bundles(9)["ragged"]
    jfc = JaxBlockSparseFC(w.astype(NP_BF16), bm=bm, bk=bk)
    fields = block_sparse_fc_fields(jfc)
    assert fields["vals"].dtype.name == "bfloat16"
    tfc = block_sparse_fc_from_numpy(fields, device="cpu")
    vals = tfc._bundle[0]
    assert vals.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        vals.view(torch.int16).numpy().view(np.uint16),
        np.asarray(jfc.vals).view(np.uint16))
    x = np.random.default_rng(3).normal(size=(5, 200)).astype(np.float32)
    want = np.asarray(jfc(jnp.asarray(x.astype(NP_BF16)), interpret=True))
    got = tfc(_t(x, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    assert _bf16_units(got.float().numpy(), want).max() <= 1.0


def test_block_sparse_takes_torch_bf16_values_as_they_are():
    """A bundle whose values are a torch bf16 tensor keeps them bf16."""
    w, bm, bk = _bundles(10)["ragged"]
    ref_fc = BlockSparseFC(w.astype(NP_BF16), bm=bm, bk=bk, device="cpu")
    vals = ref_fc._bundle[0].clone()
    fc = BlockSparseFC.from_block_csr(vals, ref_fc.row_ptr, ref_fc.col_idx,
                                      300, 200, bm, bk, device="cpu")
    assert fc._bundle[0].dtype == torch.bfloat16
    assert torch.equal(fc._bundle[0], vals)
    x = _t(np.random.default_rng(4).normal(size=(3, 200)), torch.bfloat16)
    assert torch.equal(fc(x), ref_fc(x))


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


@pytest.mark.parametrize("x_dtype,taps_dtype", [("bf16", "bf16"),
                                                ("bf16", "f32"),
                                                ("f32", "bf16")])
@pytest.mark.parametrize("c,length,k", [(37, 101, 7), (5, 12, 1),
                                        (5, 12, 12), (3, 300, 70),
                                        (1, 1, 1)])
def test_fir_conv1d_bf16_matches_jax_bitwise(c, length, k, x_dtype,
                                             taps_dtype):
    """bf16 x and/or taps: widened, summed in f32 in tap order, rounded
    once to x's dtype.  A bf16 output is bit for bit the Pallas kernel's;
    an f32 one is within the f32 tolerance of it (its CPU backend may fuse
    a multiply and an add) and bit for bit the JAX package's numpy oracle,
    as in ``test_fir_conv1d_matches_jax``."""
    rng = np.random.default_rng(c * 37 + length + k)
    (xn, xt), (tn, tt) = DTYPES[x_dtype], DTYPES[taps_dtype]
    x = rng.normal(size=(c, length)).astype(np.float32).astype(xn)
    taps = rng.normal(size=(c, k)).astype(np.float32).astype(tn)
    want = np.asarray(jax_fir(jnp.asarray(x), jnp.asarray(taps),
                              interpret=True))
    got = fir_conv1d(_t(x, xt), _t(taps, tt))
    assert got.dtype == xt and want.dtype == xn
    if x_dtype == "bf16":
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            want.view(np.uint16))
    else:
        np.testing.assert_allclose(got.numpy(), want, **TOL)
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


def _flat_fir(x, taps, out_dtype):
    """x (C, L) and taps (C, K), numpy f32 (values of out_dtype's inputs),
    through the flat FIR kernel's index arithmetic (csrc/fir_conv1d.cu's
    flat_tile and fir_flat_kernel): tiles of FLAT_OUT_BYTES of output in
    flat order, each tile's input and tap spans staged from the flat arrays
    rounded out to 16 bytes (and checked against the stage), thread t's
    outputs t, t + 256, .. found by one division and then steps of 256 //
    (L-K+1) rows and 256 % (L-K+1) positions, each summed in tap order from
    0 with one f32 rounding per multiply and per add; the output in
    out_dtype (numpy f32 or ml_dtypes bf16)."""
    fmod = _module("fir_conv1d")
    c, length = x.shape
    k = taps.shape[1]
    lo = length - k + 1
    sx = np.dtype(out_dtype).itemsize
    st = 2 if taps.dtype == NP_BF16 else 4
    t_out = fmod.FLAT_OUT_BYTES // sx
    xf, tf = x.astype(np.float32).ravel(), taps.astype(np.float32).ravel()
    total = c * lo
    out = np.empty(total, np.float32)
    step_row, step_pos = 256 // lo, 256 % lo
    for tile in range(-(-total // t_out)):
        o0 = tile * t_out
        n = min(t_out, total - o0)
        r0, p0 = divmod(o0, lo)
        r1, p1 = divmod(o0 + n - 1, lo)
        in_b0 = (r0 * length + p0) * sx // 16 * 16
        in_b1 = -(-((r1 * length + p1 + k) * sx) // 16) * 16
        tap_b0 = r0 * k * st // 16 * 16
        tap_b1 = -(-((r1 + 1) * k * st) // 16) * 16
        assert in_b1 - in_b0 <= fmod.FLAT_IN_BYTES
        assert tap_b1 - tap_b0 <= fmod.FLAT_TAP_BYTES
        in_el, tap_el = in_b0 // sx, tap_b0 // st
        xs = xf[in_el:in_b1 // sx]            # the staged spans (the end
        ts = tf[tap_el:tap_b1 // st]          # of the array cuts them)
        xoff, toff = r0 * length - in_el, r0 * k - tap_el
        for tid in range(256):
            rr, pos = divmod(p0 + tid, lo)
            for q in range(tid, n, 256):
                base = xoff + rr * length + pos
                acc = np.float32(0.0)
                for t in range(k):
                    acc = np.float32(acc + np.float32(
                        xs[base + t] * ts[toff + rr * k + t]))
                out[o0 + q] = acc
                rr, pos = rr + step_row, pos + step_pos
                if pos >= lo:
                    rr, pos = rr + 1, pos - lo
    return out.reshape(c, lo).astype(out_dtype)


#: (C, L, K): MNIST's conv2 and conv1 rows (tiles end mid-row), a ragged
#: long row, the largest K whose spans fit at L = 300 (f32), a K = 1 case,
#: and 999 x 13 (spans start off 16-byte boundaries; the last chunk of x
#: crosses its end)
_FLAT_FIR_CASES = [(700, 12, 5), (300, 28, 5), (3, 8190, 5), (5, 300, 80),
                   (7, 300, 117), (999, 13, 5), (2500, 12, 1)]


@pytest.mark.parametrize("x_dtype,taps_dtype", [("f32", "f32"),
                                                ("bf16", "bf16"),
                                                ("f32", "bf16")])
@pytest.mark.parametrize("c,length,k", _FLAT_FIR_CASES)
def test_flat_fir_index_arithmetic_matches_jax(c, length, k, x_dtype,
                                               taps_dtype):
    """The flat FIR kernel's tiles and spans, emulated in Python, give the
    JAX kernel's outputs: bit for bit the Pallas kernel's in interpret mode
    for a bf16 output, and for an f32 one bit for bit the JAX package's
    numpy oracle (the Pallas kernel's order; interpret mode on the CPU may
    fuse a multiply and an add, so it is held within the f32 tolerance)."""
    (xn, xt), (tn, tt) = DTYPES[x_dtype], DTYPES[taps_dtype]
    fmod = _module("fir_conv1d")
    assert fmod.flat_fits(length, k, np.dtype(xn).itemsize,
                          np.dtype(tn).itemsize)
    rng = np.random.default_rng(c + length + k)
    x = rng.normal(size=(c, length)).astype(np.float32).astype(xn)
    taps = rng.normal(size=(c, k)).astype(np.float32).astype(tn)
    got = _flat_fir(x, taps, xn)
    want = np.asarray(jax_fir(jnp.asarray(x), jnp.asarray(taps),
                              interpret=True))
    assert got.dtype == want.dtype
    if x_dtype == "bf16":
        np.testing.assert_array_equal(got.view(np.uint16),
                                      want.view(np.uint16))
    else:
        np.testing.assert_array_equal(got, jref.fir_conv1d_ref(x, taps))
        np.testing.assert_allclose(got, want, **TOL)
    # and the port's plain version (the wrapper on CPU tensors) is the same
    plain = fir_conv1d(_t(x.astype(np.float32), xt),
                       _t(taps.astype(np.float32), tt))
    np.testing.assert_array_equal(
        plain.float().numpy(), got.astype(np.float32))


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


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,sq,sk,d", [(1, 1, 37, 53, 8), (2, 3, 61, 29, 16),
                                         (2, 2, 45, 45, 32), (1, 3, 5, 79, 16),
                                         (2, 1, 80, 4, 8)])
def test_flash_attention_matches_jax(b, h, sq, sk, d, causal):
    """The plain version (CPU tensors) against the Pallas kernel in
    interpret mode, ragged and odd Sq != Sk, at the tiles of
    ``tests/test_kernels.py``."""
    rng = np.random.default_rng(sq * 131 + sk * 7 + d)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, h, sk, d)).astype(np.float32)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal, bq=32, bk=32,
                                interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal, bq=32, bk=32)
    assert got.dtype == torch.float32 and got.shape == (b, h, sq, d)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        ref.flash_attention_ref(_t(q), _t(k), _t(v), causal).numpy(),
        jref.flash_attention_ref(q, k, v, causal=causal), **TOL)


def test_flash_attention_gqa_equals_expanded_kv():
    """k, v with fewer heads than q give what the expanded MHA layout gives
    (query head h reads kv head h // g, the repeat_interleave order)."""
    rng = np.random.default_rng(4)
    q = _t(rng.normal(size=(2, 6, 21, 16)))
    k, v = (_t(rng.normal(size=(2, 2, 33, 16))) for _ in range(2))
    got = flash_attention(q, k, v, causal=True, bq=16, bk=16)
    want = flash_attention(q, k.repeat_interleave(3, 1),
                           v.repeat_interleave(3, 1), causal=True, bq=16,
                           bk=16)
    assert torch.equal(got, want)


def test_flash_attention_bf16_rounds_p_like_jax():
    """bf16 inputs: p is rounded to bf16 before the p v product, as the
    Pallas kernel does, so the plain version agrees with it in bf16."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(1, 2, 40, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax_flash(*(jnp.asarray(a, jnp.bfloat16)
                                  for a in (q, k, v)), causal=True, bq=16,
                                bk=16, interpret=True), np.float32)
    got = flash_attention(*(_t(a, torch.bfloat16) for a in (q, k, v)),
                          causal=True, bq=16, bk=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@functools.lru_cache(maxsize=1)
def _chip_smoke():
    """The repo's ``chip_smoke.py`` (its module level imports the standard
    library only), for the rules it holds the kernels to."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=2)
def _full_width_attention(bq, bk):
    """bf16 q (2, 4096, 128) over k, v (1, 4096, 128), causal: the length
    and head width of qwen3-0.6b's attention on the card, two q heads in
    one GQA group; and the plain version's output at a kernel's tiles
    (bq, bk)."""
    rng = np.random.default_rng(11)
    q = _t(rng.normal(size=(2, 4096, 128)), torch.bfloat16)
    k, v = (_t(rng.normal(size=(1, 4096, 128)), torch.bfloat16)
            for _ in range(2))
    want = _module("flash_attention").flash_attention_plain(
        q, k, v, causal=True, group=2, bq=bq, bk=bk)
    return q, k, v, want


def _masked_attention(q, k, v, keep):
    """Softmax attention in f32 over the keys ``keep(rows, keys)`` admits
    (k, v expanded over the group), rounded to bf16; p is not rounded."""
    qf = q.float()
    kf, vf = (a.float().repeat_interleave(q.shape[0] // k.shape[0], 0)
              for a in (k, v))
    out = torch.empty_like(qf)
    keys = torch.arange(k.shape[1])
    for r0 in range(0, q.shape[1], 512):
        rows = torch.arange(r0, min(r0 + 512, q.shape[1]))
        s = qf[:, rows] @ kf.transpose(1, 2) / math.sqrt(q.shape[-1])
        s = s.masked_fill(~keep(rows[:, None], keys[None, :]), -math.inf)
        out[:, rows] = torch.softmax(s, -1) @ vf
    return out.to(torch.bfloat16)


def _one_unit_up(x):
    """x with a seeded 5 % of its bf16 elements one unit larger in
    magnitude (the int16 view of sign and magnitude, plus one)."""
    out = x.clone()
    gen = torch.Generator().manual_seed(12)
    out.view(torch.int16)[torch.rand(x.shape, generator=gen) < 0.05] += 1
    return out


_HALF = 2048              # the fault's rows: the second half of 4,096
_ATTN_OUTPUTS = {
    # honest: no rounding of p at all; the plain version at other tiles
    # (other running maxima, so p rounded elsewhere); one bf16 unit off
    "exact": (True, lambda q, k, v, w: _masked_attention(
        q, k, v, lambda i, j: j <= i)),
    "plain at 128 x 128 tiles": (True, lambda q, k, v, w: _module(
        "flash_attention").flash_attention_plain(q, k, v, causal=True,
                                                 group=2, bq=128, bk=128)),
    "one unit off": (True, lambda q, k, v, w: _one_unit_up(w)),
    # planted faults, in late rows only
    "last KV tile dropped": (False, lambda q, k, v, w: _masked_attention(
        q, k, v,
        lambda i, j: (j <= i) & ~((i >= _HALF) & (j >= i // 64 * 64)))),
    "diagonal key dropped": (False, lambda q, k, v, w: _masked_attention(
        q, k, v, lambda i, j: (j <= i) & ~((i >= _HALF) & (j == i)))),
}


@pytest.mark.parametrize("case", sorted(_ATTN_OUTPUTS))
def test_bf16_attention_rule_at_full_width(case):
    """``chip_smoke.py``'s rule for the bf16 attention kernels at the
    model's length (|d| <= 2^-7 |ref| + 2^-6 rms of ref's row, against the
    plain version at the kernel's tiles, here the mma.sync kernel's 64 x
    64) passes outputs that differ only by rounding, and fails a kernel
    that drops the last KV tile, or only the diagonal key, for the late
    rows, whose outputs are small (rms about sqrt(e / n) over n keys)."""
    cs = _chip_smoke()
    mod = _module("flash_attention")
    q, k, v, want = _full_width_attention(mod.MMA_BLOCK_Q, mod.MMA_BLOCK_K)
    holds, make = _ATTN_OUTPUTS[case]
    got = make(q, k, v, want)
    ok, diff = cs.agree(torch, got, want, "attn_bf16")
    share = float(((got.float() - want.float()).abs()
                   / cs.attn_limit(torch, want.float())).max())
    assert ok is holds, (case, diff, share)
    if holds:
        assert share < 0.8, share   # what rounding leaves is well inside
    else:
        assert share > 10.0, share  # and a fault far outside


_ATTN_OUTPUTS_128 = {
    # honest: no rounding of p at all; the plain version at the mma.sync
    # kernel's 64 x 64 tiles (other running maxima); one bf16 unit off
    "exact": _ATTN_OUTPUTS["exact"],
    "plain at 64 x 64 tiles": (True, lambda q, k, v, w: _module(
        "flash_attention").flash_attention_plain(q, k, v, causal=True,
                                                 group=2, bq=64, bk=64)),
    "one unit off": _ATTN_OUTPUTS["one unit off"],
    # planted faults, in late rows only, at the wgmma kernel's 128-key tiles
    "last 128-key tile dropped": (False, lambda q, k, v, w: _masked_attention(
        q, k, v,
        lambda i, j: (j <= i) & ~((i >= _HALF) & (j >= i // 128 * 128)))),
    "diagonal key dropped": _ATTN_OUTPUTS["diagonal key dropped"],
}


@pytest.mark.parametrize("case", sorted(_ATTN_OUTPUTS_128))
def test_bf16_attention_rule_at_full_width_128_tiles(case):
    """The same rule against the plain version at the wgmma kernel's 128 x
    128 tiles, the tiles of qwen3-0.6b's attention on the card: rounding
    passes well inside the limit, a kernel that drops the last 128-key
    tile, or the diagonal key, of the late rows fails far outside it."""
    cs = _chip_smoke()
    mod = _module("flash_attention")
    q, k, v, want = _full_width_attention(mod.BLOCK_Q, mod.BLOCK_K)
    holds, make = _ATTN_OUTPUTS_128[case]
    got = make(q, k, v, want)
    ok, diff = cs.agree(torch, got, want, "attn_bf16")
    share = cs.limit_share(torch, got, want, "attn_bf16")
    assert ok is holds, (case, diff, share)
    if holds:
        assert share < 0.8, share
    else:
        assert share > 10.0, share


@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal", [
    (1, 2, 2, 200, 300, 64, True), (1, 4, 2, 300, 130, 64, True),
    (2, 2, 1, 130, 257, 64, False), (1, 2, 2, 37, 300, 128, True),
    (1, 2, 1, 300, 37, 128, False), (1, 2, 1, 256, 256, 64, True),
    (1, 2, 2, 200, 300, 112, True), (1, 4, 2, 300, 130, 80, False)])
def test_flash_plain_at_wgmma_tiles_matches_jax(b, h, hkv, sq, sk, d,
                                                causal):
    """The plain version at the wgmma kernel's 128 x 128 tiles against the
    Pallas kernel in interpret mode at the same tiles: ragged Sq and Sk
    (one tile, several, a tile of one key), Sq != Sk, causal or not, GQA
    (the JAX side takes k and v expanded over the group), heads of 64 and
    128 and of widths the kernel zero-fills to its tile (112, zamba2-7b's,
    and 80)."""
    mod = _module("flash_attention")
    rng = np.random.default_rng(sq * 17 + sk + d + h)
    q = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
            for _ in range(2))
    expand = functools.partial(np.repeat, repeats=h // hkv, axis=1)
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(expand(k)),
                                jnp.asarray(expand(v)), causal=causal,
                                bq=mod.BLOCK_Q, bk=mod.BLOCK_K,
                                interpret=True))
    got = flash_attention(_t(q), _t(k), _t(v), causal=causal,
                          bq=mod.BLOCK_Q, bk=mod.BLOCK_K)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@functools.lru_cache(maxsize=1)
def _full_width_matmul():
    """bf16 (512, 4096) @ (4096, 512): the depth of the 4096^3 product on
    the card, at a width the CPU takes quickly; and the plain version's
    output."""
    rng = np.random.default_rng(13)
    x = _t(rng.normal(size=(512, 4096)), torch.bfloat16)
    w = _t(rng.normal(size=(4096, 512)), torch.bfloat16)
    return x, w, ref.matmul_ref(x, w)


def _k_sliced(x, w, width, reverse=False):
    """x @ w summed in f32 over K slices of ``width`` (last slice first if
    ``reverse``), rounded to bf16 once."""
    starts = range(0, x.shape[1], width)
    acc = torch.zeros(x.shape[0], w.shape[1])
    for k0 in (reversed(starts) if reverse else starts):
        acc += x[:, k0:k0 + width].float() @ w[k0:k0 + width].float()
    return acc.to(torch.bfloat16)


def _tile_missing(x, w, k0, width):
    """The product with one 128 x 128 output tile (rows 128-255, columns
    256-383) missing K values k0 .. k0 + width - 1."""
    acc = x.float() @ w.float()
    r, c = slice(128, 256), slice(256, 384)
    acc[r, c] -= x[r, k0:k0 + width].float() @ w[k0:k0 + width, c].float()
    return acc.to(torch.bfloat16)


_MATMUL_OUTPUTS = {
    # honest: other K slices (the wgmma kernel's 64, its 16-wide k-steps),
    # a reversed K order, one bf16 unit off
    "K slices of 64": (True, lambda x, w, want: _k_sliced(x, w, 64)),
    "K steps of 16, reversed": (True, lambda x, w, want: _k_sliced(
        x, w, 16, reverse=True)),
    "one unit off": (True, lambda x, w, want: _one_unit_up(want)),
    # planted faults in one output tile
    "one 16-wide k-step dropped": (False, lambda x, w, want: _tile_missing(
        x, w, 2048, 16)),
    "one 64-wide stage dropped": (False, lambda x, w, want: _tile_missing(
        x, w, 4032, 64)),
}


@pytest.mark.parametrize("case", sorted(_MATMUL_OUTPUTS))
def test_bf16_matmul_rule_at_full_width(case):
    """``chip_smoke.py``'s rule for the bf16 matmul kernels (|d| <= 2^-7
    |ref| + 2^-12 rms(ref) per element) at K = 4096 passes sums taken in
    another order, which differ from the plain version at most by one bf16
    rounding, and fails a kernel that drops one 16-wide k-step, or one
    64-wide stage, of one output tile, far outside the limit."""
    cs = _chip_smoke()
    x, w, want = _full_width_matmul()
    holds, make = _MATMUL_OUTPUTS[case]
    got = make(x, w, want)
    ok, diff = cs.agree(torch, got, want, "bf16")
    share = cs.limit_share(torch, got, want, "bf16")
    assert ok is holds, (case, diff, share)
    if holds:
        assert share <= 1.0, share
    else:
        assert share > 10.0, share


def _tf32(a, rounded=False):
    """a (f32) as tf32: its lower 13 mantissa bits cleared, or rounded to
    nearest first (``rounded``)."""
    bits = a.view(torch.int32)
    if rounded:
        bits = bits + 0x1000
    return (bits & -8192).view(torch.float32)


def _split_products(x, w, rounded=True):
    """x @ w.T as 3xTF32: a = hi + lo with hi = tf32(a), lo = tf32(a - hi),
    both rounded to nearest as the kernel splits them (or both truncated);
    x_hi w_hi + x_hi w_lo + x_lo w_hi, each product summed in f32."""
    xh, wh = _tf32(x, rounded), _tf32(w, rounded)
    xl, wl = _tf32(x - xh, rounded), _tf32(w - wh, rounded)
    return xh @ wh.T + xh @ wl.T + xl @ wh.T


@functools.lru_cache(maxsize=1)
def _tf32x3_operands():
    """f32 x (256, 4096) and a weight (256, 4096): K = 4096, the depth of
    the 4096^2 block-sparse product on the card; the plain f32 product and
    the f64 one."""
    rng = np.random.default_rng(14)
    x = _t(rng.normal(size=(256, 4096)))
    w = _t(rng.normal(size=(256, 4096)))
    return x, w, x @ w.T, x.double() @ w.double().T


_TF32X3_OUTPUTS = {
    # 3xTF32, split as the kernel splits (rounded) or truncated: near f32
    "3xTF32, split rounded": (True, lambda x, w: _split_products(x, w)),
    "3xTF32, split truncated": (True, lambda x, w: _split_products(
        x, w, rounded=False)),
    # one tf32 product, truncated or rounded; two of the three products
    "one-pass TF32, truncated": (False, lambda x, w: _tf32(x) @ _tf32(w).T),
    "one-pass TF32, rounded": (False, lambda x, w: _tf32(x, True)
                               @ _tf32(w, True).T),
    "x_lo w_hi left out": (False, lambda x, w: _tf32(x, True)
                           @ _tf32(w, True).T + _tf32(x, True)
                           @ _tf32(w - _tf32(w, True), True).T),
}


@pytest.mark.parametrize("case", sorted(_TF32X3_OUTPUTS))
def test_tf32x3_rule_at_full_width(case):
    """``chip_smoke.py``'s ``tf32x3`` rule (max |kernel - f64| <= 4 max
    |plain f32 - f64| + 2^-24 max |f64|) at K = 4096 passes a plain-PyTorch
    emulation of 3xTF32 and fails a one-pass TF32 product, or one product
    short, by more than 100 times the limit."""
    cs = _chip_smoke()
    x, w, plain, exact = _tf32x3_operands()
    holds, make = _TF32X3_OUTPUTS[case]
    share = cs.tf32x3_share(torch, make(x, w), plain, exact)
    if holds:
        assert share <= 0.5, share
    else:
        assert share > 100.0, share


def _dense_tf32x3(x, w, split, small=True):
    """x (M, K) @ w (K, N) as the dense tf32x3 kernel sums it: both
    operands split as the kernel splits them (rounded); K in 32-wide
    slices, cut into ``split`` runs of ceil(slices / split); in each run
    every slice's x_hi w_hi summed in f32 (the partial the tensor cores
    hand over a slice) and added to an accumulator, and the slice's two
    small products added to an accumulator of their own (left out with
    ``small=False``); then the runs' partials added in rank order."""
    xh, wh = _tf32(x, True), _tf32(w, True)
    xl, wl = _tf32(x - xh, True), _tf32(w - wh, True)
    slices = -(-x.shape[1] // 32)
    per = -(-slices // split)
    out = None
    for r in range(split):
        acc = torch.zeros(x.shape[0], w.shape[1])
        small_acc = torch.zeros_like(acc)
        for s in range(r * per, min(slices, (r + 1) * per)):
            ks = slice(32 * s, 32 * s + 32)
            acc = acc + xh[:, ks] @ wh[ks]
            small_acc = small_acc + (xh[:, ks] @ wl[ks] + xl[:, ks] @ wh[ks])
        part = acc + small_acc if small else acc
        out = part if out is None else out + part
    return out


_DENSE_TF32X3_CASES = {
    # (shape, the shape whose split it takes, split, holds): the benchmark
    # shape, K = 4096 split as 4096^3 is (not at all) and as its own plan
    # splits it, and MNIST's fc2 (a K tail of 8)
    "512x1024x768": ((512, 1024, 768), (512, 1024, 768), 4, True),
    "256x4096x256 as at 4096^3": ((256, 4096, 256), (4096,) * 3, 1, True),
    "256x4096x256": ((256, 4096, 256), (256, 4096, 256), 4, True),
    "1024x200x500": ((1024, 200, 500), (1024, 200, 500), 4, True),
    "512x1024x768, small products left out": (
        (512, 1024, 768), (512, 1024, 768), 4, False),
    "256x4096x256 as at 4096^3, small products left out": (
        (256, 4096, 256), (4096,) * 3, 1, False),
}


@pytest.mark.parametrize("case", sorted(_DENSE_TF32X3_CASES))
def test_tf32x3_rule_holds_dense_kernel_arithmetic(case):
    """The dense tf32x3 kernel's own arithmetic (a partial sum per 32-wide
    K slice, the small products apart, K split as ``tf32x3_plan`` splits
    it, the partials added in rank order), emulated in plain PyTorch,
    takes at most 0.5 of ``chip_smoke.py``'s ``tf32x3`` limit at the
    benchmark shape, at K = 4096 (with 4096^3's split of 1, each output's
    arithmetic there, and with its own) and at MNIST's fc2; left without
    its small products it misses the limit by more than 100 times."""
    cs = _chip_smoke()
    (m, k, n), plan_shape, split, holds = _DENSE_TF32X3_CASES[case]
    assert importlib.import_module("repro_torch.kernels.dense_matmul"
                                   ).tf32x3_plan(*plan_shape).split == split
    rng = np.random.default_rng(m + k + n)
    x = _t(rng.normal(size=(m, k)))
    w = _t(rng.normal(size=(k, n)))
    got = _dense_tf32x3(x, w, split, small=holds)
    share = cs.tf32x3_share(torch, got, x @ w, x.double() @ w.double())
    if holds:
        assert share <= 0.5, share
    else:
        assert share > 100.0, share


@pytest.mark.parametrize("use_kernel", [True, False])
def test_attention_block_gqa_matches_jax(use_kernel):
    """GQA (8 query heads over 2 kv heads) through the port's
    ``attention_block`` against the JAX package's, with the flash path
    (the plain version here) and the blockwise path."""
    kw = dict(name="t", family="dense", num_layers=1, d_model=32,
              num_heads=8, num_kv_heads=2, head_dim=8, d_ff=64,
              vocab_size=64, q_chunk=8, k_chunk=8, qk_norm=True,
              param_dtype="float32", compute_dtype="float32",
              use_pallas_attention=use_kernel)
    rng = np.random.default_rng(6)
    shapes = jlayers.attn_param_shapes(JaxModelConfig(**kw))
    params = {n: (rng.normal(size=s) * (0.3 if len(s) > 1 else 1.0)
                  ).astype(np.float32) for n, s in shapes.items()}
    x = rng.normal(size=(2, 19, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19, dtype=np.int32), (2, 19))
    want = np.asarray(jlayers.attention_block(
        JaxModelConfig(**kw), {n: jnp.asarray(a) for n, a in params.items()},
        jnp.asarray(x), jnp.asarray(pos)))
    got = tlayers.attention_block(
        ModelConfig(**kw), {n: _t(a) for n, a in params.items()}, _t(x),
        torch.tensor(pos, dtype=torch.long))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_attention_refuses_bad_shapes():
    q = torch.randn(1, 4, 8, 16)
    with pytest.raises(ValueError, match="dividing H"):
        flash_attention(q, torch.randn(1, 3, 8, 16), torch.randn(1, 3, 8, 16))
    with pytest.raises(ValueError, match="at least one key"):
        flash_attention(q, torch.randn(1, 4, 0, 16), torch.randn(1, 4, 0, 16))
    with pytest.raises(ValueError, match="tiles"):
        flash_attention(q, q, q, bq=0)


# --------------------------------------------------------------------------
# SSD intra-chunk cell
# --------------------------------------------------------------------------

def _ssd_inputs(b, h, q, p, n, seed, dt_range=(0.01, 0.5),
                a_range=(0.5, 2.0), chunks=2):
    """The recipe of ``tests/test_kernels.py``'s SSD test: a sequence of
    ``chunks`` chunks, x dt and the cumulative decay per chunk."""
    rng = np.random.default_rng(seed)
    s = chunks * q
    xh = rng.normal(size=(b, s, h, p)).astype(np.float32)
    bb = rng.normal(size=(b, s, n)).astype(np.float32)
    cc = rng.normal(size=(b, s, n)).astype(np.float32)
    dtv = rng.uniform(*dt_range, size=(b, s, h)).astype(np.float32)
    a_neg = -rng.uniform(*a_range, size=(h,)).astype(np.float32)
    nc = s // q
    xdt = (xh * dtv[..., None]).reshape(b, nc, q, h, p)
    xdt = np.moveaxis(xdt, 3, 2).reshape(b * nc, h, q, p)
    cs = np.cumsum((dtv * a_neg).reshape(b, nc, q, h), axis=2,
                   dtype=np.float32)
    csk = np.moveaxis(cs, 3, 2).reshape(b * nc, h, q)
    return (np.ascontiguousarray(xdt), bb.reshape(b * nc, q, n),
            cc.reshape(b * nc, q, n), np.ascontiguousarray(csk))


@pytest.mark.parametrize("b,h,q,p,n,seed", [
    (1, 1, 4, 4, 3, 0), (2, 3, 8, 4, 5, 7), (1, 2, 4, 8, 5, 13),
    (2, 1, 8, 8, 3, 50), (1, 2, 37, 9, 11, 3)])
def test_ssd_intra_matches_jax(b, h, q, p, n, seed):
    """The plain version (CPU tensors) against the Pallas kernel in
    interpret mode, at the tolerance of ``tests/test_kernels.py``."""
    args = _ssd_inputs(b, h, q, p, n, seed)
    y_want, s_want = jax_ssd(*(jnp.asarray(a) for a in args),
                             interpret=True)
    y, s = ssd_intra(*(_t(a) for a in args))
    assert y.shape == (b * 2, h, q, p) and s.shape == (b * 2, h, n, p)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=3e-4,
                               atol=3e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), rtol=3e-4,
                               atol=3e-5)


def test_ssd_intra_masked_decay_overflow_stays_out():
    """Q = 64 with dt * a down to -4 a step: exp(cs_i - cs_j) above the
    diagonal overflows to inf, and neither result may see it."""
    args = _ssd_inputs(1, 2, 64, 8, 6, 21, dt_range=(1.0, 2.0),
                       a_range=(1.0, 2.0), chunks=1)
    cs = args[3]
    assert float(np.max(cs[..., None, :] - cs[..., :, None])) > 89.0
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(np.max(cs[..., None, :] - cs[..., :, None])))
    y_want, s_want = jax_ssd(*(jnp.asarray(a) for a in args),
                             interpret=True)
    y, s = ssd_intra(*(_t(a) for a in args))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_want), rtol=3e-4,
                               atol=3e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_want), rtol=3e-4,
                               atol=3e-5)


@pytest.mark.parametrize("bf16", ["all", "xdt, bb, cc", "cs", "xdt"])
@pytest.mark.parametrize("b,h,q,p,n,seed,steep", [
    (2, 3, 8, 4, 5, 7, False), (1, 2, 37, 9, 11, 3, False),
    (1, 2, 64, 8, 6, 21, True)])
def test_ssd_intra_bf16_matches_jax(b, h, q, p, n, seed, steep, bf16):
    """bf16 inputs (all, some or one) against the Pallas kernel in
    interpret mode: f32 outputs within 1e-5 max |ref| of each; a bf16 cs is
    rounded where JAX rounds it (``ref.ssd_intra_ref``)."""
    kw = dict(dt_range=(1.0, 2.0), a_range=(1.0, 2.0), chunks=1) if steep \
        else {}
    args = _ssd_inputs(b, h, q, p, n, seed, **kw)
    names = ("xdt", "bb", "cc", "cs")
    narrow = names if bf16 == "all" else bf16.split(", ")
    args = [a.astype(NP_BF16) if nm in narrow else a
            for nm, a in zip(names, args)]
    y_want, s_want = jax_ssd(*(jnp.asarray(a) for a in args),
                             interpret=True)
    got = ssd_intra(*(_t(a, torch.bfloat16 if nm in narrow else
                         torch.float32) for nm, a in zip(names, args)))
    for g, w in zip(got, (y_want, s_want)):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and w.dtype == np.float32
        assert torch.isfinite(g).all()
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()


def test_ssd_intra_refuses_bad_shapes():
    xdt = torch.randn(2, 3, 4, 5)
    bb = torch.randn(2, 4, 6)
    with pytest.raises(ValueError, match="do not match"):
        ssd_intra(xdt, bb, bb, torch.randn(2, 3, 5))
    with pytest.raises(ValueError, match="expected xdt"):
        ssd_intra(xdt, bb, torch.randn(2, 4, 7), torch.randn(2, 3, 4))


def _split_tf32(a):
    """a = big + small, both tf32 rounded to nearest (hopper.cuh's
    split_tf32)."""
    big = _tf32(a, True)
    return big, _tf32(a - big, True)


def _slices_3xtf32(a, b, one_pass=False, b_parts=2):
    """a (..., M, K) @ b (..., K, N) as the SSD kernel's wgmma sums it: K in
    32-wide slices, each slice's big x big product summed alone and added
    to an accumulator, the small products in an accumulator of their own
    (left out with ``one_pass``), the two added at the end.  b in two tf32
    parts (three products), or with ``b_parts=3`` in three: big, mid =
    tf32(b - big), low = tf32(b - big - mid), and five products (a big
    times all three, a small times big and mid)."""
    (ah, al), (bh, bl) = _split_tf32(a), _split_tf32(b)
    b3 = _tf32(b - bh - bl, True)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:])
    small = torch.zeros_like(acc)
    for k0 in range(0, a.shape[-1], 32):
        ks = slice(k0, k0 + 32)
        acc = acc + ah[..., ks] @ bh[..., ks, :]
        if not one_pass:
            small = small + (ah[..., ks] @ bl[..., ks, :]
                             + al[..., ks] @ bh[..., ks, :])
            if b_parts == 3:
                small = small + (ah[..., ks] @ b3[..., ks, :]
                                 + al[..., ks] @ bl[..., ks, :])
    return acc + small


def _ssd_wgmma(xdt, bb, cc, cs, one_pass=False):
    """The wgmma SSD kernel's arithmetic in plain PyTorch: G = C B^T once
    per batch*chunk, shared by its heads; M = G * exp(cs_i - cs_j) where j
    <= i (cs rounded as ``ref.ssd_intra_ref`` rounds a bf16 cs); y = M x dt
    and S = B^T (decay * x dt), every product as :func:`_slices_3xtf32`, S's
    with decay * x dt in three parts.  A bf16 operand's small tf32 part is
    0, so the passes the kernel drops for it are exactly 0 here."""
    rnd = cs.dtype == torch.bfloat16
    in_cs = (lambda t: t.to(torch.bfloat16).float()) if rnd else \
        (lambda t: t)
    for t in (xdt, bb, cc):
        if t.dtype == torch.bfloat16:
            assert not _split_tf32(t.float())[1].any()
    xdt, bb, cc, cs = xdt.float(), bb.float(), cc.float(), cs.float()
    q = xdt.shape[2]
    g = _slices_3xtf32(cc, bb.transpose(-1, -2), one_pass)     # (BC, Q, Q)
    causal = torch.ones(q, q, dtype=torch.bool).tril()
    m = torch.where(causal, g[:, None] * torch.exp(
        in_cs(cs[..., :, None] - cs[..., None, :])), 0.0)
    y = _slices_3xtf32(m, xdt, one_pass)
    decay = in_cs(torch.exp(in_cs(cs[..., -1:] - cs)))
    s = _slices_3xtf32(bb.transpose(-1, -2)[:, None],
                       decay[..., None] * xdt, one_pass, b_parts=3)
    return y, s


_SSD_WGMMA_CASES = {
    # name: (bf16 inputs among xdt, bb, cc, cs; steep decay; one pass)
    "f32": ((), False, False),
    "f32, steep decay": ((), True, False),
    "bf16": (("xdt", "bb", "cc", "cs"), False, False),
    "bf16 x dt (y in two passes)": (("xdt",), False, False),
    "bf16 bb and cc (G in one pass, S in three)": (("bb", "cc"), True,
                                                    False),
    "bf16 cs": (("cs",), False, False),
    "one-pass TF32, f32": ((), False, True),
}


@pytest.mark.parametrize("case", sorted(_SSD_WGMMA_CASES))
def test_ssd_wgmma_arithmetic_matches_jax(case):
    """The wgmma SSD kernel's arithmetic, emulated (:func:`_ssd_wgmma`), at
    mamba2-370m's cell widths (Q = 256, N = 128, P = 64) over 3 heads of
    one batch*chunk, against the Pallas kernel in interpret mode: within
    the ``ssd`` rule (1e-5 of max |ref| per output) and ``chip_smoke.py``'s
    f64 rule (max |got - f64| <= 4 max |plain f32 - f64| + 2^-24 max
    |f64|, the f64 cell from ``ref.ssd_intra_ref``; 0.44 of it at most).
    A one-pass TF32 product misses the f64 limit by more than 50 times."""
    cs_mod = _chip_smoke()
    narrow, steep, one_pass = _SSD_WGMMA_CASES[case]
    kw = dict(dt_range=(1.0, 2.0), a_range=(1.0, 2.0)) if steep else {}
    args = _ssd_inputs(1, 3, 256, 64, 128, 19, chunks=1, **kw)
    names = ("xdt", "bb", "cc", "cs")
    args = [a.astype(NP_BF16) if nm in narrow else a
            for nm, a in zip(names, args)]
    targs = [_t(a, torch.bfloat16 if nm in narrow else torch.float32)
             for nm, a in zip(names, args)]
    want = jax_ssd(*(jnp.asarray(a) for a in args), interpret=True)
    got = _ssd_wgmma(*targs, one_pass=one_pass)
    plain = ref.ssd_intra_ref(*targs)
    exact = ref.ssd_intra_ref(*targs, dtype=torch.float64)
    for g, w, p_, e in zip(got, want, plain, exact):
        w = torch.from_numpy(np.array(w))
        share = cs_mod.tf32x3_share(torch, g, p_, e)
        if one_pass:
            assert share > 50.0, share
            continue
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())
        assert share <= 1.0, share


@pytest.mark.parametrize("seed", [7, 10])
def test_ssd_chunk_state_needs_three_parts_of_x_dt(seed):
    """Why S splits decay * x dt into three tf32 parts: with a steep decay
    (``chip_smoke.py``'s recipe, steps of 1 to 4) S is a sum of a few
    products, the plain version's error one rounding a product, and S with
    x dt in two parts misses the f64 rule at these seeds; in three parts
    with five products it holds with room (at most 0.75 of the limit)."""
    cs_mod = _chip_smoke()
    rng = np.random.default_rng(seed)
    xdt = _t(rng.normal(size=(2, 4, 256, 64)))
    bb = _t(rng.normal(size=(2, 256, 128)))
    cs = _t(np.cumsum(-rng.uniform(1.0, 4.0, (2, 4, 256)), axis=-1))
    xs = torch.exp(cs[..., -1:] - cs)[..., None] * xdt
    bt = bb.transpose(-1, -2)[:, None]
    plain = bt @ xs
    exact = bt.double() @ xs.double()
    two = cs_mod.tf32x3_share(torch, _slices_3xtf32(bt, xs), plain, exact)
    three = cs_mod.tf32x3_share(torch, _slices_3xtf32(bt, xs, b_parts=3),
                                plain, exact)
    assert two > 1.0 and three <= 0.75, (two, three)


# --------------------------------------------------------------------------
# The attention and SSD kernels' autograd wrappers (their CUDA forward
# runs on the card; on CPU tensors the same Function runs the plain
# forward, so the backward's product is held bitwise here)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("causal,group", [(True, 1), (True, 2), (False, 4)])
def test_flash_attention_function_gives_the_plain_versions_gradient(
        causal, group):
    g = torch.Generator().manual_seed(group)
    q = torch.randn(8, 13, 16, generator=g, requires_grad=True)
    k = torch.randn(8 // group, 11 if not causal else 13, 16, generator=g,
                    requires_grad=True)
    v = torch.randn(k.shape, generator=g, requires_grad=True)
    w = torch.randn(8, 13, 16, generator=g)
    out = ops.FlashAttentionFunction.apply(q, k, v, causal, group, 4, 8)
    got = torch.autograd.grad((out * w).sum(), (q, k, v))
    plain = flash_attention_plain(q, k, v, causal=causal, group=group, bq=4,
                                  bk=8)
    assert torch.equal(out, plain.detach())
    # the backward is the plain version's product at its own tiles
    again = flash_attention_plain(q, k, v, causal=causal, group=group,
                                  bq=ops.BACKWARD_TILE, bk=ops.BACKWARD_TILE)
    want = torch.autograd.grad((again * w).sum(), (q, k, v))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_function_gives_the_plain_cells_gradient(dtype):
    g = torch.Generator().manual_seed(0)
    xdt = torch.randn(3, 2, 8, 4, generator=g).to(dtype).requires_grad_()
    bb = torch.randn(3, 8, 5, generator=g).to(dtype).requires_grad_()
    cc = torch.randn(3, 8, 5, generator=g).to(dtype).requires_grad_()
    cs = torch.cumsum(-torch.rand(3, 2, 8, generator=g), -1).to(
        dtype).requires_grad_()
    wy, ws = torch.randn(3, 2, 8, 4), torch.randn(3, 2, 5, 4)
    y, s = SSDIntraFunction.apply(xdt, bb, cc, cs)
    got = torch.autograd.grad((y * wy).sum() + (s * ws).sum(),
                              (xdt, bb, cc, cs))
    y2, s2 = ref.ssd_intra_ref(xdt, bb, cc, cs)
    want = torch.autograd.grad((y2 * wy).sum() + (s2 * ws).sum(),
                               (xdt, bb, cc, cs))
    assert all(a.dtype == dtype and torch.equal(a, b)
               for a, b in zip(got, want))
