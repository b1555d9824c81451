"""How the port picks its Hopper kernels, and what rebuilds them, on the CPU.

``dense_matmul.matmul_path``, ``flash_attention.attention_path``,
``sparse_fc.fc_path``, ``fir_conv1d.fir_path`` and ``ssd_intra.ssd_path``
decide from the operands alone (dtype, contiguity, 16-byte alignment, K
and N, d, the block shape, the FIR's row length and taps, the SSD cell's
Q, N and P) which CUDA kernel a call on the card launches; each is tested
here on every boundary with CPU tensors, which launch nothing.  ``_build``
names a library by a hash of its source, the shared headers and the flags,
so an edited header rebuilds every source, and keeps each build's log beside
its library.
"""

import importlib
import sys

import pytest
import torch

from repro_torch.kernels import _build

BF16, F32 = torch.bfloat16, torch.float32


def _module(name):
    return importlib.import_module(f"repro_torch.kernels.{name}")


def _at(shape, dtype=BF16, offset=0):
    """A contiguous tensor of ``shape`` whose data starts ``offset``
    elements into its storage (its own allocation is 64-byte aligned)."""
    n = 1
    for s in shape:
        n *= s
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


# --------------------------------------------------------------------------
# dense matmul: wgmma for bf16 and tf32x3 for f32 that TMA reads, else the
# narrow kernel for contiguous operands with N up to 64, else the CUDA-core
# kernel
# --------------------------------------------------------------------------

_MATMUL_CASES = {
    "aligned": ((128, 256, 192), {}, "wgmma"),
    "ragged M": ((13, 64, 64), {}, "wgmma"),
    "ragged K and N, multiples of 8": ((200, 296, 104), {}, "wgmma"),
    "K tail of 8": ((64, 520, 136), {}, "wgmma"),
    "K = N = 8": ((1, 8, 8), {}, "wgmma"),
    "f32": ((128, 256, 192), {"dtype": F32}, "tf32x3"),
    "f32 K = 60": ((64, 60, 64), {"dtype": F32}, "tf32x3"),
    "f32 K = 4, ragged M and N": ((13, 4, 36), {"dtype": F32}, "tf32x3"),
    "f32 N = 10": ((64, 64, 10), {"dtype": F32}, "narrow"),
    "f32 w 8 bytes off": ((64, 64, 64), {"dtype": F32, "w_offset": 2},
                          "narrow"),
    "f32 N = 100, w 8 bytes off": ((64, 64, 100), {"dtype": F32,
                                                   "w_offset": 2}, "simt"),
    "f32 x 16 bytes off": ((64, 64, 64), {"dtype": F32, "x_offset": 4},
                           "tf32x3"),
    "f32 w transposed view": ((64, 64, 64), {"dtype": F32,
                                             "w_transposed": True}, "simt"),
    "f32 M = 0": ((0, 64, 64), {"dtype": F32}, "simt"),
    "f32 x, bf16 w": ((128, 256, 192), {"dtype": F32, "w_dtype": BF16},
                      "simt"),
    "bf16 x, f32 w": ((128, 256, 192), {"w_dtype": F32}, "simt"),
    "K = 60": ((64, 60, 64), {}, "narrow"),
    "N = 100": ((64, 64, 100), {}, "simt"),
    "K = 4": ((64, 4, 64), {}, "narrow"),
    "odd everything": ((13, 57, 31), {}, "narrow"),
    "x 2 bytes off": ((64, 64, 64), {"x_offset": 1}, "narrow"),
    "w 8 bytes off": ((64, 64, 64), {"w_offset": 4}, "narrow"),
    "N = 65, x 2 bytes off": ((64, 64, 65), {"x_offset": 1}, "simt"),
    "x 16 bytes off": ((64, 64, 64), {"x_offset": 8}, "wgmma"),
    "w transposed view": ((64, 64, 64), {"w_transposed": True}, "simt"),
    "M = 0": ((0, 64, 64), {}, "simt"),
    "K = 0": ((64, 0, 64), {}, "simt"),
}


@pytest.mark.parametrize("case", sorted(_MATMUL_CASES))
def test_matmul_path_boundaries(case):
    (m, k, n), kw, want = _MATMUL_CASES[case]
    dtype = kw.get("dtype", BF16)
    x = _at((m, k), dtype, kw.get("x_offset", 0))
    if kw.get("w_transposed"):
        w = _at((n, k), dtype).T
    else:
        w = _at((k, n), kw.get("w_dtype", dtype), kw.get("w_offset", 0))
    assert _module("dense_matmul").matmul_path(x, w) == want


def test_matmul_cpu_calls_launch_no_kernel():
    """On CPU tensors the wrapper takes the plain version whatever the
    path, and counts no launch on either kernel."""
    mod = _module("dense_matmul")
    before = dict(mod.matmul.launches_by_path)
    x = torch.randn(128, 256).to(BF16)
    w = torch.randn(256, 192).to(BF16)
    assert mod.matmul_path(x, w) == "wgmma"
    out = mod.matmul(x, w, bm=128, bk=64, bn=128)
    assert torch.equal(out, _module("ref").matmul_ref(x, w))
    assert mod.matmul.launches_by_path == before
    assert set(before) == {"wgmma", "tf32x3", "narrow", "simt"}


_TF32X3_PLANS = {
    # (m, k, n): (split, CTAs); 128 x 128 tiles throughout
    (512, 1024, 768): (4, 96),       # the benchmark shape: 24 tiles
    (4096, 4096, 4096): (1, 1024),
    (1024, 200, 500): (4, 128),      # MNIST's fc2: 32 tiles, 7 slices
    (1000, 1024, 512): (4, 128),
    (1024, 4096, 1024): (2, 128),    # 64 tiles: 4 ways would be 256 CTAs
    (2048, 1024, 1024): (1, 128),
    (64, 60, 64): (2, 2),            # 2 slices: one each
    (512, 160, 768): (2, 48),        # 5 slices: 4 ways would leave one idle
    (64, 4, 64): (1, 1),             # 1 slice
}


@pytest.mark.parametrize("shape", sorted(_TF32X3_PLANS))
def test_tf32x3_plan_fills_the_card(shape):
    """``tf32x3_plan`` is a pure function of (M, K, N): 128 x 128 tiles and
    K split 4, 2 or 1 ways, the most that keeps the grid within one wave
    of 132 CTAs and every CTA at least one 32-wide K slice.  At the
    benchmark shape 512 x 1024 x 768 that is at least 96 CTAs; at 4096^3
    no split."""
    mod = _module("dense_matmul")
    m, k, n = shape
    plan = mod.tf32x3_plan(m, k, n)
    assert plan == mod.tf32x3_plan(m, k, n)
    assert (plan.bm, plan.bn) == (mod.TF32X3_TILE,) * 2 == (128, 128)
    assert (plan.split, plan.ctas(m, n)) == _TF32X3_PLANS[shape]
    slices = -(-k // mod.TF32X3_SLICE)
    per = -(-slices // plan.split)
    assert (plan.split - 1) * per < slices          # no CTA without work
    assert plan.split == 1 or plan.ctas(m, n) <= mod.SMS


# --------------------------------------------------------------------------
# flash attention: wgmma at bf16 d % 8 == 0 that TMA reads, mma.sync at
# other bf16, f32
# --------------------------------------------------------------------------

_ATTN_CASES = {
    "d = 128": (128, {}, "wgmma"),
    "d = 64": (64, {}, "wgmma"),
    "d = 80": (80, {}, "wgmma"),
    "d = 37": (37, {}, "mma_sync"),
    "d = 16": (16, {}, "wgmma"),
    "d = 96": (96, {}, "wgmma"),
    "d = 112": (112, {}, "wgmma"),
    "d = 40": (40, {}, "wgmma"),
    "d = 36": (36, {}, "mma_sync"),
    "f32 d = 128": (128, {"dtype": F32}, "f32"),
    "f32 d = 37": (37, {"dtype": F32}, "f32"),
    "q 2 bytes off": (128, {"q_offset": 1}, "mma_sync"),
    "k 8 bytes off": (64, {"k_offset": 4}, "mma_sync"),
    "v 2 bytes off": (128, {"v_offset": 1}, "mma_sync"),
    "q 16 bytes off": (128, {"q_offset": 8}, "wgmma"),
    "v transposed view": (64, {"v_transposed": True}, "mma_sync"),
}


@pytest.mark.parametrize("case", sorted(_ATTN_CASES))
def test_attention_path_boundaries(case):
    d, kw, want = _ATTN_CASES[case]
    dtype = kw.get("dtype", BF16)
    q = _at((4, 37, d), dtype, kw.get("q_offset", 0))
    k = _at((2, 53, d), dtype, kw.get("k_offset", 0))
    if kw.get("v_transposed"):
        v = _at((2, d, 53), dtype).transpose(1, 2)
    else:
        v = _at((2, 53, d), dtype, kw.get("v_offset", 0))
    mod = _module("flash_attention")
    path = mod.attention_path(q, k, v)
    assert path == want
    assert mod.kernel_tiles(path) == ((128, 128) if path == "wgmma"
                                      else (64, 64))


def test_attention_tiles_are_the_kernels():
    """The exported tiles: the wgmma kernel's 128 x 128, and the mma.sync
    (and f32) kernels' 64 x 64 under their own names."""
    mod = _module("flash_attention")
    assert (mod.BLOCK_Q, mod.BLOCK_K) == (128, 128)
    assert (mod.MMA_BLOCK_Q, mod.MMA_BLOCK_K) == (64, 64)
    assert set(mod.flash_attention.launches_by_path) == {"wgmma", "mma_sync",
                                                         "f32"}


def test_launch_by_path_refuses_cpu_tensors():
    """``launch`` names a kernel outright, so it checks what the entry
    points check: CUDA tensors only, matching shapes; nothing launches."""
    mm, fa = _module("dense_matmul"), _module("flash_attention")
    before = (dict(mm.matmul.launches_by_path),
              dict(fa.flash_attention.launches_by_path))
    x, w = torch.zeros(64, 64, dtype=BF16), torch.zeros(64, 64, dtype=BF16)
    with pytest.raises(ValueError, match="runs on CUDA"):
        mm.launch(x, w, "wgmma")
    with pytest.raises(ValueError, match="cannot multiply"):
        mm.launch(x, torch.zeros(32, 64, dtype=BF16), "simt")
    q = torch.zeros(2, 16, 64, dtype=BF16)
    with pytest.raises(ValueError, match="runs on CUDA"):
        fa.launch(q, q, q, "wgmma", causal=True)
    assert (mm.matmul.launches_by_path,
            fa.flash_attention.launches_by_path) == before


# --------------------------------------------------------------------------
# block-sparse FC: bf16 and 3xTF32 on the tensor cores, the CUDA-core kernel
# --------------------------------------------------------------------------

#: case: (batch, K, (bm, bk), nnzb, x dtype, vals dtype, options, path);
#: the cases chip_smoke.py runs on each path, then every boundary.
_FC_CASES = {
    "f32, 128 x 128 blocks": (17, 200, (128, 128), 5, F32, F32, {},
                              "tf32x3"),
    "f32, batch 1": (1, 200, (128, 128), 5, F32, F32, {}, "tf32x3"),
    "f32, batch 129": (129, 200, (128, 128), 5, F32, F32, {}, "tf32x3"),
    "f32, 128 x 64 blocks": (200, 200, (128, 64), 9, F32, F32, {},
                             "tf32x3"),
    "f32, 4096^2 checkerboard": (512, 4096, (128, 128), 512, F32, F32, {},
                                 "tf32x3"),
    "MNIST fc1": (1024, 1600, (128, 128), 26, F32, F32, {}, "tf32x3"),
    "bf16, 128 x 128 blocks": (17, 200, (128, 128), 5, BF16, BF16, {},
                               "wgmma"),
    "bf16, 128 x 64 blocks": (200, 200, (128, 64), 9, BF16, BF16, {},
                              "wgmma"),
    "bf16, 4096^2 checkerboard": (512, 4096, (128, 128), 512, BF16, BF16,
                                  {}, "wgmma"),
    "bf16 x, f32 vals": (17, 200, (128, 128), 5, BF16, F32, {}, "tf32x3"),
    "f32 x, bf16 vals": (17, 200, (128, 128), 5, F32, BF16, {}, "tf32x3"),
    "f32, 64 x 48 blocks": (9, 200, (64, 48), 17, F32, F32, {}, "simt"),
    "bf16, 64 x 48 blocks": (9, 200, (64, 48), 17, BF16, BF16, {}, "simt"),
    "f32, 40 x 40 blocks": (5, 200, (40, 40), 32, F32, F32, {}, "simt"),
    "bf16, bk 32 (half a bf16 slice)": (8, 256, (128, 32), 4, BF16, BF16,
                                        {}, "simt"),
    "f32, bk 32": (8, 256, (128, 32), 4, F32, F32, {}, "tf32x3"),
    "f32, bk 48": (8, 192, (128, 48), 4, F32, F32, {}, "simt"),
    "f32, bm 256": (8, 256, (256, 128), 2, F32, F32, {}, "simt"),
    "f32, K = 202 (rows of 808 bytes)": (8, 202, (128, 128), 2, F32, F32,
                                         {}, "simt"),
    "bf16, K = 204 (rows of 408 bytes)": (8, 204, (128, 128), 2, BF16, BF16,
                                          {}, "simt"),
    "bf16 x widened, K = 204": (8, 204, (128, 128), 2, BF16, F32, {},
                                "tf32x3"),
    "f32, x 4 bytes off": (8, 256, (128, 128), 2, F32, F32,
                           {"x_offset": 1}, "simt"),
    "f32, x 16 bytes off": (8, 256, (128, 128), 2, F32, F32,
                            {"x_offset": 4}, "tf32x3"),
    "bf16 x 2 bytes off, widened": (8, 256, (128, 128), 2, BF16, F32,
                                    {"x_offset": 1}, "tf32x3"),
    "f32, vals 4 bytes off": (8, 256, (128, 128), 2, F32, F32,
                              {"vals_offset": 1}, "simt"),
    "f32, x a transposed view": (8, 256, (128, 128), 2, F32, F32,
                                 {"x_transposed": True}, "simt"),
    "f32, batch 0": (0, 256, (128, 128), 2, F32, F32, {}, "simt"),
    "f32, no blocks": (8, 256, (128, 128), 0, F32, F32, {}, "simt"),
}


@pytest.mark.parametrize("case", sorted(_FC_CASES))
def test_fc_path_boundaries(case):
    n, k, (bm, bk), nnzb, xdt, vdt, kw, want = _FC_CASES[case]
    if kw.get("x_transposed"):
        x = _at((k, n), xdt).T
    else:
        x = _at((n, k), xdt, kw.get("x_offset", 0))
    vals = _at((nnzb, bm, bk), vdt, kw.get("vals_offset", 0))
    assert _module("sparse_fc").fc_path(x, vals, bm, bk) == want


def test_fc_cpu_calls_launch_no_kernel():
    """On CPU tensors the layer takes the plain version whatever the path,
    and counts no launch on any kernel; ``launch`` refuses CPU tensors and
    unknown kernels."""
    import numpy as np
    from repro_torch.kernels import BlockSparseFC
    mod = _module("sparse_fc")
    before = dict(mod.block_sparse_matvec.launches_by_path)
    assert set(before) == {"wgmma", "tf32x3", "simt"}
    fc = BlockSparseFC(np.ones((256, 256), np.float32), device="cpu")
    x = torch.randn(8, 256)
    assert mod.fc_path(x, fc._bundle[0], 128, 128) == "tf32x3"
    fc(x)
    fc(x.to(BF16))
    with pytest.raises(ValueError, match="runs on CUDA"):
        mod.launch(x, *fc._bundle, 256, "tf32x3", bm=128, bk=128)
    assert mod.block_sparse_matvec.launches_by_path == before
    assert (mod.HOPPER_BM, mod.HOPPER_ROWS) == (128, 128)
    assert mod.SLICE == {F32: 32, BF16: 64}


# --------------------------------------------------------------------------
# FIR: the flat kernel where its spans fit and its copies are aligned, else
# the first (tiled) design
# --------------------------------------------------------------------------

#: case: ((C, L, K), x dtype, taps dtype, options, flat_takes, fir_path).
#: The largest K of the flat design at L = 12 is 5 (MNIST's conv2) in f32,
#: 3 for bf16 x with f32 taps (a bf16 tile is 4,096 outputs, whose f32 tap
#: span is twice as long); at L = 300 it is 117 (f32).  fir_path takes it
#: from 132 tiles (2,048 f32 or 4,096 bf16 outputs each): 11,179 rows of
#: 24 outputs, not 11,178.
_FIR_CASES = {
    "MNIST conv2 rows, f32": ((819200, 12, 5), F32, F32, {}, True, "flat"),
    "MNIST conv1 rows, f32": ((491520, 28, 5), F32, F32, {}, True, "flat"),
    "8192^2, f32": ((8192, 8192, 5), F32, F32, {}, True, "flat"),
    "8192^2, bf16": ((8192, 8192, 5), BF16, BF16, {}, True, "flat"),
    "132 tiles": ((11179, 28, 5), F32, F32, {}, True, "flat"),
    "131 tiles": ((11178, 28, 5), F32, F32, {}, True, "tiled"),
    "the benchmark's 128 x 512 (32 tiles)": ((128, 512, 5), F32, F32, {},
                                             True, "tiled"),
    "L = 12, K = 6, f32": ((4, 12, 6), F32, F32, {}, False, "tiled"),
    "L = 12, K = 5, bf16": ((67584, 12, 5), BF16, BF16, {}, True, "flat"),
    "L = 12, K = 6, f32 x, bf16 taps": ((40000, 12, 6), F32, BF16, {}, True,
                                        "flat"),
    "L = 12, K = 3, bf16 x, f32 taps": ((70000, 12, 3), BF16, F32, {}, True,
                                        "flat"),
    "L = 12, K = 4, bf16 x, f32 taps": ((70000, 12, 4), BF16, F32, {}, False,
                                        "tiled"),
    "L = 300, K = 117, f32": ((3, 300, 117), F32, F32, {}, True, "tiled"),
    "L = 300, K = 118, f32": ((3, 300, 118), F32, F32, {}, False, "tiled"),
    "K = L": ((5, 12, 12), F32, F32, {}, False, "tiled"),
    "L = K = 1, f32": ((1, 1, 1), F32, F32, {}, False, "tiled"),
    "L = 2, K = 1, f32": ((1, 2, 1), F32, F32, {}, True, "tiled"),
    "x 4 bytes off": ((20000, 28, 5), F32, F32, {"x_offset": 1}, False,
                      "tiled"),
    "x 16 bytes off": ((20000, 28, 5), F32, F32, {"x_offset": 4}, True,
                       "flat"),
    "taps 2 bytes off": ((40000, 28, 5), BF16, BF16, {"taps_offset": 1},
                         False, "tiled"),
    "x a transposed view": ((20000, 28, 5), F32, F32, {"x_transposed": True},
                            False, "tiled"),
}


@pytest.mark.parametrize("case", sorted(_FIR_CASES))
def test_fir_path_boundaries(case):
    (c, length, k), xdt, tdt, kw, takes, want = _FIR_CASES[case]
    if kw.get("x_transposed"):
        x = _at((length, c), xdt).T
    else:
        x = _at((c, length), xdt, kw.get("x_offset", 0))
    taps = _at((c, k), tdt, kw.get("taps_offset", 0))
    mod = _module("fir_conv1d")
    assert mod.flat_takes(x, taps) == takes
    assert mod.fir_path(x, taps) == want


def test_fir_flat_fits_is_the_kernels_worst_case():
    """``flat_fits`` bounds every tile's spans: over the tile starts of
    four rounds of every row phase, the spans the kernel stages (rounded
    out to 16 bytes) fit the stage wherever ``flat_fits`` says so, and
    where it says not, some tile comes within the 32 bytes of rounding it
    allows of overflowing it."""
    mod = _module("fir_conv1d")
    for length, k, sx, st in ((12, 5, 4, 4), (12, 6, 4, 4), (28, 12, 2, 2),
                              (300, 117, 4, 4), (300, 118, 4, 4),
                              (13, 5, 2, 4)):
        t, lo = mod.FLAT_OUT_BYTES // sx, length - k + 1
        worst_in = worst_tap = 0
        for o0 in range(0, 4 * lo * t, t):      # tile starts, all phases
            r0, p0 = divmod(o0, lo)
            r1, p1 = divmod(o0 + t - 1, lo)
            first, end = r0 * length + p0, r1 * length + p1 + k
            worst_in = max(worst_in, -(-end * sx // 16) * 16
                           - first * sx // 16 * 16)
            worst_tap = max(worst_tap, -(-(r1 + 1) * k * st // 16) * 16
                            - r0 * k * st // 16 * 16)
        if mod.flat_fits(length, k, sx, st):
            assert worst_in <= mod.FLAT_IN_BYTES, (length, k, sx, st)
            assert worst_tap <= mod.FLAT_TAP_BYTES, (length, k, sx, st)
        else:
            assert worst_in > mod.FLAT_IN_BYTES - 32 \
                or worst_tap > mod.FLAT_TAP_BYTES - 32, (length, k, sx, st)


def test_fir_cpu_calls_launch_no_kernel():
    """On CPU tensors the entry point takes the plain version whatever the
    path and counts no launch; ``launch`` refuses CPU tensors and unknown
    kernels; the module's stage matches the kernel's."""
    mod = _module("fir_conv1d")
    before = dict(mod.fir_conv1d.launches_by_path)
    assert set(before) == {"flat", "tiled"}
    x, taps = torch.randn(40000, 12), torch.randn(40000, 5)
    assert mod.fir_path(x, taps) == "flat"
    assert torch.equal(mod.fir_conv1d(x, taps, cb=1),
                       mod.fir_conv1d_ref(x, taps))
    with pytest.raises(ValueError, match="runs on CUDA"):
        mod.launch(x, taps, "flat")
    with pytest.raises(ValueError, match="runs on CUDA"):
        mod.launch(x, taps, "tiled")
    assert mod.fir_conv1d.launches_by_path == before
    assert (mod.FLAT_OUT_BYTES, mod.FLAT_IN_BYTES, mod.FLAT_TAP_BYTES) == (
        8192, 14336, 6144)


# --------------------------------------------------------------------------
# SSD: the wgmma kernel for P = 64, Q a multiple of 64 up to 256, N a
# multiple of 64, aligned; else the first (CUDA-core) design
# --------------------------------------------------------------------------

#: case: ((BC, H, Q, P, N), dtypes of xdt, bb, cc, cs, options, path)
_SSD_CASES = {
    "mamba2-370m": ((32, 32, 256, 64, 128), (F32,) * 4, {}, "wgmma"),
    "mamba2-370m, bf16": ((32, 32, 256, 64, 128), (BF16,) * 4, {}, "wgmma"),
    "bf16 bb and cs": ((2, 3, 256, 64, 128), (F32, BF16, F32, BF16), {},
                       "wgmma"),
    "Q = N = 64": ((1, 1, 64, 64, 64), (F32,) * 4, {}, "wgmma"),
    "N = 192, 17 heads": ((2, 17, 256, 64, 192), (F32,) * 4, {}, "wgmma"),
    "Q = 320": ((1, 2, 320, 64, 128), (F32,) * 4, {}, "simt"),
    "Q = 100": ((1, 2, 100, 64, 128), (F32,) * 4, {}, "simt"),
    "N = 96": ((1, 2, 256, 64, 96), (F32,) * 4, {}, "simt"),
    "N = 32": ((1, 2, 256, 64, 32), (F32,) * 4, {}, "simt"),
    "P = 128": ((1, 2, 256, 128, 128), (F32,) * 4, {}, "simt"),
    "P = 70": ((1, 2, 100, 70, 70), (F32,) * 4, {}, "simt"),
    "no cells": ((0, 2, 256, 64, 128), (F32,) * 4, {}, "simt"),
    "xdt 4 bytes off": ((1, 2, 256, 64, 128), (F32,) * 4, {"offset": 0},
                        "simt"),
    "cs 2 bytes off": ((1, 2, 256, 64, 128), (F32, F32, F32, BF16),
                       {"offset": 3}, "simt"),
    "bb 16 bytes off": ((1, 2, 256, 64, 128), (F32,) * 4, {"offset": 1,
                                                          "by": 4},
                        "wgmma"),
}


@pytest.mark.parametrize("case", sorted(_SSD_CASES))
def test_ssd_path_boundaries(case):
    """``ssd_path`` from the shapes, dtypes, contiguity and alignment alone;
    ``offset`` names the input (0 xdt, 1 bb, 2 cc, 3 cs) placed ``by``
    elements (default 1) into its storage."""
    (bc, h, q, p, n), dts, kw, want = _SSD_CASES[case]
    shapes = ((bc, h, q, p), (bc, q, n), (bc, q, n), (bc, h, q))
    args = [_at(sh, dt, kw.get("by", 1) if kw.get("offset") == i else 0)
            for i, (sh, dt) in enumerate(zip(shapes, dts))]
    assert _module("ssd_intra").ssd_path(*args) == want


def test_ssd_path_refuses_strided_inputs():
    mod = _module("ssd_intra")
    xdt = torch.zeros(1, 2, 256, 64)
    bb = torch.zeros(1, 128, 256).transpose(1, 2)    # (1, 256, 128) view
    cs = torch.zeros(1, 2, 256)
    assert mod.ssd_path(xdt, bb.contiguous(), bb.contiguous(), cs) == "wgmma"
    assert mod.ssd_path(xdt, bb, bb.contiguous(), cs) == "simt"


def test_ssd_plan_and_cpu_calls():
    """Heads a CTA: 8 at mamba2-370m's 1,024 cells and above, fewer where
    the grid would leave SMs idle, never more than H (the picks the card's
    times favoured, PERF.md); CPU tensors take the plain version and launch
    nothing; ``launch`` refuses them and unknown kernels."""
    mod = _module("ssd_intra")
    picks = {(1, 1): 1, (1, 8): 2, (2, 8): 2, (4, 8): 2, (8, 8): 4,
             (16, 8): 2, (2, 32): 4, (4, 32): 2, (8, 32): 4, (16, 32): 8,
             (32, 32): 8, (64, 32): 8}
    assert {k: mod.ssd_plan(*k, 256, 128) for k in picks} == picks
    assert all(1 <= mod.ssd_plan(bc, h, q, n) <= min(h, mod.HEADS_PER_CTA)
               for bc in (1, 3, 40) for h in (1, 2, 5, 9, 33)
               for q in (64, 256) for n in (64, 192))
    assert mod.HEADS_PER_CTA == 8
    before = dict(mod.ssd_intra.launches_by_path)
    assert set(before) == {"wgmma", "simt", "wgmma_thread_fed"}
    assert set(mod.PATHS) < set(mod.BUILDS)
    args = (torch.randn(1, 2, 64, 64), torch.randn(1, 64, 64),
            torch.randn(1, 64, 64), -torch.rand(1, 2, 64).cumsum(-1))
    assert mod.ssd_path(*args) == "wgmma"
    y, s = mod.ssd_intra(*args)
    want = mod.ssd_intra_ref(*args)
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])
    with pytest.raises(ValueError, match="runs on CUDA"):
        mod.launch(*args, "wgmma")
    with pytest.raises(ValueError, match="runs on CUDA"):
        mod.launch(*args, "tf32")
    with pytest.raises(ValueError, match="runs on CUDA"):
        mod.launch(*args, "wgmma_thread_fed")
    assert mod.ssd_intra.launches_by_path == before


# --------------------------------------------------------------------------
# builds: a header edit renames every library
# --------------------------------------------------------------------------

def test_header_edit_changes_the_target(tmp_path, monkeypatch):
    """The library's name hashes the shared headers too: changing only a
    header changes it (so the library is rebuilt), and so does an added
    header; restoring the header restores the name."""
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n')
    header = tmp_path / "shared.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setitem(_build.SOURCE_FLAGS, "k", _build.FMAD_FLAGS)
    first = _build._target("k")
    assert first == _build._target("k")
    header.write_text("// v2\n")
    second = _build._target("k")
    assert second != first
    (tmp_path / "more.cuh").write_text("// new\n")
    assert _build._target("k") not in (first, second)
    (tmp_path / "more.cuh").unlink()
    header.write_text("// v1\n")
    assert _build._target("k") == first


def test_the_repo_headers_are_hashed():
    """The port's sources include ``csrc/hopper.cuh``, which the hash
    reads."""
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert "hopper.cuh" in headers
    for name in ("dense_matmul", "flash_attention"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in text


def test_a_reused_library_keeps_its_build_log(tmp_path, monkeypatch):
    """The build log (ptxas's registers and spills) is kept beside the
    library, so a library reused from an earlier build still reports it.
    nvcc is stood in for by a script that writes the library and a ptxas
    line; loading is stubbed out."""
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('not a library')\n"
        "print('ptxas info    : Used 168 registers, used 1 barriers')\n")
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(_build.SOURCE_FLAGS, "k", _build.FMAD_FLAGS)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: path)
    first = _build.build("k")["k"]
    assert first.seconds > 0 and "Used 168 registers" in first.log
    again = _build.build("k")["k"]
    assert again.seconds == 0.0 and again.path == first.path
    assert again.log == first.log
