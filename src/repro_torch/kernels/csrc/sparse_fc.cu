// Block-sparse FC: y (N, M) = x (N, K) @ W^T with W (M, K) stored block-CSR.
//
// Replaces the TPU kernel src/repro/kernels/sparse_fc.py:block_sparse_matvec
// (body _kernel), GENESIS's pruned FC.  On the TPU a uniform grid walks a
// host-made step plan (_plan): every row-block is padded to the widest one
// with repeats flagged invalid, and the block indices are scalar-prefetched
// so the pipeline can fetch the right weight block ahead of compute.  Here
// each thread block owns one output row-block and one tile of batch rows,
// reads its own row_ptr[i] .. row_ptr[i + 1] range, and walks only those
// nonzero blocks: no plan, no padding steps.  Each output sums its blocks in
// row_ptr order into f32 accumulators (no atomics).  Two kernels, chosen by
// the wrapper from the operands before the launch (sparse_fc.py:fc_path):
//
// * block_sparse_fc_hopper_kernel: 128-row blocks (bm = 128) whose bk is a
//   multiple of one 128-byte swizzle row (32 f32, 64 bf16), operands that
//   TMA can read.  A CTA owns one row-block and 128 batch rows.  One
//   producer warpgroup (registers lowered by setmaxnreg) has one thread
//   walk the row-block's stored blocks and, for each 128-byte K slice,
//   load by TMA the x tile (128 batch rows at column col_idx[p] * bk + c0,
//   a 2-D map over x) and the block's slice (128 weight rows, a 3-D map
//   over vals (nnzb, bm, bk)) into a ring of stages with full and empty
//   mbarriers.  Two consumer warpgroups own 64 batch rows each and run
//   wgmma m64n128 with both operands K-major as stored (the weight block
//   is B with N = bm): nothing is transposed.  TMA fills what lies past N
//   or K with zeros; the store masks ragged N and M.  A block is read once
//   per 128 batch rows, where the CUDA-core kernel reads it once per bn.
//   - bf16 x and vals ("wgmma"): wgmma bf16 k16 into f32 accumulators, 4
//     stages; the output is rounded to bf16 once.
//   - f32 x and vals ("tf32x3"): 3xTF32, 3 stages.  Each operand a is split
//     as hi = tf32(a), a rounded to 11 significant bits, and lo =
//     tf32(a - hi), and acc += x_hi w_hi + x_hi w_lo + x_lo w_hi, three
//     tf32 wgmma k8.  The split runs in the kernel, in shared memory: when
//     a stage lands, each consumer thread reads 16 words of its
//     warpgroup's x rows and 16 of its half of the weight slice, writes hi
//     back in place and lo to a ring of lo tiles (same offsets, so the
//     same swizzle and descriptors), then fence.proxy.async and a named
//     barrier over both consumer warpgroups, and only then issues wgmma on
//     the stage; the split of one stage runs beside the products of the
//     one before.  Nothing runs as a separate pass.  Why it is exact to
//     within 2^-21 of each product: a - hi is exact in f32 (hi is a
//     rounded at a's own exponent, and the 13 bits it drops fit), and
//     rounding it to lo moves it by at most 2^-11 of itself, 2^-22 of a;
//     hi and lo are written with their lower 13 bits 0, so the tensor core
//     reads them whole, whatever it does with those bits; a tf32 x tf32
//     product is exact in f32.  What is left out or rounded off (x_lo
//     w_lo, the two roundings to lo) is below 2^-21 |x w| and rounded to
//     nearest, so it does not grow with K the way a bias would (clearing
//     the bits instead of rounding them moves every product the same way,
//     and that error does grow with K).  The tensor cores' own
//     accumulation is coarser than an f32 add: summing all of K into one
//     accumulator left the output several times as far from the f64
//     product as the plain f32 version, on an H100.  So a slice's
//     x_hi w_hi products sum into a partial accumulator that the CUDA
//     cores add to the f32 one each slice (32 K terms at a time on the
//     tensor cores), and the two small products, at most 2^-10 of those,
//     sum over all of K into a third accumulator, added at the end.
// * block_sparse_fc_kernel ("simt"): every other f32 block shape, on the
//   CUDA cores, one thread per output row (bm threads) and one tile of BN
//   batch rows.  A 128 x 128 f32 weight block is 64 KB, more than a
//   block's 48 KB of static shared memory, so it is staged in slices of KS
//   columns, stored transposed with rows padded by one so that both the
//   store and each thread's read of its own output row are free of bank
//   conflicts.  The matching KS columns of the BN batch rows are staged
//   beside it and read as broadcasts.  Each output sums its blocks in
//   row_ptr order and each block's columns in order, with fmaf into a f32
//   register; ragged N, M and K (the weight padded past K) are masked
//   here.  The wrapper widens bf16 operands that reach it to f32.
//
// What bounds it on an H100: operations, for a batch of hundreds.  The
// Hopper kernel's are 2 * N * nnzb * bm * bk, over 989 TFLOP/s for bf16
// and, three tf32 products each, over 494.7 TFLOP/s for 3xTF32; its split
// and the tensor core's reads share the SM's shared-memory bandwidth.  The
// CUDA-core kernel's are the same count over 67 TFLOP/s; it makes only BN
// FMAs per weight word it reads from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#define KS 32   // weight-block columns staged per step

template <int BN>
__global__ void block_sparse_fc_kernel(const float* __restrict__ x,
                                       const float* __restrict__ vals,
                                       const int* __restrict__ row_ptr,
                                       const int* __restrict__ col_idx,
                                       float* __restrict__ y, int n, int k,
                                       int m, int bm, int bk) {
  extern __shared__ float smem[];
  const int ldw = bm + 1;
  float* ws = smem;              // (KS, bm + 1): a weight-block slice, transposed
  float* xs = ws + KS * ldw;     // (BN, KS): the batch tile's matching columns
  const int r = threadIdx.x;     // output row within the row-block
  const int i = blockIdx.x;      // row-block
  const long long n0 = (long long)blockIdx.y * BN;

  float acc[BN];
#pragma unroll
  for (int b = 0; b < BN; ++b) acc[b] = 0.0f;

  const int p_end = row_ptr[i + 1];
  for (int p = row_ptr[i]; p < p_end; ++p) {
    const long long kcol0 = (long long)col_idx[p] * bk;
    const float* blk = vals + (long long)p * bm * bk;
    for (int c0 = 0; c0 < bk; c0 += KS) {
      const int kw = min(KS, bk - c0);
      __syncthreads();           // the previous slice has been read
      for (int e = r; e < bm * kw; e += bm) {
        const int rr = e / kw, cc = e - rr * kw;
        ws[cc * ldw + rr] = blk[(long long)rr * bk + c0 + cc];
      }
      for (int e = r; e < BN * kw; e += bm) {
        const int b = e / kw, cc = e - b * kw;
        const long long gn = n0 + b, gk = kcol0 + c0 + cc;
        xs[b * KS + cc] = (gn < n && gk < k) ? x[gn * k + gk] : 0.0f;
      }
      __syncthreads();
      for (int cc = 0; cc < kw; ++cc) {
        const float wv = ws[cc * ldw + r];
#pragma unroll
        for (int b = 0; b < BN; ++b) acc[b] = fmaf(xs[b * KS + cc], wv, acc[b]);
      }
    }
  }

  const long long gm = (long long)i * bm + r;
  if (gm >= m) return;
#pragma unroll
  for (int b = 0; b < BN; ++b)
    if (n0 + b < n) y[(n0 + b) * m + gm] = acc[b];
}

template <int BN>
static int launch(const float* x, const float* vals, const int* row_ptr,
                  const int* col_idx, float* y, int n, int k, int m, int nbr,
                  int bm, int bk, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)KS * (bm + 1) + (size_t)BN * KS);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_sparse_fc_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(nbr, (n + BN - 1) / BN);
  block_sparse_fc_kernel<BN><<<grid, bm, smem, stream>>>(
      x, vals, row_ptr, col_idx, y, n, k, m, bm, bk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 128-row blocks on the tensor cores: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

#define HP_ROWS 128              // batch rows of a CTA (two warpgroups)
#define HP_BM 128                // weight rows of a block (wgmma N)
#define HP_THREADS 384           // producer + two consumer warpgroups
#define HP_CONSUMER_WARPS 8

// A stage is the x and weight slices TMA brings (32 KB); for 3xTF32 the lo
// parts of a slice go to a ring of their own, LO_BUFS deep: a warpgroup
// writes slice it + 1's while both read slice it's, and the named barrier
// of slice it + 1's split keeps it from writing slice it + 2's before the
// other warpgroup has finished with slice it - 1's, so three buffers
// suffice.
template <bool TF32> struct HopperTiles;
template <> struct HopperTiles<true> {     // f32 operands, 3xTF32
  static constexpr int SLICE = 32;          // f32 in a 128-byte row
  static constexpr int STAGES = 3;
  static constexpr int LO_BUFS = 3;
};
template <> struct HopperTiles<false> {    // bf16 operands
  static constexpr int SLICE = 64;          // bf16 in a 128-byte row
  static constexpr int STAGES = 4;
  static constexpr int LO_BUFS = 0;
};
constexpr uint32_t HP_X_BYTES = HP_ROWS * 128;              // 16 KB
constexpr uint32_t HP_STAGE = HP_X_BYTES + HP_BM * 128;     // 32 KB

template <bool TF32>
constexpr size_t hopper_smem() {
  return 1024 + (HopperTiles<TF32>::STAGES + HopperTiles<TF32>::LO_BUFS) *
                    HP_STAGE +
         2 * HopperTiles<TF32>::STAGES * 8;
}

template <bool TF32>
__global__ void __launch_bounds__(HP_THREADS, 1)
    block_sparse_fc_hopper_kernel(const __grid_constant__ CUtensorMap xmap,
                                  const __grid_constant__ CUtensorMap wmap,
                                  const int* __restrict__ row_ptr,
                                  const int* __restrict__ col_idx,
                                  void* __restrict__ y, int n, int k, int m,
                                  int bk) {
  using namespace hopper;
  typedef HopperTiles<TF32> C;
  extern __shared__ __align__(16) unsigned char hsmem[];
  // stage s at tiles + s HP_STAGE (tiles: hsmem rounded up to 1024 bytes):
  // the x slice (128 rows of 128 bytes), then the weight slice (128 rows);
  // for 3xTF32 the lo ring after the stages, the lo parts of slice it at
  // lo_tiles + (it % LO_BUFS) HP_STAGE with the same layout
  const uint32_t smem0 = smem_addr(hsmem);
  const uint32_t tiles = (smem0 + 1023) & ~1023u;
  const uint32_t lo_tiles = tiles + C::STAGES * HP_STAGE;
  const uint32_t bars = lo_tiles + C::LO_BUFS * HP_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (C::STAGES + s); };
  const int wg = threadIdx.x / 128;
  const int i = blockIdx.x;                     // row-block
  const int n0 = blockIdx.y * HP_ROWS;          // first batch row
  const int p0 = row_ptr[i];
  const int per_block = bk / C::SLICE;             // K slices of a block
  const int n_slices = (row_ptr[i + 1] - p0) * per_block;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), HP_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread walks the stored blocks and keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int it = 0; it < n_slices; ++it) {
        const int s = it % C::STAGES;
        const int p = p0 + it / per_block;
        const int c0 = (it % per_block) * C::SLICE;
        // a column at or past K reads zeros: clamp it so it stays an int
        const long long col = (long long)col_idx[p] * bk + c0;
        mbar_wait(empty(s), ((it / C::STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), HP_STAGE);
        const uint32_t t = tiles + s * HP_STAGE;
        tma_load_2d(t, &xmap, full(s), col < k ? (int)col : k, n0);
        tma_load_3d(t + HP_X_BYTES, &wmap, full(s), c0, 0, p);
      }
    }
    return;
  }

  // consumers: warpgroup c owns batch rows n0 + 64 c .. + 63
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
  if constexpr (TF32) {
    unsigned char* const gtiles = hsmem + (tiles - smem0);
    // wait for slice it, split this warpgroup's 64 x rows and its half of
    // the weight rows (512 float4 each), and make both halves of both
    // visible to wgmma
    auto split = [&](int it) {
      const int s = it % C::STAGES;
      mbar_wait(full(s), (it / C::STAGES) & 1);
      float4* raw = reinterpret_cast<float4*>(gtiles + s * HP_STAGE);
      float4* lo = reinterpret_cast<float4*>(
          gtiles + (lo_tiles - tiles) + (it % C::LO_BUFS) * HP_STAGE);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        split_tf32(raw, lo, c * 512 + tid + 128 * j);
        split_tf32(raw, lo, 1024 + c * 512 + tid + 128 * j);
      }
      fence_proxy_async();
      named_barrier_sync(1, 256);
    };
    // The tensor cores' accumulation is coarser than an f32 add.  So a
    // slice's x_hi w_hi products sum into part, which the CUDA cores then
    // add to acc: the tensor cores sum 32 K terms of it at a time.  The
    // small products x_hi w_lo + x_lo w_hi, at most 2^-10 of those, sum
    // over all of K into small, where that coarseness costs 2^-10 as much.
    float part[64], small[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) small[j] = 0.0f;
    if (n_slices > 0) split(0);
    for (int it = 0; it < n_slices; ++it) {
      const int s = it % C::STAGES;
      const uint32_t t = tiles + s * HP_STAGE;
      const uint32_t a = t + c * 64 * 128;      // this warpgroup's x rows
      const uint32_t b = t + HP_X_BYTES;        // the weight slice
      const uint32_t lo = lo_tiles + (it % C::LO_BUFS) * HP_STAGE - t;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        // both K-major: k-step ks is 32 bytes (8 f32) into each row
        const uint64_t ah = desc_sw128(a + 32 * ks, 16, 1024);
        const uint64_t al = desc_sw128(a + lo + 32 * ks, 16, 1024);
        const uint64_t bh = desc_sw128(b + 32 * ks, 16, 1024);
        const uint64_t bl = desc_sw128(b + lo + 32 * ks, 16, 1024);
        wgmma_m64n128k8_tf32_ss(small, ah, bl, 1);
        wgmma_m64n128k8_tf32_ss(small, al, bh, 1);
        wgmma_m64n128k8_tf32_ss(part, ah, bh, ks > 0);
      }
      wgmma_commit();
      fence_regs(part);
      fence_regs(small);
      if (it + 1 < n_slices) split(it + 1);     // beside this slice's products
      wgmma_wait<0>();
      fence_regs(part);
      fence_regs(small);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += part[j];
      if (lane == 0) mbar_arrive(empty(s));
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += small[j];
  } else {
    for (int it = 0; it < n_slices; ++it) {
      const int s = it % C::STAGES;
      mbar_wait(full(s), (it / C::STAGES) & 1);
      const uint32_t t = tiles + s * HP_STAGE;
      const uint32_t a = t + c * 64 * 128;      // this warpgroup's x rows
      const uint32_t b = t + HP_X_BYTES;        // the weight slice
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        // both K-major: k-step ks is 32 bytes (16 bf16) into each row
        wgmma_m64n128k16_ss<0>(acc, desc_sw128(a + 32 * ks, 16, 1024),
                               desc_sw128(b + 32 * ks, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();                          // slice it - 1 is done
      if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % C::STAGES));
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // acc[j]: batch row r (+ 8 if j & 2), weight row 8 (j / 4) + 2 (lane % 4)
  // + (j & 1) of the block, which is output column i * 128 + that
  const int r = n0 + c * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const long long row = r + ((j & 2) ? 8 : 0);
    const int col = i * HP_BM + (j >> 2) * 8 + (lane & 3) * 2 + (j & 1);
    if (row < n && col < m) {
      if constexpr (TF32)
        static_cast<float*>(y)[row * m + col] = acc[j];
      else
        static_cast<__nv_bfloat16*>(y)[row * m + col] =
            __float2bfloat16_rn(acc[j]);
    }
  }
}

template <bool TF32>
static int launch_hopper(const void* x, const void* vals, const int* row_ptr,
                         const int* col_idx, void* y, int n, int k, int m,
                         int nbr, int nnzb, int bk, cudaStream_t stream) {
  typedef HopperTiles<TF32> C;
  const CUtensorMapDataType type = TF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)k, (uint64_t)n};   // innermost first
  const uint32_t xbox[2] = {C::SLICE, HP_ROWS};
  const uint64_t wdims[3] = {(uint64_t)bk, HP_BM, (uint64_t)nnzb};
  const uint32_t wbox[3] = {C::SLICE, HP_BM, 1};
  int err = hopper::make_tensor_map(&xmap, x, 2, xdims, xbox, type);
  if (err == 0)
    err = hopper::make_tensor_map(&wmap, vals, 3, wdims, wbox, type);
  if (err != 0) return err;
  constexpr size_t smem = hopper_smem<TF32>();
  cudaError_t e = cudaFuncSetAttribute(
      block_sparse_fc_hopper_kernel<TF32>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(nbr, (n + HP_ROWS - 1) / HP_ROWS);
  block_sparse_fc_hopper_kernel<TF32><<<grid, HP_THREADS, smem, stream>>>(
      xmap, wmap, row_ptr, col_idx, y, n, k, m, bk);
  return (int)cudaGetLastError();
}

extern "C" {

// y (n, m) = x (n, k) @ W^T on the CUDA cores, W given as vals (nnzb, bm,
// bk), row_ptr (nbr + 1) and col_idx (nnzb), all contiguous: f32 values,
// int32 indices.
// One block per (row-block, bn batch rows), bm threads each; bn is one of
// 1, 2, 4, 8, 16, 32.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for another bn.
int block_sparse_fc_launch(const float* x, const float* vals,
                           const int* row_ptr, const int* col_idx, float* y,
                           int n, int k, int m, int nbr, int bm, int bk,
                           int bn, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 1: return launch<1>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 2: return launch<2>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 4: return launch<4>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 8: return launch<8>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 16: return launch<16>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    case 32: return launch<32>(x, vals, row_ptr, col_idx, y, n, k, m, nbr, bm, bk, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The Hopper kernel's block rows (bm) and batch rows a CTA; the wrapper
// checks them.
int block_sparse_fc_hopper_bm() { return HP_BM; }
int block_sparse_fc_hopper_rows() { return HP_ROWS; }

// y (n, m) = x (n, k) @ W^T on the Hopper kernel: f32 x, vals and y with
// 3xTF32 (tf32 = 1), or bf16 (tf32 = 0); vals (nnzb, 128, bk) with bk a
// multiple of 32 (f32) or 64 (bf16); row_ptr (nbr + 1) and col_idx (nnzb)
// int32.  All contiguous, x and vals 16-byte aligned, k a multiple of 4
// (f32) or 8 (bf16), n, k, nnzb >= 1, (n + 127) / 128 <= 65535; the wrapper
// checks them.  Returns 0 on success, else a cudaError_t (from building a
// tensor map or from the launch).
int block_sparse_fc_hopper_launch(const void* x, const void* vals,
                                  const int* row_ptr, const int* col_idx,
                                  void* y, int n, int k, int m, int nbr,
                                  int nnzb, int bk, int tf32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return tf32 ? launch_hopper<true>(x, vals, row_ptr, col_idx, y, n, k, m,
                                    nbr, nnzb, bk, s)
              : launch_hopper<false>(x, vals, row_ptr, col_idx, y, n, k, m,
                                     nbr, nnzb, bk, s);
}

}  // extern "C"
