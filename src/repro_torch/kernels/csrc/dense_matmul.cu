// Tiled dense matmul: out (M, N) = x (M, K) @ w (K, N), f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/dense_matmul.py:matmul (body
// _matmul_kernel), SONIC's loop-ordered accumulation on the MXU: a
// (M/bm, N/bn, K/bk) grid whose innermost, sequential K axis keeps each
// output tile in a f32 VMEM accumulator and commits it once.  Here one
// thread block owns one output tile and loops over K itself, the
// accumulators in registers.  Ragged M, N and K are handled here, so the
// caller pads nothing.  Four kernels, chosen by the wrapper from the
// operands before the launch (dense_matmul.py:matmul_path):
//
// * matmul_wgmma_kernel: bf16 on the tensor cores, for contiguous,
//   16-byte-aligned bf16 operands with K and N multiples of 8 (TMA's
//   16-byte row strides).  A block owns a 128 x 128 output tile and walks
//   K in 64-wide slices through a 4-stage ring in shared memory (32 KB a
//   stage: x's 128 x 64 box and w's 64 x 128 as two 64 x 64 boxes, all
//   with the 128-byte swizzle), each stage with a full and an empty
//   mbarrier.  One producer warpgroup (registers lowered by setmaxnreg)
//   has one thread issue the TMA loads; two consumer warpgroups each own
//   64 rows and run wgmma m64n128k16, four k-steps a slice, keeping one
//   slice's products in flight while the next is issued.  x is K-major as
//   stored; w, row-major, is the MN-major B operand (the transpose bit):
//   nothing is transposed in memory.  TMA fills whatever of a box lies
//   past M, N or K with zeros, so a K tail adds zeros; stores are masked.
//   The f32 accumulators are rounded to bf16 once (round to nearest
//   even), as _matmul_kernel's single astype does.  Layout rules of the
//   tiles and descriptors: hopper.cuh.
// * matmul_tf32x3_kernel: f32 on the tensor cores as 3xTF32, for the f32
//   operands TMA can read (contiguous, 16-byte aligned, K and N multiples
//   of 4).  The same shape of kernel as the bf16 one (128 x 128 output
//   tiles, a producer warpgroup feeding a 4-stage TMA ring, two consumer
//   warpgroups on wgmma m64n128) with block_sparse_fc_hopper_kernel's
//   arithmetic (sparse_fc.cu): each operand split into two tf32 parts
//   rounded to nearest, three of the four products, a partial accumulator
//   a 32-wide K slice added on the CUDA cores, the two small products in
//   an accumulator of their own.  Two things differ:
//   - w is MN-major and tf32 wgmma has no transpose bit, so the split
//     transposes it: w's slice lands as four 32 x 32 boxes, and the
//     consumers write its hi and lo parts K-major into a set of split
//     tiles (x's hi stays in place and its lo goes to the same set).  Two
//     sets, and a barrier that keeps a warpgroup from refilling one before
//     the other's products have read it, fit beside the 4 stages (225 KB).
//   - To fill the card when the tiles are few (24 at 512 x 1024 x 768),
//     K is split over a cluster of 1, 2 or 4 CTAs (the wrapper chooses,
//     dense_matmul.py:tf32x3_plan).  Each sums its share of the slices;
//     then each writes its partial tile to its shared memory, and CTA r of
//     the cluster adds rows r * 128 / split .. of all of them, read through
//     distributed shared memory in rank order, and stores them.  The sum
//     has the same order in every run (no atomics), so the output is the
//     same bit for bit.
// * matmul_narrow_kernel: f32 and bf16 operands with N up to 64 that
//   neither tensor-core kernel takes (MNIST's fc3: 1024 x 500 x 10, whose
//   40-byte rows of w TMA cannot read).  The product is 10 MFLOP over 2 MB,
//   bound by latency and the launch, so the design is about filling the
//   card: a CTA takes a band of bm rows of x (the wrapper sizes it so the
//   CTAs cover the 132 SMs: 8 rows, 128 CTAs at fc3), a thread one output,
//   and K goes through shared memory in slices as long as two stages allow
//   (all of K at fc3), copied with cp.async.  Each output is one fmaf chain
//   over K in order from 0.0f, as in matmul_kernel, so the two kernels give
//   the same bits.
// * matmul_kernel: f32 and bf16 operands that no other kernel takes, on
//   the CUDA cores.  The tiles (bm, bk, bn) are the caller's; the
//   accumulators are an 8 x 8 micro-tile per thread, so a block has
//   (bm / 8) * (bn / 8) threads.  Each K slice of x (stored transposed,
//   rows padded by one against bank conflicts) and of w is staged in
//   shared memory; threads own strided rows and columns of the tile, so
//   neighbouring threads read neighbouring words and write neighbouring
//   outputs.  f32 inputs are multiplied in full f32 (fmaf), never in TF32;
//   bf16 inputs are widened to f32 as they are read and the output is
//   rounded to bf16 once.
//
// What bounds it on an H100: a large product is bound by operations, 2MNK
// over 989 TFLOP/s for bf16 on the tensor cores, three times that over
// 494.7 TFLOP/s for 3xTF32, and 2MNK over 67 TFLOP/s for f32 on the CUDA
// cores.  The wgmma kernels keep the tensor cores fed from a TMA ring that
// no thread spends instructions on; the 3xTF32 one also spends shared-
// memory bandwidth on its split, and waits each slice for its partial sum.
// What they leave to later work is a persistent grid (one tile's epilogue
// over the next one's loads), clusters with TMA multicast, and a TMA store
// of the output.  The CUDA-core kernel feeds its FMAs from shared memory
// with scalar loads, 16 loads for 64 FMAs, with one stage and no
// copy/compute overlap.  The narrow kernel is bound by latency: the round
// trip that stages a slice, then each output's chain of K dependent fmaf,
// each waiting on its two operands' loads from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

#define TILE 8            // the micro-tile: TILE x TILE outputs a thread
#define MAX_THREADS 256   // (128 / TILE)^2: the largest tile, 128 x 128

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T narrow(float v);
template <> __device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(
    float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
    matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  T* __restrict__ out, int m, int k, int n, int bm, int bk,
                  int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = bm + 1;                  // padded row of the x tile
  T* xs = reinterpret_cast<T*>(smem);      // (bk, bm + 1): x slice, transposed
  T* ws = xs + bk * ldx;                   // (bk, bn): w slice
  const int trows = bm / TILE, tcols = bn / TILE;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int tr = tid / tcols, tc = tid - tr * tcols;
  const long long row0 = (long long)blockIdx.y * bm;
  const long long col0 = (long long)blockIdx.x * bn;
  const T zero = narrow<T>(0.0f);

  float acc[TILE][TILE];
#pragma unroll
  for (int i = 0; i < TILE; ++i)
#pragma unroll
    for (int j = 0; j < TILE; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += bk) {
    const int kw = min(bk, k - k0);
    for (int e = tid; e < bm * kw; e += nthreads) {
      const int r = e / kw, kk = e - r * kw;
      const long long gr = row0 + r;
      xs[kk * ldx + r] = gr < m ? x[gr * k + k0 + kk] : zero;
    }
    for (int e = tid; e < kw * bn; e += nthreads) {
      const int kk = e / bn, c = e - kk * bn;
      const long long gc = col0 + c;
      ws[kk * bn + c] = gc < n ? w[(long long)(k0 + kk) * n + gc] : zero;
    }
    __syncthreads();
    for (int kk = 0; kk < kw; ++kk) {
      float a[TILE], b[TILE];
#pragma unroll
      for (int i = 0; i < TILE; ++i) a[i] = widen(xs[kk * ldx + tr + i * trows]);
#pragma unroll
      for (int j = 0; j < TILE; ++j) b[j] = widen(ws[kk * bn + tc + j * tcols]);
#pragma unroll
      for (int i = 0; i < TILE; ++i)
#pragma unroll
        for (int j = 0; j < TILE; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TILE; ++i) {
    const long long r = row0 + tr + i * trows;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TILE; ++j) {
      const long long c = col0 + tc + j * tcols;
      if (c < n) out[r * n + c] = narrow<T>(acc[i][j]);
    }
  }
}

template <typename T>
static int launch(const void* x, const void* w, void* out, int m, int k,
                  int n, int bm, int bk, int bn, cudaStream_t stream) {
  const size_t smem = sizeof(T) * ((size_t)(bm + 1) * bk + (size_t)bk * bn);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((n + bn - 1) / bn, (m + bm - 1) / bm);
  const int threads = (bm / TILE) * (bn / TILE);
  matmul_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      m, k, n, bm, bk, bn);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// A narrow N (MNIST's fc3: 1024 x 500 x 10) on the CUDA cores
// ---------------------------------------------------------------------------

#define NR_MAX_THREADS 1024  // threads a CTA, at most: one output each
#define NR_MAX_ROWS 64       // rows of x a CTA, at most
#define NR_MAX_N 64          // the widest N the kernel takes
#define NR_SMEM_MAX (96 * 1024)  // shared memory a CTA, at most: two stages

// cp.async.ca.shared.global of 4 bytes: one f32 of a K slice, from global
// into shared memory, landing some time after it is issued.
__device__ __forceinline__ void nr_stage(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
// A bf16 (2 bytes, below cp.async's 4) is loaded and stored.
__device__ __forceinline__ void nr_stage(__nv_bfloat16* dst,
                                         const __nv_bfloat16* src) {
  *dst = *src;
}
// cp.async.commit_group: this thread's copies since the last commit are
// one group.
__device__ __forceinline__ void nr_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// cp.async.wait_group N: at most N of this thread's groups in flight.
template <int N>
__device__ __forceinline__ void nr_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A band of bm rows of x times all of w, a thread an output: thread t owns
// output (t / n, t % n) of the band.  K is walked in slices of bk through
// two stages of shared memory (x's slice, rows padded by one, then w's
// rows k0.., which are contiguous), slice i + 1 copied while slice i is
// summed.  The wrapper makes bk as long as two stages allow
// (dense_matmul.py:narrow_plan): a slice costs a round trip to memory
// whatever its length, and its sums alone are too short to hide one.
template <typename T>
__global__ void __launch_bounds__(NR_MAX_THREADS)
    matmul_narrow_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         T* __restrict__ out, int m, int k, int n, int bm,
                         int bk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldx = bk + 1;
  const int stage_elems = bm * ldx + bk * n;
  T* buf = reinterpret_cast<T*>(smem);
  const long long row0 = (long long)blockIdx.x * bm;
  const int rows = (int)min((long long)bm, (long long)m - row0);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int r = tid / n, c = tid - r * n;
  const bool mine = r < rows;
  const int slices = (k + bk - 1) / bk;

  auto load = [&](int slice) {
    const int k0 = slice * bk, kw = min(bk, k - k0);
    T* xs = buf + (slice & 1) * stage_elems;
    T* ws = xs + bm * ldx;
    for (int rr = 0; rr < rows; ++rr)
      for (int kk = tid; kk < kw; kk += nthreads)
        nr_stage(&xs[rr * ldx + kk], &x[(row0 + rr) * k + k0 + kk]);
    const T* wsrc = w + (long long)k0 * n;
    for (int e = tid; e < kw * n; e += nthreads) nr_stage(&ws[e], &wsrc[e]);
    nr_commit();
  };

  float acc = 0.0f;
  if (slices > 0) load(0);
  for (int i = 0; i < slices; ++i) {
    if (i + 1 < slices) {
      load(i + 1);               // its stage was last read before the
      nr_wait<1>();              // __syncthreads() that ended slice i - 1
    } else {
      nr_wait<0>();
    }
    __syncthreads();             // slice i has landed, every thread's part
    if (mine) {
      const T* xr = buf + (i & 1) * stage_elems + r * ldx;
      const T* wc = buf + (i & 1) * stage_elems + bm * ldx + c;
      const int kw = min(bk, k - i * bk);
      int kk = 0;
      // 16 terms' operands read first, so that their loads overlap, then
      // their 16 multiply-adds in order
      for (; kk + 16 <= kw; kk += 16) {
        float a[16], b[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          a[u] = widen(xr[kk + u]);
          b[u] = widen(wc[(kk + u) * n]);
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) acc = fmaf(a[u], b[u], acc);
      }
      for (; kk < kw; ++kk) acc = fmaf(widen(xr[kk]), widen(wc[kk * n]), acc);
    }
    __syncthreads();
  }
  if (mine) out[(row0 + r) * n + c] = narrow<T>(acc);
}

template <typename T>
static int launch_narrow(const void* x, const void* w, void* out, int m,
                         int k, int n, int bm, int bk, cudaStream_t stream) {
  const size_t smem = 2 * sizeof(T) * ((size_t)bm * (bk + 1) + (size_t)bk * n);
  if (bm < 1 || bm > NR_MAX_ROWS || n < 1 || n > NR_MAX_N ||
      bm * n > NR_MAX_THREADS || bk < 1 || smem > NR_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    // the opt-in above the default 48 KB, once a device and type (a call
    // costs microseconds)
    static bool opted_in[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64 || !opted_in[dev]) {
      e = cudaFuncSetAttribute(matmul_narrow_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               NR_SMEM_MAX);
      if (e != cudaSuccess) return (int)e;
      if (dev < 64) opted_in[dev] = true;
    }
  }
  const int threads = (bm * n + 31) / 32 * 32;
  const int grid = (m + bm - 1) / bm;
  matmul_narrow_kernel<T><<<grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      m, k, n, bm, bk);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

#define WG_BM 128                  // output rows of a block (two warpgroups)
#define WG_BN 128                  // output columns of a block
#define WG_BK 64                   // K slice: one 128-byte swizzle row
#define WG_STAGES 4                // slices in flight
#define WG_THREADS 384             // producer + two consumer warpgroups
#define WG_CONSUMER_WARPS 8

static_assert(WG_BM == 2 * 64 && WG_BN == 128 && WG_BK == 64,
              "two warpgroups of 64 rows, wgmma m64n128, a 128-byte K row");

constexpr uint32_t WG_X_BYTES = WG_BM * WG_BK * 2;       // x box, 16 KB
constexpr uint32_t WG_W_BOX = WG_BK * 64 * 2;            // w box, 8 KB
constexpr uint32_t WG_STAGE = WG_X_BYTES + 2 * WG_W_BOX;  // 32 KB
constexpr size_t WG_SMEM = 1024 + WG_STAGES * WG_STAGE + 2 * WG_STAGES * 8;

__global__ void __launch_bounds__(WG_THREADS, 1)
    matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        __nv_bfloat16* __restrict__ out, int m, int k,
                        int n) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage s at tiles + s WG_STAGE (tiles: smem rounded up to 1024 bytes):
  // x's box, then w's two boxes 16 KB and 24 KB on
  const uint32_t tiles = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t bars = tiles + WG_STAGES * WG_STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (WG_STAGES + s); };
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * WG_BM, n0 = blockIdx.x * WG_BN;
  const int n_slices = (k + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_slices; ++i) {
        const int s = i % WG_STAGES;
        mbar_wait(empty(s), ((i / WG_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), WG_STAGE);
        const uint32_t t = tiles + s * WG_STAGE;
        tma_load_2d(t, &xmap, full(s), i * WG_BK, m0);
        tma_load_2d(t + WG_X_BYTES, &wmap, full(s), n0, i * WG_BK);
        tma_load_2d(t + WG_X_BYTES + WG_W_BOX, &wmap, full(s), n0 + 64,
                    i * WG_BK);
      }
    }
    return;
  }

  // consumers: warpgroup c owns output rows m0 + 64 c .. + 63
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float acc[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
  for (int i = 0; i < n_slices; ++i) {
    const int s = i % WG_STAGES;
    mbar_wait(full(s), (i / WG_STAGES) & 1);
    const uint32_t t = tiles + s * WG_STAGE;
    const uint32_t a = t + c * 64 * 128;     // this warpgroup's 64 x rows
    const uint32_t b = t + WG_X_BYTES;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < WG_BK / 16; ++ks)
      // x K-major: +32 bytes a k-step; w MN-major: +16 rows of 128 bytes,
      // its second 64-column box 8 KB on (LBO)
      wgmma_m64n128k16_ss<1>(acc, desc_sw128(a + 32 * ks, 16, 1024),
                             desc_sw128(b + 2048 * ks, WG_W_BOX, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();                         // slice i - 1 is done
    if (i > 0 && lane == 0) mbar_arrive(empty((i - 1) % WG_STAGES));
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[j]: row r (+ 8 if j & 2), columns 8 (j / 4) + 2 (lane % 4) + (j & 1)
  const int r = m0 + c * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const long long row = r + ((j & 2) ? 8 : 0);
    const int col = n0 + (j >> 2) * 8 + (lane & 3) * 2;
    if (row < m && col < n) {                 // n is even: col + 1 < n too
      __nv_bfloat162 v = __floats2bfloat162_rn(acc[j], acc[j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + row * n + col) = v;
    }
  }
}

static int launch_wgmma(const void* x, const void* w, void* out, int m, int k,
                        int n, cudaStream_t stream) {
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)k, (uint64_t)m};   // innermost first
  const uint32_t xbox[2] = {WG_BK, WG_BM};
  const uint64_t wdims[2] = {(uint64_t)n, (uint64_t)k};
  const uint32_t wbox[2] = {64, WG_BK};
  int err = hopper::make_tensor_map(&xmap, x, 2, xdims, xbox);
  if (err == 0) err = hopper::make_tensor_map(&wmap, w, 2, wdims, wbox);
  if (err != 0) return err;
  cudaError_t e = cudaFuncSetAttribute(
      matmul_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)WG_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((n + WG_BN - 1) / WG_BN, (m + WG_BM - 1) / WG_BM);
  matmul_wgmma_kernel<<<grid, WG_THREADS, WG_SMEM, stream>>>(
      xmap, wmap, static_cast<__nv_bfloat16*>(out), m, k, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32 on the tensor cores: 3xTF32 wgmma fed by a TMA ring, K split over a
// cluster
// ---------------------------------------------------------------------------

#define TF_BM 128                  // output rows of a CTA (two warpgroups)
#define TF_BN 128                  // output columns of a CTA
#define TF_BK 32                   // K slice: one 128-byte swizzle row of f32
#define TF_STAGES 4                // raw slices in flight
#define TF_SETS 2                  // split slices (x lo, w hi, w lo)
#define TF_MAX_SPLIT 4             // CTAs of a cluster that share one tile
#define TF_LD 136                  // row of the exchanged partial tile, f32

constexpr uint32_t TF_X_BYTES = TF_BM * 128;              // x box, 16 KB
constexpr uint32_t TF_W_BOX = TF_BK * 128;                // 32 k x 32 n, 4 KB
constexpr uint32_t TF_STAGE = TF_X_BYTES + 4 * TF_W_BOX;  // 32 KB
constexpr uint32_t TF_TILE = 128 * 128;                   // 128 K-major rows
constexpr uint32_t TF_SET = 3 * TF_TILE;                  // 48 KB
constexpr size_t TF_SMEM = 1024 + TF_STAGES * TF_STAGE + TF_SETS * TF_SET +
                           2 * TF_STAGES * 8;

static_assert(TF_BM == 2 * 64 && TF_BN == 4 * 32 && TF_BK == 32,
              "two warpgroups of 64 rows, wgmma m64n128, four 32-column w "
              "boxes, a 128-byte K row of f32");
static_assert(TF_SMEM <= 232448, "more shared memory than a CTA can have");
static_assert(TF_BM * TF_LD * 4 <= TF_STAGES * TF_STAGE,
              "the partial tile is exchanged in the ring's place");

// out (m, n) = x (m, k) @ w (k, n), f32, as 3xTF32 (sparse_fc.cu gives the
// arithmetic and why it stays near f32).  A cluster of gridDim.z CTAs shares
// one 128 x 128 output tile; CTA z sums K slices z per .. z per + per - 1.
__global__ void __launch_bounds__(WG_THREADS, 1)
    matmul_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap,
                         const __grid_constant__ CUtensorMap wmap,
                         float* __restrict__ out, int m, int k, int n,
                         int per) {
  using namespace hopper;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage s at tiles + s TF_STAGE (tiles: smem rounded up to 1024 bytes):
  // x's box (128 rows of 128 bytes), then w's four boxes (32 k rows of 32
  // n); split set q at sets + q TF_SET: x lo (same layout as x's box), w
  // hi and w lo (128 n rows of 32 k, K-major)
  const uint32_t smem0 = smem_addr(smem);
  const uint32_t tiles = (smem0 + 1023) & ~1023u;
  const uint32_t sets = tiles + TF_STAGES * TF_STAGE;
  const uint32_t bars = sets + TF_SETS * TF_SET;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (TF_STAGES + s); };
  unsigned char* const gtiles = smem + (tiles - smem0);
  const int wg = threadIdx.x / 128;
  const int m0 = blockIdx.y * TF_BM, n0 = blockIdx.x * TF_BN;
  const int rank = blockIdx.z, split = gridDim.z;   // the cluster is (1, 1, split)
  const int first = rank * per;
  const int n_slices = max(0, min((k + TF_BK - 1) / TF_BK, first + per) -
                                  first);

  if (threadIdx.x == 0) {
    for (int s = 0; s < TF_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full, then the warpgroup joins
    // the cluster's two barriers of the exchange
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int it = 0; it < n_slices; ++it) {
        const int s = it % TF_STAGES;
        const int k0 = (first + it) * TF_BK;
        mbar_wait(empty(s), ((it / TF_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), TF_STAGE);
        const uint32_t t = tiles + s * TF_STAGE;
        tma_load_2d(t, &xmap, full(s), k0, m0);
        for (int b = 0; b < 4; ++b)
          tma_load_2d(t + TF_X_BYTES + b * TF_W_BOX, &wmap, full(s),
                      n0 + 32 * b, k0);
      }
    }
    __syncwarp();
    cluster_sync();
    cluster_sync();
    return;
  }

  // consumers: warpgroup c owns output rows m0 + 64 c .. + 63
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int tid = threadIdx.x & 127, u = threadIdx.x - 128;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  float acc[64], part[64], small[64];
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    acc[j] = 0.0f;
    small[j] = 0.0f;
  }
  // Wait for slice it and split it into set it % TF_SETS, both warpgroups
  // together: x's 128 rows (this warpgroup's 64, 512 float4: hi in place, lo
  // to the set's x lo at the same offset), and w's 32 x 128, transposed on
  // the way (tf32 wgmma has no transpose bit).  w's split: 512 pieces of 4 k
  // x 2 n, two a thread; a piece is read as 4 float2 (4 k rows of a raw box,
  // row k's 16-byte chunk cc stored at chunk cc ^ (k % 8)) and written as
  // 2 float4 to w hi and 2 to w lo (n row's chunk kg stored at kg ^ (n %
  // 8)).  Warp w's pieces in round r lie in box b = (w + 8 r) / 4; lane t
  // takes the n pair e = t % 2 of chunk cc = t / 2 % 8 and k group kg below,
  // so that each half-warp's float2 reads and each quarter-warp's float4
  // writes meet 16 different bank groups (8 for the writes): no conflicts.
  // The first barrier keeps a warpgroup from overwriting the set before the
  // other's products of slice it - TF_SETS have read it.
  auto split_slice = [&](int it) {
    const int s = it % TF_STAGES;
    named_barrier_sync(2, 256);
    mbar_wait(full(s), (it / TF_STAGES) & 1);
    unsigned char* raw = gtiles + s * TF_STAGE;
    unsigned char* set = gtiles + (sets - tiles) + (it % TF_SETS) * TF_SET;
    // one piece at a time (no unrolling): part, small and acc hold 192 of
    // the consumers' 232 registers while slice it - 1's products run
#pragma unroll 1
    for (int j = 0; j < 4; ++j)
      split_tf32(reinterpret_cast<float4*>(raw),
                 reinterpret_cast<float4*>(set), c * 512 + tid + 128 * j);
    const int e = lane & 1, cc = (lane >> 1) & 7;
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {
      const int wr = (u >> 5) + 8 * r, b = wr >> 2, p = wr & 3;
      const int kg = ((lane >> 4) | (p << 1)) ^ (cc & 1) ^ ((cc & 2) << 1);
      const unsigned char* box = raw + TF_X_BYTES + b * TF_W_BOX;
      float2 v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kk = 4 * kg + i;
        v[i] = *reinterpret_cast<const float2*>(
            box + kk * 128 + ((cc ^ (kk & 7)) << 4) + 8 * e);
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int nn = 32 * b + 4 * cc + 2 * e + jj;
        const float4 a = jj ? make_float4(v[0].y, v[1].y, v[2].y, v[3].y)
                            : make_float4(v[0].x, v[1].x, v[2].x, v[3].x);
        float4 h, l;
        split_tf32(a, h, l);
        const int off = nn * 128 + ((kg ^ (nn & 7)) << 4);
        *reinterpret_cast<float4*>(set + TF_TILE + off) = h;
        *reinterpret_cast<float4*>(set + 2 * TF_TILE + off) = l;
      }
    }
    fence_proxy_async();
    named_barrier_sync(1, 256);
  };
  // As in sparse_fc.cu: a slice's x_hi w_hi products sum into part, which
  // the CUDA cores add to acc (the tensor cores sum 32 K terms of it at a
  // time); the small products x_hi w_lo + x_lo w_hi sum over the CTA's K
  // into small.
  if (n_slices > 0) split_slice(0);
  for (int it = 0; it < n_slices; ++it) {
    const int s = it % TF_STAGES;
    const uint32_t set = sets + (it % TF_SETS) * TF_SET;
    const uint32_t ah = tiles + s * TF_STAGE + c * 64 * 128;  // x hi rows
    const uint32_t al = set + c * 64 * 128;                   // x lo rows
    const uint32_t bh = set + TF_TILE, bl = set + 2 * TF_TILE;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // all K-major: k-step ks is 32 bytes (8 f32) into each row
      const uint64_t dah = desc_sw128(ah + 32 * ks, 16, 1024);
      const uint64_t dal = desc_sw128(al + 32 * ks, 16, 1024);
      const uint64_t dbh = desc_sw128(bh + 32 * ks, 16, 1024);
      const uint64_t dbl = desc_sw128(bl + 32 * ks, 16, 1024);
      wgmma_m64n128k8_tf32_ss(small, dah, dbl, 1);
      wgmma_m64n128k8_tf32_ss(small, dal, dbh, 1);
      wgmma_m64n128k8_tf32_ss(part, dah, dbh, ks > 0);
    }
    wgmma_commit();
    fence_regs(part);
    fence_regs(small);
    if (it + 1 < n_slices) split_slice(it + 1);   // beside slice it's products
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(small);
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] += part[j];
    if (lane == 0) mbar_arrive(empty(s));
  }
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] += small[j];

  // The CTA's partial tile goes to shared memory in the ring's place, rows
  // of TF_LD f32 (8 banks apart, so each half-warp's float2 stores meet 16
  // different bank pairs); CTA rank then sums rows rank * 128 / split ..
  // of every CTA's tile in rank order (the same order in every run) and
  // stores them, a warp a 512-byte row.
  // acc[j]: row r (+ 8 if j & 2), columns 8 (j / 4) + 2 (lane % 4) + (j & 1)
  named_barrier_sync(1, 256);     // both warpgroups' products are done
  float* ptile = reinterpret_cast<float*>(gtiles);
  const int r0 = c * 64 + warp * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < 64; j += 2)
    *reinterpret_cast<float2*>(ptile + (r0 + ((j & 2) ? 8 : 0)) * TF_LD +
                               (j >> 2) * 8 + (lane & 3) * 2) =
        make_float2(acc[j], acc[j + 1]);
  cluster_sync();
  const int rows = TF_BM / split;
  for (int e = u; e < rows * 32; e += 256) {
    const int row = rank * rows + (e >> 5), col = 4 * (e & 31);
    const uint32_t addr = tiles + 4 * (row * TF_LD + col);
    float4 sum = ld_cluster_f4(addr, 0);
    for (int q = 1; q < split; ++q) {
      const float4 v = ld_cluster_f4(addr, q);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const long long grow = m0 + row;
    const int gcol = n0 + col;
    if (grow < m && gcol < n)       // n is a multiple of 4: gcol + 3 < n
      *reinterpret_cast<float4*>(out + grow * n + gcol) = sum;
  }
  cluster_sync();                 // no CTA leaves while its tile is read
}

static int launch_tf32x3(const void* x, const void* w, float* out, int m,
                         int k, int n, int split, cudaStream_t stream) {
  if (split < 1 || split > TF_MAX_SPLIT || TF_BM % split)
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  const uint64_t xdims[2] = {(uint64_t)k, (uint64_t)m};   // innermost first
  const uint32_t xbox[2] = {TF_BK, TF_BM};
  const uint64_t wdims[2] = {(uint64_t)n, (uint64_t)k};
  const uint32_t wbox[2] = {32, TF_BK};
  int err = hopper::make_tensor_map(&xmap, x, 2, xdims, xbox,
                                    CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err == 0)
    err = hopper::make_tensor_map(&wmap, w, 2, wdims, wbox,
                                  CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != 0) return err;
  // the shared-memory opt-in, once a device (a call costs microseconds)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(matmul_tf32x3_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)TF_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[dev] = true;
  }
  const int slices = (k + TF_BK - 1) / TF_BK;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + TF_BN - 1) / TF_BN, (m + TF_BM - 1) / TF_BM, split);
  cfg.blockDim = dim3(WG_THREADS);
  cfg.dynamicSmemBytes = TF_SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = split;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, matmul_tf32x3_kernel, xmap, wmap, out, m, k,
                         n, (slices + split - 1) / split);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" {

// The micro-tile edge and the most threads a block may have; the wrapper
// checks that it was built for the same numbers as calibrate.py.
int dense_matmul_tile() { return TILE; }
int dense_matmul_max_threads() { return MAX_THREADS; }
// The wgmma kernel's output tile edge (BM = BN).
int dense_matmul_wgmma_tile() { return WG_BM; }
// The narrow kernel's most threads a CTA, most rows a CTA and most shared
// memory a CTA in KB, packed as threads | rows << 11 | kb << 18, and the
// widest N alone.
int dense_matmul_narrow_shape() {
  return NR_MAX_THREADS | NR_MAX_ROWS << 11 | (NR_SMEM_MAX / 1024) << 18;
}
int dense_matmul_narrow_max_n() { return NR_MAX_N; }
// The tf32x3 kernel's output tile edge (BM = BN), its K slice and the most
// CTAs that split one tile's K.
int dense_matmul_tf32x3_tile() { return TF_BM; }
int dense_matmul_tf32x3_slice() { return TF_BK; }
int dense_matmul_tf32x3_max_split() { return TF_MAX_SPLIT; }

// out (m, n) = x (m, k) @ w (k, n), all row-major and contiguous, f32
// (bf16 = 0) or bf16 (bf16 = 1).  bm and bn are multiples of TILE with
// (bm / TILE) * (bn / TILE) <= MAX_THREADS; the wrapper checks them.
// Returns cudaGetLastError() after the launch (0 on success).
int dense_matmul_launch(const void* x, const void* w, void* out, int m,
                        int k, int n, int bm, int bk, int bn, int bf16,
                        void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, w, out, m, k, n, bm, bk, bn, s)
              : launch<float>(x, w, out, m, k, n, bm, bk, bn, s);
}

// out (m, n) = x (m, k) @ w (k, n) on the narrow kernel: row-major and
// contiguous, f32 (bf16 = 0) or bf16 (bf16 = 1), 1 <= n <= NR_MAX_N, bm rows
// of x a CTA with 1 <= bm <= NR_MAX_ROWS and bm * n <= NR_MAX_THREADS, K
// slices of bk >= 1 whose two stages fit in NR_SMEM_MAX bytes, m >= 1,
// k >= 0; the wrapper checks them.  Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a bm, bk or n the
// kernel does not take.
int dense_matmul_narrow_launch(const void* x, const void* w, void* out, int m,
                               int k, int n, int bm, int bk, int bf16,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_narrow<__nv_bfloat16>(x, w, out, m, k, n, bm, bk, s)
              : launch_narrow<float>(x, w, out, m, k, n, bm, bk, s);
}

// out (m, n) = x (m, k) @ w (k, n) on the wgmma kernel: bf16, row-major and
// contiguous, x and w 16-byte aligned, k and n multiples of 8, m, k, n >= 1,
// (m + 127) / 128 <= 65535; the wrapper checks them.  Returns 0 on success,
// else a cudaError_t (from building a tensor map or from the launch).
int dense_matmul_wgmma_launch(const void* x, const void* w, void* out, int m,
                              int k, int n, void* stream) {
  return launch_wgmma(x, w, out, m, k, n, (cudaStream_t)stream);
}

// out (m, n) = x (m, k) @ w (k, n) on the tf32x3 kernel: f32, row-major and
// contiguous, x and w 16-byte aligned, k and n multiples of 4, m, k, n >= 1,
// (m + 127) / 128 <= 65535; K split over `split` CTAs (1, 2 or 4) of a
// cluster; the wrapper checks them.  Returns 0 on success, else a
// cudaError_t (from building a tensor map or from the launch).
int dense_matmul_tf32x3_launch(const void* x, const void* w, void* out,
                               int m, int k, int n, int split, void* stream) {
  return launch_tf32x3(x, w, static_cast<float*>(out), m, k, n, split,
                       (cudaStream_t)stream);
}

}  // extern "C"
