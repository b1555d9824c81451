// Tiled dense matmul: out (M, N) = x (M, K) @ w (K, N), f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/dense_matmul.py:matmul (body
// _matmul_kernel), SONIC's loop-ordered accumulation on the MXU: a
// (M/bm, N/bn, K/bk) grid whose innermost, sequential K axis keeps each
// output tile in a f32 VMEM accumulator and commits it once.  Here one
// thread block owns one output tile and loops over K itself, the
// accumulators in registers.  Ragged M, N and K are handled here, so the
// caller pads nothing.  Two kernels, chosen by the wrapper from the
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
// * matmul_kernel: f32, and bf16 operands the wgmma kernel does not take,
//   on the CUDA cores.  The tiles (bm, bk, bn) are the caller's; the
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
// over 989 TFLOP/s for bf16 on the tensor cores and over 67 TFLOP/s for f32
// on the CUDA cores.  The wgmma kernel keeps the tensor cores fed from a
// TMA ring that no thread spends instructions on; what it leaves to later
// work is a persistent grid (one tile's epilogue over the next one's
// loads), clusters with TMA multicast, and a TMA store of the output.  The
// f32 kernel feeds its FMAs from shared memory with scalar loads, 16 loads
// for 64 FMAs, with one stage and no copy/compute overlap.

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

extern "C" {

// The micro-tile edge and the most threads a block may have; the wrapper
// checks that it was built for the same numbers as calibrate.py.
int dense_matmul_tile() { return TILE; }
int dense_matmul_max_threads() { return MAX_THREADS; }
// The wgmma kernel's output tile edge (BM = BN).
int dense_matmul_wgmma_tile() { return WG_BM; }

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

// out (m, n) = x (m, k) @ w (k, n) on the wgmma kernel: bf16, row-major and
// contiguous, x and w 16-byte aligned, k and n multiples of 8, m, k, n >= 1,
// (m + 127) / 128 <= 65535; the wrapper checks them.  Returns 0 on success,
// else a cudaError_t (from building a tensor map or from the launch).
int dense_matmul_wgmma_launch(const void* x, const void* w, void* out, int m,
                              int k, int n, void* stream) {
  return launch_wgmma(x, w, out, m, k, n, (cudaStream_t)stream);
}

}  // extern "C"
