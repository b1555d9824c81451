// Tiled dense matmul: out (M, N) = x (M, K) @ w (K, N), f32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/dense_matmul.py:matmul (body
// _matmul_kernel), SONIC's loop-ordered accumulation on the MXU: a
// (M/bm, N/bn, K/bk) grid whose innermost, sequential K axis keeps each
// output tile in a f32 VMEM accumulator and commits it once.  Here one
// thread block owns one (bm x bn) output tile and loops over K in bk
// slices itself; the accumulators are registers, an 8 x 8 micro-tile per
// thread, so a block has (bm / 8) * (bn / 8) threads.  Each K slice of x
// (stored transposed, rows padded by one against bank conflicts) and of w
// is staged in shared memory; threads own strided rows and columns of the
// tile, so neighbouring threads read neighbouring words and write
// neighbouring outputs.  Ragged M, N and K are masked here, so the caller
// pads nothing.
//
// Types: f32 inputs are multiplied in full f32 on the CUDA cores (fmaf),
// never in TF32; bf16 inputs are widened to f32 as they are read from
// shared memory and summed the same way, and the output is rounded to
// bf16 once (round to nearest even).
//
// What bounds it on an H100: a large product is bound by operations (2MNK
// over 67 TFLOP/s for f32 on the CUDA cores, 989 TFLOP/s for bf16 on the
// tensor cores this kernel does not use).  This first design feeds the
// FMAs from shared memory with scalar loads, 16 loads for 64 FMAs, with one
// stage and no copy/compute overlap; wgmma, TMA and a pipelined ring of
// tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

extern "C" {

// The micro-tile edge and the most threads a block may have; the wrapper
// checks that it was built for the same numbers as calibrate.py.
int dense_matmul_tile() { return TILE; }
int dense_matmul_max_threads() { return MAX_THREADS; }

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

}  // extern "C"
