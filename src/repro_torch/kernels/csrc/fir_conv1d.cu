// Depthwise "valid" FIR: out (C, L - K + 1) from x (C, L) and taps (C, K).
//
// Replaces the TPU kernel src/repro/kernels/fir_conv1d.py:fir_conv1d (body
// _fir_kernel), TAILS's LEA FIR-DTC: there a grid step holds whole rows of
// a block of channels in VMEM and slides the K taps over them.  Here a
// thread block covers cb channels x tw output positions (threadIdx.y the
// channel, threadIdx.x the position, one output a thread), so L is tiled
// too and short rows still fill a block.  Taps are consumed in slices of
// TAP_SLICE: each slice stages the block's taps and its input window (tw
// positions plus the slice's halo of up to TAP_SLICE - 1) in shared memory,
// so any K fits in a fixed amount of shared memory and the sum runs in
// order t = 0 .. K-1 across slices.
//
// Every output is summed in that order with a separate multiply and add,
// each rounded once (__fmul_rn / __fadd_rn, and the file builds with
// --fmad=false), from 0.0f: exactly the arithmetic of _fir_kernel and of
// the plain version, so the kernel is bitwise equal to it.  x and the taps
// may each be f32 or bf16 (templated on both): bf16 is read as bf16 and
// widened to f32 as it is staged, and a bf16 output (x's dtype) is rounded
// once from the f32 sum (__float2bfloat16_rn, round to nearest even, as
// the plain version's .to(bfloat16)).
//
// What bounds it on an H100: bytes.  For a few taps the work is 2K
// operations per output against 8 bytes of input and output, far below the
// card's operations per byte; each input word is read from device memory
// once and from shared memory K times.  bf16 halves the bytes; the wrapper
// makes no widened copy, which would double them.  Halo loads repeat (K - 1) / tw of
// the input; a block of short rows (L < 32) leaves threads idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define TAP_SLICE 32

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void narrow(float* out, float v) { *out = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

template <typename TX, typename TT>
__global__ void fir_conv1d_kernel(const TX* __restrict__ x,
                                  const TT* __restrict__ taps,
                                  TX* __restrict__ out, long long c,
                                  int length, int k) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tw = blockDim.x, cb = blockDim.y;
  const int win = tw + TAP_SLICE - 1;
  float* xrow = smem + ty * win;                     // (cb, win) windows
  float* trow = smem + cb * win + ty * TAP_SLICE;    // (cb, TAP_SLICE) taps
  const long long ch = (long long)blockIdx.x * cb + ty;
  const bool live = ch < c;
  const int out_len = length - k + 1;
  const int l0 = blockIdx.y * tw;

  float acc = 0.0f;
  for (int t0 = 0; t0 < k; t0 += TAP_SLICE) {
    const int kw = min(TAP_SLICE, k - t0);
    __syncthreads();             // the previous slice has been read
    if (live) {
      for (int j = tx; j < tw + kw - 1; j += tw) {
        const int gl = l0 + t0 + j;
        xrow[j] = gl < length ? widen(x[ch * length + gl]) : 0.0f;
      }
      for (int j = tx; j < kw; j += tw)
        trow[j] = widen(taps[ch * k + t0 + j]);
    }
    __syncthreads();
    if (live)
      for (int t = 0; t < kw; ++t)
        acc = __fadd_rn(acc, __fmul_rn(xrow[tx + t], trow[t]));
  }
  if (live && l0 + tx < out_len) narrow(out + ch * out_len + l0 + tx, acc);
}

template <typename TX, typename TT>
static int launch(const void* x, const void* taps, void* out, long long c,
                  int length, int k, int cb, int tw, cudaStream_t stream) {
  const int out_len = length - k + 1;
  const dim3 grid((unsigned)((c + cb - 1) / cb), (out_len + tw - 1) / tw);
  const dim3 block(tw, cb);
  const size_t smem = sizeof(float) * (size_t)cb * (tw + 2 * TAP_SLICE - 1);
  fir_conv1d_kernel<TX, TT><<<grid, block, smem, stream>>>(
      static_cast<const TX*>(x), static_cast<const TT*>(taps),
      static_cast<TX*>(out), c, length, k);
  return (int)cudaGetLastError();
}

extern "C" {

// The taps staged per step; the wrapper checks it against calibrate.py.
int fir_conv1d_tap_slice() { return TAP_SLICE; }

// out (c, length - k + 1) in x's dtype from x (c, length) and taps (c, k),
// each f32 (0) or bf16 (1) as x_bf16 and taps_bf16 say, contiguous;
// 1 <= k <= length.  Blocks of cb channels x tw positions.  Returns
// cudaGetLastError() after the launch (0 on success).
int fir_conv1d_launch(const void* x, const void* taps, void* out,
                      long long c, int length, int k, int cb, int tw,
                      int x_bf16, int taps_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 B;
  if (x_bf16)
    return taps_bf16 ? launch<B, B>(x, taps, out, c, length, k, cb, tw, s)
                     : launch<B, float>(x, taps, out, c, length, k, cb, tw, s);
  return taps_bf16 ? launch<float, B>(x, taps, out, c, length, k, cb, tw, s)
                   : launch<float, float>(x, taps, out, c, length, k, cb, tw,
                                          s);
}

}  // extern "C"
