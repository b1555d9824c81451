// Depthwise "valid" FIR: out (C, L - K + 1) from x (C, L) and taps (C, K).
//
// Replaces the TPU kernel src/repro/kernels/fir_conv1d.py:fir_conv1d (body
// _fir_kernel), TAILS's LEA FIR-DTC: there a grid step holds whole rows of
// a block of channels in VMEM and slides the K taps over them.  Two designs,
// chosen by the wrapper from the shape and the pointers before the launch
// (fir_conv1d.py:fir_path):
//
// * fir_flat_kernel ("flat", the main path): x and out are contiguous, so T
//   consecutive outputs in flat order, whatever rows they span, read one
//   contiguous span of x, from the first output's input to K - 1 past the
//   last one's, and one contiguous span of the taps (their rows).  A tile
//   is T flat outputs (8 KB of them: 2,048 f32 or 4,096 bf16); one kernel
//   serves rows of 8 outputs (MNIST's conv2: 819,200 rows of L = 12), of 24
//   (conv1, L = 28) and of 8,188 (8192^2) with every thread live.  A CTA
//   stages a tile's two spans in shared memory with 16-byte cp.async copies
//   (the span rounded out to 16 bytes; a 16-byte chunk that would step past
//   the end of the tensor is copied by plain loads), double-buffered: the
//   next tile's copies are in flight while a tile computes.
//   Thread t takes the tile's outputs t, t + 256, ...; its (row, position)
//   comes from one division a tile and then steps of 256 / (L - K + 1) rows
//   and 256 % (L - K + 1) positions.  A warp reads near-consecutive words of
//   the staged span: at L = 12 and 28 its 32 lanes cross 4 and 2 row ends,
//   which skip K - 1 words, so a few banks take two words (a 2-way conflict
//   on part of a warp's loads).  Outputs go to shared memory, then to out
//   with 16-byte stores.  The grid is persistent: as many CTAs as fit on
//   the SMs at once (four of 48 KB an SM), striding over the tiles, so
//   819,200 short rows are 3,200 tiles (f32), not 102,400 blocks.  A tile's
//   spans fit its stage for every L and K whose worst case does (the
//   wrapper's fir_path decides from them; the launcher refuses the others).
// * fir_conv1d_kernel ("tiled", the first design): a thread block covers cb
//   channels x tw output positions (threadIdx.y the channel, threadIdx.x the
//   position, one output a thread), so L is tiled too.  Taps are consumed in
//   slices of TAP_SLICE: each slice stages the block's taps and its input
//   window (tw positions plus the slice's halo of up to TAP_SLICE - 1) in
//   shared memory, so any K fits in a fixed amount of shared memory.  It
//   takes what the flat design does not: a K whose span does not fit,
//   pointers off a 16-byte boundary, and calls of fewer tiles than SMs,
//   where all its blocks run at once and the flat design's first copy is
//   not hidden behind another tile's sums (fir_path's FLAT_MIN_TILES).
//
// Every output is summed in order t = 0 .. K-1 with a separate multiply and
// add, each rounded once (__fmul_rn / __fadd_rn, and the file builds with
// --fmad=false), from 0.0f: exactly the arithmetic of _fir_kernel and of
// the plain version, so both designs are bitwise equal to it and to each
// other.  x and the taps may each be f32 or bf16 (templated on both): bf16
// is staged as bf16 and widened to f32 as it is read, and a bf16 output
// (x's dtype) is rounded once from the f32 sum (__float2bfloat16_rn, round
// to nearest even, as the plain version's .to(bfloat16)).
//
// What bounds it on an H100: bytes.  For a few taps the work is 2K
// operations per output against 8 bytes of input and output (f32), far
// below the card's operations per byte.  The flat design reads each input
// word from device memory once (the K - 1 words a row end adds to the
// span are read by no output and cost (K - 1) / L of the bytes), keeps a
// tile's copies in flight beside another tile's sums, and issues one
// 16-byte copy or store for 4 f32 or 8 bf16 words.  The sums are issue-
// bound where the bytes are few (bf16): K = 5 is built in and unrolled.
// The first design's costs were one 4-byte load and one output a thread,
// blocks of 256 outputs, two barriers a tap slice, and idle threads in a
// block of short rows (8 of 32 live at L = 12).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TAP_SLICE 32

#define FLAT_OUT_BYTES 8192      // a tile's outputs: 2,048 f32 or 4,096 bf16
#define FLAT_THREADS 256
#define FLAT_STAGES 2            // tiles staged at once: one in flight
#define FLAT_IN_BYTES 14336      // a stage's input span, at most
#define FLAT_TAP_BYTES 6144      // a stage's tap span, at most
#define FLAT_STAGE (FLAT_IN_BYTES + FLAT_TAP_BYTES)
#define FLAT_SMEM (FLAT_STAGES * FLAT_STAGE + FLAT_OUT_BYTES)

static_assert(FLAT_OUT_BYTES % (4 * FLAT_THREADS) == 0 &&
                  FLAT_STAGE % 16 == 0,
              "a tile is whole rounds of the block in either dtype, and the "
              "stages keep 16-byte boundaries");

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void narrow(float* out, float v) { *out = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// the first design: blocks of channels x positions
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// the flat design: tiles of T flat outputs, spans staged by cp.async
// ---------------------------------------------------------------------------

// cp.async.cg.shared.global of 16 bytes, landing some time after it is
// issued; cp.async.commit_group and cp.async.wait_group N
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bytes [b0, b1) of an array of `size` bytes at `src` (b0 and b1 multiples
// of 16, b0 < size) to `dst`: a 16-byte cp.async a chunk, or plain loads of
// the bytes inside the array for the one chunk that crosses its end.
__device__ __forceinline__ void stage_span(unsigned char* dst,
                                           const unsigned char* src,
                                           long long b0, long long b1,
                                           long long size) {
  const int chunks = (int)((b1 - b0) >> 4);
  for (int i = threadIdx.x; i < chunks; i += FLAT_THREADS) {
    const long long g = b0 + 16LL * i;
    if (g + 16 <= size) {
      cp_async16(dst + 16 * i, src + g);
    } else {
      for (int b = 0; g + b < size; ++b) dst[16 * i + b] = src[g + b];
    }
  }
}

// Where tile `tile` lies: its first output o0 and count n, the row r0 and
// position p0 of o0, and the first element of each staged span (rounded
// down to 16 bytes) with the byte range staged.
struct FlatTile {
  long long o0, r0, in_el, tap_el, in_b0, in_b1, tap_b0, tap_b1;
  int n, p0;
};

template <typename TX, typename TT>
__device__ __forceinline__ FlatTile flat_tile(long long tile, long long total,
                                              int length, int k, int lo) {
  constexpr int T = FLAT_OUT_BYTES / sizeof(TX);
  FlatTile f;
  f.o0 = tile * T;
  f.n = (int)min((long long)T, total - f.o0);
  f.r0 = f.o0 / lo;
  f.p0 = (int)(f.o0 - f.r0 * lo);
  const long long last = f.o0 + f.n - 1;
  const long long r1 = last / lo;
  const long long in_first = f.r0 * length + f.p0;
  const long long in_end = r1 * length + (last - r1 * lo) + k;   // exclusive
  f.in_b0 = (in_first * (long long)sizeof(TX)) & ~15LL;
  f.in_b1 = (in_end * (long long)sizeof(TX) + 15) & ~15LL;
  f.in_el = f.in_b0 / (long long)sizeof(TX);
  f.tap_b0 = (f.r0 * k * (long long)sizeof(TT)) & ~15LL;
  f.tap_b1 = ((r1 + 1) * k * (long long)sizeof(TT) + 15) & ~15LL;
  f.tap_el = f.tap_b0 / (long long)sizeof(TT);
  return f;
}

// KT: K at build time (the sum unrolled), or 0 for any K (looped)
template <typename TX, typename TT, int KT>
__global__ void __launch_bounds__(FLAT_THREADS)
    fir_flat_kernel(const TX* __restrict__ x, const TT* __restrict__ taps,
                    TX* __restrict__ out, long long c, int length, int k,
                    long long n_tiles, int step_row, int step_pos) {
  extern __shared__ __align__(16) unsigned char fsmem[];
  const int tid = threadIdx.x;
  const int lo = length - k + 1;
  const long long total = c * lo;
  const long long x_bytes = c * length * (long long)sizeof(TX);
  const long long t_bytes = c * k * (long long)sizeof(TT);
  TX* const outs = reinterpret_cast<TX*>(fsmem + FLAT_STAGES * FLAT_STAGE);

  auto issue = [&](long long tile, int s) {
    const FlatTile f = flat_tile<TX, TT>(tile, total, length, k, lo);
    unsigned char* st = fsmem + s * FLAT_STAGE;
    stage_span(st, reinterpret_cast<const unsigned char*>(x), f.in_b0,
               f.in_b1, x_bytes);
    stage_span(st + FLAT_IN_BYTES, reinterpret_cast<const unsigned char*>(taps),
               f.tap_b0, f.tap_b1, t_bytes);
  };

  // the CTA's tiles are blockIdx.x + i gridDim.x, tile i in stage i % 2:
  // the next tile's copies are in flight while a tile computes
  long long tile = blockIdx.x;
  for (int i = 0; i < FLAT_STAGES - 1; ++i) {
    const long long t = tile + (long long)i * gridDim.x;
    if (t < n_tiles) issue(t, i);
    cp_commit();
  }
  for (int s = 0; tile < n_tiles;
       tile += gridDim.x, s = s + 1 == FLAT_STAGES ? 0 : s + 1) {
    const long long ahead = tile + (long long)(FLAT_STAGES - 1) * gridDim.x;
    if (ahead < n_tiles) issue(ahead, s == 0 ? FLAT_STAGES - 1 : s - 1);
    cp_commit();                 // an empty group when there is none ahead
    cp_wait<FLAT_STAGES - 1>();  // this tile's copies (this thread's) landed
    __syncthreads();             // ... and every thread's, and the plain loads

    const FlatTile f = flat_tile<TX, TT>(tile, total, length, k, lo);
    const TX* xs = reinterpret_cast<const TX*>(fsmem + s * FLAT_STAGE);
    const TT* ts =
        reinterpret_cast<const TT*>(fsmem + s * FLAT_STAGE + FLAT_IN_BYTES);
    // output q of the tile is at row r0 + rr, position pos; its inputs at
    // xs[xoff + rr * length + pos + t] and its taps at ts[toff + rr * k + t]
    const int xoff = (int)(f.r0 * length - f.in_el);
    const int toff = (int)(f.r0 * k - f.tap_el);
    int rr = (f.p0 + tid) / lo;
    int pos = f.p0 + tid - rr * lo;
    for (int q = tid; q < f.n; q += FLAT_THREADS) {
      const TX* xp = xs + (xoff + rr * length + pos);
      const TT* tp = ts + (toff + rr * k);
      float acc = 0.0f;
      if constexpr (KT > 0) {
#pragma unroll
        for (int t = 0; t < KT; ++t)
          acc = __fadd_rn(acc, __fmul_rn(widen(xp[t]), widen(tp[t])));
      } else {
        for (int t = 0; t < k; ++t)
          acc = __fadd_rn(acc, __fmul_rn(widen(xp[t]), widen(tp[t])));
      }
      narrow(outs + q, acc);
      rr += step_row;
      pos += step_pos;
      if (pos >= lo) {
        pos -= lo;
        ++rr;
      }
    }
    __syncthreads();             // the stage is read and the outputs staged

    // out[o0 ..] from the staged outputs: o0 * sizeof(TX) is a multiple of
    // 16 (a tile is 8 KB), so whole chunks are 16-byte stores and the tail
    // of the last tile (under 16 bytes) goes element by element
    unsigned char* ob =
        reinterpret_cast<unsigned char*>(out) + f.o0 * (long long)sizeof(TX);
    const int bytes = f.n * (int)sizeof(TX);
    for (int i = tid; i < (bytes >> 4); i += FLAT_THREADS)
      reinterpret_cast<int4*>(ob)[i] =
          reinterpret_cast<const int4*>(outs)[i];
    const int tail = (bytes & 15) / (int)sizeof(TX);
    if (tid < tail) {
      const int q = f.n - tail + tid;
      reinterpret_cast<TX*>(ob)[q] = outs[q];
    }
  }
  cp_wait<0>();
}

// The worst case of a tile's two spans, in bytes with their rounding to 16
// (fir_conv1d.py:flat_fits says the same): the tile's T outputs cross at
// most (T + lo - 2) / lo row ends, each adding K - 1 input words.
static bool flat_fits(long long length, long long k, int sx, int st) {
  const long long t = FLAT_OUT_BYTES / sx, lo = length - k + 1;
  const long long rows = (t + lo - 2) / lo;
  return (t + k - 1 + rows * (k - 1)) * sx + 32 <= FLAT_IN_BYTES &&
         (rows + 1) * k * st + 32 <= FLAT_TAP_BYTES;
}

template <typename TX, typename TT, int KT>
static int launch_flat(const void* x, const void* taps, void* out,
                       long long c, int length, int k, cudaStream_t stream) {
  if (!flat_fits(length, k, sizeof(TX), sizeof(TT)))
    return (int)cudaErrorInvalidValue;
  // the shared-memory opt-in and the grid, once a device
  static int ctas[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  int per_sm = dev < 64 ? ctas[dev] : 0;
  if (per_sm == 0) {
    e = cudaFuncSetAttribute(fir_flat_kernel<TX, TT, KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FLAT_SMEM);
    if (e != cudaSuccess) return (int)e;
    int sms = 0, occ = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, fir_flat_kernel<TX, TT, KT>, FLAT_THREADS, FLAT_SMEM);
    if (e != cudaSuccess) return (int)e;
    per_sm = sms * (occ > 0 ? occ : 1);
    if (dev < 64) ctas[dev] = per_sm;
  }
  const long long lo = length - k + 1, t = FLAT_OUT_BYTES / sizeof(TX);
  const long long n_tiles = (c * lo + t - 1) / t;
  const unsigned grid = (unsigned)(n_tiles < per_sm ? n_tiles : per_sm);
  fir_flat_kernel<TX, TT, KT><<<grid, FLAT_THREADS, FLAT_SMEM, stream>>>(
      static_cast<const TX*>(x), static_cast<const TT*>(taps),
      static_cast<TX*>(out), c, length, k, n_tiles,
      (int)(FLAT_THREADS / lo), (int)(FLAT_THREADS % lo));
  return (int)cudaGetLastError();
}

// K = 5 (MNIST's convolutions, the benchmark's FIR) at build time, any
// other K (or K = 5 too, if `looped`) at run time
template <typename TX, typename TT>
static int flat_k(const void* x, const void* taps, void* out, long long c,
                  int length, int k, int looped, cudaStream_t stream) {
  return k == 5 && !looped
             ? launch_flat<TX, TT, 5>(x, taps, out, c, length, k, stream)
             : launch_flat<TX, TT, 0>(x, taps, out, c, length, k, stream);
}

extern "C" {

// The taps staged per step; the wrapper checks it against calibrate.py.
int fir_conv1d_tap_slice() { return TAP_SLICE; }

// The flat design's tile (output bytes) and stage (input and tap bytes),
// for the wrapper's fir_path to check against: tile bytes | in KB << 16 |
// tap KB << 24.
int fir_conv1d_flat_shape() {
  return FLAT_OUT_BYTES | (FLAT_IN_BYTES / 1024) << 16 |
         (FLAT_TAP_BYTES / 1024) << 24;
}

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

// The same on the flat design: x, taps and out 16-byte aligned, c * length
// >= 1, and a K whose spans fit (flat_fits); `looped` takes the looped sum
// at K = 5 too.  Returns cudaErrorInvalidValue for a K that does not fit,
// else cudaGetLastError() after the launch.
int fir_conv1d_flat_launch(const void* x, const void* taps, void* out,
                           long long c, int length, int k, int x_bf16,
                           int taps_bf16, int looped, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  typedef __nv_bfloat16 B;
  const int lp = looped;
  if (x_bf16)
    return taps_bf16 ? flat_k<B, B>(x, taps, out, c, length, k, lp, s)
                     : flat_k<B, float>(x, taps, out, c, length, k, lp, s);
  return taps_bf16 ? flat_k<float, B>(x, taps, out, c, length, k, lp, s)
                   : flat_k<float, float>(x, taps, out, c, length, k, lp, s);
}

}  // extern "C"
