// Mamba2 SSD intra-chunk cell, for each (batch*chunk, head) cell:
//
//   G = C B^T                          (Q x Q, one per batch*chunk)
//   M = G * exp(cs_i - cs_j), j <= i   (0 above the diagonal)
//   y = M (x dt)                       (Q x P)
//   S = B^T (exp(cs_{Q-1} - cs) * x dt)  (N x P)
//
// Replaces the TPU kernel src/repro/kernels/ssd_intra.py:ssd_intra (body
// _ssd_kernel), one grid step per (batch*chunk, head) cell with the whole
// cell in VMEM, so the (Q, Q) decay matrix never reaches HBM.  Two designs,
// chosen by the wrapper from the shapes and pointers before the launch
// (ssd_intra.py:ssd_path):
//
// * ssd_wgmma_kernel ("wgmma", the main path): P = 64, Q a multiple of 64 up
//   to 256, N a multiple of 64, 16-byte-aligned contiguous inputs.  G
//   depends only on the batch*chunk (bb and cc are (BC, Q, N)), so a CTA
//   owns one batch*chunk, one 64-row tile and a group of hg <= 8 heads (the
//   wrapper's ssd_plan: 8 at mamba2-370m's 1,024 cells, 2 or 4 where 8
//   would leave SMs idle), and does one of two jobs:
//   - rows i0 .. i0 + 63 of y ("Y" CTAs, Q / 64 of them): it computes its
//     64-row tile of G once, for the key tiles j0 <= i0 (64 x 64 each, the
//     two warpgroups taking alternate key tiles), and keeps it in shared
//     memory (64 x 260 f32).  Then each warpgroup takes alternate heads of
//     the group and, for each, walks the keys j < i0 + 64 in slices of 32:
//     it forms the slice of M = G * exp(cs_i - cs_j) (the exponential only
//     where j <= i; cs read from device memory, which L1 keeps), splits it
//     and the slice of x dt into their tf32 parts, and multiplies them into
//     y's 64 x 64 tile.
//   - rows n0 .. n0 + 63 of S ("S" CTAs, N / 64 of them): it splits its 64
//     columns of B, transposed, once for all Q keys (B^T, 64 x Q, in both
//     tf32 parts, 128 KB), and each warpgroup then walks its heads' keys in
//     slices of 32, scaling x dt by the end-of-chunk decay as it splits it
//     into three tf32 parts, and multiplies B^T into S's 64 x 64 tile.
//     Three parts, because a steep decay leaves S a sum of a few products:
//     the plain version then rounds once a product, and 3xTF32's error, about
//     2^-21 a product, exceeded 4 times that (chip_smoke.py's f64 rule; up to
//     1.34 of it on the CPU); with x dt's third part and five products (A big
//     times all three of x dt's, A small times big and mid) the remainder is
//     B's own split, and it stays under 0.75 of the limit
//     (tests/test_torch_kernels.py).  The three parts do not fit twice beside
//     B^T, so an S warpgroup splits its next slice after its products, while
//     the other warpgroup's run.
//   x dt streams through a TMA ring: two slots a warpgroup, each a slice of
//   32 keys x 64 columns (8 KB in f32) as one thread's TMA copy lands it,
//   on an mbarrier a slot.  Slice k + 2's copy starts as soon as every
//   thread of the warpgroup has split slice k, so it overlaps slice k + 1's
//   products and split; the split reads a slot a 128-byte row a warp.
//   To make room for the ring, a Y CTA keeps no rows of cs, and the G
//   tile's rows are padded by 4 words only.  The variant built with
//   -DSSD_THREAD_FED (_build's ssd_intra_thread_fed, timed beside it by
//   chip_smoke.py) loads x dt with the threads' own loads into registers
//   instead, slice k + 2 while slice k's products finish.
//   A CTA is 256 threads, two warpgroups, 226 KB of shared memory, one an
//   SM.  The grid is (BC x head groups x (Q / 64 + N / 64)) CTAs, the job
//   innermost so that the CTAs that read one batch*chunk's x dt run
//   together (L2 serves their repeated reads), and the costliest job
//   first: a Y CTA of row tile t reads t + 1 key tiles, an S CTA all Q / 64
//   of them, so the CTAs are issued S, Y(last), .., Y(0), and the cheap
//   ones fill the card's last wave.  At mamba2-370m's 1,024 cells that is
//   32 x 4 x 6 = 768 CTAs, 5.8 waves of 132.
//   Products run on wgmma m64n64k8 .tf32 as 3xTF32, as dense_matmul.cu's
//   tf32x3 kernel and sparse_fc.cu do: each f32 operand split into a big
//   and a small tf32 part (hopper.cuh's split_tf32, both rounded to
//   nearest), three products, the small ones in an accumulator of their
//   own, and the big one summed a 32-wide K slice at a time and added on
//   the CUDA cores.  A bf16 operand is exact in tf32, its small part 0, so
//   a product it enters takes one pass fewer (G from bf16 bb and cc one).
//   tf32 wgmma reads both operands K-major only: C and B are K-major as
//   stored for G (K = n), but x dt (K = j, stored (j, p)) and B for S (K =
//   j, stored (j, n)) are written transposed by the split, and M is
//   written K-major by the CTA that forms it.  A Y CTA's warpgroups
//   double-buffer their split slices (32 KB each: A and B, big and small):
//   each splits slice k + 1 while slice k's products run.  The two
//   warpgroups keep their own buffers, ring slots and named barrier, so one
//   runs its products while the other splits.
// * ssd_kernel ("simt", the first design): a cell is cut into 64-row
//   tiles, one thread block each: ceil(Q / 64) blocks own rows of y, and
//   ceil(N / 64) more own rows of S; a third grid axis cuts P into
//   64-column slices.  A y block walks the 64-key tiles j0 <= its last row,
//   builds that (64 x 64) tile of G from C and B staged in slices of 32
//   state columns, turns it into the tile of M in shared memory and
//   multiplies it into x dt on the CUDA cores; an S block walks all key
//   tiles, scaling x dt by the end-of-chunk decay as it stages it.  It
//   computes G once a cell, H times a batch*chunk, and takes every shape
//   the wgmma design does not (ragged Q, N and P are masked).
//
// The decay exp(cs_i - cs_j) of a masked pair (j > i) overflows to inf at
// realistic chunk lengths (Q = 256 with dt * a down to -1 a step gives
// exponents up to +255), and 0 * inf is NaN; so both designs evaluate the
// exponential only where j <= i, and the masked entries are a literal 0.
//
// Arithmetic: f32 sums in another order than the plain version's (and, on
// the wgmma design, tf32 parts whose three products keep about f32's
// accuracy: the wrapper's tests and chip_smoke.py hold it to the f64 cell).
// The elementwise products g * exp(.) and exp(.) * x dt are rounded once
// each, as in the Pallas kernel.  Each input may be f32 or bf16 (one
// instantiation of each design for each of the 16 mixes, so no load tests
// a dtype at run time and the wgmma design drops the passes a bf16 operand
// does not need): bf16 is widened to f32 as it is read, and every bf16
// product is exact in f32.  With a bf16 cs the kernels round to bf16 where
// the JAX package's arithmetic does, whose differences of a bf16 cs are
// bf16: cs_i - cs_j before its exponential, and cs_{Q-1} - cs_j and the
// end-of-chunk decay exp(.) itself.  y and S are f32 either way.
//
// What bounds it on an H100, at mamba2-370m's shapes (Q = 256, N = 128, P =
// 64, 1,024 cells, 32 batch*chunks): G counted once a batch*chunk, the
// work is 8.88 GFLOP (G 0.27, y 4.31, S 4.30), 0.133 ms on the CUDA cores
// (67 TFLOP/s) and, as three tf32 products, 0.054 ms on the tensor cores
// (494.7 TFLOP/s); the bytes, x dt 67 MB in, y 67 MB and S 34 MB out, bb,
// cc and cs 9.4 MB, 177 MB in all, take 0.053 ms at 3.35 TB/s.  The first
// design, on the CUDA cores with one stage and no copy / compute overlap,
// computes G 32 times a batch*chunk (17.2 GFLOP counted so).  The wgmma
// design's CUDA cores form and split M (an exponential an element of the
// causal half) and split x dt beside the products; that, not the tensor
// cores nor the loads, is its floor at these shapes: moving x dt's loads
// onto the TMA ring changed its time by under a tenth either way
// (chip_smoke.py's thread_fed_ms, PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>

#include "hopper.cuh"

// ---------------------------------------------------------------------------
// the first design: 64-row tiles of one cell, on the CUDA cores
// ---------------------------------------------------------------------------

#define TILE 64          // rows and columns of a block's tiles
#define THREADS 256      // 16 x 16
#define NSL 32           // state columns of C and B staged per step
#define LDT (TILE + 1)   // padded row of the transposed C and B slices
#define LDM (TILE + 16)  // padded row of the M tile

// The C/B slices (y blocks) or the B tile (S blocks), then the M tile,
// share one buffer.
#define UNION_FLOATS (2 * NSL * LDT > TILE * LDM ? 2 * NSL * LDT : TILE * LDM)

static_assert(TILE * TILE <= UNION_FLOATS, "the S blocks' B tile fits");

// An input array of f32, or of bf16 (BF16); an element is read as f32
template <bool BF16>
struct In {
  static constexpr bool bf16 = BF16;
  const unsigned char* base;
  __device__ __forceinline__ float operator[](long long i) const {
    if constexpr (BF16)
      return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(base)[i]);
    else
      return reinterpret_cast<const float*>(base)[i];
  }
  __device__ __forceinline__ In operator+(long long i) const {
    return In{base + (BF16 ? 2 : 4) * i};
  }
};

// v rounded to bf16 (round to nearest even) if `round`, else v
__device__ __forceinline__ float as_cs(float v, bool round) {
  return round ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// MASK: bit 0 xdt, 1 bb, 2 cc, 3 cs bf16 (one instantiation each, so no
// load tests a dtype at run time)
template <int MASK>
__global__ void __launch_bounds__(THREADS)
    ssd_kernel(const In<MASK & 1> xdt, const In<(MASK >> 1) & 1> bb,
               const In<(MASK >> 2) & 1> cc, const In<(MASK >> 3) & 1> cs,
               float* __restrict__ y, float* __restrict__ s_out, int h, int q,
               int n, int p, int y_tiles) {
  __shared__ __align__(16) float u[UNION_FLOATS];
  __shared__ __align__(16) float xs[TILE * TILE];   // (key, p) tile of x dt
  __shared__ float cs_i[TILE], cs_j[TILE];

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long cell = blockIdx.x;                 // bc * h + head
  const long long bc = cell / h;
  const int p0 = blockIdx.z * TILE;
  const auto xc = xdt + cell * q * p;                // (Q, P)
  const auto bcell = bb + bc * q * n;                // (Q, N)
  const auto ccell = cc + bc * q * n;                // (Q, N)
  const auto csc = cs + cell * q;                    // (Q,)

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;

  if ((int)blockIdx.y < y_tiles) {
    // ---- rows i0 .. i0 + 63 of y
    const int i0 = blockIdx.y * TILE;
    float* ct = u;                   // (NSL, LDT): C slice, transposed
    float* bt = u + NSL * LDT;       // (NSL, LDT): B slice, transposed
    float* ms = u;                   // (TILE, LDM): the M tile
    if (tid < TILE) cs_i[tid] = i0 + tid < q ? csc[i0 + tid] : 0.0f;
    for (int j0 = 0; j0 <= i0 && j0 < q; j0 += TILE) {
      float g[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) g[a][b] = 0.0f;
      for (int n0 = 0; n0 < n; n0 += NSL) {
        const int nw = min(NSL, n - n0);
        __syncthreads();             // the buffer's last readers are done
        for (int e = tid; e < TILE * nw; e += THREADS) {
          const int r = e / nw, c = e - r * nw;
          ct[c * LDT + r] =
              i0 + r < q ? ccell[(long long)(i0 + r) * n + n0 + c] : 0.0f;
          bt[c * LDT + r] =
              j0 + r < q ? bcell[(long long)(j0 + r) * n + n0 + c] : 0.0f;
        }
        __syncthreads();
        for (int kk = 0; kk < nw; ++kk) {
          float av[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) av[a] = ct[kk * LDT + ty + 16 * a];
#pragma unroll
          for (int b = 0; b < 4; ++b) bv[b] = bt[kk * LDT + tx + 16 * b];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) g[a][b] = fmaf(av[a], bv[b], g[a][b]);
        }
      }
      __syncthreads();               // done with the C/B slices
      if (tid < TILE) cs_j[tid] = j0 + tid < q ? csc[j0 + tid] : 0.0f;
      for (int e = tid; e < TILE * TILE; e += THREADS) {
        const int r = e / TILE, c = e - r * TILE;
        xs[e] = (j0 + r < q && p0 + c < p)
                    ? xc[(long long)(j0 + r) * p + p0 + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int j = j0 + tx + 16 * b;
          // the decay only where j <= i: above the diagonal it overflows
          ms[(ty + 16 * a) * LDM + tx + 16 * b] =
              (j <= i && i < q)
                  ? g[a][b] * expf(as_cs(cs_i[ty + 16 * a] -
                                             cs_j[tx + 16 * b], cs.bf16))
                  : 0.0f;
        }
      }
      __syncthreads();
      for (int jj = 0; jj < TILE; ++jj) {
        float mv[4], xv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) mv[a] = ms[(ty + 16 * a) * LDM + jj];
#pragma unroll
        for (int b = 0; b < 4; ++b) xv[b] = xs[jj * TILE + tx + 16 * b];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(mv[a], xv[b], acc[a][b]);
      }
    }
    float* yc = y + cell * q * p;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      if (i >= q) continue;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = p0 + tx + 16 * b;
        if (c < p) yc[(long long)i * p + c] = acc[a][b];
      }
    }
    return;
  }

  // ---- rows n0 .. n0 + 63 of S
  const int n0 = (blockIdx.y - y_tiles) * TILE;
  float* bs = u;                     // (TILE keys, TILE states)
  const float cs_last = csc[q - 1];
  for (int j0 = 0; j0 < q; j0 += TILE) {
    __syncthreads();                 // the tiles' last readers are done
    for (int e = tid; e < TILE * TILE; e += THREADS) {
      const int r = e / TILE, c = e - r * TILE;
      const bool row_ok = j0 + r < q;
      bs[e] = (row_ok && n0 + c < n)
                  ? bcell[(long long)(j0 + r) * n + n0 + c] : 0.0f;
      xs[e] = (row_ok && p0 + c < p)
                  ? as_cs(expf(as_cs(cs_last - csc[j0 + r], cs.bf16)),
                          cs.bf16) *
                        xc[(long long)(j0 + r) * p + p0 + c]
                  : 0.0f;
    }
    __syncthreads();
    for (int jj = 0; jj < TILE; ++jj) {
      float bv[4], xv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) bv[a] = bs[jj * TILE + ty + 16 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) xv[b] = xs[jj * TILE + tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(bv[a], xv[b], acc[a][b]);
    }
  }
  float* sc = s_out + cell * n * p;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = n0 + ty + 16 * a;
    if (r >= n) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = p0 + tx + 16 * b;
      if (c < p) sc[(long long)r * p + c] = acc[a][b];
    }
  }
}

template <int MASK>
static int launch(const void* xdt, const void* bb, const void* cc,
                  const void* cs, void* y, void* s, dim3 grid, int h, int q,
                  int n, int p, int y_tiles, cudaStream_t stream) {
  auto in = [](const void* a) {
    return static_cast<const unsigned char*>(a);
  };
  ssd_kernel<MASK><<<grid, THREADS, 0, stream>>>(
      {in(xdt)}, {in(bb)}, {in(cc)}, {in(cs)}, static_cast<float*>(y),
      static_cast<float*>(s), h, q, n, p, y_tiles);
  return (int)cudaGetLastError();
}

typedef int (*Launch)(const void*, const void*, const void*, const void*,
                      void*, void*, dim3, int, int, int, int, int,
                      cudaStream_t);
static const Launch kLaunch[16] = {
    launch<0>, launch<1>, launch<2>,  launch<3>,  launch<4>,  launch<5>,
    launch<6>, launch<7>, launch<8>,  launch<9>,  launch<10>, launch<11>,
    launch<12>, launch<13>, launch<14>, launch<15>};

// ---------------------------------------------------------------------------
// the wgmma design: G once a (batch*chunk, row tile, head group), 3xTF32
// ---------------------------------------------------------------------------

#define WT 64                 // tile edge: rows of y or S a CTA owns, P, keys
#define WQ_MAX 256            // Q at most
#define WHG 8                 // heads a CTA at most
#define W_THREADS 256         // two warpgroups
#define GLD (WQ_MAX + 4)      // padded row of the G tile in shared memory

// SSD_THREAD_FED builds the comparison variant (_build's
// ssd_intra_thread_fed): x dt by the threads' own loads into registers,
// slice k + 2 while slice k's products finish, instead of the TMA ring.
#ifdef SSD_THREAD_FED
constexpr bool X_TMA = false;
#else
constexpr bool X_TMA = true;
#endif

// Shared memory from a 1024-byte boundary: region 0, region 1, the x dt
// ring, then its four mbarriers.  Region 0 holds a Y CTA's four slice
// buffers (warpgroup w's buffer b at (2 w + b) W_BUF: A big, A small, B
// big, B small, one W_TILE each) or an S CTA's B^T (big parts from 0, small
// ones from W_R0 / 2, a W_TILE a slice of 32 keys); region 1 a Y CTA's G
// tile, or an S CTA's slice of x dt (warpgroup w's at 3 w W_TILE: big, mid,
// low) and then the end-of-chunk decay of its heads (a row of Q f32 each).
// The ring holds two slots a warpgroup (warpgroup w's slot i at (2 w + i)
// W_SLOT), each a slice of 32 keys x 64 columns of x dt as TMA stores it:
// two boxes of 32 f32 columns (4 KB each), or one of 64 bf16, each row of
// 128 bytes 128-byte swizzled.  Every wgmma tile and TMA box starts on a
// 1024-byte boundary.
constexpr uint32_t W_TILE = 64 * 128;          // 64 K-major rows of 128 bytes
constexpr uint32_t W_BUF = 4 * W_TILE;         // 32 KB
constexpr uint32_t W_R0 = 4 * W_BUF;           // 128 KB
constexpr uint32_t W_G = 64 * GLD * 4;         // 65 KB
constexpr uint32_t W_S1 = 6 * W_TILE + WHG * WQ_MAX * 4;
constexpr uint32_t W_R1 = W_G > W_S1 ? W_G : W_S1;
constexpr uint32_t W_SLOT = 32 * WT * 4;       // 8 KB
constexpr uint32_t W_RING = 4 * W_SLOT;        // 32 KB
constexpr size_t W_SMEM = 1024 + W_R0 + W_R1 + W_RING + 64;

static_assert(W_R0 / 2 >= (WQ_MAX / 32) * W_TILE, "B^T's big parts fit");
static_assert(W_R1 % 1024 == 0 && W_SMEM <= 232448,
              "the regions keep 1024-byte boundaries and fit a CTA");

// element i of an f32 (BF = false) or bf16 array, as f32
template <bool BF>
__device__ __forceinline__ float ld1(const void* base, long long i) {
  if constexpr (BF)
    return __bfloat162float(
        reinterpret_cast<const __nv_bfloat16*>(base)[i]);
  else
    return reinterpret_cast<const float*>(base)[i];
}

// elements i .. i + 3 (i a multiple of 4, 16-byte or 8-byte aligned) as f32
template <bool BF>
__device__ __forceinline__ float4 ld4(const void* base, long long i) {
  if constexpr (BF) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        reinterpret_cast<const __nv_bfloat16*>(base) + i);
    return make_float4(__uint_as_float(v.x << 16),
                       __uint_as_float(v.x & 0xFFFF0000u),
                       __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xFFFF0000u));
  } else {
    return *reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(base) + i);
  }
}

// The byte offset of 16-byte chunk c of K-major row r in a 128-byte-
// swizzled tile (hopper.cuh's layout rules)
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

// v split into three tf32 parts, each rounded to nearest: big = tf32(v),
// mid = tf32(v - big), low = tf32(v - big - mid); together they hold all
// 24 bits of v (the S products' second operand, below)
__device__ __forceinline__ void split3_tf32(const float4& v, float4& big,
                                            float4& mid, float4& low) {
  using hopper::tf32_rn;
  hopper::split_tf32(v, big, mid);
  low = make_float4(
      tf32_rn(v.x - big.x - mid.x), tf32_rn(v.y - big.y - mid.y),
      tf32_rn(v.z - big.z - mid.z), tf32_rn(v.w - big.w - mid.w));
}

// One warpgroup's products over n_items slices of 32 along K, per_tile of
// them to an output tile.  load(k) starts bringing slice k's device-memory
// operands in, split(k, b) writes its tf32 parts into buffer b, and
// addr(k, b) gives the parts' shared addresses (A big, A small, B big, B
// small; a third part of B, with B3, follows B small by a W_TILE); after a
// tile's last slice finish(tile, acc) stores its sum.  A_LO / B_LO:
// whether that operand has a small part (an f32 operand does; a bf16 one
// is exact in tf32).  The products: part = A big B big (summed a slice at
// a time, added to acc on the CUDA cores), and into small A big B small +
// A small B big, with B3 also A big B third + A small B small.  DOUBLE:
// slice k + 1 is split into the other buffer while slice k's products
// run; else one buffer, split after the products (the other warpgroup's
// products overlap it).  RING: load(k) is a TMA copy into ring slot k % 2,
// which split(k) waits for, so slice k + 2's copy starts as soon as slice
// k is split (at the top of step k, a step ahead of its split); else
// load(k) fills registers that split(k) reads, issued after split(k - 1).
template <bool A_LO, bool B_LO, bool B3, bool DOUBLE, bool RING, class Load,
          class Split, class Addr, class Finish>
__device__ __forceinline__ void wg_pipeline(int n_items, int per_tile, int bar,
                                            const Load& load,
                                            const Split& split,
                                            const Addr& addr,
                                            const Finish& finish) {
  using namespace hopper;
  float acc[32], part[32], small[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    acc[j] = 0.0f;
    small[j] = 0.0f;
  }
  if (n_items == 0) return;
  load(0);
  if (RING && n_items > 1) load(1);
  split(0, 0);
  if (!RING && n_items > 1) load(1);
  fence_proxy_async();
  named_barrier_sync(bar, 128);
  for (int it = 0; it < n_items; ++it) {
    // every thread has split slice it: its ring slot takes slice it + 2
    if (RING && it + 2 < n_items) load(it + 2);
    const int b = DOUBLE ? it & 1 : 0;
    const uint4 a = addr(it, b);   // x, y: A big, small; z, w: B big, small
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      // K-major: k-step ks is 32 bytes (8 f32) into each row
      const uint64_t dah = desc_sw128(a.x + 32 * ks, 16, 1024);
      const uint64_t dbh = desc_sw128(a.z + 32 * ks, 16, 1024);
      if constexpr (B_LO)
        wgmma_m64n64k8_tf32_ss(small, dah,
                               desc_sw128(a.w + 32 * ks, 16, 1024), 1);
      if constexpr (A_LO)
        wgmma_m64n64k8_tf32_ss(small, desc_sw128(a.y + 32 * ks, 16, 1024),
                               dbh, 1);
      if constexpr (B3) {
        wgmma_m64n64k8_tf32_ss(
            small, dah, desc_sw128(a.w + W_TILE + 32 * ks, 16, 1024), 1);
        if constexpr (A_LO)
          wgmma_m64n64k8_tf32_ss(small, desc_sw128(a.y + 32 * ks, 16, 1024),
                                 desc_sw128(a.w + 32 * ks, 16, 1024), 1);
      }
      wgmma_m64n64k8_tf32_ss(part, dah, dbh, ks > 0);
    }
    wgmma_commit();
    fence_regs(part);
    fence_regs(small);
    if (DOUBLE && it + 1 < n_items) {   // beside slice it's products
      split(it + 1, b ^ 1);
      if (!RING && it + 2 < n_items) load(it + 2);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(small);
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] += part[j];
    if ((it + 1) % per_tile == 0) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if constexpr (A_LO || B_LO || B3) acc[j] += small[j];
        small[j] = 0.0f;
      }
      finish(it / per_tile, acc);
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
    }
    // every split of slice it + 1 is seen, and slice it's buffer is free
    named_barrier_sync(bar, 128);
    if (!DOUBLE && it + 1 < n_items) {
      split(it + 1, 0);
      if (!RING && it + 2 < n_items) load(it + 2);
      fence_proxy_async();
      named_barrier_sync(bar, 128);
    }
  }
}

// MASK: bit 0 xdt, 1 bb, 2 cc, 3 cs bf16.  A CTA is job `kind` (S tiles
// first, then Y tiles last to first) of head group g of batch*chunk bc; the
// job is the block index's fastest digit.  xmap: x dt as (bc h q) rows of
// 64, in boxes of 32 rows x 128 bytes.
template <int MASK>
__global__ void __launch_bounds__(W_THREADS, 1)
    ssd_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const void* __restrict__ xdt, const void* __restrict__ bb,
                     const void* __restrict__ cc, const void* __restrict__ cs,
                     float* __restrict__ y, float* __restrict__ s_out, int h,
                     int q, int n, int hg, int groups) {
  using namespace hopper;
  constexpr bool XB = MASK & 1, BB = (MASK >> 1) & 1, CB = (MASK >> 2) & 1,
                 SB = (MASK >> 3) & 1;
  extern __shared__ __align__(16) unsigned char wsm[];
  const uint32_t sbase = smem_addr(wsm);
  const uint32_t r0 = (sbase + 1023) & ~1023u;       // region 0, shared
  unsigned char* const g0 = wsm + (r0 - sbase);      // ... and generic
  float* const gmat = reinterpret_cast<float*>(g0 + W_R0);
  const uint32_t ring = r0 + W_R0 + W_R1, bars = ring + W_RING;

  const int y_tiles = q / WT, s_tiles = n / WT;
  const int kinds = y_tiles + s_tiles;
  const int kind = (int)(blockIdx.x % kinds);
  const long long grp = blockIdx.x / kinds;
  const int g = (int)(grp % groups);
  const long long bc = grp / groups;
  const int h0 = g * hg, nh = min(hg, h - h0);
  const long long cell0 = bc * h + h0;
  const bool is_s = kind < s_tiles;
  const int tile = is_s ? kind : y_tiles - 1 - (kind - s_tiles);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int bar = 1 + wg;
  const int my_heads = (nh - wg + 1) / 2;            // heads wg, wg + 2, ..

  if (X_TMA && wt == 0) {          // the warpgroup's two ring slots
    mbar_init(bars + 8 * (2 * wg), 1);
    mbar_init(bars + 8 * (2 * wg + 1), 1);
    mbar_init_fence();
  }

  // acc[j] of a 64 x 64 tile: row acc_row(j), column acc_col(j)
  auto acc_row = [&](int j) { return warp * 16 + (lane >> 2) + (j & 2) * 4; };
  auto acc_col = [&](int j) { return (j >> 2) * 8 + (lane & 3) * 2; };

  // Slice s (keys 32 s ..) of head hh of x dt, this warpgroup's item k: a
  // TMA copy into ring slot k % 2 by one thread, or (the comparison build)
  // 4 x 4 words a thread into registers: column p = idx % 64 and keys
  // 4 (idx / 64) .. + 3 for idx = wt + 128 m
  float xr[4][4];
  auto load_x = [&](int hh, int s, int k) {
    const long long row = (cell0 + hh) * q + 32 * s;
    if constexpr (X_TMA) {
      if (wt == 0) {
        const uint32_t slot = 2 * wg + (k & 1);
        mbar_arrive_expect_tx(bars + 8 * slot, W_SLOT / (XB ? 2 : 1));
        tma_load_2d(ring + slot * W_SLOT, &xmap, bars + 8 * slot, 0,
                    (int)row);
        if (!XB)
          tma_load_2d(ring + slot * W_SLOT + 4096, &xmap, bars + 8 * slot,
                      32, (int)row);
      }
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int idx = wt + 128 * m, pp = idx & 63, c = idx >> 6;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xr[m][e] = ld1<XB>(xdt, (row + 4 * c + e) * WT + pp);
      }
    }
  };
  // ... the same words of item k, once its copy has landed (a warp reads
  // one 128-byte row of a box, in 32 banks)
  auto x_words = [&](int k, float(&v)[4][4]) {
    if constexpr (X_TMA) {
      const int slot = 2 * wg + (k & 1);
      mbar_wait(bars + 8 * slot, (k >> 1) & 1);
      const unsigned char* sp = g0 + W_R0 + W_R1 + slot * W_SLOT;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int idx = wt + 128 * m, pp = idx & 63, c = idx >> 6;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * c + e;
          if constexpr (XB)
            v[m][e] = __bfloat162float(
                *reinterpret_cast<const __nv_bfloat16*>(
                    sp + sw(r, pp >> 3) + (pp & 7) * 2));
          else
            v[m][e] = *reinterpret_cast<const float*>(
                sp + (pp >> 5) * 4096 + sw(r, (pp & 31) >> 2) + (pp & 3) * 4);
        }
      }
    } else {
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[m][e] = xr[m][e];
    }
  };
  // ... split into K-major rows p of the B operand: for y into two parts
  // (big, and small unless x dt is bf16); for S, scaled by the decay
  // first, into three (big, mid, low at big + W_TILE, + 2 W_TILE)
  auto split_x = [&](unsigned char* big, unsigned char* sml, int k, int s,
                     const float* decay) {
    float xv[4][4];
    x_words(k, xv);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int idx = wt + 128 * m, pp = idx & 63, c = idx >> 6;
      const float4 v = make_float4(xv[m][0], xv[m][1], xv[m][2], xv[m][3]);
      float4 hi, lo;
      if (decay != nullptr) {
        const float4 d =
            *reinterpret_cast<const float4*>(decay + 32 * s + 4 * c);
        float4 mid;
        split3_tf32(make_float4(d.x * v.x, d.y * v.y, d.z * v.z, d.w * v.w),
                    hi, mid, lo);
        *reinterpret_cast<float4*>(big + sw(pp, c)) = hi;
        *reinterpret_cast<float4*>(big + W_TILE + sw(pp, c)) = mid;
        *reinterpret_cast<float4*>(big + 2 * W_TILE + sw(pp, c)) = lo;
        continue;
      }
      split_tf32(v, hi, lo);
      *reinterpret_cast<float4*>(big + sw(pp, c)) = hi;
      if (sml != nullptr) *reinterpret_cast<float4*>(sml + sw(pp, c)) = lo;
    }
  };

  if (is_s) {
    // ---- rows n0 .. n0 + 63 of S for the group's heads
    const int n0 = tile * WT;
    float* const hv = reinterpret_cast<float*>(g0 + W_R0 + 6 * W_TILE);
    for (int e = tid; e < nh * q; e += W_THREADS) {
      const float last = ld1<SB>(cs, (cell0 + e / q) * q + q - 1);
      hv[e] = as_cs(expf(as_cs(last - ld1<SB>(cs, cell0 * q + e), SB)), SB);
    }
    // B^T, split: key chunk c (keys 4 c .. 4 c + 3) of state row nn
    for (int e = tid; e < (q / 32) * 512; e += W_THREADS) {
      const int ch = e >> 9, nn = e & 63, c = (e >> 6) & 7;
      const long long b0 = (bc * q + 32 * ch + 4 * c) * n + n0 + nn;
      float4 hi, lo;
      split_tf32(make_float4(ld1<BB>(bb, b0), ld1<BB>(bb, b0 + n),
                             ld1<BB>(bb, b0 + 2 * n), ld1<BB>(bb, b0 + 3 * n)),
                 hi, lo);
      const uint32_t off = ch * W_TILE + sw(nn, c);
      *reinterpret_cast<float4*>(g0 + off) = hi;
      if (!BB) *reinterpret_cast<float4*>(g0 + W_R0 / 2 + off) = lo;
    }
    fence_proxy_async();
    __syncthreads();
    // x dt's three parts in one buffer a warpgroup (region 1)
    const int ns = q / 32;
    const uint32_t xbuf = W_R0 + wg * 3 * W_TILE;
    wg_pipeline<!BB, true, true, false, X_TMA>(
        my_heads * ns, ns, bar,
        [&](int it) { load_x(wg + 2 * (it / ns), it % ns, it); },
        [&](int it, int) {
          split_x(g0 + xbuf, nullptr, it, it % ns,
                  hv + (wg + 2 * (it / ns)) * q);
        },
        [&](int it, int) {
          const uint32_t a = r0 + (it % ns) * W_TILE;
          return make_uint4(a, a + W_R0 / 2, r0 + xbuf, r0 + xbuf + W_TILE);
        },
        [&](int hk, float(&acc)[32]) {
          float* sc = s_out + ((cell0 + wg + 2 * hk) * n + n0) * WT;
#pragma unroll
          for (int j = 0; j < 32; j += 2)
            *reinterpret_cast<float2*>(sc + acc_row(j) * WT + acc_col(j)) =
                make_float2(acc[j], acc[j + 1]);
        });
    return;
  }

  // ---- rows i0 .. i0 + 63 of y for the group's heads
  const int t = tile, i0 = t * WT;
  auto buf = [&](int b) { return (2 * wg + b) * W_BUF; };
  auto buf_addr = [&](int it, int b) {
    const uint32_t a = r0 + buf(b);
    return make_uint4(a, a + W_TILE, a + 2 * W_TILE, a + 3 * W_TILE);
  };

  // G's key tiles jt = wg, wg + 2, .. <= t, each over N in slices of 32: C
  // rows i0 .. and B rows 64 jt .., K-major as stored, 4 + 4 float4 a thread
  const int n_sl = n / 32;
  float4 ca[4], ba[4];
  wg_pipeline<!CB, !BB, false, true, false>(
      (t + 2 - wg) / 2 * n_sl, n_sl, bar,
      [&](int it) {
        const int jt = wg + 2 * (it / n_sl), s = it % n_sl;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int idx = wt + 128 * m, row = idx >> 3, c = idx & 7;
          ca[m] = ld4<CB>(cc, (bc * q + i0 + row) * n + 32 * s + 4 * c);
          ba[m] = ld4<BB>(bb, (bc * q + jt * WT + row) * n + 32 * s + 4 * c);
        }
      },
      [&](int it, int b) {
        unsigned char* bp = g0 + buf(b);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int idx = wt + 128 * m, row = idx >> 3, c = idx & 7;
          float4 hi, lo;
          split_tf32(ca[m], hi, lo);
          *reinterpret_cast<float4*>(bp + sw(row, c)) = hi;
          if (!CB) *reinterpret_cast<float4*>(bp + W_TILE + sw(row, c)) = lo;
          split_tf32(ba[m], hi, lo);
          *reinterpret_cast<float4*>(bp + 2 * W_TILE + sw(row, c)) = hi;
          if (!BB)
            *reinterpret_cast<float4*>(bp + 3 * W_TILE + sw(row, c)) = lo;
        }
      },
      buf_addr,
      [&](int kt, float(&acc)[32]) {
        float* gt = gmat + (wg + 2 * kt) * WT;
#pragma unroll
        for (int j = 0; j < 32; j += 2)
          *reinterpret_cast<float2*>(gt + acc_row(j) * GLD + acc_col(j)) =
              make_float2(acc[j], acc[j + 1]);
      });
  __syncthreads();                 // G's tile is complete

  // each head: keys j < i0 + 64 in slices of 32; M's slice from G: row
  // idx / 8 and keys 4 (idx % 8) .. + 3 for idx = wt + 128 m, with cs read
  // from device memory (L1 keeps the head's row)
  const int ns = 2 * (t + 1);
  wg_pipeline<true, !XB, false, true, X_TMA>(
      my_heads * ns, ns, bar,
      [&](int it) { load_x(wg + 2 * (it / ns), it % ns, it); },
      [&](int it, int b) {
        const int s = it % ns;
        const long long csh = (cell0 + wg + 2 * (it / ns)) * q;
        unsigned char* bp = g0 + buf(b);
        const int j0 = 32 * s + 4 * (wt & 7);        // the same for every m
        const float4 cj = ld4<SB>(cs, csh + j0);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int idx = wt + 128 * m, row = idx >> 3, c = idx & 7;
          const int i = i0 + row;
          const float4 gv =
              *reinterpret_cast<const float4*>(gmat + row * GLD + j0);
          const float ci = ld1<SB>(cs, csh + i);
          // the decay only where j <= i: above the diagonal it overflows
          const float4 mv = make_float4(
              j0 <= i ? gv.x * expf(as_cs(ci - cj.x, SB)) : 0.0f,
              j0 + 1 <= i ? gv.y * expf(as_cs(ci - cj.y, SB)) : 0.0f,
              j0 + 2 <= i ? gv.z * expf(as_cs(ci - cj.z, SB)) : 0.0f,
              j0 + 3 <= i ? gv.w * expf(as_cs(ci - cj.w, SB)) : 0.0f);
          float4 hi, lo;
          split_tf32(mv, hi, lo);
          *reinterpret_cast<float4*>(bp + sw(row, c)) = hi;
          *reinterpret_cast<float4*>(bp + W_TILE + sw(row, c)) = lo;
        }
        split_x(bp + 2 * W_TILE, XB ? nullptr : bp + 3 * W_TILE, it, s,
                nullptr);
      },
      buf_addr,
      [&](int hk, float(&acc)[32]) {
        float* yc = y + ((cell0 + wg + 2 * hk) * q + i0) * WT;
#pragma unroll
        for (int j = 0; j < 32; j += 2)
          *reinterpret_cast<float2*>(yc + acc_row(j) * WT + acc_col(j)) =
              make_float2(acc[j], acc[j + 1]);
      });
}

template <int MASK>
static int launch_wgmma(const void* xdt, const void* bb, const void* cc,
                        const void* cs, void* y, void* s, long long bc, int h,
                        int q, int n, int hg, cudaStream_t stream) {
  // the shared-memory opt-in, once a device (a call costs microseconds)
  static bool opted_in[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !opted_in[dev]) {
    e = cudaFuncSetAttribute(ssd_wgmma_kernel<MASK>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)W_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) opted_in[dev] = true;
  }
  // x dt as (bc h q) rows of 64: boxes of 32 rows x 128 bytes
  constexpr bool XB = MASK & 1;
  CUtensorMap xmap;
  const uint64_t dims[2] = {(uint64_t)WT, (uint64_t)(bc * h * q)};
  const uint32_t box[2] = {XB ? 64u : 32u, 32u};
  const int err = hopper::make_tensor_map(
      &xmap, xdt, 2, dims, box,
      XB ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != 0) return err;
  const int groups = (h + hg - 1) / hg;
  const long long blocks = bc * groups * (q / WT + n / WT);
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ssd_wgmma_kernel<MASK><<<(unsigned)blocks, W_THREADS, W_SMEM, stream>>>(
      xmap, xdt, bb, cc, cs, static_cast<float*>(y), static_cast<float*>(s),
      h, q, n, hg, groups);
  return (int)cudaGetLastError();
}

typedef int (*LaunchW)(const void*, const void*, const void*, const void*,
                       void*, void*, long long, int, int, int, int,
                       cudaStream_t);
static const LaunchW kLaunchW[16] = {
    launch_wgmma<0>,  launch_wgmma<1>,  launch_wgmma<2>,  launch_wgmma<3>,
    launch_wgmma<4>,  launch_wgmma<5>,  launch_wgmma<6>,  launch_wgmma<7>,
    launch_wgmma<8>,  launch_wgmma<9>,  launch_wgmma<10>, launch_wgmma<11>,
    launch_wgmma<12>, launch_wgmma<13>, launch_wgmma<14>, launch_wgmma<15>};

extern "C" {

// The tile edge; the wrapper checks it.
int ssd_intra_tile() { return TILE; }

// y (bc * h, q, p) and s (bc * h, n, p), f32, from xdt (bc * h, q, p), bb
// and cc (bc, q, n) and cs (bc * h, q), row-major and contiguous, each f32
// or bf16 as bit 0 (xdt), 1 (bb), 2 (cc) and 3 (cs) of bf16_mask say.
// q, n, p >= 1; the grid (bc * h, ceil(q / 64) + ceil(n / 64), ceil(p / 64))
// must fit (y <= 65535, z <= 65535); the wrapper checks them.  Returns
// cudaGetLastError() after the launch (0 on success).
int ssd_intra_launch(const void* xdt, const void* bb, const void* cc,
                     const void* cs, void* y, void* s, long long bc, int h,
                     int q, int n, int p, int bf16_mask, void* stream) {
  const int y_tiles = (q + TILE - 1) / TILE;
  const dim3 grid((unsigned)(bc * h), y_tiles + (n + TILE - 1) / TILE,
                  (p + TILE - 1) / TILE);
  return kLaunch[bf16_mask & 15](xdt, bb, cc, cs, y, s, grid, h, q, n, p,
                                 y_tiles, (cudaStream_t)stream);
}

// The wgmma design's tile edge (= P), most Q, most heads a CTA, and
// whether x dt comes through the TMA ring (1) or the threads' loads (0,
// SSD_THREAD_FED); the wrapper checks them.
int ssd_intra_wgmma_shape() {
  return WT | WQ_MAX << 8 | WHG << 20 | (X_TMA ? 1 : 0) << 28;
}

// The same cell on the wgmma design: p == 64, q a multiple of 64 with 64 <=
// q <= 256, n a multiple of 64, bc * h * q < 2^31 (TMA's row coordinate),
// 1 <= hg <= WHG heads a CTA, every input 16-byte aligned; returns
// cudaErrorInvalidValue for a shape it does not take, else
// cudaGetLastError() after the launch.
int ssd_intra_wgmma_launch(const void* xdt, const void* bb, const void* cc,
                           const void* cs, void* y, void* s, long long bc,
                           int h, int q, int n, int p, int hg, int bf16_mask,
                           void* stream) {
  if (p != WT || q % WT || q < WT || q > WQ_MAX || n % WT || n < WT ||
      hg < 1 || hg > WHG || bc < 1 || h < 1 || bc * h * q > INT_MAX)
    return (int)cudaErrorInvalidValue;
  return kLaunchW[bf16_mask & 15](xdt, bb, cc, cs, y, s, bc, h, q, n, hg,
                                  (cudaStream_t)stream);
}

}  // extern "C"
