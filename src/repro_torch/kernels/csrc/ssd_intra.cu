// Mamba2 SSD intra-chunk cell, one (batch*chunk, head) cell at a time:
//
//   G = C B^T                          (Q x Q)
//   M = G * exp(cs_i - cs_j), j <= i   (0 above the diagonal)
//   y = M (x dt)                       (Q x P)
//   S = B^T (exp(cs_{Q-1} - cs) * x dt)  (N x P)
//
// Replaces the TPU kernel src/repro/kernels/ssd_intra.py:ssd_intra (body
// _ssd_kernel), one grid step per (batch*chunk, head) cell with the whole
// cell in VMEM, so the (Q, Q) decay matrix never reaches HBM.  Here a cell
// is cut into 64-row tiles, one thread block each: ceil(Q / 64) blocks own
// rows of y, and ceil(N / 64) more own rows of S; a third grid axis cuts P
// into 64-column slices.  A y block walks the 64-key tiles j0 <= its last
// row, builds that (64 x 64) tile of G from C and B staged in slices of 32
// state columns, turns it into the tile of M in shared memory and
// multiplies it into x dt; nothing of G or M leaves the block.  An S block
// walks all key tiles, scaling x dt by the end-of-chunk decay as it stages
// it.
//
// The decay exp(cs_i - cs_j) of a masked pair (j > i) overflows to inf at
// realistic chunk lengths (Q = 256 with dt * a down to -1 a step gives
// exponents up to +255), and 0 * inf is NaN; so the exponential is
// evaluated only where j <= i, and the masked entries are a literal 0.
//
// Arithmetic: f32 throughout, on the CUDA cores, with FMAs; sums run in
// another order than the plain version's.  The elementwise products
// g * exp(.) and exp(.) * x dt are rounded once each, as in the Pallas
// kernel.  Ragged Q, N and P are masked here.  Each input may be f32 or
// bf16 (one instantiation for each of the 16 mixes, so no load tests a
// dtype at run time): bf16 is widened to f32 as it is read, and every
// bf16 product is exact in f32.  With a bf16 cs the kernel rounds to bf16
// where the JAX package's arithmetic does, whose differences of a bf16 cs
// are bf16: cs_i - cs_j before its exponential, and cs_{Q-1} - cs_j and
// the end-of-chunk decay exp(.) itself.  y and S are f32 either way.
//
// Layout of a block: 256 threads as 16 x 16; thread (ty, tx) owns rows
// ty + 16 a and columns tx + 16 b (a, b < 4) of every 64 x 64 tile it
// computes (G, M, y or S), so neighbouring threads read neighbouring words.
// C and B slices sit in shared memory transposed (rows padded by one), the
// M tile padded by 16; the C/B slices and the M tile share one buffer.
//
// What bounds it on an H100: at mamba2-370m's shapes (Q = 256, N = 128,
// P = 64, 1,024 cells) the work is bound by f32 operations (67 TFLOP/s on
// the CUDA cores; the bytes, 2 x 4 MB in and 10 MB out per 1,024 cells,
// take far less).  The design stages through shared memory with one stage
// and no copy / compute overlap.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // extern "C"
