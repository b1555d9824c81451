// Flash attention: out (BH, Sq, d) = softmax(q k^T / sqrt(d)) v, online.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention (body _flash_kernel): a (BH, Sq/bq, Sk/bk) grid whose
// innermost, sequential KV axis keeps the running max m, denominator l and
// output accumulator acc of one query tile in VMEM scratch, skips KV tiles
// wholly above the causal diagonal, and writes the tile once.  On the card
// blocks run in no order, so one thread block owns one query tile and
// walks the KV tiles itself, ascending from tile 0 (key 0 is valid for
// every row, so the first tile always lifts m above the -1e30 sentinel),
// with m, l and acc in registers.  Heavy query tiles (those near the end
// of the sequence under `causal`) are scheduled first.
//
// Arithmetic, as the Pallas kernel's: scores in f32, scaled by 1/sqrt(d)
// after the product; masked scores are -1e30 (a key is valid below sk;
// under `causal` query i sees keys j <= i, start-aligned also when Sq !=
// Sk); p = exp(s - m_new) with accurate expf, l = l * corr + sum(p) in
// f32, p rounded to v's type before the p v product, which sums in f32;
// the output is acc / max(l, 1e-30), rounded to q's type.  Sums run in
// another order than the plain version's, with FMAs.
//
// GQA: q head h of batch b reads kv head h / group, i.e. kv row bh / group
// of the (B * Hkv, Sk, d) k and v, so the group is never copied out.
// Ragged Sq and Sk are handled here; the caller pads nothing.
//
// Three kernels; the wrapper picks one from the operands before the launch
// (flash_attention.py:attention_path):
//
// * flash_wgmma_kernel, bf16 at any d % 8 == 0 (d <= 128) with contiguous,
//   16-byte-aligned q, k and v (the models' case): a block owns a 128-row
//   query tile and walks 128-key tiles.  The head is stored in a tile of D
//   = 64 columns (d <= 64) or 128 (d > 64): the tensor maps are 3-D over
//   (BH, S, d) with 64-column boxes, so TMA zero-fills a tile's columns d
//   .. D - 1 as it zero-fills keys past Sk, within the tile's own head
//   (the row stride, 2 d bytes, is a multiple of 16 as a tensor map
//   needs).  Zero columns add nothing to q k^T and give zero output
//   columns, which are not stored.  One producer warpgroup (registers
//   lowered by setmaxnreg) has one thread load the q tile once and the k
//   and v tiles through a 2-stage ring of TMA loads, each stage with a
//   full and an empty mbarrier; 160 KB of shared memory at D = 128.  Two
//   consumer warpgroups own 64 query rows each: s = q k^T is wgmma
//   m64n128k16 over ceil(d / 16) k-steps with q and k from shared memory
//   (k is K-major as stored); its accumulator layout is that of wgmma's
//   register A operand, so p is rounded to bf16 in registers and o += p v
//   is wgmma (n = D) with A from registers and v from shared memory,
//   MN-major (the transpose bit), so v is never transposed.  The row max
//   and sum are two xor-shuffles over the four threads that share an
//   accumulator row.  Only tiles that cross the diagonal or the end of
//   the keys are masked.  Layout rules of the tiles and descriptors:
//   hopper.cuh.
// * flash_bf16_kernel, bf16 where TMA cannot read the operands (d % 8 !=
//   0, operands not contiguous or not 16-byte aligned), d <= 128: 4 warps,
//   each owning 16 query rows of a 64-row tile, walking 64-key tiles on
//   the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   A warp's q fragments stay in registers for the whole walk; s = q k^T
//   comes out in the accumulator layout, which is also the layout of the
//   A operand of p v, so p is rounded to bf16 and fed back without going
//   through shared memory.  k is staged row-major and v transposed, rows padded by
//   16 bytes (no bank conflicts on the 32-bit fragment loads); 36 KB of
//   shared memory at d = 128.
// * flash_f32_kernel, f32: the tensor cores would round to TF32, so 256
//   threads as 16 x 16 on the CUDA cores over 64 x 64 tiles, thread (ty,
//   tx) owning rows ty + 16 i (i < 4), score columns tx + 16 j (j < 4) and
//   output columns tx + 16 j (j < NJ); q and k tiles transposed in shared
//   memory (rows padded by one), v row-major, p row-major padded by 16;
//   120 KB at d = 128 (dynamic shared memory, opted into).
//
// What bounds it on an H100: at the model's shapes (d = 128, S = 4096) the
// work, 2 S^2 d BH operations for the causal half, is bound by operations:
// 989 TFLOP/s for bf16 on the tensor cores (67 for f32 on the CUDA cores).
// The wgmma kernel keeps the tensor cores fed from a TMA ring; within a
// warpgroup the softmax still waits on its s product and the p v product
// on the softmax.  Ping-pong scheduling of the two warpgroups and
// overlapping the softmax with the next product are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

#define BQ 64            // query rows of a block (mma.sync and f32 kernels)
#define BKV 64           // keys of a KV tile (mma.sync and f32 kernels)
#define MAX_D 128        // the widest head the kernels take
#define NEG_INF (-1e30f)

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

#define MMA_WARPS 4                 // 16 query rows each
#define MMA_THREADS (32 * MMA_WARPS)
#define SKEW 8                      // bf16 padding of a shared-memory row

static_assert(BQ == 16 * MMA_WARPS, "a warp owns 16 query rows");

// d += a b: one m16n8k16 product, a (16 x 16, row-major fragments), b
// (16 x 8, column-major fragments), d (16 x 8) in f32.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values at p (p[0] in the low half), as one 32-bit register.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Round two f32 values to bf16 (round to nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// NK = ceil(d / 16) rounded to a power of two: the 16-wide steps over d of
// q k^T; the p v product has 2 NK output tiles of 8 columns.
template <int NK>
__global__ void __launch_bounds__(MMA_THREADS)
    flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out, int sq, int sk, int d,
                      int group, int causal, float scale) {
  constexpr int DP = 16 * NK;            // d padded to the k-steps
  constexpr int LDK = DP + SKEW;         // row of the q / k tile
  constexpr int LDV = BKV + SKEW;        // row of the transposed v tile
  __shared__ __align__(16) __nv_bfloat16 ks[BKV * LDK];   // q, then k tiles
  __shared__ __align__(16) __nv_bfloat16 vt[DP * LDV];    // v^T tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;   // fragment row / column pair
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;    // heavy tiles first
  const __nv_bfloat16* qb = q + bh * sq * d;
  const __nv_bfloat16* kb = k + (bh / group) * sk * d;
  const __nv_bfloat16* vb = v + (bh / group) * sk * d;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.0f);

  // q tile -> shared -> this warp's A fragments, held for the whole walk
  for (int e = tid; e < BQ * DP; e += MMA_THREADS) {
    const int r = e / DP, c = e - r * DP;
    ks[r * LDK + c] = (q0 + r < sq && c < d)
                          ? qb[(long long)(q0 + r) * d + c] : zero;
  }
  __syncthreads();
  uint32_t qf[NK][4];
  const int r0 = warp * 16 + gid;              // this thread's rows r0, r0 + 8
#pragma unroll
  for (int t = 0; t < NK; ++t) {
    const int c = t * 16 + tig * 2;
    qf[t][0] = load_pair(&ks[r0 * LDK + c]);
    qf[t][1] = load_pair(&ks[(r0 + 8) * LDK + c]);
    qf[t][2] = load_pair(&ks[r0 * LDK + c + 8]);
    qf[t][3] = load_pair(&ks[(r0 + 8) * LDK + c + 8]);
  }
  __syncthreads();

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[2 * NK][4];
#pragma unroll
  for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
  const int row[2] = {q0 + r0, q0 + r0 + 8};

  int n_tiles = (sk + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BKV;
    for (int e = tid; e < BKV * DP; e += MMA_THREADS) {
      const int r = e / DP, c = e - r * DP;
      const bool ok = k0 + r < sk && c < d;
      const long long g = (long long)(k0 + r) * d + c;
      ks[r * LDK + c] = ok ? kb[g] : zero;
      vt[c * LDV + r] = ok ? vb[g] : zero;
    }
    __syncthreads();

    // s = q k^T: 8 tiles of 8 keys
    float s[BKV / 8][4];
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = 0.0f;
#pragma unroll
      for (int t = 0; t < NK; ++t) {
        const __nv_bfloat16* kr = &ks[(n * 8 + gid) * LDK + t * 16 + tig * 2];
        const uint32_t b[2] = {load_pair(kr), load_pair(kr + 8)};
        mma_bf16_16816(s[n], qf[t], b);
      }
    }

    // scale, mask, online softmax for rows row[0] (i = 0, 1), row[1] (2, 3)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = k0 + n * 8 + tig * 2 + (i & 1);
        const int h = i >> 1;
        const bool valid = col < sk && (!causal || col <= row[h]);
        s[n][i] = valid ? s[n][i] * scale : NEG_INF;
        mx[h] = fmaxf(mx[h], s[n][i]);
      }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < BKV / 8; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[n][i] = expf(s[n][i] - m[i >> 1]);
        sum[i >> 1] += s[n][i];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // acc += p v: p (rounded to bf16) in the A layout, 16 keys a step
#pragma unroll
    for (int t = 0; t < BKV / 16; ++t) {
      const uint32_t pf[4] = {pack_bf16(s[2 * t][0], s[2 * t][1]),
                              pack_bf16(s[2 * t][2], s[2 * t][3]),
                              pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]),
                              pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3])};
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n) {
        const __nv_bfloat16* vr = &vt[(n * 8 + gid) * LDV + t * 16 + tig * 2];
        const uint32_t b[2] = {load_pair(vr), load_pair(vr + 8)};
        mma_bf16_16816(acc[n], pf, b);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* ob = out + bh * sq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= sq) continue;
    const float inv = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = n * 8 + tig * 2 + i;
        if (col < d)
          ob[(long long)row[h] * d + col] =
              __float2bfloat16_rn(acc[n][2 * h + i] / inv);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: wgmma fed by a TMA ring (d % 8 == 0)
// ---------------------------------------------------------------------------

#define WG_BQ 128                  // query rows of a block (two warpgroups)
#define WG_BKV 128                 // keys of a KV tile
#define WG_STAGES 2                // KV tiles in flight
#define WG_THREADS 384             // producer + two consumer warpgroups
#define WG_CONSUMER_WARPS 8

static_assert(WG_BQ == 2 * 64 && WG_BKV == 128,
              "two warpgroups of 64 query rows, wgmma m64n128 for s");

constexpr uint32_t WG_CHUNK = 128 * 128;   // 128 rows x 64 columns of bf16

template <int D>
constexpr size_t wg_smem_bytes() {
  return 1024 + (size_t)(1 + 2 * WG_STAGES) * (D / 64) * WG_CHUNK +
         8 * (1 + 2 * WG_STAGES);
}

// The storage width of a tile's rows for NKS = ceil(d / 16) k-steps of s:
// one 64-column chunk up to d = 64, two up to d = 128.
__host__ __device__ constexpr int wg_storage(int nks) {
  return nks <= 4 ? 64 : 128;
}

template <int NKS>
__global__ void __launch_bounds__(WG_THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                       const __grid_constant__ CUtensorMap kmap,
                       const __grid_constant__ CUtensorMap vmap,
                       __nv_bfloat16* __restrict__ out, int sq, int sk, int d,
                       int group, int causal, float scale) {
  using namespace hopper;
  static_assert(NKS >= 1 && 16 * NKS <= MAX_D, "k-steps of a head");
  constexpr int D = wg_storage(NKS);             // columns of a stored row
  constexpr int NCH = D / 64;                    // 64-column chunks of a row
  constexpr uint32_t TILE = NCH * WG_CHUNK;      // one q, k or v tile
  extern __shared__ __align__(16) unsigned char smem[];
  // tiles: smem rounded up to 1024 bytes (the swizzle's alignment); q at
  // tiles, k of stage s at tiles + (1 + s) TILE, v at + (1 + S + s) TILE;
  // chunk c of a tile (its columns 64 c .. 64 c + 63) at + c WG_CHUNK
  const uint32_t tiles = (smem_addr(smem) + 1023) & ~1023u;
  const uint32_t q_s = tiles;
  auto k_s = [&](int s) { return tiles + (1 + s) * TILE; };
  auto v_s = [&](int s) { return tiles + (1 + WG_STAGES + s) * TILE; };
  const uint32_t bars = tiles + (1 + 2 * WG_STAGES) * TILE;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + WG_STAGES + s); };

  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * WG_BQ;   // heavy tiles first
  int n_tiles = (sk + WG_BKV - 1) / WG_BKV;
  if (causal) n_tiles = min(n_tiles, q0 / WG_BKV + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG_CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads q once, then k and v tile by tile
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int kvh = bh / group;
      mbar_arrive_expect_tx(q_full, TILE);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        tma_load_3d(q_s + c * WG_CHUNK, &qmap, q_full, 64 * c, q0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % WG_STAGES;
        mbar_wait(empty(s), ((t / WG_STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full(s), 2 * TILE);
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          tma_load_3d(k_s(s) + c * WG_CHUNK, &kmap, full(s), 64 * c,
                      t * WG_BKV, kvh);
          tma_load_3d(v_s(s) + c * WG_CHUNK, &vmap, full(s), 64 * c,
                      t * WG_BKV, kvh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns query rows q0 + 64 c .. + 63; this thread
  // rows row0 and row0 + 8 (accumulator registers j with j & 2 == 0 and
  // j & 2 != 0), columns 8 (j / 4) + 2 (lane % 4) + (j & 1)
  setmaxnreg_inc<240>();
  const int c = wg - 1;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int row0 = q0 + c * 64 + warp * 16 + (lane >> 2);
  const int row[2] = {row0, row0 + 8};
  const int col0 = (lane & 3) * 2;
  const uint32_t q_wg = q_s + c * 64 * 128;      // this warpgroup's q rows

  float o[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) o[j] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % WG_STAGES;
    const int k0 = t * WG_BKV;
    mbar_wait(full(s), (t / WG_STAGES) & 1);

    // s = q k^T: 128 keys, ceil(d / 16) k-steps (32 bytes each within a
    // chunk; at d % 16 == 8 the last one's upper 8 columns are TMA's zeros)
    float sc[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) sc[j] = 0.0f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const uint32_t off = (ks / 4) * WG_CHUNK + (ks % 4) * 32;
      wgmma_m64n128k16_ss<0>(sc, desc_sw128(q_wg + off, 16, 1024),
                             desc_sw128(k_s(s) + off, 16, 1024), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // scale; mask only a tile that crosses the end of the keys or, under
    // causal, the diagonal of this warpgroup's rows
    const bool edge = k0 + WG_BKV > sk ||
                      (causal && k0 + WG_BKV - 1 > q0 + c * 64);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int h = (j >> 1) & 1;
      if (edge) {
        const int col = k0 + (j >> 2) * 8 + col0 + (j & 1);
        const bool valid = col < sk && (!causal || col <= row[h]);
        sc[j] = valid ? sc[j] * scale : NEG_INF;
      } else {
        sc[j] *= scale;
      }
      mx[h] = fmaxf(mx[h], sc[j]);
    }
    float corr[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int h = (j >> 1) & 1;
      sc[j] = expf(sc[j] - m[h]);
      sum[h] += sc[j];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      l[h] = l[h] * corr[h] + sum[h];
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];

    // o += p v: p rounded to bf16 in the register A layout, 16 keys a
    // k-step (registers 8 kt .. 8 kt + 7); v MN-major, 16 rows of 128
    // bytes a k-step, its 64-column chunks WG_CHUNK apart (LBO); v's
    // columns d .. D - 1 are zeros, so are o's
    uint32_t pf[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) pf[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < WG_BKV / 16; ++kt) {
      const uint32_t a[4] = {pf[4 * kt], pf[4 * kt + 1], pf[4 * kt + 2],
                             pf[4 * kt + 3]};
      const uint64_t dv = desc_sw128(v_s(s) + 2048 * kt, WG_CHUNK, 1024);
      if constexpr (D == 128)
        wgmma_m64n128k16_rs<1>(o, a, dv, 1);
      else
        wgmma_m64n64k16_rs<1>(o, a, dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if (lane == 0) mbar_arrive(empty(s));
  }

  // rows of d columns; a pair (col, col + 1) lies wholly below d or not,
  // as d is even
  __nv_bfloat16* ob = out + (long long)bh * sq * d;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= sq) continue;
    const float inv = fmaxf(l[h], 1e-30f);
#pragma unroll
    for (int j = 2 * h; j < D / 2; j += 4) {
      const int col = (j >> 2) * 8 + col0;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row[h] * d + col) =
            __floats2bfloat162_rn(o[j] / inv, o[j + 1] / inv);
    }
  }
}

// The tensor maps are over the true width d: a 64-column box reaching past
// d reads zeros there.
template <int NKS>
static int launch_wgmma(const void* q, const void* k, const void* v,
                        void* out, int bh, int sq, int sk, int d, int group,
                        int causal, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  const uint64_t qdims[3] = {(uint64_t)d, (uint64_t)sq, (uint64_t)bh};
  const uint64_t kdims[3] = {(uint64_t)d, (uint64_t)sk,
                             (uint64_t)(bh / group)};
  const uint32_t box[3] = {64, 128, 1};
  int err = hopper::make_tensor_map(&qmap, q, 3, qdims, box);
  if (err == 0) err = hopper::make_tensor_map(&kmap, k, 3, kdims, box);
  if (err == 0) err = hopper::make_tensor_map(&vmap, v, 3, kdims, box);
  if (err != 0) return err;
  const size_t smem = wg_smem_bytes<wg_storage(NKS)>();
  cudaError_t e = cudaFuncSetAttribute(
      flash_wgmma_kernel<NKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(bh, (sq + WG_BQ - 1) / WG_BQ);
  flash_wgmma_kernel<NKS><<<grid, WG_THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(out), sq, sk, d, group,
      causal, scale);
  return (int)cudaGetLastError();
}

// The wgmma kernel at d with its ceil(d / 16) k-steps of s; d % 8 == 0 and
// d <= MAX_D, else cudaErrorInvalidValue.
static int launch_wgmma_at(const void* q, const void* k, const void* v,
                           void* out, int bh, int sq, int sk, int d,
                           int group, int causal, float scale,
                           cudaStream_t s) {
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  switch ((d + 15) / 16) {
#define WG_CASE(n)                                                       \
  case n:                                                                \
    return launch_wgmma<n>(q, k, v, out, bh, sq, sk, d, group, causal, \
                           scale, s);
    WG_CASE(1) WG_CASE(2) WG_CASE(3) WG_CASE(4)
    WG_CASE(5) WG_CASE(6) WG_CASE(7) WG_CASE(8)
#undef WG_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32 on the CUDA cores
// ---------------------------------------------------------------------------

#define F32_THREADS 256  // 16 x 16
#define LDT (BQ + 1)     // padded row of the transposed q and k tiles
#define LDP (BKV + 16)   // padded row of the p tile

static_assert(BQ == BKV, "the q and k tiles share one padded row length");

// Bytes of the f32 kernel's shared memory at head width d (NJ = dp / 16).
template <int NJ>
static size_t f32_smem_bytes(int d) {
  return sizeof(float) * ((size_t)2 * d * LDT + (size_t)BKV * 16 * NJ +
                          (size_t)BQ * LDP);
}

template <int NJ>
__global__ void __launch_bounds__(F32_THREADS)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int sq, int sk, int d, int group, int causal,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dp = 16 * NJ;                      // d padded to the threads
  float* qt = reinterpret_cast<float*>(smem);  // (d, LDT)
  float* kt = qt + d * LDT;                    // (d, LDT)
  float* vs = kt + d * LDT;                    // (BKV, dp)
  float* ps = vs + BKV * dp;                   // (BQ, LDP)

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const long long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;    // heavy tiles first
  const float* qb = q + bh * sq * d;
  const float* kb = k + (bh / group) * sk * d;
  const float* vb = v + (bh / group) * sk * d;

  for (int e = tid; e < BQ * d; e += F32_THREADS) {
    const int r = e / d, c = e - r * d;
    qt[c * LDT + r] = q0 + r < sq ? qb[(long long)(q0 + r) * d + c] : 0.0f;
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  int n_tiles = (sk + BKV - 1) / BKV;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BKV + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BKV;
    for (int e = tid; e < BKV * d; e += F32_THREADS) {
      const int r = e / d, c = e - r * d;
      kt[c * LDT + r] = k0 + r < sk ? kb[(long long)(k0 + r) * d + c] : 0.0f;
    }
    for (int e = tid; e < BKV * dp; e += F32_THREADS) {
      const int r = e / dp, c = e - r * dp;
      vs[e] = (k0 + r < sk && c < d) ? vb[(long long)(k0 + r) * d + c] : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
    for (int kk = 0; kk < d; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[kk * LDT + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kt[kk * LDT + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    // the 16 threads of a row are one half-warp: xor-shuffles within it
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool valid = col < sk && (!causal || col <= row);
        s[i][j] = valid ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty + 16 * i) * LDP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BKV; ++c) {
      float a[4], b[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = vs[c * dp + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* ob = out + bh * sq * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float inv = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < d) ob[(long long)row * d + col] = acc[i][j] / inv;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int NJ>
static int launch_f32(const void* q, const void* k, const void* v, void* out,
                      dim3 grid, int sq, int sk, int d, int group, int causal,
                      float scale, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes<NJ>(d);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  flash_f32_kernel<NJ><<<grid, F32_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, d,
      group, causal, scale);
  return (int)cudaGetLastError();
}

template <int NK>
static int launch_bf16(const void* q, const void* k, const void* v, void* out,
                       dim3 grid, int sq, int sk, int d, int group, int causal,
                       float scale, cudaStream_t stream) {
  flash_bf16_kernel<NK><<<grid, MMA_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, sk, d, group, causal, scale);
  return (int)cudaGetLastError();
}

extern "C" {

// The wgmma kernel's query tile and KV tile, the mma.sync (and f32)
// kernels' query tile and KV tile, and the widest head; the wrapper checks
// them.
int flash_attention_block_q() { return WG_BQ; }
int flash_attention_block_k() { return WG_BKV; }
int flash_attention_mma_block_q() { return BQ; }
int flash_attention_mma_block_k() { return BKV; }
int flash_attention_max_d() { return MAX_D; }

// out (bh, sq, d) from q (bh, sq, d) and k, v (bh / group, sk, d), all
// row-major and contiguous, on kernel `path`: 0 the f32 kernel, 1 the bf16
// mma.sync kernel, 2 the bf16 wgmma kernel (d % 8 == 0, q, k and v
// 16-byte aligned).  1 <= d <= MAX_D, sk >= 1, bh % group == 0, the query
// tiles <= 65535; the wrapper checks them.  Returns 0 on success, else a
// cudaError_t (from building a tensor map or from the launch).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int bh, int sq, int sk, int d, int group,
                           int causal, float scale, int path, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (path == 2)
    return launch_wgmma_at(q, k, v, out, bh, sq, sk, d, group, causal, scale,
                           s);
  const dim3 grid(bh, (sq + BQ - 1) / BQ);
  // the 16-wide steps over d, rounded to a power of two
  const int steps = d <= 16 ? 1 : d <= 32 ? 2 : d <= 64 ? 4 : 8;
  if (path == 1 && steps == 1)
    return launch_bf16<1>(q, k, v, out, grid, sq, sk, d, group, causal, scale,
                          s);
  if (path == 1 && steps == 2)
    return launch_bf16<2>(q, k, v, out, grid, sq, sk, d, group, causal, scale,
                          s);
  if (path == 1 && steps == 4)
    return launch_bf16<4>(q, k, v, out, grid, sq, sk, d, group, causal, scale,
                          s);
  if (path == 1)
    return launch_bf16<8>(q, k, v, out, grid, sq, sk, d, group, causal, scale,
                          s);
  if (steps == 1)
    return launch_f32<1>(q, k, v, out, grid, sq, sk, d, group, causal, scale,
                         s);
  if (steps == 2)
    return launch_f32<2>(q, k, v, out, grid, sq, sk, d, group, causal, scale,
                         s);
  if (steps == 4)
    return launch_f32<4>(q, k, v, out, grid, sq, sk, d, group, causal, scale,
                         s);
  return launch_f32<8>(q, k, v, out, grid, sq, sk, d, group, causal, scale, s);
}

}  // extern "C"
