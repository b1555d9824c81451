// The fleet replay's streamed statistics fold: a replay chunk's per-lane
// outputs folded into per-group partials (count, completed, per-op-class
// cycle sums, and per output channel sum, sum of squares, min, max and a
// fixed-bin histogram).
//
// Replaces: src/repro/core/fleetstats.py:143 reduce_lane_outputs, an XLA
// function (scatter-adds in lane order) with no Pallas kernel.
//
// The rule this kernel keeps: every f64 sum is added in lane order, so the
// result is bitwise equal to the numpy oracle stats_from_outputs (whose
// np.bincount adds in lane order) and to the plain PyTorch version
// (kernels/stats_fold.py: a CPU cumsum, also in lane order).  So a sum
// cannot be split over threads: one thread owns one (group, column) pair
// and walks the chunk's lanes in order.  There are no float atomics
// anywhere in this file.  Min and max follow numpy's minimum.at /
// maximum.at lane by lane (a tie takes the later lane's value, the first
// NaN stays); the histogram counts are integers, added with 32-bit integer
// atomics (first into a block's copy in shared memory) and turned into f64
// afterwards.
// Built with --fmad=false: total_s = live / clock + dead and v * v round
// once per operation, as numpy rounds them.
//
// What bounds it on an H100: the lane-order chain, one dependent f64 add a
// lane per column (about 8 cycles each), not the bytes (about 200 bytes a
// lane read once).  The columns run side by side, one thread each, so a
// chunk costs about one chain plus what a lane's step adds to it; with one
// owner warp on each scheduler, that step's own latency is not hidden.  So
// the owners of a block walk a tile of lanes in shared memory while its
// stager warps copy the next tile in with cp.async (double buffering); a
// warp's owners all do one kind of column (sums, mins or maxs) with no
// branch that splits the warp; a sum makes the next four lanes' addends
// ready while it adds the current four; a min or max folds four segments
// of a tile side by side (the fold is associative) and then in order.
// The first design read each lane's flags and value from device memory
// behind its branches: 47.7 ms a 65,536-lane chunk, 176 times the chain
// (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int NCH = 10;   // fleetstats.STAT_CHANNELS

// The per-lane outputs of one replay chunk, in STAT_CHANNELS' source
// order; classes is (n, nc) row-major.
struct Lanes {
  const double* live;
  const double* dead;
  const double* reboots;
  const double* wasted;
  const double* belief;
  const double* tx_bytes;
  const double* msgs_sent;
  const double* msgs_deferred;
  const double* classes;
  const unsigned char* stuck;
  const unsigned char* valid;
  const int* gid;
};

// Every channel's value of lane l, in STAT_CHANNELS' order, into
// v[0], v[stride], ...: computed as fleetstats.lane_channels computes it
// (total_s = live / clock + dead, tx_joules = radio cycles * joules).
__device__ __forceinline__ void lane_values(const Lanes& in, long long l,
                                            int nc, int radio,
                                            double clock_hz,
                                            double joules_per_cycle,
                                            double* v, int stride) {
  const double live = in.live[l], dead = in.dead[l];
  v[0 * stride] = live;
  v[1 * stride] = dead;
  v[2 * stride] = live / clock_hz + dead;
  v[3 * stride] = in.reboots[l];
  v[4 * stride] = in.wasted[l];
  v[5 * stride] = in.belief[l];
  v[6 * stride] = in.tx_bytes[l];
  v[7 * stride] = in.msgs_sent[l];
  v[8 * stride] = in.msgs_deferred[l];
  v[9 * stride] = in.classes[l * nc + radio] * joules_per_cycle;
}

// Where each channel's edges start in the flat edge array (NCH + 1
// offsets, the last the total), passed by value.
struct EdgeOff {
  int at[NCH + 1];
};

// c ? yes : no by the bits, so that no branch splits a warp.
__device__ __forceinline__ double choose(double yes, double no, bool c) {
  const long long m = -(long long)c;
  return __longlong_as_double((__double_as_longlong(yes) & m) |
                              (__double_as_longlong(no) & ~m));
}

// numpy's minimum (maximum) of x then y keeps x only when x < y (x > y);
// a tie, or a NaN y, takes y.
__device__ __forceinline__ bool keep_first(double x, double y, bool is_min) {
  return ((x < y) & is_min) | ((x > y) & !is_min);
}

// Histograms: one thread a lane (grid-stride), a bin a channel by binary
// search for searchsorted(edges, v, side="right") - 1 clipped to
// [0, bins - 1], counted with integer atomics in the block's shared copy
// (when it fits) and then added to `counts` (n_groups, hb).  Lanes that are
// padding, did not complete, or whose group is out of range add nothing.
__global__ void fold_hist_kernel(Lanes in, int n, int nc, int radio,
                                 double clock_hz, double joules_per_cycle,
                                 int n_groups, const double* __restrict__ edges,
                                 EdgeOff edge_off, int hb,
                                 unsigned int* counts, int shared_copy) {
  extern __shared__ unsigned int local[];
  const int total = n_groups * hb;
  unsigned int* dst = shared_copy ? local : counts;
  if (shared_copy) {
    for (int i = threadIdx.x; i < total; i += blockDim.x) local[i] = 0u;
    __syncthreads();
  }
  for (long long l = blockIdx.x * (long long)blockDim.x + threadIdx.x; l < n;
       l += (long long)gridDim.x * blockDim.x) {
    const int g = in.gid[l];
    if (g < 0 || g >= n_groups || !in.valid[l] || in.stuck[l]) continue;
    double v[NCH];
    lane_values(in, l, nc, radio, clock_hz, joules_per_cycle, v, 1);
#pragma unroll
    for (int ch = 0; ch < NCH; ++ch) {
      const int lo = edge_off.at[ch], ne = edge_off.at[ch + 1] - lo;
      // edges[lo + i] <= v for every i < a; a NaN sorts after every edge,
      // as numpy's searchsorted puts it
      int a = 0, b = ne;
      while (a < b) {
        const int m = (a + b) >> 1;
        if (edges[lo + m] <= v[ch] || v[ch] != v[ch]) a = m + 1; else b = m;
      }
      int bin = a - 1;
      bin = bin < 0 ? 0 : (bin > ne - 2 ? ne - 2 : bin);
      atomicAdd(&dst[g * hb + (lo - ch) + bin], 1u);
    }
  }
  if (shared_copy) {
    __syncthreads();
    for (int i = threadIdx.x; i < total; i += blockDim.x)
      if (local[i]) atomicAdd(&counts[i], local[i]);
  }
}

// The ordered pass's block: OWNERS threads that own columns (two groups'
// GROUP_SLOTS slots) and STAGERS threads that copy the next tile of lanes
// into shared memory while the owners walk the current one.
constexpr int TILE = 256;                 // lanes a tile
constexpr int OWNERS = 256;
constexpr int STAGERS = 128;
constexpr int FOLD_BLOCK = OWNERS + STAGERS;
constexpr int SEGS = 4;                   // min/max segments of a tile
constexpr int CPITCH = TILE + 2;          // a channel row: even, and rows
                                          // 0-7 on distinct bank pairs

// Owners are laid out a group at a time in GROUP_SLOTS slots: warps 0-1
// the summed columns (count, completed, the op classes, then each
// channel's sum and sum of squares: 2 + nc + 2 * NCH of them), warp 2 the
// channels' mins, warp 3 their maxs.  So every warp runs one kind of
// column, and a lane's step is one dependent add (or compare) that no
// branch splits.
constexpr int GROUP_SLOTS = 128;
enum { SUM_SLOTS = 64, MIN_SLOT0 = 64, MAX_SLOT0 = 96 };

// One tile's buffer in shared memory: the lanes' op-class cycles as they
// lie in device memory ([TILE][nc]), the NCH channel rows ([NCH][CPITCH]),
// each lane's group and flags (bit 1 valid, bit 2 valid and done).
__host__ __device__ constexpr int buffer_bytes(int nc) {
  return ((TILE * nc * 8 + 15) / 16) * 16 + NCH * CPITCH * 8 + TILE * 4 +
         TILE;
}
__host__ __device__ constexpr int stage_bytes(int nc) {
  return 2 * ((buffer_bytes(nc) + 15) / 16) * 16;
}

struct Buffer {
  double* cls;
  double* chan;
  int* gid;
  unsigned char* flag;
};

__device__ __forceinline__ Buffer buffer(unsigned char* base, int nc) {
  Buffer b;
  b.cls = reinterpret_cast<double*>(base);
  b.chan = reinterpret_cast<double*>(base + ((TILE * nc * 8 + 15) / 16) * 16);
  b.gid = reinterpret_cast<int*>(b.chan + NCH * CPITCH);
  b.flag = reinterpret_cast<unsigned char*>(b.gid + TILE);
  return b;
}

// The addends of lanes i .. i + 3 of a summed column: the lane's value
// (1.0 for count and completed), squared for a sum of squares, 0.0 where
// the lane is not the column's.
__device__ __forceinline__ void sum_terms(const Buffer& b, const double* vp,
                                          int vs, int i, int g,
                                          unsigned char need, bool ones,
                                          bool square, double* x) {
  const int4 gg = *reinterpret_cast<const int4*>(b.gid + i);
  const uchar4 ff = *reinterpret_cast<const uchar4*>(b.flag + i);
  const int gs[4] = {gg.x, gg.y, gg.z, gg.w};
  const unsigned char fs[4] = {ff.x, ff.y, ff.z, ff.w};
  double v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = vp[(i + u) * vs];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const double w = choose(1.0, v[u], ones);
    x[u] = choose(choose(w * w, w, square), 0.0,
                  (gs[u] == g) & ((fs[u] & need) != 0));
  }
}

__device__ __forceinline__ void copy_async(void* smem, const void* gmem,
                                           int bytes_8_or_4) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes_8_or_4 == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem));
}

// The stagers' share: lanes [base, base + m) into `b`.  The op-class span,
// the eight per-lane channel arrays and the groups are copied with
// cp.async; each lane's flags and its two derived channels (total_s =
// live / clock + dead, tx_joules = radio cycles * joules, as
// fleetstats.lane_channels computes them) once the copies have landed.
__device__ __forceinline__ void stage_tile(const Lanes& in, int base, int m,
                                           int nc, int radio, double clock_hz,
                                           double joules_per_cycle, Buffer b,
                                           int tid) {
  const double* span = in.classes + (long long)base * nc;
  for (int j = tid; j < m * nc; j += STAGERS)
    copy_async(b.cls + j, span + j, 8);
  const double* src[8] = {in.live, in.dead, in.reboots, in.wasted,
                          in.belief, in.tx_bytes, in.msgs_sent,
                          in.msgs_deferred};
  const int row[8] = {0, 1, 3, 4, 5, 6, 7, 8};   // STAT_CHANNELS rows
#pragma unroll
  for (int k = 0; k < 8; ++k)
    for (int i = tid; i < m; i += STAGERS)
      copy_async(b.chan + row[k] * CPITCH + i, src[k] + base + i, 8);
  for (int i = tid; i < m; i += STAGERS)
    copy_async(b.gid + i, in.gid + base + i, 4);
  asm volatile("cp.async.commit_group;\n" ::);
  unsigned char f[TILE / STAGERS];
#pragma unroll
  for (int u = 0; u < TILE / STAGERS; ++u) {
    const int i = tid + u * STAGERS;
    f[u] = 0;
    if (i < m) {
      const bool valid = in.valid[base + i] != 0;
      f[u] = (unsigned char)((valid ? 1 : 0) |
                             (valid && !in.stuck[base + i] ? 2 : 0));
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  asm volatile("bar.sync 1, %0;\n" ::"n"(STAGERS));   // the stagers' copies
#pragma unroll
  for (int u = 0; u < TILE / STAGERS; ++u) {
    const int i = tid + u * STAGERS;
    if (i < m) {
      b.flag[i] = f[u];
      b.chan[2 * CPITCH + i] = b.chan[i] / clock_hz + b.chan[CPITCH + i];
      b.chan[9 * CPITCH + i] = b.cls[i * nc + radio] * joules_per_cycle;
    }
  }
}

// The ordered pass.  Slot s of group g (owner thread g * GROUP_SLOTS + s
// of the owner blocks) owns one column of acc[g] (ncol = 2 + nc + 4 *
// NCH: count, completed, the op-class sums, then sum, sum of squares, min,
// max a channel).  While the stagers copy tile k + 1 into one buffer, the
// owners walk tile k's lanes in the other, in order, adding the lanes of
// their group that their column takes; one barrier a tile hands the
// buffers over.  Adding +0.0 for a lane not taken leaves a sum's bits as
// they are (a sum that starts at +0.0 is never -0.0).  Blocks past the
// owner blocks turn the histogram counts into f64.
__global__ void __launch_bounds__(FOLD_BLOCK)
    fold_ordered_kernel(Lanes in, int n, int nc, int radio, double clock_hz,
                        double joules_per_cycle, int n_groups, int ncol,
                        int owner_blocks, double* acc,
                        const unsigned int* __restrict__ counts,
                        double* hist, int hb) {
  extern __shared__ __align__(16) unsigned char smem[];
  if ((int)blockIdx.x >= owner_blocks) {  // a conversion block (uniform)
    const long long h =
        (long long)(blockIdx.x - owner_blocks) * blockDim.x + threadIdx.x;
    if (h < (long long)n_groups * hb) hist[h] = (double)counts[h];
    return;
  }
  // the two buffers' pointers are made from `smem` where they are used,
  // never kept in an array: in local memory they would turn every shared
  // load into a generic one
  const int half = ((buffer_bytes(nc) + 15) / 16) * 16;
  const bool stager = threadIdx.x >= OWNERS;
  const long long t = (long long)blockIdx.x * OWNERS + threadIdx.x;
  const int g = (int)(t / GROUP_SLOTS), slot = (int)(t % GROUP_SLOTS);
  int col = -1, row = -1, cls = -1;   // acc column; channel row; class
  bool square = false;
  unsigned char need = 2;
  if (!stager && g < n_groups) {
    if (slot < 2 + nc) {
      col = slot;
      need = slot == 0 ? 1 : 2;
      cls = slot >= 2 ? slot - 2 : -1;
    } else if (slot < 2 + nc + 2 * NCH) {
      const int k = slot - 2 - nc;
      col = 2 + nc + 4 * (k / 2) + k % 2;
      row = k / 2;
      square = k % 2 == 1;
    } else if (slot >= MIN_SLOT0 && slot < MIN_SLOT0 + NCH) {
      col = 2 + nc + 4 * (slot - MIN_SLOT0) + 2;
      row = slot - MIN_SLOT0;
    } else if (slot >= MAX_SLOT0 && slot < MAX_SLOT0 + NCH) {
      col = 2 + nc + 4 * (slot - MAX_SLOT0) + 3;
      row = slot - MAX_SLOT0;
    }
  }
  const int kind = slot < SUM_SLOTS ? 0 : (slot < MAX_SLOT0 ? 1 : 2);
  double a = kind == 1 ? __longlong_as_double(0x7ff0000000000000LL)
                       : (kind == 2 ? __longlong_as_double(0xfff0000000000000LL)
                                    : 0.0);
  bool seen_nan = false;          // min, max: a NaN met, and the first
  double nan_v = 0.0;
  const int tiles = (n + TILE - 1) / TILE;
  if (stager && tiles > 0)
    stage_tile(in, 0, n < TILE ? n : TILE, nc, radio, clock_hz,
               joules_per_cycle, buffer(smem, nc), threadIdx.x - OWNERS);
  __syncthreads();
  for (int k = 0; k < tiles; ++k) {
    const Buffer b = buffer(smem + (k & 1) * half, nc);
    const int m = n - k * TILE < TILE ? n - k * TILE : TILE;
    if (stager) {
      if (k + 1 < tiles) {
        const int nb = (k + 1) * TILE;
        stage_tile(in, nb, n - nb < TILE ? n - nb : TILE, nc, radio,
                   clock_hz, joules_per_cycle,
                   buffer(smem + ((k + 1) & 1) * half, nc),
                   threadIdx.x - OWNERS);
      }
    } else if (col >= 0) {
      // a column's values: a class's cycles (stride nc), a channel row
      // (stride 1), or 1.0 (count, completed)
      const double* vp = cls >= 0 ? b.cls + cls
                                  : b.chan + (row < 0 ? 0 : row) * CPITCH;
      const int vs = cls >= 0 ? nc : 1;
      const bool ones = cls < 0 && row < 0;
      int i = 0;
      if (kind == 0) {
        // four lanes' addends made ready (loads, masks, squares, all
        // without a branch) while the previous four are added
        double xc[4], xn[4];
        if (m >= 4) sum_terms(b, vp, vs, 0, g, need, ones, square, xc);
        for (; i + 8 <= m; i += 4) {
          sum_terms(b, vp, vs, i + 4, g, need, ones, square, xn);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            a = a + xc[u];
            xc[u] = xn[u];
          }
        }
        if (i + 4 <= m) {
#pragma unroll
          for (int u = 0; u < 4; ++u) a = a + xc[u];
          i += 4;
        }
        for (; i < m; ++i) {
          const double w = choose(1.0, vp[i * vs], ones);
          a = a + choose(choose(w * w, w, square), 0.0,
                         b.gid[i] == g && (b.flag[i] & need));
        }
      } else {
        // numpy's minimum.at / maximum.at: a = (a < v or a is NaN) ? a : v
        // (a tie takes the lane's value, so -0.0 after +0.0 gives -0.0),
        // the first NaN kept.  That fold is associative, so a full tile is
        // folded as SEGS contiguous segments side by side (independent
        // chains, a lane of each a step) and the segments then into `a` in
        // order: the last minimal lane of the tile is the last minimal lane
        // of its last segment that holds the minimum.  The NaN is tracked
        // apart; a lane not taken loses to every value (or ties with the
        // same bits).
        const bool is_min = kind == 1;
        const double lose = is_min ? __longlong_as_double(0x7ff0000000000000LL)
                                   : __longlong_as_double(0xfff0000000000000LL);
        if (m == TILE) {
          double sv[SEGS], snv[SEGS];
          bool sn[SEGS];
#pragma unroll
          for (int j = 0; j < SEGS; ++j) {
            sv[j] = lose;
            snv[j] = 0.0;
            sn[j] = false;
          }
          for (int l0 = 0; l0 < TILE / SEGS; ++l0) {
#pragma unroll
            for (int j = 0; j < SEGS; ++j) {
              const int l = j * (TILE / SEGS) + l0;
              const double v = vp[l];
              // & and |, not && and ||: no branch
              const bool take = (b.gid[l] == g) & ((b.flag[l] & 2) != 0);
              const bool first_nan = take & (v != v) & !sn[j];
              snv[j] = choose(v, snv[j], first_nan);
              sn[j] = sn[j] | first_nan;
              sv[j] = choose(sv[j], v, !take | keep_first(sv[j], v, is_min));
            }
          }
#pragma unroll
          for (int j = 0; j < SEGS; ++j) {
            nan_v = choose(snv[j], nan_v, sn[j] & !seen_nan);
            seen_nan = seen_nan | sn[j];
            a = choose(a, sv[j], keep_first(a, sv[j], is_min));
          }
          i = m;
        }
        for (; i < m; ++i) {
          const bool take = b.gid[i] == g && (b.flag[i] & 2);
          const double v = vp[i];
          const bool first_nan = take && v != v && !seen_nan;
          nan_v = first_nan ? v : nan_v;
          seen_nan = seen_nan || first_nan;
          a = (take && !keep_first(a, v, kind == 1)) ? v : a;
        }
      }
    }
    __syncthreads();
  }
  if (col >= 0) acc[(long long)g * ncol + col] = seen_nan ? nan_v : a;
}

}  // namespace

extern "C" {

int stats_fold_n_channels() { return NCH; }

// Fold n lanes into n_groups groups on `stream`.  `lanes` holds the 8
// channel pointers in STAT_CHANNELS' source order (live, dead, reboots,
// wasted, belief, tx_bytes, msgs_sent, msgs_deferred), then classes (n, nc)
// f64; stuck and valid are bool bytes, gid int32.  `edges` is every
// channel's edges back to back, `edge_off` where
// each starts (host, NCH + 1 ints, the last the total); hb is the total
// bins.  `counts` (n_groups * hb uint32) must
// be zero.  Writes acc (n_groups, ncol = 2 + nc + 4 * NCH) and hist
// (n_groups, hb).  Returns cudaGetLastError() after the two launches.
int stats_fold_launch(const double* const* lanes, const double* classes,
                      const unsigned char* stuck, const unsigned char* valid,
                      const int* gid, int n, int nc, int radio,
                      double clock_hz, double joules_per_cycle, int n_groups,
                      const double* edges, const int* edge_off, int hb,
                      unsigned int* counts, double* acc, double* hist,
                      void* stream) {
  if (n < 0 || nc < 1 || radio < 0 || radio >= nc || n_groups < 1 || hb < 1)
    return (int)cudaErrorInvalidValue;
  EdgeOff off;
  for (int ch = 0; ch <= NCH; ++ch) off.at[ch] = edge_off[ch];
  for (int ch = 0; ch < NCH; ++ch)
    if (off.at[ch + 1] - off.at[ch] < 2) return (int)cudaErrorInvalidValue;
  if (hb != off.at[NCH] - NCH) return (int)cudaErrorInvalidValue;
  Lanes in = {lanes[0], lanes[1], lanes[2], lanes[3], lanes[4], lanes[5],
              lanes[6], lanes[7], classes,  stuck,    valid,    gid};
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = (long long)n_groups * hb;
  const long long smem = total * (long long)sizeof(unsigned int);
  const int shared_copy = smem <= 48 * 1024;
  if (n > 0) {
    const int block = 256;
    int grid = (n + block - 1) / block;
    if (grid > 132 * 4) grid = 132 * 4;
    fold_hist_kernel<<<grid, block, shared_copy ? (size_t)smem : 0, s>>>(
        in, n, nc, radio, clock_hz, joules_per_cycle, n_groups, edges, off,
        hb, counts, shared_copy);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int ncol = 2 + nc + 4 * NCH;
  const int owner_blocks =
      (int)(((long long)n_groups * GROUP_SLOTS + OWNERS - 1) / OWNERS);
  const long long convert_blocks = (total + FOLD_BLOCK - 1) / FOLD_BLOCK;
  if (stage_bytes(nc) > 227 * 1024 || 2 + nc + 2 * NCH > SUM_SLOTS)
    return (int)cudaErrorInvalidValue;
  if (stage_bytes(nc) > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fold_ordered_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        stage_bytes(nc));
    if (err != cudaSuccess) return (int)err;
  }
  fold_ordered_kernel<<<(unsigned int)(owner_blocks + convert_blocks),
                        FOLD_BLOCK, stage_bytes(nc), s>>>(
      in, n, nc, radio, clock_hz, joules_per_cycle, n_groups, ncol,
      owner_blocks, acc, counts, hist, hb);
  return (int)cudaGetLastError();
}

}  // extern "C"
