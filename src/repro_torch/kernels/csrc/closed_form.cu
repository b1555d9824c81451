// The closed form on the card (kernels/closed_form.py, called by
// core/fleetsim.py:_scan_replay): one CUDA thread a lane walks every row of
// its table in registers.
//
// It replaces no TPU kernel: the JAX package leaves its deterministic row
// scan to XLA, which fuses it.  A deterministic replay delivers exactly cap
// every charge, so a row's reboots collapse to the hoisted design's
// fast_forward applied to a fresh row (charge_replay.cuh), and BURN/CALIB
// rows burn whole nominal charges.  fleetsim._scan_step (stochastic=False)
// is the plain version: the kernel walks every row of the table, padding
// included, with the same float operations in the same order, so the two
// give the same bits (build with --fmad=false).  Where _scan_step computes
// fast_forward on every lane and then overrides BURN and CALIB rows, this
// kernel branches on the row's kind: the override keeps nothing of
// fast_forward's on a BURN row, and on a CALIB row only the chg of a lane
// that burns nothing, which no output of the closed form reads (chg feeds
// the stochastic path's belief update alone).
//
// What bounds it on an H100: each lane's rows run in series, a chain of
// dependent f64 operations a row, and a fleet of 8,192 or 16,384 lanes is
// one or two warps a scheduler, so the latency of that chain, not the f64
// rate (some 94 operations a lane and row) or the memory, sets the time;
// twice the lanes take the same time.  The design shortens the chain:
//
// * A row that finishes in the charge it starts in, the common case, takes
//   fast_forward's finishing branch written out here (the same operations
//   on the values it keeps), so it computes none of the failing branch's
//   two divisions; a lane whose row fails takes fast_forward itself.
// * Every lane is at the same row at the same step.  With one table for all
//   lanes (a fleet sweep) a block stages the next tile of rows in shared
//   memory with cp.async while it runs the current one, and every lane
//   reads a row as a broadcast from there: 35 % faster than reading it
//   through L1, where a prefetch of the rows a few steps ahead was 8-10 %
//   slower (PERF.md).  Per-lane tables (replay_plans) and a pack of plans
//   read by plan index (a PlanSet) are read row-major from global memory.

#include "charge_replay.cuh"

#define TILE_ROWS 16        // rows of a staged tile, at most
#define TILE_DOUBLES 3072   // doubles of one of the two tile buffers (24 KB)

namespace closed {

using direct::State;
using hoisted::Ctx;

enum { MODE_SHARED, MODE_LANE, MODE_PLAN };

// One row of _scan_step(stochastic=False) on one lane, the row row-major at
// `row`.
template <bool PARAM, bool SEND>
__device__ __forceinline__ void closed_row(const double* row,
                                           const Layout& L, bool adaptive,
                                           double cap, double theta,
                                           double conf, const double* radio,
                                           const double* tcum, int r_trace,
                                           double tail, State& st) {
  Prof pf;
  const Ctx x = hoisted::row_ctx<PARAM, SEND>(row, 1, L, adaptive, cap, theta,
                                              conf, radio);

  // decision 5: a SEND row waking into a closed window sleeps
  double send_wait = 0.0;
  bool defer_now = false, is_send = false;
  if (SEND) {
    is_send = x.kind == KIND_SEND;
    if (is_send && (x.send_bytes > 0.0) && !x.row_stuck) {
      double period = radio[R_PERIOD];
      double t = st.live / radio[R_CLK] + st.dead;
      double ps = jmax(period, 1e-30);
      double phase = t - fabs(floor(t / ps) * ps);
      defer_now = (period > 0.0) && (phase >= radio[R_DUTY] * period);
      send_wait = defer_now ? period - phase : 0.0;
    }
  }

  const double r0 = st.reboots;
  if (x.kind == KIND_BURN) {
    // a failed calibration attempt drains the whole buffer
    double r = st.rem;
    st.rem = cap;
    st.bel = st.bhat;
    st.live = st.live + r;
    st.reboots = st.reboots + 1.0;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      st.classes[c] = st.classes[c] + (c == L.burn_idx ? 0.0 + r : 0.0);
    st.chg = 0.0;
  } else if (PARAM && x.kind == KIND_CALIB) {
    // per-lane burn count from the capacitor (Sec. 7.1)
    double burns = (double)x.k;
    double calib_live = burns > 0.0 ? st.rem + (burns - 1.0) * cap : 0.0;
    st.rem = burns > 0.0 ? cap : st.rem;
    st.bel = burns > 0.0 ? st.bhat : st.bel;
    st.live = st.live + calib_live;
    st.reboots = st.reboots + burns;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      st.classes[c] =
          st.classes[c] + (c == L.burn_idx ? 0.0 + calib_live : 0.0);
    if (burns > 0.0) st.chg = 0.0;
  } else {
    // fast_forward on a fresh row (left = n); its finishing branch here
    bool batch0 = false;
    if (adaptive) {
      bool lvl0 = isinf(cap) ? true : (st.bel >= theta * st.bhat);
      batch0 = x.has_iters && (x.cc > 0.0) && lvl0;
    }
    double e0 = batch0 ? x.e + x.cc : x.e;
    double c0 = batch0 ? x.c - x.cc : x.c;
    double needed = e0 + x.n * c0;
    if (st.rem >= needed) {
      const hoisted::ForwardTerms t = {batch0, x.n, batch0 ? 1.0 : 0.0};
      hoisted::forward_classes<hoisted::FF_OK, SEND>(x, L, t, st);
      double new_rem = st.rem - needed;
      st.rem = new_rem;
      st.bel = new_rem;
      st.live = st.live + needed;
      st.reboots = st.reboots + 0.0;
      st.chg = st.chg + needed;
    } else {
      st.left = x.n;
      hoisted::fast_forward<SEND>(x, L, adaptive, cap, theta, st, pf);
    }
  }

  // decision 3: per-reboot dead time, the window wait added first
  st.dead = (st.dead + send_wait) +
            trace_window(tcum, r_trace, r0, st.reboots, tail);
  if (SEND) {
    bool adv_tx = is_send && !x.row_stuck;
    st.tx = st.tx + (adv_tx ? x.send_bytes : 0.0);
    st.sent = st.sent + ((adv_tx && (x.send_bytes > 0.0)) ? 1.0 : 0.0);
    st.deferred = st.deferred + (defer_now ? 1.0 : 0.0);
  }
}

// Stage `n` doubles from `src` into shared memory at `dst`, 8 bytes a
// cp.async, the block's threads in turn; one commit group.
__device__ __forceinline__ void stage_tile(double* dst, const double* src,
                                           int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    unsigned s = (unsigned)__cvta_generic_to_shared(dst + j);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(s),
                 "l"(src + j));
  }
  asm volatile("cp.async.commit_group;");
}

// One thread a lane.  MODE_SHARED: one row-major (S, F) table for every
// lane, staged `tile_rows` rows at a time into two buffers of dynamic
// shared memory (2 * tile_rows * F doubles), every thread of the block
// staging, a lane past the fleet's end too.  MODE_LANE: lane l's table at
// rows + l * lane_stride; MODE_PLAN: at rows + plan_idx[l] * lane_stride.
template <bool PARAM, bool SEND, int MODE>
__global__ void __launch_bounds__(LANE_MAX_BLOCK, 1) closed_form_kernel(
    const double* __restrict__ rows, long long lane_stride, int n_rows,
    int tile_rows, const int* __restrict__ plan_idx, Layout L,
    int adaptive_i, const double* __restrict__ caps,
    const double* __restrict__ rem0, const double* __restrict__ trace_cum,
    int r_trace, const double* __restrict__ tail_s, double theta,
    const double* __restrict__ confs, const double* __restrict__ radio,
    double* live_o, double* reboots_o, double* dead_o, double* classes_o,
    double* wasted_o, unsigned char* stuck_o, double* rem_o,
    double* belief_o, double* tx_o, double* sent_o, double* deferred_o,
    int n_lanes) {
  extern __shared__ double tiles[];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = lane < n_lanes;
  if (MODE != MODE_SHARED && !active) return;
  const int l = active ? lane : 0;
  const bool adaptive = adaptive_i != 0;
  const double cap = caps[l];
  const double tail = tail_s[l];
  const double conf = confs[l];
  const double* tcum = trace_cum + (long long)l * r_trace;

  // the carry _scan_step changes; pend, pend_class, pend_rows and wasted
  // stay as _scan_state0 made them, and bhat is cap
  State st;
  st.stuck = false;
  st.dead = st.live = st.reboots = st.chg = st.left = 0.0;
  st.tx = st.sent = st.deferred = 0.0;
  st.rem = st.bel = rem0[l];
  st.bhat = cap + 0.0;
#pragma unroll
  for (int c = 0; c < NC; ++c) st.classes[c] = 0.0;

  if (MODE == MODE_SHARED) {
    const int F = L.F;
    const int n_tiles = (n_rows + tile_rows - 1) / tile_rows;
    if (n_tiles > 0) stage_tile(tiles, rows, min(tile_rows, n_rows) * F);
    for (int t = 0; t < n_tiles; ++t) {
      // tile t has landed, and every lane is done with tile t - 1, whose
      // buffer tile t + 1 takes
      asm volatile("cp.async.wait_group 0;" ::: "memory");
      __syncthreads();
      const int i0 = t * tile_rows;
      if (t + 1 < n_tiles)
        stage_tile(tiles + ((t + 1) & 1) * tile_rows * F,
                   rows + (long long)(i0 + tile_rows) * F,
                   min(tile_rows, n_rows - i0 - tile_rows) * F);
      const double* tile = tiles + (t & 1) * tile_rows * F;
      const int n = min(tile_rows, n_rows - i0);
      if (active)
        for (int i = 0; i < n; ++i)
          closed_row<PARAM, SEND>(tile + i * F, L, adaptive, cap, theta,
                                  conf, radio, tcum, r_trace, tail, st);
    }
    if (!active) return;
  } else {
    const double* lane_rows =
        rows + (long long)(MODE == MODE_PLAN ? plan_idx[lane] : lane) *
                   lane_stride;
    for (int i = 0; i < n_rows; ++i)
      closed_row<PARAM, SEND>(lane_rows + (long long)i * L.F, L, adaptive,
                              cap, theta, conf, radio, tcum, r_trace, tail,
                              st);
  }

  live_o[lane] = st.live;
  reboots_o[lane] = st.reboots;
  dead_o[lane] = st.dead;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    classes_o[(long long)lane * NC + c] = st.classes[c];
  wasted_o[lane] = 0.0;
  stuck_o[lane] = st.stuck ? 1 : 0;
  rem_o[lane] = st.rem;
  belief_o[lane] = st.bhat;
  tx_o[lane] = st.tx;
  sent_o[lane] = st.sent;
  deferred_o[lane] = st.deferred;
}

}  // namespace closed

extern "C" {

int closed_form_n_classes() { return NC; }

// closed_form_kernel<parametric, has_send, mode> on `stream`, `block` lanes
// a block (1 to LANE_MAX_BLOCK), over `n_rows` rows of a row-major table:
// one table for every lane where lane_stride is 0, else lane l's at rows +
// l * lane_stride, or at rows + plan_idx[l] * lane_stride where plan_idx is
// not null.  `layout` is 21 ints in Layout's order, its F the row stride.
// Returns cudaErrorInvalidValue for a block out of range or a shared row
// wider than a tile buffer, else cudaGetLastError() after the launch.
int closed_form_launch(
    const double* rows, long long lane_stride, int n_rows,
    const int* plan_idx, const int* layout, const double* caps,
    const double* rem0, const double* trace_cum, int r_trace,
    const double* tail_s, double theta, const double* conf,
    const double* radio, int adaptive, int parametric, int has_send,
    double* live, double* reboots, double* dead, double* classes,
    double* wasted, unsigned char* stuck, double* rem, double* belief,
    double* tx_bytes, double* msgs_sent, double* msgs_deferred, int n_lanes,
    int block, void* stream) {
  Layout L;
  int* dst = &L.kind;
  for (int j = 0; j < (int)(sizeof(Layout) / sizeof(int)); ++j)
    dst[j] = layout[j];
  if (block < 1 || block > LANE_MAX_BLOCK)
    return (int)cudaErrorInvalidValue;
  const int mode = plan_idx ? closed::MODE_PLAN
                            : (lane_stride ? closed::MODE_LANE
                                           : closed::MODE_SHARED);
  int tile_rows = 0;
  if (mode == closed::MODE_SHARED) {
    tile_rows = L.F > 0 ? TILE_DOUBLES / L.F : 0;
    if (tile_rows > TILE_ROWS) tile_rows = TILE_ROWS;
    if (tile_rows < 1) return (int)cudaErrorInvalidValue;
  }
  if (n_lanes <= 0) return 0;
  using Kernel = decltype(&closed::closed_form_kernel<false, false, 0>);
  static const Kernel kernels[3][4] = {
      {&closed::closed_form_kernel<false, false, closed::MODE_SHARED>,
       &closed::closed_form_kernel<false, true, closed::MODE_SHARED>,
       &closed::closed_form_kernel<true, false, closed::MODE_SHARED>,
       &closed::closed_form_kernel<true, true, closed::MODE_SHARED>},
      {&closed::closed_form_kernel<false, false, closed::MODE_LANE>,
       &closed::closed_form_kernel<false, true, closed::MODE_LANE>,
       &closed::closed_form_kernel<true, false, closed::MODE_LANE>,
       &closed::closed_form_kernel<true, true, closed::MODE_LANE>},
      {&closed::closed_form_kernel<false, false, closed::MODE_PLAN>,
       &closed::closed_form_kernel<false, true, closed::MODE_PLAN>,
       &closed::closed_form_kernel<true, false, closed::MODE_PLAN>,
       &closed::closed_form_kernel<true, true, closed::MODE_PLAN>}};
  const int k = 2 * (parametric != 0) + (has_send != 0);
  const int grid = (n_lanes + block - 1) / block;
  const size_t smem = (size_t)2 * tile_rows * L.F * sizeof(double);
  kernels[mode][k]<<<grid, block, smem, (cudaStream_t)stream>>>(
      rows, lane_stride, n_rows, tile_rows, plan_idx, L, adaptive, caps,
      rem0, trace_cum, r_trace, tail_s, theta, conf, radio, live, reboots,
      dead, classes, wasted, stuck, rem, belief, tx_bytes, msgs_sent,
      msgs_deferred, n_lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
