// The lane state and row arithmetic shared by the lane kernel
// (charge_replay.cu) and the closed form (closed_form.cu): the row
// layout, the NaN-propagating helpers, the profile build's hooks,
// trace_window, the lane's State, and the hoisted design's row_ctx and
// fast_forward.  Every float operation rounds once, in the reference's
// order: build every includer with --fmad=false.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define NC 17  // op classes (core/energy.OP_CLASSES)
#define LANE_MAX_BLOCK 256  // lanes a block of the hoisted design, at most

// Packed radio vector slots (runtime/radio.py R_*).
#define R_WAKEUP 0
#define R_CPB 1
#define R_HDR 2
#define R_CLASS 3
#define R_TOPK 4
#define R_CONF_HI 5
#define R_CONF_LO 6
#define R_PERIOD 7
#define R_DUTY 8
#define R_CLK 9

#define KIND_WORK 0
#define KIND_BURN 1
#define KIND_CALIB 2
#define KIND_SEND 3

// Column offsets of each plan field in one packed row (-1: absent), the
// row width F, the charge-segment width G, the tile-candidate count K, and
// the op-class slots the replay books to.
struct Layout {
  int kind, n, iter_cycles, entry_cycles, iter_class, entry_class,
      commit_cycles, commit_class, seg_class, seg_cycles, tile_flag, tile_n,
      tile_iter_cycles, tile_iter_class, tile_sel_cost;
  int F, G, K;
  int control_idx, burn_idx, radio_idx;
};

struct Flags {
  int adaptive, parametric, enable_fast, has_burn, has_send;
};

__device__ __forceinline__ double jmax(double a, double b) {
  if (isnan(a) || isnan(b)) return a + b;
  return a > b ? a : b;
}

__device__ __forceinline__ double jmin(double a, double b) {
  if (isnan(a) || isnan(b)) return a + b;
  return a < b ? a : b;
}

__device__ __forceinline__ double jclip(double x, double lo, double hi) {
  return jmin(jmax(x, lo), hi);
}

// The profile build (-DREPLAY_PROFILE, tools/profile_replay.py): clock64()
// laps per region, event counts, and each warp's active lanes where a
// region starts, kept in registers and added to prof_acc once a lane ends.
// In the normal build every hook is empty and compiles to nothing.
enum { P_CTX, P_HEAD, P_CHARGE, P_FAST, P_BURN, P_TAIL, P_CO_SCALAR,
       P_CO_CLASS, P_REGIONS };
enum { C_EVENTS, C_CHARGE, C_FAST, C_BURN, C_TORN, C_COUNTS };
enum { W_LOOP, W_CHARGE, W_FAST, W_TORN, W_SITES };
#define PROF_SLOTS 64
#define PROF_SMS 256

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  return g;
}

#ifdef REPLAY_PROFILE
__device__ unsigned long long prof_acc[PROF_SLOTS];
__device__ unsigned int prof_sm[PROF_SMS];  // blocks that ran on each SM
struct Prof {
  long long t0, t, cyc[P_REGIONS];
  unsigned long long g0;
  unsigned long long cnt[C_COUNTS], wexec[W_SITES], wlanes[W_SITES];
  __device__ void start() {
    if (threadIdx.x == 0) {
      unsigned sm;
      asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
      atomicAdd(&prof_sm[sm % PROF_SMS], 1u);
    }
    g0 = globaltimer();
    t0 = t = clock64();
    for (int r = 0; r < P_REGIONS; ++r) cyc[r] = 0;
    for (int c = 0; c < C_COUNTS; ++c) cnt[c] = 0;
    for (int w = 0; w < W_SITES; ++w) wexec[w] = wlanes[w] = 0;
  }
  __device__ void lap(int r) {
    long long n = clock64();
    cyc[r] += n - t;
    t = n;
  }
  __device__ void count(int c) { cnt[c] += 1; }
  __device__ void warp(int w) {
    unsigned a = __activemask();
    if ((int)(threadIdx.x & 31) == __ffs(a) - 1) {
      wexec[w] += 1;
      wlanes[w] += __popc(a);
    }
  }
  // slots: 0 lanes, 1 total cycles, 2 max total cycles, 3.. regions,
  // 12 total globaltimer ns, 16.. counts, 32.. warp executions, 48.. warp
  // lanes
  __device__ void flush() {
    unsigned long long total = (unsigned long long)(clock64() - t0);
    atomicAdd(&prof_acc[12], globaltimer() - g0);
    atomicAdd(&prof_acc[0], 1ull);
    atomicAdd(&prof_acc[1], total);
    atomicMax(&prof_acc[2], total);
    for (int r = 0; r < P_REGIONS; ++r)
      atomicAdd(&prof_acc[3 + r], (unsigned long long)cyc[r]);
    for (int c = 0; c < C_COUNTS; ++c) atomicAdd(&prof_acc[16 + c], cnt[c]);
    for (int w = 0; w < W_SITES; ++w) {
      atomicAdd(&prof_acc[32 + w], wexec[w]);
      atomicAdd(&prof_acc[48 + w], wlanes[w]);
    }
  }
};
#else
struct Prof {
  __device__ void start() {}
  __device__ void lap(int) {}
  __device__ void count(int) {}
  __device__ void warp(int) {}
  __device__ void flush() {}
};
#endif

// Windowed sum of a cumulative trace over reboots (r0, r1], `fallback` per
// entry past its end.
__device__ double trace_window(const double* cum, int r, double r0,
                               double r1, double fallback) {
  double last = (double)(r - 1);
  int i0 = (int)jclip(r0, 0.0, last);
  int i1 = (int)jclip(r1, 0.0, last);
  double over = jmax(r1 - last, 0.0) - jmax(r0 - last, 0.0);
  return cum[i1] - cum[i0] + over * fallback;
}

// The lane state (charge_once and fast_forward in the reference carry
// it; the closed form uses the fields fast_forward changes).
namespace direct {

struct State {
  int i;
  bool fresh, stuck;
  double row_r0, dead, rem, bel, left, live, reboots, wasted, pend,
      pend_rows, bhat, chg, debt, tx, sent, deferred;
  double classes[NC], pend_class[NC], debt_class[NC];
};

}  // namespace direct

// The hoisted design's row context and closed-form completion of a row
// (the rest of the design is in charge_replay.cu).
namespace hoisted {

using direct::State;

// A column run of a row: `n` values `s` doubles apart.  The shared plan's
// table is laid out column-major (s = S rows), a lane's own table
// row-major (s = 1).
struct Vec {
  const double* p;
  int s;
  __device__ __forceinline__ double operator[](int j) const {
    return p[j * s];
  }
};

// The direct design's Ctx, with its vectors read through a stride.
struct Ctx {
  int kind, k;
  double n, c, e, cc;
  Vec iter_class, entry_class, commit_class, seg_class, seg_cycles;
  bool send_row;
  double cost;
  int radio_idx;
  double er, cr, crs, afford_nom, send_bytes;
  bool batchr, row_stuck, has_iters;

  __device__ __forceinline__ double ivr(int c) const {
    return batchr ? iter_class[c] - commit_class[c] : iter_class[c];
  }
};

// Ctx::ec and Ctx::seg with has_send known at compile time.  The plan's
// value is loaded whatever the row (every row has one), so that no load
// waits behind a branch.
template <bool SEND>
__device__ __forceinline__ double ec(const Ctx& x, int c) {
  const double v = x.entry_class[c];
  if (SEND) return x.send_row ? (c == x.radio_idx ? x.cost : 0.0) : v;
  return v;
}
template <bool SEND>
__device__ __forceinline__ double seg(const Ctx& x, int g) {
  const double v = x.seg_cycles[g];
  if (SEND) return x.send_row ? (g == 0 ? x.cost : 0.0) : v;
  return v;
}

// Class c's share of a torn entry prefix of `p` cycles: the amounts of the
// segments of class c added to 0.0 in segment order, which are exactly the
// additions torn_prefix makes to out[c] -- with no array indexed at run
// time, so nothing goes to local memory.
template <bool SEND>
__device__ __forceinline__ double torn_class(const Ctx& x, const Layout& L,
                                             double p, int c) {
  double out = 0.0, cum = 0.0;
  for (int g = 0; g < L.G; ++g) {
    double s = seg<SEND>(x, g);
    cum = cum + s;
    double start = cum - s;
    double amt = jmin(jmax(p - start, 0.0), s);
    if ((int)x.seg_class[g] == c) out = out + amt;
  }
  return out;
}

// row_ctx of the direct design, with parametric and has_send known at
// compile time.  Column j of the row is row[j * cs].
template <bool PARAM, bool SEND>
__device__ __forceinline__ Ctx row_ctx(const double* row, int cs,
                                       const Layout& L, bool adaptive,
                                       double cap, double theta, double conf,
                                       const double* radio) {
  const Vec r = {row, cs};
  Ctx x;
  x.kind = (int)r[L.kind];
  x.k = 0;
  x.n = r[L.n];
  x.c = r[L.iter_cycles];
  x.iter_class = {row + (long long)L.iter_class * cs, cs};
  if (PARAM) {
    int cnt = 0;
    for (int j = 0; j < L.K; ++j) cnt += (r[L.tile_sel_cost + j] > cap);
    x.k = cnt < 0 ? 0 : (cnt > L.K - 1 ? L.K - 1 : cnt);
    if (r[L.tile_flag] > 0.0) {
      x.n = r[L.tile_n + x.k];
      x.c = r[L.tile_iter_cycles + x.k];
      x.iter_class = {row + (long long)(L.tile_iter_class + x.k * NC) * cs,
                      cs};
    }
  }
  x.e = r[L.entry_cycles];
  x.cc = r[L.commit_cycles];
  x.entry_class = {row + (long long)L.entry_class * cs, cs};
  x.commit_class = {row + (long long)L.commit_class * cs, cs};
  x.seg_class = {row + (long long)L.seg_class * cs, cs};
  x.seg_cycles = {row + (long long)L.seg_cycles * cs, cs};
  x.radio_idx = L.radio_idx;
  x.send_row = false;
  x.cost = 0.0;
  x.send_bytes = 0.0;
  if (SEND && x.kind == KIND_SEND) {
    x.send_bytes = conf >= radio[R_CONF_HI]
                       ? radio[R_HDR] + radio[R_CLASS]
                       : (conf >= radio[R_CONF_LO]
                              ? radio[R_HDR] + radio[R_TOPK] : 0.0);
    x.cost = x.send_bytes > 0.0
                 ? radio[R_WAKEUP] + x.send_bytes * radio[R_CPB] : 0.0;
    x.e = x.cost;
    x.send_row = true;
  }
  x.has_iters = x.n > 0.0;
  x.batchr = adaptive ? (x.has_iters && (x.cc > 0.0) && (theta <= 1.0))
                      : false;
  x.er = x.batchr ? x.e + x.cc : x.e;
  x.cr = x.batchr ? x.c - x.cc : x.c;
  x.crs = jmax(x.cr, 1e-30);
  x.afford_nom = floor((cap - x.er) / x.crs);
  x.row_stuck = x.has_iters ? (x.afford_nom < 1.0) : (x.e > cap);
  return x;
}

// Which branch of fast_forward's class loop a lane takes: the row finishes
// on this charge, or it fails having entered, or it fails torn.
enum { FF_OK, FF_ENTERED, FF_TORN };

struct ForwardTerms {
  bool batch0;
  double left, ok_commits, entries, afford0, rem_iters, fail_commits,
      residue, rem;
};

// The class loop of the direct design's fast_forward for one case.
template <int CASE, bool SEND>
__device__ __forceinline__ void forward_classes(const Ctx& x,
                                                const Layout& L,
                                                const ForwardTerms& t,
                                                State& s) {
  const int CTRL = L.control_idx;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    double cc_c = x.commit_class[c];
    double iv0 = t.batch0 ? x.iter_class[c] - cc_c : x.iter_class[c];
    double add;
    if (CASE == FF_OK) {
      add = (ec<SEND>(x, c) + t.left * iv0) + t.ok_commits * cc_c;
    } else {
      add = t.entries * ec<SEND>(x, c) + t.afford0 * iv0 +
            t.rem_iters * x.ivr(c) + t.fail_commits * cc_c;
      add = add + (CASE == FF_ENTERED ? 0.0
                                      : torn_class<SEND>(x, L, t.rem, c));
      if (c == CTRL) add = add + t.residue;
    }
    s.classes[c] = s.classes[c] + add;
  }
}

// fast_forward of the direct design: the same scalar arithmetic, then the
// class loop of the lane's case.
template <bool SEND>
__device__ __forceinline__ void fast_forward(const Ctx& x, const Layout& L,
                                             bool adaptive, double cap,
                                             double theta, State& s,
                                             Prof& pf) {
  double rem = s.rem, left = s.left;
  bool batch0 = false;
  if (adaptive) {
    bool lvl0 = isinf(cap) ? true : (s.bel >= theta * s.bhat);
    batch0 = x.has_iters && (x.cc > 0.0) && lvl0;
  }
  double e0 = batch0 ? x.e + x.cc : x.e;
  double c0 = batch0 ? x.c - x.cc : x.c;
  double c0s = jmax(c0, 1e-30);
  double needed = e0 + left * c0;
  bool ok = rem >= needed;

  bool entered = rem >= x.e;
  double afford0 = jclip(entered ? floor((rem - e0) / c0s) : 0.0, 0.0, left);
  double rem_iters = left - afford0;
  double afford_full = jmax(x.afford_nom, 1.0);
  double visits =
      x.has_iters ? jmax(ceil(rem_iters / afford_full), 1.0) : 1.0;
  double n_last =
      x.has_iters ? rem_iters - (visits - 1.0) * afford_full : 0.0;
  double fail_live = rem + (visits - 1.0) * cap + x.er + n_last * x.cr;
  double fail_rem = cap - x.er - n_last * x.cr;
  double entries = visits + (entered ? 1.0 : 0.0);
  double ok_commits = batch0 ? 1.0 : 0.0;
  double fail_commits = (x.batchr ? visits : 0.0) +
                        ((batch0 && (afford0 > 0.0)) ? 1.0 : 0.0);
  double residue = fail_live - entries * x.e - afford0 * c0 -
                   rem_iters * x.cr - fail_commits * x.cc -
                   (entered ? 0.0 : rem);

  const ForwardTerms t = {batch0,    left,         ok_commits,
                          entries,   afford0,      rem_iters,
                          fail_commits, residue,   rem};
  if (ok) {
    forward_classes<FF_OK, SEND>(x, L, t, s);
  } else if (entered) {
    forward_classes<FF_ENTERED, SEND>(x, L, t, s);
  } else {
    pf.warp(W_TORN);
    pf.count(C_TORN);
    forward_classes<FF_TORN, SEND>(x, L, t, s);
  }
  double new_rem = ok ? rem - needed : fail_rem;
  s.rem = new_rem;
  s.bel = new_rem;
  s.left = 0.0;
  s.live = s.live + (ok ? needed : fail_live);
  s.reboots = s.reboots + (ok ? 0.0 : visits);
  s.chg = ok ? s.chg + needed : x.er + n_last * x.cr;
  s.stuck = s.stuck || (!ok && x.row_stuck);
}

}  // namespace hoisted
