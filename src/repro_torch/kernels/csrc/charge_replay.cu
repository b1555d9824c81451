// Fused stochastic charge replay: one CUDA thread per device lane.
//
// Replaces the TPU kernel src/repro/kernels/charge_replay.py:pallas_replay
// (body _lane_kernel), which runs the JAX event stream `event_replay` one
// lane per grid step.  This kernel computes exactly the same function: each
// thread walks its lane's plan as a stream of events (one charge of the
// current row, or the row's closed-form remainder once every later refill is
// nominal, or a whole BURN/CALIB row), with the uplink send/defer decision
// and the per-row dead-time gather, and writes the 11 output channels.
//
// Bit-for-bit agreement with the reference: every float operation rounds
// once, in the reference's order.  Build with --fmad=false (nvcc would
// otherwise contract a*b+c into an FMA) and without --use_fast_math.
// jnp.maximum/minimum/clip propagate NaN, CUDA's fmax/fmin do not, so the
// j* helpers below are used instead.  A lane with cap = inf (continuous
// power) goes through unchanged.  Where the reference computes both sides
// of a jnp.where and selects, this kernel branches and computes only the
// selected side with the same operations, which gives the same bits.
//
// What bounds it on an H100: per event, a few hundred scalar f64 operations
// (the 17-wide per-class vectors dominate) and one row stripe of F x 8 bytes
// (520 B for F = 65) read through L2; the row table is shared by every lane
// of a fleet sweep and fits in the 50 MB L2.  The per-lane state (about 20
// f64 scalars plus three 17-wide class vectors) lives in registers and local
// memory, and spills are expected.  This first design does nothing about
// either bound, on purpose: it is the simple, right version.  Lanes that
// finish early leave their warp's other threads running alone (divergence),
// and the five static flags are launch arguments rather than template
// parameters; both are later work.

#include <cuda_runtime.h>
#include <math.h>

#define NC 17  // op classes (core/energy.OP_CLASSES)

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

// State-independent per-row decisions (row_ctx in the reference).
struct Ctx {
  int kind, k;
  double n, c, e, cc;
  const double* iter_class;
  const double* entry_class;
  const double* commit_class;
  const double* seg_class;
  const double* seg_cycles;
  bool send_row;       // entry class/segments replaced by the send cost
  double cost;
  int radio_idx;
  double er, cr, crs, afford_nom, send_bytes;
  bool batchr, row_stuck, has_iters;

  __device__ double ec(int c) const {
    return send_row ? (c == radio_idx ? cost : 0.0) : entry_class[c];
  }
  __device__ double seg(int g) const {
    return send_row ? (g == 0 ? cost : 0.0) : seg_cycles[g];
  }
  __device__ double ivr(int c) const {
    return batchr ? iter_class[c] - commit_class[c] : iter_class[c];
  }
};

__device__ Ctx row_ctx(const double* row, const Layout& L, const Flags& fl,
                       double cap, double theta, double conf,
                       const double* radio) {
  Ctx x;
  x.kind = (int)row[L.kind];
  x.k = 0;
  x.n = row[L.n];
  x.c = row[L.iter_cycles];
  x.iter_class = row + L.iter_class;
  if (fl.parametric) {
    int cnt = 0;
    for (int j = 0; j < L.K; ++j) cnt += (row[L.tile_sel_cost + j] > cap);
    x.k = cnt < 0 ? 0 : (cnt > L.K - 1 ? L.K - 1 : cnt);
    if (row[L.tile_flag] > 0.0) {
      x.n = row[L.tile_n + x.k];
      x.c = row[L.tile_iter_cycles + x.k];
      x.iter_class = row + L.tile_iter_class + x.k * NC;
    }
  }
  x.e = row[L.entry_cycles];
  x.cc = row[L.commit_cycles];
  x.entry_class = row + L.entry_class;
  x.commit_class = row + L.commit_class;
  x.seg_class = row + L.seg_class;
  x.seg_cycles = row + L.seg_cycles;
  x.radio_idx = L.radio_idx;
  x.send_row = false;
  x.cost = 0.0;
  x.send_bytes = 0.0;
  if (fl.has_send && x.kind == KIND_SEND) {
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
  x.batchr = fl.adaptive ? (x.has_iters && (x.cc > 0.0) && (theta <= 1.0))
                         : false;
  x.er = x.batchr ? x.e + x.cc : x.e;
  x.cr = x.batchr ? x.c - x.cc : x.c;
  x.crs = jmax(x.cr, 1e-30);
  x.afford_nom = floor((cap - x.er) / x.crs);
  x.row_stuck = x.has_iters ? (x.afford_nom < 1.0) : (x.e > cap);
  return x;
}

// Charge-order attribution of a torn entry prefix of `p` cycles: each
// charge segment books clip(p - start, 0, len) to its own class, in order.
__device__ void torn_prefix(const Ctx& x, const Layout& L, double p,
                            double* out) {
  for (int c = 0; c < NC; ++c) out[c] = 0.0;
  double cum = 0.0;
  for (int g = 0; g < L.G; ++g) {
    double s = x.seg(g);
    cum = cum + s;
    double start = cum - s;
    double amt = jmin(jmax(p - start, 0.0), s);
    int cls = (int)x.seg_class[g];
    out[cls] = out[cls] + amt;
  }
}

struct State {
  int i;
  bool fresh, stuck;
  double row_r0, dead, rem, bel, left, live, reboots, wasted, pend,
      pend_rows, bhat, chg, debt, tx, sent, deferred;
  double classes[NC], pend_class[NC], debt_class[NC];
};

// Exactly one charge of the current row (charge_once in the reference).
// Returns whether the row finished or stuck.
__device__ bool charge_once(const Ctx& x, const Layout& L, const Flags& fl,
                            double cap, const double* ccum, int rc,
                            double theta, double window, double alpha,
                            State& s) {
  const int CTRL = L.control_idx;
  double a0 = s.rem, est0 = s.bel;

  // phase 0: multi-row rollback replay
  bool have_debt = s.debt > 0.0;
  double debt_s = jmax(s.debt, 1e-30);
  double want = have_debt ? jmin(s.debt, jmax(est0 - x.cc, 0.0)) : 0.0;
  bool dok = have_debt && (want > 0.0) && (a0 >= want + x.cc);
  bool dfail = have_debt && !dok;
  bool dpart = dok && ((s.debt - want) > 0.0);
  bool dend = dfail || dpart;
  double d_exec = dfail ? jmin(want, a0) : 0.0;
  double d_spend = dok ? want + x.cc : 0.0;
  double a1 = a0 - d_spend;
  double est1 = jmax(est0 - d_spend, 0.0);
  double debt1 = dok ? s.debt - want : s.debt;
  double keep_f = (s.debt - want) / debt_s;
  double take_f = want / debt_s;
  double pnd1 = dok ? 0.0 : s.pend;
  double prw1 = dok ? 0.0 : s.pend_rows;

  // batch decision for this charge
  bool batch = false, defer = false;
  if (fl.adaptive) {
    batch = x.has_iters && (x.cc > 0.0) &&
            (isinf(cap) || (est1 >= theta * s.bhat));
    defer = batch && ((prw1 + 1.0) < window);
  }
  double e_b = batch ? x.e + x.cc : x.e;
  double c_b = batch ? x.c - x.cc : x.c;
  double c_bs = jmax(c_b, 1e-30);

  // row phase: schedule from belief, execute against actual
  bool entered = a1 >= x.e;
  double k_est = jclip(est1 >= e_b ? floor((est1 - e_b) / c_bs) : 0.0, 0.0,
                       s.left);
  double fin_cost = x.e + s.left * c_b + ((batch && !defer) ? x.cc : 0.0);
  bool plan_fin = est1 >= fin_cost;
  double sched_i = (batch && plan_fin) ? s.left : k_est;
  double k_act = jclip(entered ? floor((a1 - e_b) / c_bs) : 0.0, 0.0,
                       s.left);
  double k_exec = jclip(entered ? floor((a1 - x.e) / c_bs) : 0.0, 0.0,
                        batch ? sched_i : s.left);
  bool fin = batch ? (plan_fin && (a1 >= fin_cost))
                   : (a1 >= x.e + s.left * c_b);
  bool boundary = batch && !plan_fin && (k_est == 0.0) && (prw1 > 0.0);
  bool sched_commit = plan_fin ? !defer : ((k_est > 0.0) || (prw1 > 0.0));
  bool commit_ok = boundary ? (a1 >= x.cc) : (a1 >= e_b + sched_i * c_b);
  bool land = batch && !plan_fin && sched_commit && commit_ok;
  double exec_iters = batch ? ((land && !boundary) ? sched_i : k_exec)
                            : k_act;
  double prog = batch ? ((land && !boundary) ? sched_i : 0.0) : k_act;
  double commit_n = land ? 1.0 : 0.0;

  double p_entry = boundary ? (land ? a1 - x.cc : -1.0) : a1;
  bool entered_d = p_entry >= x.e;
  double entry_burn = entered_d ? x.e : jclip(p_entry, 0.0, x.e);
  double residue = a1 - entry_burn - exec_iters * c_b - commit_n * x.cc;
  double spend_fin = fin_cost;
  double f_commit = (batch && !defer) ? 1.0 : 0.0;

  bool fin_ok = fin && !dend;
  bool committed = batch ? land : (k_act > 0.0);
  bool tear = !fin_ok && !dend && !committed && (pnd1 > 0.0);
  double waste_add =
      ((!fin_ok && !dend && batch && !land) ? k_exec * c_b : 0.0) +
      (tear ? pnd1 : 0.0) + (dfail ? d_exec : 0.0);
  double pnd_fin = defer ? pnd1 + spend_fin : 0.0;
  double prw_fin = defer ? prw1 + 1.0 : 0.0;

  bool died = dend || !fin;
  double obs = s.chg + a0;
  double bh_new = ((alpha > 0.0) && (s.reboots > 0.0) && died)
                      ? jmax(rint(s.bhat + alpha * (obs - s.bhat)), 1.0)
                      : s.bhat;
  bool stuck_now = !fin_ok && x.row_stuck;

  // per-class vectors, element by element, in the reference's order
  double torn[NC];
  bool need_torn = !dend && !fin && !entered_d;
  if (need_torn) torn_prefix(x, L, p_entry, torn);
  for (int c = 0; c < NC; ++c) {
    double dc = s.debt_class[c], pc = s.pend_class[c];
    double cc_c = x.commit_class[c];
    double iv = batch ? x.iter_class[c] - cc_c : x.iter_class[c];
    double d_cls = dok ? dc * take_f + cc_c : 0.0;
    double pcls1 = dok ? 0.0 : pc;
    double dcls1 = dok ? dc * keep_f : dc;
    double add;
    if (dend) {
      if (dfail) {
        add = dc * (d_exec / debt_s);
        if (c == CTRL) add = add + (a0 - d_exec);
      } else {
        add = d_cls;
        if (c == CTRL) add = add + a1;
      }
    } else if (fin) {
      add = d_cls + ((x.ec(c) + s.left * iv) + f_commit * cc_c);
    } else {
      double burn = ((entered_d ? x.ec(c) : 0.0) +
                     (entered_d ? 0.0 : torn[c])) +
                    exec_iters * iv + commit_n * cc_c;
      if (c == CTRL) burn = burn + residue;
      add = d_cls + burn;
    }
    s.classes[c] = s.classes[c] + add;
    s.pend_class[c] =
        dend ? pcls1 : (fin ? (defer ? (pcls1 + x.ec(c)) + s.left * iv : 0.0)
                            : 0.0);
    s.debt_class[c] = dcls1 + (tear ? pcls1 : 0.0);
  }

  double new_rem = fin_ok ? a1 - spend_fin
                          : trace_window(ccum, rc, s.reboots,
                                         s.reboots + 1.0, cap);
  s.bel = fin_ok ? jmax(est1 - spend_fin, 0.0) : bh_new;
  s.left = fin_ok ? 0.0 : s.left - (dend ? 0.0 : prog);
  s.live = s.live + (dend ? a0 : d_spend + (fin ? spend_fin : a1));
  s.reboots = s.reboots + (fin_ok ? 0.0 : 1.0);
  s.rem = new_rem;
  s.wasted = s.wasted + waste_add;
  s.pend = dend ? pnd1 : (fin ? pnd_fin : 0.0);
  s.pend_rows = dend ? prw1 : (fin ? prw_fin : 0.0);
  s.bhat = bh_new;
  s.chg = fin_ok ? s.chg + d_spend + spend_fin : 0.0;
  s.debt = debt1 + (tear ? pnd1 : 0.0);
  s.stuck = s.stuck || stuck_now;
  return fin_ok || stuck_now;
}

// Closed-form completion of the row's remaining iterations when every
// refill from here on delivers exactly `cap` (fast_forward in the
// reference).  Always finishes the row.
__device__ void fast_forward(const Ctx& x, const Layout& L, const Flags& fl,
                             double cap, double theta, State& s) {
  const int CTRL = L.control_idx;
  double rem = s.rem, left = s.left;
  bool batch0 = false;
  if (fl.adaptive) {
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

  double torn[NC];
  if (!ok && !entered) torn_prefix(x, L, rem, torn);
  for (int c = 0; c < NC; ++c) {
    double cc_c = x.commit_class[c];
    double iv0 = batch0 ? x.iter_class[c] - cc_c : x.iter_class[c];
    double add;
    if (ok) {
      add = (x.ec(c) + left * iv0) + ok_commits * cc_c;
    } else {
      add = entries * x.ec(c) + afford0 * iv0 + rem_iters * x.ivr(c) +
            fail_commits * cc_c;
      add = add + (entered ? 0.0 : torn[c]);
      if (c == CTRL) add = add + residue;
    }
    s.classes[c] = s.classes[c] + add;
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

__global__ void charge_replay_kernel(
    const double* __restrict__ rows, long long lane_stride, Layout L,
    Flags fl, const double* __restrict__ caps,
    const double* __restrict__ rem0, const double* __restrict__ trace_cum,
    int r_trace, const double* __restrict__ tail_s,
    const double* __restrict__ charge_cum, int r_charge,
    const double* __restrict__ nominal_from, const int* __restrict__ s_real,
    double theta, double window, double alpha,
    const double* __restrict__ confs, const double* __restrict__ radio,
    double* live_o, double* reboots_o, double* dead_o, double* classes_o,
    double* wasted_o, unsigned char* stuck_o, double* rem_o,
    double* belief_o, double* tx_o, double* sent_o, double* deferred_o,
    int n_lanes) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= n_lanes) return;
  const double cap = caps[lane];
  const double tail = tail_s[lane];
  const double nfrom = nominal_from[lane];
  const double conf = confs[lane];
  const int n_real = s_real[lane];
  const double* tcum = trace_cum + (long long)lane * r_trace;
  const double* ccum = charge_cum + (long long)lane * r_charge;
  const double* lane_rows = rows + (long long)lane * lane_stride;

  State st;
  st.i = 0;
  st.fresh = true;
  st.stuck = false;
  st.row_r0 = st.dead = st.left = st.live = st.reboots = 0.0;
  st.wasted = st.pend = st.pend_rows = st.chg = st.debt = 0.0;
  st.tx = st.sent = st.deferred = 0.0;
  st.rem = st.bel = rem0[lane];
  st.bhat = cap + 0.0;
  for (int c = 0; c < NC; ++c)
    st.classes[c] = st.pend_class[c] = st.debt_class[c] = 0.0;

  while (st.i < n_real) {
    const double* row = lane_rows + (long long)st.i * L.F;
    Ctx x = row_ctx(row, L, fl, cap, theta, conf, radio);
    bool fresh = st.fresh;

    // decision 5: a fresh SEND row waking into a closed window sleeps
    double send_wait = 0.0;
    bool defer_now = false, is_send = false;
    if (fl.has_send) {
      is_send = x.kind == KIND_SEND;
      bool want_send =
          fresh && is_send && (x.send_bytes > 0.0) && !x.row_stuck;
      double period = radio[R_PERIOD];
      double t = st.live / radio[R_CLK] + st.dead;
      double ps = jmax(period, 1e-30);
      double phase = t - fabs(floor(t / ps) * ps);
      bool closed = (period > 0.0) && (phase >= radio[R_DUTY] * period);
      defer_now = want_send && closed;
      send_wait = defer_now ? period - phase : 0.0;
    }

    // entering a row resets the row-local loop state
    if (fresh) {
      st.left = x.n;
      st.debt = 0.0;
      for (int c = 0; c < NC; ++c) st.debt_class[c] = 0.0;
    }

    bool is_work = x.kind == KIND_WORK || (fl.has_send && is_send);
    bool advance = true;
    if (is_work) {
      bool elig = false;
      if (fl.enable_fast) {
        elig = (st.reboots >= nfrom) && (st.bel == st.rem) &&
               (st.bhat == cap) && (st.pend == 0.0) &&
               (st.pend_rows == 0.0) && (st.debt == 0.0) && !x.row_stuck &&
               ((alpha <= 0.0) || (st.chg + st.rem == cap) ||
                (st.reboots == 0.0));
        if (fl.adaptive) elig = elig && (window <= 1.0);
      }
      if (elig) {
        fast_forward(x, L, fl, cap, theta, st);
        advance = true;
      } else {
        advance = charge_once(x, L, fl, cap, ccum, r_charge, theta, window,
                              alpha, st);
      }
    } else if (fl.has_burn && x.kind == KIND_BURN) {
      // a failed calibration attempt drains the whole buffer
      double r = st.rem;
      st.rem = trace_window(ccum, r_charge, st.reboots, st.reboots + 1.0,
                            cap);
      st.bel = st.bhat;
      st.live = st.live + r;
      st.reboots = st.reboots + 1.0;
      for (int c = 0; c < NC; ++c)
        st.classes[c] = st.classes[c] + (c == L.burn_idx ? 0.0 + r : 0.0);
      st.chg = 0.0;
    } else if (fl.parametric && x.kind == KIND_CALIB) {
      // per-lane burn count from the capacitor (Sec. 7.1)
      double burns = (double)x.k;
      double calib_live =
          burns > 0.0 ? st.rem + trace_window(ccum, r_charge, st.reboots,
                                              st.reboots + burns - 1.0, cap)
                      : 0.0;
      double calib_rem =
          burns > 0.0 ? trace_window(ccum, r_charge, st.reboots + burns - 1.0,
                                     st.reboots + burns, cap)
                      : st.rem;
      st.rem = calib_rem;
      st.bel = burns > 0.0 ? st.bhat : st.bel;
      st.live = st.live + calib_live;
      st.reboots = st.reboots + burns;
      for (int c = 0; c < NC; ++c)
        st.classes[c] =
            st.classes[c] + (c == L.burn_idx ? 0.0 + calib_live : 0.0);
      if (burns > 0.0) st.chg = 0.0;
    }

    // decision 3: per-reboot dead time, booked once per row; the window
    // wait is added first as its own float step
    double dead_base = st.dead + send_wait;
    st.dead = advance ? dead_base + trace_window(tcum, r_trace, st.row_r0,
                                                 st.reboots, tail)
                      : dead_base;
    if (fl.has_send) {
      bool adv_tx = advance && is_send && !x.row_stuck;
      st.tx = st.tx + (adv_tx ? x.send_bytes : 0.0);
      st.sent = st.sent + ((adv_tx && (x.send_bytes > 0.0)) ? 1.0 : 0.0);
      st.deferred = st.deferred + (defer_now ? 1.0 : 0.0);
    }
    if (advance) {
      st.i += 1;
      st.row_r0 = st.reboots;
    }
    st.fresh = advance;
  }

  live_o[lane] = st.live;
  reboots_o[lane] = st.reboots;
  dead_o[lane] = st.dead;
  for (int c = 0; c < NC; ++c)
    classes_o[(long long)lane * NC + c] = st.classes[c];
  wasted_o[lane] = st.wasted;
  stuck_o[lane] = st.stuck ? 1 : 0;
  rem_o[lane] = st.rem;
  belief_o[lane] = st.bhat;
  tx_o[lane] = st.tx;
  sent_o[lane] = st.sent;
  deferred_o[lane] = st.deferred;
}

extern "C" {

int charge_replay_n_classes() { return NC; }

// Launch one thread per lane, 128 to a block, on `stream`.  `layout` is 21
// ints in Layout's field order.  Returns cudaGetLastError() after the
// launch.
int charge_replay_launch(
    const double* rows, long long lane_stride, const int* layout,
    const double* caps, const double* rem0, const double* trace_cum,
    int r_trace, const double* tail_s, const double* charge_cum,
    int r_charge, const double* nominal_from, const int* s_real,
    double theta, double window, double alpha, const double* conf,
    const double* radio, int adaptive, int parametric, int enable_fast,
    int has_burn, int has_send, double* live, double* reboots, double* dead,
    double* classes, double* wasted, unsigned char* stuck, double* rem,
    double* belief, double* tx_bytes, double* msgs_sent,
    double* msgs_deferred, int n_lanes, void* stream) {
  Layout L;
  int* dst = &L.kind;
  for (int j = 0; j < (int)(sizeof(Layout) / sizeof(int)); ++j)
    dst[j] = layout[j];
  Flags fl = {adaptive, parametric, enable_fast, has_burn, has_send};
  if (n_lanes <= 0) return 0;
  const int block = 128;
  const int grid = (n_lanes + block - 1) / block;
  charge_replay_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      rows, lane_stride, L, fl, caps, rem0, trace_cum, r_trace, tail_s,
      charge_cum, r_charge, nominal_from, s_real, theta, window, alpha, conf,
      radio, live, reboots, dead, classes, wasted, stuck, rem, belief,
      tx_bytes, msgs_sent, msgs_deferred, n_lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
