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
// What bounds it on an H100: a lane's events run in series, each a chain
// of dependent f64 operations (about 8 cycles each, several divisions)
// with a 17-wide class update beside it, so a lane is bound by latency and
// the card by how many lanes it holds, not by its f64 rate or its memory
// rate.  The row table is shared by every lane of a fleet sweep and lives
// in L2 (and, for the rows the lanes of an SM are at, in L1).  Two designs,
// chosen by name from charge_replay.py (design=):
//
// * hoisted (the main path).  Profiled with clock64() laps
//   (tools/profile_replay.py), the direct design spent two thirds of an
//   event in charge_once's class loop: each class's row loads waited
//   behind that class's branches, so the 17 classes paid 17 round trips to
//   memory in series, and the lanes of a warp, a few rows apart, read a
//   row-major row as a cache line each.  Here the branch of the class loop
//   (the event's case, the same for all 17 classes) is chosen once, and
//   each case's loop is straight-line code whose loads issue together; the
//   shared plan's table is passed column-major, so a warp reads a column
//   from a few lines; the divisions whose quotients an event does not read
//   (no debt, no send) are not taken (0 / 1e-30 goes down CUDA's slow
//   division path); parametric and has_send are template parameters (four
//   instantiations; adaptive, enable_fast and has_burn stay run-time: each
//   is the same for every lane of a launch, so its branches never diverge,
//   and the event head that holds most of them takes 4 % of an event in
//   the profile); the torn prefix is
//   added class by class with no array indexed at run time (the direct
//   design's kept 136 bytes of local memory); and the blocks cover all 132
//   SMs.  Rows are not staged in shared memory: a per-lane copy of each
//   row, made one event ahead with cp.async, cost more in L2 traffic than
//   the loads it saved, since L1 already shares a row among the lanes of an
//   SM (PERF.md).
// * direct (the first design, kept to be timed beside it): rows read
//   row-major from global memory, the class loop branching inside, the
//   five flags at run time, 128 lanes a block.
//
// A lane finds its rows in one of three ways, the same in both designs:
// one table shared by every lane (a fleet sweep), a table of its own
// (replay_plans), or its candidate's table in a (P, S, F) pack of plans, by
// a per-lane plan index (a PlanSet design sweep; the hoisted design gets
// each plan column-major, as it gets a shared table).
//
// Both designs do the same float operations in the same order on every
// lane, so they give the same bits; each is held against the plain version
// and the other on the card (chip_smoke.py, tests/test_torch_cuda.py).
//
// The lane state, the row layout, row_ctx, fast_forward and trace_window of
// the hoisted design are in charge_replay.cuh, which the closed form's
// kernel (closed_form.cu) shares.

#include "charge_replay.cuh"

// ===========================================================================
// The direct design: one thread per lane, rows read from global memory
// (L2), the five flags at run time, and a class loop with its branches
// inside.  Launched by name (charge_replay.py: design="direct") to time
// it beside the hoisted design; the main path never calls it.
// ===========================================================================

namespace direct {

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

// Exactly one charge of the current row (charge_once in the reference).
// Returns whether the row finished or stuck.
__device__ bool charge_once(const Ctx& x, const Layout& L, const Flags& fl,
                            double cap, const double* ccum, int rc,
                            double theta, double window, double alpha,
                            State& s, Prof& pf) {
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
  pf.lap(P_CO_SCALAR);

  // per-class vectors, element by element, in the reference's order
  double torn[NC];
  bool need_torn = !dend && !fin && !entered_d;
  if (need_torn) {
    pf.warp(W_TORN);
    pf.count(C_TORN);
    torn_prefix(x, L, p_entry, torn);
  }
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
  pf.lap(P_CO_CLASS);

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
                             double cap, double theta, State& s,
                             Prof& pf) {
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
  if (!ok && !entered) {
    pf.warp(W_TORN);
    pf.count(C_TORN);
    torn_prefix(x, L, rem, torn);
  }
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
    const double* __restrict__ rows, long long lane_stride,
    const int* __restrict__ plan_idx, Layout L,
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
  // a lane's table: its own (lane_stride apart), or its plan's in a
  // (P, S, F) pack of candidate plans when plan_idx is given
  const double* lane_rows =
      rows + (long long)(plan_idx ? plan_idx[lane] : lane) * lane_stride;

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

  Prof pf;
  pf.start();
  while (st.i < n_real) {
    pf.warp(W_LOOP);
    pf.count(C_EVENTS);
    const double* row = lane_rows + (long long)st.i * L.F;
    Ctx x = row_ctx(row, L, fl, cap, theta, conf, radio);
    pf.lap(P_CTX);
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
      pf.lap(P_HEAD);
      if (elig) {
        pf.warp(W_FAST);
        pf.count(C_FAST);
        fast_forward(x, L, fl, cap, theta, st, pf);
        advance = true;
        pf.lap(P_FAST);
      } else {
        pf.warp(W_CHARGE);
        pf.count(C_CHARGE);
        advance = charge_once(x, L, fl, cap, ccum, r_charge, theta, window,
                              alpha, st, pf);
        pf.lap(P_CHARGE);
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
    if (!is_work) {
      pf.count(C_BURN);
      pf.lap(P_BURN);
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
    pf.lap(P_TAIL);
  }
  pf.flush();

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

}  // namespace direct

// ===========================================================================
// The hoisted design (the main path): the same arithmetic per lane as the
// direct design, scheduled for the card.
// ===========================================================================

namespace hoisted {

// Which branch of charge_once's class loop an event takes.  It is the same
// for all 17 classes, so it is chosen once per event, outside the loop, and
// each case's loop is straight-line code whose loads issue together (in
// the direct design each class's loads wait behind that class's branches).
enum { CASE_DFAIL, CASE_DOK, CASE_FIN, CASE_PART, CASE_TORN };

// The per-event scalars charge_once's class loop reads.
struct ChargeTerms {
  bool batch, defer, tear;
  double take_f, keep_f, d_ratio, a0, d_exec, a1, left, f_commit,
      exec_iters, commit_n, residue, p_entry;
};

// The class loop of the direct design's charge_once for one case and one
// value of dok (a debt replayed this charge: rare, so the common loop
// carries none of its arithmetic): every expression as there, in the same
// order.  `t.d_ratio` is its d_exec / debt_s, the same quotient for every
// class.
template <int CASE, bool DOK, bool SEND>
__device__ __forceinline__ void charge_classes(const Ctx& x, const Layout& L,
                                               const ChargeTerms& t,
                                               State& s) {
  constexpr bool DEND = CASE == CASE_DFAIL || CASE == CASE_DOK;
  constexpr bool FIN = CASE == CASE_FIN;
  const int CTRL = L.control_idx;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    double dc = s.debt_class[c], pc = s.pend_class[c];
    double cc_c = x.commit_class[c];
    double iv = t.batch ? x.iter_class[c] - cc_c : x.iter_class[c];
    double d_cls = DOK ? dc * t.take_f + cc_c : 0.0;
    double pcls1 = DOK ? 0.0 : pc;
    double dcls1 = DOK ? dc * t.keep_f : dc;
    double add;
    if (CASE == CASE_DFAIL) {
      add = dc * t.d_ratio;
      if (c == CTRL) add = add + (t.a0 - t.d_exec);
    } else if (CASE == CASE_DOK) {
      add = d_cls;
      if (c == CTRL) add = add + t.a1;
    } else if (FIN) {
      add = d_cls + ((ec<SEND>(x, c) + t.left * iv) + t.f_commit * cc_c);
    } else {
      constexpr bool ENTERED = CASE == CASE_PART;
      double burn =
          ((ENTERED ? ec<SEND>(x, c) : 0.0) +
           (ENTERED ? 0.0 : torn_class<SEND>(x, L, t.p_entry, c))) +
          t.exec_iters * iv + t.commit_n * cc_c;
      if (c == CTRL) burn = burn + t.residue;
      add = d_cls + burn;
    }
    s.classes[c] = s.classes[c] + add;
    s.pend_class[c] =
        DEND ? pcls1
             : (FIN ? (t.defer ? (pcls1 + ec<SEND>(x, c)) + t.left * iv : 0.0)
                    : 0.0);
    s.debt_class[c] = dcls1 + (t.tear ? pcls1 : 0.0);
  }
}

// charge_once of the direct design: the same scalar arithmetic, then the
// class loop of the event's case.
template <bool SEND>
__device__ __forceinline__ bool charge_once(const Ctx& x, const Layout& L,
                                            bool adaptive, double cap,
                                            const double* ccum, int rc,
                                            double theta, double window,
                                            double alpha, State& s,
                                            Prof& pf) {
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
  // read only where dok: without debt both are 0 / 1e-30, which CUDA's
  // division sends down its slow path, twice an event
  double keep_f = 0.0, take_f = 0.0;
  if (dok) {
    keep_f = (s.debt - want) / debt_s;
    take_f = want / debt_s;
  }
  double pnd1 = dok ? 0.0 : s.pend;
  double prw1 = dok ? 0.0 : s.pend_rows;

  // batch decision for this charge
  bool batch = false, defer = false;
  if (adaptive) {
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
  pf.lap(P_CO_SCALAR);

  // per-class vectors, element by element, in the reference's order
  const ChargeTerms t = {batch,    defer,      tear,
                         take_f,   keep_f,     dfail ? d_exec / debt_s : 0.0,
                         a0,       d_exec,     a1,       s.left,
                         f_commit, exec_iters, commit_n, residue,
                         p_entry};
  // (dfail implies !dok; the DOK case, dend && !dfail, implies dok)
  if (dend) {
    if (dfail) {
      charge_classes<CASE_DFAIL, false, SEND>(x, L, t, s);
    } else {
      charge_classes<CASE_DOK, true, SEND>(x, L, t, s);
    }
  } else if (fin) {
    if (dok)
      charge_classes<CASE_FIN, true, SEND>(x, L, t, s);
    else
      charge_classes<CASE_FIN, false, SEND>(x, L, t, s);
  } else if (entered_d) {
    if (dok)
      charge_classes<CASE_PART, true, SEND>(x, L, t, s);
    else
      charge_classes<CASE_PART, false, SEND>(x, L, t, s);
  } else {
    pf.warp(W_TORN);
    pf.count(C_TORN);
    if (dok)
      charge_classes<CASE_TORN, true, SEND>(x, L, t, s);
    else
      charge_classes<CASE_TORN, false, SEND>(x, L, t, s);
  }
  pf.lap(P_CO_CLASS);

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

// One thread per lane, as in the direct design.  Element (i, j) of a lane's
// table is at lane_rows[i * rs + j * cs]: the shared plan's table comes
// column-major (rs = 1, cs = S), so the lanes of a warp, a few rows apart,
// read a column from a few cache lines where row-major rows would take one
// line a lane (an L1 wavefront each); so does each plan of a pack of
// candidate plans ((P, F, S), a plan F * S apart); a lane's own table
// comes row-major (rs = F, cs = 1).  PLAN: a lane finds its table by its
// plan index (a template parameter, so that the other modes compile to the
// code they had before plan_idx existed: a run-time test of plan_idx cost
// the main path 7 % at 255 registers, PERF.md).
template <bool PARAM, bool SEND, bool PLAN>
__global__ void __launch_bounds__(LANE_MAX_BLOCK, 1) charge_replay_kernel(
    const double* __restrict__ rows, long long lane_stride,
    const int* __restrict__ plan_idx, int rs, int cs, Layout L, Flags fl,
    const double* __restrict__ caps,
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
  const bool adaptive = fl.adaptive != 0;
  const double cap = caps[lane];
  const double tail = tail_s[lane];
  const double nfrom = nominal_from[lane];
  const double conf = confs[lane];
  const int n_real = s_real[lane];
  const double* tcum = trace_cum + (long long)lane * r_trace;
  const double* ccum = charge_cum + (long long)lane * r_charge;
  // a lane's table: its own (lane_stride apart, 0 for a shared one), or
  // its plan's in a (P, S, F) pack of candidate plans
  const double* lane_rows =
      rows + (long long)(PLAN ? plan_idx[lane] : lane) * lane_stride;

  State st;
  st.i = 0;
  st.fresh = true;
  st.stuck = false;
  st.row_r0 = st.dead = st.left = st.live = st.reboots = 0.0;
  st.wasted = st.pend = st.pend_rows = st.chg = st.debt = 0.0;
  st.tx = st.sent = st.deferred = 0.0;
  st.rem = st.bel = rem0[lane];
  st.bhat = cap + 0.0;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    st.classes[c] = st.pend_class[c] = st.debt_class[c] = 0.0;

  Prof pf;
  pf.start();
  while (st.i < n_real) {
    pf.warp(W_LOOP);
    pf.count(C_EVENTS);
    const double* row = lane_rows + (long long)st.i * rs;
    Ctx x = row_ctx<PARAM, SEND>(row, cs, L, adaptive, cap, theta, conf,
                                 radio);
    pf.lap(P_CTX);
    bool fresh = st.fresh;

    // decision 5: a fresh SEND row waking into a closed window sleeps
    double send_wait = 0.0;
    bool defer_now = false, is_send = false;
    if (SEND) {
      is_send = x.kind == KIND_SEND;
      bool want_send =
          fresh && is_send && (x.send_bytes > 0.0) && !x.row_stuck;
      // the window's phase (two divisions) only where a send is wanted:
      // elsewhere defer_now is false whatever it is
      if (want_send) {
        double period = radio[R_PERIOD];
        double t = st.live / radio[R_CLK] + st.dead;
        double ps = jmax(period, 1e-30);
        double phase = t - fabs(floor(t / ps) * ps);
        bool closed = (period > 0.0) && (phase >= radio[R_DUTY] * period);
        defer_now = closed;
        send_wait = defer_now ? period - phase : 0.0;
      }
    }

    // entering a row resets the row-local loop state
    if (fresh) {
      st.left = x.n;
      st.debt = 0.0;
#pragma unroll
      for (int c = 0; c < NC; ++c) st.debt_class[c] = 0.0;
    }

    bool is_work = x.kind == KIND_WORK || (SEND && is_send);
    bool advance = true;
    if (is_work) {
      bool elig = false;
      if (fl.enable_fast) {
        elig = (st.reboots >= nfrom) && (st.bel == st.rem) &&
               (st.bhat == cap) && (st.pend == 0.0) &&
               (st.pend_rows == 0.0) && (st.debt == 0.0) && !x.row_stuck &&
               ((alpha <= 0.0) || (st.chg + st.rem == cap) ||
                (st.reboots == 0.0));
        if (adaptive) elig = elig && (window <= 1.0);
      }
      pf.lap(P_HEAD);
      if (elig) {
        pf.warp(W_FAST);
        pf.count(C_FAST);
        fast_forward<SEND>(x, L, adaptive, cap, theta, st, pf);
        advance = true;
        pf.lap(P_FAST);
      } else {
        pf.warp(W_CHARGE);
        pf.count(C_CHARGE);
        advance = charge_once<SEND>(x, L, adaptive, cap, ccum, r_charge,
                                    theta, window, alpha, st, pf);
        pf.lap(P_CHARGE);
      }
    } else if (fl.has_burn && x.kind == KIND_BURN) {
      // a failed calibration attempt drains the whole buffer
      double r = st.rem;
      st.rem = trace_window(ccum, r_charge, st.reboots, st.reboots + 1.0,
                            cap);
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
#pragma unroll
      for (int c = 0; c < NC; ++c)
        st.classes[c] =
            st.classes[c] + (c == L.burn_idx ? 0.0 + calib_live : 0.0);
      if (burns > 0.0) st.chg = 0.0;
    }
    if (!is_work) {
      pf.count(C_BURN);
      pf.lap(P_BURN);
    }

    // decision 3: per-reboot dead time, booked once per row; the window
    // wait is added first as its own float step
    double dead_base = st.dead + send_wait;
    st.dead = advance ? dead_base + trace_window(tcum, r_trace, st.row_r0,
                                                 st.reboots, tail)
                      : dead_base;
    if (SEND) {
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
    pf.lap(P_TAIL);
  }
  pf.flush();

  live_o[lane] = st.live;
  reboots_o[lane] = st.reboots;
  dead_o[lane] = st.dead;
#pragma unroll
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

}  // namespace hoisted

// The dependent latency of f64 arithmetic (chip_smoke.py's chain floor):
// one thread runs `n` dependent additions, then `n` dependent
// multiplications, and writes the clock64() cycles of each chain and the
// %globaltimer nanoseconds of both (the SM clock beside the cycles).  The
// empty asm statements keep each chain between its two clock reads.
__global__ void f64_latency_kernel(double a, double b, int n,
                                   long long* out, double* sink) {
  double x = a;
  asm volatile("" : "+d"(x));
  unsigned long long g0 = globaltimer();
  long long c0 = clock64();
  for (int i = 0; i < n; ++i) x = x + b;
  asm volatile("" : "+d"(x));
  long long c1 = clock64();
  for (int i = 0; i < n; ++i) x = x * a;
  asm volatile("" : "+d"(x));
  long long c2 = clock64();
  unsigned long long g1 = globaltimer();
  out[0] = c1 - c0;
  out[1] = c2 - c1;
  out[2] = (long long)(g1 - g0);
  sink[0] = x;
}

extern "C" {

int charge_replay_n_classes() { return NC; }

// f64_latency_kernel on one thread: out (device, 3 long longs) gets the
// add chain's cycles, the multiply chain's cycles and the nanoseconds of
// both; sink (device, 1 double) keeps the result live.
int charge_replay_f64_latency(int n, long long* out, double* sink,
                              void* stream) {
  f64_latency_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(1.0000001, 1e-3, n,
                                                        out, sink);
  return (int)cudaGetLastError();
}

#ifdef REPLAY_PROFILE
// The profile build's counters: zero them, or copy PROF_SLOTS + PROF_SMS
// 64-bit words (the blocks per SM widened) to `host`.
int charge_replay_profile_reset() {
  unsigned long long z[PROF_SLOTS] = {0};
  unsigned int zs[PROF_SMS] = {0};
  cudaMemcpyToSymbol(prof_acc, z, sizeof(z));
  cudaMemcpyToSymbol(prof_sm, zs, sizeof(zs));
  return (int)cudaGetLastError();
}
int charge_replay_profile_read(unsigned long long* host) {
  unsigned int sms[PROF_SMS];
  cudaMemcpyFromSymbol(host, prof_acc, sizeof(unsigned long long) * PROF_SLOTS);
  cudaMemcpyFromSymbol(sms, prof_sm, sizeof(sms));
  for (int i = 0; i < PROF_SMS; ++i) host[PROF_SLOTS + i] = sms[i];
  return (int)cudaGetLastError();
}
#endif

// The direct design: one thread per lane, 128 to a block, on `stream`.
// Lane l's row-major table starts at rows + l * lane_stride (0 for one
// shared table) or, where plan_idx (device, one int a lane) is not null,
// at rows + plan_idx[l] * lane_stride: its candidate's plan in a (P, S, F)
// pack.  `layout` is 21 ints in Layout's field order.  Returns
// cudaGetLastError() after the launch.
int charge_replay_launch(
    const double* rows, long long lane_stride, const int* plan_idx,
    const int* layout,
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
  direct::charge_replay_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      rows, lane_stride, plan_idx, L, fl, caps, rem0, trace_cum, r_trace,
      tail_s, charge_cum, r_charge, nominal_from, s_real, theta, window,
      alpha, conf, radio, live, reboots, dead, classes, wasted, stuck, rem,
      belief, tx_bytes, msgs_sent, msgs_deferred, n_lanes);
  return (int)cudaGetLastError();
}

// The hoisted design, on `stream`: `block` lanes a block (1 to
// LANE_MAX_BLOCK); `variant` is the instantiation, 2 * parametric +
// has_send (charge_replay.py:kernel_variant), in plan mode where plan_idx
// is not null; element (i, j) of a lane's
// table at i * rs + j * cs.  The other arguments are charge_replay_launch's
// (`layout`'s F is the row width whatever the strides).  Returns cudaErrorInvalidValue for a block or
// variant these flags do not allow, else cudaGetLastError() after the
// launch.
int charge_replay_hoisted_launch(
    const double* rows, long long lane_stride, const int* plan_idx,
    const int* layout,
    const double* caps, const double* rem0, const double* trace_cum,
    int r_trace, const double* tail_s, const double* charge_cum,
    int r_charge, const double* nominal_from, const int* s_real,
    double theta, double window, double alpha, const double* conf,
    const double* radio, int adaptive, int parametric, int enable_fast,
    int has_burn, int has_send, double* live, double* reboots, double* dead,
    double* classes, double* wasted, unsigned char* stuck, double* rem,
    double* belief, double* tx_bytes, double* msgs_sent,
    double* msgs_deferred, int n_lanes, int variant, int block, int rs,
    int cs, void* stream) {
  Layout L;
  int* dst = &L.kind;
  for (int j = 0; j < (int)(sizeof(Layout) / sizeof(int)); ++j)
    dst[j] = layout[j];
  Flags fl = {adaptive, parametric, enable_fast, has_burn, has_send};
  if (variant != 2 * (parametric != 0) + (has_send != 0) || block < 1 ||
      block > LANE_MAX_BLOCK)
    return (int)cudaErrorInvalidValue;
  if (n_lanes <= 0) return 0;
  using Kernel =
      decltype(&hoisted::charge_replay_kernel<false, false, false>);
  static const Kernel kernels[8] = {
      &hoisted::charge_replay_kernel<false, false, false>,
      &hoisted::charge_replay_kernel<false, true, false>,
      &hoisted::charge_replay_kernel<true, false, false>,
      &hoisted::charge_replay_kernel<true, true, false>,
      &hoisted::charge_replay_kernel<false, false, true>,
      &hoisted::charge_replay_kernel<false, true, true>,
      &hoisted::charge_replay_kernel<true, false, true>,
      &hoisted::charge_replay_kernel<true, true, true>};
  const int grid = (n_lanes + block - 1) / block;
  const int k = variant + (plan_idx ? 4 : 0);
  kernels[k]<<<grid, block, 0, (cudaStream_t)stream>>>(
      rows, lane_stride, plan_idx, rs, cs, L, fl, caps, rem0, trace_cum,
      r_trace, tail_s, charge_cum, r_charge, nominal_from, s_real, theta,
      window, alpha, conf, radio, live, reboots, dead, classes, wasted, stuck,
      rem, belief, tx_bytes, msgs_sent, msgs_deferred, n_lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
