"""Whether what the timed path produced is correct.

Once the window has closed, the reference (``perfbench/fleetref``: frozen
numpy copies of the port's row emission, samplers and fold, and the
pure-Python replay oracle) works out again, from the configuration's
network and input and each call's seed:

* ``plan_rows``: every row value of every candidate's plan, and its
  capacity and recharge time (mismatched values; limit 0);
* ``edges``: every call's histogram edges (mismatched values; limit 0);
* ``lanes``: a sample of lanes (``sample_lanes``: drawn from the seed
  over the calls, the ends of every candidate's block and chunk and one
  lane of every 1,024 of one call, and per candidate the lane of the last
  call that ran longest), each replayed by the oracle from inputs it drew
  itself; the widest gap of any channel, relative to
  ``max(|reference|, 1)`` (limit from the mix: 0 where the program replays
  charge by charge, which the oracle mirrors bit for bit);
* ``fold``: every fold of the window against the reference fold of the
  lanes the program handed it (the widest relative gap; limit 0);
* ``stats``: every call's answer against the merge of those reference
  folds in chunk order (limit 0);
* ``count``: every group's lane count in every answer (a group a
  candidate, or a capacitor of a capacitor sweep) against the mix's
  devices (limit 0), which a replay that drops lanes before the fold
  cannot pass.

The fold and stats checks follow the program from its own lane outputs;
the lane check is the stage they skip, judged on the sample.
"""

from __future__ import annotations

import math
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from fleetref import fold as RF
from fleetref import inputs as RI
from fleetref import oracle as RO
from fleetref import plan as RP
from fleetref.energy import rf_recharge_seconds

from .program import n_groups

#: The per-lane channels compared (``stuck`` as 0 / 1).
LANE_CHANNELS = ("live", "reboots", "dead", "classes", "wasted", "belief",
                 "tx_bytes", "msgs_sent", "msgs_deferred", "stuck")
#: The lanes of one call of which ``sample_lanes`` draws one each.
STRATUM = 1024
#: The most processes the oracle replays the picked lanes in, and the
#: fewest picks it starts them for.
MAX_WORKERS, POOL_FROM = 8, 64


def gap(a, b) -> float:
    """The widest ``|a - b| / max(|b|, 1)`` over two arrays (equal values,
    infinities and NaNs included, read 0)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    same = (a == b) | (np.isnan(a) & np.isnan(b))
    if same.all():
        return 0.0
    with np.errstate(invalid="ignore", over="ignore"):
        d = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    d = np.where(same, 0.0, d)
    return float(np.nan_to_num(d, nan=math.inf).max())


def reference_plans(cfg: dict, arrays: list, x, candidates,
                    parametric: bool = False) -> list[dict]:
    from fleetref import inference
    net = RI.build_net(cfg, arrays, inference)
    return [RP.build_rows(net, x, c["strategy"], c["power"], parametric)
            for c in candidates]


def plan_mismatches(program_plans, ref_plans) -> int:
    bad = 0
    for p, r in zip(program_plans, ref_plans):
        for k, want in r["rows"].items():
            got = np.asarray(getattr(p, k))
            if got.shape != want.shape:
                bad += want.size
            else:
                bad += int(np.sum(~((got == want)
                                    | (np.isnan(got) & np.isnan(want)))))
        bad += int(p.capacity != r["capacity"])
        bad += int(p.recharge_s != r["recharge_s"])
    return bad


def reference_edges(ref_plans: list[dict], bins: int,
                    capacities=None) -> dict:
    if capacities is not None:           # a capacitor sweep's grid
        caps = np.asarray(capacities, np.float64)
        fin = caps[np.isfinite(caps)]
        rec = rf_recharge_seconds(fin) if fin.size else np.zeros(1)
        return RF.default_stat_edges(ref_plans[0]["total_cycles"], caps,
                                     rec, bins)
    if len(ref_plans) == 1:
        r = ref_plans[0]
        return RF.default_stat_edges(r["total_cycles"], r["capacity"],
                                     r["recharge_s"], bins)
    return RF.default_stat_edges(
        max(r["total_cycles"] for r in ref_plans),
        np.asarray([r["capacity"] for r in ref_plans], np.float64),
        np.asarray([r["recharge_s"] for r in ref_plans], np.float64), bins)


def program_part(part: tuple) -> dict:
    psums, pmins, pmaxs = part
    return dict(count=psums["count"], completed=psums["completed"],
                sums={c: psums[f"{c}:sum"] for c in RF.STAT_CHANNELS},
                sumsqs={c: psums[f"{c}:sumsq"] for c in RF.STAT_CHANNELS},
                mins=dict(pmins), maxs=dict(pmaxs),
                hists={c: psums[f"{c}:hist"] for c in RF.STAT_CHANNELS},
                class_sums=psums["class_sums"])


def stats_dict(st) -> dict:
    return dict(count=st.count, completed=st.completed, sums=st.sums,
                sumsqs=st.sumsqs, mins=st.mins, maxs=st.maxs,
                hists=st.hists, class_sums=st.class_sums)


def stats_gap(a: dict, b: dict) -> float:
    g = max(gap(a["count"], b["count"]), gap(a["completed"], b["completed"]),
            gap(a["class_sums"], b["class_sums"]))
    for key in ("sums", "sumsqs", "mins", "maxs", "hists"):
        for c in RF.STAT_CHANNELS:
            g = max(g, gap(a[key][c], b[key][c]))
    return g


def sample_lanes(seed: int, n_calls: int, n_candidates: int, n_devices: int,
                 per_candidate: int, longest: list,
                 lane_chunk: int | None = None) -> list[tuple]:
    """``(call, lane)`` pairs, each once: ``per_candidate`` drawn from the
    seed for each candidate, each from any call; then, in one call drawn
    from the seed, the first and last lane of each candidate's block and of
    each chunk, and one lane drawn from each ``STRATUM`` lanes of the call;
    then ``longest`` (each candidate's longest lane of the last call)."""
    rng = np.random.default_rng([seed % 2**64, 7])
    picks = []
    for p in range(n_candidates):
        for _ in range(per_candidate):
            picks.append((int(rng.integers(n_calls)),
                          p * n_devices + int(rng.integers(n_devices))))
    call = int(rng.integers(n_calls))
    n_lanes = n_candidates * n_devices
    chunk = lane_chunk or n_lanes
    ends = set()
    for lo, width in ([(p * n_devices, n_devices)
                       for p in range(n_candidates)]
                      + [(lo, chunk) for lo in range(0, n_lanes, chunk)]):
        ends |= {lo, min(lo + width, n_lanes) - 1}
    picks += [(call, lane) for lane in sorted(ends)]
    picks += [(call, lo + int(rng.integers(min(STRATUM, n_lanes - lo))))
              for lo in range(0, n_lanes, STRATUM)]
    picks += [(n_calls - 1, lane) for lane in longest]
    return list(dict.fromkeys(picks))


def lane_output(chunks: list[dict], lane: int, lane_chunk: int | None):
    """Lane ``lane``'s outputs from a call's captured folds."""
    if lane_chunk is None:
        c, i = chunks[0], lane
    else:
        c, i = chunks[lane // lane_chunk], lane % lane_chunk
    return {k: v[i] for k, v in c["out"].items()}


def replay_lane(traffic: dict, ref_plans: list[dict], seed: int, lane: int,
                precision: str = "float64") -> dict:
    """The oracle's replay of lane ``lane`` of the call with fleet seed
    ``seed``, from the inputs it draws itself."""
    sweep = traffic["sweep"]
    if traffic.get("capacities"):
        li = RI.capacitor_lane_inputs(sweep, traffic["capacities"], seed,
                                      lane)
    else:
        heads = [dict(capacity=r["capacity"], recharge_s=r["recharge_s"])
                 for r in ref_plans]
        li = RI.lane_inputs(sweep, heads, seed, lane, len(ref_plans) > 1)
    return RO.reference_replay(
        ref_plans[li["plan"]]["rows"], li["cap"], li["rem0"],
        tail_s=li["tail_s"], recharge_cum=li["recharge_cum"],
        charge_cum=li["charge_cum"], policy=sweep.get("policy", "fixed"),
        theta=sweep.get("theta", 0.5), batch_rows=sweep.get("batch_rows", 1),
        belief_alpha=sweep.get("belief_alpha", 0.0), precision=precision)


_WORKER: dict = {}


def _start_worker(traffic: dict, ref_plans: list[dict]) -> None:
    _WORKER.update(traffic=traffic, plans=ref_plans)


def _replay_task(task: tuple) -> dict:
    return replay_lane(_WORKER["traffic"], _WORKER["plans"], *task)


def replay_reference(traffic: dict, ref_plans, seeds, picks,
                     precision: str = "float64",
                     workers: int | None = None) -> list[dict]:
    """The oracle's replay of every picked ``(call, lane)``, in order: in
    ``workers`` processes of their own (by default one a host core, at
    most ``MAX_WORKERS``), which are stopped and waited for before it
    returns; by default in this process where the picks are under
    ``POOL_FROM``."""
    tasks = [(seeds[call], lane, precision) for call, lane in picks]
    if workers is None:
        workers = min(MAX_WORKERS, os.cpu_count() or 1) \
            if len(tasks) >= POOL_FROM else 1
    if workers < 2:
        return [replay_lane(traffic, ref_plans, *t) for t in tasks]
    plans = [dict(rows=r["rows"], capacity=r["capacity"],
                  recharge_s=r["recharge_s"]) for r in ref_plans]
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn"),
                             initializer=_start_worker,
                             initargs=(traffic, plans)) as pool:
        return list(pool.map(_replay_task, tasks, chunksize=2))


def lane_gap(got: dict, want: dict, closed_form: bool) -> float:
    """One lane's widest channel gap; a lane the reference finds stuck is
    held on ``stuck`` alone in the closed form, whose channels of a lane
    that never finishes are not the charge-wise ones."""
    if closed_form and want["stuck"]:
        return gap(float(got["stuck"]), float(want["stuck"]))
    return max(gap(np.asarray(got[k], np.float64),
                   np.asarray(want[k], np.float64)) for k in LANE_CHANNELS)


def judge(cell, arrays, x, program_plans, answers: list, seeds: list,
          calls: list[list[dict]], seed: int) -> tuple:
    """Every comparison of a run: ``(correct, [(name, value, limit)],
    lanes checked, calls failed)``."""
    traffic, sweep = cell.traffic, cell.traffic["sweep"]
    limits = dict(traffic["limits"])
    cands = traffic["candidates"]
    caps = traffic.get("capacities")
    groups = n_groups(traffic)
    n_dev = sweep["n_devices"]
    ref_plans = reference_plans(cell.config, arrays, x, cands, bool(caps))
    rows_bad = plan_mismatches(program_plans, ref_plans)

    edges = reference_edges(ref_plans, sweep.get("stats_bins", 64), caps)
    edges_bad = 0
    for st in answers:
        for c in RF.STAT_CHANNELS:
            e, g = edges[c], np.asarray(st.edges[c])
            edges_bad += e.size if e.shape != g.shape else int(np.sum(e != g))

    per_call = []                      # (fold, stats, count) gaps a call
    for st, chunks in zip(answers, calls):
        fold_g, merged = 0.0, None
        for c in chunks:
            v = np.asarray(c["valid"], bool)
            ref = RF.stats_from_outputs(
                {k: np.asarray(a)[v] for k, a in c["out"].items()},
                edges, group_id=np.asarray(c["gid"])[v],
                n_groups=c["n_groups"])
            fold_g = max(fold_g, stats_gap(program_part(c["part"]), ref))
            merged = ref if merged is None else RF.merge(merged, ref)
        stats_g = math.inf if merged is None else \
            stats_gap(stats_dict(st), merged)
        want = np.full(groups, float(n_dev))
        cnt = np.asarray(st.count, np.float64)
        count_g = math.inf if cnt.shape != want.shape else \
            float(np.max(np.abs(cnt - want)))
        per_call.append([fold_g, stats_g, count_g, 0.0])

    longest = []
    lane_chunk = sweep.get("lane_chunk")
    for p in range(groups):
        live = [lane_output(calls[-1], i, lane_chunk)["live"]
                for i in range(p * n_dev, (p + 1) * n_dev)]
        longest.append(p * n_dev + int(np.argmax(live)))
    picks = sample_lanes(seed, len(calls), groups, n_dev,
                         traffic["check"]["lanes_per_candidate"], longest,
                         lane_chunk)
    want = replay_reference(traffic, ref_plans, seeds, picks)
    closed = not charge_wise(sweep, len(cands))
    for (call, lane), w in zip(picks, want):
        got = lane_output(calls[call], lane, lane_chunk)
        per_call[call][3] = max(per_call[call][3], lane_gap(got, w, closed))

    lim = [0, 0, 0, limits["lanes"]]
    checks = [("plan_rows", rows_bad, 0), ("edges", edges_bad, 0)]
    checks += [(n, max(pc[j] for pc in per_call), lim[j])
               for j, n in enumerate(("fold", "stats", "count", "lanes"))]
    correct = all(v <= lm and not math.isnan(v) for _n, v, lm in checks)
    if rows_bad or edges_bad:
        failed = len(calls)
    else:
        failed = sum(any(not v <= lm for v, lm in zip(pc, lim))
                     for pc in per_call)
    return correct, checks, len(picks), failed


def charge_wise(sweep: dict, n_candidates: int) -> bool:
    """Whether the program replays charge by charge (``fleetsim._prepare``'s
    rule; a design sweep always does) rather than by the closed form."""
    return (n_candidates > 1 or sweep.get("charge_cv", 0) > 0
            or sweep.get("charge_bias_cv", 0) > 0
            or sweep.get("charge_reboots", 0) > 0
            or (sweep.get("policy") == "adaptive"
                and sweep.get("batch_rows", 1) > 1))
