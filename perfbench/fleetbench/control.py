"""The check's control: the reference put in the program's place and
computed in float32, the nearest precision below the configuration's
float64.

For each seed the control draws the lanes a run with that seed would
check (``check.sample_lanes``, the seed's own picks over ``calls`` calls),
replays each with the reference at both precisions and reports the widest
``lanes`` gap; the check has to find it above the mix's limit.  It runs no
program and needs no card:

    python3 perfbench/control.py --workload <cell> --seed <n> [<n> ...]
"""

from __future__ import annotations

import argparse
import json
import time

from fleetref import inputs as RI

from . import check


def reading(cell, seed: int, calls: int) -> dict:
    """The control's ``lanes`` gap for one seed, beside the limit."""
    from . import program

    traffic, sweep = cell.traffic, cell.traffic["sweep"]
    cands = traffic["candidates"]
    arrays = RI.network_arrays(cell.config)
    x = RI.network_input(cell.config)
    refs = check.reference_plans(cell.config, arrays, x, cands,
                                 bool(traffic.get("capacities")))
    seeds = [program.call_seed(seed, i) for i in range(calls)]
    picks = check.sample_lanes(seed, calls, program.n_groups(traffic),
                               sweep["n_devices"],
                               traffic["check"]["lanes_per_candidate"], [],
                               sweep.get("lane_chunk"))
    closed = not check.charge_wise(sweep, len(cands))
    t = time.perf_counter()
    want = check.replay_reference(traffic, refs, seeds, picks)
    got = check.replay_reference(traffic, refs, seeds, picks,
                                 precision="float32")
    g = max(check.lane_gap(a, b, closed) for a, b in zip(got, want))
    return {"workload": cell.name, "seed": seed, "lanes": g,
            "limit": traffic["limits"]["lanes"], "lanes_checked": len(picks),
            "seconds": time.perf_counter() - t}


def main(cell, seeds, argv=()) -> int:
    """A line a seed (``argv``: ``--calls``, the calls of a run the picks
    spread over); 1 if a seed's control would pass the check."""
    ap = argparse.ArgumentParser(prog="perfbench/control.py")
    ap.add_argument("--calls", type=int, default=4,
                    help="calls of a run the picks spread over")
    args = ap.parse_args(list(argv))
    failed = 0
    for s in seeds:
        r = reading(cell, s, args.calls)
        r["control_fails"] = r["lanes"] > r["limit"]
        failed += not r["control_fails"]
        print(json.dumps(r), flush=True)
    return 1 if failed else 0
