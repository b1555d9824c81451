"""The lanes the check replays, the processes it replays them in, and the
warm-up call: at the cells' own sizes where nothing runs, small where the
oracle or the program does."""

import pytest

from perfbench_support import CELLS, cpu_run, find_cell, tiny_cell
from fleetbench import check, program
from fleetref import inputs as RI

from repro_torch.core import fleetsim


@pytest.mark.parametrize("workload", CELLS)
def test_sample_covers_every_block_and_chunk(workload):
    cell = find_cell(workload)
    sw, tr = cell.traffic["sweep"], cell.traffic
    n_cand, n_dev = program.n_groups(tr), sw["n_devices"]
    n_lanes, chunk = n_cand * n_dev, sw.get("lane_chunk")
    longest = [p * n_dev + 3 for p in range(n_cand)]
    picks = check.sample_lanes(2**33 + 5, 6, n_cand, n_dev,
                               tr["check"]["lanes_per_candidate"], longest,
                               chunk)
    assert len(picks) == len(set(picks)) >= 200
    assert all(0 <= c < 6 and 0 <= lane < n_lanes for c, lane in picks)
    assert {(5, lane) for lane in longest} <= set(picks)
    for p in range(n_cand):
        assert sum(p * n_dev <= lane < (p + 1) * n_dev
                   for _c, lane in picks) >= tr["check"]["lanes_per_candidate"]
    # one call holds the ends of every candidate's block and chunk, and a
    # lane of every STRATUM lanes
    by_call = {}
    for c, lane in picks:
        by_call.setdefault(c, set()).add(lane)
    ends = {p * n_dev for p in range(n_cand)} \
        | {(p + 1) * n_dev - 1 for p in range(n_cand)}
    if chunk:
        ends |= set(range(0, n_lanes, chunk)) \
            | {lo + chunk - 1 for lo in range(0, n_lanes, chunk)}
    strata = set(range(n_lanes // check.STRATUM))
    assert any(ends <= lanes and strata <= {lane // check.STRATUM
                                            for lane in lanes}
               for lanes in by_call.values())
    assert picks == check.sample_lanes(2**33 + 5, 6, n_cand, n_dev,
                                       tr["check"]["lanes_per_candidate"],
                                       longest, chunk)


def test_pooled_replays_match_this_process():
    cell = tiny_cell("har.design-space")
    arrays = RI.network_arrays(cell.config)
    x = RI.network_input(cell.config)
    refs = check.reference_plans(cell.config, arrays, x,
                                 cell.traffic["candidates"])
    seeds = [program.call_seed(2**35 + 1, i) for i in range(2)]
    picks = check.sample_lanes(9, 2, len(refs),
                               cell.traffic["sweep"]["n_devices"], 1, [])
    here = check.replay_reference(cell.traffic, refs, seeds, picks,
                                  workers=1)
    pooled = check.replay_reference(cell.traffic, refs, seeds, picks,
                                    workers=2)
    assert len(here) == len(pooled) == len(picks)
    for a, b in zip(here, pooled):
        assert check.lane_gap(a, b, False) == 0.0


def test_warm_up_is_one_chunk(monkeypatch):
    cell = tiny_cell("mnist.stats-query")
    sweep = cell.traffic["sweep"]
    sizes = []
    real = fleetsim.fleet_sweep

    def sweep_call(*a, **k):
        sizes.append(k["n_devices"])
        return real(*a, **k)

    monkeypatch.setattr(fleetsim, "fleet_sweep", sweep_call)
    rc, _lines, err = cpu_run(cell)
    assert rc == 0, err
    assert sizes[0] == sweep["lane_chunk"]
    assert len(sizes) >= 2 and set(sizes[1:]) == {sweep["n_devices"]}
