"""The system under test: ``repro_torch``'s plan build and fleet replay,
driven by one traffic mix.

A mix (``perfbench/traffic/<name>.json``) names its candidates (strategy
and power system each) and the keyword arguments of ``fleet_sweep``.  One
candidate replays as a ``FleetPlan``; several as one ``PlanSet``, a design
sweep.  A mix that names ``capacities`` builds its one candidate's plan
parametric and replays it over that grid of capacitors (``capacitor_sweep``:
every lane calibrates its own TAILS tile).  Every call is a fresh fleet drawn
from its own seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: Strategies whose rows depend on the capacitor (TAILS's calibration
#: burns); the others are built once and restamped to each power system.
POWER_DEPENDENT = ("tails",)


def call_seed(seed: int, i: int) -> int:
    """The fleet seed of call ``i`` of a run (``-1``: the warm-up), a
    non-negative 62-bit integer drawn from ``(seed, i)``."""
    ss = np.random.SeedSequence([seed % 2**64, i + 1])
    lo, hi = (int(v) for v in ss.generate_state(2, np.uint32))
    return (hi << 32 | lo) >> 2


def n_groups(traffic: dict) -> int:
    """The statistics groups of a call: one a capacitor of a capacitor
    sweep, else one a candidate."""
    return len(traffic.get("capacities") or traffic["candidates"])


def build_plans(fleetsim, make_power_system, net, x, candidates,
                parametric: bool = False) -> list:
    """The program's plans, in the mix's order: TAILS built for each power
    system (sharing its continuous-power reference run; ``parametric``
    for a capacitor sweep), the rest built once and restamped with each
    capacitor."""
    plans, built, refs = [], {}, {}
    for c in candidates:
        s, power = c["strategy"], c["power"]
        if s in POWER_DEPENDENT:
            p = fleetsim.build_plan(net, x, s, power, ref=refs.get(s),
                                    parametric=parametric)
            refs[s] = (p.ref_output, p.max_atomic)
        elif s not in built:
            p = built[s] = fleetsim.build_plan(net, x, s, power)
        else:
            ps = make_power_system(power)
            p = dataclasses.replace(built[s], power=ps.name,
                                    recharge_s=ps.recharge_s,
                                    capacity=ps.cycles_per_charge)
        plans.append(p)
    return plans


def sweep_target(fleetsim, plans, network: str):
    if len(plans) == 1:
        return plans[0]
    labels = [f"{network}/{p.strategy}/{p.power}" for p in plans]
    return fleetsim.PlanSet.from_plans(plans, labels=labels)


class Capture:
    """Stands in for ``fleetsim.reduce_lane_outputs`` while the program
    runs: keeps each fold's inputs (the replay's per-lane outputs, groups,
    mask) and its partial, by call, so they can be judged once the window
    has closed.  It holds references and copies nothing."""

    def __init__(self, fn):
        self.fn = fn
        self.calls: list[list[dict]] = []

    def new_call(self) -> None:
        self.calls.append([])

    def __call__(self, out, group_id, valid, edges, n_groups):
        part = self.fn(out, group_id, valid, edges, n_groups)
        self.calls[-1].append(dict(out=out, gid=group_id, valid=valid,
                                   n_groups=n_groups, part=part))
        return part


def host_calls(capture: Capture) -> list[list[dict]]:
    """Every captured fold as numpy arrays (the device tensors dropped)."""
    import torch

    def host(v):
        return v.cpu().numpy() if torch.is_tensor(v) else v

    out = []
    for chunks in capture.calls:
        out.append([dict(out={k: host(v) for k, v in c["out"].items()},
                         gid=host(c["gid"]), valid=host(c["valid"]),
                         n_groups=c["n_groups"],
                         part=tuple({k: host(v) for k, v in d.items()}
                                    for d in c["part"]))
                    for c in chunks])
    capture.calls = []
    return out
