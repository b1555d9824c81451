"""Elastic rescale policy: keep training as hosts come and go.

Checkpoints are mesh-agnostic (logical arrays; see checkpoint.store), so a
rescale is: drain -> checkpoint -> rebuild mesh on the available hosts ->
restore with new shardings -> resume at the loop-continuation cursor.  The
policy picks the largest valid (dp x tp) grid not exceeding the available
host count, keeping tp fixed (tp changes would reshard every weight).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MeshChoice:
    dp: int
    tp: int

    @property
    def hosts(self) -> int:
        return self.dp * self.tp


def choose_mesh(available_hosts: int, tp: int, min_dp: int = 1
                ) -> MeshChoice | None:
    dp = available_hosts // tp
    if dp < min_dp:
        return None
    return MeshChoice(dp, tp)


@dataclass
class ElasticEvent:
    t_s: float
    available: int


def simulate_elastic(events: list[ElasticEvent], tp: int, step_s: float,
                     rescale_s: float = 300.0, horizon_s: float = 1e6,
                     batch_per_dp: int = 1) -> dict:
    """Throughput (global batches/s aggregated) across availability events.

    Rescale only when the chosen mesh actually changes (hysteresis keeps
    single-host churn from thrashing).  A rescale is an *outage*: the new
    mesh produces nothing until ``rescale_s`` after the event (drain +
    checkpoint + rebuild + restore), tracked by advancing a ``ready_at``
    clock -- each wall-clock second is booked exactly once, as either
    productive (``work_s``) or idle, so ``work_s + idle_s == wall_s``.
    (An earlier version both added the outage to idle *and* subtracted its
    batch-equivalent from work, double-billing every rescale.)"""
    events = sorted(events, key=lambda e: e.t_s)
    cur = choose_mesh(events[0].available, tp)
    t = events[0].t_s
    ready_at = t
    work = 0.0      # global batches
    work_s = 0.0    # productive wall-clock
    idle = 0.0
    rescales = 0
    for nxt in events[1:] + [ElasticEvent(horizon_s, events[-1].available)]:
        span = nxt.t_s - t
        if cur is None:
            idle += span
        else:
            productive = max(nxt.t_s - max(t, ready_at), 0.0)
            work_s += productive
            idle += span - productive
            work += productive / step_s * cur.dp * batch_per_dp
        new = choose_mesh(nxt.available, tp)
        if (new is None) != (cur is None) or (
                new is not None and cur is not None and new.dp != cur.dp):
            rescales += 1
            if new is not None:
                ready_at = nxt.t_s + rescale_s
        cur = new
        t = nxt.t_s
    return {"batches": work, "idle_s": idle, "work_s": work_s,
            "wall_s": horizon_s - events[0].t_s, "rescales": rescales}
