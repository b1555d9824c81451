"""Vectorized resumable inner loops.

The paper's loop continuation persists a cursor per *iteration*; simulating
DNN inference at one Python call per MAC would be intractable, so the
simulator executes energy-affordable *chunks* of iterations with a single
numpy operation while charging the device the exact per-iteration cost
(including the per-iteration cursor FRAM write, which Fig. 12 shows is 14% of
SONIC's energy).  The chunk boundary is wherever the charge runs out, so
failure points are energy-accurate; the boundary iteration simply re-runs
(idempotent body), matching loop-continuation semantics.  Protocol-level torn
states (mid-iteration interleavings) are exercised exhaustively by the
fine-grained unit tests in ``tests/test_idempotence.py``.
"""

from __future__ import annotations

import math
from typing import Callable

from .energy import Device
from .nvstore import NVStore


def per_iter_cycles(device: Device, costs: dict[str, float]) -> float:
    return sum(getattr(device.costs, op) * n for op, n in costs.items())


def charge_bulk(device: Device, costs: dict[str, float], iters: int) -> None:
    for op, n in costs.items():
        device.charge(op, n * iters)


def resumable_vec_loop(
    nv: NVStore,
    device: Device,
    cursor: str,
    n: int,
    iter_costs: dict[str, float],
    apply_range: Callable[[int, int], None],
    recover: Callable[[], None] | None = None,
) -> None:
    """Run ``apply_range(lo, hi)`` over [cursor, n) in affordable chunks.

    ``iter_costs`` maps op class -> count per iteration and must already
    include the cursor-update FRAM write if the strategy persists one.
    ``apply_range`` must be idempotent over its range.
    """
    if cursor not in nv:
        nv.write_scalar(cursor, 0)
    if recover is not None:
        recover()
    cyc = per_iter_cycles(device, iter_costs)
    while True:
        i = int(nv.raw(cursor))
        if i >= n:
            return
        if math.isinf(device.remaining):
            affordable = n - i
        else:
            affordable = min(n - i, int(device.remaining // max(cyc, 1e-9)))
        if affordable <= 0:
            device.drain()  # raises PowerFailure; cursor still == i
        apply_range(i, i + affordable)
        charge_bulk(device, iter_costs, affordable)
        # Cursor word itself is atomic; its write energy is in iter_costs.
        # Chunks always complete by construction, so cursor granularity is
        # exactly per-chunk == energy-boundary == loop-continuation semantics.
        nv.write_scalar(cursor, i + affordable)


def fresh_cursor(nv: NVStore, cursor: str) -> None:
    nv.write_scalar(cursor, 0)
