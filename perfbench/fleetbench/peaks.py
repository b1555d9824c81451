"""The yardstick's peaks and floors, fixed here whatever implements the work.

Copied from ``chip_smoke.py`` at commit f60fe63 (``PEAK_F64_OPS``,
``PEAK_BYTES``, ``MIN_F64_OPS_PER_EVENT`` and the arithmetic of
``replay_bound_ms``), with the counts taken from the cell's real plan rows
instead of the launch's padded tensors: one event a real row, each real row
read once, each lane's inputs read and outputs written once.
"""

from __future__ import annotations

#: H100 SXM peaks (NVIDIA data sheet): FP64 outside the tensor cores, and
#: HBM3 bandwidth.
PEAK_F64_OPS = 34e12
PEAK_BYTES = 3.35e12

#: The op classes of a row's class vectors (the plan's ``iter_class``).
N_CLASSES = 17

#: A floor on the f64 operations of one lane-kernel event, counted from
#: csrc/charge_replay.cu: the row context (~12), the phase-0 and row-phase
#: scalar arithmetic of charge_once (~60) and the 17-wide class update (at
#: least 4 operations per class).  Every row costs at least one event.
MIN_F64_OPS_PER_EVENT = 12 + 60 + 4 * N_CLASSES

#: A floor on the f64 operations of one lane and row of the closed-form
#: scan, counted from the reference's row step (``fleetref/oracle.py``, a
#: row that finishes in the charge it starts in, the least a row can do):
#: the class update, five per class (``left * iter``, ``commits * commit``,
#: the two adds into the entry vector and the add into the carry), and nine
#: scalar operations (``needed = e + left * c``: 2; the finish test: 1; the
#: remaining charge, live cycles and charge spent: 3; the dead time, ``(r1 -
#: r0) * tail`` added to the carry: 3).
MIN_F64_OPS_PER_ROW_CLOSED_FORM = 5 * N_CLASSES + 9

#: Bytes of one lane's replay outputs: nine f64 scalars (live, reboots,
#: dead, wasted, remaining charge, belief and the three uplink channels),
#: the f64 class vector and the bool ``stuck`` (``fleetsim._lane_io_bytes``).
LANE_OUT_BYTES = 8 * (9 + N_CLASSES) + 1

#: The per-lane f64 channels the statistics fold reads besides the class
#: vector (``kernels/stats_fold.LANE_KEYS``).
FOLD_LANE_KEYS = 8
#: The statistics channels the fold reduces (``fleetstats.STAT_CHANNELS``).
FOLD_CHANNELS = 10


def lane_in_bytes(trace_reboots: int, charge_columns: int) -> int:
    """Bytes of one lane's replay inputs: five f64 scalars (capacity, initial
    charge, tail, nominal-from index, confidence), two int32 (real rows,
    plan index), the recharge table (``trace_reboots + 1`` f64, one column
    without a trace) and the charge table (``charge_columns`` f64)."""
    return 8 * 5 + 4 * 2 + 8 * (trace_reboots + 1) + 8 * charge_columns


def replay_bound_s(lane_rows: int, table_values: int, lanes: int,
                   lane_bytes: int) -> tuple[float, str, dict]:
    """The least time the card could take for a lane-kernel replay:
    ``lane_rows`` real rows summed over lanes (one event each, at
    ``MIN_F64_OPS_PER_EVENT``), ``table_values`` f64 values of the real row
    tables read once, ``lanes`` lanes' inputs and outputs
    (``lane_bytes`` each) once."""
    ops = lane_rows * MIN_F64_OPS_PER_EVENT
    nbytes = table_values * 8 + lanes * lane_bytes
    t_ops, t_bytes = ops / PEAK_F64_OPS, nbytes / PEAK_BYTES
    info = dict(f64_ops=ops, bytes=nbytes, ops_s=t_ops, bytes_s=t_bytes)
    if t_ops >= t_bytes:
        return t_ops, "operations", info
    return t_bytes, "bytes", info


def fold_bytes(lanes: int, n_groups: int, bins: int) -> int:
    """Bytes a statistics fold of ``lanes`` lanes must move: each lane's
    f64 channels and class vector, its ``stuck`` and ``valid`` flags and its
    int32 group read once, the edges read once, and the partial (count,
    completed, class sums, and sum, sum of squares, min, max and ``bins``
    histogram counts a channel, per group) written once."""
    per_lane = 8 * (FOLD_LANE_KEYS + N_CLASSES) + 1 + 1 + 4
    edges = FOLD_CHANNELS * (bins + 1) * 8
    out = n_groups * (2 + N_CLASSES + FOLD_CHANNELS * (4 + bins)) * 8
    return lanes * per_lane + edges + out
