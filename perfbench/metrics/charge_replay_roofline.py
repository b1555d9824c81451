"""The lane kernel's share of its roofline in the traced call: the least
time the card could take (``peaks.replay_bound_s``: one event a real row at
``MIN_F64_OPS_PER_EVENT`` f64 operations over the FP64 peak, or each real
row and each lane's inputs and outputs moved once over HBM bandwidth,
whichever is longer) over the kernel's device time in the trace, in %."""


def read(run):
    if run.trace is None or not run.traced["charge_wise"]:
        return None
    n, s = run.trace_module.kernel_time(
        run.trace, lambda name: run.trace_module.LANE_KERNEL in name)
    if not n:
        return None
    w = run.traced
    bound, _by, _info = run.peaks.replay_bound_s(
        w["lane_rows"], w["table_values"], w["lanes"], w["lane_bytes"])
    return 100.0 * bound / s
