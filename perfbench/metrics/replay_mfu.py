"""The window's share of the FP64 peak: the floor on the f64 operations of
every call of the window (one event a real row and lane at
``MIN_F64_OPS_PER_EVENT`` where the program replays charge by charge, a
real row and lane at ``MIN_F64_OPS_PER_ROW_CLOSED_FORM`` in the closed
form) over the time from the first call's start to the last call's end
(host clock: the window runs untraced, before the traced call), over
34 TFLOP/s, in %.  Read in a run that traced the card."""


def read(run):
    if run.trace is None:
        return None
    w, p = run.traced, run.peaks
    per = p.MIN_F64_OPS_PER_EVENT if w["charge_wise"] \
        else p.MIN_F64_OPS_PER_ROW_CLOSED_FORM
    calls = run.calls
    span = calls[-1]["t1"] - calls[0]["t0"]
    return 100.0 * len(calls) * w["lane_rows"] * per / span / p.PEAK_F64_OPS
