"""The share of the traced call in which no operation ran on the device:
one less the union of the device's busy intervals over the call, in %.
Only where the profiler leaves the call's pace as it is: a call of a few
large kernels, not one of millions of small ones, whose records the
profiler keeps on the host while they run."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
