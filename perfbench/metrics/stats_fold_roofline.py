"""The statistics fold's share of its roofline in the traced call: the
bytes it must move (``peaks.fold_bytes``: each lane's channels read once,
each partial written once) over HBM bandwidth, over the fold kernels'
device time in the trace, in %."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace_module
    n, s = t.kernel_time(run.trace,
                         lambda name: any(k in name for k in t.FOLD_KERNELS))
    if not n:
        return None
    w = run.traced
    nbytes = sum(run.peaks.fold_bytes(w["fold_lanes"] // w["folds"],
                                      w["n_groups"], w["bins"])
                 for _ in range(w["folds"]))
    return 100.0 * nbytes / run.peaks.PEAK_BYTES / s
