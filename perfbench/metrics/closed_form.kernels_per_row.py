"""Device kernels a replayed row of the closed-form scan launches in the
traced call: every kernel that is neither the lane kernel nor the fold,
counted, over the rows replayed (the plan's rows times the chunks)."""


def read(run):
    w = run.traced
    if run.trace is None or w["charge_wise"] or not w["rows_replayed"]:
        return None
    t = run.trace_module
    n, _s = t.kernel_time(run.trace, t.is_other_kernel)
    if not n:
        return None
    return n / w["rows_replayed"]
