"""Device kernels a decode step launches in the traced call: every device
event of the call that is not a copy or a fill, over the call's decode
steps."""


def read(run):
    if run.trace is None or not run.traced_steps:
        return None
    t = run.trace_module
    n = sum(c for name, (c, _s) in run.trace["kernels"].items()
            if not t.is_copy(name))
    return n / run.traced_steps if n else None
