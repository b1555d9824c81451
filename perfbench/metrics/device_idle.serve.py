"""The share of the window's time in which no operation ran on the card,
in %: one less the card's busy seconds a decode step (the union of the
device's busy intervals over the traced call, over its steps) over the
window's host seconds a step (the first call's start to the last call's
end, over the window's steps).  The traced call serves a batch of the
window's mix (the same steps and kernels); the profiler slows its host,
not its kernels, so the card's busy time is read there and the time a
step takes where nothing traces it."""


def read(run):
    if run.trace is None or not run.traced_steps or not run.steps:
        return None
    calls = run.calls
    step_s = (calls[-1]["t1"] - calls[0]["t0"]) / run.steps
    busy = run.trace["busy_s"] / run.traced_steps
    return 100.0 * (1.0 - busy / step_s)
