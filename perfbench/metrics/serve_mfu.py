"""The window's share of the card's dense bf16 peak: the model FLOPs of
every request the window served (``lmbench/peaks.call_flops``: 2 N a fed
position, N every parameter a token touches, and the attention term;
neither re-prefill nor a finished request's row counted) over the time
from the first call's start to the last call's end (host clock: the
window runs untraced, before the traced call), over 989 TFLOP/s, in %.
Read in a run that traced the card."""


def read(run):
    if run.trace is None:
        return None
    calls = run.calls
    span = calls[-1]["t1"] - calls[0]["t0"]
    flops = run.call_flops * len(calls)
    return 100.0 * flops / span / run.peaks.PEAK_BF16_FLOPS
