"""Host milliseconds a decode step took: the engine's ``_decode`` (one
``decode_step`` of the batch, prefill and re-prefill included), wrapped
from outside, over the window's steps (all untraced).  The engine reads
each served token back (``.cpu()``), so a generation step's wait for the
card falls in the step after it."""


def read(run):
    if run.host is None or not run.steps:
        return None
    return run.host["decode"] * 1e3 / run.steps
