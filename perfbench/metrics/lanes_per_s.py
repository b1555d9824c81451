"""Simulated devices replayed and folded per second: every lane of every
call of the window over the time from the first call's start to the last
call's end (host clock; each call ends in a device synchronisation)."""


def read(run):
    calls = run.calls
    span = calls[-1]["t1"] - calls[0]["t0"]
    return sum(c["lanes"] for c in calls) / span
