"""Served tokens completed per second: every token the window's calls
served, each once (a preempted request's re-prefilled tokens are not
served again), over the time from the first call's start to the last
call's end (host clock; each call ends in a device synchronisation)."""


def read(run):
    calls = run.calls
    span = calls[-1]["t1"] - calls[0]["t0"]
    return sum(c["tokens"] for c in calls) / span
