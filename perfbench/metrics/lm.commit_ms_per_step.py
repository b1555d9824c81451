"""Host milliseconds of cursor commits a decode step: every
``Cursor.commit`` of the window (a request's submission and its
loop-continuation write after each served token, an atomic file write
each), wrapped from outside, over the window's decode steps."""


def read(run):
    if run.host is None or not run.steps:
        return None
    return run.host["commit"] * 1e3 / run.steps
