"""Seconds from the process's start to the first timed call: imports, the
CUDA context, the kernels' libraries (their build where the checkout has
none), the plan builds and one warm-up call (host clock)."""


def read(run):
    return run.setup_s
