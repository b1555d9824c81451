"""Host milliseconds a call spent in the replay entry layer's own code
(``fleetsim``'s entry functions, caller and producer threads summed, less
the time in the samplers, the closed form, the kernels' wrappers and the
final wait for the device), over the window's calls (all untraced)."""


def read(run):
    if run.host is None:
        return None
    return run.host["entry"] * 1e3
