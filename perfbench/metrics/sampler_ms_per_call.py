"""Host milliseconds a call spent in the samplers (``runtime.failures``'
draws and trace tables), caller and producer threads summed, over the
window's calls (all untraced)."""


def read(run):
    if run.host is None:
        return None
    return run.host["samplers"] * 1e3
