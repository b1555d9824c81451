"""Host seconds by layer while the window runs.

A copy of ``chip_smoke.HostTimer`` (``chip_smoke.py``, class ``HostTimer``,
at commit f60fe63), frozen here so the yardstick does not move with the
program.  It wraps named module functions for the ``with`` block and
times every call's wall seconds (``perf_counter``), on whichever thread
runs it (the caller's, or the pipeline's ``fleetsim-prefetch``
producer).  Two changes: each function belongs to a layer, and a call's
seconds minus those of the wrapped calls nested in it (its self time) go
to its layer, so a layer's total counts no nested layer's time twice; and
while ``annotate`` is set each call also opens a profiler range named
``perfbench:<function>``, so a trace can say what the host was doing in a
gap of the device.
"""

from __future__ import annotations

import threading
import time

#: Functions of the replay entry layer (``repro_torch.core.fleetsim``).
ENTRY = ("fleet_sweep", "_design_sweep", "_chunked_replay",
         "_overlapped_replay", "_run_replay", "_prepare", "_bucket_rows",
         "_upload", "_chunk_tensors", "_device_rows", "_stats_inputs",
         "_dispatch", "merge_parts")
#: The samplers (``repro_torch.runtime.failures``): ``HostTimer.FAILURES``
#: and the legacy draws.
SAMPLERS = ("initial_charge_fraction_stream", "harvest_jitter_stream",
            "reboot_recharge_times_stream", "charge_capacity_jitter_stream",
            "charge_trace_cumulative", "recharge_trace_cumulative",
            "pad_charge_trace_columns", "charge_trace_nominal_from",
            "initial_charge_fraction", "harvest_jitter",
            "reboot_recharge_times", "charge_capacity_jitter",
            "inference_confidence", "inference_confidence_stream")


class HostTimer:
    """``layers`` maps a layer name to ``[(module, function name), ...]``."""

    def __init__(self, layers: dict):
        self.local = threading.local()
        self.lock = threading.Lock()
        self.names = [(layer, mod, n) for layer, fns in layers.items()
                      for mod, n in fns]
        self.saved = []
        self.annotate = False
        self.layer_s = {layer: 0.0 for layer in layers}

    def wrap(self, fn, name, layer):
        def run(*a, **k):
            stack = getattr(self.local, "stack", None)
            if stack is None:
                stack = self.local.stack = []
            stack.append(0.0)               # nested wrapped seconds
            rf = None
            if self.annotate:
                import torch
                rf = torch.profiler.record_function(f"perfbench:{name}")
                rf.__enter__()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t
                if rf is not None:
                    rf.__exit__(None, None, None)
                nested = stack.pop()
                if stack:
                    stack[-1] += dt
                with self.lock:
                    self.layer_s[layer] += dt - nested
        return run

    def __enter__(self):
        self.saved = [(mod, n, getattr(mod, n)) for _l, mod, n in self.names]
        for (layer, mod, n), (_m, _n, fn) in zip(self.names, self.saved):
            setattr(mod, n, self.wrap(fn, n, layer))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in self.saved:
            setattr(mod, n, fn)
