"""One run of one fleet cell: set-up, the measured window, the check, the
line (``benchcore.core.main`` hands a configuration without a ``kind``
here)."""

from __future__ import annotations

import importlib
import time
from types import SimpleNamespace

from benchcore import spec, trace
from benchcore.core import card, emit, finish, start_trace, stop_trace

from . import check, hosttimer, kernels, peaks, program


class Run:
    """``device="cpu"`` drives the same run on the CPU (the program's plain
    versions, no trace), as the harness's tests do; ``preloaded`` names
    forbidden modules that a process shared with other code (a test
    worker) held before the run began, which the run did not load."""

    def __init__(self, cell, args, t_start: float, device: str = "cuda",
                 preloaded=()):
        self.cell, self.args, self.t_start = cell, args, t_start
        self.device = device
        self.preloaded = set(preloaded)
        self.closed_form_replays = 0
        self.traffic = cell.traffic
        self.sweep = dict(cell.traffic["sweep"])

    # -- the program's modules --------------------------------------------
    def load_program(self):
        self.fleetsim = importlib.import_module("repro_torch.core.fleetsim")
        self.inference = importlib.import_module("repro_torch.core.inference")
        self.energy = importlib.import_module("repro_torch.core.energy")
        self.failures = importlib.import_module("repro_torch.runtime.failures")
        self.cr = importlib.import_module("repro_torch.kernels.charge_replay")
        self.sf = importlib.import_module("repro_torch.kernels.stats_fold")
        # the wrappers count their launches on these (``_wrapper``), even
        # while something stands in for them
        self.lane_kernel = self.cr._wrapper
        self.fold_kernel = self.sf._wrapper

    def timer_layers(self) -> dict:
        fs, fl = self.fleetsim, self.failures
        return {"entry": [(fs, n) for n in hosttimer.ENTRY],
                "samplers": [(fl, n) for n in hosttimer.SAMPLERS],
                "closed_form": [(fs, "_scan_replay")],
                "lane_kernel": [(self.cr, "charge_replay")],
                "stats_fold": [(fs, "reduce_lane_outputs")],
                "device_wait": [(fs, "parts_numpy")]}

    def zero_counts(self) -> None:
        k = self.lane_kernel
        k.launches = 0
        for d in (k.launches_by_design, k.launches_by_mode):
            for key in d:
                d[key] = 0
        self.fold_kernel.launches = 0
        self.closed_form_replays = 0

    def path_counts(self) -> dict:
        k = self.lane_kernel
        return {"charge_replay.launches": k.launches,
                "charge_replay.launches_by_mode": dict(k.launches_by_mode),
                "charge_replay.launches_by_design":
                    dict(k.launches_by_design),
                "stats_fold.launches": self.fold_kernel.launches,
                "closed_form.replays": self.closed_form_replays}

    # -- the run -------------------------------------------------------------
    def execute(self) -> int:
        import torch

        from fleetref import inputs as RI

        cell, args = self.cell, self.args
        self.load_program()
        fs = self.fleetsim
        cfg = cell.config
        arrays = RI.network_arrays(cfg)
        x = RI.network_input(cfg)
        net = RI.build_net(cfg, arrays, self.inference)
        caps = self.traffic.get("capacities")
        t0 = time.perf_counter()
        plans = program.build_plans(fs, self.energy.make_power_system, net,
                                    x, self.traffic["candidates"],
                                    parametric=bool(caps))
        target = program.sweep_target(fs, plans, cfg["network"])
        plan_build_s = time.perf_counter() - t0

        cuda = self.device == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)

        def call(seed, **over):
            kw = {**self.sweep, **over}
            if caps:
                return fs.capacitor_sweep(net, x, caps, plan=target,
                                          seed=seed, device=self.device, **kw)
            return fs.fleet_sweep(plan=target, seed=seed, device=self.device,
                                  **kw)

        capture = program.Capture(fs.reduce_lane_outputs)
        scan = fs._scan_replay

        def counted_scan(*a, **k):
            self.closed_form_replays += 1
            return scan(*a, **k)

        fs.reduce_lane_outputs, fs._scan_replay = capture, counted_scan
        try:
            window = self.window(call, capture, sync, cuda)
        finally:
            fs.reduce_lane_outputs, fs._scan_replay = capture.fn, scan
        calls, answers, seeds, setup_s, host_s, events, mem_peak, \
            counts = window
        summary = None
        if args.trace and cuda:
            t = time.perf_counter()
            summary = trace.summarize(events)
            del events
            emit({"trace_read_s": time.perf_counter() - t})
        host_calls = program.host_calls(capture)

        lanes = self.sweep["n_devices"] * program.n_groups(self.traffic)
        for c in calls:
            c["lanes"] = lanes
        host = None if host_s is None else \
            {k: v / len(calls) for k, v in host_s.items()}
        info = SimpleNamespace(
            setup_s=setup_s, plan_build_s=plan_build_s, calls=calls,
            host=host, trace=summary,
            traced=self.traced_work(plans, host_calls[-1]), peaks=peaks,
            trace_module=kernels)
        metrics = {}
        for m in cell.metrics:
            v = spec.reader(m["name"])(info)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

        emit({"paths": counts, "calls": len(calls),
              "call_s": [c["t1"] - c["t0"] for c in calls],
              "plan_build_s": plan_build_s, "setup_s": setup_s,
              "card": card() if cuda else "cpu"})
        t = time.perf_counter()
        correct, checks, n_checked, failed = check.judge(
            cell, arrays, x, plans, answers, seeds, host_calls, args.seed)
        emit({"reference_s": time.perf_counter() - t,
              "lanes_checked": n_checked})

        return finish(self, correct, len(answers), failed, metrics, checks,
                      mem_peak, summary, cuda)

    def window(self, call, capture, sync, cuda):
        """The warm-up call (of one chunk where the mix streams its lanes
        in chunks: every chunk runs the same kernels and captures its own
        graphs), then calls back to back until ``--seconds`` have
        passed (the last starting before); with ``--trace 1`` the host
        timer runs through the window, and one more call, the traced one,
        follows it, so the profiler neither stretches the window nor
        lengthens the calls the host is timed over."""
        import torch

        args = self.args
        warm = {}
        if self.sweep.get("lane_chunk"):
            warm["n_devices"] = min(self.sweep["n_devices"],
                                    self.sweep["lane_chunk"])
        capture.new_call()
        call(program.call_seed(args.seed, -1), **warm)
        sync()
        capture.calls = []
        self.zero_counts()
        timer = None
        if args.trace:
            timer = hosttimer.HostTimer(self.timer_layers()).__enter__()
        try:
            setup_s = time.perf_counter() - self.t_start
            calls, answers, seeds = [], [], []
            host_s = events = None
            w0 = time.perf_counter()
            i = 0
            while True:
                s = program.call_seed(args.seed, i)
                capture.new_call()
                c0 = time.perf_counter()
                answers.append(call(s))
                sync()
                c1 = time.perf_counter()
                calls.append(dict(t0=c0, t1=c1, seed=s))
                seeds.append(s)
                i += 1
                if time.perf_counter() - w0 >= args.seconds:
                    break
            if timer is not None:
                host_s = dict(timer.layer_s)
            if args.trace and cuda:
                s = program.call_seed(args.seed, i)
                capture.new_call()
                prof, rng = start_trace(timer)
                answers.append(call(s))
                sync()
                t = time.perf_counter()
                events = stop_trace(prof, rng, timer)
                del prof
                emit({"trace_stop_s": time.perf_counter() - t})
                seeds.append(s)
        finally:
            if timer is not None:
                timer.__exit__(None, None, None)
        mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        return (calls, answers, seeds, setup_s, host_s, events, mem_peak,
                self.path_counts())

    def traced_work(self, plans, chunks: list[dict]) -> dict:
        """The work of one call (each is alike; ``chunks`` are the traced
        call's folds), counted from the real plan rows and the mix."""
        import numpy as np

        from fleetref.plan import ROW_FIELDS, TILE_FIELDS

        sw = self.sweep
        n_dev = sw["n_devices"]
        groups = program.n_groups(self.traffic)
        rows = [len(p) for p in plans]
        # a capacitor sweep replays its one plan in every group
        group_rows = rows * groups if self.traffic.get("capacities") \
            else rows
        width = [sum(int(np.prod(np.shape(getattr(p, k))[1:]))
                     for k in ROW_FIELDS + (TILE_FIELDS if p.parametric
                                            else ())) for p in plans]
        charge_wise = check.charge_wise(sw, len(plans))
        use_charge = (sw.get("charge_cv", 0) > 0
                      or sw.get("charge_bias_cv", 0) > 0
                      or sw.get("charge_reboots", 0) > 0)
        n_charges = sw.get("charge_reboots", 0) or (256 if use_charge else 8)
        charge_cols = n_charges + 1 if charge_wise else 1
        return dict(
            charge_wise=charge_wise, lanes=n_dev * groups,
            lane_rows=n_dev * sum(group_rows),
            table_values=sum(r * w for r, w in zip(rows, width)),
            lane_bytes=peaks.lane_in_bytes(sw.get("trace_reboots", 0),
                                           charge_cols)
            + peaks.LANE_OUT_BYTES,
            rows_replayed=len(chunks) * rows[0] if not charge_wise else 0,
            fold_lanes=sum(int(np.sum(c["valid"])) for c in chunks),
            folds=len(chunks), n_groups=groups,
            bins=sw.get("stats_bins", 64))

