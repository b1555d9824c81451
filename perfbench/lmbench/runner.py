"""One run of one language-model cell: set-up, the measured window, the
check, the line (``benchcore.core.main`` hands a configuration of
``kind`` ``"lm"`` here).

Set-up makes the weights from the seed, builds nothing else the program
does not build itself, and serves one warm-up call; then calls back to
back until ``--seconds`` have passed (the last starting before), each a
fresh batch from its own seed in a fresh state directory under the
checkout's ``build/``; with ``--trace 1`` the host timer runs through the
window and one more call, traced by the profiler, follows it.
"""

from __future__ import annotations

import importlib
import time
from pathlib import Path
from types import SimpleNamespace

from benchcore import spec, trace
from benchcore.core import card, emit, finish, start_trace, stop_trace
# ``tests/test_torch_spans.py`` loads the host timer from this path
from fleetbench import hosttimer

from . import check, peaks, program

#: Where a family's plain reference is found: ``<LMREF>/<family>.py``.
LMREF = spec.HERE / "lmref"


class Run:
    """``device="cpu"`` drives the same run on the CPU (tests);
    ``preloaded`` names forbidden modules a shared process held before the
    run began; ``lmref`` is the directory of the families' references and
    ``state`` the engines' (by default ``build/lm_state/<cell>`` in the
    checkout)."""

    def __init__(self, cell, args, t_start: float, device: str = "cuda",
                 preloaded=(), lmref=LMREF, state=None):
        self.cell, self.args, self.t_start = cell, args, t_start
        self.device = device
        self.preloaded = set(preloaded)
        self.lmref = lmref
        self.state = Path(state) if state else \
            spec.ROOT / "build" / "lm_state" / cell.name

    def load_program(self):
        self.configs = importlib.import_module("repro_torch.configs")
        self.api = importlib.import_module("repro_torch.models.api")
        self.engine = importlib.import_module("repro_torch.serving.engine")
        self.store = importlib.import_module("repro_torch.checkpoint.store")

    def setup(self, seed: int):
        """The program's modules, the family's reference, the port's
        configuration (checked against the file) and the weights drawn
        from ``seed``: ``(ref, port, params, device)``."""
        import torch

        cfg = self.cell.config
        self.load_program()
        ref = program.reference(cfg["family"], self.lmref)
        port = program.port_config(self.configs, cfg)
        program.check_shapes(ref, cfg, self.api.param_shapes(port))
        dev = torch.device(self.device)
        params = program.make_weights(torch, ref, cfg, seed, dev,
                                      getattr(torch, port.param_dtype))
        return ref, port, params, dev

    def requests(self, mix: dict, seed: int, i: int):
        """Call ``i``'s prompts and answer lengths."""
        return program.call_requests(mix, self.cell.config["vocab_size"],
                                     seed, i)

    def serve(self, port, params, mix: dict, batch, preempt: bool = True):
        """``batch`` (prompts, answer lengths) served: ``{rid: tokens}``."""
        return program.serve(self.engine.ServeEngine, self.engine.Request,
                             port, params, mix, *batch, self.state, preempt)

    def execute(self) -> int:
        import torch

        cell, args, traffic = self.cell, self.args, self.cell.traffic
        ref, port, params, dev = self.setup(args.seed)
        cuda = dev.type == "cuda"
        sync = torch.cuda.synchronize if cuda else (lambda: None)

        def call(batch, mix=traffic, preempt=True):
            out = self.serve(port, params, mix, batch, preempt)
            sync()
            return out

        with program.captured(self.engine.ServeEngine) as capture:
            window = self.window(call, capture, program.warm_traffic(traffic))
        mem_peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
        calls, summary, setup_s, host_s = (window[k] for k in (
            "calls", "summary", "setup_s", "host_s"))
        steps = sum(c["steps"] for c in calls)
        info = SimpleNamespace(
            setup_s=setup_s, calls=calls, trace=summary, steps=steps,
            host=host_s, traced_steps=window["traced_steps"],
            call_flops=peaks.call_flops(ref, cell.config, traffic),
            peaks=peaks, trace_module=trace)
        metrics = {}
        for m in cell.metrics:
            v = spec.reader(m["name"])(info)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        emit({"calls": len(calls), "steps": steps,
              "tokens": sum(c["tokens"] for c in calls),
              "call_s": [c["t1"] - c["t0"] for c in calls],
              "setup_s": setup_s, "card": card() if cuda else "cpu"})

        resumed, resume_s = None, 0.0
        if traffic.get("fail_after_tokens"):
            t = time.perf_counter()
            resumed = call((window["ids"][-1], window["answers"][-1]),
                           preempt=False)
            resume_s = time.perf_counter() - t
        if cuda:
            torch.cuda.empty_cache()
        t = time.perf_counter()
        correct, checks, n_checked, failed = check.judge(
            torch, ref, cell, params, window, resumed, args.seed, dev)
        emit({"resume_s": resume_s, "reference_s": time.perf_counter() - t,
              "requests_checked": n_checked})
        self.clear_state()

        attempted = traffic["requests"] * (len(calls) + bool(summary))
        return finish(self, correct, attempted, failed, metrics, checks,
                      mem_peak, summary, cuda)

    def clear_state(self) -> None:
        import shutil
        if self.state.exists():
            shutil.rmtree(self.state)

    def timer_layers(self) -> dict:
        return {"decode": [(self.engine.ServeEngine, "_decode")],
                "commit": [(self.store.Cursor, "commit")]}

    def window(self, call, capture, warm: dict) -> dict:
        """The warm-up call, then calls until ``--seconds`` have passed;
        the last window call's steps stay captured, of its
        ``check.logit_rows`` requests.  With ``--trace 1`` the host timer
        runs through the window and one traced call follows it (its steps
        not captured)."""
        args, traffic = self.args, self.cell.traffic
        n_rows = traffic["check"]["logit_rows"]
        capture.new_call(keep=False)
        call(self.requests(warm, args.seed, -1), warm)
        timer = None
        if args.trace:
            timer = hosttimer.HostTimer(self.timer_layers()).__enter__()
        try:
            setup_s = time.perf_counter() - self.t_start
            calls, ids, answers, served = [], [], [], []
            w0 = time.perf_counter()
            i = 0
            while True:
                batch = self.requests(traffic, args.seed, i)
                rows = program.logit_rows(batch[1], args.seed, i, n_rows)
                capture.new_call(rows=rows)
                s0 = capture.steps
                c0 = time.perf_counter()
                out = call(batch)
                c1 = time.perf_counter()
                calls.append(dict(t0=c0, t1=c1, steps=capture.steps - s0,
                                  tokens=sum(map(len, out.values()))))
                ids.append(batch[0])
                answers.append(batch[1])
                served.append(out)
                i += 1
                if time.perf_counter() - w0 >= args.seconds:
                    break
            captured = capture.call
            host_s = None if timer is None else dict(timer.layer_s)
            summary, traced_steps = None, 0
            if args.trace and self.device == "cuda":
                batch = self.requests(traffic, args.seed, i)
                capture.new_call(keep=False)
                s0 = capture.steps
                prof, rng = start_trace(timer)
                call(batch)
                events = stop_trace(prof, rng, timer)
                del prof
                traced_steps = capture.steps - s0
                t = time.perf_counter()
                summary = trace.summarize(events)
                del events
                emit({"trace_read_s": time.perf_counter() - t})
        finally:
            if timer is not None:
                timer.__exit__(None, None, None)
        return dict(calls=calls, ids=ids, answers=answers, served=served,
                    captured=captured, rows=rows, setup_s=setup_s,
                    host_s=host_s, summary=summary,
                    traced_steps=traced_steps)
