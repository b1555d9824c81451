"""Shared pieces of the benchmark's tests: the harness on the import path,
a tiny network in place of the configuration's, the cells' own traffic at
a few lanes, a tiny language model in place of the port's configuration,
and a run on the CPU with its output captured."""

from __future__ import annotations

import contextlib
import io
import json
import sys
import tempfile
import time
from pathlib import Path

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent
for p in (PERFBENCH, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from benchcore import core, spec  # noqa: E402
from fleetbench import runner  # noqa: E402

#: A network of the configurations' layer kinds with a few hundred rows a
#: plan, so a replay on the CPU takes well under a second.
TINY = {"name": "tiny", "network": "tiny", "input_shape": [1, 12, 12],
        "layers": [
            {"type": "conv", "name": "conv1", "out": 2, "in": 1, "kh": 3,
             "kw": 3},
            {"type": "pool", "kh": 2, "kw": 2},
            {"type": "fc", "name": "fc1", "out": 6, "in": 50, "relu": True},
            {"type": "fc", "name": "fc2", "out": 3, "in": 6,
             "relu": False}],
        "weights_seed": 0, "input_seed": 42}

#: A network whose TAILS plan outlasts a 1mF charge (711 rows, 1.28e6
#: cycles), so the closed form's lanes reboot and a lower precision shows.
TINY_REBOOTS = {"name": "tiny", "network": "tiny", "input_shape": [1, 64, 64],
                "layers": [
                    {"type": "conv", "name": "conv1", "out": 3, "in": 1,
                     "kh": 5, "kw": 5},
                    {"type": "pool", "kh": 4, "kw": 4},
                    {"type": "fc", "name": "fc1", "out": 6, "in": 675,
                     "relu": True},
                    {"type": "fc", "name": "fc2", "out": 3, "in": 6,
                     "relu": False}],
                "weights_seed": 0, "input_seed": 42}

#: The fleet cells and the language-model cells, in BENCHMARK.json's order.
FLEET_CELLS = ("har.design-space", "mnist.stats-query")
LM_CELLS = ("qwen3-0.6b.chat",)
#: Fleet mixes the harness runs that BENCHMARK.json holds no cell of yet:
#: each its configuration, and the cell whose metrics it would report.
QUEUED = {"har.capacitor-sweep": ("har", "mnist.stats-query")}
#: Every fleet mix the tests run.
CELLS = FLEET_CELLS + tuple(QUEUED)
#: Each fleet cell's end-to-end rate, and the prefix of the per-layer
#: metrics that move it (the query cells carry a bound of their own).
RATES = {"har.design-space": ("lanes_per_s", ""),
         "mnist.stats-query": ("query_lanes_per_s", "query.")}


def fleet_rate(workload: str) -> tuple[str, str]:
    """``workload``'s rate and per-layer prefix (a queued mix's those of
    the cell whose metrics it would report)."""
    return RATES[QUEUED[workload][1] if workload in QUEUED else workload]


def find_cell(workload: str, trace: bool = False):
    """``workload``'s cell as the harness finds it, or a queued mix's, made
    from its files as a cell of BENCHMARK.json would name them."""
    bench = spec.load_benchmark()
    if workload not in QUEUED:
        return spec.find_cell(bench, workload, trace)
    config, like = QUEUED[workload]
    cell = spec.find_cell(bench, like, trace)
    entry = next(c for c in bench["configs"] if c["name"] == config)
    cell.name = workload
    cell.config = json.loads((ROOT / entry["file"]).read_text())
    cell.traffic = json.loads((PERFBENCH / "traffic"
                               / f"{workload.split('.', 1)[1]}.json")
                              .read_text())
    return cell


def tiny_cell(workload: str, trace: bool = False):
    """``workload``'s cell with a tiny network, its own traffic mix at a
    few devices (the chunked mixes in chunks of 8) and two checked lanes a
    candidate."""
    cell = find_cell(workload, trace)
    design = len(cell.traffic["candidates"]) > 1
    cell.config = TINY if design else TINY_REBOOTS
    sweep = cell.traffic["sweep"]
    sweep["n_devices"] = 6 if design else 16
    if "lane_chunk" in sweep:
        sweep["lane_chunk"] = 8
    cell.traffic["check"]["lanes_per_candidate"] = 2
    return cell


#: The port's fields of a tiny model, and the file's keys they fill.
TINY_LM_KEYS = {"num_hidden_layers": "num_layers", "hidden_size": "d_model",
                "num_attention_heads": "num_heads",
                "num_key_value_heads": "num_kv_heads", "head_dim": "hd",
                "intermediate_size": "d_ff", "vocab_size": "vocab_size",
                "vocab_rows": "vocab_padded"}


def tiny_port(monkeypatch, **over):
    """Stand the port's configurations in with their ``scaled_down``
    selves in bf16 (``over`` on top): ``get_config``'s answer, as the
    harness asks for it."""
    from repro_torch import configs
    real = configs.get_config

    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16") | over

    def tiny(name):
        return real(name).scaled_down(**kw)
    monkeypatch.setattr(configs, "get_config", tiny)
    return tiny


def tiny_config(cfg: dict, port) -> dict:
    """``cfg`` with its widths and depth those of the tiny ``port``."""
    return dict(cfg, **{k: getattr(port, f)
                        for k, f in TINY_LM_KEYS.items()})


def tiny_traffic(traffic: dict, preempt: bool = False) -> dict:
    """The mix at a few positions: 12 requests of 6 prompt ids, answers of
    1-4 tokens (mean 3), every step of 4 of them compared; with
    ``preempt``, every answer 4 tokens and the engine killed after 2."""
    tiny = dict(traffic, requests=12, prompt_len=6,
                answers={"mean": 3, "cap": 4}, max_len=10,
                check=dict(traffic["check"], logit_rows=4))
    if preempt:
        tiny.update(answers=4, fail_after_tokens=2)
    return tiny


def tiny_lm_cell(monkeypatch, workload: str = LM_CELLS[0],
                 trace: bool = False, preempt: bool = False, **over):
    """``workload``'s cell with a tiny model of its family (its port
    configuration ``scaled_down``) and its own mix at a few positions."""
    cell = spec.find_cell(spec.load_benchmark(), workload, trace)
    port = tiny_port(monkeypatch, **over)(cell.config["port_config"])
    cell.config = tiny_config(cell.config, port)
    cell.traffic = tiny_traffic(cell.traffic, preempt)
    return cell


def cpu_run(cell, seed: int = 2**31 + 11, seconds: float = 0.2,
            trace: int = 0, **kw) -> tuple[int, list, str]:
    """One run of ``cell`` on the CPU, of its kind's run class (``kw``
    passed on): ``(exit code, stdout lines, stderr)``."""
    args = core.parse(["--workload", cell.name, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            tempfile.TemporaryDirectory() as tmp:
        if cell.config.get("kind") == "lm":     # an engine state of its own
            kw.setdefault("state", tmp)
        rc = core.run_class(cell)(
            cell, args, time.perf_counter(), device="cpu",
            preloaded=core.forbidden_modules(), **kw).execute()
    return rc, out.getvalue().splitlines(), err.getvalue()


def result(lines: list) -> dict:
    return json.loads(lines[-1])
