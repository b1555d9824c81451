"""BENCHMARK.json and the files the harness finds from its names."""

import json
import re

import pytest

from perfbench_support import (FLEET_CELLS, LM_CELLS, PERFBENCH, ROOT,
                               fleet_rate, spec)

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_cells_in_order_on_one_chip():
    assert [w["name"] for w in BENCH["workloads"]] == list(FLEET_CELLS + LM_CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert {c["name"] for c in BENCH["configs"]} == {"mnist", "har",
                                                     "qwen3-0.6b"}


@pytest.mark.parametrize("workload", FLEET_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_found_by_name(workload, trace):
    cell = spec.find_cell(spec.load_benchmark(), workload, trace)
    assert cell.config["layers"] and cell.traffic["candidates"]
    assert cell.traffic["sweep"]["reduce"] == "stats"
    names = {m["name"] for m in cell.metrics}
    kind = "per_layer" if trace else "end_to_end"
    assert names == {m["name"] for m in BENCH[kind]
                     if workload in spec.metric_cells(m, BENCH)}
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if workload in spec.metric_cells(m, BENCH)}
    assert e2e == {"setup_s", fleet_rate(workload)[0]}


@pytest.mark.parametrize("workload", LM_CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_lm_cell_found_by_name(workload, trace):
    cell = spec.find_cell(spec.load_benchmark(), workload, trace)
    assert cell.config["kind"] == "lm" and cell.config["port_config"]
    assert (PERFBENCH / "lmref" / f"{cell.config['family']}.py").is_file()
    names = {m["name"] for m in cell.metrics}
    if trace:
        assert names == {"lm.decode_ms_per_step", "lm.commit_ms_per_step",
                         "lm.kernels_per_step", "device_idle.serve",
                         "serve_mfu"}
    else:
        assert names == {"tokens_per_s", "setup_s"}


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_has_a_reader(metric):
    assert callable(spec.reader(metric))


def test_contract_names_units_and_bounds():
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(FLEET_CELLS + LM_CELLS)
        moved = next(e for e in BENCH["end_to_end"]
                     if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(spec.metric_cells(moved, BENCH))
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"plan build", "replay entry", "samplers",
                      "lane kernel", "closed form", "stats fold", "device",
                      "engine decode", "cursor commits", "lm kernels"}
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert NAME.match(w["name"]) and 1 <= len(w["why"]) <= 200
    for m in METRICS:
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert (PERFBENCH / "traffic" / f"{w['traffic']}.json").is_file()
