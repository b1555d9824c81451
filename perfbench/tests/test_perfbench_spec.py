"""BENCHMARK.json and the files the harness finds from its names."""

import json
import re

import pytest

from perfbench_support import CELLS, PERFBENCH, ROOT, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_cells_in_order_on_one_chip():
    assert [w["name"] for w in BENCH["workloads"]] == list(CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])
    assert {c["name"] for c in BENCH["configs"]} == {"mnist", "har"}


@pytest.mark.parametrize("workload", CELLS)
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
    assert "setup_s" in e2e and len(e2e) >= 2


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
        assert set(m["workloads"]) <= set(CELLS)
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert layers == {"plan build", "replay entry", "samplers",
                      "lane kernel", "closed form", "stats fold", "device"}
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
