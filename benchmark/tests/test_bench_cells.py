"""BENCHMARK.json's names, units and entries, and the files each cell
names, found by name."""

import json
import re

import pytest

from benchmark import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((cells.REPO / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_entries(group):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if group == "end_to_end" else {"layer", "moves"}
    cell_names = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH[group]:
        assert set(m) - {"workloads"} == keys, m["name"]
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cell_names
        if group == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0 < m["bound"] <= 0.25


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_every_cell_loads_its_files_by_name():
    names = {w["name"] for w in BENCH["workloads"]}
    for name in names:
        cell = cells.load(name)
        assert cell.chips == 1
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                         "peak_mem_gib"}
        assert len(cell.end_to_end) >= 3 and cell.per_layer
        assert all(callable(r.read) for _, r in cell.per_layer)
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())


def test_configs_name_their_files_and_cuts():
    for c in BENCH["configs"]:
        f = json.loads((cells.REPO / c["file"]).read_text())
        assert f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert set(f["reduced"]) <= set(f["changed"]) | {"dataset_dir"}
