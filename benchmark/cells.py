"""A cell of `BENCHMARK.json` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  Everything that belongs to one of them sits in files of its own,
found by name:

- ``configs/<config>.json``: the configuration as it is run (``cfg``,
  the program's config keys), its scene and where it comes from;
- ``configs/<config>.py``: the configuration's plain reference field
  (``build(cfg, aabb_scale)``);
- ``traffic/<traffic>.json``: the traffic mix's parameters, read by the
  general driver of its ``kind`` (``train`` or ``render``);
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``,
  which returns the metric's value or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    reference: object      # the configuration's reference module
    end_to_end: list       # BENCHMARK.json's entries this cell reports
    per_layer: list        # (entry, reader module) this cell reports


def _reports(entry: dict, cell: str, e2e_names) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return e2e_names is None or entry.get("moves") in e2e_names


def load(name: str, bench_file: Path = REPO / "BENCHMARK.json",
         root: Path = HERE) -> Cell:
    bench = _json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file}: "
                       f"{sorted(cells)}")
    w = cells[name]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name, None)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [(m, _module(root / "metrics" / f"{m['name']}.py",
                             "benchmark_metric_" + m["name"].replace(".", "_")))
                 for m in bench["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json(root / "configs" / f"{w['config']}.json"),
        traffic=_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=_json(root / "limits" / f"{name}.json"),
        reference=_module(root / "configs" / f"{w['config']}.py",
                          f"benchmark_config_{w['config']}"),
        end_to_end=e2e, per_layer=per_layer)
