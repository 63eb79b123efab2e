"""Find what a run needs by name: the manifest (`BENCHMARK.json` at the
root of the checkout), a cell's file under `workloads/`, its
configuration's file under `configs/`, and each metric's reader under
`metrics/`. Adding a cell, a configuration or a metric adds files and
edits none."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent


@dataclass
class Cell:
    name: str
    entry: dict  # the manifest's workload entry
    spec: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    end_to_end: list  # manifest metric entries this cell reports
    per_layer: list


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str) -> Cell:
    """The cell `name` of the manifest, with its files and the metrics it
    reports: an end-to-end metric where it has no `workloads` key or
    lists the cell; a per-layer metric where it lists the cell or, with
    no such key, where the cell reports the metric it moves."""
    man = manifest()
    found = [w for w in man["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = found[0]
    spec = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    config = json.loads(
        (BENCH / "configs" / f"{entry['config']}.json").read_text())
    e2e = [m for m in man["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if (name in m["workloads"] if "workloads" in m
               else m["moves"] in names)]
    return Cell(name, entry, spec, config, e2e, per)


def reader(metric: str):
    """The `read` function of metrics/<metric>.py."""
    path = BENCH / "metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read
