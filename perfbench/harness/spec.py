"""Find a cell's pieces by name: its entry in ``BENCHMARK.json`` (at the
root of the checkout), ``workloads/<cell>.json`` (the serve's geometry
and the check's sample and limit), ``configs/<config>.json`` and
``traffic/<traffic>.json``, and the metrics the cell reports. A new cell
is new files and a new entry; no code names a cell."""

from __future__ import annotations

import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _named(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell_spec(name: str, bench: dict | None = None,
              root: Path = ROOT) -> dict:
    """Everything a run of cell ``name`` reads: ``entry`` (its
    ``workloads`` entry), ``serve`` (the workload file), ``config``,
    ``traffic``, and the names of its ``end_to_end`` and ``per_layer``
    metrics."""
    bench = load_benchmark(root) if bench is None else bench
    entry = _named(bench["workloads"], name, "workload")
    base = root / "perfbench"
    serve = load_json(base / "workloads" / f"{name}.json")
    for key in ("config", "traffic"):
        if serve.get(key, entry[key]) != entry[key]:
            raise ValueError(f"workloads/{name}.json names {key} "
                             f"{serve[key]!r}; BENCHMARK.json {entry[key]!r}")
    config = load_json(base / "configs" / f"{entry['config']}.json")
    traffic = load_json(base / "traffic" / f"{entry['traffic']}.json")
    return {
        "name": name, "entry": entry, "serve": serve, "config": config,
        "traffic": traffic,
        "end_to_end": [m["name"] for m in bench["end_to_end"]
                       if _applies(m, name)],
        "per_layer": [m["name"] for m in bench["per_layer"]
                      if _applies(m, name)],
        "units": {m["name"]: m["unit"]
                  for m in bench["end_to_end"] + bench["per_layer"]},
    }
