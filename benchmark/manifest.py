"""The benchmark's manifest: ``BENCHMARK.json`` at the root of the
checkout, and the files it names, found by name alone.

* a configuration ``<c>``: the file its entry names
  (``configs/<c>.json``): env id and options, policy, algorithm and its
  config, the network and render kernel whose counts apply;
* a traffic mix ``<t>``: ``traffic/<t>.json`` (envs, rollout length,
  minibatches, epochs, the dp x tp mesh);
* a cell ``<w>``: its ``workloads`` entry, and ``cells/<w>.json`` with the
  limits of the comparison that decides ``correct``. A cell that is built
  and tested but not yet measured to the benchmark's rules keeps its
  ``workloads`` entry and its metrics' entries in that file, under
  ``pending``, until they move into ``BENCHMARK.json``: ``run.py`` runs it
  by name, and no check of the benchmark does;
* a per-layer metric ``<m>``: the reader ``metrics/<m>.py``;
* a network's or kernel's counts ``<k>``: ``counts/<k>.py``.

Adding any of them takes new files and new entries only."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The Python module at ``path`` (a reader or a count), loaded by path:
    file names may hold dots."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric`` (every cell, without a
    ``workloads`` key)."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, repo: Path = REPO) -> Cell:
    bench = _json(repo / "BENCHMARK.json")
    bench_dir = repo / "benchmark"
    entries = {w["name"]: w for w in bench["workloads"]}
    cell_path = bench_dir / "cells" / f"{name}.json"
    pending = _json(cell_path).get("pending") if cell_path.exists() else None
    if name not in entries and pending is None:
        raise KeyError(f"no workload '{name}' in BENCHMARK.json (known: {sorted(entries)})")
    if name not in entries:
        entries[name] = pending["workload"]
        bench = dict(bench, end_to_end=bench["end_to_end"] + pending["end_to_end"],
                     per_layer=bench["per_layer"] + pending["per_layer"])
    entry = entries[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg_entry = configs[entry["config"]]
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config_name=entry["config"],
        config=_json(repo / cfg_entry["file"]),
        traffic_name=entry["traffic"],
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(cell_path)["limits"],
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
    )


def metric_reader(name: str, repo: Path = REPO):
    return load_module(repo / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}")


def counts(name: str, repo: Path = REPO):
    return load_module(repo / "benchmark" / "counts" / f"{name}.py", f"counts_{name}")
