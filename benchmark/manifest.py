"""The benchmark's manifest: ``BENCHMARK.json`` at the root of the
checkout, and the files it names, found by name alone.

* a configuration ``<c>``: the file its entry names
  (``configs/<c>.json``): env id and options, policy, algorithm and its
  config, whether observations are normalized (``normalize_obs``), the
  network and render kernel whose counts apply;
* a traffic mix ``<t>``: ``traffic/<t>.json`` (envs, rollout length,
  minibatches, epochs, the dp x tp mesh);
* a cell ``<w>``: its ``workloads`` entry, and ``cells/<w>.json`` with the
  limits of the comparison that decides ``correct``. A cell that is built
  and tested but not yet measured to the benchmark's rules keeps its
  ``workloads`` entry and its metrics' entries in that file, under
  ``pending``, until they move into ``BENCHMARK.json``: ``run.py`` runs it
  by name, and no check of the benchmark does;
* a per-layer metric ``<m>``: the reader ``metrics/<m>.py``;
* a network ``<n>`` (a configuration's ``network``): the plain reference
  ``reference/<n>.py`` (its leaves, their draw from the seed, the map from
  the reference env's state to the program's observation, the forward
  pass: ``reference/__init__.py``), its model FLOPs ``counts/<n>.py``
  (``update_flops(cfg, traffic)``), and, where a frozen stage of it lives in
  the program's env, ``handin/<n>.py`` (``make_env(cfg, device)``: the
  program's env with the stage in it; ``hand_in(agent, frozen)``: the
  stage's leaves of the seed put in place);
* a kernel's counts ``<k>``: ``counts/<k>.py``.

Adding any of them takes new files and new entries only: a new PPO2
network is a configuration, ``reference/<n>.py``, ``counts/<n>.py``
(and ``handin/<n>.py`` for a frozen stage), a cell file and entries."""
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
    # The checkout whose files the cell was found in, its network's plain
    # reference, and its frozen stage's hand-in (None without one).
    repo: Path = REPO
    network: object = None
    handin: object = None


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
    config = _json(repo / cfg_entry["file"])
    net = config["network"]
    handin = bench_dir / "handin" / f"{net}.py"
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config_name=entry["config"],
        config=config,
        traffic_name=entry["traffic"],
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(cell_path)["limits"],
        end_to_end=[m for m in bench["end_to_end"] if reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if reports(m, name)],
        repo=repo,
        network=load_module(bench_dir / "reference" / f"{net}.py", f"reference.{net}"),
        handin=load_module(handin, f"handin_{net}") if handin.exists() else None,
    )


def metric_reader(name: str, repo: Path = REPO):
    return load_module(repo / "benchmark" / "metrics" / f"{name}.py", f"metric_{name}")


def counts(name: str, repo: Path = REPO):
    return load_module(repo / "benchmark" / "counts" / f"{name}.py", f"counts_{name}")
