#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from, at the
cell's own size, in one process a card (the set-up is paid once):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--faults frozen,half_batch,...]

For each seed of ``--seeds`` the program's first update is judged against
the reference (a sound run); for each of ``--control-seeds`` the float8
reference is judged in the program's place (the control); for each fault of
``faults.py`` and each of ``--fault-seeds`` the program with that fault
planted. One JSON line per judged update, then one with each number's
lower reading (the largest of the sound runs) and each kind's least.

A cell on a dp x tp mesh runs on ``dp x tp`` ranks (``ranks.py``), rank 0
printing the lines; its faults include ``faults.MESH_FAULTS``. ``--options``
(JSON) sets the ranks' ``device`` and ``overrides`` (``ranks.launch``)."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

import run  # noqa: F401  (puts the program and the harness on the path)
import cell as driver
import faults
import judge
import manifest
import ranks


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    # ``reset`` shows only in an update with episode ends, after the window.
    p.add_argument("--faults", default=None,
                   help="default: every fault of faults.py that the cell can have but "
                        "reset (on a mesh, and MESH_FAULTS)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", default=None,
                   help="JSON of traffic entries to replace (a small rehearsal)")
    ranks.add_rank_args(p)
    args = p.parse_args(argv)
    run.set_environment()
    import torch

    cell = manifest.load_cell(args.workload)
    mesh_cell = ranks.world_of(cell.traffic) > 1
    if mesh_cell and args.rank is None:
        rc, _ = ranks.launch(str(Path(__file__).resolve()),
                             sys.argv[1:] if argv is None else argv,
                             ranks.world_of(cell.traffic), json.loads(args.options))
        return rc
    kinds = faults.kinds(cell, mesh_cell)
    names = [f for f in args.faults.split(",") if f] if args.faults is not None else \
        [f for f in kinds if f != "reset"]
    if set(names) - set(kinds):
        p.error(f"faults {sorted(set(names) - set(kinds))} are not among the cell's "
                f"{sorted(kinds)}")
    overrides = json.loads(args.overrides) if args.overrides else None
    comm = mesh = None
    if mesh_cell:
        device, comm, mesh = ranks.join(args, cell)
        overrides = json.loads(args.options).get("overrides", overrides)
    else:
        device = torch.device(args.device)
    try:
        agent = driver.build(cell, device, overrides)
        if comm is not None:
            comm.rows = (*driver.rows(agent, mesh), agent.vec_env.num_envs)
        jobs = [("sound", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
        jobs += [(f, s) for f in names for s in args.fault_seeds]
        readings = {}
        for kind, seed in jobs:
            t0 = time.perf_counter()
            params0 = driver.weights(cell, agent, seed, device)
            ctx = kinds[kind](agent) if kind in kinds else contextlib.nullcontext()
            with ctx:
                state, _, rec = driver.first_update(agent, params0, seed, cell.config["gae"],
                                                    mesh)
            del state
            details = {}
            values = judge.judge(rec, cell, params0, control=kind == "control",
                                 details=details, ranks=comm)
            del rec
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            readings.setdefault(kind, []).append(values)
            say(comm, json.dumps({"kind": kind, "seed": seed,
                                  "seconds": time.perf_counter() - t0, **values,
                                  "details": details}))
        summary = {"lower": {k: max(v[k] for v in readings.get("sound", [{k: 0.0}]))
                             for k in judge.NUMBERS}}
        for kind, vals in readings.items():
            if kind != "sound":
                summary[kind] = {k: min(v[k] for v in vals) for k in judge.NUMBERS}
        say(comm, json.dumps({"summary": summary}))
        if comm is not None and comm.rank == 0:
            print(ranks.RESULT + " " + json.dumps(summary), flush=True)
    finally:
        ranks.leave()
    return 0


def say(comm, line: str) -> None:
    """A line of the readings on standard output (on a mesh, rank 0's,
    through the launcher)."""
    if comm is None:
        print(line, flush=True)
    elif comm.rank == 0:
        print(ranks.OUT + " " + line, flush=True)


if __name__ == "__main__":
    sys.exit(main())
