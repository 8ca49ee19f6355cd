#!/usr/bin/env python3
"""Readings that the limits of a cell's comparison are set from, at the
cell's own size, in one process (the set-up is paid once):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds ...] [--fault-seeds ...] [--faults frozen,half_batch,...]

For each seed of ``--seeds`` the program's first update is judged against
the reference (a sound run); for each of ``--control-seeds`` the float8
reference is judged in the program's place (the control); for each fault of
``faults.py`` and each of ``--fault-seeds`` the program with that fault
planted. One JSON line per judged update, then one with each number's
lower reading (the largest of the sound runs) and each kind's least."""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

import run  # noqa: F401  (puts the program and the harness on the path)
import cell as driver
import faults
import judge
import manifest


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    # ``reset`` shows only in an update with episode ends, after the window.
    p.add_argument("--faults", default=",".join(f for f in faults.FAULTS if f != "reset"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--overrides", default=None,
                   help="JSON of traffic entries to replace (a small rehearsal)")
    args = p.parse_args(argv)
    run.set_environment()
    import torch

    device = torch.device(args.device)
    cell = manifest.load_cell(args.workload)
    agent = driver.build(cell, device, json.loads(args.overrides) if args.overrides else None)
    jobs = [("sound", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    jobs += [(f, s) for f in args.faults.split(",") if f for s in args.fault_seeds]
    readings = {}
    for kind, seed in jobs:
        t0 = time.perf_counter()
        params0 = driver.weights(cell, agent, seed, device)
        ctx = faults.FAULTS[kind](agent) if kind in faults.FAULTS else contextlib.nullcontext()
        with ctx:
            state, _, rec = driver.first_update(agent, params0, seed, cell.config["gae"])
        del state
        details = {}
        values = judge.judge(rec, cell, params0, control=kind == "control", details=details)
        del rec
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        readings.setdefault(kind, []).append(values)
        print(json.dumps({"kind": kind, "seed": seed, "seconds": time.perf_counter() - t0,
                          **values, "details": details}), flush=True)
    summary = {"lower": {k: max(v[k] for v in readings.get("sound", [{k: 0.0}]))
                         for k in judge.NUMBERS}}
    for kind, vals in readings.items():
        if kind != "sound":
            summary[kind] = {k: min(v[k] for v in vals) for k in judge.NUMBERS}
    print(json.dumps({"summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
