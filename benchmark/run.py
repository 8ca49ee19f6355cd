#!/usr/bin/env python3
"""The benchmark of srl_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's env and agent, makes the weights from the seed on
the card and runs the first update (the window's own call, recorded for the
check). The window then calls ``train_iteration`` in whole updates until
``--seconds`` have passed. With ``--trace 0`` the result holds the cell's
end-to-end metrics; with ``--trace 1`` the window runs under the
benchmark's spans, one more update runs under ``torch.profiler``, and the
result holds the per-layer metrics. After the window the program runs on,
recorded, until an update in which an episode ends; then the reference
follows the first update and that one, and decides ``correct``. The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the last key of
that object.

A cell on a dp x tp mesh (``dp`` or ``tp`` above 1 in its traffic file) runs
one process a card (``ranks.py``): this process starts ``dp x tp`` ranks of
this script, rank ``r`` on card ``r``, each building the agent for the
global batch and joining the program's mesh as its data-parallel job script
does; the window's clock is rank 0's, every number compared is the worst
rank's, and this process prints rank 0's result. A rank that ends with
another code than 0 ends the run at once, with no result; a rank that hangs
does so within ``ranks.COLLECTIVE_S`` (120 s), when the others' next
collective gives up.

Needs as many NVIDIA cards as the cell asks for; prints no result and exits
non-zero without them."""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
# The harness's modules, then the program beside it in the checkout.
for _path in (REPO, BENCH):
    if str(_path) not in sys.path:
        sys.path.insert(0, str(_path))
# The reference package and the harness import no JAX; nor may anything the
# program loads in this process (compared by whole top-level names).
FORBIDDEN = ("jax", "jaxlib", "flax", "srl_tpu")
PROGRAM = "srl_tpu_torch"
# Kernel and build caches at fixed paths inside the checkout.
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "nv"}


def set_environment() -> None:
    os.environ["USE_FLAX"] = "0"
    for var, sub in CACHES.items():
        os.environ[var] = str(REPO / "build" / "bench_cache" / sub)


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reference_imports() -> list:
    """Modules of the program, of JAX or of the JAX package that a file of
    the reference imports."""
    bad = set(FORBIDDEN) | {PROGRAM}
    found = []
    for path in sorted((BENCH / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            found += [f"{path.name}: {n}" for n in names if n.split(".")[0] in bad]
    return found


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def program_records() -> list:
    """The program's per-update records (``srl_tpu_torch/utils/trace``; none
    from a program without the tracer)."""
    try:
        from srl_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.records()


def per_layer(cell, ctx) -> dict:
    import manifest

    out = {}
    for m in cell.per_layer:
        value = manifest.metric_reader(m["name"], cell.repo).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, overrides=None,
             t_start: float = T0, ranks=None, mesh=None) -> dict:
    """One run of ``cell`` on one device: the result's fields and the
    numbers compared (``checks``). On a mesh (``ranks``, the harness's
    collectives, and ``mesh``, the program's, both made by ``ranks.join``,
    whose time counts in ``imports``) every rank calls it; rank 0's result
    holds the run's, the others' None."""
    import torch

    import cell as driver
    import judge
    import manifest
    import tracing

    phases = [("imports", time.perf_counter())]
    agent = driver.build(cell, device, overrides)
    if ranks is not None:
        ranks.rows = (*driver.rows(agent, mesh), agent.vec_env.num_envs)
    phases.append(("env_and_agent", time.perf_counter()))
    params0 = driver.weights(cell, agent, seed, device)
    cap = driver.check_updates_cap(cell)
    phases.append(("weights", time.perf_counter()))
    state, gen, rec = driver.first_update(agent, params0, seed, cell.config["gae"], mesh)
    driver.sync(device)
    if ranks is not None:
        ranks.barrier()
    phases.append(("first_update", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    setup_parts = {name: b - a for (name, b), (_, a) in
                   zip(phases, [("start", t_start)] + phases[:-1])}
    on_card = device.type == "cuda"
    profile, spans = None, None
    if trace:
        # The second update of every run is the one profiled: how many
        # episodes reset in a step, and so the rollout's launches, follows
        # the update's index, and a later one would follow the host's speed.
        state, profile = driver.profiled(agent, state, gen, cell.config["spans"], device)
        spans = tracing.Spans(agent, cell.config["spans"], device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    if spans is not None:
        with spans:
            state, updates, window_s, marks = driver.window(agent, state, gen, seconds,
                                                            device, ranks)
    else:
        state, updates, window_s, marks = driver.window(agent, state, gen, seconds, device,
                                                        ranks)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    traffic = cell.traffic
    steps = updates * traffic["n_steps"] * traffic["num_envs"]
    state, check, check_runs = driver.check_update(agent, state, gen, cell.config["gae"], cap,
                                                   mesh, ranks)
    del state, agent
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    values = judge.judge(rec, cell, params0, check=check, ranks=ranks)
    correct = judge.verdict(values, cell.limits)
    rank_records = None
    if ranks is not None:
        # Rank 0 reports the fullest card, each card's busy share of its
        # profiled update and each rank's records of the traced window.
        theirs = ranks.gather("readings", {
            "peak": peak, "forbidden": loaded_forbidden(),
            "busy": profile and [profile["busy_s"], profile["window_s"]],
            "records": program_records() if trace else None})
        if ranks.rank != 0:
            return None
        peak = max(r["peak"] for r in theirs)
        forbidden = sorted({m for r in theirs for m in r["forbidden"]})
        if trace:
            rank_records = [r["records"] for r in theirs]
            profile = dict(profile, busy_s=sum(r["busy"][0] for r in theirs) / len(theirs),
                           window_s=sum(r["busy"][1] for r in theirs) / len(theirs))
    if trace:
        flops = manifest.counts(cell.config["network"], cell.repo).update_flops(
            cell.config, traffic)
        ctx = types.SimpleNamespace(cell=cell, spans=spans.seconds, updates=updates,
                                    window_s=window_s, profile=profile, peak_bytes=peak,
                                    flops_per_update=flops, rank_records=rank_records)
        metrics = per_layer(cell, ctx)
    else:
        # An end-to-end metric is the quantity its name starts with (a
        # suffix names the cells whose bound it carries).
        quantity = {"env_steps_per_s": steps / window_s, "setup_s": setup_s}
        metrics = {m["name"]: {"value": quantity[m["name"].split(".")[0]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    readings = {k: values[k] for k in judge.NUMBERS}
    readings.update(resets_checked=values.get("resets_checked"), check_updates=check_runs)
    result = {"correct": correct, "attempted": updates, "failed": 0, "metrics": metrics,
              "profile": profile, "peak": peak, "setup_parts": setup_parts, "update_marks": marks,
              "readings": readings}
    result["checks"] = {k: {"value": values[k], "limit": cell.limits[k]}
                        for k in judge.compared(cell.limits)}
    if ranks is not None:
        result["forbidden"] = forbidden
    return result


def emit(result: dict, cell, trace: bool, kind: str, limit_w: str) -> int:
    """Print a run's result: the set-up's parts, the window's marks and each
    number read beside its limit on standard error, then the JSON line."""
    bad = loaded_forbidden() + result.get("forbidden", [])
    bad_ref = reference_imports()
    if bad or bad_ref:
        print(f"import guard: modules loaded {sorted(set(bad))}; reference imports {bad_ref}",
              file=sys.stderr)
        return 4
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": {"platform": "gpu", "kind": kind, "count": cell.chips,
                       "memory_peak_bytes": result["peak"], "power_limit": limit_w}}
    if trace:
        prof = result["profile"]
        line["device"].update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    if "setup_parts" in result:
        print("setup " + " ".join(f"{k} {v:.3f}" for k, v in result["setup_parts"].items()),
              file=sys.stderr)
        print("window " + " ".join(f"{m:.3f}" for m in result["update_marks"]),
              file=sys.stderr)
    for name, value in result.get("readings", {}).items():
        if name not in result["checks"]:
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
    line["checks"] = result["checks"]
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


def run_mesh(cell, args, options=None, script=None):
    """(exit code, rank 0's result) of ``cell`` on its mesh: ``dp x tp``
    ranks of ``script`` (this one), started and watched by ``ranks.launch``."""
    import ranks

    argv = ["--workload", cell.name, "--seed", str(args.seed), "--seconds",
            str(args.seconds), "--trace", str(args.trace)]
    return ranks.launch(script or str(Path(__file__).resolve()), argv,
                        ranks.world_of(cell.traffic), options, t0=T0)


def rank_main(args, cell) -> int:
    """One rank of a run on a mesh (``run_mesh`` starts it): rank 0 hands
    the run's result to the launcher."""
    import ranks

    options = json.loads(args.options)
    device, comm, mesh = ranks.join(args, cell)
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                          options.get("overrides"), args.t0 if args.t0 is not None else T0,
                          comm, mesh)
        if result is not None:
            if result["profile"] is not None:
                result["profile"] = {k: result["profile"][k] for k in
                                     ("busy_s", "window_s", "device_ops", "idle_gaps")}
            print(ranks.RESULT + " " + json.dumps(result), flush=True)
    finally:
        ranks.leave()
    return 0


def main(argv=None) -> int:
    import ranks

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ranks.add_rank_args(parser)
    args = parser.parse_args(argv)
    set_environment()
    import torch

    import manifest

    cell = manifest.load_cell(args.workload)
    if args.rank is not None:
        return rank_main(args, cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell '{cell.name}' needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    if cell.traffic["tp"] > 1:
        print(f"the cell '{cell.name}' asks for tp {cell.traffic['tp']}: the check follows "
              "whole leaves, and a tp above 1 is not judged yet", file=sys.stderr)
        return 3
    limit_w = power_limit()
    if ranks.world_of(cell.traffic) > 1:
        rc, result = run_mesh(cell, args)
        if rc:
            return rc
    else:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0))
    return emit(result, cell, bool(args.trace), torch.cuda.get_device_name(0), limit_w)


if __name__ == "__main__":
    sys.exit(main())
