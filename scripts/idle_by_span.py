"""Where the card idles, by the program's spans. On the card, from the root
of the repo:

    python3 scripts/idle_by_span.py OUT.json kuka112.ppo2.e1024 mobile224.ppo2.e256

For each benchmark cell named: its env and agent as the benchmark builds
them, the weights from ``--seed``, the first update, then the second under
``torch.profiler`` (CPU and CUDA) with the tracer's detail mode on
(``srl_tpu_torch/utils/trace``). Both stamp Unix-epoch nanoseconds, so each
of the update's idle gaps (its wall time outside the union of device
operations) is put down to the program spans running then: for each span
name, its host seconds, the idle seconds inside it, its share of the
update's idle time and the idle share of its own time. Also the set-up
spans (``agent.policy_init``, ``kernel.load``) and the update's record.
Prints one JSON object a cell and writes them all to OUT.json. Needs a
card."""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "benchmark")]

# Spans whose idle time is reported (nested ones overlap their parents).
NAMES = ("env.dynamics", "env.reset", "env.observe", "rollout.policy", "sync.done",
         "sync.h2d", "env.step", "rollout", "gae", "epochs", "update")


def union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap(xs, ys) -> int:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(device, lo: int, hi: int) -> list:
    """[lo, hi) outside the union of the device intervals."""
    gaps, end = [], lo
    for a, b in union((max(a, lo), min(b, hi)) for a, b in device if b > lo and a < hi):
        if a > end:
            gaps.append([end, a])
        end = max(end, b)
    if hi > end:
        gaps.append([end, hi])
    return gaps


def cell_idle(name: str, seed: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import cell as bench_cell
    import manifest
    from srl_tpu_torch.utils import trace

    trace.disable()
    trace.reset()
    cell = manifest.load_cell(name)
    dev = torch.device("cuda", 0)
    agent = bench_cell.build(cell, dev)
    state, gen = bench_cell.start(agent, bench_cell.weights(cell, agent, seed, dev), seed)
    state, _ = agent.train_iteration(state, gen)
    torch.cuda.synchronize()
    setup = {k: v for k, v in trace.totals()["seconds"].items()
             if k in ("agent.policy_init", "kernel.load")}
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            agent.train_iteration(state, gen)
            torch.cuda.synchronize()
    finally:
        trace.disable()
    origin = prof.profiler.kineto_results.trace_start_ns()
    device = [(origin + round(e.time_range.start * 1000), origin + round(e.time_range.end * 1000))
              for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [s for s in trace.spans() if s["update"] == 1]
    update = next(s for s in spans if s["name"] == "update")
    gaps = idle_gaps(device, update["start_ns"], update["end_ns"])
    idle = sum(b - a for a, b in gaps)
    by_span = {}
    for n in NAMES:
        own = union((s["start_ns"], s["end_ns"]) for s in spans if s["name"] == n)
        length, inside = sum(b - a for a, b in own), overlap(own, gaps)
        by_span[n] = {"span_s": length / 1e9, "idle_in_s": inside / 1e9,
                      "share_of_idle": inside / idle if idle else None,
                      "idle_share_of_span": inside / length if length else None}
    window = update["end_ns"] - update["start_ns"]
    return {"window_s": window / 1e9, "idle_s": idle / 1e9, "idle_share": idle / window,
            "by_span": by_span, "setup": setup,
            "record": next(r for r in trace.records() if r["update"] == 1)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("out")
    parser.add_argument("cells", nargs="+")
    parser.add_argument("--seed", type=int, default=4100000007)
    args = parser.parse_args(argv)
    import run as bench_run
    import torch

    if not torch.cuda.is_available():
        print("idle_by_span: no CUDA device", file=sys.stderr)
        return 1
    bench_run.set_environment()
    result = {}
    for name in args.cells:
        result[name] = cell_idle(name, args.seed)
        print(name, json.dumps({k: v for k, v in result[name].items() if k != "record"}),
              flush=True)
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
