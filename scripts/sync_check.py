"""Whether the tracer's ``host_syncs`` misses a synchronisation. On the
card, from the root of the repo:

    python3 scripts/sync_check.py OUT.json mobile224.ppo2.e256:4 kuka112.ppo2.e1024:12

For each benchmark cell named (``cell:updates``): its env and agent as the
benchmark builds them, then that many updates, each under
``torch.cuda.set_sync_debug_mode("warn")``. Every warning, one for each
synchronising CUDA call, is set against the update's record
(``srl_tpu_torch/utils/trace``): a line for each update with the
warnings, its ``host_syncs``, ``reset_steps`` and ``sync.*`` calls, and
the call sites of warnings raised outside any ``sync.*`` span (a blocking
call that the tracer does not count). Writes every line to OUT.json; exits 1 where an
update after the first has such a warning. Needs a card."""
from __future__ import annotations

import collections
import json
import sys
import traceback
import warnings
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO), str(REPO / "benchmark")]


def checked_update(agent, state, gen, trace):
    """(state, warnings, untraced call sites) of one update."""
    import torch

    sites, total = collections.Counter(), [0]

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        total[0] += 1
        if not any(frame[0].startswith("sync.") for frame in trace._local.stack):
            frames = [f for f in traceback.extract_stack()[:-1] if "srl_tpu_torch" in f.filename]
            sites[" <- ".join(f"{Path(f.filename).name}:{f.lineno}:{f.name}"
                              for f in reversed(frames[-5:]))] += 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            state, _ = agent.train_iteration(state, gen)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return state, total[0], dict(sites)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    import torch

    if not torch.cuda.is_available():
        print("sync_check: no CUDA device", file=sys.stderr)
        return 1
    import cell as bench_cell
    import manifest
    import run as bench_run
    from srl_tpu_torch.utils import trace

    bench_run.set_environment()
    out, missed = {}, False
    for arg in argv[1:]:
        name, n = arg.split(":")
        cell = manifest.load_cell(name)
        dev = torch.device("cuda", 0)
        agent = bench_cell.build(cell, dev)
        seed = 3000000019
        state, gen = bench_cell.start(agent, bench_cell.weights(cell, agent, seed, dev), seed)
        rows = []
        for _ in range(int(n)):
            state, warned, untraced = checked_update(agent, state, gen, trace)
            rec = trace.records()[-1]
            rows.append({"update": rec["update"], "warned": warned,
                         "host_syncs": rec["counts"].get("host_syncs", 0),
                         "reset_steps": rec["counts"].get("reset_steps", 0),
                         "sync_calls": {k: v for k, v in rec["calls"].items()
                                        if k.startswith("sync.")},
                         "untraced": untraced})
            missed |= rec["update"] > 0 and bool(untraced)
            print(name, json.dumps(rows[-1]), flush=True)
        out[name] = rows
        del agent, state
        torch.cuda.empty_cache()
    Path(argv[0]).parent.mkdir(parents=True, exist_ok=True)
    Path(argv[0]).write_text(json.dumps(out, indent=1))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
