"""Whether the bars of ``chip_smoke.py``'s step 15 tell a faulty dp
reduction from a sound one, and where a sound run's distance from one
process sits. On the card, from the root of the repo:

    python3 scripts/dp_bar_check.py --runs 15a 15c 15d --faults drop scale
    python3 scripts/dp_bar_check.py --runs 15d --fp32-convs

For each run of ``chip_smoke.DP_AGENT_RUNS`` named: the run as step 15
makes it (two gloo ranks on the card against one process stepping the
whole batch), then once again with each fault planted in the ranks:

* ``drop``: dp rank 1's share left out of every gradient-sized all-reduce
  (the gradients, and TRPO's Fisher-vector products);
* ``scale``: every gradient-sized all-reduce returns dp times the sum, as
  if each rank had taken its gradient as the mean over its own rows rather
  than its sum over the global count.

Each prints ``hold_dp``'s verdict under the run's own bars and under 13b's
(the curve bar and the step bar), the first gradients' distances from one
process's, and a table of every parameter leaf: its share of
|p_dp - p_one|^2, its distance over its own step, and for each first
gradient its |g_dp - g_one| / |g_one|, the share of its entries whose sign
differs from one process's, and the share of its entries with
|g_one| > 1e-5 (PPO's Adam eps; where Adam's first step is nearly
lr * sign(g)). ``--fp32-convs`` runs the Nature CNN in float32 (convolutions
and fc), in the ranks and in the one process. It ends with one line
``DP_BAR_CHECK {json}`` of every reading and exits 0 once every run has
run, whatever the verdicts.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = ("drop", "scale")
# What each rank's python runs: the fault and the precision from the
# environment, then dp_ppo's main on the arguments that follow.
RANK_SRC = ("import os, sys; sys.path[:0] = [os.path.join(os.getcwd(), 'scripts'), os.getcwd()]; "
            "import dp_bar_check; dp_bar_check.plant(os.environ.get('DP_FAULT', ''), "
            "os.environ.get('DP_FP32_CONVS') == '1'); "
            "from srl_tpu_torch.parallel import dp_ppo; dp_ppo.main(sys.argv[1:])")


def plant(fault: str, fp32_convs: bool) -> None:
    """Plant ``fault`` (one of FAULTS, or "" for none) in ``Mesh.all_reduce_``
    and, with ``fp32_convs``, run the Nature CNN in float32, for this
    process."""
    import torch
    import torch.nn.functional as F

    from srl_tpu_torch.models import policies
    from srl_tpu_torch.parallel import dp_ppo
    from srl_tpu_torch.parallel.mesh import Mesh

    if fault:
        if fault not in FAULTS:
            raise ValueError(f"unknown fault {fault!r}: one of {FAULTS}")
        reduce_, make_agent = Mesh.all_reduce_, dp_ppo.make_agent
        n_params = []

        def counted(*args, **kwargs):
            # A gradient-sized all-reduce holds one entry per parameter (tp 1).
            agent = make_agent(*args, **kwargs)
            n_params.append(sum(math.prod(s) for s in agent.param_shapes().values()))
            return agent

        def all_reduce_(self, t, op="sum"):
            gradient = op == "sum" and n_params and t.numel() == n_params[-1]
            if gradient and fault == "drop" and self.dp_index == 1:
                t.zero_()
            out = reduce_(self, t, op)
            if gradient and fault == "scale":
                out.mul_(self.dp)
            return out

        Mesh.all_reduce_, dp_ppo.make_agent = all_reduce_, counted
    if fp32_convs:
        def forward(self, x):
            x = (x.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
            x = x.contiguous(memory_format=torch.channels_last)
            x = F.relu(self.c1.conv(x))
            x = F.relu(policies._bf16_conv(self.c2, x))
            x = F.relu(policies._bf16_conv(self.c3, x))
            x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
            return F.relu(self.fc(x))

        policies.NatureCnnTorso.forward = forward


def leaf_table(torch, got: dict, want: dict) -> list:
    """One row for each parameter leaf (see the module docstring)."""
    names, sizes = zip(*want["leaves"])
    split = lambda x: dict(zip(names, torch.split(x.double(), list(sizes))))
    off = split(got["params"] - want["params"])
    step = split(want["params"] - want["params0"])
    total = sum(v.square().sum().item() for v in off.values()) or 1.0
    sites = {}
    for site, g_one in (want.get("grads0") or {}).items():
        if site in (got.get("grads0") or {}):
            sites[site] = (split(got["grads0"][site]), split(g_one))
    rows = []
    for k, n in zip(names, sizes):
        row = {"leaf": k, "size": n, "share": off[k].square().sum().item() / total,
               "of_step": off[k].norm().item() / max(step[k].norm().item(), 1e-30)}
        for site, (g_dp, g_one) in sites.items():
            a, b = g_dp[k], g_one[k]
            row[site] = {"dist": ((a - b).norm() / max(b.norm().item(), 1e-30)).item(),
                         "flips": (torch.sign(a) != torch.sign(b)).double().mean().item(),
                         "above_eps": (b.abs() > 1e-5).double().mean().item()}
        rows.append(row)
    return rows


def print_table(rows: list) -> None:
    sites = [k for k in rows[0] if k not in ("leaf", "size", "share", "of_step")]
    head = "leaf".ljust(34) + "size".rjust(10) + "  share  of_step"
    for site in sites:
        head += f"  {site}: dist  flips  >eps"
    print(head)
    for r in sorted(rows, key=lambda r: -r["share"]):
        line = f"{r['leaf'][:34]:34}{r['size']:10d}  {r['share']:5.1%}  {r['of_step']:7.2%}"
        for site in sites:
            s = r[site]
            line += f"  {' ' * len(site)}  {s['dist']:5.1%}  {s['flips']:5.1%}  {s['above_eps']:4.0%}"
        print(line)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--runs", nargs="+", default=["15a", "15c", "15d"])
    p.add_argument("--faults", nargs="*", default=list(FAULTS), choices=FAULTS)
    p.add_argument("--fp32-convs", action="store_true")
    args = p.parse_args()

    import subprocess

    import torch
    if not torch.cuda.is_available():
        print("dp_bar_check: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    plant("", args.fp32_convs)
    os.environ["DP_FP32_CONVS"] = "1" if args.fp32_convs else "0"
    runs = {r[0]: r for r in smoke.DP_AGENT_RUNS}
    readings = []
    for name in args.runs:
        run, what, argv, kernel, held = runs[name]
        one = None
        for fault in ["", *args.faults]:
            os.environ["DP_FAULT"] = fault
            label = f"{run} {what}" + (" float32 CNN" if args.fp32_convs else "") + (
                f", fault {fault}" if fault else ", sound")
            torch.cuda.empty_cache()
            one, ranks = smoke.gloo_ranks(torch, argv, label, card, kernel,
                                          smoke.dp_launches(argv), one=one, held=(),
                                          launch=("-c", RANK_SRC))
            verdicts = {}
            for bars, named in ((held, "its bars"), (("curve", "step"), "13b's bars")):
                try:
                    smoke.hold_dp(torch, ranks[0], one, label, own_rows=True, held=bars)
                    verdicts[named] = "held"
                except AssertionError as e:
                    verdicts[named] = "failed: " + str(e).split(": not within ")[1].split(": ")[0]
            params, params_want = ranks[0]["params"].double(), one["params"].double()
            reading = {
                "run": label, "verdicts": verdicts,
                "of_step": ((params - params_want).norm()
                            / (params_want - one["params0"].double()).norm()).item(),
                "grads": smoke.first_grads_off(ranks[0], one),
                "loss": {k: [v, one["metrics"][k]] for k, v in ranks[0]["metrics"].items()},
                "leaves": leaf_table(torch, ranks[0], one)}
            readings.append(reading)
            print(f"== {label}: {verdicts}; |p_dp - p_one| {reading['of_step']:.3%} of the "
                  f"step; first gradients' |g_dp - g_one| / |g_one| "
                  f"{ {k: f'{v:.3%}' for k, v in reading['grads'].items()} }; {card}",
                  flush=True)
            print_table(reading["leaves"])
            del ranks
    print("DP_BAR_CHECK " + json.dumps({"card": card, "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
