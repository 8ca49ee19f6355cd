"""Rewards at timestep budgets and Welch t-tests between methods
(counterpart of srl_tpu/replay/gather_results.py).

For each SRL-method folder under ``logs/{env}/``: the mean over its runs of
the smoothed reward each run had reached at each budget, written to
``results.csv`` (with the run count per budget), then Welch's t-test
between every pair of methods at the largest budget.

    python -m srl_tpu_torch.replay.gather_results --log-dir logs/ENV/ \\
        [--timesteps 500000 1000000] [--episode-window 40] [--output CSV]
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
from math import erf, sqrt
from typing import Dict

import numpy as np

from srl_tpu_torch.replay.aggregate_plots import curve_for_run
from srl_tpu_torch.utils.logging import printGreen


def welch_t_test(a: np.ndarray, b: np.ndarray):
    """Welch's unequal-variance t statistic and its two-sided p-value from
    the normal approximation, as the reference reports it: (t, p)."""
    ma, mb = a.mean(), b.mean()
    va, vb = a.var(ddof=1), b.var(ddof=1)
    na, nb = len(a), len(b)
    denom = np.sqrt(va / na + vb / nb)
    if denom == 0:
        return 0.0, 1.0
    t = (ma - mb) / denom
    p = 2 * (1 - 0.5 * (1 + erf(abs(t) / sqrt(2))))
    return float(t), float(p)


def rewards_at_budget(method_dir: str, budget: int, window: int = 40) -> np.ndarray:
    """Each run's last smoothed reward at or before ``budget`` timesteps."""
    out = []
    for run_dir in glob.glob(os.path.join(method_dir, "*", "*")):
        if not os.path.isdir(run_dir):
            continue
        c = curve_for_run(run_dir, window)
        if c is None:
            continue
        t, r = c
        mask = t <= budget
        if mask.any():
            out.append(r[mask][-1])
    return np.asarray(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Gather results + t-tests")
    parser.add_argument("--log-dir", type=str, required=True, help="logs/{env}/ directory")
    parser.add_argument("--timesteps", type=int, nargs="+",
                        default=[500_000, 1_000_000, 2_000_000, 5_000_000])
    parser.add_argument("--episode-window", type=int, default=40)
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args(argv)

    methods = sorted(d for d in os.listdir(args.log_dir)
                     if os.path.isdir(os.path.join(args.log_dir, d)))
    rows = []
    per_method: Dict[str, Dict[int, np.ndarray]] = {}
    for m in methods:
        per_method[m] = {}
        row = {"method": m}
        for budget in args.timesteps:
            r = rewards_at_budget(os.path.join(args.log_dir, m), budget, args.episode_window)
            per_method[m][budget] = r
            row[str(budget)] = round(float(r.mean()), 3) if len(r) else None
            row[f"{budget}_n"] = len(r)
        rows.append(row)

    out = args.output or os.path.join(args.log_dir, "results.csv")
    with open(out, "w", newline="") as f:
        if rows:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
    printGreen(f"Saved {out}")

    budget = args.timesteps[-1]
    print("Welch t-tests (method_a vs method_b: t, p) at budget", budget)
    tests = {}
    for i, a in enumerate(methods):
        for b in methods[i + 1:]:
            ra, rb = per_method[a][budget], per_method[b][budget]
            if len(ra) < 2 or len(rb) < 2:
                continue
            tests[(a, b)] = t, p = welch_t_test(ra, rb)
            print(f"  {a} vs {b}: t={t:.3f} p={p:.4f}")
    return out, tests


if __name__ == "__main__":
    main()
