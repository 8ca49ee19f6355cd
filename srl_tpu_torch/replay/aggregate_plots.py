"""Learning curves aggregated over seeds (counterpart of
srl_tpu/replay/aggregate_plots.py).

For each SRL-method folder under ``logs/{env}/``: every run's monitor CSVs,
smoothed over the episode window, interpolated onto a common timestep grid,
and their mean and standard error, saved as ``{method}.npz`` and drawn
together in ``aggregated_curves.png``.

    python -m srl_tpu_torch.replay.aggregate_plots --log-dir logs/ENV/ \\
        [--algo ppo2] [--episode-window 40] [--output DIR]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from srl_tpu_torch.experiments.visualize import (episodes_with_timesteps, no_pyplot, pyplot,
                                                 smooth_moving_average)
from srl_tpu_torch.utils.logging import printGreen, printYellow
from srl_tpu_torch.utils.monitor import load_results


def curve_for_run(run_dir: str, window: int = 40):
    """(timesteps, rewards) of a run, smoothed over ``window`` episodes once
    it has that many; None without an episode."""
    timesteps, rewards = episodes_with_timesteps(load_results(run_dir))
    if len(rewards) == 0:
        return None
    if len(rewards) >= window:
        rewards = smooth_moving_average(rewards, window)
        timesteps = timesteps[window - 1:]
    return timesteps, rewards


def aggregate_method(method_dir: str, algo: str = None, window: int = 40,
                     grid_points: int = 200):
    """Mean and standard error over the runs of one env/srl-method folder
    (of ``algo``, else of every algo), on ``grid_points`` timesteps up to the
    shortest run's last; None without a run that has an episode."""
    pattern = os.path.join(method_dir, algo or "*", "*")
    run_dirs = [d for d in glob.glob(pattern) if os.path.isdir(d)]
    curves = [c for c in (curve_for_run(d, window) for d in run_dirs) if c]
    if not curves:
        return None
    t_max = min(c[0][-1] for c in curves)
    grid = np.linspace(0, t_max, grid_points)
    interp = np.stack([np.interp(grid, t, r) for t, r in curves])
    return {"timesteps": grid, "mean": interp.mean(axis=0),
            "stderr": interp.std(axis=0) / np.sqrt(len(curves)), "n_runs": len(curves)}


def main(argv=None):
    parser = argparse.ArgumentParser(description="Aggregate curves over seeds")
    parser.add_argument("--log-dir", type=str, required=True, help="logs/{env}/ directory")
    parser.add_argument("--algo", type=str, default=None)
    parser.add_argument("--episode-window", type=int, default=40)
    parser.add_argument("--output", type=str, default=None)
    args = parser.parse_args(argv)

    out_dir = args.output or args.log_dir
    os.makedirs(out_dir, exist_ok=True)
    aggregated = {}
    for method_dir in sorted(glob.glob(os.path.join(args.log_dir, "*"))):
        if not os.path.isdir(method_dir):
            continue
        method = os.path.basename(method_dir)
        agg = aggregate_method(method_dir, args.algo, args.episode_window)
        if agg is None:
            printYellow(f"No complete runs for {method}")
            continue
        np.savez(os.path.join(out_dir, f"{method}.npz"), **agg)
        aggregated[method] = agg
    if not aggregated:
        return None
    out = os.path.join(out_dir, "aggregated_curves.png")
    plt = pyplot()
    if plt is None:
        no_pyplot(out)
        return None
    fig, ax = plt.subplots(figsize=(8, 5))
    for method, agg in aggregated.items():
        ax.plot(agg["timesteps"], agg["mean"], label=f"{method} (n={agg['n_runs']})")
        ax.fill_between(agg["timesteps"], agg["mean"] - agg["stderr"],
                        agg["mean"] + agg["stderr"], alpha=0.25)
    ax.set_xlabel("timesteps")
    ax.set_ylabel("mean episode reward")
    ax.legend()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    printGreen(f"Saved {out}")
    return out


if __name__ == "__main__":
    main()
