"""Learning curves from a run's monitor CSVs (counterpart of
srl_tpu/experiments/visualize.py): the smoothing, median-filter and
downsampling helpers, the (timesteps, rewards) merge of a log dir's monitor
files, and ``plot_log_dir``, the timesteps and episodes plots drawn to
``learning_curve.png`` in the log dir.

Drawing needs matplotlib, imported by ``pyplot`` when a figure is drawn;
without it only the figure is left out (the caller is told) and every number
behind it is still computed.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from srl_tpu_torch.utils.logging import printYellow
from srl_tpu_torch.utils.monitor import load_results


def pyplot():
    """``matplotlib.pyplot`` on the Agg backend, or None where matplotlib is
    not installed."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def no_pyplot(out: str) -> None:
    printYellow(f"matplotlib is not installed: {out} is not drawn")


def smooth_moving_average(x: np.ndarray, window: int) -> np.ndarray:
    """Moving average over ``window`` points (``valid`` mode); ``x`` as it
    is when shorter than the window."""
    if len(x) < window or window <= 1:
        return x
    kernel = np.ones(window) / window
    return np.convolve(x, kernel, mode="valid")


def median_filter(x: np.ndarray, size: int = 5) -> np.ndarray:
    """Running median over ``size`` points; the ``size // 2`` points at each
    end are kept."""
    if len(x) < size:
        return x
    out = x.copy()
    half = size // 2
    for i in range(half, len(x) - half):
        out[i] = np.median(x[i - half: i + half + 1])
    return out


def downsample(x: np.ndarray, y: np.ndarray, n: int = 500):
    """At most ``n`` evenly spaced points of (x, y)."""
    if len(x) <= n:
        return x, y
    idx = np.linspace(0, len(x) - 1, n).astype(int)
    return x[idx], y[idx]


def episodes_with_timesteps(results) -> tuple:
    """(cumulative timesteps, rewards) of every episode of the monitor files
    ``results``, ordered by wall time."""
    if not results:
        return np.array([]), np.array([])
    r = np.concatenate([res["r"] for res in results])
    t = np.concatenate([res["t"] for res in results])
    lengths = np.concatenate([res["l"] for res in results])
    order = np.argsort(t)
    return np.cumsum(lengths[order]), r[order]


def plot_log_dir(log_dir: str, title: str = "", episode_window: int = 40,
                 out_name: str = "learning_curve.png") -> Optional[str]:
    """Reward against timesteps (raw and smoothed) and against episodes, to
    ``log_dir/out_name``; None when the run has no episode yet or matplotlib
    is missing."""
    timesteps, rewards = episodes_with_timesteps(load_results(log_dir))
    if len(rewards) == 0:
        return None
    out = os.path.join(log_dir, out_name)
    plt = pyplot()
    if plt is None:
        no_pyplot(out)
        return None

    fig, axes = plt.subplots(1, 2, figsize=(12, 4.5))
    axes[0].plot(timesteps, rewards, alpha=0.3, label="episode reward")
    if len(rewards) >= episode_window:
        sm = smooth_moving_average(rewards, episode_window)
        axes[0].plot(timesteps[episode_window - 1:], sm,
                     label=f"smoothed (w={episode_window})")
    axes[0].set_xlabel("timesteps")
    axes[0].set_ylabel("episode reward")
    axes[0].legend()
    axes[0].set_title(title or os.path.basename(log_dir))

    episodes = np.arange(len(rewards))
    axes[1].plot(episodes, rewards, alpha=0.3)
    if len(rewards) >= episode_window:
        axes[1].plot(episodes[episode_window - 1:],
                     smooth_moving_average(rewards, episode_window))
    axes[1].set_xlabel("episodes")
    axes[1].set_ylabel("episode reward")

    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out
