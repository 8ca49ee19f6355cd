"""Re-plot a past run's learning curve (counterpart of
srl_tpu/replay/plots.py): ``learning_curve.png`` in the log dir.

    python -m srl_tpu_torch.replay.plots --log-dir LOG_DIR [--episode-window 40]
"""
from __future__ import annotations

import argparse

from srl_tpu_torch.experiments.visualize import plot_log_dir
from srl_tpu_torch.utils.logging import printGreen


def main(argv=None):
    parser = argparse.ArgumentParser(description="Plot a past log dir")
    parser.add_argument("--log-dir", type=str, required=True)
    parser.add_argument("--episode-window", type=int, default=40)
    args = parser.parse_args(argv)
    out = plot_log_dir(args.log_dir, episode_window=args.episode_window)
    printGreen(f"Saved {out}" if out else "Nothing drawn")
    return out


if __name__ == "__main__":
    main()
