"""Aggregated curves of several methods in one figure, from the
``{method}.npz`` files of ``aggregate_plots`` (counterpart of
srl_tpu/replay/compare_plots.py): ``comparison.png``.

    python -m srl_tpu_torch.replay.compare_plots -i DIR [--methods A B] \\
        [--title T] [-o OUT.png]
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from srl_tpu_torch.experiments.visualize import no_pyplot, pyplot
from srl_tpu_torch.utils.logging import printGreen


def main(argv=None):
    parser = argparse.ArgumentParser(description="Compare aggregated curves")
    parser.add_argument("-i", "--input-dir", type=str, required=True,
                        help="Directory containing method .npz files")
    parser.add_argument("--methods", type=str, nargs="+", default=None)
    parser.add_argument("--title", type=str, default="")
    parser.add_argument("-o", "--output", type=str, default=None)
    args = parser.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.input_dir, "*.npz")))
    if args.methods:
        files = [f for f in files
                 if os.path.splitext(os.path.basename(f))[0] in args.methods]
    assert files, "no .npz curve files found"
    out = args.output or os.path.join(args.input_dir, "comparison.png")
    plt = pyplot()
    if plt is None:
        no_pyplot(out)
        return None

    fig, ax = plt.subplots(figsize=(8, 5))
    for f in files:
        d = np.load(f)
        ax.plot(d["timesteps"], d["mean"], label=os.path.splitext(os.path.basename(f))[0])
        ax.fill_between(d["timesteps"], d["mean"] - d["stderr"], d["mean"] + d["stderr"],
                        alpha=0.25)
    ax.set_xlabel("timesteps")
    ax.set_ylabel("mean episode reward")
    ax.set_title(args.title)
    ax.legend()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    printGreen(f"Saved {out}")
    return out


if __name__ == "__main__":
    main()
