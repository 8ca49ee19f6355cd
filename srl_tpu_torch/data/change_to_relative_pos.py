"""Rewrite a dataset's ground-truth states relative to each episode's
target (counterpart of srl_tpu/data/change_to_relative_pos.py):
``ground_truth.npz`` is written again, byte for byte as the reference
writes it.

    python -m srl_tpu_torch.data.change_to_relative_pos --data-folder DIR
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from srl_tpu_torch.utils.logging import printGreen


def convert_to_relative(data_folder: str) -> None:
    gt_path = os.path.join(data_folder, "ground_truth.npz")
    gt = dict(np.load(gt_path, allow_pickle=True))
    states = np.asarray(gt["ground_truth_states"], np.float32)
    targets = np.asarray(gt["target_positions"], np.float32)
    episode_starts = np.load(os.path.join(data_folder, "preprocessed_data.npz"))[
        "episode_starts"]
    episode_idx = np.cumsum(episode_starts) - 1
    d = min(states.shape[1], targets.shape[1])
    states[:, :d] = states[:, :d] - targets[episode_idx][:, :d]
    gt["ground_truth_states"] = states
    np.savez(gt_path, **gt)
    printGreen(f"Rewrote {len(states)} states in {gt_path} to target-relative")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data-folder", type=str, required=True)
    args = parser.parse_args(argv)
    convert_to_relative(args.data_folder)


if __name__ == "__main__":
    main()
