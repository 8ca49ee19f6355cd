"""Merge two recorded datasets into one (counterpart of
srl_tpu/data/dataset_fusioner.py): frames, actions, rewards, episode starts,
ground-truth states and target positions concatenated, the second
dataset's episodes renumbered after the first's in ``images_path``, and
``dataset_config.json``/``env_globals.json`` taken from the first. The
sources are removed unless ``--keep-sources``. The files written are byte
for byte the reference's.

    python -m srl_tpu_torch.data.dataset_fusioner --merge SRC1 SRC2 DST [--keep-sources]
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from srl_tpu_torch.srl.episode_saver import load_dataset, save_frames
from srl_tpu_torch.utils.logging import printGreen


def fuse_datasets(src1: str, src2: str, dst: str, remove_sources: bool = True) -> str:
    d1, d2 = load_dataset(src1), load_dataset(src2)
    os.makedirs(dst, exist_ok=False)
    name = os.path.basename(dst.rstrip("/"))
    n_ep1 = int(np.asarray(d1["episode_starts"]).sum())

    def renumber(paths, offset):
        """"<name>/record_XXX/frameYYYYYY" keys under the merged name, the
        episode number XXX moved by ``offset``."""
        out = []
        for p in paths:
            parts = str(p).split("/")
            ep = int(parts[-2].split("_")[1]) + offset
            out.append(f"{name}/record_{ep:03d}/{parts[-1]}")
        return np.asarray(out)

    cat = {k: np.concatenate([d1[k], d2[k]])
           for k in ("observations", "actions", "rewards", "episode_starts",
                     "ground_truth_states", "target_positions")}
    images_path = np.concatenate([renumber(d1["images_path"], 0),
                                  renumber(d2["images_path"], n_ep1)])
    np.savez(os.path.join(dst, "preprocessed_data.npz"), rewards=cat["rewards"],
             actions=cat["actions"], episode_starts=cat["episode_starts"])
    np.savez(os.path.join(dst, "ground_truth.npz"), target_positions=cat["target_positions"],
             ground_truth_states=cat["ground_truth_states"], images_path=images_path)
    save_frames(dst, cat["observations"])
    for extra in ("dataset_config.json", "env_globals.json"):
        src_file = os.path.join(src1, extra)
        if os.path.exists(src_file):
            shutil.copy(src_file, os.path.join(dst, extra))

    if remove_sources:
        shutil.rmtree(src1)
        shutil.rmtree(src2)
    printGreen(f"Merged into {dst}: {len(cat['rewards'])} frames")
    return dst


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="Dataset Fusion")
    parser.add_argument("--merge", nargs=3, metavar=("SRC1", "SRC2", "DST"), required=True)
    parser.add_argument("--keep-sources", action="store_true")
    args = parser.parse_args(argv)
    return fuse_datasets(*args.merge, remove_sources=not args.keep_sources)


if __name__ == "__main__":
    main()
