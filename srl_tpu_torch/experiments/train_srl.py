"""SRL encoder training CLI (counterpart of srl_tpu/experiments/train_srl.py).

Trains an encoder on a recorded dataset and writes a checkpoint directory
that ``config/srl_models.yaml`` can name: ``exp_config.json``,
``srl_model.pkl`` (or ``pca.pkl``), and ``history.json`` with each epoch's
last-minibatch losses, ``images_trained``, the seconds and the img/s.
``random`` saves the initial encoder untrained; ``pca`` fits the PCA
baseline.

Usage:
  python -m srl_tpu_torch.experiments.train_srl --data-folder data/mobilerobotgymenv \\
      --srl-model autoencoder --state-dim 3 --epochs 5 \\
      --log-dir srl_logs/MobileRobotGymEnv-v0/autoencoder [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.srl import SRLType
from srl_tpu_torch.srl.episode_saver import load_dataset
from srl_tpu_torch.srl.registry import registered_srl
from srl_tpu_torch.srl.trainer import SRLTrainer, fit_pca, save_pca
from srl_tpu_torch.utils.logging import printGreen, printYellow


def train_srl_model(
    data_folder: str,
    srl_model: str,
    state_dim: int = 3,
    epochs: int = 10,
    batch_size: int = 64,
    learning_rate: float = 1e-3,
    seed: int = 0,
    log_dir: str = None,
    n_actions: int = None,
    device="cuda",
) -> str:
    """Train ``srl_model`` on the dataset; returns the checkpoint's path."""
    entry = registered_srl[srl_model]
    if entry["type"] != SRLType.SRL:
        raise ValueError(f"'{srl_model}' is an environment-provided mode, not a "
                         "trainable model")
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = load_dataset(data_folder)
    if log_dir is None:
        log_dir = os.path.join("srl_logs", os.path.basename(data_folder), srl_model)

    if srl_model == "pca":
        path = save_pca(fit_pca(data["observations"], state_dim, dev), log_dir)
        printGreen(f"PCA baseline saved to {path}")
        return path

    if n_actions is None:
        actions = np.asarray(data["actions"])
        n_actions = int(actions.max()) + 1 if actions.ndim == 1 else 4
    obs_shape = tuple(np.asarray(data["observations"]).shape[1:])
    trainer = SRLTrainer(
        state_dim=state_dim, losses=entry["losses"], image_obs=len(obs_shape) == 3,
        obs_shape=obs_shape, n_actions=n_actions, learning_rate=learning_rate, seed=seed,
        split_dimensions=entry.get("splits") or None, device=dev)
    epochs = 0 if srl_model == "random" else epochs  # random: the initial encoder
    t0 = time.perf_counter()
    out = trainer.fit(
        data, epochs=epochs, batch_size=batch_size,
        log_fn=lambda e, logs: printYellow(
            f"epoch {e}: " + " ".join(f"{k}={v:.4f}" for k, v in logs.items())))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    rate = out["images_trained"] / max(seconds, 1e-9)
    if epochs:
        printGreen(f"trained on {out['images_trained']} images in {seconds:.1f}s "
                   f"({rate:.0f} img/s)")
    path = trainer.save(log_dir)
    with open(os.path.join(log_dir, "history.json"), "w") as f:
        json.dump({**out, "seconds": seconds, "img_per_s": rate}, f, indent=2)
    printGreen(f"SRL model '{srl_model}' saved to {path}")
    return path


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="SRL encoder training (PyTorch port)")
    parser.add_argument("--data-folder", type=str, required=True)
    parser.add_argument("--srl-model", type=str, default="autoencoder",
                        choices=list(registered_srl))
    parser.add_argument("--state-dim", type=int, default=3)
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--learning-rate", type=float, default=1e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-dir", type=str, default=None)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    return train_srl_model(args.data_folder, args.srl_model, args.state_dim, args.epochs,
                           args.batch_size, args.learning_rate, args.seed, args.log_dir,
                           device=args.device)


if __name__ == "__main__":
    main()
