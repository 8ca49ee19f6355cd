"""Model FLOPs of a PCA served in the env step and the MLP actor-critic
on its states (two per multiply-add; biases, activations and the frame's
centring not counted)."""
from __future__ import annotations

import math

HIDDEN = (64, 64)


def update_flops(cfg: dict, traffic: dict) -> int:
    """One PPO update of one card's envs: the PCA of every step's frames,
    the policy's forward of every step's states and of the last, then each
    epoch's forward and backward (twice the forward) of the batch."""
    n_in = cfg["state_dim"]
    pca = 2 * math.prod(cfg["frame"]) * n_in
    fwd = 0
    for n_out in HIDDEN:
        fwd += 2 * n_in * n_out
        n_in = n_out
    fwd += 2 * n_in * (cfg["n_actions"] + 1)
    num_envs = traffic["num_envs"] // traffic["dp"]
    batch = num_envs * traffic["n_steps"]
    return batch * pca + (batch + num_envs) * fwd + traffic["noptepochs"] * batch * 3 * fwd
