"""Model FLOPs of the MLP actor-critic (two per multiply-add of each
linear layer; biases and activations not counted)."""
from __future__ import annotations

import math

HIDDEN = (64, 64)


def forward_flops(n_in: int, n_actions: int) -> int:
    flops = 0
    for n_out in HIDDEN:
        flops += 2 * n_in * n_out
        n_in = n_out
    return flops + 2 * n_in * (n_actions + 1)


def update_flops(cfg: dict, traffic: dict) -> int:
    """One PPO update of one card's envs: the rollout's forward of every
    step's observations and of the last, then each epoch's forward and
    backward (twice the forward) of the batch."""
    fwd = forward_flops(math.prod(cfg["observation"]), cfg["n_actions"])
    num_envs = traffic["num_envs"] // traffic["dp"]
    batch = num_envs * traffic["n_steps"]
    return (batch + num_envs) * fwd + traffic["noptepochs"] * batch * 3 * fwd
