"""PPO2's running observation normalizer (stable-baselines' VecNormalize,
as the program keeps it), written plainly in float32: Chan et al.'s
parallel update of a mean and a variance (ddof 0) from each step's batch,
starting from mean 0, variance 1 and count 1e-4, applied as
``clip((x - mean) / sqrt(var + 1e-8), -10, 10)``."""
from __future__ import annotations

import torch

CLIP = 10.0
EPS = 1e-8
COUNT0 = 1e-4


def follow(obs: torch.Tensor) -> torch.Tensor:
    """The normalized observations [T + 1, N, ...] of a rollout's raw
    ``obs`` [T + 1, N, ...]: step ``t`` (of T) first adds its batch to the
    statistics, then is normalized with them; the last observation (the
    bootstrap's) is normalized with the statistics after step T - 1."""
    x = obs.to(torch.float32)
    mean = torch.zeros(x.shape[2:], device=x.device)
    var = torch.ones(x.shape[2:], device=x.device)
    count = torch.tensor(COUNT0, device=x.device)
    out = torch.empty_like(x)
    for t in range(x.shape[0]):
        if t < x.shape[0] - 1:
            n = torch.tensor(float(x.shape[1]), device=x.device)
            b_mean, b_var = x[t].mean(0), x[t].var(0, unbiased=False)
            delta = b_mean - mean
            total = count + n
            m2 = var * count + b_var * n + delta * delta * count * n / total
            mean, var, count = mean + delta * n / total, m2 / total, total
        out[t] = torch.clamp((x[t] - mean) / torch.sqrt(var + EPS), -CLIP, CLIP)
    return out
