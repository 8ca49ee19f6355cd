"""Policy distributions (counterpart of srl_tpu/models/distributions.py).

``sample`` draws from an explicit ``torch.Generator``. ``sample(gen,
rows=(lo, n))`` draws for a batch of ``n`` rows and keeps rows ``lo`` on
(as many as the distribution has): a rank of a data-parallel mesh samples
its rows of the one-process draw.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _draw(fn, shape, gen, rows: Optional[Tuple[int, int]], **kwargs) -> torch.Tensor:
    """``fn(shape)`` from ``gen``; with ``rows = (lo, n)``, rows ``lo`` to
    ``lo + shape[0]`` of ``fn((n,) + shape[1:])``."""
    if rows is None:
        return fn(shape, generator=gen, **kwargs)
    lo, n = rows
    return fn((n,) + tuple(shape[1:]), generator=gen, **kwargs)[lo:lo + shape[0]]


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits  # [..., n]

    def sample(self, gen: torch.Generator, rows=None) -> torch.Tensor:
        """Gumbel-max draw: argmax(logits - log(-log(u)))."""
        u = _draw(torch.rand, self.logits.shape, gen, rows, device=self.logits.device)
        u = u.clamp_min(torch.finfo(torch.float32).tiny)
        return torch.argmax(self.logits - torch.log(-torch.log(u)), -1)

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(self.logits, -1)
        return torch.gather(logp, -1, actions.long()[..., None])[..., 0]

    def entropy(self) -> torch.Tensor:
        logp = F.log_softmax(self.logits, -1)
        return -torch.sum(torch.exp(logp) * logp, -1)

    def mode(self) -> torch.Tensor:
        return torch.argmax(self.logits, -1)

    def probs(self) -> torch.Tensor:
        return F.softmax(self.logits, -1)


class DiagGaussian:
    def __init__(self, mean: torch.Tensor, log_std: torch.Tensor):
        self.mean = mean  # [..., d]
        self.log_std = log_std  # broadcastable to mean

    def sample(self, gen: torch.Generator, rows=None) -> torch.Tensor:
        noise = _draw(torch.randn, self.mean.shape, gen, rows, device=self.mean.device,
                      dtype=self.mean.dtype)
        return self.mean + torch.exp(self.log_std) * noise

    def log_prob(self, actions: torch.Tensor) -> torch.Tensor:
        var = torch.exp(2 * self.log_std)
        logp = -0.5 * (torch.square(actions - self.mean) / var
                       + 2 * self.log_std + math.log(2 * math.pi))
        return torch.sum(logp, -1)

    def entropy(self) -> torch.Tensor:
        ent = self.log_std + 0.5 * math.log(2 * math.pi * math.e)
        return torch.sum(ent.expand_as(self.mean), -1)

    def mode(self) -> torch.Tensor:
        return self.mean
