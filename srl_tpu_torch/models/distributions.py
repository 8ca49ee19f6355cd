"""Policy distributions (counterpart of srl_tpu/models/distributions.py).

``sample`` draws from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


class Categorical:
    def __init__(self, logits: torch.Tensor):
        self.logits = logits  # [..., n]

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        """Gumbel-max draw: argmax(logits - log(-log(u)))."""
        u = torch.rand(self.logits.shape, generator=gen, device=self.logits.device)
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

    def sample(self, gen: torch.Generator) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=gen, device=self.mean.device,
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
