"""Running observation normalization (counterpart of
srl_tpu/core/normalize.py).

A parallel (Chan et al.) running mean and variance over observation batches,
variance with ddof 0, applied as ``clip((x - mean) / sqrt(var + eps), +-10)``.
``save``/``load`` write and read the reference's ``obs_rms.pkl``
(``{"mean", "var": float32 numpy, "count": float}``), so either package
reads the other's file.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from srl_tpu_torch.core.device import host_tensor

CLIP_OBS = 10.0
EPS = 1e-8


@dataclasses.dataclass
class RunningNorm:
    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor  # float32 scalar

    @classmethod
    def create(cls, shape, device="cpu") -> "RunningNorm":
        f32 = dict(dtype=torch.float32, device=device)
        return cls(mean=torch.zeros(shape, **f32), var=torch.ones(shape, **f32),
                   count=torch.tensor(1e-4, **f32))

    def update(self, batch: torch.Tensor, mesh=None) -> "RunningNorm":
        """Chan et al. parallel update from a [B, ...] batch; with ``mesh``
        (a ``parallel.mesh.Mesh``), from the batch of every rank of the dp
        group, its count, mean and squared deviations all-reduced (the ranks
        of a tp group hold the same rows: over the world each would count tp
        times)."""
        batch = batch.to(torch.float32)
        if mesh is None:
            batch_mean = batch.mean(0)
            batch_var = batch.var(0, unbiased=False)
            batch_count = host_tensor(float(batch.shape[0]), torch.float32, batch.device)
        else:
            batch_mean, batch_var, batch_count = mesh.moments(batch)
        delta = batch_mean - self.mean
        tot = self.count + batch_count
        new_mean = self.mean + delta * batch_count / tot
        m_a = self.var * self.count
        m_b = batch_var * batch_count
        m2 = m_a + m_b + torch.square(delta) * self.count * batch_count / tot
        return RunningNorm(mean=new_mean, var=m2 / tot, count=tot)

    def normalize(self, x: torch.Tensor, clip: float = CLIP_OBS) -> torch.Tensor:
        out = (x - self.mean) / torch.sqrt(self.var + EPS)
        return torch.clamp(out, -clip, clip)

    def save(self, path: str, name: str = "obs_rms"):
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, f"{name}.pkl"), "wb") as f:
            pickle.dump({"mean": self.mean.detach().cpu().numpy(),
                         "var": self.var.detach().cpu().numpy(),
                         "count": float(self.count)}, f)

    @classmethod
    def load(cls, path: str, name: str = "obs_rms", device="cpu") -> "RunningNorm":
        """Only load files this program or the reference wrote: unpickling
        runs code."""
        with open(os.path.join(path, f"{name}.pkl"), "rb") as f:
            d = pickle.load(f)
        f32 = dict(dtype=torch.float32, device=device)
        return cls(mean=torch.as_tensor(np.asarray(d["mean"]), **f32),
                   var=torch.as_tensor(np.asarray(d["var"]), **f32),
                   count=torch.tensor(d["count"], **f32))
