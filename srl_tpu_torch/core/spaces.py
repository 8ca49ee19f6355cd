"""Action/observation spaces (counterpart of srl_tpu/core/spaces.py).

``sample`` draws a batch from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Space:
    shape: Tuple[int, ...]
    dtype: np.dtype

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        raise NotImplementedError

    def contains(self, x) -> bool:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Discrete(Space):
    n: int = 0

    def __init__(self, n: int):
        object.__setattr__(self, "n", int(n))
        object.__setattr__(self, "shape", ())
        object.__setattr__(self, "dtype", np.dtype(np.int32))

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        return torch.randint(0, self.n, (n,), generator=gen, device=gen.device,
                             dtype=torch.int64)

    def contains(self, x) -> bool:
        return bool(0 <= int(x) < self.n)


@dataclasses.dataclass(frozen=True)
class Box(Space):
    low: np.ndarray = None
    high: np.ndarray = None

    def __init__(self, low, high, shape=None, dtype=np.float32):
        if shape is None:
            shape = np.broadcast(np.asarray(low), np.asarray(high)).shape
        low = np.broadcast_to(np.asarray(low, dtype=dtype), shape)
        high = np.broadcast_to(np.asarray(high, dtype=dtype), shape)
        object.__setattr__(self, "low", low)
        object.__setattr__(self, "high", high)
        object.__setattr__(self, "shape", tuple(shape))
        object.__setattr__(self, "dtype", np.dtype(dtype))

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        shape = (n,) + self.shape
        if np.isfinite(self.low).all() and np.isfinite(self.high).all():
            low = torch.as_tensor(np.array(self.low, np.float32), device=gen.device)
            high = torch.as_tensor(np.array(self.high, np.float32), device=gen.device)
            u = torch.rand(shape, generator=gen, device=gen.device)
            return low + u * (high - low)
        return torch.randn(shape, generator=gen, device=gen.device)

    def contains(self, x) -> bool:
        x = np.asarray(x)
        return bool(
            x.shape == self.shape and (x >= self.low).all() and (x <= self.high).all()
        )
