"""Frozen copy of the plain PyTorch in srl_tpu_torch/core/numerics.py,
kept under the benchmark as the yardstick: it imports nothing of the
program.

Float32 rounding helpers shared by the port's modules."""
from __future__ import annotations

import numpy as np
import torch


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as the fused multiply-adds
    that XLA forms from the reference's expressions: the float32 product is
    exact in float64."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root, computed in float64 (exact
    after one rounding). PyTorch's vectorised CPU kernel is off by one ulp
    for some inputs; IEEE float32 square roots (XLA's, CUDA's) are not."""
    return torch.sqrt(x.double()).to(torch.float32)


def linspace(start: float, stop: float, num: int) -> np.ndarray:
    """float32 ``jnp.linspace(start, stop, num)`` as XLA evaluates it under
    jit, bit for bit: ``start * (1 - i * r) + i * (stop * r)`` with ``r =
    float32(1 / (num - 1))`` and the last entry ``stop``. (Eager
    ``jnp.linspace`` and ``torch.linspace`` round other entries differently.)"""
    f32 = np.float32
    r = f32(1.0 / (num - 1))
    i = np.arange(num - 1, dtype=f32)
    head = f32(start) * (f32(1.0) - i * r) + i * (f32(stop) * r)
    return np.append(head, f32(stop)).astype(f32)
