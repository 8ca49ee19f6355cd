"""Float32 rounding helpers shared by the port's modules."""
from __future__ import annotations

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
