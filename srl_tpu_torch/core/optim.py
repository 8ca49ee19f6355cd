"""optax's Adam over a ``{name: tensor}`` parameter dict, in place.

``optax.adam``: bias-corrected moments and ``m_hat / (sqrt(v_hat) + eps)``
(``torch.optim.Adam`` adds eps to ``sqrt(v) / sqrt(1 - b2^t)`` instead).
The state is ``{"count": steps taken, "mu": {...}, "nu": {...}}``.
"""
from __future__ import annotations

from typing import Dict

import torch

ADAM_B1 = 0.9
ADAM_B2 = 0.999


def adam_init(params: Dict[str, torch.Tensor]) -> dict:
    return {"count": 0,
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


@torch.no_grad()
def adam_update_(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                 opt_state: dict, lr: float, eps: float) -> None:
    """One Adam step of ``params`` and ``opt_state`` at ``lr``, in place."""
    opt_state["count"] += 1
    c1 = 1 - ADAM_B1 ** opt_state["count"]
    c2 = 1 - ADAM_B2 ** opt_state["count"]
    for k, g in grads.items():
        mu = opt_state["mu"][k].mul_(ADAM_B1).add_(g, alpha=1 - ADAM_B1)
        nu = opt_state["nu"][k].mul_(ADAM_B2).addcmul_(g, g, value=1 - ADAM_B2)
        denom = torch.div(nu, c2).sqrt_().add_(eps)
        params[k].add_(torch.div(mu, c1).div_(denom).mul_(-lr))
