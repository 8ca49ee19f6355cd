"""optax's Adam and RMSProp over a ``{name: tensor}`` parameter dict, in
place.

* ``optax.adam``: bias-corrected moments and ``m_hat / (sqrt(v_hat) + eps)``
  (``torch.optim.Adam`` adds eps to ``sqrt(v) / sqrt(1 - b2^t)`` instead).
  The state is ``{"count": steps taken, "mu": {...}, "nu": {...}}``. PPO
  uses eps 1e-5, TRPO's value-function steps optax's default 1e-8.
* ``optax.rmsprop`` (A2C): ``nu = decay * nu + (1 - decay) * g^2`` from
  ``nu = 0``, then ``g * rsqrt(nu + eps)``, eps inside the square root
  (``torch.optim.RMSprop`` computes ``g / (sqrt(nu) + eps)``, another
  function). The state is ``{"count": steps taken, "nu": {...}}``.
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


def rmsprop_init(params: Dict[str, torch.Tensor]) -> dict:
    return {"count": 0, "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


@torch.no_grad()
def rmsprop_update_(params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
                    opt_state: dict, lr: float, decay: float, eps: float) -> None:
    """One RMSProp step of ``params`` and ``opt_state`` at ``lr``, in place."""
    opt_state["count"] += 1
    for k, g in grads.items():
        nu = opt_state["nu"][k]
        nu.copy_(torch.square(g).mul_(1 - decay).add_(nu, alpha=decay))
        params[k].add_(torch.rsqrt(nu + eps).mul_(g).mul_(-lr))
