"""On-device replay buffer, uniform and proportional-prioritized
(counterpart of srl_tpu/agents/buffers.py).

Fixed-capacity tensors on the agent's device with a circular write cursor;
``cursor`` and ``size`` are host ints, so inserting and deciding to sample
never wait for the device. The reference samples inside its jitted step
from a threefry key; here each draw is split from its use, so a caller (a
test) can give the indices the reference drew:

* ``draw_uniform(gen, batch)`` / ``sample_uniform(idx)``;
* ``draw_prioritized(gen, batch, alpha)`` / ``sample_prioritized(idx,
  alpha, beta)``.

Proportional priorities: ``P(i) = (p_i + 1e-6)^alpha`` over the valid rows,
normalized; the importance weights ``(n P(i) + 1e-8)^-beta`` divided by their
maximum. New rows get priority ``max(max(p), 1)``, and ``update_priorities``
sets ``|td| + 1e-6``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from srl_tpu_torch import bridge


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (a space's ``dtype``)."""
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


class DeviceStore:
    """A subclass is a dataclass of [C, ...] tensors on the device, then the
    host ints ``cursor`` and ``size``, and names the reference's class of
    the same fields (``ref_name``), which its checkpoint holds."""

    ref_name = None

    def tensor_names(self):
        return [f.name for f in dataclasses.fields(self) if f.name not in ("cursor", "size")]

    @property
    def capacity(self) -> int:
        return len(getattr(self, self.tensor_names()[0]))

    def to_reference(self) -> "bridge.Record":
        """The reference's buffer, as numpy."""
        fields = {name: getattr(self, name).detach().cpu().numpy()
                  for name in self.tensor_names()}
        return bridge.Record(self.ref_name, {**fields,
                                             "cursor": np.asarray(self.cursor, np.int32),
                                             "size": np.asarray(self.size, np.int32)})

    @classmethod
    def from_reference(cls, ref, device="cpu"):
        """The port's buffer of a reference one (a ``bridge.Record`` or the
        reference's own object)."""
        names = [f.name for f in dataclasses.fields(cls) if f.name not in ("cursor", "size")]
        return cls(**{name: torch.as_tensor(np.array(getattr(ref, name)), device=device)
                      for name in names},
                   cursor=int(np.asarray(ref.cursor)), size=int(np.asarray(ref.size)))


@dataclasses.dataclass
class ReplayBuffer(DeviceStore):
    obs: torch.Tensor  # [C, ...]
    actions: torch.Tensor  # [C, ...]
    rewards: torch.Tensor  # [C]
    next_obs: torch.Tensor  # [C, ...]
    dones: torch.Tensor  # [C]
    priorities: torch.Tensor  # [C]
    cursor: int = 0
    size: int = 0

    ref_name = "srl_tpu.agents.buffers.ReplayBuffer"

    @classmethod
    def create(cls, capacity: int, obs_shape, obs_dtype, action_shape=(),
               action_dtype=np.int32, device="cpu") -> "ReplayBuffer":
        zeros = lambda shape, dtype: torch.zeros((capacity,) + tuple(shape),
                                                 dtype=torch_dtype(dtype), device=device)
        return cls(obs=zeros(obs_shape, obs_dtype), actions=zeros(action_shape, action_dtype),
                   rewards=zeros((), np.float32), next_obs=zeros(obs_shape, obs_dtype),
                   dones=zeros((), np.bool_), priorities=zeros((), np.float32))

    def add_batch(self, obs, actions, rewards, next_obs, dones) -> "ReplayBuffer":
        """Insert a [B, ...] batch at the cursor, in place; returns the
        buffer."""
        b = obs.shape[0]
        idx = (self.cursor + torch.arange(b, device=self.obs.device)) % self.capacity
        max_prio = torch.clamp_min(torch.max(self.priorities), 1.0)
        for name, value in (("obs", obs), ("actions", actions), ("rewards", rewards),
                            ("next_obs", next_obs), ("dones", dones)):
            store = getattr(self, name)
            store.index_copy_(0, idx, value.to(store.dtype))
        self.priorities[idx] = max_prio
        self.cursor = (self.cursor + b) % self.capacity
        self.size = min(self.size + b, self.capacity)
        return self

    # ---- drawing indices ------------------------------------------------
    def draw_uniform(self, gen: torch.Generator, batch_size: int) -> torch.Tensor:
        return torch.randint(0, max(self.size, 1), (batch_size,), generator=gen,
                             device=self.obs.device)

    def probabilities(self, alpha: float) -> torch.Tensor:
        """P(i) over the capacity, zero past ``size``."""
        valid = torch.arange(self.capacity, device=self.obs.device) < self.size
        p = torch.where(valid, torch.pow(self.priorities + 1e-6, alpha), 0.0)
        return p / torch.clamp_min(torch.sum(p), 1e-8)

    def draw_prioritized(self, gen: torch.Generator, batch_size: int,
                         alpha: float) -> torch.Tensor:
        return torch.multinomial(self.probabilities(alpha), batch_size, replacement=True,
                                 generator=gen)

    # ---- using them -----------------------------------------------------
    def sample_uniform(self, idx: torch.Tensor) -> Tuple[tuple, torch.Tensor]:
        """(batch, weights) of the rows ``idx``; the weights are ones."""
        return self.gather(idx), torch.ones(idx.shape, dtype=torch.float32,
                                            device=self.obs.device)

    def sample_prioritized(self, idx: torch.Tensor, alpha: float, beta: float):
        """(batch, importance weights) of the rows ``idx``."""
        probs = self.probabilities(alpha)
        n = max(float(self.size), 1.0)
        weights = torch.pow(n * probs[idx] + 1e-8, -float(beta))
        return self.gather(idx), weights / torch.clamp_min(torch.max(weights), 1e-8)

    def update_priorities(self, idx: torch.Tensor, td_errors: torch.Tensor) -> "ReplayBuffer":
        """Priorities ``|td| + 1e-6`` at ``idx``, in place (a repeated index
        carries the same TD error)."""
        self.priorities[idx] = torch.abs(td_errors.detach()) + 1e-6
        return self

    def gather(self, idx: torch.Tensor) -> tuple:
        """(obs, actions, rewards, next_obs, dones) of the rows ``idx``."""
        return (self.obs[idx], self.actions[idx], self.rewards[idx], self.next_obs[idx],
                self.dones[idx])
