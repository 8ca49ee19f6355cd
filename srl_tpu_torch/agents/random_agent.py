"""The random-action baseline (counterpart of srl_tpu/agents/random_agent.py).

Chunks of 256 vector steps of uniform actions (``torch.randint`` over the
discrete actions, uniform in [-1, 1] for continuous ones) from the agent's
generator, ``"{steps} steps - {fps:.0f} FPS"`` and the callback after each.
With no policy in the loop it measures the env and render rate alone, which
bounds every agent on that env. ``getAction`` draws from an unseeded
``np.random.RandomState()``, as the reference's.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.utils.logging import printGreen

CHUNK = 256


class RandomAgent(BaseRLAgent):
    name = "random_agent"

    def __init__(self, env=None, num_envs: int = 16, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.num_envs = num_envs
        if env is not None:
            self.vec_env = VecEnv(env, num_envs)

    def actions(self, gen: torch.Generator) -> torch.Tensor:
        """One vector step's uniform actions."""
        space, n = self.env.action_space, self.num_envs
        n_act = getattr(space, "n", None)
        if n_act is not None:
            return torch.randint(0, n_act, (n,), generator=gen, device=self.device)
        u = torch.rand((n,) + tuple(space.shape), generator=gen, device=self.device)
        return u * 2 - 1

    @torch.no_grad()
    def learn(self, total_timesteps: int, seed: int = 0, callback: Optional[Callable] = None):
        gen = self._start(seed)
        vstate, _ = self.vec_env.reset(gen)
        t_start = time.time()
        steps = 0
        episode_returns = []
        while steps < total_timesteps:
            rewards, ep_ret = [], []
            for _ in range(CHUNK):
                vstate, tr = self.vec_env.step(vstate, self.actions(gen), gen)
                rewards.append(tr.reward)
                ep_ret.append(tr.episode_return)
            steps += CHUNK * self.num_envs
            er = torch.stack(ep_ret).cpu().numpy()
            episode_returns.extend(er[~np.isnan(er)].tolist())
            fps = steps / max(time.time() - t_start, 1e-9)
            printGreen(f"{steps} steps - {fps:.0f} FPS")
            if callback is not None:
                callback({"self": self, "num_timesteps": steps, "fps": fps,
                          "episode_returns": episode_returns, "episode_lengths": [],
                          "update": steps, "n_updates": total_timesteps, "state": None,
                          "metrics": {"mean_reward_per_step": float(torch.stack(rewards).mean())}},
                         {})
        self.state = vstate
        return vstate

    def getAction(self, observation, dones=None, deterministic: bool = False, *,
                  gen: Optional[torch.Generator] = None):
        """Uniform actions from an unseeded ``np.random.RandomState()``, as
        the reference's (``gen`` is there for the common call forms)."""
        n = len(observation)
        n_act = getattr(self.env.action_space, "n", None)
        rng = np.random.RandomState()
        if n_act is not None:
            return rng.randint(0, n_act, size=n)
        return rng.uniform(-1, 1, size=(n,) + tuple(self.env.action_space.shape))

    def getActionProba(self, observation, dones=None):
        n = len(observation)
        n_act = getattr(self.env.action_space, "n", None)
        if n_act is not None:
            return np.full((n, n_act), 1.0 / n_act)
        return np.zeros((n,) + tuple(self.env.action_space.shape))

    def save(self, save_path: str, _locals=None):
        self._save_pickle(save_path, {"name": self.name, "num_envs": self.num_envs})

    @classmethod
    def load(cls, load_path: str, env=None, args=None, *, device="cuda"):
        return cls(env=env, num_envs=cls._load_pickle(load_path)["num_envs"], device=device)

    def state_to_reference(self, s):
        """``self.state`` as the reference's: the env batch, or None before
        ``learn`` ends (the reference sets it then)."""
        return bridge.to_reference(s, self.seed)
