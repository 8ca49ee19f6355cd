"""ARS, Augmented Random Search (counterpart of srl_tpu/agents/ars.py).

The reference's defaults: 10 antithetic pairs (20 envs), exploration noise
0.02, step size 0.02, the top 2 pairs, ``max_step_amplitude`` 10, ``v2``
running normalization of non-pixel observations, 260 steps a generation.

A linear policy ``obs_flat @ M``, ``M`` [obs_dim, A]. A generation: deltas
``[P, obs_dim, A]``, member ``2p + d`` acting with ``M + (1 - 2d) sigma
delta_p``, all ``2P`` members in lock-step as one ``bmm`` over a fresh env
batch of ``2P`` (``population_returns``: exactly ``max_episode_steps``
steps, each return counted to its first ``done``). Pixels are uint8 and
not scaled (the reference's ``uint8 @ float32`` promotes the raw values).
With ``v2`` the normalizer updates on all ``2P`` observations every step,
finished envs included. Then the pairs ranked by their better direction
with a stable sort (JAX's ``argsort`` is stable), and ``M += step_size /
max(k std(r_top), 1 / max_step_amplitude) * sum (r+ - r-) delta``, the
standard deviation over all ``2k`` returns (ddof 0).

``getActionProba`` does not normalize the observation, though
``getAction`` does, as in the reference (ROADMAP Queue C).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent, as_tensor_on
from srl_tpu_torch.agents.common import population_actions, population_returns
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.core.spaces import Discrete
from srl_tpu_torch.utils.logging import softmax


@dataclasses.dataclass
class ARSConfig:
    num_population: int = 10
    exploration_noise: float = 0.02
    step_size: float = 0.02
    top_population: int = 2
    max_step_amplitude: float = 10.0
    algo_type: str = "v2"  # v2 = running observation normalization
    deterministic: bool = False
    max_episode_steps: int = 260  # steps of a generation's rollout


class ARS(BaseRLAgent):
    name = "ars"
    config_class = ARSConfig

    def __init__(self, env=None, config: ARSConfig = None, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.config = config or ARSConfig()
        assert self.config.top_population <= self.config.num_population
        assert self.config.num_population > 1
        if env is not None:
            self.num_envs = 2 * self.config.num_population
            self.vec_env = VecEnv(env, self.num_envs)
            self.obs_dim = int(np.prod(env.observation_space.shape))
            self.discrete = isinstance(env.action_space, Discrete)
            self.act_dim = (env.action_space.n if self.discrete
                            else int(np.prod(env.action_space.shape)))
            self.M = torch.zeros((self.obs_dim, self.act_dim), dtype=torch.float32,
                                 device=self.device)
            self.obs_norm = (RunningNorm.create((self.obs_dim,), self.device)
                             if self.config.algo_type == "v2" and env.srl_model != "raw_pixels"
                             else None)

    # ---- a generation -----------------------------------------------------------
    def generation(self, M: torch.Tensor, obs_norm: Optional[RunningNorm],
                   gen: torch.Generator, delta=None, gumbel=None, reset_noise=None):
        """One generation from ``M`` and the normalizer (module docstring).
        ``delta`` [P, obs_dim, A], ``gumbel`` [T, 2P, A] (discrete draws) and
        the first reset's noise, when given, replace the draws from ``gen``.
        Returns (M', obs_norm', returns [P, 2])."""
        cfg = self.config
        if delta is None:
            delta = torch.randn((cfg.num_population,) + tuple(M.shape), generator=gen,
                                device=self.device)
        delta = torch.as_tensor(delta, device=self.device)
        act, norm = self.population_policy(M, delta, obs_norm, gen, gumbel)
        r = population_returns(self.vec_env, act, gen, cfg.max_episode_steps,
                               reset_noise).reshape(cfg.num_population, 2)
        return self.update(M, delta, r), norm[0], r

    def population_policy(self, M, delta, obs_norm, gen, gumbel=None):
        """``act(obs, t)`` of the ``2P`` members ``M + (1 - 2d) sigma
        delta_p`` in lock-step (one ``bmm``), updating the normalizer, which
        the returned one-element list holds."""
        cfg, n = self.config, self.num_envs
        signs = torch.tensor([1.0, -1.0], device=self.device).repeat(cfg.num_population)
        member_M = M[None] + signs[:, None, None] * cfg.exploration_noise * torch.repeat_interleave(
            delta, 2, dim=0)
        norm = [obs_norm]

        def act(obs, t):
            flat = obs.reshape(n, -1)
            if norm[0] is not None:
                norm[0] = norm[0].update(flat)
                flat = norm[0].normalize(flat)
            logits = torch.bmm(flat.to(torch.float32)[:, None], member_M)[:, 0]
            return population_actions(logits, self.discrete, cfg.deterministic, gen,
                                      None if gumbel is None else gumbel[t])

        return act, norm

    def update(self, M, delta, r):
        """``M`` after the generation's returns ``r`` [P, 2]: the top pairs by
        their better direction (a stable sort), the step over their deltas."""
        cfg = self.config
        order = torch.argsort(-torch.max(r, 1).values, stable=True)
        top = order[:cfg.top_population]
        delta_sum = torch.einsum("k,kij->ij", r[top, 0] - r[top, 1], delta[top])
        denom = torch.clamp_min(cfg.top_population * torch.std(r[top], unbiased=False),
                                1.0 / cfg.max_step_amplitude)
        return M + cfg.step_size / denom * delta_sum

    def learn(self, total_timesteps: int, seed: int = 0, callback: Optional[Callable] = None):
        """``max(1, total_timesteps // (max_episode_steps 2P))`` generations
        from ``M`` and the normalizer (a loaded policy's, with
        ``self.pretrained``), ``callback(locals, globals)`` after each with
        the generation's mean and best return."""
        cfg = self.config
        steps_per_gen = cfg.max_episode_steps * self.num_envs
        n_generations = max(1, int(total_timesteps) // steps_per_gen)
        gen = self._start(seed)
        M, obs_norm = self.pretrained if self.pretrained is not None else (self.M, self.obs_norm)
        t_start = time.time()
        episode_returns = []
        for g in range(n_generations):
            M, obs_norm, r = self.generation(M, obs_norm, gen)
            mean_r, max_r = float(r.mean()), float(r.max())
            episode_returns.append(mean_r)
            if callback is not None:
                callback({"self": self, "update": g, "n_updates": n_generations,
                          "num_timesteps": (g + 1) * steps_per_gen,
                          "episode_returns": episode_returns, "episode_lengths": [],
                          "metrics": {"mean_return": mean_r, "max_return": max_r},
                          "state": None,
                          "fps": (g + 1) * steps_per_gen / max(time.time() - t_start, 1e-9)},
                         {})
        self.M, self.obs_norm = M, obs_norm
        self.state = (M, obs_norm)
        return M

    # ---- the reference's surface -----------------------------------------------------
    def customArguments(self, parser):
        super().customArguments(parser)
        parser.add_argument("--num-population", type=int, default=10)
        parser.add_argument("--exploration-noise", type=float, default=0.02)
        parser.add_argument("--step-size", type=float, default=0.02)
        parser.add_argument("--top-population", type=int, default=2)
        parser.add_argument("--algo-type", type=str, default="v2", choices=["v1", "v2"])
        parser.add_argument("--max-step-amplitude", type=float, default=10.0)
        parser.add_argument("--deterministic", action="store_true", default=False)
        return parser

    @classmethod
    def getOptParam(cls):
        return {
            "top_population": (int, (1, 5)),
            "exploration_noise": (float, (0, 0.1)),
            "num_population": (int, (5, 50)),
            "step_size": (float, (0, 0.1)),
            "max_step_amplitude": (float, (1, 100)),
        }

    def _logits(self, observation, normalize: bool) -> torch.Tensor:
        obs = as_tensor_on(observation, self.device)
        obs = obs.reshape(len(obs), -1).to(torch.float32)
        if normalize and self.obs_norm is not None:
            obs = self.obs_norm.normalize(obs)
        return obs @ self.M

    @torch.no_grad()
    def getAction(self, observation, dones=None, deterministic: bool = True, *,
                  gen: Optional[torch.Generator] = None):
        """The argmax of the normalized observation's logits, or the logits
        clipped to [-1, 1] (``deterministic`` and ``gen`` are there for the
        common call forms; the reference's ARS always acts so)."""
        logits = self._logits(observation, True)
        if self.discrete:
            return torch.argmax(logits, -1).cpu().numpy()
        return torch.clamp(logits, -1, 1).cpu().numpy()

    @torch.no_grad()
    def getActionProba(self, observation, dones=None):
        """The softmax of the logits of the observation as it is, not
        normalized (the reference's), or the logits."""
        logits = self._logits(observation, False).cpu().numpy()
        return softmax(logits) if self.discrete else logits

    def save(self, save_path: str, _locals=None):
        norm = self.obs_norm
        self._save_pickle(save_path, {
            "name": self.name, "config": dataclasses.asdict(self.config),
            "M": self.M.detach().cpu().numpy(),
            "obs_norm": ({"mean": norm.mean.cpu().numpy(), "var": norm.var.cpu().numpy(),
                          "count": float(norm.count)} if norm is not None else None)})

    @classmethod
    def load(cls, load_path: str, env=None, args=None, *, device="cuda"):
        """The agent of an ``ars`` pickle (either package's): ``M`` and the
        normalizer on ``device``."""
        d = cls._load_pickle(load_path)
        agent = cls(env=env, config=ARSConfig(**d["config"]), device=device)
        agent.M = torch.as_tensor(np.asarray(d["M"], np.float32), device=agent.device)
        if d["obs_norm"] is not None:
            agent.obs_norm = RunningNorm(**{
                k: torch.as_tensor(np.asarray(v, np.float32), device=agent.device)
                for k, v in d["obs_norm"].items()})
        agent.state = (agent.M, agent.obs_norm)
        return agent

    def state_to_reference(self, s):
        """``self.state`` as the reference's: ``(M, RunningNorm)``, or None
        before ``learn`` ends (the reference sets it then)."""
        return bridge.to_reference(s, self.seed)
