"""DQN ("deepq"): dueling double Q-learning from a prioritized replay buffer
(counterpart of srl_tpu/agents/dqn.py). Discrete actions only, as the
reference.

The reference's defaults (lr 1e-4 with optax's Adam, a buffer of 1,000
transitions, exploration from 1 to 0.01 over the first tenth of the run,
a TD update every 4 vector steps from 500 env steps on, batches of 32, the
target network copied every 500 env steps, gamma 0.99, proportional
prioritized replay with alpha 0.6 and beta from 0.4 to 1, dueling heads).

A vector step, in the reference's order:

* epsilon-greedy actions, ``epsilon`` linear over ``exploration_fraction``
  of ``total_timesteps``;
* the env step and the insert of its ``num_envs`` transitions (normalized
  observations, for every observation but raw pixels);
* ``global_step += num_envs``;
* a TD update when ``global_step >= learning_starts`` and
  ``(global_step // num_envs) % train_freq == 0``: a batch drawn by
  priority (``beta`` linear over the run), the double-DQN target (the
  online network's argmax, the target network's value), the weighted mean
  Huber loss (delta 1), Adam, and the batch's priorities set to ``|td| +
  1e-6``;
* the target network copied when ``global_step % target_network_update_freq
  < num_envs``.

Every counter is a host int, so the step waits for the device only where
the env does. ``train_step`` takes its draws (the explore uniforms, the
random actions and the batch's indices) as arguments when given, so a test
feeds the ones the reference drew. ``learn`` runs chunks of 64 vector
steps, a callback after each, while fewer than ``total_timesteps`` steps are
done; it takes no ``initial_state``, as the reference's, so ``--resume`` is
refused.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.agents.buffers import ReplayBuffer
from srl_tpu_torch.agents.ppo import ADAM_STATE, EMPTY_STATE
from srl_tpu_torch.bridge import Record
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.core.optim import adam_init, adam_update_
from srl_tpu_torch.models.distributions import Categorical
from srl_tpu_torch.models.policies import _linear, make_torso, torso_kind

ADAM_EPS = 1e-8  # optax.adam's default


@dataclasses.dataclass
class DQNConfig:
    learning_rate: float = 1e-4
    buffer_size: int = 1000
    exploration_fraction: float = 0.1
    exploration_final_eps: float = 0.01
    train_freq: int = 4
    batch_size: int = 32
    learning_starts: int = 500
    target_network_update_freq: int = 500
    gamma: float = 0.99
    prioritized_replay: bool = True
    prioritized_replay_alpha: float = 0.6
    prioritized_replay_beta0: float = 0.4
    dueling: bool = True


class DuelingQNet(nn.Module):
    """The torso, then ``value + adv - mean(adv)`` (dueling) or one ``q``
    layer, each orthogonal sqrt 2."""

    def __init__(self, obs_shape, n_actions: int, torso: str = "mlp", dueling: bool = True):
        super().__init__()
        self.torso_kind = torso
        self.dueling = bool(dueling)
        self.torso = make_torso(obs_shape, torso)
        if self.dueling:
            self.value = _linear(self.torso.out_dim, 1)
            self.adv = _linear(self.torso.out_dim, n_actions)
        else:
            self.q = _linear(self.torso.out_dim, n_actions)

    def forward(self, obs):
        h = self.torso(obs)
        if self.dueling:
            a = self.adv(h)
            return self.value(h) + a - torch.mean(a, -1, keepdim=True)
        return self.q(h)


@dataclasses.dataclass
class DQNState:
    params: Dict[str, torch.Tensor]
    target_params: Dict[str, torch.Tensor]
    opt_state: Optional[dict]  # Adam: {"count", "mu", "nu"}
    buffer: Optional[ReplayBuffer]
    vstate: object
    obs: Optional[torch.Tensor]
    obs_norm: Optional[RunningNorm]
    global_step: int = 0  # env steps taken


class DQN(BaseRLAgent):
    name = "deepq"
    config_class = DQNConfig

    def __init__(self, env=None, num_envs: int = 4, policy: str = "auto",
                 config: DQNConfig = None, normalize_obs: Optional[bool] = None,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.num_envs = num_envs
        self.config = config or DQNConfig()
        self.policy_kind = policy
        self._total_timesteps = 1  # the schedules' horizon, set by learn()
        if env is not None:
            self.n_act = env.action_space.n
            self._setup(normalize_obs)

    def _make_policy(self) -> DuelingQNet:
        return DuelingQNet(self.obs_shape, self.n_act,
                           torso_kind(self.policy_kind, self.obs_shape), self.config.dueling)

    def opt_init(self, params):
        return adam_init(params)

    def q_values(self, params, obs) -> torch.Tensor:
        return functional_call(self.policy, params, (obs,))

    def apply(self, params, obs):
        q = self.q_values(params, obs)
        return Categorical(q), q

    # ---- the schedules, in float32 as the reference computes them ---------
    def epsilon(self, step: int) -> np.float32:
        cfg = self.config
        horizon = np.float32(max(cfg.exploration_fraction * self._total_timesteps, 1.0))
        frac = min(np.float32(step) / horizon, np.float32(1.0))
        return np.float32(1.0) + frac * np.float32(cfg.exploration_final_eps - 1.0)

    def beta(self, step: int) -> np.float32:
        cfg = self.config
        frac = min(np.float32(step) / np.float32(self._total_timesteps), np.float32(1.0))
        return (np.float32(cfg.prioritized_replay_beta0)
                + frac * np.float32(1.0 - cfg.prioritized_replay_beta0))

    # ---- a TD update ----------------------------------------------------------
    def td_loss(self, params, target_params, batch, weights):
        """(the weighted mean Huber loss, the TD errors) of a batch (obs,
        actions, rewards, next_obs, dones), with the double-DQN target."""
        obs, actions, rewards, next_obs, dones = batch
        q = self.q_values(params, obs)
        q_taken = torch.gather(q, 1, actions.long()[:, None])[:, 0]
        with torch.no_grad():
            next_actions = torch.argmax(self.q_values(params, next_obs), 1)
            next_q = torch.gather(self.q_values(target_params, next_obs), 1,
                                  next_actions[:, None])[:, 0]
            target = rewards + self.config.gamma * next_q * (1.0 - dones.to(torch.float32))
        td = q_taken - target
        huber = F.huber_loss(td, torch.zeros_like(td), reduction="none", delta=1.0)
        return torch.mean(weights * huber), td

    def td_update_(self, state: DQNState, idx: Optional[torch.Tensor], gen):
        """One TD update from the buffer at ``state.global_step``, in place on
        the parameters, the Adam state and the priorities; ``idx`` [batch],
        when given, replaces the draw. Returns the loss."""
        cfg, buffer = self.config, state.buffer
        if cfg.prioritized_replay:
            if idx is None:
                idx = buffer.draw_prioritized(gen, cfg.batch_size, cfg.prioritized_replay_alpha)
            batch, weights = buffer.sample_prioritized(
                idx, cfg.prioritized_replay_alpha, self.beta(state.global_step))
        else:
            if idx is None:
                idx = buffer.draw_uniform(gen, cfg.batch_size)
            batch, weights = buffer.sample_uniform(idx)
        names = list(state.params)
        leaves = {k: state.params[k].detach().requires_grad_(True) for k in names}
        loss, td = self.td_loss(leaves, state.target_params, batch, weights)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        adam_update_(state.params, grads, state.opt_state, cfg.learning_rate, ADAM_EPS)
        if cfg.prioritized_replay:
            buffer.update_priorities(idx, td)
        return loss.detach()

    # ---- a vector step ----------------------------------------------------------
    def train_step(self, state: DQNState, gen: torch.Generator, draws=None):
        """One vector step and what follows it (module docstring), in place on
        ``state`` (returned). ``draws`` = (explore uniforms [N], random
        actions [N], batch indices [batch_size]), when given, replace the
        draws from ``gen`` (the indices are used only by a TD update).
        Returns (state, transition, TD loss or None, target copied)."""
        cfg, n = self.config, self.num_envs
        dev = state.obs.device
        obs_norm = state.obs_norm
        if obs_norm is not None:
            obs_norm = obs_norm.update(state.obs)
            norm_obs = obs_norm.normalize(state.obs)
        else:
            norm_obs = state.obs
        with torch.no_grad():
            greedy = torch.argmax(self.q_values(state.params, norm_obs), 1)
        if draws is None:
            random_actions = torch.randint(0, self.n_act, (n,), generator=gen, device=dev)
            uniforms = torch.rand(n, generator=gen, device=dev)
            idx = None
        else:
            uniforms, random_actions, idx = (None if x is None else torch.as_tensor(x, device=dev)
                                             for x in draws)
        explore = uniforms < float(self.epsilon(state.global_step))
        actions = torch.where(explore, random_actions.long(), greedy).to(torch.int32)
        vstate, tr = self.vec_env.step(state.vstate, actions, gen)
        next_norm_obs = obs_norm.normalize(tr.obs) if obs_norm is not None else tr.obs
        state.buffer.add_batch(norm_obs, actions, tr.reward, next_norm_obs, tr.done)
        state.vstate, state.obs, state.obs_norm = vstate, tr.obs, obs_norm
        state.global_step += n
        loss = None
        if (state.global_step >= cfg.learning_starts
                and (state.global_step // n) % cfg.train_freq == 0):
            loss = self.td_update_(state, None if idx is None else idx.long(), gen)
        copied = state.global_step % cfg.target_network_update_freq < n
        if copied:
            state.target_params = {k: v.detach().clone() for k, v in state.params.items()}
        return state, tr, loss, copied

    def init_state(self, gen: torch.Generator, seed: int = 0) -> DQNState:
        """A fresh env batch, Adam state and replay buffer; the parameters
        and normalizer from ``seed`` or of ``self.pretrained``; the target
        network a copy of the parameters."""
        s = BaseRLAgent.init_state(self, gen, seed)
        buffer = ReplayBuffer.create(self.config.buffer_size, self.obs_shape,
                                     self.env.observation_space.dtype, device=self.device)
        return DQNState(params=s.params,
                        target_params={k: v.clone() for k, v in s.params.items()},
                        opt_state=s.opt_state, buffer=buffer, vstate=s.vstate, obs=s.obs,
                        obs_norm=s.obs_norm)

    def learn(self, total_timesteps: int, seed: int = 0, callback: Optional[Callable] = None,
              chunk: int = 64) -> DQNState:
        """Chunks of ``chunk`` vector steps while fewer than
        ``total_timesteps`` env steps are done, ``callback(locals, globals)``
        after each with the chunk's metrics (its mean reward per step, the
        mean TD loss of its updates, NaN without one, and the counts of TD
        updates and target copies)."""
        self._total_timesteps = total_timesteps
        state = self.init_state(self._start(seed), seed)
        episode_returns, episode_lengths = [], []
        t_start = time.time()
        steps = update = 0
        while steps < total_timesteps:
            rewards, ep_ret, ep_len, losses, copies = [], [], [], [], 0
            for _ in range(chunk):
                state, tr, loss, copied = self.train_step(state, self.gen)
                rewards.append(tr.reward)
                ep_ret.append(tr.episode_return)
                ep_len.append(tr.episode_length)
                if loss is not None:
                    losses.append(loss)
                copies += int(copied)
            self.state = state
            steps += chunk * self.num_envs
            update += 1
            ep_ret = torch.stack(ep_ret).cpu().numpy()
            finished = ~np.isnan(ep_ret)
            episode_returns.extend(ep_ret[finished].tolist())
            episode_lengths.extend(torch.stack(ep_len).cpu().numpy()[finished].tolist())
            if callback is not None:
                callback({
                    "self": self, "state": state, "update": update,
                    "n_updates": max(total_timesteps // (chunk * self.num_envs), 1),
                    "num_timesteps": steps,
                    "episode_returns": episode_returns, "episode_lengths": episode_lengths,
                    "metrics": {
                        "mean_reward_per_step": float(torch.stack(rewards).mean()),
                        "td_loss": (float(torch.stack(losses).mean()) if losses
                                    else float("nan")),
                        "td_updates": len(losses), "target_copies": copies},
                    "fps": steps / max(time.time() - t_start, 1e-9),
                }, {})
        self.state = state
        return state

    # ---- acting: greedy, as the reference's ------------------------------------
    @torch.no_grad()
    def getAction(self, observation, dones=None, deterministic: bool = True, *,
                  gen: Optional[torch.Generator] = None):
        """The greedy actions (``deterministic`` and ``gen`` are there for the
        common call forms; the reference's DQN always acts greedily)."""
        return self._act_dist(observation).mode().cpu().numpy()

    # ---- checkpoints and the policy pickle --------------------------------------
    def opt_state_to_reference(self, opt_state):
        adam = Record(ADAM_STATE, args=(np.asarray(opt_state["count"], np.int32),
                                        self._flax(opt_state["mu"]),
                                        self._flax(opt_state["nu"])))
        return (adam, Record(EMPTY_STATE, args=()))

    def state_to_reference(self, s: DQNState) -> Record:
        """The training state as the reference's ``DQNState``: the replay
        buffer too."""
        return Record("srl_tpu.agents.dqn.DQNState", {
            "params": self._flax(s.params),
            "target_params": self._flax(s.target_params),
            "opt_state": self.opt_state_to_reference(s.opt_state),
            "buffer": s.buffer.to_reference(),
            "vstate": bridge.to_reference(s.vstate, self.seed),
            "obs": s.obs.detach().cpu().numpy(),
            "obs_norm": bridge.to_reference(s.obs_norm),
            "key": bridge.fresh_keys(self.seed, 1)[0],
            "global_step": np.asarray(s.global_step, np.int32),
        })

    def loaded_state(self, params, obs_norm) -> DQNState:
        return DQNState(params=params, target_params=params, opt_state=None, buffer=None,
                        vstate=None, obs=None, obs_norm=obs_norm)

    # ---- the reference's surface ---------------------------------------------------
    def customArguments(self, parser):
        super().customArguments(parser)
        parser.add_argument("--prioritized", type=int, default=1)
        parser.add_argument("--dueling", type=int, default=1)
        parser.add_argument("--buffer-size", type=int, default=int(1e3))
        return parser

    @classmethod
    def getOptParam(cls):
        return {
            "learning_rate": (float, (1e-2, 1e-5)),
            "exploration_fraction": (float, (0, 1)),
            "exploration_final_eps": (float, (0, 0.2)),
            "train_freq": (int, (1, 16)),
            "batch_size": (int, (16, 256)),
            "target_network_update_freq": (int, (50, 5000)),
            "gamma": (float, (0.5, 1)),
        }
