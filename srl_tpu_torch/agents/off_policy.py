"""What SAC and DDPG share (counterparts of srl_tpu/agents/sac.py and
ddpg.py): continuous actions from a replay buffer, an actor and a critic.

* The networks: the reference's ``MlpTorso`` (tanh, orthogonal sqrt 2) or
  ``NatureCnnTorso`` without ``input_scale`` (on ``--coarse-obs`` the CNN
  runs on the 112x112 image itself), under heads with Flax's default Dense
  init (LeCun normal, zero bias). Each network names its modules for the
  reference's tree (``names()``), which ``bridge.module_state_dict_to_flax``
  maps.
* A vector step: the observations normalized (every observation but raw
  pixels), the agent's actions, the env step, the insert of the
  ``num_envs`` transitions into the ``ReplayBuffer`` (float32
  ``[act_dim]`` actions), ``global_step += num_envs`` (a host int), and one
  update once ``global_step >= learning_starts``. ``train_step`` takes its
  draws as arguments when given, so a test feeds the reference's.
* ``learn`` runs chunks of 64 vector steps while fewer than
  ``total_timesteps`` env steps are done, a callback after each; it takes
  no ``initial_state``, as the reference's, so ``--resume`` is refused.
* The policy pickle holds the actor's and the critic's trees, and a
  checkpoint the whole state, the replay store too (the reference's
  ``save_checkpoint``).
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn
from torch.func import functional_call

from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent, as_tensor_on
from srl_tpu_torch.agents.buffers import ReplayBuffer
from srl_tpu_torch.agents.ppo import ADAM_STATE
from srl_tpu_torch.bridge import Record
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.models.policies import torso_kind

ADAM_EPS = 1e-8  # optax.adam's default
_TORSO_NAME = {"mlp": "MlpTorso", "cnn": "NatureCnnTorso"}


def flax_dense(n_in: int, n_out: int) -> nn.Linear:
    """A Linear with Flax's default init: LeCun normal (truncated at two
    standard deviations, rescaled to variance 1 / fan_in), zero bias."""
    layer = nn.Linear(n_in, n_out)
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2 * std, b=2 * std)
    nn.init.zeros_(layer.bias)
    return layer


class Network(nn.Module):
    """A network whose module names map to the reference's tree through
    ``names()``."""

    def names(self) -> Dict[str, str]:
        raise NotImplementedError


def adam_to_reference(opt_state: dict, to_flax) -> Record:
    return Record(ADAM_STATE, args=(np.asarray(opt_state["count"], np.int32),
                                    to_flax(opt_state["mu"]), to_flax(opt_state["nu"])))


@dataclasses.dataclass
class OffPolicyState:
    """The fields SAC's and DDPG's training states share."""

    actor_params: Dict[str, torch.Tensor]
    critic_params: Dict[str, torch.Tensor]
    buffer: Optional[ReplayBuffer]
    vstate: object
    obs: Optional[torch.Tensor]
    obs_norm: Optional[RunningNorm]
    global_step: int = 0  # env steps taken


class OffPolicyAgent(BaseRLAgent):
    """A subclass builds ``self.actor`` and ``self.critic`` in
    ``_make_nets`` and provides ``init_state``, ``act``, ``update_parts``,
    ``train_step(state, gen, draws=None)`` -> (state, transition, losses or
    None), ``loaded_state`` and ``state_to_reference``."""

    def __init__(self, env=None, num_envs: int = 4, policy: str = "auto", config=None,
                 normalize_obs: Optional[bool] = None, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.num_envs = num_envs
        self.config = config or self.config_class()
        self.policy_kind = policy
        if env is not None:
            self.vec_env = VecEnv(env, num_envs)
            self.obs_shape = tuple(env.observation_space.shape)
            self.act_dim = int(np.prod(env.action_space.shape))
            self.torso = torso_kind(policy, self.obs_shape)
            self.actor, self.critic = (net.to(self.device) for net in self._make_nets())
            if normalize_obs is None:
                normalize_obs = env.srl_model != "raw_pixels"
            self.normalize_obs = normalize_obs

    def _make_nets(self):
        raise NotImplementedError

    def actor_apply(self, params, obs):
        return functional_call(self.actor, params, (obs,))

    def critic_apply(self, params, obs, act):
        return functional_call(self.critic, params, (obs, act))

    def init_params(self, seed: int):
        """Fresh (actor, critic) parameters drawn from ``seed``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            actor, critic = self._make_nets()
        return tuple({k: v.detach().to(self.device) for k, v in net.state_dict().items()}
                     for net in (actor, critic))

    def start_params(self, seed: int):
        """(actor, critic, obs_norm) to start from: fresh from ``seed``, or a
        copy of ``self.pretrained`` (a loaded policy: the fine-tuning
        start)."""
        if self.pretrained is not None:
            copy = lambda p: {k: v.detach().clone() for k, v in p.items()}
            norm = self.pretrained.obs_norm
            return copy(self.pretrained.actor_params), copy(self.pretrained.critic_params), norm
        actor, critic = self.init_params(seed)
        return actor, critic, None

    def new_buffer(self) -> ReplayBuffer:
        return ReplayBuffer.create(self.config.buffer_size, self.obs_shape,
                                   self.env.observation_space.dtype, (self.act_dim,), np.float32,
                                   device=self.device)

    def new_norm(self, obs_norm):
        if obs_norm is None and self.normalize_obs:
            return RunningNorm.create(self.obs_shape, self.device)
        return obs_norm

    # ---- a vector step's shared halves ------------------------------------------
    @staticmethod
    def observe_(state) -> torch.Tensor:
        """The normalizer updated with ``state.obs`` (in place on ``state``)
        and the normalized observations."""
        if state.obs_norm is None:
            return state.obs
        state.obs_norm = state.obs_norm.update(state.obs)
        return state.obs_norm.normalize(state.obs)

    def step_env_(self, state, norm_obs, actions, gen):
        """The env step, the insert of its transitions and the global step,
        in place on ``state``; returns the transition."""
        vstate, tr = self.vec_env.step(state.vstate, actions, gen)
        next_norm = state.obs_norm.normalize(tr.obs) if state.obs_norm is not None else tr.obs
        state.buffer.add_batch(norm_obs, actions, tr.reward, next_norm, tr.done)
        state.vstate, state.obs = vstate, tr.obs
        state.global_step += self.num_envs
        return tr

    def batch(self, state, idx, gen):
        """The update's batch: the rows ``idx`` (the reference's indices),
        else a uniform draw from ``gen``."""
        if idx is None:
            idx = state.buffer.draw_uniform(gen, self.config.batch_size)
        return state.buffer.gather(torch.as_tensor(idx, device=self.device).long())

    def update_(self, state, *args) -> Dict[str, torch.Tensor]:
        """One update (the subclass's ``update_parts(state, *args)``, in its
        order), in place. Returns the losses."""
        parts, ctx = self.update_parts(state, *args)
        for _, part in parts:
            part()
        return {"critic_loss": ctx["critic_loss"], "actor_loss": ctx["actor_loss"]}

    @staticmethod
    def polyak_(target: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor], tau: float):
        """``(1 - tau) t + tau p``, in place on ``target``."""
        with torch.no_grad():
            for k, t in target.items():
                t.mul_(1 - tau).add_(params[k] * tau)

    # ---- the training loop -------------------------------------------------------
    def learn(self, total_timesteps: int, seed: int = 0, callback: Optional[Callable] = None,
              chunk: int = 64):
        """Chunks of ``chunk`` vector steps while fewer than
        ``total_timesteps`` env steps are done, ``callback(locals, globals)``
        after each with the chunk's metrics (the reference's, then the mean
        losses of its updates, NaN without one, and their count)."""
        gen = self._start(seed)
        state = self.init_state(gen, seed)
        episode_returns, episode_lengths = [], []
        t_start = time.time()
        steps = update = 0
        while steps < total_timesteps:
            rewards, ep_ret, ep_len, losses = [], [], [], []
            for _ in range(chunk):
                state, tr, loss = self.train_step(state, gen)
                rewards.append(tr.reward)
                ep_ret.append(tr.episode_return)
                ep_len.append(tr.episode_length)
                if loss is not None:
                    losses.append(loss)
            self.state = state
            steps += chunk * self.num_envs
            update += 1
            ep_ret = torch.stack(ep_ret).cpu().numpy()
            finished = ~np.isnan(ep_ret)
            episode_returns.extend(ep_ret[finished].tolist())
            episode_lengths.extend(torch.stack(ep_len).cpu().numpy()[finished].tolist())
            metrics = {"mean_reward_per_step": float(torch.stack(rewards).mean()),
                       **self.chunk_metrics(state)}
            for name in ("critic_loss", "actor_loss"):
                metrics[name] = (float(torch.stack([x[name] for x in losses]).mean())
                                 if losses else float("nan"))
            metrics["updates"] = len(losses)
            if callback is not None:
                callback({
                    "self": self, "state": state, "update": update,
                    "n_updates": max(total_timesteps // (chunk * self.num_envs), 1),
                    "num_timesteps": steps,
                    "episode_returns": episode_returns, "episode_lengths": episode_lengths,
                    "metrics": metrics,
                    "fps": steps / max(time.time() - t_start, 1e-9),
                }, {})
        self.state = state
        return state

    def chunk_metrics(self, state) -> dict:
        return {}

    # ---- the parameter trees in the reference's layout ---------------------------
    def _flax_actor(self, tree):
        return bridge.module_state_dict_to_flax(tree, self.actor.names())

    def _flax_critic(self, tree):
        return bridge.module_state_dict_to_flax(tree, self.critic.names())

    def _port(self, tree, net):
        return {k: v.to(self.device) for k, v in
                bridge.module_flax_to_state_dict(tree, net.names()).items()}

    def _norm_payload(self, norm):
        return (self._to_numpy({"mean": norm.mean, "var": norm.var, "count": norm.count})
                if norm is not None else None)

    def common_reference_fields(self, s) -> dict:
        return {"buffer": s.buffer.to_reference(),
                "vstate": bridge.to_reference(s.vstate, self.seed),
                "obs": s.obs.detach().cpu().numpy(),
                "obs_norm": bridge.to_reference(s.obs_norm),
                "key": bridge.fresh_keys(self.seed, 1)[0],
                "global_step": np.asarray(s.global_step, np.int32)}

    # ---- the policy pickle ----------------------------------------------------------
    def policy_payload(self) -> dict:
        return {"name": self.name, "config": dataclasses.asdict(self.config),
                "num_envs": self.num_envs, "policy_kind": self.policy_kind,
                "normalize_obs": self.normalize_obs,
                "actor_params": self._flax_actor(self.state.actor_params),
                "critic_params": self._flax_critic(self.state.critic_params),
                "obs_norm": self._norm_payload(self.state.obs_norm)}

    def restore_policy(self, payload: dict):
        norm = payload["obs_norm"]
        if norm is not None:
            norm = RunningNorm(**{k: torch.as_tensor(np.asarray(v, np.float32),
                                                     device=self.device)
                                  for k, v in norm.items()})
        self.state = self.loaded_state(self._port(payload["actor_params"], self.actor),
                                       self._port(payload["critic_params"], self.critic),
                                       norm, payload)

    def _normalized_input(self, observation) -> torch.Tensor:
        obs = as_tensor_on(observation, self.device)
        if self.state.obs_norm is not None:
            obs = self.state.obs_norm.normalize(obs)
        return obs
