"""Recurrent (LSTM) PPO2 (counterpart of srl_tpu/agents/recurrent_ppo.py).

PPO2 with an lstm/lnlstm/cnnlstm/cnnlnlstm policy (``models/recurrent``) and
the reference's tuned hyperparameters (``lstm_ppo_config``: n_steps 609, 4
minibatches, 8 epochs, constant lr). The rollout keeps each step's
episode-start mask ``done_in`` and the carry the segment started from. A
minibatch is a group of whole env columns of the [T, N] segment (one
permutation of the N envs per epoch, ``env_perms`` [noptepochs, N]; hence
``num_envs % nminibatches == 0``), and its loss re-runs the policy over the
segment from the stored initial carry: the torso once over the T x mb
frames, the cell over T. The update's arithmetic is PPO2's (optax's
global-norm clip and Adam, per-minibatch advantage normalization):
``update_epochs(params, opt_state, data, env_perms)`` with ``data`` =
(obs, done_in, carry0, actions, log_probs, values, advantages, returns),
each [T, N, ...] but ``carry0`` ((c, h), each [N, H]).

``RecurrentPolicyMixin`` holds what the recurrent agents over
``LstmActorCritic`` share (RecurrentPPO2 here, RecurrentA2C in ``a2c.py``):
the policy, its bridge to the reference's tree, the state with its carry,
checkpoints as the reference's ``RecurrentPPOState`` and the stateful
acting. Their ``learn`` takes no ``initial_state``: the reference's does
not, so ``--resume`` is refused for them as there.

On a dp x tp mesh (a state from ``parallel.shard_ppo_state``: the rank's env
rows of the batch, of ``done`` and of the carry) the rollout draws for the
whole batch (``collect_recurrent_rollout(mesh=)``); each epoch permutes the
global env columns, and a rank computes the loss terms of the columns of
each minibatch it holds, each from its stored carry over the T steps, as
shares of the global minibatch's means with the advantages normalized by
the global moments; the gradients are summed over the dp group (a rank that
holds none of a minibatch's columns adds zeros and still joins every
all-reduce): PPO2's ``_shard_loss`` / ``_shard_grads`` over env columns.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent, RecurrentActing, episode_metrics
from srl_tpu_torch.agents.common import (collect_recurrent_rollout, compute_gae,
                                         explained_variance)
from srl_tpu_torch.agents.ppo import PPO2, PPOConfig
from srl_tpu_torch.models.recurrent import LstmActorCritic, make_recurrent_policy


def lstm_ppo_config() -> PPOConfig:
    """The reference's tuned recurrent PPO2 hyperparameters."""
    return PPOConfig(
        n_steps=609, nminibatches=4, noptepochs=8, cliprange=0.2,
        learning_rate=0.004923676735761618, lr_linear_decay=False,
        ent_coef=0.06415865069774951, vf_coef=0.056219345567007695,
        max_grad_norm=0.19232704980689763, gamma=0.9752388470759489,
        lam=0.3987544314875193,
    )


@dataclasses.dataclass
class RecurrentPPOState:
    """The training state of the LSTM agents: ``done`` [N] is the
    episode-start mask of the next step, ``lstm_state`` the carry (c, h)."""

    params: dict
    opt_state: Optional[dict]
    vstate: object
    obs: Optional[torch.Tensor]
    done: Optional[torch.Tensor]
    lstm_state: Optional[tuple]
    obs_norm: object
    update_idx: int = 0
    # The mesh the state is laid out on (``parallel.shard_ppo_state``: the
    # rank's rows of the env batch, ``done`` and the carry), else None.
    mesh: Optional[object] = None


class RecurrentPolicyMixin(RecurrentActing):
    """An agent over ``LstmActorCritic`` (before the agent's own class in
    the bases)."""

    policy: LstmActorCritic

    @property
    def n_lstm(self) -> int:
        return self.policy.n_lstm

    def _make_policy(self) -> LstmActorCritic:
        return make_recurrent_policy(self.env.action_space, self.obs_shape, self.policy_kind)

    def apply(self, params, obs, carry, done):
        """(distribution, value, carry') of one step (``done`` [B]) or of a
        [T, B] segment."""
        return torch.func.functional_call(self.policy, params, (obs, carry, done))

    _policy_step = apply

    def _flax(self, tree):
        return bridge.recurrent_state_dict_to_flax(tree)

    def _state_dict(self, tree):
        return {k: v.to(self.device) for k, v in
                bridge.recurrent_flax_to_state_dict(tree).items()}

    def init_state(self, gen: torch.Generator, seed: int = 0) -> RecurrentPPOState:
        s = BaseRLAgent.init_state(self, gen, seed)
        return RecurrentPPOState(
            params=s.params, opt_state=s.opt_state, vstate=s.vstate, obs=s.obs,
            done=torch.zeros(self.num_envs, dtype=torch.bool, device=self.device),
            lstm_state=self.policy.initial_state(self.num_envs, self.device),
            obs_norm=s.obs_norm)

    def rollout(self, state: RecurrentPPOState, gen: torch.Generator):
        """The segment of ``n_steps`` and the values after it: (vstate',
        obs', done', carry', obs_norm', batch, last_value)."""
        whole = self.whole_params(state.params, state.mesh)
        policy = lambda obs, carry, done: self.apply(whole, obs, carry, done)
        vstate, obs, done, carry, obs_norm, last_norm_obs, batch = collect_recurrent_rollout(
            self.vec_env, policy, state.vstate, state.obs, state.done, state.lstm_state,
            state.obs_norm, gen, self.config.n_steps, state.mesh)
        with torch.no_grad():
            _, last_value, _ = policy(last_norm_obs, carry, done)
        return vstate, obs, done, carry, obs_norm, batch, last_value

    def state_to_reference(self, s: RecurrentPPOState) -> bridge.Record:
        s = self.whole_state(s)
        return bridge.Record("srl_tpu.agents.recurrent_ppo.RecurrentPPOState", {
            "params": self._flax(s.params),
            "opt_state": self.opt_state_to_reference(s.opt_state),
            "vstate": bridge.to_reference(s.vstate, self.seed),
            "obs": s.obs.detach().cpu().numpy(),
            "done": s.done.detach().cpu().numpy(),
            "lstm_state": tuple(x.detach().cpu().numpy() for x in s.lstm_state),
            "obs_norm": bridge.to_reference(s.obs_norm),
            "key": bridge.fresh_keys(self.seed, 1)[0],
            "update_idx": np.asarray(s.update_idx, np.int32),
        })

    def loaded_state(self, params, obs_norm) -> RecurrentPPOState:
        return RecurrentPPOState(params=params, opt_state=None, vstate=None, obs=None,
                                 done=None, lstm_state=None, obs_norm=obs_norm)


class RecurrentPPO2(RecurrentPolicyMixin, PPO2):
    name = "ppo2"  # the same algo, an lstm policy
    pickle_name = "ppo2_lstm"
    aux_keys = PPO2.aux_keys + ("loss",)

    def __init__(self, env=None, num_envs: int = 16, policy: str = "lstm",
                 config: PPOConfig = None, normalize_obs: Optional[bool] = None,
                 device="cuda"):
        config = config or lstm_ppo_config()
        if num_envs % config.nminibatches:
            raise AssertionError("Error: recurrent policies need num_envs to be a multiple "
                                 "of nminibatches (ppo2.py:42-43)")
        super().__init__(env=env, num_envs=num_envs, policy=policy, config=config,
                         normalize_obs=normalize_obs, device=device)

    # ---- the minibatch: whole env columns of the segment ---------------------
    def _minibatch(self, data, idx):
        obs, done_in, carry0, *rest = data
        return ((obs[:, idx], done_in[:, idx], (carry0[0][idx], carry0[1][idx])),
                *(x[:, idx] for x in rest))

    def _minibatch_forward(self, params, segment):
        obs, done_in, carry0 = segment
        dist, vpred, _ = self.apply(params, obs, carry0, done_in)
        return dist, vpred

    def _loss(self, params, minibatch, cliprange):
        total, aux = super()._loss(params, minibatch, cliprange)
        aux["loss"] = total.detach()
        return total, aux

    def _shard_loss(self, params, data, idx, mesh):
        """(loss, parts) of this rank's share of the global minibatch ``idx``
        of env columns: the columns in the rank's env slice, each run through
        the T steps from its stored carry, their terms summed and divided by
        the global minibatch's T x len(idx) entries, the advantages
        normalized with the global mean and std. (None, None) where the rank
        owns none of them (it still joins the all-reduces)."""
        lo, hi = mesh.env_slice(self.num_envs)
        local = idx[(idx >= lo) & (idx < hi)] - lo
        segment, *rest = self._minibatch(data, local)
        adv_mean, adv_var, _ = mesh.moments(rest[3].reshape(-1))
        if local.numel() == 0:
            return None, None
        dist, vpred = self._minibatch_forward(params, segment)
        count = data[3].shape[0] * idx.shape[0]
        total, aux = self._objective(dist, vpred, *rest, self.config.cliprange,
                                     mean=lambda x: x.sum() / count,
                                     adv_stats=(adv_mean, torch.sqrt(adv_var)))
        aux["loss"] = total.detach()
        return total, aux

    def train_iteration(self, state: RecurrentPPOState, gen: torch.Generator):
        """One update: the segment, GAE, the epochs over env columns; on the
        state's mesh, each rank computes the columns of each minibatch it
        holds, and the gradients are summed over the dp group."""
        cfg = self.config
        mesh = state.mesh
        vstate, obs, done, carry, obs_norm, batch, last_value = self.rollout(state, gen)
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_value, cfg.gamma, cfg.lam)
        data = (batch.obs, batch.done_in, batch.carry0, batch.actions, batch.log_probs,
                batch.values, advantages, returns)
        env_perms = torch.stack([
            torch.randperm(self.num_envs, generator=gen, device=gen.device)
            for _ in range(cfg.noptepochs)])
        params, opt_state, metrics = self.update_epochs(
            state.params, state.opt_state, data, env_perms, mesh)
        metrics["explained_variance"] = explained_variance(batch.values.reshape(-1),
                                                           returns.reshape(-1), mesh)
        metrics.update(episode_metrics(batch, mesh))
        return RecurrentPPOState(params=params, opt_state=opt_state, vstate=vstate,
                                 obs=obs, done=done, lstm_state=carry, obs_norm=obs_norm,
                                 update_idx=state.update_idx + 1, mesh=mesh), metrics

    def learn(self, total_timesteps: int, seed: int = 0,
              callback: Optional[Callable] = None) -> RecurrentPPOState:
        """``total_timesteps // (n_steps * num_envs)`` updates (at least
        one)."""
        n_updates = max(1, total_timesteps // (self.config.n_steps * self.num_envs))
        self.n_updates = n_updates
        state = self.init_state(self._start(seed), seed)
        return self._run(state, n_updates, callback)

    @classmethod
    def getOptParam(cls):
        # The reference's RecurrentPPO2 derives from the base agent: none.
        return None
