"""DDPG, deterministic policy gradient with action and parameter noise
(counterpart of srl_tpu/agents/ddpg.py).

The reference's defaults: the actor's Adam at 1e-4; the critic's
``optax.chain(add_decayed_weights(1e-2), adam(1e-3))``, which adds
``1e-2 * p`` to the gradient of every critic parameter, the biases too,
before Adam (ROADMAP Queue C); gamma 0.99, tau 0.001, batches of 128, a
buffer of 50,000, ``learning_starts`` 100; Ornstein-Uhlenbeck action noise
(theta 0.15, sigma 0.2).

A vector step (``agents/off_policy.py``): the actor's actions, from
parameters each perturbed by ``param_noise_sigma * N(0, 1)`` with
``noise_param`` (the sigma is never adapted, as in the reference), plus
the OU state ``ou - theta ou + sigma N(0, 1)`` (never reset at ``done``) or
``sigma N(0, 1)`` (``"normal"``) or nothing (``"none"``), clipped to
[-1, 1]; the insert; one update once ``global_step >= learning_starts``:
the target from the target actor and target critic, the critic's step,
the actor's step against the updated critic, then Polyak on both targets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from srl_tpu_torch.agents.off_policy import (ADAM_EPS, _TORSO_NAME, Network, OffPolicyAgent,
                                             OffPolicyState, adam_to_reference, flax_dense)
from srl_tpu_torch.agents.ppo import EMPTY_STATE
from srl_tpu_torch.bridge import Record
from srl_tpu_torch.core.optim import adam_init, adam_update_
from srl_tpu_torch.models.policies import make_torso


@dataclasses.dataclass
class DDPGConfig:
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    critic_l2_reg: float = 1e-2
    buffer_size: int = 50_000
    batch_size: int = 128
    tau: float = 0.001
    gamma: float = 0.99
    learning_starts: int = 100
    noise_action: str = "ou"  # "ou" | "normal" | "none"
    noise_action_sigma: float = 0.2
    noise_param: bool = False
    noise_param_sigma: float = 0.2
    ou_theta: float = 0.15


class Actor(Network):
    """``tanh(out(torso(obs)))``, the torso 2 x 64 tanh or the Nature CNN."""

    def __init__(self, obs_shape, act_dim: int, torso: str = "mlp"):
        super().__init__()
        self.torso_kind = torso
        self.torso = make_torso(obs_shape, torso, hidden=(64, 64))
        self.out = flax_dense(self.torso.out_dim, act_dim)

    def names(self):
        return {"torso": _TORSO_NAME[self.torso_kind] + "_0", "out": "Dense_0"}

    def forward(self, obs):
        return torch.tanh(self.out(self.torso(obs)))


class Critic(Network):
    """On the MLP, ``out(torso([obs_flat, act]))``; on the CNN,
    ``out(relu(fc([torso(obs), act])))``."""

    def __init__(self, obs_shape, act_dim: int, torso: str = "mlp"):
        super().__init__()
        self.torso_kind = torso
        self.torso = make_torso(obs_shape, torso, hidden=(64, 64), extra=act_dim)
        n = self.torso.out_dim
        if torso == "cnn":
            self.fc = flax_dense(n + act_dim, 64)
            n = 64
        self.out = flax_dense(n, 1)

    def names(self):
        names = {"torso": _TORSO_NAME[self.torso_kind] + "_0", "out": "Dense_0"}
        if self.torso_kind == "cnn":
            names.update(fc="Dense_0", out="Dense_1")
        return names

    def forward(self, obs, act):
        if self.torso_kind == "mlp":
            h = self.torso(torch.cat([obs.reshape(obs.shape[0], -1).to(act.dtype), act], -1))
        else:
            h = torch.relu(self.fc(torch.cat([self.torso(obs), act], -1)))
        return self.out(h)[..., 0]


@dataclasses.dataclass
class DDPGState(OffPolicyState):
    target_actor: Optional[Dict[str, torch.Tensor]] = None
    target_critic: Optional[Dict[str, torch.Tensor]] = None
    actor_opt: Optional[dict] = None  # Adam: {"count", "mu", "nu"}
    critic_opt: Optional[dict] = None  # Adam after the weight decay
    ou_state: Optional[torch.Tensor] = None  # [N, act_dim]
    param_noise_sigma: float = 0.0


class DDPG(OffPolicyAgent):
    name = "ddpg"
    config_class = DDPGConfig

    def _make_nets(self):
        return (Actor(self.obs_shape, self.act_dim, self.torso),
                Critic(self.obs_shape, self.act_dim, self.torso))

    def init_state(self, gen: torch.Generator, seed: int = 0) -> DDPGState:
        """A fresh env batch, Adam states, replay buffer and OU state; the
        parameters from ``seed`` or of ``self.pretrained``; the targets a
        copy."""
        vstate, obs = self.vec_env.reset(gen)
        actor, critic, norm = self.start_params(seed)
        copy = lambda p: {k: v.clone() for k, v in p.items()}
        return DDPGState(actor_params=actor, critic_params=critic, buffer=self.new_buffer(),
                         vstate=vstate, obs=obs, obs_norm=self.new_norm(norm),
                         target_actor=copy(actor), target_critic=copy(critic),
                         actor_opt=adam_init(actor), critic_opt=adam_init(critic),
                         ou_state=torch.zeros((self.num_envs, self.act_dim), device=self.device),
                         param_noise_sigma=self.config.noise_param_sigma)

    # ---- the update ----------------------------------------------------------------
    def update_parts(self, state: DDPGState, batch) -> tuple:
        """The update from ``batch`` (obs, actions, rewards, next_obs, dones)
        as its parts in order, [(name, fn)], each ``fn()`` doing its part in
        place on the parameters, the Adam states and the targets (``update_``
        runs them; a profile times them), and ``ctx``, where the losses
        land."""
        cfg, ctx = self.config, {}
        obs, actions, rewards, next_obs, dones = batch

        @torch.no_grad()
        def target():
            next_act = self.actor_apply(state.target_actor, next_obs)
            ctx["target"] = rewards + cfg.gamma * (1 - dones.to(torch.float32)) * (
                self.critic_apply(state.target_critic, next_obs, next_act))

        def critic():
            leaves = {k: v.detach().requires_grad_(True) for k, v in state.critic_params.items()}
            loss = torch.mean(torch.square(self.critic_apply(leaves, obs, actions)
                                           - ctx["target"]))
            grads = torch.autograd.grad(loss, list(leaves.values()))
            # optax.add_decayed_weights: every critic parameter, the biases too.
            ctx["critic_grads"] = {k: g + cfg.critic_l2_reg * state.critic_params[k]
                                   for k, g in zip(leaves, grads)}
            ctx["critic_loss"] = loss.detach()

        def actor():
            leaves = {k: v.detach().requires_grad_(True) for k, v in state.actor_params.items()}
            loss = -torch.mean(self.critic_apply(state.critic_params, obs,
                                                 self.actor_apply(leaves, obs)))
            ctx["actor_grads"] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            ctx["actor_loss"] = loss.detach()

        def polyak():
            self.polyak_(state.target_actor, state.actor_params, cfg.tau)
            self.polyak_(state.target_critic, state.critic_params, cfg.tau)

        return [
            ("target", target), ("critic", critic),
            ("critic_adam", lambda: adam_update_(state.critic_params, ctx["critic_grads"],
                                                 state.critic_opt, cfg.critic_lr, ADAM_EPS)),
            ("actor", actor),
            ("actor_adam", lambda: adam_update_(state.actor_params, ctx["actor_grads"],
                                                state.actor_opt, cfg.actor_lr, ADAM_EPS)),
            ("polyak", polyak),
        ], ctx

    # ---- a vector step -----------------------------------------------------------------
    def train_step(self, state: DDPGState, gen: torch.Generator, draws=None):
        """One vector step and its update, in place on ``state`` (returned).
        ``draws`` = (action noise normals [N, A], parameter noise normals
        ``{name: [shape]}`` of the actor's parameters, batch indices
        [batch]), when given, replace the draws from ``gen``. Returns
        (state, transition, losses or None)."""
        act_noise, param_noise, idx = draws or (None, None, None)
        norm_obs = self.observe_(state)
        actions = self.act(state, norm_obs, gen, act_noise, param_noise)
        tr = self.step_env_(state, norm_obs, actions, gen)
        losses = None
        if state.global_step >= self.config.learning_starts:
            losses = self.update_(state, self.batch(state, idx, gen))
        return state, tr, losses

    @torch.no_grad()
    def act(self, state: DDPGState, norm_obs, gen, act_noise=None, param_noise=None):
        """A vector step's actions (module docstring), in place on the OU
        state; each draw from ``gen`` unless given."""
        cfg, n, dev = self.config, self.num_envs, self.device
        params = state.actor_params
        if cfg.noise_param:
            if param_noise is None:
                param_noise = {k: torch.randn(v.shape, generator=gen, device=dev)
                               for k, v in params.items()}
            params = {k: v + torch.as_tensor(param_noise[k], device=dev)
                      * state.param_noise_sigma for k, v in params.items()}
        actions = self.actor_apply(params, norm_obs)
        if cfg.noise_action != "none":
            if act_noise is None:
                act_noise = torch.randn((n, self.act_dim), generator=gen, device=dev)
            act_noise = torch.as_tensor(act_noise, device=dev)
            if cfg.noise_action == "ou":
                ou = state.ou_state
                state.ou_state = ou - cfg.ou_theta * ou + cfg.noise_action_sigma * act_noise
                actions = actions + state.ou_state
            else:
                actions = actions + cfg.noise_action_sigma * act_noise
        return torch.clamp(actions, -1.0, 1.0)

    # ---- acting: the actor's action, without noise, as the reference's ------------------
    @torch.no_grad()
    def getAction(self, observation, dones=None, deterministic: bool = True, *,
                  gen: Optional[torch.Generator] = None):
        """The actor's action (``deterministic`` and ``gen`` are there for
        the common call forms; the reference's DDPG always acts so)."""
        return self.actor_apply(self.state.actor_params,
                                self._normalized_input(observation)).cpu().numpy()

    def getActionProba(self, observation, dones=None):
        return self.getAction(observation)

    # ---- the policy pickle and checkpoints ----------------------------------------------
    def loaded_state(self, actor, critic, obs_norm, payload) -> DDPGState:
        return DDPGState(actor_params=actor, critic_params=critic, buffer=None, vstate=None,
                         obs=None, obs_norm=obs_norm)

    def state_to_reference(self, s: DDPGState) -> Record:
        """The training state as the reference's ``DDPGState``: the replay
        buffer too; the critic's optimizer state is the chain's
        ``(EmptyState, (ScaleByAdamState, EmptyState))``."""
        empty = Record(EMPTY_STATE, args=())
        return Record("srl_tpu.agents.ddpg.DDPGState", {
            "actor_params": self._flax_actor(s.actor_params),
            "critic_params": self._flax_critic(s.critic_params),
            "target_actor": self._flax_actor(s.target_actor),
            "target_critic": self._flax_critic(s.target_critic),
            "actor_opt": (adam_to_reference(s.actor_opt, self._flax_actor), empty),
            "critic_opt": (empty, (adam_to_reference(s.critic_opt, self._flax_critic), empty)),
            "ou_state": s.ou_state.detach().cpu().numpy(),
            "param_noise_sigma": np.asarray(s.param_noise_sigma, np.float32),
            **self.common_reference_fields(s),
        })

    # ---- the reference's surface ---------------------------------------------------
    def customArguments(self, parser):
        super().customArguments(parser)
        parser.add_argument("--memory-limit", type=int, default=50000)
        parser.add_argument("--noise-action", choices=["none", "normal", "ou"], default="ou")
        parser.add_argument("--noise-action-sigma", type=float, default=0.2)
        parser.add_argument("--noise-param", action="store_true", default=False)
        parser.add_argument("--noise-param-sigma", type=float, default=0.2)
        parser.add_argument("--batch-size", type=int, default=128)
        return parser

    @classmethod
    def getOptParam(cls):
        return {
            "actor_lr": (float, (1e-2, 1e-6)),
            "critic_lr": (float, (1e-2, 1e-6)),
            "batch_size": (int, (16, 512)),
            "gamma": (float, (0.5, 1)),
            "tau": (float, (0, 0.1)),
            "noise_action_sigma": (float, (0, 1)),
        }
