"""SAC, soft actor-critic (counterpart of srl_tpu/agents/sac.py).

The reference's defaults (lr 3e-4 for all three of optax's Adams, a buffer
of 50,000 transitions, batches of 64, tau 0.005, gamma 0.99,
``learning_starts`` 100, the entropy temperature learned toward ``-act_dim``).
A squashed-Gaussian actor (``log_std`` clipped to [-20, 2]) and twin Q
critics, each with its own torso, and a Polyak target of the critics.

A vector step (``agents/off_policy.py``): before ``learning_starts`` env
steps the actions are uniform in [-1, 1], then ``tanh`` of the actor's
sample; the insert; then, once ``global_step >= learning_starts``, one
update every vector step: ``train_freq`` is never read, as in the
reference (ROADMAP Queue C). The update, in the reference's order:

1. the target from ``alpha = exp(log_alpha)`` before the step, the actor's
   sample on ``next_obs`` and the minimum of the target twins;
2. the critic loss, the sum of the two MSEs, and an Adam step;
3. the actor loss ``mean(alpha logp - min(q1, q2))`` against the updated
   critics, and an Adam step;
4. with ``ent_coef == "auto"``, the temperature loss
   ``-mean(log_alpha (logp + target_entropy))`` (``logp`` of step 3 held
   constant), and an Adam step;
5. Polyak on the critics: ``(1 - tau) t + tau p``.
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

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
# jnp.log(2 * jnp.pi) in float32.
LOG_2PI = float(np.log(np.float32(2 * np.pi)))


@dataclasses.dataclass
class SACConfig:
    learning_rate: float = 3e-4
    buffer_size: int = 50_000
    batch_size: int = 64
    tau: float = 0.005
    gamma: float = 0.99
    train_freq: int = 1
    learning_starts: int = 100
    ent_coef: str = "auto"  # or a float


class SquashedGaussianActor(Network):
    """The torso (2 x 256 tanh, or the Nature CNN), then the mean and the
    clipped ``log_std`` heads."""

    def __init__(self, obs_shape, act_dim: int, torso: str = "mlp"):
        super().__init__()
        self.torso_kind = torso
        self.torso = make_torso(obs_shape, torso, hidden=(256, 256))
        self.mean = flax_dense(self.torso.out_dim, act_dim)
        self.log_std = flax_dense(self.torso.out_dim, act_dim)

    def names(self):
        return {"torso": _TORSO_NAME[self.torso_kind] + "_0", "mean": "Dense_0",
                "log_std": "Dense_1"}

    def forward(self, obs):
        h = self.torso(obs)
        return self.mean(h), torch.clamp(self.log_std(h), LOG_STD_MIN, LOG_STD_MAX)


class TwinQ(Network):
    """Two critics, each with its own torso: on the MLP, over
    ``[obs_flat, act]``; on the CNN, ``relu(fc([torso(obs), act]))``; then a
    one-unit output."""

    def __init__(self, obs_shape, act_dim: int, torso: str = "mlp"):
        super().__init__()
        self.torso_kind = torso
        for q in ("q1", "q2"):
            t = make_torso(obs_shape, torso, hidden=(256, 256), extra=act_dim)
            self.add_module(f"{q}_torso", t)
            n = t.out_dim
            if torso == "cnn":
                self.add_module(f"{q}_fc", flax_dense(n + act_dim, 256))
                n = 256
            self.add_module(f"{q}_out", flax_dense(n, 1))

    def names(self):
        base = _TORSO_NAME[self.torso_kind]
        return {"q1_torso": base + "_0", "q2_torso": base + "_1"}

    def _q(self, q, obs, act):
        torso = getattr(self, f"{q}_torso")
        if self.torso_kind == "mlp":
            h = torso(torch.cat([obs.reshape(obs.shape[0], -1).to(act.dtype), act], -1))
        else:
            h = torch.relu(getattr(self, f"{q}_fc")(torch.cat([torso(obs), act], -1)))
        return getattr(self, f"{q}_out")(h)[..., 0]

    def forward(self, obs, act):
        return self._q("q1", obs, act), self._q("q2", obs, act)


def sample_action(mean, log_std, eps):
    """``tanh(mean + std eps)`` and its log-probability, the reference's
    ``_sample_action`` given its normal draws ``eps``."""
    action = torch.tanh(mean + torch.exp(log_std) * eps)
    logp = torch.sum(-0.5 * (torch.square(eps) + 2 * log_std + LOG_2PI)
                     - torch.log(1 - torch.square(action) + 1e-6), -1)
    return action, logp


@dataclasses.dataclass
class SACState(OffPolicyState):
    target_critic_params: Optional[Dict[str, torch.Tensor]] = None
    log_alpha: Optional[torch.Tensor] = None  # float32 scalar
    actor_opt: Optional[dict] = None  # Adam: {"count", "mu", "nu"}
    critic_opt: Optional[dict] = None
    alpha_opt: Optional[dict] = None  # Adam over {"log_alpha": ...}


class SAC(OffPolicyAgent):
    name = "sac"
    config_class = SACConfig

    def _make_nets(self):
        return (SquashedGaussianActor(self.obs_shape, self.act_dim, self.torso),
                TwinQ(self.obs_shape, self.act_dim, self.torso))

    @property
    def target_entropy(self) -> float:
        return -float(self.act_dim)

    def init_state(self, gen: torch.Generator, seed: int = 0) -> SACState:
        """A fresh env batch, Adam states and replay buffer; the parameters
        from ``seed``, or those of ``self.pretrained`` (its ``log_alpha``
        too); the target critics a copy."""
        vstate, obs = self.vec_env.reset(gen)
        actor, critic, norm = self.start_params(seed)
        if self.pretrained is not None:
            log_alpha = self.pretrained.log_alpha.detach().clone()
        elif self.config.ent_coef == "auto":
            log_alpha = torch.zeros((), dtype=torch.float32, device=self.device)
        else:
            log_alpha = torch.log(torch.tensor(float(self.config.ent_coef), device=self.device))
        return SACState(actor_params=actor, critic_params=critic, buffer=self.new_buffer(),
                        vstate=vstate, obs=obs, obs_norm=self.new_norm(norm),
                        target_critic_params={k: v.clone() for k, v in critic.items()},
                        log_alpha=log_alpha, actor_opt=adam_init(actor),
                        critic_opt=adam_init(critic),
                        alpha_opt=adam_init({"log_alpha": log_alpha}))

    # ---- the update ----------------------------------------------------------------
    def update_parts(self, state: SACState, batch, noise) -> tuple:
        """The update from ``batch`` (obs, actions, rewards, next_obs, dones)
        with the normal draws ``noise`` = (for ``next_obs``, for the actor
        loss), each [batch, act_dim], as its parts in order: [(name, fn)],
        each ``fn()`` doing its part in place on the parameters, the Adam
        states, the temperature and the target critics (``update_`` runs
        them; a profile times them), and ``ctx``, where the losses land."""
        cfg, ctx = self.config, {}
        obs, actions, rewards, next_obs, dones = batch
        eps_next, eps_pi = noise
        alpha = torch.exp(state.log_alpha)

        @torch.no_grad()
        def target():
            mean, log_std = self.actor_apply(state.actor_params, next_obs)
            next_act, next_logp = sample_action(mean, log_std, eps_next)
            tq1, tq2 = self.critic_apply(state.target_critic_params, next_obs, next_act)
            ctx["target"] = rewards + cfg.gamma * (1 - dones.to(torch.float32)) * (
                torch.minimum(tq1, tq2) - alpha * next_logp)

        def critic():
            leaves = {k: v.detach().requires_grad_(True) for k, v in state.critic_params.items()}
            q1, q2 = self.critic_apply(leaves, obs, actions)
            t = ctx["target"]
            loss = torch.mean(torch.square(q1 - t)) + torch.mean(torch.square(q2 - t))
            ctx["critic_grads"] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            ctx["critic_loss"] = loss.detach()

        def actor():
            leaves = {k: v.detach().requires_grad_(True) for k, v in state.actor_params.items()}
            mean, log_std = self.actor_apply(leaves, obs)
            act, logp = sample_action(mean, log_std, eps_pi)
            q1, q2 = self.critic_apply(state.critic_params, obs, act)  # the updated critics
            loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
            ctx["actor_grads"] = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            ctx["actor_loss"], ctx["logp"] = loss.detach(), logp.detach()

        def temperature():
            if cfg.ent_coef == "auto":
                # d/dla of -mean(la (logp + target_entropy)), logp held constant.
                grad = -torch.mean(ctx["logp"] + self.target_entropy)
                adam_update_({"log_alpha": state.log_alpha}, {"log_alpha": grad},
                             state.alpha_opt, cfg.learning_rate, ADAM_EPS)

        return [
            ("target", target), ("critic", critic),
            ("critic_adam", lambda: adam_update_(state.critic_params, ctx["critic_grads"],
                                                 state.critic_opt, cfg.learning_rate, ADAM_EPS)),
            ("actor", actor),
            ("actor_adam", lambda: adam_update_(state.actor_params, ctx["actor_grads"],
                                                state.actor_opt, cfg.learning_rate, ADAM_EPS)),
            ("alpha", temperature),
            ("polyak", lambda: self.polyak_(state.target_critic_params, state.critic_params,
                                            cfg.tau)),
        ], ctx

    # ---- a vector step -----------------------------------------------------------------
    def train_step(self, state: SACState, gen: torch.Generator, draws=None):
        """One vector step and its update, in place on ``state`` (returned).
        ``draws`` = (warm-up uniforms in [-1, 1] [N, A], acting normals [N,
        A], batch indices [batch], the update's normals for ``next_obs`` and
        for the actor loss [batch, A]), when given, replace the draws from
        ``gen``. Returns (state, transition, losses or None)."""
        cfg, dev = self.config, self.device
        uniforms, act_noise, idx, eps_next, eps_pi = draws or (None,) * 5
        norm_obs = self.observe_(state)
        actions = self.act(state, norm_obs, gen, uniforms, act_noise)
        tr = self.step_env_(state, norm_obs, actions, gen)
        losses = None
        if state.global_step >= cfg.learning_starts:
            batch = self.batch(state, idx, gen)
            shape = (cfg.batch_size, self.act_dim)
            noise = tuple(torch.as_tensor(e, device=dev) if e is not None else
                          torch.randn(shape, generator=gen, device=dev)
                          for e in (eps_next, eps_pi))
            losses = self.update_(state, batch, noise)
        return state, tr, losses

    @torch.no_grad()
    def act(self, state: SACState, norm_obs, gen, uniforms=None, act_noise=None):
        """A vector step's actions: uniform in [-1, 1] before
        ``learning_starts`` env steps, then the actor's sample (each draw
        from ``gen`` unless given)."""
        n, dev = self.num_envs, self.device
        if state.global_step < self.config.learning_starts:
            if uniforms is None:
                return torch.rand((n, self.act_dim), generator=gen, device=dev) * 2 - 1
            return torch.as_tensor(uniforms, device=dev)
        if act_noise is None:
            act_noise = torch.randn((n, self.act_dim), generator=gen, device=dev)
        mean, log_std = self.actor_apply(state.actor_params, norm_obs)
        return sample_action(mean, log_std, torch.as_tensor(act_noise, device=dev))[0]

    def chunk_metrics(self, state) -> dict:
        return {"alpha": float(torch.exp(state.log_alpha))}

    # ---- acting ---------------------------------------------------------------------------
    @torch.no_grad()
    def getAction(self, observation, dones=None, deterministic: bool = True, *,
                  gen: Optional[torch.Generator] = None):
        """``tanh`` of the actor's mean, or of a sample from ``gen`` (else
        the agent's own acting generator)."""
        mean, log_std = self.actor_apply(self.state.actor_params,
                                         self._normalized_input(observation))
        if deterministic:
            return torch.tanh(mean).cpu().numpy()
        eps = torch.randn(mean.shape, generator=self._sampling_gen(gen), device=self.device)
        return sample_action(mean, log_std, eps)[0].cpu().numpy()

    @torch.no_grad()
    def getActionProba(self, observation, dones=None):
        mean, _ = self.actor_apply(self.state.actor_params, self._normalized_input(observation))
        return torch.tanh(mean).cpu().numpy()

    # ---- the policy pickle and checkpoints ----------------------------------------------
    def policy_payload(self) -> dict:
        return {**super().policy_payload(), "log_alpha": float(self.state.log_alpha)}

    def loaded_state(self, actor, critic, obs_norm, payload) -> SACState:
        return SACState(actor_params=actor, critic_params=critic, buffer=None, vstate=None,
                        obs=None, obs_norm=obs_norm,
                        log_alpha=torch.tensor(np.float32(payload["log_alpha"]),
                                               device=self.device))

    def state_to_reference(self, s: SACState) -> Record:
        """The training state as the reference's ``SACState``: the replay
        buffer too."""
        empty = Record(EMPTY_STATE, args=())
        alpha_tree = lambda t: t["log_alpha"].detach().cpu().numpy()
        return Record("srl_tpu.agents.sac.SACState", {
            "actor_params": self._flax_actor(s.actor_params),
            "critic_params": self._flax_critic(s.critic_params),
            "target_critic_params": self._flax_critic(s.target_critic_params),
            "log_alpha": s.log_alpha.detach().cpu().numpy(),
            "actor_opt": (adam_to_reference(s.actor_opt, self._flax_actor), empty),
            "critic_opt": (adam_to_reference(s.critic_opt, self._flax_critic), empty),
            "alpha_opt": (adam_to_reference(s.alpha_opt, alpha_tree), empty),
            **self.common_reference_fields(s),
        })

    @classmethod
    def getOptParam(cls):
        return {
            "learning_rate": (float, (1e-2, 1e-5)),
            "batch_size": (int, (16, 256)),
            "tau": (float, (0, 0.1)),
            "gamma": (float, (0.5, 1)),
            "train_freq": (int, (1, 16)),
        }
