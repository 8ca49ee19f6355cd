"""A2C, the synchronous advantage actor-critic (counterpart of
srl_tpu/agents/a2c.py): ``A2C`` and, with an lstm policy, ``RecurrentA2C``.

Same defaults as the reference (n_steps 5, vf_coef 0.5, ent_coef 0.01,
max_grad_norm 0.5, RMSProp lr 7e-4 with decay 0.99 and eps 1e-5, gamma
0.99) and the same update: a rollout of ``n_steps``, discounted returns (GAE
with lambda 1), one full-batch gradient step with the advantages held
constant, optax's global-norm clip and optax's RMSProp (``core/optim``).
``lr_schedule="linear"`` decays the lr per update; every other schedule
name is a constant lr, as in the reference. The policy is built without
``input_scale``, as the reference builds it: on coarse observations the
Nature CNN runs on the 112x112 image itself, with no conv1 fold.

``RecurrentA2C`` keeps the carry through the rollout (zeroed at episode
starts) and takes its one full-batch step with backpropagation through time
over the [T, N] segment from the segment's initial carry, its policy
pickle named ``"a2c_lstm"``.

On a dp x tp mesh (a state from ``parallel.shard_ppo_state``) a rank steps
its env rows (and their carry), the draws made for the whole batch; its
loss terms are its shares of the global means (``base.global_mean``), the
one gradient of the update is summed over the dp group (one all-reduce of
the rank's tp shards of it), the clip's norm is global (float64 squares)
and RMSProp steps the rank's shards of the parameters and of ``nu``; with
tp > 1 the whole weights are gathered once for the rollout and once for
the gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from srl_tpu_torch.agents.base import (BaseRLAgent, PPOState, episode_metrics, global_mean,
                                       reduce_losses)
from srl_tpu_torch.agents.common import collect_rollout, compute_gae, explained_variance
from srl_tpu_torch.agents.ppo import EMPTY_STATE, SCHEDULE_STATE, clip_by_global_norm_
from srl_tpu_torch.agents.recurrent_ppo import RecurrentPolicyMixin, RecurrentPPOState
from srl_tpu_torch.bridge import Record
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.optim import rmsprop_init, rmsprop_update_

RMS_STATE = "optax._src.transform.ScaleByRmsState"
LR_SCHEDULES = ["linear", "constant", "double_linear_con", "middle_drop",
                "double_middle_drop"]


@dataclasses.dataclass
class A2CConfig:
    n_steps: int = 5
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    learning_rate: float = 7e-4
    epsilon: float = 1e-5
    alpha: float = 0.99
    gamma: float = 0.99
    lr_schedule: str = "constant"


class A2C(BaseRLAgent):
    name = "a2c"
    SAVE_INTERVAL = 10
    config_class = A2CConfig

    def __init__(self, env=None, num_envs: int = 16, policy: str = "auto",
                 config: A2CConfig = None, normalize_obs: Optional[bool] = None,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.num_envs = num_envs
        self.config = config or A2CConfig()
        self.policy_kind = policy
        self.n_updates = 1  # lr-decay horizon, set by learn()
        if env is not None:
            self._setup(normalize_obs)

    def opt_init(self, params):
        return rmsprop_init(params)

    def learning_rate(self, count: int) -> float:
        """The lr of optimizer step ``count`` (one step an update)."""
        cfg = self.config
        if cfg.lr_schedule == "linear":
            return cfg.learning_rate * max(1.0 - count / max(self.n_updates, 1), 0.0)
        return cfg.learning_rate

    def opt_state_to_reference(self, opt_state):
        lr = (Record(SCHEDULE_STATE, args=(np.asarray(opt_state["count"], np.int32),))
              if self.config.lr_schedule == "linear" else Record(EMPTY_STATE, args=()))
        empty = Record(EMPTY_STATE, args=())
        return (empty, (Record(RMS_STATE, args=(self._flax(opt_state["nu"]),)), lr, empty))

    # ------------------------------------------------------------------
    def _batch_forward(self, params, obs):
        """(distribution, values) of the batch's observations."""
        return self.apply(params, obs)

    def update(self, params, opt_state, data, mesh=None):
        """One full-batch step from the flat batch ``data`` = (obs, actions,
        advantages, returns) (RecurrentA2C: the [T, N] segment, its ``obs``
        the triple (obs, done_in, carry0)): (params', opt_state', losses);
        the inputs are left as they are. With ``mesh``, ``data`` is the
        rank's env rows and ``params`` and ``opt_state`` its tp shards: the
        loss terms are the rank's shares of the global means, the gradient is
        summed over the dp group, and RMSProp steps the shards."""
        obs, *rest = data
        names = list(params)
        whole = self.whole_params(params, mesh)
        leaves = {k: whole[k].detach().requires_grad_(True) for k in names}
        dist, vpred = self._batch_forward(leaves, obs)
        total, losses = self._objective(dist, vpred, *rest,
                                        mean=torch.mean if mesh is None else global_mean(mesh))
        grads = dict(zip(names, torch.autograd.grad(total, [leaves[k] for k in names])))
        grads = self.reduce_grads(grads, mesh)
        params = {k: v.detach().clone() for k, v in params.items()}
        opt_state = {"count": opt_state["count"],
                     "nu": {k: v.clone() for k, v in opt_state["nu"].items()}}
        with torch.no_grad():
            self.optimizer_step_(params, grads, opt_state, mesh)
        return params, opt_state, reduce_losses(losses, mesh)

    def _objective(self, dist, vpred, actions, advantages, returns, mean=torch.mean):
        """(the A2C loss, its parts) of the batch's policy outputs, the
        advantages held constant; ``mean`` is a rank's share of a global
        mean on a mesh."""
        cfg = self.config
        pg_loss = -mean(advantages.detach() * dist.log_prob(actions))
        vf_loss = mean(torch.square(vpred - returns))
        entropy = mean(dist.entropy())
        total = pg_loss + cfg.vf_coef * vf_loss - cfg.ent_coef * entropy
        return total, {"pg_loss": pg_loss.detach(), "vf_loss": vf_loss.detach(),
                       "entropy": entropy.detach()}

    def optimizer_step_(self, params, grads, opt_state, mesh=None):
        """optax's global-norm clip, then RMSProp, in place on ``params``
        and ``opt_state``; ``grads`` is consumed. On a tp mesh all three hold
        the rank's shards."""
        cfg = self.config
        clip_by_global_norm_(grads, cfg.max_grad_norm, mesh, self.sharded_names(mesh))
        rmsprop_update_(params, grads, opt_state, self.learning_rate(opt_state["count"]),
                        cfg.alpha, cfg.epsilon)

    def train_iteration(self, state: PPOState, gen: torch.Generator):
        """One update: the rollout, discounted returns, one full-batch step;
        on the state's mesh, data-parallel (module docstring)."""
        cfg = self.config
        mesh = state.mesh
        whole = self.whole_params(state.params, mesh)
        policy = lambda obs: self.apply(whole, obs)
        vstate, obs, obs_norm, last_norm_obs, batch = collect_rollout(
            self.vec_env, policy, state.vstate, state.obs, state.obs_norm, gen,
            cfg.n_steps, mesh=mesh)
        with torch.no_grad():
            _, last_value = policy(last_norm_obs)
        # Discounted returns: GAE with lambda 1.
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_value, cfg.gamma, 1.0)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        params, opt_state, metrics = self.update(
            state.params, state.opt_state,
            (flat(batch.obs), flat(batch.actions), flat(advantages), flat(returns)), mesh)
        metrics["explained_variance"] = explained_variance(flat(batch.values), flat(returns),
                                                           mesh)
        metrics.update(episode_metrics(batch, mesh))
        return PPOState(params=params, opt_state=opt_state, vstate=vstate, obs=obs,
                        obs_norm=obs_norm, update_idx=state.update_idx + 1, mesh=mesh), metrics

    def learn(self, total_timesteps: int, seed: int = 0,
              callback: Optional[Callable] = None) -> PPOState:
        n_updates = max(1, total_timesteps // (self.config.n_steps * self.num_envs))
        self.n_updates = n_updates
        state = self.init_state(self._start(seed), seed)
        return self._run(state, n_updates, callback)

    # ---- the reference's surface -------------------------------------------
    @classmethod
    def getOptParam(cls):
        return {
            "n_steps": (int, (1, 100)),
            "vf_coef": (float, (0, 1)),
            "ent_coef": (float, (0, 1)),
            "max_grad_norm": (float, (0.1, 5)),
            "learning_rate": (float, (0, 0.1)),
            "epsilon": (float, (0, 0.01)),
            "alpha": (float, (0.5, 1)),
            "gamma": (float, (0.5, 1)),
            "lr_schedule": ((list, str), list(LR_SCHEDULES)),
        }

    def customArguments(self, parser):
        super().customArguments(parser)
        parser.add_argument("--lr-schedule", help="Learning rate schedule",
                            default="constant", choices=LR_SCHEDULES)
        return parser


class RecurrentA2C(RecurrentPolicyMixin, A2C):
    pickle_name = "a2c_lstm"

    def __init__(self, env=None, num_envs: int = 16, policy: str = "lstm",
                 config: A2CConfig = None, normalize_obs: Optional[bool] = None,
                 device="cuda"):
        super().__init__(env=env, num_envs=num_envs, policy=policy, config=config,
                         normalize_obs=normalize_obs, device=device)

    def _batch_forward(self, params, segment):
        obs, done_in, carry0 = segment
        dist, vpred, _ = self.apply(params, obs, carry0, done_in)
        return dist, vpred

    def train_iteration(self, state: RecurrentPPOState, gen: torch.Generator):
        cfg = self.config
        mesh = state.mesh
        vstate, obs, done, carry, obs_norm, batch, last_value = self.rollout(state, gen)
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_value, cfg.gamma, 1.0)
        params, opt_state, metrics = self.update(
            state.params, state.opt_state,
            ((batch.obs, batch.done_in, batch.carry0), batch.actions, advantages, returns),
            mesh)
        metrics["explained_variance"] = explained_variance(batch.values.reshape(-1),
                                                           returns.reshape(-1), mesh)
        metrics.update(episode_metrics(batch, mesh))
        return RecurrentPPOState(params=params, opt_state=opt_state, vstate=vstate,
                                 obs=obs, done=done, lstm_state=carry, obs_norm=obs_norm,
                                 update_idx=state.update_idx + 1, mesh=mesh), metrics
