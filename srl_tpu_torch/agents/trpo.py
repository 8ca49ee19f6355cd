"""TRPO (counterpart of srl_tpu/agents/trpo.py), with the reference's
defaults: 128 steps per env, max_kl 0.01, 10 conjugate-gradient iterations,
damping 0.1, gamma 0.99, lam 0.98, 3 value-function Adam steps at 3e-4
(optax's default eps 1e-8), entcoeff 0.0, up to 10 line-search halvings.

The natural-gradient step over the flat parameter vector:

* Fisher-vector products as the Hessian-vector product of the mean KL to the
  rollout's policy (``autograd.grad`` of ``grad_kl . v``, the KL's gradient
  taken once with ``create_graph``): the same product as the reference's
  JVP of the KL gradient; plus the damping times ``v``;
* conjugate gradient for ``F x = g``, ``g`` the surrogate's gradient, then
  the step scaled to the trust region, ``sqrt(2 max_kl / x.F x)``;
* backtracking line search: accept the first halving whose surrogate
  improves and whose KL is at most 1.5 max_kl, else keep the parameters;
* then the value-function Adam steps, which update every parameter, the
  shared torso too, as the reference applies the value loss's gradient to
  the whole tree.

The flat vector orders parameters by the ``state_dict``, the reference's by
Flax's sorted paths: compare parameters after the bridge maps them back,
never as flat vectors. The policy is built without ``input_scale``, as the
reference builds it.

On a dp x tp mesh (a state from ``parallel.shard_ppo_state``), the original's
MPI allreduce: a rank steps its env rows; the advantages are standardized
with the global moments; the surrogate's gradient, each Fisher-vector
product (one all-reduce for each CG iteration) and each line-search trial's
surrogate and KL are summed over the dp group, so every rank runs the same
CG iterates on the whole flat vector and decides each trial on the same
values (and agrees on it over the world: a rank that left the search early
would hang the group); each rank keeps its tp shards of the step, and the
value-function Adam steps sum their gradients over the dp group.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from srl_tpu_torch.agents.base import BaseRLAgent, PPOState, episode_metrics, global_mean
from srl_tpu_torch.agents.common import collect_rollout, compute_gae, moments
from srl_tpu_torch.agents.ppo import ADAM_STATE, EMPTY_STATE
from srl_tpu_torch.bridge import Record
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.optim import adam_init, adam_update_
from srl_tpu_torch.models.distributions import Categorical
from srl_tpu_torch.parallel.mesh import shard_params

VF_ADAM_EPS = 1e-8  # optax.adam's default


@dataclasses.dataclass
class TRPOConfig:
    n_steps: int = 128  # per env; total batch = n_steps * num_envs
    max_kl: float = 0.01
    cg_iters: int = 10
    cg_damping: float = 0.1
    gamma: float = 0.99
    lam: float = 0.98
    vf_iters: int = 3
    vf_stepsize: float = 3e-4
    entcoeff: float = 0.0
    ls_steps: int = 10  # backtracking line-search steps


def kl_divergence(dist_a, dist_b) -> torch.Tensor:
    """KL(a || b) per row, of two categoricals or two diagonal Gaussians."""
    if isinstance(dist_a, Categorical):
        pa = torch.log_softmax(dist_a.logits, -1)
        pb = torch.log_softmax(dist_b.logits, -1)
        return torch.sum(torch.exp(pa) * (pa - pb), -1)
    va = torch.exp(2 * dist_a.log_std)
    vb = torch.exp(2 * dist_b.log_std)
    return torch.sum(dist_b.log_std - dist_a.log_std
                     + (va + torch.square(dist_a.mean - dist_b.mean)) / (2 * vb) - 0.5, -1)


def conjugate_gradient(fvp: Callable, g: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` CG iterations for ``F x = g`` from ``x = 0``."""
    x = torch.zeros_like(g)
    r, p = g.clone(), g.clone()
    rr = torch.dot(g, g)
    for _ in range(iters):
        ap = fvp(p)
        alpha = rr / (torch.dot(p, ap) + 1e-10)
        x = x + alpha * p
        r = r - alpha * ap
        rr_new = torch.dot(r, r)
        p = r + (rr_new / (rr + 1e-10)) * p
        rr = rr_new
    return x


class TRPO(BaseRLAgent):
    name = "trpo"
    config_class = TRPOConfig

    def __init__(self, env=None, num_envs: int = 8, policy: str = "auto",
                 config: TRPOConfig = None, normalize_obs: Optional[bool] = None,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.num_envs = num_envs
        self.config = config or TRPOConfig()
        self.policy_kind = policy
        if env is not None:
            self._setup(normalize_obs)

    def opt_init(self, params):
        return adam_init(params)

    def opt_state_to_reference(self, opt_state):
        adam = Record(ADAM_STATE, args=(np.asarray(opt_state["count"], np.int32),
                                        self._flax(opt_state["mu"]),
                                        self._flax(opt_state["nu"])))
        return (adam, Record(EMPTY_STATE, args=()))

    # ------------------------------------------------------------------
    def update(self, params, opt_state, data, mesh=None):
        """The natural-gradient step and the value-function steps from the
        flat batch ``data`` = (obs, actions, log_probs, advantages, returns):
        (params', opt_state', metrics, diagnostics); the diagnostics are the
        surrogate's gradient ``g``, the CG solution ``x``, the full step and
        the accepted halving (-1: none), flat in ``state_dict`` order. The
        inputs are left as they are.

        With ``mesh``, ``data`` is the rank's env rows and ``params`` and
        ``opt_state`` its tp shards. The advantages are standardized with the
        global moments; the surrogate and the KL are the rank's shares of the
        global means, their gradients, every Fisher-vector product and every
        line-search trial's values summed over the dp group, so every rank
        runs the same CG iterates on the whole flat vector and takes the same
        branch at every trial; then each rank keeps its shards of the step,
        and the value-function Adam steps sum their gradients over the dp
        group and step the shards."""
        cfg = self.config
        b_obs, b_act, b_logp, b_adv, b_ret = data
        if mesh is None or mesh.dp == 1:
            adv_mean, adv_std = moments(b_adv)
            b_adv = (b_adv - adv_mean) / (adv_std + 1e-8)
        else:
            adv_mean, adv_var, _ = mesh.moments(b_adv)
            b_adv = (b_adv - adv_mean) / (torch.sqrt(adv_var) + 1e-8)
        mean = torch.mean if mesh is None else global_mean(mesh)
        reduce_ = (lambda x: x) if mesh is None else mesh.all_reduce_
        whole = self.whole_params(params, mesh)
        names = list(params)
        shapes = [whole[k].shape for k in names]
        sizes = [whole[k].numel() for k in names]
        flat0 = torch.cat([whole[k].detach().reshape(-1) for k in names])

        def unflatten(fp):
            return {k: x.reshape(s) for k, x, s in zip(names, torch.split(fp, sizes), shapes)}

        with torch.no_grad():
            old_dist, _ = self.apply(whole, b_obs)

        def surrogate(fp):
            dist, _ = self.apply(unflatten(fp), b_obs)
            ratio = torch.exp(dist.log_prob(b_act) - b_logp)
            return mean(ratio * b_adv) + cfg.entcoeff * mean(dist.entropy())

        def mean_kl(fp):
            dist, _ = self.apply(unflatten(fp), b_obs)
            return mean(kl_divergence(old_dist, dist))

        fp = flat0.clone().requires_grad_(True)
        g = reduce_(torch.autograd.grad(surrogate(fp), fp)[0])
        self.note_grads([g], "surrogate")
        fp = flat0.clone().requires_grad_(True)
        grad_kl = torch.autograd.grad(mean_kl(fp), fp, create_graph=True)[0]

        def fvp(v):
            hvp = torch.autograd.grad(torch.dot(grad_kl, v), fp, retain_graph=True)[0]
            return reduce_(hvp) + cfg.cg_damping * v

        x = conjugate_gradient(fvp, g, cfg.cg_iters)
        x_fx = torch.dot(x, fvp(x))
        full_step = x * torch.sqrt(2 * cfg.max_kl / torch.clamp(x_fx, min=1e-10))
        del grad_kl
        with torch.no_grad():
            # Every trial is decided on the values summed over the dp group,
            # the same on every rank (the KL only where the surrogate
            # improves), and agreed over the world: a rank that left the
            # search early would wait on a collective the others never join.
            value = lambda fn, fp: reduce_(fn(fp).reshape(1))[0]
            surr_before = value(surrogate, flat0)
            new_flat, accepted_at = flat0, -1
            for i in range(cfg.ls_steps):
                candidate = flat0 + 0.5 ** i * full_step
                ok = bool(value(surrogate, candidate) - surr_before > 0) and bool(
                    value(mean_kl, candidate) <= cfg.max_kl * 1.5)
                if mesh is not None:
                    ok = not mesh.any(torch.tensor(not ok, device=flat0.device))
                if ok:
                    new_flat, accepted_at = candidate, i
                    break
            surr, kl = value(surrogate, new_flat), value(mean_kl, new_flat)
            metrics = {
                "surrogate_improve": surr - surr_before,
                "kl": kl,
                "line_search_accepted": torch.tensor(float(accepted_at >= 0),
                                                     device=flat0.device),
            }
        params = unflatten(new_flat)
        params = {k: v.clone() for k, v in
                  (params if mesh is None else shard_params(params, mesh)).items()}
        opt_state = {"count": opt_state["count"],
                     "mu": {k: v.clone() for k, v in opt_state["mu"].items()},
                     "nu": {k: v.clone() for k, v in opt_state["nu"].items()}}
        for _ in range(cfg.vf_iters):
            whole = self.whole_params(params, mesh)
            leaves = {k: whole[k].detach().requires_grad_(True) for k in names}
            _, v = self.apply(leaves, b_obs)
            grads = torch.autograd.grad(mean(torch.square(v - b_ret)),
                                        [leaves[k] for k in names],
                                        allow_unused=True, materialize_grads=True)
            adam_update_(params, self.reduce_grads(dict(zip(names, grads)), mesh), opt_state,
                         cfg.vf_stepsize, VF_ADAM_EPS)
        diagnostics = {"g": g, "x": x.detach(), "full_step": full_step.detach(),
                       "accepted_at": accepted_at}
        return params, opt_state, metrics, diagnostics

    def train_iteration(self, state: PPOState, gen: torch.Generator):
        """One update: the rollout, GAE, the natural-gradient step and the
        value-function steps; on the state's mesh, data-parallel."""
        cfg = self.config
        mesh = state.mesh
        whole = self.whole_params(state.params, mesh)
        policy = lambda obs: self.apply(whole, obs)
        vstate, obs, obs_norm, last_norm_obs, batch = collect_rollout(
            self.vec_env, policy, state.vstate, state.obs, state.obs_norm, gen,
            cfg.n_steps, mesh=mesh)
        with torch.no_grad():
            _, last_value = policy(last_norm_obs)
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_value, cfg.gamma, cfg.lam)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        params, opt_state, metrics, _ = self.update(
            state.params, state.opt_state,
            (flat(batch.obs), flat(batch.actions), flat(batch.log_probs),
             flat(advantages), flat(returns)), mesh)
        metrics.update(episode_metrics(batch, mesh))
        return PPOState(params=params, opt_state=opt_state, vstate=vstate, obs=obs,
                        obs_norm=obs_norm, update_idx=state.update_idx + 1, mesh=mesh), metrics

    def learn(self, total_timesteps: int, seed: int = 0,
              callback: Optional[Callable] = None) -> PPOState:
        n_updates = max(1, total_timesteps // (self.config.n_steps * self.num_envs))
        state = self.init_state(self._start(seed), seed)
        return self._run(state, n_updates, callback)

    # ---- the reference's surface -------------------------------------------
    @classmethod
    def getOptParam(cls):
        return {
            "max_kl": (float, (0.001, 0.1)),
            "gamma": (float, (0.5, 1)),
            "lam": (float, (0, 1)),
            "entcoeff": (float, (0, 1)),
            "cg_damping": (float, (0.01, 1)),
            "vf_stepsize": (float, (1e-2, 1e-5)),
            "n_steps": (int, (32, 2048)),
        }
