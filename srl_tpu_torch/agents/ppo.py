"""PPO2 (counterpart of srl_tpu/agents/ppo.py).

Same defaults as the reference (n_steps 128, 4 minibatches, 4 epochs, clip
0.2, lr 2.5e-4 linearly annealed, ent_coef 0.01, vf_coef 0.5, max_grad_norm
0.5, gamma 0.99, lam 0.95, Adam eps 1e-5) and the same update arithmetic:

* per-minibatch advantage normalization with std ddof 0 plus 1e-8;
* optax's global-norm clip: ``g * 0.5 / ||g||`` only when ``||g|| >= 0.5``
  (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and is not the same);
* optax's Adam (bias-corrected moments, ``m / (sqrt(v) + eps)``);
* the lr anneal indexed by ``optimizer_step // (noptepochs * nminibatches)``;
* one fresh permutation of the batch per epoch.

A mixed-family env (``core/mixed_env.MixedEnv``) trains unchanged: its
``VecEnv`` is a ``MixedVecEnv`` whose state is a tuple of per-family
states.

Beyond one update:

* ``learn(..., updates_per_call=K)`` runs K updates per callback, the
  episode statistics reaching the host once per K updates, and the metrics
  averaged over them;
* ``learn(..., initial_state=...)`` resumes a ``load_checkpoint`` state
  (either package's), the lr horizon being the completed plus the remaining
  updates;
* ``recompute_obs``: the rollout stores each step's env state instead of its
  observation, and each minibatch re-renders its frames (on the card, the
  Kuka frames through render3d), bit-identical to the stored frames;
* ``remat_policy``: the loss recomputes the policy's activations in the
  backward pass (``torch.utils.checkpoint``).

Parameters are a plain ``{name: tensor}`` dict applied with
``torch.func.functional_call``, so ``update_epochs`` is a function of
(params, Adam state, data, permutations) like the reference's scanned epochs.

Data-parallel (``parallel.shard_ppo_state``): a state laid out on a dp mesh
holds the rank's rows ``[lo, hi)`` of the env batch. The rollout draws for
the whole batch and keeps the rank's rows; every rank draws the same
permutations of the global flat batch ``g = t * N + n``, and rank ``r``
owns the rows with ``lo <= g % N < hi``, locally at ``(g // N) * (N / dp) +
g % N - lo``. Each global minibatch's loss terms are the sums over the owned
rows divided by the global minibatch size, its advantages normalized with
the global mean and std (two all-reduces); the gradients are all-reduced
with SUM before the clip and Adam, so every rank takes the same step. The
metrics are reduced, the episode statistics gathered.

Tensor-parallel (a ``dp x tp`` mesh, ``tp > 1``): the state holds the rank's
tp shards of the parameters and of Adam's moments (``parallel.mesh.
shard_params``), and the ranks of a tp group hold the same env rows. The
rollout acts on the whole parameters gathered once over the tp group; each
minibatch gathers them again (Adam changed them), takes the full gradient
of the rank's rows, keeps its shard's slice and all-reduces that over the dp
group only. The global norm of the clip sums the sharded leaves' squares
over the tp group and adds the replicated leaves' once; Adam steps the
shards. What is computed is the dp run's, bit for bit: the clip sums its
squares in float64, so the tp partial sums round as whole leaves do.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from srl_tpu_torch.agents.base import BaseRLAgent, PPOState, episode_metrics
from srl_tpu_torch.agents.common import (collect_rollout, compute_gae, explained_variance,
                                         moments)
from srl_tpu_torch.bridge import Record
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import state_map
from srl_tpu_torch.core.frame_stack import FrameStack
from srl_tpu_torch.core.optim import adam_init, adam_update_
from srl_tpu_torch.utils import trace

EMPTY_STATE = "optax._src.base.EmptyState"
ADAM_STATE = "optax._src.transform.ScaleByAdamState"
SCHEDULE_STATE = "optax._src.transform.ScaleByScheduleState"


@dataclasses.dataclass
class PPOConfig:
    n_steps: int = 128
    nminibatches: int = 4
    noptepochs: int = 4
    cliprange: float = 0.2
    learning_rate: float = 2.5e-4
    lr_linear_decay: bool = True
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    max_grad_norm: float = 0.5
    gamma: float = 0.99
    lam: float = 0.95
    adam_eps: float = 1e-5


def clip_by_global_norm_(grads: Dict[str, torch.Tensor], max_norm: float, mesh=None,
                         sharded=()):
    """optax.clip_by_global_norm, in place: unchanged below ``max_norm``,
    else scaled to norm ``max_norm`` (as ``g * (max_norm / ||g||)``, within
    1 ulp of optax's ``g / ||g|| * max_norm``). The squares are summed in
    float64 and the sum rounded to float32 before the square root, so the
    order of the partial sums (whole leaves, or a tp group's shards of them)
    does not show in the norm: a float32 sum's last bits move the clip's
    scale, which an update amplifies (tensor parallelism in PERF.md). On a
    mesh with ``tp > 1``, ``grads`` holds the rank's shards of the leaves
    named in ``sharded`` (their squares are summed over the tp group) and
    the whole of the rest (their squares added once)."""
    zero = torch.zeros((), dtype=torch.float64, device=next(iter(grads.values())).device)
    square_sum = lambda gs: sum((torch.sum(torch.square(g.double())) for g in gs), zero)
    if mesh is None or mesh.tp == 1:
        sq = square_sum(grads.values())
    else:
        sq = mesh.tp_all_reduce_(
            square_sum(g for k, g in grads.items() if k in sharded).reshape(1))[0]
        sq = sq + square_sum(g for k, g in grads.items() if k not in sharded)
    g_norm = torch.sqrt(sq.to(torch.float32))
    scale = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
    for g in grads.values():
        g.mul_(scale)
    return grads


def _gather(x, idx):
    """Rows ``idx`` of a tensor or of every field of a state dataclass."""
    if dataclasses.is_dataclass(x):
        return state_map(lambda y: y[idx], x)
    return x[idx]


class PPO2(BaseRLAgent):
    name = "ppo2"
    LOG_INTERVAL = 10
    SAVE_INTERVAL = 1
    config_class = PPOConfig
    # The loss parts of a minibatch, in the order the ranks reduce them.
    aux_keys = ("pg_loss", "vf_loss", "entropy", "approx_kl", "clip_frac")

    def __init__(self, env=None, num_envs: int = 16, policy: str = "auto",
                 config: PPOConfig = None, normalize_obs: Optional[bool] = None,
                 env_align: Optional[int] = None, recompute_obs: bool = False,
                 remat_policy: bool = False, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.num_envs = num_envs
        self.config = config or PPOConfig()
        self.policy_kind = policy
        # Mixed-family envs: the family-slice alignment (None:
        # core/mixed_env.default_align).
        self.env_align = env_align
        self.recompute_obs = recompute_obs
        self.remat_policy = remat_policy
        self.n_updates = 1  # lr-anneal horizon, set by learn()
        if env is not None:
            # Coarse-obs envs hand the traced half-resolution image to the
            # CNN, the 2x upsample folded into conv1.
            self._setup(normalize_obs, getattr(env, "obs_coarse_scale", 1), env_align)
            if recompute_obs:
                self._check_recompute_obs()

    def _check_recompute_obs(self):
        assert not self.normalize_obs, (
            "recompute_obs re-renders observations in the update; online "
            "normalizer statistics cannot be replayed - use it for raw_pixels "
            "(unnormalized) training")
        assert not getattr(self.env, "is_mixed_family", False), (
            "recompute_obs is not wired for mixed-family batches yet")
        assert not isinstance(self.env, FrameStack), (
            "recompute_obs with FrameStack would store the stacked frame buffer "
            "per step (num_stack x the slab it removes) - drop --recompute-obs "
            "or --num-stack")

    # ------------------------------------------------------------------
    def opt_init(self, params):
        return adam_init(params)

    def learning_rate(self, count: int) -> float:
        """The reference's linear anneal at optimizer step ``count``."""
        cfg = self.config
        if not cfg.lr_linear_decay:
            return cfg.learning_rate
        update = count // (cfg.noptepochs * cfg.nminibatches)
        frac = 1.0 - update / max(self.n_updates, 1)
        return cfg.learning_rate * max(frac, 0.0)

    def optimizer_step_(self, params, grads, opt_state, mesh=None):
        """Global-norm clip, then Adam at the annealed lr (optax's chain), in
        place on ``params`` and ``opt_state``; ``grads`` is consumed. (The
        fc512 weight alone is 19M floats.) On a tp mesh all three hold the
        rank's shards."""
        cfg = self.config
        clip_by_global_norm_(grads, cfg.max_grad_norm, mesh, self.sharded_names(mesh))
        adam_update_(params, grads, opt_state, self.learning_rate(opt_state["count"]),
                     cfg.adam_eps)

    def opt_state_to_reference(self, opt_state):
        count = np.asarray(opt_state["count"], np.int32)
        adam = Record(ADAM_STATE, args=(count, self._flax(opt_state["mu"]),
                                        self._flax(opt_state["nu"])))
        lr = (Record(SCHEDULE_STATE, args=(count,)) if self.config.lr_linear_decay
              else Record(EMPTY_STATE, args=()))
        return (Record(EMPTY_STATE, args=()), (adam, lr))

    def opt_state_from_reference(self, ref):
        _, (adam, lr) = ref
        count = int(np.asarray(adam.count))
        if lr.ref_name == SCHEDULE_STATE and int(np.asarray(lr.count)) != count:
            raise ValueError(f"Adam count {count} and schedule count "
                             f"{int(np.asarray(lr.count))} disagree")
        return {"count": count, "mu": self._state_dict(adam.mu),
                "nu": self._state_dict(adam.nu)}

    # ------------------------------------------------------------------
    def _minibatch_forward(self, params, obs):
        """(distribution, values) of a minibatch's observations."""
        if self.recompute_obs:
            # ``obs`` is the gathered env states: render this minibatch's
            # frames (no gradient flows into a render).
            with torch.no_grad():
                obs = self.vec_env.env.observe(obs)
        if self.remat_policy:
            return checkpoint(self.apply, params, obs, use_reentrant=False)
        return self.apply(params, obs)

    def _minibatch(self, data, idx):
        """The minibatch of the flat batch ``data`` at indices ``idx``."""
        return tuple(_gather(x, idx) for x in data)

    def _loss(self, params, minibatch, cliprange):
        obs, *rest = minibatch
        dist, vpred = self._minibatch_forward(params, obs)
        return self._objective(dist, vpred, *rest, cliprange)

    def _objective(self, dist, vpred, actions, old_logp, old_values, advantages, returns,
                   cliprange, mean=torch.mean, adv_stats=None):
        """(the clipped PPO loss, its parts) of the minibatch's policy
        outputs. On a mesh, ``mean`` is a rank's share of the global
        minibatch's mean and ``adv_stats`` the global (mean, std) of its
        advantages."""
        logp = dist.log_prob(actions)
        entropy = mean(dist.entropy())

        if adv_stats is None:
            adv_stats = moments(advantages)
        advantages = (advantages - adv_stats[0]) / (adv_stats[1] + 1e-8)
        ratio = torch.exp(logp - old_logp)
        pg1 = -advantages * ratio
        pg2 = -advantages * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange)
        pg_loss = mean(torch.maximum(pg1, pg2))

        vpred_clipped = old_values + torch.clamp(vpred - old_values, -cliprange, cliprange)
        vf_loss = 0.5 * mean(torch.maximum(torch.square(vpred - returns),
                                           torch.square(vpred_clipped - returns)))
        cfg = self.config
        total = pg_loss - cfg.ent_coef * entropy + cfg.vf_coef * vf_loss
        with torch.no_grad():
            aux = {
                "pg_loss": pg_loss.detach(),
                "vf_loss": vf_loss.detach(),
                "entropy": entropy.detach(),
                "approx_kl": 0.5 * mean(torch.square(logp - old_logp)),
                "clip_frac": mean((torch.abs(ratio - 1.0) > cliprange).to(torch.float32)),
            }
        return total, aux

    def _shard_loss(self, params, data, idx, mesh):
        """(loss, parts) of this rank's share of the global minibatch ``idx``
        of flat indices ``t * N + n``: the rows with ``n`` in the rank's env
        slice, their terms summed and divided by the global minibatch size,
        the advantages normalized with the global mean and std. (None, None)
        where the rank owns none of them (it still joins the all-reduces)."""
        n = self.num_envs
        lo, hi = mesh.env_slice(n)
        env = idx % n
        owned = (env >= lo) & (env < hi)
        local = ((idx // n) * (hi - lo) + env - lo)[owned]
        obs, *rest = self._minibatch(data, local)
        adv_mean, adv_var, _ = mesh.moments(rest[3])
        if local.numel() == 0:
            return None, None
        dist, vpred = self._minibatch_forward(params, obs)
        mb_size = idx.shape[0]
        return self._objective(dist, vpred, *rest, self.config.cliprange,
                               mean=lambda x: x.sum() / mb_size,
                               adv_stats=(adv_mean, torch.sqrt(adv_var)))

    def update_epochs(self, params, opt_state, data, perms, mesh=None):
        """The shuffled minibatch epochs: ``perms`` [noptepochs, T * N] holds
        one permutation of the flat batch per epoch; ``data[0]`` is the
        observations or, with ``recompute_obs``, the env states. Returns
        (params', opt_state', metrics averaged over every minibatch); the
        inputs are left as they are. With ``mesh``, ``data`` holds the
        rank's env columns [T, N / dp] flattened, ``perms`` permute the
        global batch, and ``params`` and ``opt_state`` hold the rank's tp
        shards (module docstring)."""
        cfg = self.config
        mb_size = perms.shape[1] // cfg.nminibatches
        names = list(params)
        params = {k: v.clone() for k, v in params.items()}
        opt_state = {"count": opt_state["count"],
                     "mu": {k: v.clone() for k, v in opt_state["mu"].items()},
                     "nu": {k: v.clone() for k, v in opt_state["nu"].items()}}
        with trace.span("epochs"):
            auxs = []
            for perm in perms:
                for i in range(cfg.nminibatches):
                    with trace.span("epochs.minibatch"):
                        idx = perm[i * mb_size:(i + 1) * mb_size]
                        whole = self.whole_params(params, mesh)
                        leaves = {k: whole[k].detach().requires_grad_(True) for k in names}
                        if mesh is None:
                            loss, aux = self._loss(leaves, self._minibatch(data, idx),
                                                   cfg.cliprange)
                            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
                            self.note_grads(grads)
                        else:
                            grads, aux = self._shard_grads(leaves, data, idx, mesh)
                        with torch.no_grad():
                            self.optimizer_step_(params, dict(zip(names, grads)), opt_state,
                                                 mesh)
                        auxs.append(aux)
            if mesh is None:
                metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
            else:
                # Each rank's parts are its shares of the global means: their
                # sums over the ranks are the one-process parts.
                stacked = mesh.all_reduce_(torch.stack([torch.stack(list(a.values()))
                                                        for a in auxs]))
                metrics = dict(zip(auxs[0], stacked.mean(0)))
        return params, opt_state, metrics

    def _shard_grads(self, leaves, data, idx, mesh):
        """(gradients summed over the dp group, this rank's loss parts) of
        the global minibatch ``idx``, each gradient the rank's tp shard of
        it; the ranks of a dp group get the same gradients."""
        names = list(leaves)
        loss, aux = self._shard_loss(leaves, data, idx, mesh)
        if loss is None:
            grads = [torch.zeros_like(v) for v in leaves.values()]
            aux = dict.fromkeys(self.aux_keys, torch.zeros((), device=idx.device))
        else:
            grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return list(self.reduce_grads(dict(zip(names, grads)), mesh).values()), aux

    def train_iteration(self, state: PPOState, gen: torch.Generator):
        """One PPO update: rollout, GAE, shuffled minibatch epochs; on the
        state's mesh, data-parallel (module docstring). Traced as the update
        ``state.update_idx`` (``utils/trace``)."""
        with trace.update(state.update_idx):
            return self._train_iteration(state, gen)

    def _train_iteration(self, state: PPOState, gen: torch.Generator):
        cfg = self.config
        mesh = state.mesh
        # The parameters do not change during the rollout: one gather.
        whole = self.whole_params(state.params, mesh)
        policy = lambda obs: self.apply(whole, obs)
        vstate, obs, obs_norm, last_norm_obs, batch = collect_rollout(
            self.vec_env, policy, state.vstate, state.obs, state.obs_norm, gen,
            cfg.n_steps, store_states=self.recompute_obs, mesh=mesh)
        with trace.span("gae"):
            with torch.no_grad():
                _, last_value = policy(last_norm_obs)
            advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                              last_value, cfg.gamma, cfg.lam)
        flat = lambda x: x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])
        obs_data = (state_map(flat, batch.obs) if self.recompute_obs else flat(batch.obs))
        data = (obs_data, flat(batch.actions), flat(batch.log_probs),
                flat(batch.values), flat(advantages), flat(returns))
        batch_size = data[1].shape[0]
        if mesh is not None:
            batch_size *= mesh.dp
        perms = torch.stack([
            torch.randperm(batch_size, generator=gen, device=gen.device)
            for _ in range(cfg.noptepochs)])
        params, opt_state, metrics = self.update_epochs(
            state.params, state.opt_state, data, perms, mesh)
        metrics["explained_variance"] = explained_variance(data[3], data[5], mesh)
        metrics.update(episode_metrics(batch, mesh))
        new_state = PPOState(params=params, opt_state=opt_state, vstate=vstate,
                             obs=obs, obs_norm=obs_norm, update_idx=state.update_idx + 1,
                             mesh=mesh)
        return new_state, metrics

    # ------------------------------------------------------------------
    def learn(self, total_timesteps: int, seed: int = 0,
              callback: Optional[Callable] = None, log_interval: Optional[int] = None,
              updates_per_call: int = 1, initial_state=None) -> PPOState:
        """Run ``total_timesteps // (n_steps * num_envs)`` updates (at least
        one), ``updates_per_call`` per call of ``callback(locals, globals)``.
        ``initial_state`` (from ``load_checkpoint``) resumes a run: the lr
        anneal continues on the run's slope, its horizon the completed plus
        the remaining updates."""
        cfg = self.config
        n_updates = max(1, total_timesteps // (cfg.n_steps * self.num_envs))
        if initial_state is not None:
            state = self.restore(initial_state, seed)
            self.n_updates = state.update_idx + n_updates
        else:
            self.n_updates = n_updates
            state = self.init_state(self._start(seed), seed)
        return self._run(state, n_updates, callback, updates_per_call)

    # ---- the reference's surface -------------------------------------------
    @classmethod
    def getOptParam(cls):
        return {
            "lam": (float, (0, 1)),
            "gamma": (float, (0, 1)),
            "max_grad_norm": (float, (0, 1)),
            "vf_coef": (float, (0, 1)),
            "learning_rate": (float, (1e-2, 1e-5)),
            "ent_coef": (float, (0, 1)),
            "cliprange": (float, (0, 1)),
            "noptepochs": (int, (1, 10)),
            "n_steps": (int, (32, 2048)),
        }
