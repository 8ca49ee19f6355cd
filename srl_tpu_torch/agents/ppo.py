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

Parameters are a plain ``{name: tensor}`` dict applied with
``torch.func.functional_call``, so ``update_epochs`` is a function of
(params, Adam state, data, permutations) like the reference's scanned epochs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.agents.common import collect_rollout, compute_gae, explained_variance
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import VecEnv, VecEnvState
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.core.optim import adam_init, adam_update_
from srl_tpu_torch.models.policies import ActorCritic, make_policy

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


@dataclasses.dataclass
class PPOState:
    params: Dict[str, torch.Tensor]
    # {"count": optimizer steps taken, "mu": {...}, "nu": {...}}
    opt_state: dict
    vstate: Optional[VecEnvState]
    obs: Optional[torch.Tensor]
    obs_norm: Optional[RunningNorm]


def clip_by_global_norm_(grads: Dict[str, torch.Tensor], max_norm: float):
    """optax.clip_by_global_norm, in place: unchanged below ``max_norm``,
    else scaled to norm ``max_norm`` (as ``g * (max_norm / ||g||)``, within
    1 ulp of optax's ``g / ||g|| * max_norm``)."""
    g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
    scale = torch.where(g_norm < max_norm, 1.0, max_norm / g_norm)
    for g in grads.values():
        g.mul_(scale)
    return grads


class PPO2(BaseRLAgent):
    name = "ppo2"
    LOG_INTERVAL = 10

    def __init__(self, env=None, num_envs: int = 16, policy: str = "auto",
                 config: PPOConfig = None, normalize_obs: Optional[bool] = None,
                 env_align: Optional[int] = None, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.num_envs = num_envs
        self.config = config or PPOConfig()
        self.policy_kind = policy
        # Mixed-family envs: the family-slice alignment (None: one device,
        # core/mixed_env.default_align).
        self.env_align = env_align
        self.n_updates = 1  # lr-anneal horizon, set by learn()
        if env is not None:
            self._setup(normalize_obs)

    def _setup(self, normalize_obs):
        env = self.env
        if getattr(env, "is_mixed_family", False):
            self.vec_env = VecEnv(env, self.num_envs, align=self.env_align)
        else:
            self.vec_env = VecEnv(env, self.num_envs)
        self.obs_shape = tuple(env.observation_space.shape)
        self.input_scale = getattr(env, "obs_coarse_scale", 1)
        self.policy: ActorCritic = self._make_policy().to(self.device)
        # VecNormalize only for non-pixel observations.
        if normalize_obs is None:
            normalize_obs = env.srl_model != "raw_pixels"
        self.normalize_obs = normalize_obs

    def _make_policy(self) -> ActorCritic:
        return make_policy(self.env.action_space, self.obs_shape,
                           self.policy_kind, input_scale=self.input_scale)

    def apply(self, params: Dict[str, torch.Tensor], obs: torch.Tensor):
        """(distribution, value) of the policy with ``params``."""
        return functional_call(self.policy, params, (obs,))

    # ------------------------------------------------------------------
    def init_params(self, seed: int) -> Dict[str, torch.Tensor]:
        """Fresh orthogonal-init parameters drawn from ``seed``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = self._make_policy()
        return {k: v.detach().to(self.device) for k, v in fresh.state_dict().items()}

    def init_state(self, gen: torch.Generator, seed: int = 0) -> PPOState:
        vstate, obs = self.vec_env.reset(gen)
        params = self.init_params(seed)
        obs_norm = (RunningNorm.create(self.obs_shape, self.device)
                    if self.normalize_obs else None)
        return PPOState(params=params, opt_state=adam_init(params), vstate=vstate,
                        obs=obs, obs_norm=obs_norm)

    def learning_rate(self, count: int) -> float:
        """The reference's linear anneal at optimizer step ``count``."""
        cfg = self.config
        if not cfg.lr_linear_decay:
            return cfg.learning_rate
        update = count // (cfg.noptepochs * cfg.nminibatches)
        frac = 1.0 - update / max(self.n_updates, 1)
        return cfg.learning_rate * max(frac, 0.0)

    def optimizer_step_(self, params, grads, opt_state):
        """Global-norm clip, then Adam at the annealed lr (optax's chain), in
        place on ``params`` and ``opt_state``; ``grads`` is consumed. (The
        fc512 weight alone is 19M floats.)"""
        cfg = self.config
        clip_by_global_norm_(grads, cfg.max_grad_norm)
        adam_update_(params, grads, opt_state, self.learning_rate(opt_state["count"]),
                     cfg.adam_eps)

    # ------------------------------------------------------------------
    def _loss(self, params, minibatch, cliprange):
        obs, actions, old_logp, old_values, advantages, returns = minibatch
        dist, vpred = self.apply(params, obs)
        logp = dist.log_prob(actions)
        entropy = torch.mean(dist.entropy())

        advantages = ((advantages - advantages.mean())
                      / (advantages.std(unbiased=False) + 1e-8))
        ratio = torch.exp(logp - old_logp)
        pg1 = -advantages * ratio
        pg2 = -advantages * torch.clamp(ratio, 1.0 - cliprange, 1.0 + cliprange)
        pg_loss = torch.mean(torch.maximum(pg1, pg2))

        vpred_clipped = old_values + torch.clamp(vpred - old_values, -cliprange, cliprange)
        vf_loss = 0.5 * torch.mean(torch.maximum(torch.square(vpred - returns),
                                                 torch.square(vpred_clipped - returns)))
        cfg = self.config
        total = pg_loss - cfg.ent_coef * entropy + cfg.vf_coef * vf_loss
        with torch.no_grad():
            aux = {
                "pg_loss": pg_loss.detach(),
                "vf_loss": vf_loss.detach(),
                "entropy": entropy.detach(),
                "approx_kl": 0.5 * torch.mean(torch.square(logp - old_logp)),
                "clip_frac": torch.mean(
                    (torch.abs(ratio - 1.0) > cliprange).to(torch.float32)),
            }
        return total, aux

    def update_epochs(self, params, opt_state, data, perms):
        """The shuffled minibatch epochs: ``perms`` [noptepochs, T * N] holds
        one permutation of the flat batch per epoch. Returns (params',
        opt_state', metrics averaged over every minibatch); the inputs are
        left as they are."""
        cfg = self.config
        mb_size = perms.shape[1] // cfg.nminibatches
        names = list(params)
        params = {k: v.clone() for k, v in params.items()}
        opt_state = {"count": opt_state["count"],
                     "mu": {k: v.clone() for k, v in opt_state["mu"].items()},
                     "nu": {k: v.clone() for k, v in opt_state["nu"].items()}}
        auxs = []
        for perm in perms:
            for i in range(cfg.nminibatches):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                mb = tuple(x[idx] for x in data)
                leaves = {k: params[k].detach().requires_grad_(True) for k in names}
                loss, aux = self._loss(leaves, mb, cfg.cliprange)
                grads = torch.autograd.grad(loss, [leaves[k] for k in names])
                with torch.no_grad():
                    self.optimizer_step_(params, dict(zip(names, grads)), opt_state)
                auxs.append(aux)
        metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
        return params, opt_state, metrics

    def train_iteration(self, state: PPOState, gen: torch.Generator):
        """One PPO update: rollout, GAE, shuffled minibatch epochs."""
        cfg = self.config
        policy = lambda obs: self.apply(state.params, obs)
        vstate, obs, obs_norm, last_norm_obs, batch = collect_rollout(
            self.vec_env, policy, state.vstate, state.obs, state.obs_norm, gen,
            cfg.n_steps)
        with torch.no_grad():
            _, last_value = policy(last_norm_obs)
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_value, cfg.gamma, cfg.lam)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        data = (flat(batch.obs), flat(batch.actions), flat(batch.log_probs),
                flat(batch.values), flat(advantages), flat(returns))
        batch_size = data[1].shape[0]
        perms = torch.stack([
            torch.randperm(batch_size, generator=gen, device=gen.device)
            for _ in range(cfg.noptepochs)])
        params, opt_state, metrics = self.update_epochs(
            state.params, state.opt_state, data, perms)
        metrics["explained_variance"] = explained_variance(data[3], data[5])
        metrics["episode_return"] = batch.episode_return
        metrics["episode_length"] = batch.episode_length
        metrics["mean_reward_per_step"] = batch.rewards.mean()
        new_state = PPOState(params=params, opt_state=opt_state, vstate=vstate,
                             obs=obs, obs_norm=obs_norm)
        return new_state, metrics

    # ------------------------------------------------------------------
    def learn(self, total_timesteps: int, seed: int = 0,
              callback: Optional[Callable] = None) -> PPOState:
        """Run ``total_timesteps // (n_steps * num_envs)`` updates (at least
        one), calling ``callback(locals, globals)`` after each."""
        cfg = self.config
        steps_per_update = cfg.n_steps * self.num_envs
        self.n_updates = n_updates = max(1, total_timesteps // steps_per_update)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        state = self.init_state(gen, seed)
        episode_returns, episode_lengths = [], []
        t_start = time.time()
        num_timesteps = 0
        for update in range(n_updates):
            state, metrics = self.train_iteration(state, gen)
            self.state = state
            num_timesteps += steps_per_update
            ep_ret = metrics.pop("episode_return").cpu().numpy()
            ep_len = metrics.pop("episode_length").cpu().numpy()
            finished = ~np.isnan(ep_ret)
            episode_returns.extend(ep_ret[finished].tolist())
            episode_lengths.extend(ep_len[finished].tolist())
            if callback is not None:
                callback({
                    "self": self,
                    "state": state,
                    "update": update,
                    "n_updates": n_updates,
                    "num_timesteps": num_timesteps,
                    "episode_returns": episode_returns,
                    "episode_lengths": episode_lengths,
                    "metrics": {k: float(v) for k, v in metrics.items()},
                    "fps": num_timesteps / max(time.time() - t_start, 1e-9),
                }, {})
        self.state = state
        return state

    # ------------------------------------------------------------------
    def getAction(self, observation, deterministic: bool = False,
                  gen: Optional[torch.Generator] = None):
        obs = torch.as_tensor(np.asarray(observation), device=self.device)
        if self.state.obs_norm is not None:
            obs = self.state.obs_norm.normalize(obs)
        with torch.no_grad():
            dist, _ = self.apply(self.state.params, obs)
            if deterministic:
                return dist.mode().cpu().numpy()
            if gen is None:
                if getattr(self, "_act_gen", None) is None:
                    self._act_gen = torch.Generator(device=self.device)
                    self._act_gen.manual_seed(0)
                gen = self._act_gen
            return dist.sample(gen).cpu().numpy()

    # ---- persistence (the reference's payload format) --------------------
    def save(self, save_path: str, _locals=None):
        norm = self.state.obs_norm
        payload = {
            "name": self.name,
            "config": dataclasses.asdict(self.config),
            "num_envs": self.num_envs,
            "policy_kind": self.policy_kind,
            "normalize_obs": self.normalize_obs,
            "params": bridge.state_dict_to_flax(self.state.params,
                                                self.policy.torso_kind),
            "obs_norm": (self._to_numpy({"mean": norm.mean, "var": norm.var,
                                         "count": norm.count})
                         if norm is not None else None),
        }
        self._save_pickle(save_path, payload)

    @classmethod
    def load(cls, load_path: str, env=None, device="cuda") -> "PPO2":
        d = bridge.load_jax_checkpoint(load_path)
        agent = cls(env=env, num_envs=d["num_envs"], policy=d["policy_kind"],
                    config=PPOConfig(**d["config"]),
                    normalize_obs=d["normalize_obs"], device=device)
        dev = agent.device
        obs_norm = None
        if d["obs_norm"] is not None:
            obs_norm = RunningNorm(
                **{k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
                   for k, v in d["obs_norm"].items()})
        params = {k: v.to(dev) for k, v in d["state_dict"].items()}
        agent.state = PPOState(params=params, opt_state=None, vstate=None, obs=None,
                               obs_norm=obs_norm)
        return agent
