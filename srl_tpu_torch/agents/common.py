"""Rollouts, GAE and explained variance (counterpart of
srl_tpu/agents/common.py). The reference's ``lax.scan`` loops are Python
loops here; every tensor stays on the env's device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from srl_tpu_torch.core.env import VecEnv, VecEnvState, state_map
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.core.numerics import fma
from srl_tpu_torch.models.distributions import Categorical
from srl_tpu_torch.utils import trace


@dataclasses.dataclass
class RolloutBatch:
    """[T, N, ...] tensors from one rollout segment. ``obs`` is the
    (normalized) observations, or, from ``collect_rollout(store_states=True)``,
    the env-state dataclass with [T, N, ...] fields that each observation
    renders from."""

    obs: object
    actions: torch.Tensor
    log_probs: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor
    dones: torch.Tensor
    episode_return: torch.Tensor  # NaN except where done
    episode_length: torch.Tensor


@torch.no_grad()
def collect_rollout(
    vec_env: VecEnv,
    policy: Callable,
    vstate: VecEnvState,
    obs: torch.Tensor,
    obs_norm: Optional[RunningNorm],
    gen: torch.Generator,
    n_steps: int,
    store_states: bool = False,
    mesh=None,
) -> Tuple[VecEnvState, torch.Tensor, Optional[RunningNorm], torch.Tensor, RolloutBatch]:
    """``n_steps`` of (policy -> env step -> auto-reset). The normalizer
    statistics update online during collection. ``policy(obs)`` returns
    (distribution, value). Returns (vstate', last_obs, obs_norm',
    last_norm_obs, batch).

    With ``mesh`` (a ``parallel.mesh.Mesh``), ``vstate`` and ``obs`` hold
    the rank's rows of the env batch: actions and env noise are drawn for the
    whole batch and the rank keeps its rows, and the normalizer updates from
    the observations of every rank of the dp group.

    ``store_states=True`` records each step's pre-step ``vstate.env_state``
    instead of its observation (``env.observe(env_state_t)`` is obs_t), for
    a caller that re-renders; it needs ``obs_norm`` None, since the online
    normalizer statistics cannot be replayed."""
    assert not (store_states and obs_norm is not None), (
        "store_states re-renders observations in the update; online "
        "normalization statistics cannot be replayed"
    )
    rows = None if mesh is None else (mesh.env_slice(vec_env.num_envs)[0], vec_env.num_envs)
    observed, steps = [], []
    with trace.span("rollout"):
        for _ in range(n_steps):
            with trace.span("rollout.policy"):
                if obs_norm is not None:
                    obs_norm = obs_norm.update(obs, mesh)
                    norm_obs = obs_norm.normalize(obs)
                else:
                    norm_obs = obs
                dist, value = policy(norm_obs)
                action = dist.sample(gen, rows)
                log_prob = dist.log_prob(action)
            observed.append(vstate.env_state if store_states else norm_obs)
            vstate, tr = vec_env.step(vstate, action, gen, mesh=mesh)
            steps.append((action, log_prob, value, tr.reward, tr.done,
                          tr.episode_return, tr.episode_length))
            obs = tr.obs
        stack = lambda *xs: torch.stack(xs)
        batch = RolloutBatch(state_map(stack, *observed) if store_states else stack(*observed),
                             *(stack(*x) for x in zip(*steps)))
        last_norm_obs = obs_norm.normalize(obs) if obs_norm is not None else obs
    return vstate, obs, obs_norm, last_norm_obs, batch


@dataclasses.dataclass
class RecurrentRolloutBatch(RolloutBatch):
    """A ``RolloutBatch`` of a recurrent policy: ``done_in`` [T, N] is the
    episode-start mask each step acted with (the previous step's ``done``),
    ``carry0`` the carry the segment started from."""

    done_in: torch.Tensor = None
    carry0: tuple = None


@torch.no_grad()
def collect_recurrent_rollout(
    vec_env: VecEnv,
    policy: Callable,
    vstate: VecEnvState,
    obs: torch.Tensor,
    done: torch.Tensor,
    carry: tuple,
    obs_norm: Optional[RunningNorm],
    gen: torch.Generator,
    n_steps: int,
    mesh=None,
):
    """``collect_rollout`` for a recurrent policy: ``policy(obs, carry,
    done)`` returns (distribution, value, carry'), ``done`` [N] masks the
    carry at episode starts. Returns (vstate', last_obs, done', carry',
    obs_norm', last_norm_obs, batch). With ``mesh``, ``vstate``, ``obs``,
    ``done`` and the carry hold the rank's env rows, as in
    ``collect_rollout``."""
    rows = None if mesh is None else (mesh.env_slice(vec_env.num_envs)[0], vec_env.num_envs)
    carry0 = carry
    observed, steps = [], []
    for _ in range(n_steps):
        if obs_norm is not None:
            obs_norm = obs_norm.update(obs, mesh)
            norm_obs = obs_norm.normalize(obs)
        else:
            norm_obs = obs
        dist, value, carry = policy(norm_obs, carry, done)
        action = dist.sample(gen, rows)
        observed.append(norm_obs)
        done_in = done
        vstate, tr = vec_env.step(vstate, action, gen, mesh=mesh)
        steps.append((action, dist.log_prob(action), value, tr.reward, tr.done,
                      tr.episode_return, tr.episode_length, done_in))
        obs, done = tr.obs, tr.done
    stack = lambda *xs: torch.stack(xs)
    batch = RecurrentRolloutBatch(stack(*observed), *(stack(*x) for x in zip(*steps)),
                                  carry0=carry0)
    last_norm_obs = obs_norm.normalize(obs) if obs_norm is not None else obs
    return vstate, obs, done, carry, obs_norm, last_norm_obs, batch


def compute_gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """Generalized advantage estimation over [T, N]; a done at step t cuts
    the bootstrap from t + 1. Returns (advantages, returns)."""
    gae = torch.zeros_like(last_value)
    value_next = last_value
    advantages = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        not_done = 1.0 - dones[t].to(torch.float32)
        delta = fma(gamma * value_next, not_done, rewards[t]) - values[t]
        gae = fma(gamma * lam * not_done, gae, delta)
        advantages[t] = gae
        value_next = values[t]
    advantages = torch.stack(advantages)
    return advantages, advantages + values


def moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean, standard deviation with ddof 0) of every entry of ``x`` in two
    passes, as ``jnp.mean`` and ``jnp.std`` compute them and as
    ``parallel.mesh.Mesh.moments`` does over its ranks (on one rank, bit for
    bit: a one-rank mesh normalizes advantages as no mesh does)."""
    x = x.reshape(-1)
    count = torch.full((), float(x.shape[0]), dtype=torch.float32, device=x.device)
    mean = x.sum(0) / count
    return mean, torch.sqrt(torch.square(x - mean).sum(0) / count)


def explained_variance(y_pred: torch.Tensor, y_true: torch.Tensor, mesh=None) -> torch.Tensor:
    """1 - var(y_true - y_pred) / var(y_true), NaN where var(y_true) is 0;
    with ``mesh``, over the flat batches of every rank of the dp group."""
    if mesh is None:
        var = lambda x: torch.var(x, unbiased=False)
    else:
        var = lambda x: mesh.moments(x.reshape(-1))[1]
    var_y = var(y_true)
    ev = 1 - var(y_true - y_pred) / var_y
    return torch.where(var_y == 0, torch.nan, ev)


def population_actions(logits: torch.Tensor, discrete: bool, deterministic: bool,
                       gen: torch.Generator, gumbel=None) -> torch.Tensor:
    """The evolution strategies' actions from each member's logits [N, A]:
    discrete, the argmax (``deterministic``) or a categorical draw (the
    argmax of the logits plus Gumbel noise, ``gumbel`` [N, A] when given,
    else drawn from ``gen``), as int32; continuous, the logits clipped to
    [-1, 1]."""
    if not discrete:
        return torch.clamp(logits, -1.0, 1.0)
    if deterministic:
        return torch.argmax(logits, -1).to(torch.int32)
    if gumbel is None:
        return Categorical(logits).sample(gen).to(torch.int32)
    return torch.argmax(logits + torch.as_tensor(gumbel).to(logits), -1).to(torch.int32)


@torch.no_grad()
def population_returns(vec_env: VecEnv, act: Callable, gen: torch.Generator, n_steps: int,
                       reset_noise: Optional[dict] = None) -> torch.Tensor:
    """Each env's return over a fresh episode, one population member per
    env in lock-step (srl_tpu/agents/ars.py:89-118, cma_es.py:107-131): a
    reset, then exactly ``n_steps`` steps of ``act(obs, t)``; an env steps
    on (auto-reset) after its first ``done``, but its return stops counting
    there. Returns [N] float32."""
    vstate, obs = vec_env.reset(gen, reset_noise)
    ret = torch.zeros(vec_env.num_envs, dtype=torch.float32, device=obs.device)
    done_once = torch.zeros_like(ret)
    for t in range(n_steps):
        vstate, tr = vec_env.step(vstate, act(obs, t), gen)
        ret = ret + tr.reward * (1.0 - done_once)
        done_once = torch.maximum(done_once, tr.done.to(torch.float32))
        obs = tr.obs
    return ret
