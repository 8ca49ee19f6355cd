"""Batched environment API and the auto-resetting vector wrapper
(counterpart of srl_tpu/core/env.py).

Every env here is batched: a state is a dataclass of [N, ...] tensors. The
randomness of a reset or a step is split in two halves, so that a caller can
supply the random numbers itself (the tests feed the ones the JAX env drew):

  * ``draw_reset_noise(gen, n)`` / ``apply_reset(noise)``;
  * ``draw_step_noise(gen, n)`` / ``apply_step(state, action, noise)``.

``reset(gen, n)`` and ``step(state, action, gen)`` compose the two.
``VecEnv(env, n)`` of a mixed-family env (``core/mixed_env.MixedEnv``) is a
``MixedVecEnv``.

On a data-parallel mesh (``parallel/mesh.py``) a rank steps rows
``[lo, hi)`` of the batch: ``VecEnv.step(..., mesh=mesh)`` draws every
random number for the whole batch and keeps the rank's rows
(``take_rows``), so the rank steps those rows of the one-process run bit for
bit.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Optional, Tuple

import torch

from srl_tpu_torch.core.spaces import Space
from srl_tpu_torch.utils import trace


@dataclasses.dataclass
class Transition:
    """Result of one vectorized env step (after auto-reset)."""

    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    # Valid where ``done``: return and length of the episode that just
    # finished (NaN and 0 elsewhere).
    episode_return: torch.Tensor
    episode_length: torch.Tensor


@dataclasses.dataclass
class VecEnvState:
    env_state: Any  # batched env state dataclass
    ep_return: torch.Tensor  # [N] float32
    ep_length: torch.Tensor  # [N] int32


def state_map(fn, *states):
    """``fn`` applied field by field across batched state dataclasses of one
    type, recursing into fields that are state dataclasses themselves (a
    wrapper's inner state): ``state_map(lambda x: x[idx], s)`` gathers rows,
    ``state_map(lambda *xs: torch.stack(xs), *steps)`` stacks steps."""
    first = states[0]
    out = {}
    for f in dataclasses.fields(first):
        xs = [getattr(s, f.name) for s in states]
        if dataclasses.is_dataclass(xs[0]):
            out[f.name] = state_map(fn, *xs)
        else:
            out[f.name] = fn(*xs)
    return type(first)(**out)


def take_rows(x, lo: int, hi: int):
    """Rows ``[lo, hi)`` of the batch ``x``: a tensor, a noise dict, a
    batched state dataclass, a ``VecEnvState``, or a mixed batch's tuple of
    per-family ``VecEnvState``s (whose families hold consecutive rows; a
    family keeps the rows of ``[lo, hi)`` that it holds, maybe none)."""
    if isinstance(x, tuple):
        out, start = [], 0
        for vs in x:
            n = vs.ep_return.shape[0]
            f_lo = min(max(lo - start, 0), n)
            out.append(take_rows(vs, f_lo, max(min(hi - start, n), f_lo)))
            start += n
        return tuple(out)
    if isinstance(x, dict):
        return {k: v[lo:hi] for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return state_map(lambda y: y[lo:hi], x)
    return x[lo:hi]


def state_where(mask: torch.Tensor, a, b):
    """Field by field ``where(mask, a, b)`` over two batched state
    dataclasses; ``mask`` is [N] bool."""
    return state_map(
        lambda x, y: torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y),
        a, b)


class BatchedEnv(abc.ABC):
    """Abstract batched environment (the port's ``TpuEnv``)."""

    srl_model: str = "ground_truth"
    relative_pos: bool = True
    max_steps: int = 1000

    @abc.abstractmethod
    def draw_reset_noise(self, gen: torch.Generator, n: int) -> dict:
        """The random numbers one reset of ``n`` envs consumes."""

    @abc.abstractmethod
    def apply_reset(self, noise: dict):
        """Fresh episode states from drawn reset noise."""

    @abc.abstractmethod
    def draw_step_noise(self, gen: torch.Generator, n: int) -> dict:
        """The random numbers one step of ``n`` envs consumes."""

    @abc.abstractmethod
    def apply_step(self, state, action, noise: dict):
        """Advance one step: returns (state', reward [N], done [N])."""

    @abc.abstractmethod
    def observe(self, state) -> torch.Tensor:
        """[N, ...] observations for the configured srl_model mode."""

    @abc.abstractmethod
    def ground_truth(self, state) -> torch.Tensor:
        """[N, d] low-dimensional ground-truth state."""

    @abc.abstractmethod
    def target_pos(self, state) -> torch.Tensor:
        """[N, d] position of the current target, in the coordinates that
        ``srl_state`` subtracts: [N, 3] for Kuka, [N, 2] for MobileRobot,
        [N, 1] for its 1D and line-target variants."""

    @property
    @abc.abstractmethod
    def action_space(self) -> Space:
        ...

    @property
    @abc.abstractmethod
    def observation_space(self) -> Space:
        ...

    def reset(self, gen: torch.Generator, n: int):
        return self.apply_reset(self.draw_reset_noise(gen, n))

    def step(self, state, action, gen: torch.Generator):
        return self.apply_step(state, action,
                               self.draw_step_noise(gen, action.shape[0]))

    def srl_state(self, state) -> torch.Tensor:
        gt = self.ground_truth(state)
        if self.relative_pos:
            return gt - self.target_pos(state)
        return gt

    @staticmethod
    def ground_truth_dim() -> int:
        raise NotImplementedError

    def render_pixels(self, state) -> torch.Tensor:
        """uint8 [N, H, W, C] frames, whatever ``srl_model`` says; pixel envs
        override."""
        raise NotImplementedError


TpuEnv = BatchedEnv  # the reference's name of the env base class


class VecEnv:
    """Auto-resetting vector of ``num_envs`` envs.

    Stable-baselines semantics: when an episode ends, ``done`` is True for
    that step, the returned observation is the first one of the new episode,
    and the finished episode's return and length ride on the Transition.
    """

    def __new__(cls, env, num_envs: int, *args, **kwargs):
        # A MixedEnv vectorizes as per-family slices (core/mixed_env.py), so
        # that every agent's ``VecEnv(env, n)`` takes mixed batches.
        if cls is VecEnv and getattr(env, "is_mixed_family", False):
            from srl_tpu_torch.core.mixed_env import MixedVecEnv

            return super().__new__(MixedVecEnv)
        return super().__new__(cls)

    def __init__(self, env: BatchedEnv, num_envs: int):
        self.env = env
        self.num_envs = num_envs

    def reset(self, gen: torch.Generator,
              noise: Optional[dict] = None) -> Tuple[VecEnvState, torch.Tensor]:
        if noise is None:
            noise = self.env.draw_reset_noise(gen, self.num_envs)
        env_state = self.env.apply_reset(noise)
        obs = self.env.observe(env_state)
        n, dev = self.num_envs, obs.device
        vstate = VecEnvState(
            env_state=env_state,
            ep_return=torch.zeros(n, dtype=torch.float32, device=dev),
            ep_length=torch.zeros(n, dtype=torch.int32, device=dev),
        )
        return vstate, obs

    def step(self, vstate: VecEnvState, actions: torch.Tensor,
             gen: Optional[torch.Generator] = None,
             step_noise: Optional[dict] = None,
             reset_noise: Optional[dict] = None, *, mesh=None,
             rows: Optional[Tuple[int, int]] = None) -> Tuple[VecEnvState, Transition]:
        """One step of every env. The noise dicts, when given, replace the
        draws from ``gen``; reset noise is drawn only when an episode ended.

        With ``mesh`` (a ``parallel.mesh.Mesh``), ``vstate`` and ``actions``
        hold rows ``rows`` of the batch (by default the rank's
        ``mesh.env_slice``): the noise, drawn or given, is the whole batch's,
        and whether an episode ended anywhere is one all-reduce. A rank with
        no rows here (a mixed batch's other family) still draws and joins
        it, and returns (vstate, None).

        Traced (``utils/trace``) as the span ``env.step`` holding
        ``env.dynamics``, ``sync.done`` (the blocking read of ``done``),
        ``env.reset`` (on steps where an episode ended: counted in
        ``reset_steps``, and in detail mode their envs in ``envs_reset``)
        and ``env.observe``."""
        with trace.span("env.step"):
            return self._step(vstate, actions, gen, step_noise, reset_noise, mesh, rows)

    def _step(self, vstate, actions, gen, step_noise, reset_noise, mesh, rows):
        """``step``'s phases, each under its span (``MixedVecEnv`` steps its
        families through this, inside its own ``env.step``)."""
        with trace.span("env.dynamics"):
            if step_noise is None:
                step_noise = self.env.draw_step_noise(gen, self.num_envs)
            if mesh is not None:
                lo, hi = mesh.env_slice(self.num_envs) if rows is None else rows
                if lo == hi:
                    if mesh.any(actions.new_zeros(1, dtype=torch.bool)) and reset_noise is None:
                        self.env.draw_reset_noise(gen, self.num_envs)
                    return vstate, None
                step_noise = take_rows(step_noise, lo, hi)
            env_state, reward, done = self.env.apply_step(
                vstate.env_state, actions, step_noise)
        ep_return = vstate.ep_return + reward
        ep_length = vstate.ep_length + 1

        # Masked select of fresh states where done (one host sync: the reset
        # pass is skipped on the common step where no episode ended; on a
        # mesh the sync is the all-reduce of the flag, so that every rank
        # draws the reset noise on the same steps).
        if mesh is None:
            detail = trace.detail()
            with trace.sync("done"):
                # Detail mode reads how many ended (``envs_reset``): a bool
                # tensor's sum costs a cast kernel more than ``any``.
                ended = int(done.sum()) if detail else bool(done.any())
            if detail and ended:
                trace.count("envs_reset", ended)
        else:
            ended = mesh.any(done)
        if ended:
            trace.count("reset_steps")
            with trace.span("env.reset"):
                if reset_noise is None:
                    reset_noise = self.env.draw_reset_noise(gen, self.num_envs)
                if mesh is not None:
                    reset_noise = take_rows(reset_noise, lo, hi)
                fresh = self.env.apply_reset(reset_noise)
                env_state = state_where(done, fresh, env_state)

        with trace.span("env.observe"):
            obs = self.env.observe(env_state)
        transition = Transition(
            obs=obs,
            reward=reward,
            done=done,
            episode_return=torch.where(done, ep_return, torch.nan),
            episode_length=torch.where(done, ep_length, 0),
        )
        new_vstate = VecEnvState(
            env_state=env_state,
            ep_return=torch.where(done, 0.0, ep_return),
            ep_length=torch.where(done, 0, ep_length),
        )
        return new_vstate, transition
