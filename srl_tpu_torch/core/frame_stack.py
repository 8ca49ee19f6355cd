"""Observation frame stacking, batched (counterpart of
srl_tpu/core/frame_stack.py).

The last k observations ride in the state as ``frames`` [N, k, ...obs]; a
new episode starts from zero frames with the last slot set to its first
observation. ``observe`` moves the stack axis last and merges it into the
channel axis, so stacked channel ``c * k + j`` is frame ``j``'s channel
``c``: channels are interleaved, as the reference orders them, which is
what a policy trained by the reference expects.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from srl_tpu_torch.core.env import BatchedEnv
from srl_tpu_torch.core.spaces import Box, Space


@dataclasses.dataclass
class FrameStackState:
    inner: Any  # the wrapped env's batched state
    frames: torch.Tensor  # [N, k, ...obs], oldest first


class FrameStack(BatchedEnv):
    """Stacks the last ``num_stack`` observations of ``env``."""

    def __init__(self, env: BatchedEnv, num_stack: int):
        self.env = env
        self.num_stack = int(num_stack)
        self.srl_model = env.srl_model
        self.relative_pos = env.relative_pos
        self.max_steps = env.max_steps

    def __getattr__(self, name):
        if name == "env":  # not set yet (copy, unpickle): no recursion
            raise AttributeError(name)
        return getattr(self.env, name)

    @property
    def action_space(self) -> Space:
        return self.env.action_space

    @property
    def observation_space(self) -> Space:
        inner = self.env.observation_space
        shape = inner.shape[:-1] + (inner.shape[-1] * self.num_stack,)
        return Box(np.min(inner.low), np.max(inner.high), shape, inner.dtype)

    def draw_reset_noise(self, gen: torch.Generator, n: int) -> dict:
        return self.env.draw_reset_noise(gen, n)

    def apply_reset(self, noise: dict) -> FrameStackState:
        inner = self.env.apply_reset(noise)
        obs = self.env.observe(inner)
        frames = obs.new_zeros((obs.shape[0], self.num_stack) + obs.shape[1:])
        frames[:, -1] = obs
        return FrameStackState(inner=inner, frames=frames)

    def draw_step_noise(self, gen: torch.Generator, n: int) -> dict:
        return self.env.draw_step_noise(gen, n)

    def apply_step(self, state: FrameStackState, action, noise: dict):
        inner, reward, done = self.env.apply_step(state.inner, action, noise)
        obs = self.env.observe(inner)
        frames = torch.cat([state.frames[:, 1:], obs[:, None]], 1)
        return FrameStackState(inner=inner, frames=frames), reward, done

    def observe(self, state: FrameStackState) -> torch.Tensor:
        # [N, k, ..., C] -> [N, ..., C, k] -> [N, ..., C * k]
        frames = torch.movedim(state.frames, 1, -1)
        return frames.reshape(frames.shape[:-2] + (-1,))

    def ground_truth(self, state: FrameStackState) -> torch.Tensor:
        return self.env.ground_truth(state.inner)

    def target_pos(self, state: FrameStackState) -> torch.Tensor:
        return self.env.target_pos(state.inner)
