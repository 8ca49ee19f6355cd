"""Frozen copy of the plain PyTorch in srl_tpu_torch/envs/mobile_robot.py,
kept under the benchmark as the yardstick: it imports nothing of the
program.

MobileRobot envs, batched over N (counterpart of
srl_tpu/envs/mobile_robot.py).

A robot base on a 4 x 4 m plate moves by DELTA_POS per step (4 discrete
actions, 2 in 1D, or a clipped continuous action), is rolled back in full
when it would cross a wall margin (-1), and is rewarded +1 within 0.4 of
its target (0.1 of the line target), or -distance with ``shape_reward``.
An episode ends when ``step_count > max_steps``. Variants: 1D, two targets
(reached in order), and a line target.

Random numbers: a reset draws the robot's start offset and, with
``random_target``, the targets; a step draws one normal for the
action-magnitude noise. Pixel observations come from ``ops/render2d.py``
(the CUDA sprite compositor on a card).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import numerics

MAX_STEPS = 250
MAX_STEPS_2TARGET = 1500
REWARD_DIST_THRESHOLD = 0.4
REWARD_DIST_THRESHOLD_LINE = 0.1
ROBOT_OFFSET = 0.2
N_DISCRETE_ACTIONS = 4
DELTA_POS = 0.1
NOISE_STD = 0.0
ROBOT_WIDTH = 0.2
ROBOT_LENGTH = 0.325 * 2
COLLISION_MARGIN = 0.1
MIN_X, MAX_X = 0.0, 4.0
MIN_Y, MAX_Y = 0.0, 4.0
RENDER_WIDTH = 224
RENDER_HEIGHT = 224


@dataclasses.dataclass
class MobileRobotState:
    robot_pos: torch.Tensor  # [N, 2] float32 (y stays 0 in 1D)
    targets: torch.Tensor  # [N, n_targets, 2] float32
    current_target: torch.Tensor  # [N] int32
    step_count: torch.Tensor  # [N] int32
    terminated: torch.Tensor  # [N] bool
    has_bumped: torch.Tensor  # [N] bool


class MobileRobotEnv:
    """Robot base on a 4x4 m plate reaching a cylinder target."""

    name = "MobileRobotGymEnv-v0"

    def __init__(
        self,
        dim: int = 2,
        n_targets: int = 1,
        line_target: bool = False,
        is_discrete: bool = True,
        random_target: bool = False,
        shape_reward: bool = False,
        noise_std: float = NOISE_STD,
        srl_model: str = "ground_truth",
        max_steps: int = None,
        fpv: bool = False,
        state_dim: int = -1,
        render_shape: Tuple[int, int] = (RENDER_HEIGHT, RENDER_WIDTH),
    ):
        if dim not in (1, 2):
            raise ValueError(f"dim must be 1 or 2, got {dim}")
        if (dim == 1 or n_targets > 1) and not is_discrete:
            raise ValueError("only discrete actions are supported for this variant")
        self.dim = dim
        self.n_targets = n_targets
        self.line_target = line_target
        self.is_discrete = is_discrete
        self.random_target = random_target
        self.shape_reward = shape_reward
        self.noise_std = float(noise_std)
        self.srl_model = srl_model
        self.relative_pos = True
        self.fpv = fpv
        self.state_dim = state_dim
        self.render_shape = tuple(render_shape)
        if max_steps is None:
            max_steps = MAX_STEPS_2TARGET if n_targets > 1 else MAX_STEPS
        self.max_steps = max_steps
        # Per-axis rollback margins; float32 as the reference rounds them.
        self._margins = np.array(
            [COLLISION_MARGIN + ROBOT_LENGTH / 2, COLLISION_MARGIN + ROBOT_WIDTH / 2],
            dtype=np.float32,
        )
        self._upper = np.array([MAX_X, MAX_Y], np.float32) - self._margins
        self._reward_threshold = (
            REWARD_DIST_THRESHOLD_LINE if line_target else REWARD_DIST_THRESHOLD
        )

    # ------------------------------------------------------------------
    def ground_truth_dim_(self) -> int:
        return self.dim

    # ------------------------------------------------------------------
    def draw_reset_noise(self, gen: torch.Generator, n: int) -> dict:
        """``robot_u``: U(-4/3, 4/3) [n, 2], the start offset from the plate
        centre; ``target_u``: U(0.4, 3.6) [n, n_targets, 2] with
        random_target."""
        dev = gen.device
        span = MAX_X / 3
        noise = {"robot_u": torch.rand((n, 2), generator=gen, device=dev) * (2 * span)
                 - span}
        if self.random_target:
            margin = 0.1 * MAX_X
            noise["target_u"] = (
                torch.rand((n, self.n_targets, 2), generator=gen, device=dev)
                * (MAX_X - 2 * margin) + margin)
        return noise

    def apply_reset(self, noise: dict) -> MobileRobotState:
        start = MAX_X / 2 + noise["robot_u"]
        n, dev = start.shape[0], start.device
        f32 = dict(dtype=torch.float32, device=dev)
        active = torch.arange(2, device=dev) < self.dim
        robot_pos = torch.where(active, start, 0.0)

        if self.random_target:
            rnd = noise["target_u"]
            if self.dim == 1:
                targets = torch.stack([rnd[..., 0], torch.zeros_like(rnd[..., 0])], -1)
            elif self.line_target:
                targets = torch.stack([rnd[..., 0], torch.full_like(rnd[..., 0], MAX_X)],
                                      -1)
            else:
                targets = rnd
        else:
            defaults = np.array([[0.9 * MAX_X, MAX_Y * 3 / 4], [0.1 * MAX_X, MAX_Y * 3 / 4]],
                                np.float32)[: self.n_targets]
            if self.line_target:
                defaults = np.array([[0.9 * MAX_X, MAX_X]], np.float32)
            if self.dim == 1:
                defaults[:, 1] = 0.0
            targets = torch.as_tensor(defaults, device=dev).expand(n, -1, -1)

        i32 = dict(dtype=torch.int32, device=dev)
        false = torch.zeros(n, dtype=torch.bool, device=dev)
        return MobileRobotState(
            robot_pos=robot_pos.to(**f32),
            targets=targets.to(**f32).contiguous(),
            current_target=torch.zeros(n, **i32),
            step_count=torch.zeros(n, **i32),
            terminated=false,
            has_bumped=false.clone(),
        )

    # ------------------------------------------------------------------
    def draw_step_noise(self, gen: torch.Generator, n: int) -> dict:
        """``dv``: N(0, 1) [n], the action-magnitude noise."""
        return {"dv": torch.randn((n,), generator=gen, device=gen.device)}

    def _new_pos(self, prev: torch.Tensor, dv: torch.Tensor, action) -> torch.Tensor:
        if not self.is_discrete:
            # prev + act * dv as one fused multiply-add, as XLA evaluates it.
            act = torch.clamp(action.to(torch.float32), -1.0, 1.0)
            return numerics.fma(act, dv[:, None], prev)
        zero = torch.zeros_like(dv)
        dxs = torch.stack([-dv, dv, zero, zero], -1)
        a = action.long()[:, None]
        if self.dim == 1:
            return prev + torch.cat([dxs.gather(1, a), zero[:, None]], 1)
        dys = torch.stack([zero, zero, -dv, dv], -1)
        return prev + torch.cat([dxs.gather(1, a), dys.gather(1, a)], 1)

    def apply_step(self, state: MobileRobotState, action, noise: dict):
        dev = state.robot_pos.device
        dv = DELTA_POS + noise["dv"] * self.noise_std
        prev = state.robot_pos
        new = self._new_pos(prev, dv, action)

        # Per-axis wall margins; any bump rolls the whole position back.
        margins = torch.as_tensor(self._margins, device=dev)
        upper = torch.as_tensor(self._upper, device=dev)
        active = torch.arange(2, device=dev) < self.dim
        has_bumped = torch.any(((new < margins) | (new > upper)) & active, 1)
        robot_pos = torch.where(has_bumped[:, None], prev, new)
        step_count = state.step_count + 1

        target = self._current_target_pos(state)
        if self.line_target:
            distance = torch.abs((target[:, 0] - ROBOT_OFFSET) - robot_pos[:, 0])
        elif self.dim == 1:
            distance = torch.abs(target[:, 0] - robot_pos[:, 0])
        else:
            # sqrt(dx*dx + dy*dy) rounded as written: no fused multiply-add.
            d = target - robot_pos
            distance = numerics.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
        reached = distance <= self._reward_threshold
        reward = reached.to(torch.float32)
        current_target = state.current_target
        if self.n_targets > 1:
            advance = reached & (current_target < self.n_targets - 1)
            current_target = torch.where(advance, current_target + 1, current_target)
        reward = torch.where(has_bumped, -1.0, reward)
        if self.shape_reward:
            reward = -distance

        done = state.terminated | (step_count > self.max_steps)
        new_state = dataclasses.replace(
            state, robot_pos=robot_pos, current_target=current_target,
            step_count=step_count, has_bumped=has_bumped)
        return new_state, reward.to(torch.float32), done

    # ------------------------------------------------------------------
    def _current_target_pos(self, state: MobileRobotState) -> torch.Tensor:
        """[N, 2] full position of the active target."""
        if self.n_targets == 1:
            return state.targets[:, 0]
        rows = torch.arange(state.targets.shape[0], device=state.targets.device)
        return state.targets[rows, state.current_target.long()]

    def target_pos(self, state: MobileRobotState) -> torch.Tensor:
        """[N, 2] target x, y; [N, 1] target x in 1D; [N, 1] x - ROBOT_OFFSET
        for the line target."""
        full = self._current_target_pos(state)
        if self.line_target:
            return full[:, :1] - ROBOT_OFFSET
        return full[:, : self.dim]

    def ground_truth(self, state: MobileRobotState) -> torch.Tensor:
        return state.robot_pos[:, : self.ground_truth_dim_()]

    def srl_state(self, state: MobileRobotState) -> torch.Tensor:
        """The ground-truth observation: the robot's position relative to
        the target."""
        return self.ground_truth(state) - self.target_pos(state)

    def observe(self, state: MobileRobotState) -> torch.Tensor:
        if self.srl_model == "ground_truth":
            return self.srl_state(state)
        if self.srl_model != "raw_pixels" or self.fpv:
            raise ValueError("the reference observes ground truth or top-down raw pixels only")
        return self.render_pixels(state)

    def render_pixels(self, state: MobileRobotState) -> torch.Tensor:
        from .render2d import render_mobile_robot

        return render_mobile_robot(self, state)


class MobileRobot1DEnv(MobileRobotEnv):
    name = "MobileRobot1DGymEnv-v0"

    def __init__(self, **kwargs):
        kwargs.setdefault("dim", 1)
        super().__init__(**kwargs)


class MobileRobot2TargetEnv(MobileRobotEnv):
    name = "MobileRobot2TargetGymEnv-v0"

    def __init__(self, **kwargs):
        kwargs.setdefault("n_targets", 2)
        super().__init__(**kwargs)


class MobileRobotLineTargetEnv(MobileRobotEnv):
    name = "MobileRobotLineTargetGymEnv-v0"

    def __init__(self, **kwargs):
        kwargs.setdefault("line_target", True)
        super().__init__(**kwargs)
