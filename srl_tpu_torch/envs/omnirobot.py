"""Omnirobot reach-target env, batched over N (counterpart of
srl_tpu/envs/omnirobot.py).

An omnidirectional robot on a [-0.85, 0.85]^2 arena moves by STEP_DISTANCE
per discrete action (+x, -x, +y, -y) or by a continuous 2-D action from the
``RingBox``; a move that would cross a wall (strict inequalities) is not
made and pays -1, a robot within 0.2 of its target is paid +1 (or
-distance with ``shape_reward``). An episode ends when ``step_count >
max_steps`` (251 steps by default).

Random numbers: a reset draws the robot's start and, with
``random_target``, the target, both U(-0.7, 0.7)^2; with ``noise`` (the
default) every state also carries ``render_noise``, three N(0, 1) numbers
that jitter the rendered robot's position (x 0.01) and heading
(x radians(2.5)). They are drawn at the reset and at every step, so that
``observe`` is a function of the state alone; the reference derives the
same numbers from ``fold_in(state.key, step_count)``.

Pixel observations are a top-down 224x224 view rasterised in plain PyTorch
(the reference's renderer is plain XLA, not a Pallas kernel): a chequered
floor, a dark border beyond the walls, a red target square, a black robot
disk with a white heading dot.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch

from srl_tpu_torch.core import numerics
from srl_tpu_torch.core.env import BatchedEnv
from srl_tpu_torch.core.spaces import Box, Discrete, Space
from srl_tpu_torch.ops.renderer import _color_u8

MAX_STEPS = 250
N_DISCRETE_ACTIONS = 4
STEP_DISTANCE = 0.1
MIN_X, MAX_X = -0.85, 0.85
MIN_Y, MAX_Y = -0.85, 0.85
INIT_MIN, INIT_MAX = -0.7, 0.7
TARGET_MIN, TARGET_MAX = -0.7, 0.7
DIST_TO_TARGET_THRESHOLD = 0.2
REWARD_TARGET_REACH = 1.0
REWARD_BUMP_WALL = -1.0
REWARD_NOTHING = 0.0
ACTION_POSITIVE_HIGH = 0.1
RENDER_WIDTH = 224
RENDER_HEIGHT = 224
NOISE_VAR_ROBOT_POS = 0.01
NOISE_VAR_ROBOT_YAW = np.radians(2.5)

# Render colours, quantised as the reference's final clip(c * 255 + 0.5).
FLOOR = (0.82, 0.71, 0.55)
BORDER = (0.25, 0.22, 0.2)
TARGET_RGB = (0.85, 0.1, 0.1)
ROBOT_RGB = (0.08, 0.08, 0.08)
HEADING_RGB = (0.95, 0.95, 0.95)


class RingBox(Box):
    """Continuous space whose coordinates keep away from zero: values in
    [negative_low, negative_high] U [positive_low, positive_high]."""

    def __init__(self, positive_low, positive_high, negative_low, negative_high,
                 shape, dtype=np.float32):
        super().__init__(negative_low, positive_high, tuple(shape), dtype)
        object.__setattr__(self, "positive_low", positive_low)
        object.__setattr__(self, "positive_high", positive_high)
        object.__setattr__(self, "negative_low", negative_low)
        object.__setattr__(self, "negative_high", negative_high)

    def sample(self, gen: torch.Generator, n: int) -> torch.Tensor:
        """``raw`` U(-(negative length), positive length), shifted away from
        zero by ``positive_low`` (raw >= 0) or ``negative_high`` (raw < 0)."""
        lp = self.positive_high - self.positive_low
        ln = self.negative_high - self.negative_low
        u = torch.rand((n,) + self.shape, generator=gen, device=gen.device)
        raw = u * (lp + ln) - ln
        return raw + torch.where(raw >= 0, self.positive_low, self.negative_high)


@dataclasses.dataclass
class OmniRobotState:
    robot_pos: torch.Tensor  # [N, 2] float32
    robot_yaw: torch.Tensor  # [N] float32
    target_pos: torch.Tensor  # [N, 2] float32
    step_count: torch.Tensor  # [N] int32
    terminated: torch.Tensor  # [N] bool
    n_contacts: torch.Tensor  # [N] int32
    render_noise: torch.Tensor  # [N, 3] float32: N(0, 1) for x, y, yaw


@lru_cache(maxsize=4)
def _moves(device: torch.device) -> torch.Tensor:
    """[4, 2] moves of the discrete actions: 0 forward (+x), 1 backward
    (-x), 2 left (+y), 3 right (-y)."""
    return torch.tensor([[STEP_DISTANCE, 0.0], [-STEP_DISTANCE, 0.0],
                         [0.0, STEP_DISTANCE], [0.0, -STEP_DISTANCE]],
                        dtype=torch.float32, device=device)


@lru_cache(maxsize=4)
def _static_frame(device: torch.device):
    """(xs [W], ys [H], background uint8 [H, W, 3], colours): the view grid,
    the floor with its checker and border (the same for every env), and the
    markers' uint8 colours (target, robot, heading)."""
    xs = numerics.linspace(-1.0, 1.0, RENDER_WIDTH)
    ys = numerics.linspace(1.0, -1.0, RENDER_HEIGHT)
    gx, gy = np.broadcast_arrays(xs[None, :], ys[:, None])
    f32 = np.float32
    checker = (np.floor(gx / f32(0.425)) + np.floor(gy / f32(0.425))) % f32(2)
    floor = np.asarray(FLOOR, f32) * (f32(0.92) + f32(0.08) * checker[..., None])
    border = (np.abs(gx) > f32(MAX_X)) | (np.abs(gy) > f32(MAX_Y))
    img = np.where(border[..., None], np.asarray(BORDER, f32), floor)
    as_t = lambda a: torch.as_tensor(a, device=device)
    colours = tuple(as_t(_color_u8(c)) for c in (TARGET_RGB, ROBOT_RGB, HEADING_RGB))
    return as_t(xs), as_t(ys), as_t(_color_u8(img)), colours


class OmniRobotEnv(BatchedEnv):
    name = "OmnirobotEnv-v0"

    def __init__(self, is_discrete: bool = True, random_target: bool = True,
                 shape_reward: bool = False, srl_model: str = "raw_pixels",
                 max_steps: int = MAX_STEPS, simple_continual_target: bool = False,
                 state_dim: int = -1, action_repeat: int = 1, noise: bool = True):
        if action_repeat != 1:
            raise ValueError("Omnirobot does not support action_repeat")
        self.is_discrete = is_discrete
        self.random_target = random_target
        self.shape_reward = shape_reward
        self.srl_model = srl_model
        self.relative_pos = True
        self.max_steps = max_steps
        self.state_dim = state_dim
        self.noise = noise

    @property
    def action_space(self) -> Space:
        if self.is_discrete:
            return Discrete(N_DISCRETE_ACTIONS)
        return RingBox(0.0, ACTION_POSITIVE_HIGH, -ACTION_POSITIVE_HIGH, 0.0, (2,))

    @property
    def observation_space(self) -> Space:
        if self.srl_model == "raw_pixels":
            return Box(0, 255, (RENDER_HEIGHT, RENDER_WIDTH, 3), np.uint8)
        return Box(-np.inf, np.inf, (2,))

    @staticmethod
    def ground_truth_dim() -> int:
        return 2

    # ------------------------------------------------------------------
    def _draw_render_noise(self, gen: torch.Generator, n: int, noise: dict) -> dict:
        if self.noise:
            noise["render"] = torch.randn((n, 3), generator=gen, device=gen.device)
        return noise

    def draw_reset_noise(self, gen: torch.Generator, n: int) -> dict:
        """``robot_pos`` (and with random_target ``target_pos``): U(-0.7,
        0.7) [n, 2]; ``render``: N(0, 1) [n, 3] with noise."""
        dev = gen.device
        uniform = lambda lo, hi: torch.rand((n, 2), generator=gen, device=dev) * (hi - lo) + lo
        noise = {"robot_pos": uniform(INIT_MIN, INIT_MAX)}
        if self.random_target:
            noise["target_pos"] = uniform(TARGET_MIN, TARGET_MAX)
        return self._draw_render_noise(gen, n, noise)

    def _render_noise(self, noise: dict, n: int, dev) -> torch.Tensor:
        if self.noise:
            return noise["render"].to(torch.float32)
        return torch.zeros((n, 3), dtype=torch.float32, device=dev)

    def apply_reset(self, noise: dict) -> OmniRobotState:
        robot_pos = noise["robot_pos"].to(torch.float32)
        n, dev = robot_pos.shape[0], robot_pos.device
        if self.random_target:
            target = noise["target_pos"].to(torch.float32)
        else:
            target = torch.zeros((n, 2), dtype=torch.float32, device=dev)
        zeros_i = torch.zeros(n, dtype=torch.int32, device=dev)
        return OmniRobotState(
            robot_pos=robot_pos, robot_yaw=torch.zeros(n, dtype=torch.float32, device=dev),
            target_pos=target, step_count=zeros_i, terminated=torch.zeros_like(zeros_i,
                                                                             dtype=torch.bool),
            n_contacts=zeros_i.clone(), render_noise=self._render_noise(noise, n, dev))

    # ------------------------------------------------------------------
    def draw_step_noise(self, gen: torch.Generator, n: int) -> dict:
        """``render``: N(0, 1) [n, 3] for the stepped state, with noise."""
        return self._draw_render_noise(gen, n, {})

    def apply_step(self, state: OmniRobotState, action, noise: dict):
        pos = state.robot_pos
        dev = pos.device
        if self.is_discrete:
            delta = _moves(dev)[action.long()]
        else:
            delta = action.to(torch.float32)
        new = pos + delta
        inside = ((new[:, 0] > MIN_X) & (new[:, 0] < MAX_X)
                  & (new[:, 1] > MIN_Y) & (new[:, 1] < MAX_Y))
        has_bumped = ~inside
        robot_pos = torch.where(has_bumped[:, None], pos, new)

        d = robot_pos - state.target_pos
        distance = numerics.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1])
        reached = distance < DIST_TO_TARGET_THRESHOLD
        reward = torch.where(reached, REWARD_TARGET_REACH,
                             torch.where(has_bumped, REWARD_BUMP_WALL, REWARD_NOTHING))
        if self.shape_reward:
            reward = -distance
        n_contacts = torch.where(reached, state.n_contacts + 1, 0).to(torch.int32)
        step_count = state.step_count + 1
        done = state.terminated | (step_count > self.max_steps)
        new_state = dataclasses.replace(
            state, robot_pos=robot_pos, step_count=step_count, n_contacts=n_contacts,
            render_noise=self._render_noise(noise, pos.shape[0], dev))
        return new_state, reward.to(torch.float32), done

    # ------------------------------------------------------------------
    def ground_truth(self, state: OmniRobotState) -> torch.Tensor:
        return state.robot_pos

    def target_pos(self, state: OmniRobotState) -> torch.Tensor:
        return state.target_pos

    def observe(self, state: OmniRobotState) -> torch.Tensor:
        if self.srl_model == "ground_truth":
            return self.srl_state(state)
        return self.render_pixels(state)

    def actionPolicyTowardTarget(self, state: OmniRobotState) -> torch.Tensor:
        """The expert: the larger axis of the distance to the target, as a
        discrete move, or the distance clipped to a step."""
        d = state.target_pos - state.robot_pos
        if self.is_discrete:
            return torch.where(torch.abs(d[:, 0]) > torch.abs(d[:, 1]),
                               torch.where(d[:, 0] > 0, 0, 1),
                               torch.where(d[:, 1] > 0, 2, 3)).to(torch.int32)
        return torch.clamp(d, -STEP_DISTANCE, STEP_DISTANCE)

    def render_pixels(self, state: OmniRobotState) -> torch.Tensor:
        """uint8 [N, 224, 224, 3] frames: the static floor, then the target
        square, the robot disk and its heading dot, each a mask over the
        view grid. The masks are those of the reference's float32 render,
        and compositing the quantised colours gives its bytes: bit-equal to
        the jitted reference (tests/test_torch_omnirobot.py)."""
        dev = state.robot_pos.device
        xs, ys, background, (target_rgb, robot_rgb, heading_rgb) = _static_frame(dev)
        pos, yaw = state.robot_pos, state.robot_yaw
        if self.noise:
            pos = pos + state.render_noise[:, :2] * NOISE_VAR_ROBOT_POS
            yaw = yaw + state.render_noise[:, 2] * np.float32(NOISE_VAR_ROBOT_YAW)

        t = state.target_pos
        tmask = ((torch.abs(ys[None, :] - t[:, 1:2]) < 0.09)[:, :, None]
                 & (torch.abs(xs[None, :] - t[:, 0:1]) < 0.09)[:, None, :])
        img = torch.where(tmask[..., None], target_rgb, background)

        def disk(cx, cy, radius):
            dx = xs[None, None, :] - cx[:, None, None]
            dy = ys[None, :, None] - cy[:, None, None]
            return dx * dx + dy * dy < radius ** 2

        img = torch.where(disk(pos[:, 0], pos[:, 1], 0.11)[..., None], robot_rgb, img)
        hx = pos[:, 0] + 0.06 * torch.cos(yaw)
        hy = pos[:, 1] + 0.06 * torch.sin(yaw)
        return torch.where(disk(hx, hy, 0.035)[..., None], heading_rgb, img)
