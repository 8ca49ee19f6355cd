"""CarRacing, batched over N (counterpart of srl_tpu/envs/car_racing.py): a
procedural closed track, a bicycle-model car and a top-down renderer.

* Track: 12 checkpoints on a circle at random angle offsets and radii (the
  first pinned at angle 0, radius 0.75 TRACK_RAD), 21 tiles interpolated
  between consecutive checkpoints (252 tiles), then 8 circular smoothing
  passes.
* Actions: discrete(4) = steer left, steer right, gas, brake; continuous
  [steer, gas, brake] with the steer negated.
* Reward: 1000/252 per newly visited tile (a tile is visited within
  TRACK_WIDTH of the car) minus 0.1 per step; -100 and done when the car
  leaves the playfield; done when every tile is visited or at ``max_steps``.
  ``shape_reward``: minus the distance to the nearest unvisited tile over
  TRACK_RAD.
* Ground truth (dim 5): x, y, yaw, the constant hull inertia, yaw rate;
  ``target_pos`` is the tile ``lookahead`` ahead of the nearest one, padded
  to 5.

Random numbers: a reset draws the 12 angle offsets U(0, 2 pi / 12) and the
12 radii U(TRACK_RAD / 3, TRACK_RAD); a step draws none.

Pixel observations are a car-centred view rotated with the car, rendered in
plain PyTorch as the reference renders it with plain XLA (no Pallas): the
distance to the nearest of all 252 tiles on a coarse 56x56 grid, upsampled
bilinearly to 224x224 and thresholded into the track band, over a
chequered grass and under the car's red box. The coarse field is chunked
over the envs so that its [n, 56, 56, 252] temporary stays small.
"""
from __future__ import annotations

import dataclasses
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from srl_tpu_torch.core import numerics
from srl_tpu_torch.core.env import BatchedEnv
from srl_tpu_torch.core.spaces import Box, Discrete, Space
from srl_tpu_torch.ops.renderer import _color_u8

MAX_STEPS = 10000
RENDER_WIDTH = 224
RENDER_HEIGHT = 224
FPS = 50.0
DT = 1.0 / FPS
SCALE = 6.0
TRACK_RAD = 900.0 / SCALE
PLAYFIELD = 2000.0 / SCALE
N_CHECKPOINTS = 12
N_TILES = 252  # 12 checkpoints x 21 interpolated tiles
TRACK_WIDTH = 40.0 / SCALE
TILE_REWARD_TOTAL = 1000.0
LOOKAHEAD = 20

MAX_STEER = 0.42
STEER_RATE = 3.0
ENGINE_ACCEL = 40.0
BRAKE_DECEL = 80.0
DRAG = 0.35
GRIP = 6.0
WHEELBASE = 2.8
HULL_INERTIA = 1.0546

VIEW = 60.0  # world units across the view
LOW = 56  # side of the coarse distance field
# Envs per chunk of the coarse field: 32 x 56 x 56 x 252 float32 is 101 MB.
FIELD_CHUNK = 32

GRASS_HI = (0.4, 0.8, 0.4)
GRASS_LO = (0.4 * 0.92, 0.8 * 0.92, 0.4 * 0.92)
TRACK_RGB = (0.4, 0.4, 0.4)
CAR_RGB = (0.8, 0.0, 0.0)


@dataclasses.dataclass
class CarRacingState:
    pos: torch.Tensor  # [N, 2] float32
    vel: torch.Tensor  # [N, 2] world-frame velocity
    yaw: torch.Tensor  # [N]
    yaw_rate: torch.Tensor  # [N]
    wheel_angle: torch.Tensor  # [N]
    track: torch.Tensor  # [N, N_TILES, 2]
    visited: torch.Tensor  # [N, N_TILES] bool
    total_reward: torch.Tensor  # [N]
    step_count: torch.Tensor  # [N] int32
    terminated: torch.Tensor  # [N] bool


def generate_track(angle_u: torch.Tensor, rad_u: torch.Tensor) -> torch.Tensor:
    """[N, N_TILES, 2] closed loops from the drawn angle offsets and radii
    ([N, 12] each): checkpoints at (rad cos alpha, rad sin alpha), linear
    interpolation between consecutive ones, 8 passes of a circular 3-tap
    mean. The interpolation ``cps (1 - t) + nxt t`` rounds as XLA's CPU
    code does, with the first product fused into the sum, and ``/ 3`` is a
    multiplication by float32(1 / 3), as XLA rewrites it. (XLA also fuses
    some of the smoothing's products into its sums, depending on how it
    splits the passes into loops; the port rounds them as written, so the
    tiles agree to a few ulps.)"""
    n, dev = angle_u.shape[0], angle_u.device
    base = torch.arange(N_CHECKPOINTS, device=dev, dtype=torch.float32) * np.float32(
        2 * np.pi / N_CHECKPOINTS)
    alpha = base + angle_u.to(torch.float32)
    alpha[:, 0] = 0.0
    rad = rad_u.to(torch.float32).clone()
    rad[:, 0] = 0.75 * TRACK_RAD
    cps = torch.stack([rad * torch.cos(alpha), rad * torch.sin(alpha)], -1)  # [N, 12, 2]
    per = N_TILES // N_CHECKPOINTS
    t = torch.arange(per, device=dev, dtype=torch.float32) * np.float32(1.0 / per)
    nxt = torch.roll(cps, -1, dims=1)[:, :, None, :].expand(-1, -1, per, -1)
    cps = cps[:, :, None, :].expand(-1, -1, per, -1)
    t = t[None, None, :, None].expand_as(cps)
    pts = numerics.fma(cps, 1 - t, nxt * t).reshape(n, N_TILES, 2)
    for _ in range(8):
        # / 3 as XLA evaluates it: a multiplication by float32(1 / 3).
        pts = (torch.roll(pts, 1, dims=1) + pts + torch.roll(pts, -1, dims=1)) * np.float32(
            1.0 / 3.0)
    return pts


@lru_cache(maxsize=4)
def _controls_table(device: torch.device) -> torch.Tensor:
    """[4, 3] (steer, gas, brake) of the discrete actions: steer left, steer
    right, gas, brake."""
    return torch.tensor([[-1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                         [0.0, 0.0, 1.0]], device=device)


@lru_cache(maxsize=4)
def _view_grids(device: torch.device):
    """The view grids (the reference's jitted linspace, bit for bit): full
    (xs [W], ys [H]) and coarse (xs [LOW], ys [LOW]); the car's mask [H, W],
    static in the view; and the four uint8 colours (grass high and low,
    track, car)."""
    as_t = lambda a: torch.as_tensor(a, device=device)
    xs = numerics.linspace(-VIEW / 2, VIEW / 2, RENDER_WIDTH)
    ys = numerics.linspace(VIEW / 2, -VIEW / 2, RENDER_HEIGHT)
    car = (np.abs(ys)[:, None] < 2.0) & (np.abs(xs)[None, :] < 1.0)
    colours = tuple(as_t(_color_u8(c)) for c in (GRASS_HI, GRASS_LO, TRACK_RGB, CAR_RGB))
    return (as_t(xs), as_t(ys), as_t(numerics.linspace(-VIEW / 2, VIEW / 2, LOW)),
            as_t(numerics.linspace(VIEW / 2, -VIEW / 2, LOW)), as_t(car), colours)


def _tile_d2(track, pos):
    """[N, N_TILES] squared distances from ``pos`` [N, 2] to the tiles,
    ``dx * dx + dy * dy`` with the second product fused into the sum, as
    XLA's CPU code evaluates the reference's sum of squares."""
    d = track - pos[:, None, :]
    return numerics.fma(d[..., 1], d[..., 1], d[..., 0] * d[..., 0])


def _world(pos, c, s, xs, ys):
    """World coordinates [n, len(ys), len(xs)] of the view grid for cars at
    ``pos`` [n, 2] rotated by (c, s) [n]."""
    c, s = c[:, None, None], s[:, None, None]
    gx, gy = xs[None, None, :], ys[None, :, None]
    wx = pos[:, 0, None, None] + c * gx - s * gy
    wy = pos[:, 1, None, None] + s * gx + c * gy
    return wx, wy


class CarRacingEnv(BatchedEnv):
    name = "CarRacingGymEnv-v0"

    def __init__(self, is_discrete: bool = True, shape_reward: bool = False,
                 srl_model: str = "raw_pixels", max_steps: int = MAX_STEPS,
                 lookahead: int = LOOKAHEAD, state_dim: int = -1, **_):
        self.is_discrete = is_discrete
        self.shape_reward = shape_reward
        self.srl_model = srl_model
        self.relative_pos = False
        self.max_steps = max_steps
        self.lookahead = lookahead
        self.state_dim = state_dim

    @property
    def action_space(self) -> Space:
        if self.is_discrete:
            return Discrete(4)
        return Box(np.array([-1, 0, 0], np.float32), np.array([1, 1, 1], np.float32))

    @property
    def observation_space(self) -> Space:
        if self.srl_model == "raw_pixels":
            return Box(0, 255, (RENDER_HEIGHT, RENDER_WIDTH, 3), np.uint8)
        return Box(-np.inf, np.inf, (5,))

    @staticmethod
    def ground_truth_dim() -> int:
        return 5

    # ------------------------------------------------------------------
    def draw_reset_noise(self, gen: torch.Generator, n: int) -> dict:
        """``angle_u``: U(0, 2 pi / 12) [n, 12]; ``rad_u``: U(TRACK_RAD / 3,
        TRACK_RAD) [n, 12]."""
        dev = gen.device
        u = lambda lo, hi: torch.rand((n, N_CHECKPOINTS), generator=gen, device=dev) * (
            hi - lo) + lo
        return {"angle_u": u(0.0, 2 * np.pi / N_CHECKPOINTS),
                "rad_u": u(TRACK_RAD / 3, TRACK_RAD)}

    def apply_reset(self, noise: dict) -> CarRacingState:
        track = generate_track(noise["angle_u"], noise["rad_u"])
        n, dev = track.shape[0], track.device
        heading = track[:, 1] - track[:, 0]
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        false = torch.zeros(n, dtype=torch.bool, device=dev)
        return CarRacingState(
            pos=track[:, 0].clone(), vel=torch.zeros((n, 2), dtype=torch.float32, device=dev),
            yaw=torch.atan2(heading[:, 1], heading[:, 0]), yaw_rate=zeros,
            wheel_angle=zeros.clone(), track=track,
            visited=torch.zeros((n, N_TILES), dtype=torch.bool, device=dev),
            total_reward=zeros.clone(), step_count=torch.zeros(n, dtype=torch.int32, device=dev),
            terminated=false)

    # ------------------------------------------------------------------
    def draw_step_noise(self, gen: torch.Generator, n: int) -> dict:
        return {}

    def _controls(self, action):
        if self.is_discrete:
            table = _controls_table(action.device)[action.long()]
            return table[:, 0], table[:, 1], table[:, 2]
        act = action.to(torch.float32)
        return -act[:, 0], torch.clamp(act[:, 1], 0.0, 1.0), torch.clamp(act[:, 2], 0.0, 1.0)

    def apply_step(self, state: CarRacingState, action, noise: dict):
        steer, gas, brake = self._controls(action)
        target_angle = steer * MAX_STEER
        wheel_angle = state.wheel_angle + torch.clamp(
            target_angle - state.wheel_angle, -STEER_RATE * DT, STEER_RATE * DT)

        hx, hy = torch.cos(state.yaw), torch.sin(state.yaw)
        speed = state.vel[:, 0] * hx + state.vel[:, 1] * hy
        accel = gas * ENGINE_ACCEL - brake * BRAKE_DECEL * torch.sign(speed) - DRAG * speed
        speed = speed + accel * DT
        yaw_rate = speed / WHEELBASE * torch.tan(wheel_angle)
        yaw = state.yaw + yaw_rate * DT
        ideal = torch.stack([torch.cos(yaw), torch.sin(yaw)], -1) * speed[:, None]
        vel = state.vel + (ideal - state.vel) * min(GRIP * DT, 1.0)
        pos = state.pos + vel * DT

        d2 = _tile_d2(state.track, pos)
        on_tile = d2 < TRACK_WIDTH ** 2
        newly = on_tile & ~state.visited
        visited = state.visited | on_tile
        n_new = newly.sum(-1).to(torch.float32)

        step_count = state.step_count + 1
        # n_new * (1000 / 252) - 0.1 as one fused multiply-add, as XLA
        # evaluates it.
        step_reward = numerics.fma(n_new, torch.full_like(n_new, TILE_REWARD_TOTAL / N_TILES),
                                   torch.full_like(n_new, -0.1))
        out_of_field = (torch.abs(pos[:, 0]) > PLAYFIELD) | (torch.abs(pos[:, 1]) > PLAYFIELD)
        done = (out_of_field | visited.all(-1) | (step_count >= self.max_steps)
                | state.terminated)
        step_reward = torch.where(out_of_field, -100.0, step_reward)
        if self.shape_reward:
            unvisited = torch.where(visited, torch.inf, d2)
            # / TRACK_RAD as XLA evaluates it, a multiplication by the
            # float32 reciprocal; the square root correctly rounded.
            step_reward = -numerics.sqrt(unvisited.min(-1).values + 1e-8) * np.float32(
                1.0 / TRACK_RAD)

        new_state = dataclasses.replace(
            state, pos=pos, vel=vel, yaw=yaw, yaw_rate=yaw_rate, wheel_angle=wheel_angle,
            visited=visited, total_reward=state.total_reward + step_reward,
            step_count=step_count)
        return new_state, step_reward.to(torch.float32), done

    # ------------------------------------------------------------------
    def ground_truth(self, state: CarRacingState) -> torch.Tensor:
        inertia = torch.full_like(state.yaw, HULL_INERTIA)
        return torch.cat([state.pos, torch.stack([state.yaw, inertia, state.yaw_rate], -1)],
                         -1)

    def target_pos(self, state: CarRacingState) -> torch.Tensor:
        nearest = torch.argmin(_tile_d2(state.track, state.pos), -1)
        idx = (nearest + self.lookahead) % N_TILES
        rows = torch.arange(idx.shape[0], device=idx.device)
        pt = state.track[rows, idx]
        return torch.cat([pt, torch.zeros((pt.shape[0], 3), dtype=pt.dtype, device=pt.device)],
                         -1)

    def observe(self, state: CarRacingState) -> torch.Tensor:
        if self.srl_model == "ground_truth":
            return self.ground_truth(state)
        return self.render_pixels(state)

    def render_pixels(self, state: CarRacingState) -> torch.Tensor:
        """uint8 [N, 224, 224, 3] car-centred frames."""
        dev = state.pos.device
        xs, ys, xs_lo, ys_lo, car, (grass_hi, grass_lo, track_rgb, car_rgb) = _view_grids(dev)
        angle = state.yaw - np.float32(np.pi / 2)
        c, s = torch.cos(angle), torch.sin(angle)

        wx, wy = _world(state.pos, c, s, xs, ys)
        checker = torch.remainder(torch.floor(wx / 10.0) + torch.floor(wy / 10.0), 2) > 0.5
        img = torch.where(checker[..., None], grass_hi, grass_lo)

        # The squared distance to the nearest tile on the coarse grid (an
        # exact min over all tiles), upsampled, thresholded at the band.
        fields = []
        for lo in range(0, state.pos.shape[0], FIELD_CHUNK):
            sl = slice(lo, lo + FIELD_CHUNK)
            wx_lo, wy_lo = _world(state.pos[sl], c[sl], s[sl], xs_lo, ys_lo)
            tx = state.track[sl, None, None, :, 0]
            ty = state.track[sl, None, None, :, 1]
            fields.append(torch.min(torch.square(wx_lo[..., None] - tx)
                                    + torch.square(wy_lo[..., None] - ty), -1).values)
        min_d2 = F.interpolate(torch.cat(fields)[:, None], size=(RENDER_HEIGHT, RENDER_WIDTH),
                               mode="bilinear", align_corners=False)[:, 0]
        img = torch.where((min_d2 < TRACK_WIDTH ** 2)[..., None], track_rgb, img)
        return torch.where(car[..., None], car_rgb, img)
