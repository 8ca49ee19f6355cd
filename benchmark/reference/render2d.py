"""Frozen copy of the plain PyTorch in srl_tpu_torch/ops/render2d.py,
kept under the benchmark as the yardstick: it imports nothing of the
program.

MobileRobot sprite compositor, its plain form (the counterpart of
srl_tpu/ops/pallas_render.py): each env's scene packed into one row of 8
floats (robot xy, target xy, second target xy, two-target flag, line
flag), composited per pixel over the packed-u32 checker-and-walls
background: the yellow target disk (or the line band), the red second
target, the robot body box and its four wheel pads. Integer selects over
pre-quantized colours and float compares; the one place where rounding
decides a pixel is the disk test ``dy2 + dx2 <= r*r``, with ``dx * dx``
fused into the sum as one multiply-add.
"""
from __future__ import annotations

import numpy as np
import torch

from . import numerics
from . import renderer2d as rr

SCENE_FLOATS = 8


def _f32(x: float) -> float:
    """A constant rounded to float32, so that every path compares and
    subtracts the same value whatever precision it computes in."""
    return float(np.float32(x))


TARGET_R2 = _f32(rr.TARGET_RADIUS * rr.TARGET_RADIUS)
LINE_HALF_W = _f32(rr.LINE_TARGET_HALF_W)
LINE_CY = LINE_HALF_H = 2.0
HALF_L = _f32(rr.ROBOT_HALF_L)
HALF_W = _f32(rr.ROBOT_HALF_W)
WHEEL_DX = _f32(rr.WHEEL_DX)
WHEEL_HX = _f32(rr.WHEEL_HALF_X)
WHEEL_HY = _f32(rr.WHEEL_HALF_Y)
# Packed RGB (R in byte 0) of the sprites, quantized once on the host.
COLORS = tuple(int(rr._pack_color(c)) for c in (
    rr.TARGET_YELLOW, rr.TARGET_RED, rr.ROBOT_BODY, rr.ROBOT_WHEEL))


def scene_params(env, states) -> torch.Tensor:
    """[N, 8] float32 scene rows: robot xy, target 0 xy, target 1 xy (zeros
    with one target), two-target flag, line flag."""
    n = states.robot_pos.shape[0]
    t0 = states.targets[:, 0]
    t1 = states.targets[:, 1] if env.n_targets > 1 else torch.zeros_like(t0)
    flags = torch.tensor([float(env.n_targets > 1), float(env.line_target)],
                         dtype=torch.float32, device=t0.device).expand(n, 2)
    return torch.cat([states.robot_pos, t0, t1, flags], 1).to(torch.float32).contiguous()


_DEVICE_CONSTS: dict = {}


def static_tensors(dim: int, height: int, width: int, device):
    """(xs_row f32 [W], ys_col f32 [H], background int32 [H, W] of packed
    RGB) on ``device``, cached."""
    key = (dim, height, width, str(device))
    if key not in _DEVICE_CONSTS:
        xs, ys, bg = rr._mobile_robot_static_packed(dim, height, width)
        _DEVICE_CONSTS[key] = tuple(
            torch.as_tensor(np.ascontiguousarray(a), device=device)
            for a in (xs, ys, bg.view(np.int32)))
    return _DEVICE_CONSTS[key]


def background_rgb(dim: int, height: int, width: int, device) -> torch.Tensor:
    """uint8 [H, W, 3] on ``device``: the background of ``static_tensors`` as
    the bytes the kernel copies, cached."""
    key = ("rgb", dim, height, width, str(device))
    if key not in _DEVICE_CONSTS:
        bg = rr._mobile_robot_static_packed(dim, height, width)[2]
        rgb = np.ascontiguousarray(bg.view(np.uint8).reshape(height, width, 4)[..., :3])
        _DEVICE_CONSTS[key] = torch.as_tensor(rgb, device=device)
    return _DEVICE_CONSTS[key]


# ---------------------------------------------------------------------------
# The plain twin.
# ---------------------------------------------------------------------------
def render_mobile_robot_plain(scene, xs_row, ys_col, bg) -> torch.Tensor:
    """uint8 [N, H, W, 3]: the batched packed-u32 compositor, with the same
    formulas as the kernel. Box masks are outer products of 1-D interval
    masks, the disk is ``dy2[:, None] + dx2[None, :] <= r*r`` with the x
    square fused into the sum (``fma(dx, dx, dy2)``), and the four wheels
    are one folded mask ``| |x - rx| - 0.22 | <= 0.08``."""
    xr, yc = xs_row[None, :], ys_col[None, :]  # [1, W], [1, H]
    col = lambda j: scene[:, j:j + 1]  # [N, 1]
    rx, ry, t0x, t0y, t1x, t1y = (col(j) for j in range(6))
    two = (col(6) > 0.5)[:, :, None]
    line = (col(7) > 0.5)[:, :, None]

    def outer(my, mx):
        return my[:, :, None] & mx[:, None, :]

    def disk(cx, cy):
        dx = (xr - cx)[:, None, :]
        dy2 = torch.square(yc - cy)[:, :, None]
        return numerics.fma(dx, dx, dy2) <= TARGET_R2

    yellow, red, body, wheel = COLORS
    img = bg[None]
    band = outer(torch.abs(yc - LINE_CY) <= LINE_HALF_H, torch.abs(xr - t0x) <= LINE_HALF_W)
    img = torch.where(torch.where(line, band, disk(t0x, t0y)), yellow, img)
    img = torch.where(disk(t1x, t1y) & two & ~line, red, img)
    img = torch.where(outer(torch.abs(yc - ry) <= HALF_W, torch.abs(xr - rx) <= HALF_L),
                      body, img)
    wx = torch.abs(torch.abs(xr - rx) - WHEEL_DX) <= WHEEL_HX
    wy = torch.abs(torch.abs(yc - ry) - HALF_W) <= WHEEL_HY
    img = torch.where(outer(wy, wx), wheel, img)
    return torch.stack([(img >> s) & 255 for s in (0, 8, 16)], -1).to(torch.uint8)


def render_mobile_robot(env, states) -> torch.Tensor:
    """uint8 [N, H, W, 3] top-down frames of a batched MobileRobotState,
    composited by the plain twin on the states' device."""
    scene = scene_params(env, states)
    h, w = env.render_shape
    xs, ys, bg = static_tensors(env.dim, h, w, scene.device)
    return render_mobile_robot_plain(scene, xs, ys, bg)
