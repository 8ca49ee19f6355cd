"""Frozen copy of the plain PyTorch in srl_tpu_torch/ops/renderer.py,
kept under the benchmark as the yardstick: it imports nothing of the
program.

MobileRobot scene constants, the host-side tables of the sprite
compositor, and the first-person camera (counterpart of
srl_tpu/ops/renderer.py).

The top-down view is a packed-u32 sprite composite over a precomputed
checker-and-walls background; ``ops/render2d.py`` draws it (the CUDA kernel
on a card, its plain twin on the CPU) from the tables built here. The tables
are numpy, computed once per configuration with the reference's formulas and
roundings, so that both packages see the same bits. The first-person view
(``fpv=True``) is plain PyTorch ray tracing, as the reference computes it
with XLA and not with a Pallas kernel.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# Colors (linear 0..1, shaded flat).
GROUND_LIGHT = np.array([0.93, 0.93, 0.93], np.float32)
GROUND_DARK = np.array([0.78, 0.78, 0.78], np.float32)
WALL_COLORS = {
    "left": np.array([0.8, 0.0, 0.0], np.float32),  # red
    "bottom": np.array([0.05, 0.05, 0.05], np.float32),  # black
    "right": np.array([0.0, 0.8, 0.0], np.float32),  # green
    "top": np.array([0.0, 0.0, 0.8], np.float32),  # blue
}
TARGET_YELLOW = np.array([0.95, 0.95, 0.05], np.float32)
TARGET_RED = np.array([0.8, 0.05, 0.05], np.float32)
ROBOT_BODY = np.array([0.15, 0.15, 0.35], np.float32)
ROBOT_WHEEL = np.array([0.05, 0.05, 0.05], np.float32)

TARGET_RADIUS = 0.25
WALL_HALF_W = 0.05
LINE_TARGET_HALF_W = 0.25
ROBOT_HALF_L = 0.325  # ROBOT_LENGTH / 2 (x)
ROBOT_HALF_W = 0.10  # ROBOT_WIDTH / 2 (y)
# The four wheel pads sit at (+-WHEEL_DX, +-ROBOT_HALF_W) from the chassis
# centre, with half extents (WHEEL_HALF_X, WHEEL_HALF_Y).
WHEEL_DX = 0.22
WHEEL_HALF_X = 0.08
WHEEL_HALF_Y = 0.03


@lru_cache(maxsize=16)
def _mobile_robot_coords(dim: int, height: int, width: int):
    """Separable pixel -> ground coordinates (xs_row [W], ys_col [H], f32).

    The top-down camera looks straight down on the plate, so column u fixes
    world x and row v world y. Computed in float64 and rounded once, these
    two vectors are the canonical per-pixel coordinates."""
    target = (2.0, 2.0, 0.0) if dim == 2 else (2.0, 0.0, 0.0)
    tan_half = np.tan(np.radians(60.0) / 2.0)
    aspect = width / height
    ndc_x = (np.arange(width) + 0.5) / width * 2.0 - 1.0
    ndc_y = 1.0 - (np.arange(height) + 0.5) / height * 2.0
    xs_row = (target[0] + 4.4 * tan_half * aspect * ndc_x).astype(np.float32)
    ys_col = (target[1] + 4.4 * tan_half * ndc_y).astype(np.float32)
    return xs_row, ys_col


@lru_cache(maxsize=16)
def _mobile_robot_static(dim: int, height: int, width: int):
    """(grid [H, W, 2], background [H, W, 3]) float32 numpy for a config."""
    xs_row, ys_col = _mobile_robot_coords(dim, height, width)
    xs = np.broadcast_to(xs_row[None, :], (height, width))
    ys = np.broadcast_to(ys_col[:, None], (height, width))
    grid = np.stack([xs, ys], axis=-1).astype(np.float32)

    # Checkerboard ground.
    checker = ((np.floor(xs / 0.5) + np.floor(ys / 0.5)) % 2).astype(np.float32)
    bg = (
        checker[..., None] * GROUND_DARK[None, None]
        + (1 - checker[..., None]) * GROUND_LIGHT[None, None]
    )

    def paint_box(img, cx, cy, hx, hy, color):
        mask = (np.abs(xs - cx) <= hx) & (np.abs(ys - cy) <= hy)
        return np.where(mask[..., None], color[None, None], img)

    # Walls (the 1D variant has only the left wall).
    bg = paint_box(bg, 2.0, 0.0, 2.0, WALL_HALF_W, WALL_COLORS["left"])
    if dim == 2:
        bg = paint_box(bg, 4.0, 2.0, WALL_HALF_W, 2.0, WALL_COLORS["bottom"])
        bg = paint_box(bg, 2.0, 4.0, 2.0, WALL_HALF_W, WALL_COLORS["right"])
        bg = paint_box(bg, 0.0, 2.0, WALL_HALF_W, 2.0, WALL_COLORS["top"])

    return grid, bg.astype(np.float32)


def _color_u8(c) -> np.ndarray:
    """Quantize a linear color as ``clip(c * 255 + 0.5)`` does, so uint8
    compositing gives the float path's bits."""
    return np.clip(np.asarray(c, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _pack_color(c) -> np.uint32:
    """RGB -> one little-endian u32 (R in byte 0)."""
    cu = _color_u8(c)
    return np.uint32(int(cu[0]) | (int(cu[1]) << 8) | (int(cu[2]) << 16))


@lru_cache(maxsize=16)
def _mobile_robot_static_packed(dim: int, height: int, width: int):
    """(xs_row f32 [W], ys_col f32 [H], background u32-packed [H, W])."""
    xs_row, ys_col = _mobile_robot_coords(dim, height, width)
    _, bg = _mobile_robot_static(dim, height, width)
    bu = _color_u8(bg)
    packed = (bu[..., 0].astype(np.uint32)
              | (bu[..., 1].astype(np.uint32) << 8)
              | (bu[..., 2].astype(np.uint32) << 16))
    return xs_row, ys_col, packed
