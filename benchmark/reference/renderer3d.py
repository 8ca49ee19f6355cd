"""Frozen copy of the plain PyTorch in srl_tpu_torch/ops/renderer3d.py,
kept under the benchmark as the yardstick: it imports nothing of the
program.

Kuka scene constants, cameras, the nearest upsample, and the ray-primitive
intersections of the MobileRobot first-person camera (counterpart of
srl_tpu/ops/renderer3d.py).

The per-primitive XLA renderer of the Kuka scene is not ported: the CUDA
ray tracer in ``ops/render3d.py`` and its plain PyTorch twin draw every Kuka
frame, batched or not. ``_hit_plane``, ``_hit_aabb`` and ``_hit_vcylinder``
are the reference's intersections as plain tensor functions; they broadcast
over leading axes, so an ``eye`` of [N, 1, 1, 3] against ``dirs`` [H, W, 3]
traces a batch.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .camera import pixel_rays

BIG = 1e9

# Scene colors.
FLOOR_COLOR = np.array([0.85, 0.85, 0.85], np.float32)
TABLE_COLOR = np.array([0.55, 0.38, 0.22], np.float32)
BUTTON_GREEN = np.array([0.0, 0.85, 0.0], np.float32)
BUTTON_CAP_YELLOW = np.array([0.9, 0.9, 0.0], np.float32)
BUTTON_CAP_TEAL = np.array([0.2, 0.6, 0.38], np.float32)
ARM_ORANGE = np.array([0.95, 0.55, 0.05], np.float32)
ARM_SILVER = np.array([0.75, 0.75, 0.78], np.float32)
BALL_COLOR = np.array([0.9, 0.9, 0.9], np.float32)
DISTRACTOR_COLOR = np.array([0.85, 0.75, 0.1], np.float32)
SKY_COLOR = np.array([0.7, 0.78, 0.9], np.float32)
LIGHT_DIR = np.array([0.4, 0.25, 0.88], np.float32)
LIGHT_DIR /= np.linalg.norm(LIGHT_DIR)

# Floor plane at z=-1, table top at Z_TABLE=-0.2 with the tabletop box below.
FLOOR_Z = -1.0
TABLE_CENTER = np.array([0.5, 0.0, -0.51], np.float32)
TABLE_HALF = np.array([0.75, 0.5, 0.31], np.float32)
ARM_LINK_RADIUS = 0.055
# The gripper segment and the last joint sphere are thinner.
ARM_LAST_RADIUS = 0.035
DISTRACTOR_RADIUS = 0.05
BALL_RADIUS = 0.03

# (target, distance, yaw, pitch, roll, fov) of the two Kuka cameras.
KUKA_CAMERAS = {
    "main": ((0.316, -0.2, -0.1), 1.1, 145.0, -36.0, 0.0, 60.0),
    "second": ((0.316, 0.316, -0.105), 1.05, 32.0, -13.0, 0.0, 60.0),
}


@lru_cache(maxsize=8)
def _kuka_camera(which: str, height: int, width: int):
    """(eye [3], dirs [H, W, 3]) float32 numpy for the "main" or aux camera."""
    target, dist, yaw, pitch, roll, fov = KUKA_CAMERAS[
        "main" if which == "main" else "second"
    ]
    return pixel_rays(target, dist, yaw, pitch, roll, fov, width, height)


def _safe(d: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(d) < 1e-8, 1e-8, d)


def _hit_plane(eye, dirs, z):
    """Horizontal plane at height ``z``: (t, normal +z).

    Here and in ``_hit_vcylinder`` a division by a function of the rays is
    a multiplication by its reciprocal: the reference's callers bake the
    rays in as constants, and XLA rewrites ``x / constant`` that way."""
    t = (z - eye[..., 2]) * (1.0 / _safe(dirs[..., 2]))
    t = torch.where(t > 1e-4, t, BIG)
    normal = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=dirs.device)
    return t, normal.expand(dirs.shape)


def _hit_aabb(eye, dirs, center, half):
    """Slab-method axis-aligned box: (t, unit normal of the entry face)."""
    inv = 1.0 / _safe(dirs)
    lo = (center - half - eye) * inv
    hi = (center + half - eye) * inv
    tmin = torch.minimum(lo, hi)
    tmax = torch.maximum(lo, hi)
    t_near = torch.amax(tmin, -1)
    t_far = torch.amin(tmax, -1)
    hit = (t_near <= t_far) & (t_far > 1e-4)
    t = torch.where(hit & (t_near > 1e-4), t_near, BIG)
    # The axis that reaches t_near, signed against the ray.
    is_axis = (tmin == t_near[..., None]).to(torch.float32)
    normal = -torch.sign(dirs) * is_axis
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    return t, normal / torch.where(norm < 1e-8, 1.0, norm)


def _hit_vcylinder(eye, dirs, center_xy, radius, z_lo, z_hi):
    """Vertical cylinder with a top cap disk: (t, normal)."""
    ox = eye[..., 0] - center_xy[..., 0]
    oy = eye[..., 1] - center_xy[..., 1]
    dx, dy = dirs[..., 0], dirs[..., 1]
    a = dx * dx + dy * dy
    b = 2.0 * (ox * dx + oy * dy)
    c = ox * ox + oy * oy - radius * radius
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_side = (-b - sq) * (1.0 / (2 * _safe(a)))
    z_at = eye[..., 2] + t_side * dirs[..., 2]
    side_ok = (disc > 0) & (t_side > 1e-4) & (z_at >= z_lo) & (z_at <= z_hi)
    t_side = torch.where(side_ok, t_side, BIG)
    side_n = torch.stack([(ox + t_side * dx) / radius, (oy + t_side * dy) / radius,
                          torch.zeros_like(t_side)], -1)

    t_cap, cap_n = _hit_plane(eye, dirs, z_hi)
    px = eye[..., 0] + t_cap * dx - center_xy[..., 0]
    py = eye[..., 1] + t_cap * dy - center_xy[..., 1]
    t_cap = torch.where((px * px + py * py) <= radius * radius, t_cap, BIG)

    use_cap = t_cap < t_side
    return torch.minimum(t_side, t_cap), torch.where(use_cap[..., None], cap_n, side_n)


def upsample_nearest(img: torch.Tensor, s: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., H*s, W*s, C] nearest-neighbour upsample."""
    if s == 1:
        return img
    *lead, h, w, c = img.shape
    out = img[..., :, None, :, None, :].expand(*lead, h, s, w, s, c)
    return out.reshape(*lead, h * s, w * s, c)
