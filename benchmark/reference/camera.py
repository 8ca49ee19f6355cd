"""Frozen copy of the plain PyTorch in srl_tpu_torch/ops/camera.py,
kept under the benchmark as the yardstick: it imports nothing of the
program.

Camera math for the ray tracer (counterpart of srl_tpu/ops/camera.py).

Host-side numpy: the Kuka cameras are static per env config, so the eye and
the per-pixel ray directions are computed once and uploaded as constants.
"""
from __future__ import annotations

import numpy as np


def camera_basis(yaw_deg: float, pitch_deg: float, roll_deg: float = 0.0):
    """Orthonormal (forward, right, up) for a z-up yaw/pitch/roll camera.

    forward points from the eye toward the target. Matches the yaw/pitch
    convention of PyBullet's debug camera: yaw rotates about +z, pitch tilts
    toward -z (pitch=-90 looks straight down).
    """
    y = np.radians(yaw_deg)
    p = np.radians(pitch_deg)
    r = np.radians(roll_deg)
    forward = np.array(
        [np.cos(p) * np.cos(y), np.cos(p) * np.sin(y), np.sin(p)], np.float64
    )
    # Right vector: horizontal, perpendicular to forward's azimuth — stays
    # well-defined at pitch=±90. (Right-handed: looking along +x with z up,
    # right is -y.)
    right = np.array([np.sin(y), -np.cos(y), 0.0], np.float64)
    up = np.cross(right, forward)
    if abs(r) > 1e-9:
        c, s = np.cos(r), np.sin(r)
        right, up = c * right + s * up, -s * right + c * up
    return forward, right, up


def pixel_rays(
    camera_target, distance, yaw, pitch, roll, fov_deg, width, height
):
    """Eye position + per-pixel unit ray directions [H, W, 3] (numpy).

    Row 0 is the top of the image; image-up is the camera up vector.
    """
    forward, right, up = camera_basis(yaw, pitch, roll)
    target = np.asarray(camera_target, np.float64)
    eye = target - distance * forward

    tan_half = np.tan(np.radians(fov_deg) / 2.0)
    aspect = width / height
    # Pixel centers in NDC.
    xs = (np.arange(width) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (np.arange(height) + 0.5) / height * 2.0
    u = xs[None, :, None] * (tan_half * aspect) * right[None, None, :]
    v = ys[:, None, None] * tan_half * up[None, None, :]
    dirs = forward[None, None, :] + u + v
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return eye.astype(np.float32), dirs.astype(np.float32)


def ground_grid(camera_target, distance, yaw, pitch, roll, fov_deg, width, height,
                ground_z=0.0):
    """World (x, y) of each pixel ray's intersection with the z=ground_z
    plane, [H, W, 2] float32. Pixels whose rays miss the plane get NaN."""
    eye, dirs = pixel_rays(camera_target, distance, yaw, pitch, roll, fov_deg, width, height)
    dz = dirs[..., 2]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (ground_z - eye[2]) / dz
    t = np.where(t > 0, t, np.nan)
    xy = eye[None, None, :2] + t[..., None] * dirs[..., :2]
    return xy.astype(np.float32)
