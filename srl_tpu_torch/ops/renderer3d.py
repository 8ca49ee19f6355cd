"""Kuka scene constants, cameras and the nearest upsample (counterpart of
srl_tpu/ops/renderer3d.py).

The per-primitive XLA renderer of the reference is not ported: the CUDA
ray tracer in ``ops/render3d.py`` and its plain PyTorch twin draw every Kuka
frame, batched or not.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from srl_tpu_torch.ops.camera import pixel_rays

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


def upsample_nearest(img: torch.Tensor, s: int) -> torch.Tensor:
    """[..., H, W, C] -> [..., H*s, W*s, C] nearest-neighbour upsample."""
    if s == 1:
        return img
    *lead, h, w, c = img.shape
    out = img[..., :, None, :, None, :].expand(*lead, h, s, w, s, c)
    return out.reshape(*lead, h * s, w * s, c)
