"""Observation preprocessing (counterpart of srl_tpu/srl/preprocessing.py):
resize to 224x224, scale to [-1, 1]; ``N_CHANNELS`` is 6 for multi-view
observations.

The reference resizes with ``jax.image.resize(..., "bilinear")``, which
filters with a triangle kernel widened by the scale when it shrinks an image
(anti-aliasing). ``F.interpolate(mode="bilinear", antialias=True)`` does the
same; without ``antialias`` a 448 -> 224 shrink differs by tens of levels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

IMAGE_WIDTH = 224
IMAGE_HEIGHT = 224
N_CHANNELS = 3  # 6 for multi-view


def getNChannels() -> int:
    return N_CHANNELS


def setNChannels(n: int):
    global N_CHANNELS
    N_CHANNELS = n


def preprocessImage(image, convert_to_rgb: bool = False) -> torch.Tensor:
    """uint8 [H, W, C] -> float32 [IMAGE_HEIGHT, IMAGE_WIDTH, C] in [-1, 1]."""
    img = torch.as_tensor(image)
    if tuple(img.shape[:2]) != (IMAGE_HEIGHT, IMAGE_WIDTH):
        chw = img.to(torch.float32).permute(2, 0, 1)[None]
        chw = F.interpolate(chw, size=(IMAGE_HEIGHT, IMAGE_WIDTH), mode="bilinear",
                            align_corners=False, antialias=True)
        img = chw[0].permute(1, 2, 0)
    img = img.to(torch.float32) / 255.0
    return img * 2.0 - 1.0


def deNormalize(x) -> torch.Tensor:
    """Inverse of preprocessImage's scaling: [-1, 1] -> [0, 1]."""
    return (torch.as_tensor(x) + 1.0) / 2.0
