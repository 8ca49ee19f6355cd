"""Actor-critic policy networks (counterpart of srl_tpu/models/policies.py).

``mlp`` (2x64 tanh) and ``cnn`` (Nature CNN). Images arrive as NHWC uint8,
are scaled by /255 in float32 and run through the convolutions and fc512 in
bfloat16; parameters and the torso output stay float32. The scaling, conv1
and its ReLU are one op (``ops/conv1``: CUDA kernels on the card). Parameter
names and layouts are PyTorch's (Linear [out, in], conv OIHW);
``srl_tpu_torch.bridge`` maps them to and from the Flax tree of the
reference.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srl_tpu_torch.core.spaces import Discrete, Space
from srl_tpu_torch.models.distributions import Categorical, DiagGaussian
from srl_tpu_torch.ops import conv1 as conv1_op

ORTHO_GAIN = math.sqrt(2)


def _linear(n_in: int, n_out: int, gain: float = ORTHO_GAIN) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    nn.init.orthogonal_(layer.weight, gain)
    nn.init.zeros_(layer.bias)
    return layer


def _conv(n_in: int, n_out: int, k: int, stride: int) -> nn.Conv2d:
    layer = nn.Conv2d(n_in, n_out, k, stride)
    nn.init.orthogonal_(layer.weight, ORTHO_GAIN)
    nn.init.zeros_(layer.bias)
    return layer


def _bf16_conv(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype),
                    stride=layer.stride)


class MlpTorso(nn.Module):
    """Two 64-unit tanh layers over the flattened observation."""

    def __init__(self, n_in: int, hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.out_dim = hidden[-1]
        for i, h in enumerate(hidden):
            self.add_module(f"fc{i}", _linear(n_in, h))
            n_in = h
        self.n_layers = len(hidden)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        for i in range(self.n_layers):
            x = torch.tanh(getattr(self, f"fc{i}")(x))
        return x


class _Conv1(nn.Module):
    """conv1 of the Nature CNN (32 x 8x8 stride 4) with an optional fused 2x
    nearest upsample of its input.

    The parameter is always the full-resolution [32, C, 8, 8] kernel. With
    ``input_scale=2`` the input is the half-resolution image, and the exact
    identity

        conv(upsample2x(x), k=8, s=4) == conv(x, k'=4, s=2),
        k'[m, n] = sum of k[2m + {0, 1}, 2n + {0, 1}]

    replaces the upsample; gradients flow through the block sum. The
    forward is the stem from frames (``ops/conv1.conv1_stem``); ``conv`` is
    the plain convolution of an input already scaled."""

    def __init__(self, n_in: int, input_scale: int = 1):
        super().__init__()
        if input_scale not in (1, 2):
            raise ValueError("only a 2x fused upsample is supported")
        self.input_scale = input_scale
        self.weight = nn.Parameter(torch.empty(32, n_in, 8, 8))
        self.bias = nn.Parameter(torch.zeros(32))
        nn.init.orthogonal_(self.weight, ORTHO_GAIN)

    def folded_weight(self) -> torch.Tensor:
        if self.input_scale == 1:
            return self.weight
        o, c = self.weight.shape[:2]
        return self.weight.reshape(o, c, 4, 2, 4, 2).sum((3, 5))

    @property
    def stride(self) -> int:
        return 4 if self.input_scale == 1 else 2

    def forward(self, frames):
        """relu(conv1(frames / 255)) as bf16 NCHW in channels_last memory,
        from NHWC uint8 ``frames``."""
        out = conv1_op.conv1_stem(frames, self.folded_weight(), self.bias, self.stride)
        return out.permute(0, 3, 1, 2)

    def conv(self, x):
        """``x`` NCHW in its compute dtype."""
        return F.conv2d(x, self.folded_weight().to(x.dtype),
                        self.bias.to(x.dtype), stride=self.stride)


class NatureCnnTorso(nn.Module):
    """32x8s4, 64x4s2, 64x3s1, fc512 (stable-baselines CnnPolicy). Input:
    uint8 NHWC; ``input_scale=2`` consumes half-resolution images with the
    upsample folded into conv1, and every later shape is unchanged."""

    def __init__(self, obs_shape, input_scale: int = 1):
        super().__init__()
        h, w, c = obs_shape
        self.c1 = _Conv1(c, input_scale)
        self.c2 = _conv(32, 64, 4, 2)
        self.c3 = _conv(64, 64, 3, 1)

        def out_hw(n):
            n = (n - 8) // 4 + 1 if input_scale == 1 else (n - 4) // 2 + 1
            return ((n - 4) // 2 + 1) - 2

        self.fc = _linear(out_hw(h) * out_hw(w) * 64, 512)
        self.out_dim = 512

    def forward(self, x):
        bf16 = torch.bfloat16
        x = self.c1(x)
        x = F.relu(_bf16_conv(self.c2, x))
        x = F.relu(_bf16_conv(self.c3, x))
        # Flatten in NHWC order, as the reference does, so that fc's weight is
        # a plain transpose of the Flax kernel.
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = F.relu(F.linear(x, self.fc.weight.to(bf16), self.fc.bias.to(bf16)))
        return x.to(torch.float32)


def make_torso(obs_shape, kind: str, input_scale: int = 1, hidden=(64, 64),
               extra: int = 0) -> nn.Module:
    """``MlpTorso(hidden)`` over the flattened observation and ``extra``
    more inputs (a critic's actions) (``mlp``), or the Nature CNN
    (``cnn``)."""
    if kind == "mlp":
        return MlpTorso(int(np.prod(obs_shape)) + extra, hidden)
    return NatureCnnTorso(obs_shape, input_scale)


def torso_kind(policy: str, obs_shape) -> str:
    """The reference's selection: ``cnn`` for ``cnn``, and for ``auto`` on
    image observations; ``mlp`` otherwise."""
    return "cnn" if policy == "cnn" or (policy == "auto" and len(obs_shape) == 3) else "mlp"


class ActorCritic(nn.Module):
    """Shared torso, value head ``vf`` and policy head ``pi`` (logits, or a
    Gaussian mean with a state-independent ``log_std``)."""

    def __init__(self, action_space: Space, obs_shape, torso: str = "mlp",
                 input_scale: int = 1):
        super().__init__()
        self.action_space = action_space
        self.torso_kind = torso
        self.torso = make_torso(obs_shape, torso, input_scale)
        latent = self.torso.out_dim
        self.vf = _linear(latent, 1, gain=1.0)
        if isinstance(action_space, Discrete):
            self.pi = _linear(latent, action_space.n, gain=0.01)
            self.log_std = None
        else:
            act_dim = int(np.prod(action_space.shape))
            self.pi = _linear(latent, act_dim, gain=0.01)
            self.log_std = nn.Parameter(torch.zeros(act_dim))

    def forward(self, obs):
        latent = self.torso(obs)
        value = self.vf(latent)[..., 0]
        out = self.pi(latent)
        if self.log_std is None:
            return Categorical(out), value
        return DiagGaussian(out, self.log_std.expand_as(out)), value


def make_policy(action_space: Space, obs_shape, policy: str = "mlp",
                input_scale: int = 1) -> ActorCritic:
    """``cnn`` for image observations under ``auto``, else ``mlp``."""
    if policy not in ("mlp", "cnn", "auto"):
        raise ValueError(f"unknown policy kind '{policy}' (mlp|cnn|auto)")
    torso = torso_kind(policy, obs_shape)
    return ActorCritic(action_space, tuple(obs_shape), torso,
                       input_scale if torso == "cnn" else 1)
