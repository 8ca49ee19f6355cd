"""SRL encoder, decoder and heads (counterpart of srl_tpu/srl/nets.py).

``SRLModules`` is the encoder (the conv net for images, an MLP for vectors)
plus the heads its loss set needs: a deconv decoder (autoencoder, dae, vae),
the vae's log-variance head, and the forward, inverse and reward heads. With
split dimensions each head reads only its own slice of the state vector.

Numerics follow the reference. Images arrive as NHWC (uint8 or float),
are scaled by /255 in float32, and the convs and deconvs run in bfloat16
with the bias cast too; the encoder flattens in NHWC order and its fc1 and
state layers, the decoder's Dense and every head run in float32. The
decoder casts back to float32 before its sigmoid.

Two layouts differ from PyTorch's defaults:

* Flax's ``padding="SAME"`` pads ``max((ceil(n/s) - 1) * s + k - n, 0)`` in
  all, the smaller half first, so at 224 the third conv pads (0, 1). Every
  conv pads with ``F.pad`` (which keeps the channels-last layout) and
  convolves unpadded: PyTorch's CPU bfloat16 conv returns garbage weight
  gradients for a 1x1 NCHW input with ``padding=1`` and stride 2, the
  third conv's case on 8x8 frames.
* Flax's ``ConvTranspose`` does not flip its kernel; PyTorch's
  ``conv_transpose2d`` does. A port deconv weight [in, out, kh, kw] is the
  Flax kernel HWIO flipped in both spatial axes (``bridge`` maps them), and
  stride 2 with padding 1 gives Flax's SAME output (twice the input).

Parameter names are the Flax module names (``encoder.c1``,
``decoder.Dense_0``, ``forward_head.Dense_1``, ...), so that
``srl_tpu_torch.bridge`` maps the two trees by name.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from srl_tpu_torch.models.policies import ORTHO_GAIN, _conv, _linear

RECON_LOSSES = ("autoencoder", "vae", "dae")


def split_ranges(losses, state_dim, split_dimensions) -> Dict[str, Tuple[int, int]]:
    """Per-loss (start, end) slices of the state vector.

    Each loss with a width in ``split_dimensions`` owns a contiguous slice,
    allocated in loss order; -1 takes the remaining dims. A loss without a
    width, or every loss when ``split_dimensions`` is empty, sees the whole
    vector."""
    if not split_dimensions:
        return {loss: (0, state_dim) for loss in losses}
    split = dict(split_dimensions)
    explicit = sum(d for d in split.values() if d > 0)
    rest = state_dim - explicit
    n_rest = sum(1 for d in split.values() if d < 0)
    if rest < 0:
        raise ValueError(f"split dims {split} exceed state_dim {state_dim}")
    if n_rest > 1:
        raise ValueError("at most one loss may take the remaining dims (-1)")
    ranges, start = {}, 0
    for loss in losses:
        d = split.get(loss, 0)
        if d < 0:
            d = rest
        if d == 0:
            ranges[loss] = (0, state_dim)
            continue
        ranges[loss] = (start, start + d)
        start += d
    return ranges


def _deconv(n_in: int, n_out: int) -> nn.ConvTranspose2d:
    layer = nn.ConvTranspose2d(n_in, n_out, 4, stride=2, padding=1)
    nn.init.orthogonal_(layer.weight, ORTHO_GAIN)
    nn.init.zeros_(layer.bias)
    return layer


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """Flax's SAME padding of one axis: (before, after)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_same(layer: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``layer`` over NCHW ``x`` with SAME padding, in ``x``'s dtype."""
    k, s = layer.kernel_size[0], layer.stride[0]
    (top, bottom), (left, right) = (same_padding(n, k, s) for n in x.shape[-2:])
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype), stride=s)


def _deconv_same(layer: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    return F.conv_transpose2d(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype),
                              stride=2, padding=1)


class SRLConvEncoder(nn.Module):
    """Pixels [B, H, W, C] -> state [B, state_dim]: conv 32x8s4, 64x4s2,
    64x3s2 (SAME), fc 256, state."""

    def __init__(self, state_dim: int, obs_hw: Sequence[int] = (224, 224),
                 channels: int = 3):
        super().__init__()
        self.c1 = _conv(channels, 32, 8, 4)
        self.c2 = _conv(32, 64, 4, 2)
        self.c3 = _conv(64, 64, 3, 2)
        h, w = obs_hw
        for s in (4, 2, 2):
            h, w = math.ceil(h / s), math.ceil(w / s)
        self.fc1 = _linear(h * w * 64, 256)
        self.state = _linear(256, state_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = (x.to(torch.float32) / 255.0).to(torch.bfloat16).permute(0, 3, 1, 2)
        x = F.relu(_conv_same(self.c1, x))
        x = F.relu(_conv_same(self.c2, x))
        x = F.relu(_conv_same(self.c3, x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).to(torch.float32)
        return self.state(F.relu(self.fc1(x)))


class SRLMlpEncoder(nn.Module):
    """Vector observations -> state: two 128-unit ReLU layers."""

    def __init__(self, n_in: int, state_dim: int):
        super().__init__()
        self.Dense_0 = _linear(n_in, 128)
        self.Dense_1 = _linear(128, 128)
        self.Dense_2 = _linear(128, state_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], -1).to(torch.float32)
        x = F.relu(self.Dense_1(F.relu(self.Dense_0(x))))
        return self.Dense_2(x)


class SRLDeconvDecoder(nn.Module):
    """State [B, n_in] -> pixels [B, H, W, C] in [0, 1]: Dense to
    (H//16) x (W//16) x 64, four 4x4 stride-2 deconvs, sigmoid, crop."""

    def __init__(self, n_in: int, out_hw: Sequence[int], channels: int = 3):
        super().__init__()
        self.out_hw = tuple(out_hw)
        self.h0 = max(self.out_hw[0] // 16, 1)
        self.w0 = max(self.out_hw[1] // 16, 1)
        self.Dense_0 = _linear(n_in, self.h0 * self.w0 * 64)
        self.d1 = _deconv(64, 64)
        self.d2 = _deconv(64, 32)
        self.d3 = _deconv(32, 16)
        self.d4 = _deconv(16, channels)

    def forward(self, s: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.Dense_0(s)).reshape(s.shape[0], self.h0, self.w0, 64)
        x = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        x = F.relu(_deconv_same(self.d1, x))
        x = F.relu(_deconv_same(self.d2, x))
        x = F.relu(_deconv_same(self.d3, x))
        x = torch.sigmoid(_deconv_same(self.d4, x).to(torch.float32))
        x = x.permute(0, 2, 3, 1)
        return x[:, : self.out_hw[0], : self.out_hw[1], :]


class _PairHead(nn.Module):
    """concat(a, b) -> Dense 64 ReLU -> Dense n_out."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.Dense_0 = _linear(n_in, 64)
        self.Dense_1 = _linear(64, n_out)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(F.relu(self.Dense_0(torch.cat([a, b], -1))))


class ForwardHead(_PairHead):
    """(state slice, one-hot action) -> next state slice."""


class InverseHead(_PairHead):
    """(state slice, next state slice) -> action logits."""


class RewardHead(_PairHead):
    """(state slice, next state slice) -> logits over the reward's sign
    classes {-1, 0, 1}."""


class SRLModules(nn.Module):
    """The encoder plus the heads that ``losses`` needs.

    ``obs_shape`` is one observation's shape: [H, W, C] for images (C = 6
    for a multi-view triplet model, whose encoder reads one 3-channel view),
    any shape for vectors with ``image_obs=False``."""

    def __init__(self, state_dim: int, losses: Sequence[str],
                 obs_shape: Sequence[int] = (224, 224, 3), image_obs: bool = True,
                 n_actions: int = 4,
                 split_dimensions: Optional[Dict[str, int]] = None):
        super().__init__()
        self.state_dim = state_dim
        self.losses = tuple(losses)
        self.ranges = split_ranges(self.losses, state_dim, split_dimensions)
        self.recon = next((l for l in RECON_LOSSES if l in self.losses), None)
        if image_obs:
            h, w, channels = obs_shape
            enc_channels = channels // 2 if "triplet" in self.losses else channels
            self.encoder = SRLConvEncoder(state_dim, (h, w), enc_channels)
        else:
            if self.recon is not None:
                raise ValueError(f"the {self.recon} loss needs image observations")
            self.encoder = SRLMlpEncoder(math.prod(obs_shape), state_dim)
        width = lambda loss: self.ranges[loss][1] - self.ranges[loss][0]
        if "vae" in self.losses:
            self.log_var_head = _linear(width("vae"), width("vae"))
        if self.recon is not None:
            self.decoder = SRLDeconvDecoder(width(self.recon), (h, w), channels)
        if "forward" in self.losses:
            self.forward_head = ForwardHead(width("forward") + n_actions, width("forward"))
        if "inverse" in self.losses:
            self.inverse_head = InverseHead(2 * width("inverse"), n_actions)
        if "reward" in self.losses:
            self.reward_head = RewardHead(2 * width("reward"), 3)

    def _slice(self, s: torch.Tensor, loss: str) -> torch.Tensor:
        a, b = self.ranges[loss]
        return s[..., a:b]

    def encode(self, obs: torch.Tensor) -> torch.Tensor:
        return self.encoder(obs)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.encode(obs)

    def decode(self, s: torch.Tensor) -> torch.Tensor:
        return self.decoder(self._slice(s, self.recon))

    def vae_posterior(self, obs: torch.Tensor):
        """(mu, log_var): the encoder output is mu, and the log-variance is
        computed from mu's vae slice."""
        mu = self.encoder(obs)
        return mu, self.log_var_head(self._slice(mu, "vae"))

    def predict_forward(self, s: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
        return self.forward_head(self._slice(s, "forward"), a)

    def predict_inverse(self, s: torch.Tensor, s_next: torch.Tensor) -> torch.Tensor:
        return self.inverse_head(self._slice(s, "inverse"), self._slice(s_next, "inverse"))

    def predict_reward(self, s: torch.Tensor, s_next: torch.Tensor) -> torch.Tensor:
        return self.reward_head(self._slice(s, "reward"), self._slice(s_next, "reward"))
