"""The Nature CNN actor-critic (Mnih et al. 2015; stable-baselines'
CnnPolicy) in plain float32: 32x8 stride 4, 64x4 stride 2, 64x3 stride 1,
fc512, ReLU after each, then a value head and a policy head of logits.
A network of the benchmark's contract (``reference/__init__.py``): every
leaf is trained, and the program's observation is the env's frame.

Frames arrive as uint8 NHWC and are scaled by 1/255. A frame traced at
1/``input_scale`` of the network's resolution is upsampled (nearest) to
it first, as its definition says. The fc weight reads the last feature
map flattened in NHWC order (the stable-baselines and Flax layout).

``precision="fp8"`` is the control: the inputs and weights of the four
layers that a lower-precision path would run in float8 (e4m3, one scale
per tensor) are rounded to it; everything else stays float32."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

CONVS = (("c1", 32, 8, 4), ("c2", 64, 4, 2), ("c3", 64, 3, 1))
FC = 512
# The program's observations are uint8 frames.
FRAMES = True


def feature_hw(h: int) -> int:
    for _, _, k, s in CONVS:
        h = (h - k) // s + 1
    return h


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of the parameters, weights as PyTorch lays them out
    ([out, in] and OIHW), for the configuration's traced ``frame`` (H, W,
    C) at ``input_scale`` and its ``n_actions``."""
    h, w, c = cfg["frame"]
    input_scale = cfg.get("input_scale", 1)
    n_actions = cfg["n_actions"]
    h, w = h * input_scale, w * input_scale
    shapes, n_in = {}, c
    for name, n_out, k, _ in CONVS:
        shapes[f"torso.{name}.weight"] = (n_out, n_in, k, k)
        shapes[f"torso.{name}.bias"] = (n_out,)
        n_in = n_out
    shapes["torso.fc.weight"] = (FC, feature_hw(h) * feature_hw(w) * n_in)
    shapes["torso.fc.bias"] = (FC,)
    shapes["vf.weight"] = (1, FC)
    shapes["vf.bias"] = (1,)
    shapes["pi.weight"] = (n_actions, FC)
    shapes["pi.bias"] = (n_actions,)
    return shapes


def trained(name: str) -> bool:
    """Whether the optimizer steps leaf ``name``: every leaf."""
    return True


def observe(env, state, params: dict) -> torch.Tensor:
    """The program's observation of the reference env's ``state``: its
    frame."""
    return env.observe(state)


def init_params(shapes: dict, seed: int, device) -> dict:
    """Weights drawn from ``seed`` on ``device`` in one call: each weight
    normal with std gain / sqrt(fan_in) (gain sqrt(2) in the torso, 1 for
    the value head, 0.01 for the policy head, the scales of the usual
    orthogonal init), biases zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    weights = {k: s for k, s in shapes.items() if k.endswith(".weight")}
    flat = torch.randn(sum(math.prod(s) for s in weights.values()), generator=gen,
                       device=device)
    params, at = {}, 0
    for name, shape in shapes.items():
        if name not in weights:
            params[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        gain = 1.0 if name.startswith("vf.") else 0.01 if name.startswith("pi.") \
            else math.sqrt(2.0)
        params[name] = flat[at:at + n].view(shape) * (gain / math.sqrt(n // shape[0]))
        at += n
    return params


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor; the
    gradient passes straight through."""
    scale = x.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def forward(params: dict, frames: torch.Tensor, cfg: dict, precision: str = "fp32",
            magnitude: bool = False):
    """(logits [N, A], values [N]) of uint8 frames [N, H, W, C]; with
    ``magnitude``, also the value head's magnitude [N]: the sum of |weight
    x feature| over its 512 inputs, and |bias|."""
    input_scale = cfg.get("input_scale", 1)
    q = _fp8 if precision == "fp8" else (lambda t: t)
    x = frames.to(torch.float32).div(255.0).permute(0, 3, 1, 2)
    if input_scale > 1:
        x = x.repeat_interleave(input_scale, 2).repeat_interleave(input_scale, 3)
    for name, _, _, stride in CONVS:
        x = F.relu(F.conv2d(q(x), q(params[f"torso.{name}.weight"]),
                            params[f"torso.{name}.bias"], stride=stride))
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(F.linear(q(x), q(params["torso.fc.weight"]), params["torso.fc.bias"]))
    values = F.linear(x, params["vf.weight"], params["vf.bias"])[:, 0]
    logits = F.linear(x, params["pi.weight"], params["pi.bias"])
    if not magnitude:
        return logits, values
    w, b = params["vf.weight"][0].abs(), params["vf.bias"].abs()
    return logits, values, x.abs() @ w + b
