"""A frozen PCA served in the env step (srl_zoo's PCA baseline: one
projection of the flattened frame, ``(frame / 255 - mean) @ components``),
then the MLP actor-critic (two 64-unit tanh layers, a value head and a
policy head of logits) on its states, in plain float32: a network of the
benchmark's contract (``reference/__init__.py``). The PCA's leaves
(``srl.*``) are frozen: the program keeps them in its env
(``handin/pca_mlp.py``); the optimizer steps the policy's.

``precision="fp8"`` is the control: the inputs and weights of the two
hidden layers rounded to float8 (e4m3, one scale per tensor)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

HIDDEN = (64, 64)
FRAMES = False


def param_shapes(cfg: dict) -> dict:
    """{name: shape}: the PCA's mean [H * W * C] and components
    [H * W * C, state_dim], then the policy's ([out, in])."""
    n_pixels = math.prod(cfg["frame"])
    shapes = {"srl.mean": (n_pixels,), "srl.components": (n_pixels, cfg["state_dim"])}
    n_in = cfg["state_dim"]
    for i, n_out in enumerate(HIDDEN):
        shapes[f"torso.fc{i}.weight"] = (n_out, n_in)
        shapes[f"torso.fc{i}.bias"] = (n_out,)
        n_in = n_out
    shapes["vf.weight"] = (1, n_in)
    shapes["vf.bias"] = (1,)
    shapes["pi.weight"] = (cfg["n_actions"], n_in)
    shapes["pi.bias"] = (cfg["n_actions"],)
    return shapes


def trained(name: str) -> bool:
    return not name.startswith("srl.")


def observe(env, state, params: dict) -> torch.Tensor:
    """The PCA's states of the env's frames of ``state``."""
    frames = env.observe(state).to(torch.float32)
    return (frames.reshape(frames.shape[0], -1) / 255.0 - params["srl.mean"]) \
        @ params["srl.components"]


def init_params(shapes: dict, seed: int, device) -> dict:
    """From ``seed``, in one call: the PCA's mean uniform in [0, 1) (a mean
    frame over 255) and its components normal with std 1 / sqrt(H * W * C)
    (columns of about unit length); the policy's weights normal with std
    gain / sqrt(fan_in) (sqrt(2) in the torso, 1 for the value head, 0.01
    for the policy head); biases zero."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    drawn = [k for k in shapes if k.endswith(".weight") or k.startswith("srl.")]
    flat = torch.randn(sum(math.prod(shapes[k]) for k in drawn), generator=gen, device=device)
    params, at = {}, 0
    for name, shape in shapes.items():
        if name not in drawn:
            params[name] = torch.zeros(shape, device=device)
            continue
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        if name == "srl.mean":
            params[name] = torch.special.ndtr(x)
        elif name == "srl.components":
            params[name] = x / math.sqrt(shape[0])
        else:
            gain = 1.0 if name.startswith("vf.") else 0.01 if name.startswith("pi.") \
                else math.sqrt(2.0)
            params[name] = x * (gain / math.sqrt(shape[1]))
    return params


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def forward(params: dict, obs: torch.Tensor, cfg: dict, precision: str = "fp32",
            magnitude: bool = False):
    """(logits [N, A], values [N]) of the policy on (normalized) states [N,
    state_dim]; with ``magnitude``, also the value head's magnitude [N]."""
    q = _fp8 if precision == "fp8" else (lambda t: t)
    x = obs.to(torch.float32)
    for i in range(len(HIDDEN)):
        x = torch.tanh(F.linear(q(x), q(params[f"torso.fc{i}.weight"]),
                                params[f"torso.fc{i}.bias"]))
    values = F.linear(x, params["vf.weight"], params["vf.bias"])[:, 0]
    logits = F.linear(x, params["pi.weight"], params["pi.bias"])
    if not magnitude:
        return logits, values
    return logits, values, x.abs() @ params["vf.weight"][0].abs() + params["vf.bias"].abs()
