"""The MLP actor-critic (stable-baselines' MlpPolicy: two 64-unit tanh
layers, then a value head and a policy head of logits) in plain float32,
over state observations as the env returns them (ground truth): a network
of the benchmark's contract (``reference/__init__.py``) whose every leaf is
trained.

``precision="fp8"`` is the control: the inputs and weights of the two
hidden layers rounded to float8 (e4m3, one scale per tensor)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

HIDDEN = (64, 64)
FRAMES = False


def param_shapes(cfg: dict) -> dict:
    """{name: shape} of the parameters ([out, in]) for the configuration's
    ``observation`` shape and ``n_actions``."""
    shapes, n_in = {}, math.prod(cfg["observation"])
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
    return True


def observe(env, state, params: dict) -> torch.Tensor:
    """The env's own observation of ``state`` (ground truth)."""
    return env.observe(state)


def init_params(shapes: dict, seed: int, device) -> dict:
    """Weights normal with std gain / sqrt(fan_in) (sqrt(2) in the torso, 1
    for the value head, 0.01 for the policy head), drawn in one call;
    biases zero."""
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
        params[name] = flat[at:at + n].view(shape) * (gain / math.sqrt(shape[1]))
        at += n
    return params


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = x.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


def forward(params: dict, obs: torch.Tensor, cfg: dict, precision: str = "fp32",
            magnitude: bool = False):
    """(logits [N, A], values [N]) of observations [N, ...]; with
    ``magnitude``, also the value head's magnitude [N]."""
    q = _fp8 if precision == "fp8" else (lambda t: t)
    x = obs.reshape(obs.shape[0], -1).to(torch.float32)
    for i in range(len(HIDDEN)):
        x = torch.tanh(F.linear(q(x), q(params[f"torso.fc{i}.weight"]),
                                params[f"torso.fc{i}.bias"]))
    values = F.linear(x, params["vf.weight"], params["vf.bias"])[:, 0]
    logits = F.linear(x, params["pi.weight"], params["pi.bias"])
    if not magnitude:
        return logits, values
    return logits, values, x.abs() @ params["vf.weight"][0].abs() + params["vf.bias"].abs()
