"""Recurrent (LSTM) actor-critic policies (counterpart of
srl_tpu/models/recurrent.py).

``lstm``/``lnlstm`` (MLP torso) and ``cnnlstm``/``cnnlnlstm`` (Nature CNN
torso, without ``input_scale``: on coarse observations the CNN runs on the
112x112 image itself, as the reference builds it): torso -> an LSTM cell of
64 -> optional LayerNorm -> pi/vf heads. The carry is zeroed where ``done``
marks an episode start, before the step.

The cell is Flax's ``OptimizedLSTMCell``: gates i, f, g, o from
``(h @ W_h + b_h) + x @ W_i`` (the input projection has no bias and there is
no forget-gate offset), carry ``(c, h)`` in that order. The LayerNorm is
Flax's: eps 1e-6 and the variance as ``E[x^2] - E[x]^2``.
``srl_tpu_torch.bridge`` maps the parameters to and from the reference's
tree (``features``, ``cell/{ii,if,ig,io}/kernel``,
``cell/{hi,hf,hg,ho}/{kernel,bias}``, ``ln/{scale,bias}``, ``vf``, ``pi``).

``forward(obs, carry, done)`` takes one step when ``done`` is [B] and a
whole [T, B] segment when it is [T, B]: the torso, which does not depend on
the carry, then runs once over the T*B frames (one batched CNN call) and
only the cell loops over T, the same function as stepping the whole policy
T times.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srl_tpu_torch.core.spaces import Discrete, Space
from srl_tpu_torch.models.distributions import Categorical, DiagGaussian
from srl_tpu_torch.models.policies import _linear, make_torso

N_LSTM = 64
Carry = Tuple[torch.Tensor, torch.Tensor]


class LstmCell(nn.Module):
    """Flax's ``OptimizedLSTMCell``: the four gates' kernels stacked in the
    order i, f, g, o (``weight_ih`` [4H, in] without bias, ``weight_hh``
    [4H, H] with ``bias_hh``); ``lecun_normal`` input kernels, orthogonal
    recurrent kernels (one per gate), zero biases."""

    def __init__(self, n_in: int, n_hidden: int):
        super().__init__()
        self.n_hidden = n_hidden
        self.weight_ih = nn.Parameter(torch.empty(4 * n_hidden, n_in))
        self.weight_hh = nn.Parameter(torch.empty(4 * n_hidden, n_hidden))
        self.bias_hh = nn.Parameter(torch.zeros(4 * n_hidden))
        std = math.sqrt(1.0 / n_in) / 0.87962566103423978  # truncated at 2 std
        nn.init.trunc_normal_(self.weight_ih, std=std, a=-2 * std, b=2 * std)
        for gate in self.weight_hh.data.chunk(4):
            nn.init.orthogonal_(gate)

    def project_input(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W_i`` for every gate: one matmul over all the steps."""
        return F.linear(x, self.weight_ih)

    def step(self, x_proj: torch.Tensor, carry: Carry) -> Carry:
        """One step from the projected input: carry (c, h) -> (c', h')."""
        c, h = carry
        gates = F.linear(h, self.weight_hh, self.bias_hh) + x_proj
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class FlaxLayerNorm(nn.Module):
    """``flax.linen.LayerNorm()`` over the last axis: eps 1e-6, the variance
    as ``max(E[x^2] - E[x]^2, 0)``, ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias``."""

    def __init__(self, n: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(n))
        self.bias = nn.Parameter(torch.zeros(n))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp_min(torch.square(x).mean(-1, keepdim=True) - torch.square(mean), 0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def mask_carry(carry: Carry, done: torch.Tensor) -> Carry:
    """Both halves of the carry zeroed where ``done`` [B] starts an episode."""
    mask = (1.0 - done.to(torch.float32))[:, None]
    return carry[0] * mask, carry[1] * mask


class LstmCore(nn.Module):
    """The torso, Flax's LSTM cell and an optional LayerNorm, under the
    parameter names the bridge maps (``torso``, ``cell``, ``ln``); a
    subclass adds its heads. ``hidden(obs, carry, done)`` takes one step for
    ``done`` [B]; for ``done`` [T, B] (obs [T, B, ...]) it runs the torso
    once over the T*B frames and the input projection as one matmul, then
    only the cell over T."""

    def __init__(self, obs_shape, torso: str = "mlp", n_lstm: int = N_LSTM,
                 layer_norm: bool = False):
        super().__init__()
        self.torso_kind = torso
        self.n_lstm = n_lstm
        self.torso = make_torso(obs_shape, torso)
        self.cell = LstmCell(self.torso.out_dim, n_lstm)
        self.ln = FlaxLayerNorm(n_lstm) if layer_norm else None

    def initial_state(self, batch: int, device="cpu") -> Carry:
        zeros = torch.zeros((batch, self.n_lstm), dtype=torch.float32, device=device)
        return zeros, zeros.clone()

    def _norm(self, h):
        return self.ln(h) if self.ln is not None else h

    def hidden(self, obs, carry: Carry, done):
        """(the cell's outputs before the LayerNorm, [B, H] or [T, B, H];
        the last carry)."""
        if done.dim() == 1:
            carry = self.cell.step(self.cell.project_input(self.torso(obs)),
                                   mask_carry(carry, done))
            return carry[1], carry
        t, b = done.shape
        x = self.cell.project_input(self.torso(obs.reshape((t * b,) + obs.shape[2:])))
        x = x.reshape(t, b, -1)
        hs = []
        for k in range(t):
            carry = self.cell.step(x[k], mask_carry(carry, done[k]))
            hs.append(carry[1])
        return torch.stack(hs), carry


class LstmActorCritic(LstmCore):
    def __init__(self, action_space: Space, obs_shape, torso: str = "mlp",
                 n_lstm: int = N_LSTM, layer_norm: bool = False):
        super().__init__(obs_shape, torso, n_lstm, layer_norm)
        self.action_space = action_space
        self.vf = _linear(n_lstm, 1, gain=1.0)
        if isinstance(action_space, Discrete):
            self.pi = _linear(n_lstm, action_space.n, gain=0.01)
            self.log_std = None
        else:
            act_dim = int(np.prod(action_space.shape))
            self.pi = _linear(n_lstm, act_dim, gain=0.01)
            self.log_std = nn.Parameter(torch.zeros(act_dim))

    def _heads(self, h):
        h = self._norm(h)
        value = self.vf(h)[..., 0]
        out = self.pi(h)
        if self.log_std is None:
            return Categorical(out), value
        return DiagGaussian(out, self.log_std.expand_as(out)), value

    def forward(self, obs, carry: Carry, done):
        """(distribution, value, carry'): one step for ``done`` [B], a
        segment for ``done`` [T, B] (obs [T, B, ...]; the distribution and
        values then [T, B, ...])."""
        h, carry = self.hidden(obs, carry, done)
        dist, value = self._heads(h)
        return dist, value, carry


def make_recurrent_policy(action_space: Space, obs_shape, policy: str) -> LstmActorCritic:
    """'lstm' | 'lnlstm' | 'cnnlstm' | 'cnnlnlstm' -> module."""
    if policy not in ("lstm", "lnlstm", "cnnlstm", "cnnlnlstm"):
        raise ValueError(f"unknown recurrent policy kind '{policy}'")
    return LstmActorCritic(action_space, tuple(obs_shape),
                           torso="cnn" if policy.startswith("cnn") else "mlp",
                           layer_norm="lnlstm" in policy)
