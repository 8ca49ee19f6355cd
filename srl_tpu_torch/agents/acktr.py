"""ACKTR, the actor-critic with a Kronecker-factored natural gradient (K-FAC)
(counterpart of srl_tpu/agents/acktr.py): ``ACKTR`` and, with an lstm
policy, ``RecurrentACKTR``. Discrete actions only, as the reference.

The reference's defaults (n_steps 20, lr 7e-4 with momentum 0.9, vf_coef
0.25, ent_coef 0.01, gamma 0.99, kl_clip 0.001, damping 0.01, stat_decay
0.95, max_grad_norm 0.5, factors of the convs over the first 32 samples).
The policy is an explicit parameter dict with the reference's names (``W1``,
``b1``, ... or the CNN's ``C1..C3``, ``cb1..cb3``, ``Wfc``; ``Wl``, ``bl``,
``ln_g``, ``ln_b`` for the LSTM; ``Wpi``, ``bpi``, ``Wv``, ``bv``), dense
kernels [in, out] as there, conv kernels OIHW (HWIO in the reference;
``bridge.acktr_params_*`` maps them), and the fc input flattened in NHWC
order on both sides. The CNN: VALID convs 32x8s4, 64x4s2, 64x3s1 in
bfloat16 with the bias added in bfloat16, an average pool of ``pool =
max(1, min(4, h3, w3))``, fc512 in float32 (224x224: a 2304-wide fc input,
112x112: 256, 36x36: 64).

An update:

* one loss backward over the whole [T*N] batch, its gradients clipped as
  the reference clips them (``min(1, max_grad_norm / (norm + 1e-8))``);
* the true-Fisher G: targets drawn from the model's own distributions (an
  action from the policy, a value target v + e with unit Gaussian e) on the
  first 32 samples, and every layer's per-sample pre-activation gradients
  from one backward of the summed per-sample losses with respect to the
  pre-activations (summed over space for the convs): the reference's
  per-sample bias gradients (``vmap(grad)``), since samples are
  independent. ``fisher_G(..., draws=...)`` takes the draws, so a test can
  feed the reference's;
* factor EMAs from zeros, A over the bias-augmented input rows (the convs':
  ``F.unfold`` patches, channel order (cin, kh, kw) as the reference's
  ``conv_general_dilated_patches``, over the first 32 samples), both
  bias-corrected by ``1 - stat_decay^(update_idx + 1)``;
* per layer ``(A + pi sqrt(damping) I)^-1 dW (G + sqrt(damping)/pi I)^-1``
  (``torch.linalg.inv``, as the reference's XLA inverse), the trust-region
  step ``eta = min(lr, sqrt(2 kl_clip / |g.F^-1 g|))``, then momentum.

``RecurrentACKTR`` has its own cell (not Flax's): carry (h, c), gates ``[e,
h_in] @ Wl + bl`` in the order i, f, g, o, the forget gate +1.0, an
optional LayerNorm with eps 1e-5 and a two-pass variance (``ln_g``,
``ln_b`` take the plain momentum step). Its loss backpropagates through time
over the segment from the stored carry; K-FAC's ``Wl`` statistics sum over
the [T*N] rows, and the Fisher samples condition on the stored (h, c) of
their step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from srl_tpu_torch import bridge
from srl_tpu_torch.agents.base import BaseRLAgent, RecurrentActing, refuse_mesh
from srl_tpu_torch.agents.common import (collect_recurrent_rollout, collect_rollout,
                                         compute_gae)
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.models.distributions import Categorical
from srl_tpu_torch.models.recurrent import mask_carry


@dataclasses.dataclass
class ACKTRConfig:
    n_steps: int = 20
    learning_rate: float = 7e-4
    lr_schedule: str = "constant"
    momentum: float = 0.9
    vf_coef: float = 0.25
    ent_coef: float = 0.01
    gamma: float = 0.99
    kl_clip: float = 0.001
    damping: float = 0.01
    stat_decay: float = 0.95
    max_grad_norm: float = 0.5
    hidden: int = 64
    n_lstm: int = 64  # RecurrentACKTR's hidden size
    kfac_obs_samples: int = 32  # the samples of the conv factors and of G


@dataclasses.dataclass
class ACKTRState:
    params: Dict[str, torch.Tensor]
    momentum: Optional[Dict[str, torch.Tensor]]
    kfac_A: Optional[Dict[str, torch.Tensor]]  # per weight: input-row covariance
    kfac_G: Optional[Dict[str, torch.Tensor]]  # per weight: gradient covariance
    vstate: object
    obs: Optional[torch.Tensor]
    obs_norm: Optional[RunningNorm]
    update_idx: int = 0


@dataclasses.dataclass
class RecurrentACKTRState:
    """``ACKTRState`` with the episode-start mask ``done`` [N] of the next
    step and the carry ``lstm_state`` (h, c)."""

    params: Dict[str, torch.Tensor]
    momentum: Optional[Dict[str, torch.Tensor]]
    kfac_A: Optional[Dict[str, torch.Tensor]]
    kfac_G: Optional[Dict[str, torch.Tensor]]
    vstate: object
    obs: Optional[torch.Tensor]
    done: Optional[torch.Tensor]
    lstm_state: Optional[tuple]
    obs_norm: Optional[RunningNorm]
    update_idx: int = 0


def _orthogonal(shape, gain: float, gen: torch.Generator) -> torch.Tensor:
    return torch.nn.init.orthogonal_(torch.empty(shape), gain, generator=gen)


def _bf16_conv(x, w, b, stride: int):
    """The reference's conv: VALID, in bfloat16, then the bias added in
    bfloat16 (the pre-activation)."""
    return F.conv2d(x, w.to(x.dtype), stride=stride) + b.to(x.dtype)[:, None, None]


class ACKTR(BaseRLAgent):
    name = "acktr"
    config_class = ACKTRConfig

    def __init__(self, env=None, num_envs: int = 8, policy: str = "auto",
                 config: ACKTRConfig = None, normalize_obs: Optional[bool] = None,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.num_envs = num_envs
        self.config = config or ACKTRConfig()
        self.policy_kind = policy
        self.is_cnn = policy == "cnn"
        self.n_updates = 1  # the linear schedule's horizon, set by learn()
        if env is not None:
            self.vec_env = VecEnv(env, num_envs)
            self.n_act = env.action_space.n
            self.obs_shape = tuple(env.observation_space.shape)
            self.obs_dim = int(np.prod(self.obs_shape))
            self.is_cnn = policy == "cnn" or (policy == "auto" and len(self.obs_shape) == 3)
            if self.is_cnn:
                self._cnn_geometry(self.obs_shape)
            if normalize_obs is None:
                normalize_obs = env.srl_model != "raw_pixels" and not self.is_cnn
            self.normalize_obs = normalize_obs

    def _cnn_geometry(self, obs_shape):
        """The conv and pool output shapes: ``pool`` and ``cnn_flat_dim``."""
        h, w, c = obs_shape
        self.cnn_in_channels = c
        out = lambda d, k, s: (d - k) // s + 1
        h3 = out(out(out(h, 8, 4), 4, 2), 3, 1)
        w3 = out(out(out(w, 8, 4), 4, 2), 3, 1)
        self.pool = max(1, min(4, h3, w3))
        self.cnn_flat_dim = (h3 // self.pool) * (w3 // self.pool) * 64

    # ---- the explicit policy --------------------------------------------------
    def _torso_specs(self):
        if self.is_cnn:
            return [("C1", "cb1", "conv", {"k": 8, "s": 4}),
                    ("C2", "cb2", "conv", {"k": 4, "s": 2}),
                    ("C3", "cb3", "conv", {"k": 3, "s": 1}),
                    ("Wfc", "bfc", "dense", {})]
        return [("W1", "b1", "dense", {}), ("W2", "b2", "dense", {})]

    def _layer_specs(self):
        """(weight, bias, kind, conv geometry) of every K-FAC layer."""
        return self._torso_specs() + [("Wpi", "bpi", "dense", {}), ("Wv", "bv", "dense", {})]

    def _torso_init(self, gen) -> tuple:
        """The torso's parameters and its output width."""
        if self.is_cnn:
            c = self.cnn_in_channels
            return {"C1": _orthogonal((32, c, 8, 8), math.sqrt(2), gen), "cb1": torch.zeros(32),
                    "C2": _orthogonal((64, 32, 4, 4), math.sqrt(2), gen), "cb2": torch.zeros(64),
                    "C3": _orthogonal((64, 64, 3, 3), math.sqrt(2), gen), "cb3": torch.zeros(64),
                    "Wfc": _orthogonal((self.cnn_flat_dim, 512), math.sqrt(2), gen),
                    "bfc": torch.zeros(512)}, 512
        h, n_in, params = self.config.hidden, self.obs_dim, {}
        for wname, bname, _, _ in self._torso_specs():
            params[wname] = _orthogonal((n_in, h), math.sqrt(2), gen)
            params[bname] = torch.zeros(h)
            n_in = h
        return params, h

    def init_params(self, seed: int) -> Dict[str, torch.Tensor]:
        """Fresh parameters drawn from ``seed``: orthogonal kernels (gain
        sqrt 2, the heads 0.01 and 1), zero biases."""
        gen = torch.Generator().manual_seed(seed)
        params, latent = self._torso_init(gen)
        params.update({"Wpi": _orthogonal((latent, self.n_act), 0.01, gen),
                       "bpi": torch.zeros(self.n_act),
                       "Wv": _orthogonal((latent, 1), 1.0, gen), "bv": torch.zeros(1)})
        return {k: v.to(self.device) for k, v in params.items()}

    def _torso(self, params, x, acts=None, pre=None):
        """The torso's output; fills ``acts`` with each torso layer's input
        (the convs' over the first ``kfac_obs_samples`` samples, float32
        NCHW) and ``pre`` with each bias's pre-activation, when given."""
        n = x.shape[0]
        keep = acts is not None
        if not self.is_cnn:
            x = x.reshape(n, -1).to(torch.float32)
            for wname, bname, _, _ in self._torso_specs():  # tanh layers
                z = x @ params[wname] + params[bname]
                if keep:
                    acts[wname] = x.detach()
                if pre is not None:
                    pre[bname] = z
                x = torch.tanh(z)
            return x
        ns = self.config.kfac_obs_samples
        x = (x.to(torch.float32) / 255.0).permute(0, 3, 1, 2)
        xb = x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        z1 = _bf16_conv(xb, params["C1"], params["cb1"], 4)
        h1 = F.relu(z1)
        z2 = _bf16_conv(h1, params["C2"], params["cb2"], 2)
        h2 = F.relu(z2)
        z3 = _bf16_conv(h2, params["C3"], params["cb3"], 1)
        pooled = F.avg_pool2d(F.relu(z3).to(torch.float32), self.pool)
        flat = pooled.permute(0, 2, 3, 1).reshape(n, -1)
        zfc = flat @ params["Wfc"] + params["bfc"]
        if keep:
            acts.update(C1=x[:ns].detach().contiguous(), C2=h1[:ns].detach().float(),
                        C3=h2[:ns].detach().float(), Wfc=flat.detach())
        if pre is not None:
            pre.update(cb1=z1, cb2=z2, cb3=z3, bfc=zfc)
        return F.relu(zfc)

    def _heads(self, params, latent, acts=None, pre=None):
        logits = latent @ params["Wpi"] + params["bpi"]
        value = latent @ params["Wv"] + params["bv"]
        if acts is not None:
            acts.update(Wpi=latent.detach(), Wv=latent.detach())
        if pre is not None:
            pre.update(bpi=logits, bv=value)
        return logits, value[..., 0]

    def _forward(self, params, x, acts=None, pre=None):
        """(logits, value) of observations ``x``."""
        return self._heads(params, self._torso(params, x, acts, pre), acts, pre)

    def apply(self, params, obs):
        """(distribution, value), for acting and the rollout."""
        logits, value = self._forward(params, obs)
        return Categorical(logits), value

    # ---- the update ----------------------------------------------------------
    def _clipped_grads(self, params, loss):
        """The loss's gradients, scaled by ``min(1, max_grad_norm / (norm +
        1e-8))``."""
        names = list(params)
        grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
        with torch.no_grad():
            norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads.values()))
            clip = torch.clamp(self.config.max_grad_norm / (norm + 1e-8), max=1.0)
            return {k: g * clip for k, g in grads.items()}

    def _a2c_loss(self, logits, value, actions, advantages, returns):
        cfg = self.config
        logp_all = F.log_softmax(logits, -1)
        logp = torch.gather(logp_all, -1, actions.long()[..., None])[..., 0]
        pg = -torch.mean(advantages.detach() * logp)
        vf = torch.mean(torch.square(value - returns))
        ent = -torch.mean(torch.sum(torch.exp(logp_all) * logp_all, -1))
        return pg + cfg.vf_coef * vf - cfg.ent_coef * ent

    def loss_and_grads(self, params, data):
        """(loss, clipped gradients, K-FAC input rows per weight, the Fisher
        samples) of the batch ``data`` = (obs, actions, advantages, returns),
        flat [T*N, ...]."""
        obs, actions, advantages, returns = data
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        acts = {}
        with torch.enable_grad():
            logits, value = self._forward(leaves, obs, acts)
            loss = self._a2c_loss(logits, value, actions, advantages, returns)
            grads = self._clipped_grads(leaves, loss)
        return loss.detach(), grads, acts, obs[:self.config.kfac_obs_samples]

    def _fisher_forward(self, params, samples, pre):
        return self._forward(params, samples, pre=pre)

    def fisher_G(self, params, samples, gen: Optional[torch.Generator] = None, draws=None):
        """The true-Fisher G per bias name over ``samples``: with targets
        drawn from the model's own distributions (``draws`` = (actions [n],
        value noise [n]), else drawn from ``gen``), ``g.T @ g / n`` of the
        per-sample pre-activation gradients of ``-log p(a) + 0.5 (v -
        stop_gradient(v + e))^2``, all from one backward."""
        specs = self._layer_specs()
        pre = {}
        leaves = {k: v.detach().requires_grad_(k in {b for _, b, _, _ in specs})
                  for k, v in params.items()}
        with torch.enable_grad():
            logits, value = self._fisher_forward(leaves, samples, pre)
            if draws is None:
                draws = (Categorical(logits.detach()).sample(gen),
                         torch.randn(value.shape, generator=gen, device=value.device))
            actions, noise = draws
            logp = torch.gather(F.log_softmax(logits, -1), -1, actions.long()[:, None])[:, 0]
            vf = 0.5 * torch.square(value - (value + noise).detach())
            per_pre = torch.autograd.grad(torch.sum(-logp + vf), [pre[b] for _, b, _, _ in specs])
        fisher = {}
        for (_, bname, kind, _), g in zip(specs, per_pre):
            g = g.to(torch.float32)
            if kind == "conv":
                g = g.sum((2, 3))
            fisher[bname] = g.T @ g / g.shape[0]
        return fisher

    def _input_rows(self, wname, kind, geom, act):
        """A layer's K-FAC input rows: the activations, or a conv's patches."""
        if kind != "conv":
            return act
        patches = F.unfold(act, geom["k"], stride=geom["s"])  # [n, cin*k*k, L]
        return patches.transpose(1, 2).reshape(-1, patches.shape[1])

    @torch.no_grad()
    def update_factors(self, kfac_A, kfac_G, acts, fisher):
        """The factor EMAs: (A', G') per weight name."""
        decay = self.config.stat_decay
        new_A, new_G = {}, {}
        for wname, bname, kind, geom in self._layer_specs():
            a = self._input_rows(wname, kind, geom, acts[wname])
            a = torch.cat([a, torch.ones((a.shape[0], 1), dtype=a.dtype, device=a.device)], 1)
            new_A[wname] = decay * kfac_A[wname] + (1 - decay) * (a.T @ a / a.shape[0])
            new_G[wname] = decay * kfac_G[wname] + (1 - decay) * fisher[bname]
        return new_A, new_G

    @torch.no_grad()
    def precondition(self, grads, kfac_A, kfac_G, update_idx: int):
        """The natural gradient: per layer ``A^-1 dW G^-1`` of the
        bias-corrected, pi-damped factors; the other parameters (``ln_g``,
        ``ln_b``) keep their gradient."""
        cfg = self.config
        corr = 1.0 - torch.tensor(cfg.stat_decay, dtype=torch.float32) ** float(update_idx + 1)
        damp = math.sqrt(cfg.damping)
        precond = dict(grads)
        for wname, bname, kind, _ in self._layer_specs():
            A, G = kfac_A[wname] / corr, kfac_G[wname] / corr
            pi = torch.sqrt((torch.trace(A) / A.shape[0])
                            / (torch.trace(G) / G.shape[0] + 1e-8) + 1e-8)
            eye = lambda m: torch.eye(m.shape[0], dtype=m.dtype, device=m.device)
            a_inv = torch.linalg.inv(A + pi * damp * eye(A))
            g_inv = torch.linalg.inv(G + damp / pi * eye(G))
            dw = grads[wname]
            if kind == "conv":
                dw = dw.reshape(dw.shape[0], -1).T  # OIHW -> [(cin, kh, kw), cout]
            nat = a_inv @ torch.cat([dw, grads[bname][None, :]]) @ g_inv
            w = nat[:-1]
            precond[wname] = w.T.reshape(grads[wname].shape) if kind == "conv" else w
            precond[bname] = nat[-1]
        return precond

    def learning_rate(self, update_idx: int) -> float:
        """The lr of update ``update_idx`` (``linear``: annealed over
        ``n_updates``; any other schedule: constant)."""
        cfg = self.config
        if cfg.lr_schedule == "linear":
            return cfg.learning_rate * (1.0 - update_idx / self.n_updates)
        return cfg.learning_rate

    @torch.no_grad()
    def kfac_step(self, params, momentum, grads, precond, lr: float):
        """The trust-region step size ``eta`` and the momentum step:
        (params', momentum', eta)."""
        dot = sum(torch.sum(precond[k] * grads[k]) for k in grads)
        eta = torch.clamp(torch.sqrt(2 * self.config.kl_clip / (torch.abs(dot) + 1e-8)), max=lr)
        momentum = {k: self.config.momentum * m + precond[k] for k, m in momentum.items()}
        params = {k: p - eta * momentum[k] for k, p in params.items()}
        return params, momentum, eta

    def update(self, state, data, gen: Optional[torch.Generator] = None, fisher_draws=None):
        """One K-FAC update of ``state`` from the batch ``data`` (see
        ``loss_and_grads``): (params', momentum', A', G', metrics). The
        Fisher targets are ``fisher_draws`` when given, else drawn from
        ``gen``."""
        loss, grads, acts, samples = self.loss_and_grads(state.params, data)
        fisher = self.fisher_G(state.params, samples, gen, fisher_draws)
        kfac_A, kfac_G = self.update_factors(state.kfac_A, state.kfac_G, acts, fisher)
        precond = self.precondition(grads, kfac_A, kfac_G, state.update_idx)
        params, momentum, eta = self.kfac_step(state.params, state.momentum, grads, precond,
                                               self.learning_rate(state.update_idx))
        return params, momentum, kfac_A, kfac_G, {"loss": loss, "eta": eta}

    def rollout(self, state, gen: torch.Generator):
        """The segment of ``n_steps``: (the next state's env fields, the
        update's ``data``, the rollout batch)."""
        cfg = self.config
        policy = lambda obs: self.apply(state.params, obs)
        vstate, obs, obs_norm, last_norm_obs, batch = collect_rollout(
            self.vec_env, policy, state.vstate, state.obs, state.obs_norm, gen, cfg.n_steps)
        with torch.no_grad():
            _, last_value = policy(last_norm_obs)
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_value, cfg.gamma, 1.0)
        flat = lambda x: x.reshape((-1,) + x.shape[2:])
        data = (flat(batch.obs), flat(batch.actions), flat(advantages), flat(returns))
        return dict(vstate=vstate, obs=obs, obs_norm=obs_norm), data, batch

    def train_iteration(self, state, gen: torch.Generator):
        """One update: the segment, then K-FAC."""
        refuse_mesh(self, state)
        env_fields, data, batch = self.rollout(state, gen)
        params, momentum, kfac_A, kfac_G, metrics = self.update(state, data, gen)
        metrics["episode_return"] = batch.episode_return
        metrics["episode_length"] = batch.episode_length
        metrics["mean_reward_per_step"] = batch.rewards.mean()
        return type(state)(params=params, momentum=momentum, kfac_A=kfac_A, kfac_G=kfac_G,
                           update_idx=state.update_idx + 1, **env_fields), metrics

    # ---- state ----------------------------------------------------------------
    def _zero_factors(self, params):
        kfac_A, kfac_G = {}, {}
        for wname, _, kind, _ in self._layer_specs():
            w = params[wname]
            in_dim, out_dim = ((w[0].numel(), w.shape[0]) if kind == "conv"
                               else tuple(w.shape))
            kfac_A[wname] = torch.zeros((in_dim + 1, in_dim + 1), device=self.device)
            kfac_G[wname] = torch.zeros((out_dim, out_dim), device=self.device)
        return kfac_A, kfac_G

    def _fresh(self, gen: torch.Generator, seed: int) -> dict:
        """A fresh env batch, zero factors and momentum; fresh parameters
        and normalizer from ``seed``, or those of ``self.pretrained``."""
        vstate, obs = self.vec_env.reset(gen)
        if self.pretrained is not None:
            params = {k: v.detach().clone() for k, v in self.pretrained.params.items()}
            obs_norm = self.pretrained.obs_norm
        else:
            params, obs_norm = self.init_params(seed), None
        if obs_norm is None and self.normalize_obs:
            obs_norm = RunningNorm.create(self.obs_shape, self.device)
        kfac_A, kfac_G = self._zero_factors(params)
        return dict(params=params, momentum={k: torch.zeros_like(v) for k, v in params.items()},
                    kfac_A=kfac_A, kfac_G=kfac_G, vstate=vstate, obs=obs, obs_norm=obs_norm)

    def init_state(self, gen: torch.Generator, seed: int = 0) -> ACKTRState:
        return ACKTRState(**self._fresh(gen, seed))

    def learn(self, total_timesteps: int, seed: int = 0,
              callback: Optional[Callable] = None) -> ACKTRState:
        n_updates = max(1, total_timesteps // (self.config.n_steps * self.num_envs))
        self.n_updates = n_updates
        state = self.init_state(self._start(seed), seed)
        return self._run(state, n_updates, callback)

    # ---- pickles and checkpoints ---------------------------------------------------
    def _flax(self, tree):
        return bridge.acktr_params_to_reference(tree)

    def _state_dict(self, tree):
        return {k: v.to(self.device) for k, v in bridge.acktr_params_from_reference(tree).items()}

    def _numpy(self, tree):
        return {k: v.detach().cpu().numpy() for k, v in tree.items()}

    def _reference_fields(self, s) -> dict:
        return {"params": self._flax(s.params), "momentum": self._flax(s.momentum),
                "kfac_A": self._numpy(s.kfac_A), "kfac_G": self._numpy(s.kfac_G),
                "vstate": bridge.to_reference(s.vstate, self.seed),
                "obs": s.obs.detach().cpu().numpy(),
                "obs_norm": bridge.to_reference(s.obs_norm),
                "key": bridge.fresh_keys(self.seed, 1)[0],
                "update_idx": np.asarray(s.update_idx, np.int32)}

    def state_to_reference(self, s: ACKTRState) -> bridge.Record:
        return bridge.Record("srl_tpu.agents.acktr.ACKTRState", self._reference_fields(s))

    def loaded_state(self, params, obs_norm) -> ACKTRState:
        return ACKTRState(params=params, momentum=None, kfac_A=None, kfac_G=None,
                          vstate=None, obs=None, obs_norm=obs_norm)

    def policy_payload(self) -> dict:
        """The ``acktr`` (``acktr_lstm``) pickle: the base payload, the
        policy kind as the reference saves it and the CNN's geometry."""
        return {**super().policy_payload(), "policy_kind": self.saved_policy_kind(),
                "cnn_geom": ({"pool": self.pool, "flat": self.cnn_flat_dim,
                              "channels": self.cnn_in_channels} if self.is_cnn else None)}

    def saved_policy_kind(self) -> str:
        return "cnn" if self.is_cnn else "mlp"

    def restore_policy(self, payload: dict):
        """Without an env, the CNN's geometry comes from the pickle."""
        geom = payload.get("cnn_geom")
        if geom and not hasattr(self, "pool"):
            self.pool, self.cnn_flat_dim = geom["pool"], geom["flat"]
            self.cnn_in_channels = geom["channels"]
        super().restore_policy(payload)

    @classmethod
    def getOptParam(cls):
        return {
            "n_steps": (int, (1, 100)),
            "vf_coef": (float, (0, 1)),
            "ent_coef": (float, (0, 1)),
            "learning_rate": (float, (0, 1)),
            "gamma": (float, (0.5, 1)),
            "kl_clip": (float, (1e-4, 1e-2)),
        }


class RecurrentACKTR(RecurrentActing, ACKTR):
    pickle_name = "acktr_lstm"

    def __init__(self, env=None, num_envs: int = 8, policy: str = "lstm",
                 config: ACKTRConfig = None, normalize_obs: Optional[bool] = None,
                 device="cuda"):
        if "lstm" not in policy:
            raise AssertionError("RecurrentACKTR needs an lstm policy kind")
        super().__init__(env=env, num_envs=num_envs,
                         policy="cnn" if policy.startswith("cnn") else "mlp",
                         config=config, normalize_obs=normalize_obs, device=device)
        self.policy_kind = policy
        self.layer_norm = "lnlstm" in policy

    @property
    def n_lstm(self) -> int:
        return self.config.n_lstm

    def saved_policy_kind(self) -> str:
        return self.policy_kind

    def _torso_specs(self):
        if self.is_cnn:
            return super()._torso_specs()
        return [("W1", "b1", "dense", {})]

    def _layer_specs(self):
        return self._torso_specs() + [("Wl", "bl", "dense", {}), ("Wpi", "bpi", "dense", {}),
                                      ("Wv", "bv", "dense", {})]

    def init_params(self, seed: int) -> Dict[str, torch.Tensor]:
        """Fresh parameters drawn from ``seed``: the torso's, ``Wl``
        orthogonal with gain 1 over [e + n_lstm, 4 n_lstm], the heads', and
        the LayerNorm's ones and zeros."""
        gen = torch.Generator().manual_seed(seed)
        nl = self.config.n_lstm
        params, e_dim = self._torso_init(gen)
        params.update({"Wl": _orthogonal((e_dim + nl, 4 * nl), 1.0, gen),
                       "bl": torch.zeros(4 * nl),
                       "Wpi": _orthogonal((nl, self.n_act), 0.01, gen),
                       "bpi": torch.zeros(self.n_act),
                       "Wv": _orthogonal((nl, 1), 1.0, gen), "bv": torch.zeros(1)})
        if self.layer_norm:
            params.update(ln_g=torch.ones(nl), ln_b=torch.zeros(nl))
        return {k: v.to(self.device) for k, v in params.items()}

    def _cell(self, params, e, h_in, c_in, pre=None):
        """One step of the cell from the (masked) carry and the heads'
        input: (h', c', head input, [e, h_in]); fills ``pre`` with the
        gates' pre-activation."""
        z = torch.cat([e, h_in], -1)
        gates = z @ params["Wl"] + params["bl"]
        if pre is not None:
            pre["bl"] = gates
        i, f, g, o = gates.chunk(4, -1)
        c = torch.sigmoid(f + 1.0) * c_in + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out = h
        if self.layer_norm:
            mu = h.mean(-1, keepdim=True)
            var = torch.square(h - mu).mean(-1, keepdim=True)
            out = (h - mu) / torch.sqrt(var + 1e-5) * params["ln_g"] + params["ln_b"]
        return h, c, out, z

    def _policy_step(self, params, obs, carry, done):
        """(distribution, value, carry') of one step."""
        h, c, out, _ = self._cell(params, self._torso(params, obs), *mask_carry(carry, done))
        logits, value = self._heads(params, out)
        return Categorical(logits), value, (h, c)

    def _fisher_forward(self, params, samples, pre):
        x, h, c = samples
        e = self._torso(params, x, pre=pre)
        return self._heads(params, self._cell(params, e, h, c, pre)[2], pre=pre)

    def loss_and_grads(self, params, data):
        """As ``ACKTR.loss_and_grads`` over the segment ``data`` = (obs,
        done_in, carry0, actions, advantages, returns), each [T, N, ...] but
        ``carry0`` ((h, c), each [N, n_lstm]): the torso once over the T*N
        frames, the cell over T. The Fisher samples are the first
        ``kfac_obs_samples`` frames with the (h, c) their step started
        from."""
        obs, done_in, carry, actions, advantages, returns = data
        t, n = done_in.shape
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        acts = {}
        with torch.enable_grad():
            e = self._torso(leaves, obs.reshape((t * n,) + obs.shape[2:]), acts).reshape(t, n, -1)
            zs, outs, h_in, c_in = [], [], [], []
            for k in range(t):
                carry = mask_carry(carry, done_in[k])
                h_in.append(carry[0])
                c_in.append(carry[1])
                h, c, out, z = self._cell(leaves, e[k], *carry)
                carry = (h, c)
                zs.append(z)
                outs.append(out)
            out = torch.stack(outs)
            logits, value = self._heads(leaves, out)
            loss = self._a2c_loss(logits, value, actions, advantages, returns)
            grads = self._clipped_grads(leaves, loss)
        rows = out.detach().reshape(t * n, -1)
        acts.update(Wl=torch.cat(zs).detach(), Wpi=rows, Wv=rows)
        ns = self.config.kfac_obs_samples
        flat_obs = obs.reshape((t * n,) + obs.shape[2:])
        samples = (flat_obs[:ns], torch.cat(h_in)[:ns].detach(), torch.cat(c_in)[:ns].detach())
        return loss.detach(), grads, acts, samples

    def rollout(self, state: RecurrentACKTRState, gen: torch.Generator):
        cfg = self.config
        policy = lambda obs, carry, done: self._policy_step(state.params, obs, carry, done)
        vstate, obs, done, carry, obs_norm, last_norm_obs, batch = collect_recurrent_rollout(
            self.vec_env, policy, state.vstate, state.obs, state.done, state.lstm_state,
            state.obs_norm, gen, cfg.n_steps)
        with torch.no_grad():
            _, last_value, _ = policy(last_norm_obs, carry, done)
        advantages, returns = compute_gae(batch.rewards, batch.values, batch.dones,
                                          last_value, cfg.gamma, 1.0)
        data = (batch.obs, batch.done_in, batch.carry0, batch.actions, advantages, returns)
        return (dict(vstate=vstate, obs=obs, done=done, lstm_state=carry, obs_norm=obs_norm),
                data, batch)

    def init_state(self, gen: torch.Generator, seed: int = 0) -> RecurrentACKTRState:
        zeros = torch.zeros((self.num_envs, self.n_lstm), device=self.device)
        return RecurrentACKTRState(
            **self._fresh(gen, seed),
            done=torch.zeros(self.num_envs, dtype=torch.bool, device=self.device),
            lstm_state=(zeros, zeros.clone()))

    def state_to_reference(self, s: RecurrentACKTRState) -> bridge.Record:
        return bridge.Record("srl_tpu.agents.acktr.RecurrentACKTRState", {
            **self._reference_fields(s), "done": s.done.detach().cpu().numpy(),
            "lstm_state": tuple(x.detach().cpu().numpy() for x in s.lstm_state)})

    def loaded_state(self, params, obs_norm) -> RecurrentACKTRState:
        return RecurrentACKTRState(params=params, momentum=None, kfac_A=None, kfac_G=None,
                                   vstate=None, obs=None, done=None, lstm_state=None,
                                   obs_norm=obs_norm)
