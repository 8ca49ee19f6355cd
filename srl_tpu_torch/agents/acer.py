"""ACER, actor-critic with experience replay (counterpart of
srl_tpu/agents/acer.py): ``ACER`` and, with an lstm policy,
``RecurrentACER``. Discrete actions only, as the reference.

The reference's defaults (n_steps 20, 50 stored segments, replay ratio 4
from 4 stored segments on, q_coef 0.5, ent_coef 0.01, RMSProp lr 7e-4 with
decay 0.99 and eps 1e-5 after optax's global-norm clip at 10, gamma 0.99,
Retrace with importance weights truncated at c = 10, bias correction, and
the trust region against an average policy with alpha 0.99 and delta 1).

An iteration, in the reference's order:

1. a rollout of ``n_steps`` acting with the current parameters (the
   behaviour probabilities ``mus`` kept);
2. the segment of T + 1 observations stored in the segment buffer at its
   cursor (observations in the space's dtype: uint8 pixels, float32
   normalized states);
3. the on-policy update from that segment;
4. if the buffer then holds ``replay_start`` segments, ``replay_ratio``
   replay updates, each from a segment drawn uniformly from the stored ones
   (the one just added included), all against the average policy of the
   iteration's start;
5. the average policy's EMA ``alpha * avg + (1 - alpha) * params``.

An update is the reference's distribution-space split:
``acer_logit_grads`` gives the loss gradients with respect to the logits
and Q values of the segment (the policy loss to the logits only, the Q loss
to Q only, each reaching the other input only through a stopped gradient,
then the trust-region projection), and one backward pulls them back to the
parameters, the Q part scaled by ``q_coef`` (the reference's VJP).

The network is built without ``input_scale``, as the reference builds it:
on ``--coarse-obs`` the Nature CNN runs on the 112x112 image itself.

``RecurrentACER`` runs Flax's LSTM cell (``models/recurrent``: carry (c, h))
between the torso and the ``pi``/``q`` heads. Its segment buffer also keeps
the segment's initial carry and the done-before-step masks ``dones_in``
[T + 1, N] that zero the carry; every update re-runs the cell over the
segment from that carry with the current parameters (backpropagation
through time), the torso once over the (T + 1) * N frames and only the cell
looped. The carry persists across iterations.

Randomness is split from its use, as the envs split it: ``train_iteration``
takes the rollout's Gumbel noise (``jax.random.categorical`` is the argmax
of logits plus Gumbel noise) and the replays' segment indices, so a test
gives the ones the reference drew from its keys. ``size`` and ``cursor`` of
the buffer are host ints: deciding on the replays waits for nothing.

On a dp x tp mesh (a state from ``parallel.shard_ppo_state``) a rank steps
its env rows and keeps their rows of every stored segment (the store's env
axis: half the store a rank on dp2); the Gumbel noise is drawn for the
whole batch, the replay indices once for the world (every rank's store
holds as many segments, so the replays start on the same iteration); the
Retrace terms and the distribution-space gradients are the rank's rows, the
losses its shares of the global means, and each update's gradient is
summed over the dp group; RMSProp and the average policy's EMA step the
rank's tp shards.

``learn`` takes no ``initial_state``: the reference's does not, so
``--resume`` is refused for these agents. The checkpoint holds the whole
state, the segment buffer too (at the Kuka pixel run's width, 50 x 21 x
256 frames of 112x112x3: about 10 GB).
"""
from __future__ import annotations

import dataclasses
import types
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from srl_tpu_torch import bridge
from srl_tpu_torch.agents.a2c import RMS_STATE
from srl_tpu_torch.agents.base import (BaseRLAgent, RecurrentActing, episode_metrics,
                                       global_mean, reduce_losses)
from srl_tpu_torch.agents.buffers import DeviceStore, torch_dtype
from srl_tpu_torch.agents.ppo import EMPTY_STATE, clip_by_global_norm_
from srl_tpu_torch.bridge import Record
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.core.optim import rmsprop_init, rmsprop_update_
from srl_tpu_torch.models.distributions import Categorical
from srl_tpu_torch.models.policies import _linear, make_torso, torso_kind
from srl_tpu_torch.models.recurrent import N_LSTM, LstmCore


@dataclasses.dataclass
class ACERConfig:
    n_steps: int = 20
    buffer_segments: int = 50  # ~5000/(n_steps*envs) transition parity
    replay_ratio: int = 4
    replay_start: int = 4  # segments before off-policy updates begin
    q_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 10.0
    learning_rate: float = 7e-4
    rprop_alpha: float = 0.99
    rprop_epsilon: float = 1e-5
    gamma: float = 0.99
    correction_term: float = 10.0  # importance weight truncation c
    trust_region: bool = True
    alpha: float = 0.99  # average policy EMA
    delta: float = 1.0  # trust region radius


class ACERNet(nn.Module):
    """The torso, then the policy logits ``pi`` (orthogonal 0.01) and the Q
    values ``q`` (orthogonal 1.0) per action."""

    def __init__(self, obs_shape, n_actions: int, torso: str = "mlp"):
        super().__init__()
        self.torso_kind = torso
        self.torso = make_torso(obs_shape, torso)
        self.pi = _linear(self.torso.out_dim, n_actions, gain=0.01)
        self.q = _linear(self.torso.out_dim, n_actions, gain=1.0)

    def forward(self, obs):
        h = self.torso(obs)
        return self.pi(h), self.q(h)


class LstmACERNet(LstmCore):
    """``models/recurrent.LstmCore`` (the torso, Flax's LSTM cell, an
    optional LayerNorm), then ``pi`` and ``q``. ``forward(obs, carry,
    done)`` takes one step for ``done`` [B] and a segment for ``done`` [T,
    B]; ``done`` zeroes the carry before the step."""

    def __init__(self, obs_shape, n_actions: int, torso: str = "mlp", n_lstm: int = N_LSTM,
                 layer_norm: bool = False):
        super().__init__(obs_shape, torso, n_lstm, layer_norm)
        self.pi = _linear(n_lstm, n_actions, gain=0.01)
        self.q = _linear(n_lstm, n_actions, gain=1.0)

    def forward(self, obs, carry, done):
        """(logits, q, carry')."""
        h, carry = self.hidden(obs, carry, done)
        h = self._norm(h)
        return self.pi(h), self.q(h), carry


# ---------------------------------------------------------------------------
# Segment buffers
# ---------------------------------------------------------------------------
class _SegmentStore(DeviceStore):
    """Whole segments, one a row, written at the host cursor."""

    def add(self, **segment) -> "_SegmentStore":
        """Store one segment (a value per tensor field) at the cursor, in
        place; returns the buffer."""
        for name in self.tensor_names():
            getattr(self, name)[self.cursor].copy_(segment[name])
        self.cursor = (self.cursor + 1) % self.capacity
        self.size = min(self.size + 1, self.capacity)
        return self

    def segment(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The stored segment at the one-element index tensor ``idx`` (read
        without a host sync)."""
        return {name: getattr(self, name).index_select(0, idx)[0]
                for name in self.tensor_names()}

    # The env axis of each field: [C, T(+1), N, ...], the carries [C, N, H].
    ENV_AXIS = {"lstm_c": 1, "lstm_h": 1}

    def env_rows(self, lo: int, hi: int) -> "_SegmentStore":
        """A store of env rows ``[lo, hi)`` of every stored segment (copied:
        the whole store can then be freed), the cursor and size kept."""
        return dataclasses.replace(self, **{
            name: getattr(self, name).narrow(self.ENV_AXIS.get(name, 2), lo, hi - lo)
            .contiguous() for name in self.tensor_names()})


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=torch_dtype(dtype), device=device)


@dataclasses.dataclass
class SegmentBuffer(_SegmentStore):
    obs: torch.Tensor  # [C, T+1, N, ...]
    actions: torch.Tensor  # [C, T, N] int32
    rewards: torch.Tensor  # [C, T, N]
    dones: torch.Tensor  # [C, T, N]
    mus: torch.Tensor  # [C, T, N, A] behaviour probabilities
    cursor: int = 0
    size: int = 0

    ref_name = "srl_tpu.agents.acer.SegmentBuffer"

    @classmethod
    def create(cls, capacity, n_steps, num_envs, obs_shape, obs_dtype, n_act, device="cpu"):
        c, t, n = capacity, n_steps, num_envs
        return cls(obs=_zeros((c, t + 1, n) + tuple(obs_shape), obs_dtype, device),
                   actions=_zeros((c, t, n), np.int32, device),
                   rewards=_zeros((c, t, n), np.float32, device),
                   dones=_zeros((c, t, n), np.bool_, device),
                   mus=_zeros((c, t, n, n_act), np.float32, device))


@dataclasses.dataclass
class RecurrentSegmentBuffer(_SegmentStore):
    """``SegmentBuffer`` plus what a replay through time needs: the
    done-before-step masks and the segment's initial carry (c, h)."""

    obs: torch.Tensor  # [C, T+1, N, ...]
    actions: torch.Tensor  # [C, T, N]
    rewards: torch.Tensor  # [C, T, N]
    dones: torch.Tensor  # [C, T, N] done after each step (Retrace)
    dones_in: torch.Tensor  # [C, T+1, N] done before each evaluation (the carry)
    mus: torch.Tensor  # [C, T, N, A]
    lstm_c: torch.Tensor  # [C, N, H]
    lstm_h: torch.Tensor  # [C, N, H]
    cursor: int = 0
    size: int = 0

    ref_name = "srl_tpu.agents.acer.RecurrentSegmentBuffer"

    @classmethod
    def create(cls, capacity, n_steps, num_envs, obs_shape, obs_dtype, n_act, n_lstm,
               device="cpu"):
        c, t, n = capacity, n_steps, num_envs
        return cls(obs=_zeros((c, t + 1, n) + tuple(obs_shape), obs_dtype, device),
                   actions=_zeros((c, t, n), np.int32, device),
                   rewards=_zeros((c, t, n), np.float32, device),
                   dones=_zeros((c, t, n), np.bool_, device),
                   dones_in=_zeros((c, t + 1, n), np.bool_, device),
                   mus=_zeros((c, t, n, n_act), np.float32, device),
                   lstm_c=_zeros((c, n, n_lstm), np.float32, device),
                   lstm_h=_zeros((c, n, n_lstm), np.float32, device))


@dataclasses.dataclass
class ACERState:
    params: Dict[str, torch.Tensor]
    avg_params: Dict[str, torch.Tensor]
    opt_state: Optional[dict]  # RMSProp: {"count", "nu"}
    buffer: Optional[SegmentBuffer]
    vstate: object
    obs: Optional[torch.Tensor]
    obs_norm: Optional[RunningNorm]
    update_idx: int = 0
    # The mesh the state is laid out on (``parallel.shard_ppo_state``: the
    # rank's env rows, the segment store's too), else None.
    mesh: Optional[object] = None


@dataclasses.dataclass
class RecurrentACERState:
    """``ACERState`` with the episode-start mask ``done`` [N] of the next
    step and the carry ``lstm_state`` (c, h)."""

    params: Dict[str, torch.Tensor]
    avg_params: Dict[str, torch.Tensor]
    opt_state: Optional[dict]
    buffer: Optional[RecurrentSegmentBuffer]
    vstate: object
    obs: Optional[torch.Tensor]
    done: Optional[torch.Tensor]
    lstm_state: Optional[tuple]
    obs_norm: Optional[RunningNorm]
    update_idx: int = 0
    mesh: Optional[object] = None


# ---------------------------------------------------------------------------
# The loss in distribution space
# ---------------------------------------------------------------------------
def _take(x, actions):
    return torch.gather(x, -1, actions.long()[..., None])[..., 0]


def acer_logit_grads(logits, q, avg_logits, actions, rewards, dones, mus,
                     config: ACERConfig, losses: Optional[dict] = None, mean=torch.mean):
    """ACER's gradients with respect to ``logits`` and ``q`` [T+1, N, A] of
    one segment (``actions``, ``rewards``, ``dones`` [T, N], ``mus`` [T, N,
    A]; ``avg_logits`` the average policy's): the Retrace targets
    (``rho_bar = min(rho, 1)``, the bootstrap ``v[T] * (1 - dones[T-1])``),
    the truncated policy gain (``min(c, rho)``), the bias correction over
    all actions (``max(0, 1 - c / (rho_all + 1e-6))``), the entropy bonus,
    and, with ``trust_region``, the projection of the policy gradient
    against ``softmax(avg_logits)``. The policy loss reaches ``logits`` and
    the Q loss ``q`` only; each reaches the other input only through a
    stopped gradient. Returns (g_logits, g_q), the bootstrap row T of
    ``g_logits`` zero; ``losses``, when a dict, receives the detached loss
    terms. ``mean`` takes the means over [T, N]: on a mesh, a rank's share
    of the global mean (``base.global_mean``)."""
    cfg = config
    T = actions.shape[0]
    lg = logits.detach().requires_grad_(True)
    qv = q.detach().requires_grad_(True)
    with torch.enable_grad():
        f_all = F.softmax(lg, -1)
        f = f_all[:T]
        q_t = qv[:T]
        v = torch.sum(f_all * qv, -1)  # [T+1, N]
        f_a = _take(f, actions)
        q_a = _take(q_t, actions)
        with torch.no_grad():
            mu_a = _take(mus, actions)
            rho = f_a / (mu_a + 1e-6)
            rho_all = f / (mus + 1e-6)
            rho_bar = torch.clamp_max(rho, 1.0)
            # Retrace, backward over the segment.
            not_done = 1.0 - dones.to(torch.float32)
            q_rets = [None] * T
            q_ret = v[T] * not_done[T - 1]
            for t in reversed(range(T)):
                q_ret = rewards[t] + cfg.gamma * q_ret * not_done[t]
                q_rets[t] = q_ret
                q_ret = rho_bar[t] * (q_ret - q_a[t]) + v[t]
            q_ret = torch.stack(q_rets)  # [T, N]
            adv = q_ret - v[:T]
            gain_weight = adv * torch.clamp_max(rho, cfg.correction_term)
            adv_bc = q_t - v[:T, :, None]
            bc_weight = adv_bc * f * torch.clamp_min(
                1.0 - cfg.correction_term / (rho_all + 1e-6), 0.0)
        gain_f = torch.log(f_a + 1e-6) * gain_weight
        gain_bc = torch.sum(torch.log(f + 1e-6) * bc_weight, -1)
        loss_policy = -mean(gain_f + gain_bc)
        entropy = -mean(torch.sum(f * torch.log(f + 1e-6), -1))
        loss_q = 0.5 * mean(torch.square(q_ret - q_a))
        (g_logits,) = torch.autograd.grad(loss_policy - cfg.ent_coef * entropy, lg)
        (g_q,) = torch.autograd.grad(loss_q, qv)
    if losses is not None:
        losses.update(loss_policy=loss_policy.detach(), loss_q=loss_q.detach(),
                      entropy=entropy.detach())
    if cfg.trust_region:
        # k = the gradient of KL(avg || pi) with respect to the logits.
        k = F.softmax(logits, -1) - F.softmax(avg_logits, -1)
        g = -g_logits  # the ascent direction of the gain
        kg = torch.sum(k * g, -1, keepdim=True)
        k2 = torch.sum(k * k, -1, keepdim=True)
        adj = torch.clamp_min((kg - cfg.delta) / (k2 + 1e-6), 0.0)
        g_logits = -(g - adj * k)
    return g_logits, g_q


# ---------------------------------------------------------------------------
# The agents
# ---------------------------------------------------------------------------
class ACER(BaseRLAgent):
    name = "acer"
    config_class = ACERConfig

    def __init__(self, env=None, num_envs: int = 8, policy: str = "auto",
                 config: ACERConfig = None, normalize_obs: Optional[bool] = None,
                 device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.env = env
        self.num_envs = num_envs
        self.config = config or ACERConfig()
        self.policy_kind = policy
        if env is not None:
            self.n_act = env.action_space.n
            self._setup(normalize_obs)

    def _make_policy(self) -> nn.Module:
        return ACERNet(self.obs_shape, self.n_act, torso_kind(self.policy_kind, self.obs_shape))

    def opt_init(self, params):
        return rmsprop_init(params)

    # ---- the network --------------------------------------------------------
    def net(self, params, obs):
        """(logits, q) of observations [B, ...]."""
        return functional_call(self.policy, params, (obs,))

    def apply(self, params, obs):
        """(distribution, q), for acting."""
        logits, q = self.net(params, obs)
        return Categorical(logits), q

    def _act_logits(self, params, obs, carry, done):
        """The rollout's logits of one step, and the carry after it."""
        return self.net(params, obs)[0], None

    def segment_outputs(self, params, seg: dict):
        """(logits, q) [T+1, N, A] of a segment's observations."""
        obs = seg["obs"]
        t1, n = obs.shape[:2]
        logits, q = self.net(params, obs.reshape((t1 * n,) + obs.shape[2:]))
        return logits.reshape(t1, n, -1), q.reshape(t1, n, -1)

    # ---- an update -----------------------------------------------------------
    def segment_grads(self, params, avg_params, seg: dict, losses: Optional[dict] = None,
                      mesh=None) -> Dict[str, torch.Tensor]:
        """The ACER gradient of one segment with respect to ``params`` (whole
        parameters): one forward with grad, the average policy's logits
        without, the distribution-space gradients, one backward (the Q part
        times ``q_coef``). With ``mesh``, ``seg`` holds the rank's env rows
        and the gradient is the rank's share of the global one."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        logits, q = self.segment_outputs(leaves, seg)
        with torch.no_grad():
            avg_logits, _ = self.segment_outputs(avg_params, seg)
        g_logits, g_q = acer_logit_grads(logits.detach(), q.detach(), avg_logits,
                                         seg["actions"], seg["rewards"], seg["dones"],
                                         seg["mus"], self.config, losses,
                                         torch.mean if mesh is None else global_mean(mesh))
        grads = torch.autograd.grad((logits, q), list(leaves.values()),
                                    (g_logits, g_q * self.config.q_coef))
        return dict(zip(leaves, grads))

    def optimizer_step_(self, params, grads, opt_state, mesh=None):
        """optax's global-norm clip, then RMSProp, in place on ``params`` and
        ``opt_state``; ``grads`` is consumed. On a tp mesh all three hold the
        rank's shards."""
        cfg = self.config
        clip_by_global_norm_(grads, cfg.max_grad_norm, mesh, self.sharded_names(mesh))
        rmsprop_update_(params, grads, opt_state, cfg.learning_rate, cfg.rprop_alpha,
                        cfg.rprop_epsilon)

    def update_(self, params, opt_state, avg_params, seg: dict, losses=None, mesh=None):
        """One ACER update from one segment, in place on ``params`` and
        ``opt_state`` (on a mesh: the rank's shards, the gradient summed over
        the dp group); ``avg_params`` is whole."""
        grads = self.segment_grads(self.whole_params(params, mesh), avg_params, seg, losses,
                                   mesh)
        self.optimizer_step_(params, self.reduce_grads(grads, mesh), opt_state, mesh)

    # ---- an iteration -------------------------------------------------------
    @torch.no_grad()
    def rollout(self, state, gen: torch.Generator, gumbel=None):
        """``n_steps`` acting with ``state.params``: each action the argmax of
        the logits plus Gumbel noise, drawn from ``gen`` unless ``gumbel``
        [n_steps, N, A] gives it. Returns (vstate', obs', obs_norm', done',
        carry', the segment as the buffer stores it, episode returns and
        lengths [T, N]); done' and carry' are None for the feed-forward
        agent. On the state's mesh the draws (and ``gumbel``) are the whole
        batch's, of which the rank keeps its rows."""
        vstate, obs, obs_norm, mesh = state.vstate, state.obs, state.obs_norm, state.mesh
        done, carry = getattr(state, "done", None), getattr(state, "lstm_state", None)
        n = self.num_envs
        lo, hi = (0, n) if mesh is None else mesh.env_slice(n)
        rows = None if mesh is None else (lo, n)
        params = self.whole_params(state.params, mesh)
        carry0 = carry
        steps = []
        for t in range(self.config.n_steps):
            if obs_norm is not None:
                obs_norm = obs_norm.update(obs, mesh)
                norm_obs = obs_norm.normalize(obs)
            else:
                norm_obs = obs
            logits, carry = self._act_logits(params, norm_obs, carry, done)
            dist = Categorical(logits)
            action = (dist.sample(gen, rows) if gumbel is None else torch.argmax(
                logits + torch.as_tensor(gumbel[t][lo:hi]).to(logits), -1))
            vstate, tr = self.vec_env.step(vstate, action, gen, mesh=mesh)
            steps.append((norm_obs, done, action.to(torch.int32), tr.reward, tr.done,
                          dist.probs(), tr.episode_return, tr.episode_length))
            obs, done = tr.obs, tr.done
        cols = list(zip(*steps))
        stack = lambda xs: torch.stack(list(xs))
        last = obs_norm.normalize(obs) if obs_norm is not None else obs
        seg = {"obs": stack(cols[0] + (last,)), "actions": stack(cols[2]),
               "rewards": stack(cols[3]), "dones": stack(cols[4]), "mus": stack(cols[5])}
        if carry0 is None:
            done = None
        else:
            seg.update(dones_in=stack(cols[1] + (done,)), lstm_c=carry0[0], lstm_h=carry0[1])
        return vstate, obs, obs_norm, done, carry, seg, stack(cols[6]), stack(cols[7])

    def train_iteration(self, state, gen: torch.Generator, gumbel=None, replay_idx=None):
        """One iteration (module docstring). ``gumbel`` [n_steps, N, A] and
        ``replay_idx`` [replay_ratio], when given, replace the draws from
        ``gen``. The buffer is updated in place; the parameters and
        optimizer state are new.

        On the state's mesh (``parallel.shard_ppo_state``) the rank steps,
        stores and updates from its env rows: each update's loss terms are
        its shares of the global means, the gradient is summed over the dp
        group and RMSProp and the average policy's EMA step the rank's tp
        shards. Every rank adds one segment an iteration, so the store's
        host-int size, the replay decision and the replay indices (drawn from
        the generator all ranks seed alike) agree on every rank."""
        cfg = self.config
        mesh = state.mesh
        vstate, obs, obs_norm, done, carry, seg, ep_ret, ep_len = self.rollout(
            state, gen, gumbel)
        buffer = state.buffer.add(**seg)
        params = {k: v.detach().clone() for k, v in state.params.items()}
        opt_state = {"count": state.opt_state["count"],
                     "nu": {k: v.clone() for k, v in state.opt_state["nu"].items()}}
        # Every update of the iteration is against its start's average policy.
        avg_whole = self.whole_params(state.avg_params, mesh)
        losses = {}
        self.update_(params, opt_state, avg_whole, seg, losses, mesh)
        replays = 0
        if buffer.size >= cfg.replay_start:
            if replay_idx is None:
                replay_idx = torch.randint(0, max(buffer.size, 1), (cfg.replay_ratio,),
                                           generator=gen, device=gen.device)
            replay_idx = torch.as_tensor(replay_idx, device=self.device).long()
            for i in range(cfg.replay_ratio):
                self.update_(params, opt_state, avg_whole,
                             buffer.segment(replay_idx[i:i + 1]), mesh=mesh)
            replays = cfg.replay_ratio
        with torch.no_grad():
            avg_params = {k: cfg.alpha * a + (1 - cfg.alpha) * params[k]
                          for k, a in state.avg_params.items()}
        episodes = types.SimpleNamespace(episode_return=ep_ret, episode_length=ep_len,
                                         rewards=seg["rewards"])
        metrics = {**reduce_losses(losses, mesh), "replays": torch.tensor(float(replays)),
                   **episode_metrics(episodes, mesh)}
        fields = dict(params=params, avg_params=avg_params, opt_state=opt_state, buffer=buffer,
                      vstate=vstate, obs=obs, obs_norm=obs_norm,
                      update_idx=state.update_idx + 1, mesh=mesh)
        if done is not None:
            fields.update(done=done, lstm_state=carry)
        return type(state)(**fields), metrics

    def _new_buffer(self):
        cfg = self.config
        return SegmentBuffer.create(cfg.buffer_segments, cfg.n_steps, self.num_envs,
                                    self.obs_shape, self.env.observation_space.dtype,
                                    self.n_act, self.device)

    def init_state(self, gen: torch.Generator, seed: int = 0) -> ACERState:
        """A fresh env batch, optimizer and segment buffer; the parameters
        and normalizer from ``seed`` or of ``self.pretrained``; the average
        policy a copy of the parameters."""
        s = BaseRLAgent.init_state(self, gen, seed)
        return ACERState(params=s.params,
                         avg_params={k: v.clone() for k, v in s.params.items()},
                         opt_state=s.opt_state, buffer=self._new_buffer(), vstate=s.vstate,
                         obs=s.obs, obs_norm=s.obs_norm)

    def learn(self, total_timesteps: int, seed: int = 0,
              callback=None) -> ACERState:
        """``total_timesteps // (n_steps * num_envs)`` iterations (at least
        one)."""
        n_updates = max(1, total_timesteps // (self.config.n_steps * self.num_envs))
        state = self.init_state(self._start(seed), seed)
        return self._run(state, n_updates, callback)

    # ---- checkpoints and the policy pickle --------------------------------
    def opt_state_to_reference(self, opt_state):
        empty = Record(EMPTY_STATE, args=())
        return (empty, (Record(RMS_STATE, args=(self._flax(opt_state["nu"]),)), empty, empty))

    def state_to_reference(self, s) -> Record:
        """The training state as the reference's ``ACERState``: the segment
        buffer too."""
        return Record("srl_tpu.agents.acer.ACERState", self._common_reference_fields(s))

    def _common_reference_fields(self, s) -> dict:
        s = self.whole_state(s)
        return {
            "params": self._flax(s.params),
            "avg_params": self._flax(s.avg_params),
            "opt_state": self.opt_state_to_reference(s.opt_state),
            "buffer": s.buffer.to_reference(),
            "vstate": bridge.to_reference(s.vstate, self.seed),
            "obs": s.obs.detach().cpu().numpy(),
            "obs_norm": bridge.to_reference(s.obs_norm),
            "key": bridge.fresh_keys(self.seed, 1)[0],
            "update_idx": np.asarray(s.update_idx, np.int32),
        }

    def loaded_state(self, params, obs_norm) -> ACERState:
        return ACERState(params=params, avg_params=params, opt_state=None, buffer=None,
                         vstate=None, obs=None, obs_norm=obs_norm)

    # ---- the reference's surface -------------------------------------------
    @classmethod
    def getOptParam(cls):
        return {
            "n_steps": (int, (1, 100)),
            "q_coef": (float, (0, 1)),
            "ent_coef": (float, (0, 1)),
            "learning_rate": (float, (0, 0.1)),
            "gamma": (float, (0.5, 1)),
            "replay_ratio": (int, (0, 10)),
            "correction_term": (float, (1, 10)),
            "delta": (float, (0.1, 10)),
        }


class RecurrentACER(RecurrentActing, ACER):
    """ACER with an lstm/lnlstm/cnnlstm/cnnlnlstm policy."""

    pickle_name = "acer_lstm"

    def __init__(self, env=None, num_envs: int = 8, policy: str = "lstm",
                 config: ACERConfig = None, normalize_obs: Optional[bool] = None,
                 device="cuda"):
        super().__init__(env=env, num_envs=num_envs, policy=policy, config=config,
                         normalize_obs=normalize_obs, device=device)

    @property
    def n_lstm(self) -> int:
        return self.policy.n_lstm

    def _make_policy(self) -> LstmACERNet:
        return LstmACERNet(self.obs_shape, self.n_act,
                           "cnn" if self.policy_kind.startswith("cnn") else "mlp",
                           layer_norm="lnlstm" in self.policy_kind)

    def net(self, params, obs, carry, done):
        """(logits, q, carry') of one step (``done`` [B]) or a [T, B]
        segment."""
        return functional_call(self.policy, params, (obs, carry, done))

    def _policy_step(self, params, obs, carry, done):
        logits, q, carry = self.net(params, obs, carry, done)
        return Categorical(logits), q, carry

    def _act_logits(self, params, obs, carry, done):
        logits, _, carry = self.net(params, obs, carry, done)
        return logits, carry

    def segment_outputs(self, params, seg: dict):
        logits, q, _ = self.net(params, seg["obs"], (seg["lstm_c"], seg["lstm_h"]),
                                seg["dones_in"])
        return logits, q

    def _flax(self, tree):
        return bridge.recurrent_state_dict_to_flax(tree)

    def _state_dict(self, tree):
        return {k: v.to(self.device) for k, v in
                bridge.recurrent_flax_to_state_dict(tree).items()}

    def _new_buffer(self):
        cfg = self.config
        return RecurrentSegmentBuffer.create(
            cfg.buffer_segments, cfg.n_steps, self.num_envs, self.obs_shape,
            self.env.observation_space.dtype, self.n_act, self.n_lstm, self.device)

    def init_state(self, gen: torch.Generator, seed: int = 0) -> RecurrentACERState:
        s = ACER.init_state(self, gen, seed)
        return RecurrentACERState(
            params=s.params, avg_params=s.avg_params, opt_state=s.opt_state, buffer=s.buffer,
            vstate=s.vstate, obs=s.obs,
            done=torch.zeros(self.num_envs, dtype=torch.bool, device=self.device),
            lstm_state=self.policy.initial_state(self.num_envs, self.device),
            obs_norm=s.obs_norm)

    def state_to_reference(self, s) -> Record:
        return Record("srl_tpu.agents.acer.RecurrentACERState", {
            **self._common_reference_fields(s),
            "done": s.done.detach().cpu().numpy(),
            "lstm_state": tuple(x.detach().cpu().numpy() for x in s.lstm_state)})

    def loaded_state(self, params, obs_norm) -> RecurrentACERState:
        return RecurrentACERState(params=params, avg_params=params, opt_state=None,
                                  buffer=None, vstate=None, obs=None, done=None,
                                  lstm_state=None, obs_norm=obs_norm)
