"""Base RL agent (counterpart of srl_tpu/agents/base.py): the CLI surface
(``customArguments``, ``getOptParam``, ``parserHyperParam``), acting
(``getAction``, ``getActionProba``), the policy pickle every agent writes and
reads, and full training-state checkpoints.

Checkpoints (``save_checkpoint`` / ``load_checkpoint``) have the reference's
format: ``{"state": PPOState, "meta": {...}}`` with the reference's class
names (``bridge.write_reference_pickle``), so each package resumes the
other's. The port adds ``"torch_generator"``, its generator's state and
device type, which the reference ignores.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch.func import functional_call

from srl_tpu_torch import bridge
from srl_tpu_torch.core.env import VecEnv, VecEnvState
from srl_tpu_torch.core.normalize import RunningNorm
from srl_tpu_torch.core.spaces import Discrete
from srl_tpu_torch.models.policies import ActorCritic, make_policy
from srl_tpu_torch.parallel.mesh import gather_params, shard_params, tp_sharded
from srl_tpu_torch.utils import trace


def as_tensor_on(x, device) -> torch.Tensor:
    """``x`` (a tensor on any device, or anything numpy reads) as a tensor
    on ``device``: observations that are on the card stay there."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.as_tensor(np.asarray(x), device=device)


@dataclasses.dataclass
class PPOState:
    """The training state of the actor-critic agents (PPO2, PPO1, A2C,
    TRPO)."""

    params: Dict[str, torch.Tensor]
    # Optimizer state: {"count": steps taken, "mu"/"nu": {...}} per agent.
    opt_state: Optional[dict]
    vstate: Optional[VecEnvState]
    obs: Optional[torch.Tensor]
    obs_norm: Optional[RunningNorm]
    update_idx: int = 0
    # The dp x tp mesh the state is laid out on (``parallel.shard_ppo_state``),
    # else None. With tp > 1, ``params`` and the optimizer's moments hold the
    # rank's shards (``BaseRLAgent.whole_state``).
    mesh: Optional[object] = None


def refuse_mesh(agent, state) -> None:
    """Refuse a meshed state to an agent whose state the reference's
    ``shard_ppo_state`` cannot lay out (ACKTR, DQN, SAC, DDPG, ...)."""
    if getattr(state, "mesh", None) is not None:
        raise ValueError(f"{type(agent).__name__} does not train on a mesh: the reference's "
                         f"shard_ppo_state cannot lay out its state")


def global_mean(mesh) -> Callable:
    """A rank's share of the mean over the dp group of tensors that hold
    the same number of entries on every rank: its sum over the global
    count. The shares of the ranks sum to the global mean. On one dp rank
    (a tp group alone) the mean itself, rounded as one process rounds it."""
    if mesh.dp == 1:
        return torch.mean
    return lambda x: x.sum() / (x.numel() * mesh.dp)


def episode_metrics(batch, mesh=None) -> dict:
    """The episode statistics [T, N] of a rollout and its mean reward per
    step: on a mesh, gathered over the dp group along the env axis and
    averaged over it."""
    if mesh is None:
        return {"episode_return": batch.episode_return,
                "episode_length": batch.episode_length,
                "mean_reward_per_step": batch.rewards.mean()}
    return {"episode_return": mesh.all_gather(batch.episode_return, 1),
            "episode_length": mesh.all_gather(batch.episode_length, 1),
            "mean_reward_per_step": mesh.mean(batch.rewards)}


def reduce_losses(losses: dict, mesh) -> dict:
    """The ranks' shares of the loss terms (``global_mean``) summed over the
    dp group: the global terms (one all-reduce)."""
    if mesh is None:
        return losses
    return dict(zip(losses, mesh.all_reduce_(torch.stack(list(losses.values())))))


class BaseRLAgent:
    """Common interface of the agents. A subclass sets ``config_class`` and
    ``opt_init``, and calls ``_setup`` once it has its env; its
    ``train_iteration(state, gen)`` returns (state', metrics)."""

    name = "base"
    pickle_name = None  # the policy pickle's "name" where it is not ``name``
    LOG_INTERVAL = 10
    SAVE_INTERVAL = 1
    config_class = None
    # A dict where the first gradient each site hands on is kept (flat,
    # float32, on the host): ``"grads"`` (the optimizer's, after the dp
    # reduction) and TRPO's ``"surrogate"``; ``parallel.dp_ppo`` holds a dp
    # run's against one process's. None: nothing is kept.
    grad_probe: Optional[dict] = None

    def __init__(self):
        self.state = None
        self._act_gen = None
        self.pretrained = None  # a loaded policy's state to fine-tune from

    # ---- env, policy and state ------------------------------------------
    def _setup(self, normalize_obs, input_scale: int = 1, env_align=None):
        """The vector env, the policy (``input_scale``: the conv1 fold of
        coarse observations) and whether observations are normalized
        (VecNormalize for every observation but raw pixels)."""
        env = self.env
        if getattr(env, "is_mixed_family", False):
            self.vec_env = VecEnv(env, self.num_envs, align=env_align)
        else:
            self.vec_env = VecEnv(env, self.num_envs)
        self.obs_shape = tuple(env.observation_space.shape)
        self.input_scale = input_scale
        with trace.span("agent.policy_init"):
            self.policy: ActorCritic = self._make_policy().to(self.device)
        if normalize_obs is None:
            normalize_obs = env.srl_model != "raw_pixels"
        self.normalize_obs = normalize_obs

    def _make_policy(self) -> ActorCritic:
        return make_policy(self.env.action_space, self.obs_shape, self.policy_kind,
                           input_scale=self.input_scale)

    def apply(self, params: Dict[str, torch.Tensor], obs: torch.Tensor):
        """(distribution, value) of the policy with ``params``."""
        return functional_call(self.policy, params, (obs,))

    def param_shapes(self) -> Dict[str, tuple]:
        """Each parameter's whole shape."""
        return {k: tuple(v.shape) for k, v in self.policy.state_dict().items()}

    def whole_params(self, params: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
        """``params`` whole: on a mesh with tp > 1, gathered over the rank's
        tp group (a collective: every rank of the group calls it)."""
        if mesh is None:
            return params
        return gather_params(params, mesh, self.param_shapes())

    def whole_state(self, s):
        """``s`` with its parameters, the optimizer's moments and ACER's
        average policy whole (gathered over the tp group where ``s`` is laid
        out on a mesh with tp > 1)."""
        mesh = getattr(s, "mesh", None)
        if mesh is None or mesh.tp == 1:
            return s
        whole = lambda tree: self.whole_params(tree, mesh)
        fields = {"params": whole(s.params), "opt_state": {
            k: whole(v) if isinstance(v, dict) else v for k, v in s.opt_state.items()}}
        if hasattr(s, "avg_params"):
            fields["avg_params"] = whole(s.avg_params)
        return dataclasses.replace(s, **fields)

    def sharded_names(self, mesh) -> set:
        """The parameters a rank of ``mesh`` holds a tp shard of."""
        if mesh is None:
            return set()
        return {k for k, shape in self.param_shapes().items() if tp_sharded(shape, mesh.tp)}

    def reduce_grads(self, grads: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
        """The whole gradients of a rank's loss share, each cut to the rank's
        tp shard and summed over the dp group (one all-reduce of the flat
        shards): the ranks of a dp group get the same gradients."""
        if mesh is not None:
            grads = shard_params(grads, mesh)
            flat = mesh.all_reduce_(torch.cat([g.reshape(-1) for g in grads.values()]))
            grads = {k: f.view_as(g) for (k, g), f in
                     zip(grads.items(), torch.split(flat, [g.numel() for g in grads.values()]))}
        self.note_grads(grads.values())
        return grads

    def note_grads(self, grads, site: str = "grads") -> None:
        """Keep ``grads`` (tensors) flat in ``grad_probe`` if they are the
        first ``site`` has handed on."""
        if self.grad_probe is not None and site not in self.grad_probe:
            self.grad_probe[site] = torch.cat([g.detach().reshape(-1).float()
                                               for g in grads]).cpu()

    def init_params(self, seed: int) -> Dict[str, torch.Tensor]:
        """Fresh orthogonal-init parameters drawn from ``seed``."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = self._make_policy()
        return {k: v.detach().to(self.device) for k, v in fresh.state_dict().items()}

    def init_state(self, gen: torch.Generator, seed: int = 0) -> PPOState:
        """A fresh env batch and optimizer; fresh parameters and normalizer
        from ``seed``, or those of ``self.pretrained`` (a loaded policy's
        state: the fine-tuning start) when it is set."""
        vstate, obs = self.vec_env.reset(gen)
        if self.pretrained is not None:
            params = {k: v.detach().clone() for k, v in self.pretrained.params.items()}
            obs_norm = self.pretrained.obs_norm
        else:
            params = self.init_params(seed)
            obs_norm = None
        if obs_norm is None and self.normalize_obs:
            obs_norm = RunningNorm.create(self.obs_shape, self.device)
        return PPOState(params=params, opt_state=self.opt_init(params), vstate=vstate,
                        obs=obs, obs_norm=obs_norm)

    # ---- the training loop ------------------------------------------------
    def _start(self, seed: int) -> torch.Generator:
        """The run's generator, kept for its checkpoints."""
        self.seed = seed
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        return self.gen

    def _run(self, state: PPOState, n_updates: int, callback: Optional[Callable],
             updates_per_call: int = 1) -> PPOState:
        """``n_updates`` updates from ``state``, rounded up to whole calls of
        ``updates_per_call`` updates, calling ``callback(locals, globals)``
        after each call with its updates' metrics averaged. The episode
        statistics reach the host once a call."""
        steps_per_update = self.config.n_steps * self.num_envs
        k = max(1, min(updates_per_call, n_updates))
        episode_returns, episode_lengths = [], []
        t_start = time.time()
        num_timesteps = 0
        for update in range(0, n_updates, k):
            stats = []
            for _ in range(k):
                state, metrics = self.train_iteration(state, self.gen)
                stats.append(metrics)
            self.state = state
            num_timesteps += steps_per_update * k
            ep_ret = torch.stack([m.pop("episode_return") for m in stats]).cpu().numpy()
            ep_len = torch.stack([m.pop("episode_length") for m in stats]).cpu().numpy()
            finished = ~np.isnan(ep_ret)
            episode_returns.extend(ep_ret[finished].tolist())
            episode_lengths.extend(ep_len[finished].tolist())
            if callback is not None:
                callback({
                    "self": self,
                    "state": state,
                    "update": update + k - 1,
                    "n_updates": n_updates,
                    "num_timesteps": num_timesteps,
                    "episode_returns": episode_returns,
                    "episode_lengths": episode_lengths,
                    "metrics": {name: float(torch.stack([m[name] for m in stats]).mean())
                                for name in stats[0]},
                    "fps": num_timesteps / max(time.time() - t_start, 1e-9),
                }, {})
        self.state = state
        return state

    # ---- CLI integration ------------------------------------------------
    def customArguments(self, parser):
        parser.add_argument("--num-envs", help="Number of batched environments "
                            "(replaces --num-cpu)", type=int, default=None)
        return parser

    @classmethod
    def getOptParam(cls) -> Optional[Dict[str, tuple]]:
        return None

    @classmethod
    def parserHyperParam(cls, hyperparam):
        """Parse 'k:v' strings against the ``getOptParam`` declarations."""
        opt_param = cls.getOptParam()
        parsed = {}
        if hyperparam:
            assert opt_param is not None, (
                "Error: cannot parse hyperparameters for {}".format(cls.name)
            )
            for kv in hyperparam:
                assert ":" in kv, "Error: hyperparam must be of format 'name:value'"
                k, v = kv.split(":", 1)
                assert k in opt_param, f"Error: unknown hyperparam {k}"
                parsed[k] = opt_param[k][0](v)
        return parsed

    # ---- acting ---------------------------------------------------------
    def _act_dist(self, observation):
        obs = as_tensor_on(observation, self.device)
        if self.state.obs_norm is not None:
            obs = self.state.obs_norm.normalize(obs)
        params = self.whole_params(self.state.params, getattr(self.state, "mesh", None))
        dist, _ = self.apply(params, obs)
        return dist

    @torch.no_grad()
    def getAction(self, observation, dones=None, deterministic: bool = False, *,
                  gen: Optional[torch.Generator] = None):
        """Actions for a batch of observations. Without ``gen``, sampling
        draws from the agent's own generator, seeded with 0, which only
        sampling consumes. ``dones`` is there for recurrent agents."""
        dist = self._act_dist(observation)
        if deterministic:
            return dist.mode().cpu().numpy()
        return dist.sample(self._sampling_gen(gen)).cpu().numpy()

    def _sampling_gen(self, gen: Optional[torch.Generator]) -> torch.Generator:
        """``gen``, else the agent's own acting generator, seeded with 0."""
        if gen is None:
            if self._act_gen is None:
                self._act_gen = torch.Generator(device=self.device)
                self._act_gen.manual_seed(0)
            gen = self._act_gen
        return gen

    @torch.no_grad()
    def getActionProba(self, observation, dones=None):
        """Action probabilities (``Discrete``), else the Gaussian's mean."""
        dist = self._act_dist(observation)
        if isinstance(self.env.action_space, Discrete):
            return dist.probs().cpu().numpy()
        return dist.mean.cpu().numpy()

    # ---- the policy pickle (the reference's payload) ----------------------
    @staticmethod
    def _to_numpy(tree):
        """Tensors of a (nested) dict -> numpy arrays."""
        if isinstance(tree, dict):
            return {k: BaseRLAgent._to_numpy(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy()
        return tree

    @staticmethod
    def _save_pickle(path: str, payload: dict):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(payload, f)

    @staticmethod
    def _load_pickle(path: str) -> dict:
        """Only load files this program or the reference wrote: unpickling
        runs code."""
        with open(path, "rb") as f:
            return pickle.load(f)

    def save(self, save_path: str, _locals=None):
        self._save_pickle(save_path, self.policy_payload())

    def policy_payload(self) -> dict:
        """The policy pickle: the reference's payload."""
        norm = self.state.obs_norm
        return {
            "name": self.pickle_name or self.name,
            "config": dataclasses.asdict(self.config),
            "num_envs": self.num_envs,
            "policy_kind": self.policy_kind,
            "normalize_obs": self.normalize_obs,
            "params": self._flax(self.whole_params(self.state.params,
                                                   getattr(self.state, "mesh", None))),
            "obs_norm": (self._to_numpy({"mean": norm.mean, "var": norm.var,
                                         "count": norm.count})
                         if norm is not None else None),
        }

    @classmethod
    def load(cls, load_path: str, env=None, args=None, *, device="cuda"):
        """The agent of a policy pickle (either package's), its parameters
        and normalizer on ``device``; ``args`` is unused, as in the
        reference."""
        d = cls._load_pickle(load_path)
        agent = cls(env=env, num_envs=d["num_envs"], policy=d["policy_kind"],
                    config=cls.config_class(**d["config"]),
                    normalize_obs=d["normalize_obs"], device=device)
        agent.restore_policy(d)
        return agent

    def restore_policy(self, payload: dict):
        """``self.state`` from a policy pickle: its parameters and
        normalizer on the device."""
        norm = payload["obs_norm"]
        if norm is not None:
            norm = RunningNorm(**{k: torch.as_tensor(np.asarray(v, np.float32),
                                                     device=self.device)
                                  for k, v in norm.items()})
        self.state = self.loaded_state(self._state_dict(payload["params"]), norm)

    def loaded_state(self, params, obs_norm):
        """The state of a loaded policy: parameters and normalizer only."""
        return PPOState(params=params, opt_state=None, vstate=None, obs=None,
                        obs_norm=obs_norm)

    # ---- full training-state checkpoints ----------------------------------
    # A subclass that writes checkpoints provides
    # ``opt_state_to_reference(opt_state)``, its optimizer state as the
    # reference's optax state (``bridge.Record``s); one that resumes them,
    # ``opt_state_from_reference(ref)``, the converse.
    # The parameter tree (and every tree shaped like it) in the reference's
    # layout, and back; the recurrent agents and ACKTR override both.
    def _flax(self, tree):
        return bridge.state_dict_to_flax(tree, self.policy.torso_kind)

    def _state_dict(self, tree):
        return {k: v.to(self.device) for k, v in
                bridge.flax_to_state_dict(tree, self.policy.torso_kind).items()}

    def state_to_reference(self, s) -> "bridge.Record":
        """The training state ``s`` as the reference's ``PPOState``, its
        parameters and optimizer whole."""
        s = self.whole_state(s)
        return bridge.Record("srl_tpu.agents.ppo.PPOState", {
            "params": self._flax(s.params),
            "opt_state": self.opt_state_to_reference(s.opt_state),
            "vstate": bridge.to_reference(s.vstate, self.seed),
            "obs": s.obs.detach().cpu().numpy(),
            "obs_norm": bridge.to_reference(s.obs_norm),
            "key": bridge.fresh_keys(self.seed, 1)[0],
            "update_idx": np.asarray(s.update_idx, np.int32),
        })

    def save_checkpoint(self, path: str, meta: Optional[dict] = None):
        """Atomically write the whole training state (parameters, optimizer,
        env batch, observations, normalizer, update counter, the
        generator's state) and the progress ``meta``."""
        ref = self.state_to_reference(self.state)
        bridge.write_reference_pickle({
            "state": ref, "meta": meta or {},
            "torch_generator": {"device_type": self.gen.device.type,
                                "state": self.gen.get_state().numpy()},
        }, path)

    @staticmethod
    def load_checkpoint(path: str):
        """(training state, meta) of a checkpoint of either package; pass the
        state as ``learn(initial_state=...)``. The state is the reference's
        ``PPOState`` as a ``bridge.Record``; ``state.torch_generator`` is the
        port's generator state, None in a reference checkpoint. The state
        itself is None in a checkpoint of ARS, CMA-ES or the random agent
        written before their ``learn`` ended (they set it at its end)."""
        d = bridge.read_reference_pickle(path)
        state = d["state"]
        if isinstance(state, bridge.Record):
            state.torch_generator = d.get("torch_generator")
        return state, d["meta"]

    def restore(self, ckpt, seed: int) -> PPOState:
        """The port's training state of a ``load_checkpoint`` state. The
        generator continues the checkpoint's stream when the port wrote it on
        this device type; otherwise (a reference checkpoint, or another
        device type) a fresh stream starts from ``seed``, and this prints so.
        Sets the agent's ``seed`` and ``gen``."""
        state = PPOState(
            params=self._state_dict(ckpt.params),
            opt_state=self.opt_state_from_reference(ckpt.opt_state),
            vstate=bridge.to_port(ckpt.vstate, self.device),
            obs=torch.as_tensor(np.array(ckpt.obs), device=self.device),
            obs_norm=bridge.to_port(ckpt.obs_norm, self.device),
            update_idx=int(np.asarray(ckpt.update_idx)),
        )
        gen = self._start(seed)
        saved = getattr(ckpt, "torch_generator", None)
        if saved is not None and saved["device_type"] == self.device.type:
            gen.set_state(torch.from_numpy(np.asarray(saved["state"])))
        else:
            origin = ("a reference checkpoint" if saved is None else
                      f"a checkpoint written on {saved['device_type']}")
            print(f"Resuming {origin} on {self.device.type}: the random stream "
                  f"starts fresh from seed {seed}")
        return state


class RecurrentActing:
    """Stateful acting of the recurrent agents, as the reference's: the
    carry persists between ``getAction`` calls (zeros for a new batch
    size), ``dones`` zeroes it where an episode starts, and
    ``getActionProba`` reads the context the last ``getAction`` acted from
    without advancing it (zeros before any call). A subclass provides
    ``_policy_step(params, obs, carry, done)`` -> (distribution, value,
    carry') and ``n_lstm``."""

    _act_carry = None
    _act_ctx = None

    def _act_step(self, observation, carry, done):
        obs = as_tensor_on(observation, self.device)
        if self.state.obs_norm is not None:
            obs = self.state.obs_norm.normalize(obs)
        params = self.whole_params(self.state.params, getattr(self.state, "mesh", None))
        return self._policy_step(params, obs, carry, done)

    def _zero_context(self, n: int):
        zeros = torch.zeros((n, self.n_lstm), dtype=torch.float32, device=self.device)
        return (zeros, zeros.clone()), torch.zeros(n, dtype=torch.bool, device=self.device)

    @torch.no_grad()
    def getAction(self, observation, dones=None, deterministic: bool = False, *,
                  gen: Optional[torch.Generator] = None):
        n = len(observation)
        if self._act_carry is None or self._act_carry[0].shape[0] != n:
            self._act_carry = self._zero_context(n)[0]
        done = (torch.zeros(n, dtype=torch.bool, device=self.device) if dones is None
                else as_tensor_on(dones, self.device).to(torch.bool))
        self._act_ctx = (self._act_carry, done)
        dist, _, self._act_carry = self._act_step(observation, self._act_carry, done)
        if deterministic:
            return dist.mode().cpu().numpy()
        return dist.sample(self._sampling_gen(gen)).cpu().numpy()

    @torch.no_grad()
    def getActionProba(self, observation, dones=None):
        n = len(observation)
        ctx = self._act_ctx
        if ctx is not None and ctx[0][0].shape[0] >= n:
            carry, done = (ctx[0][0][:n], ctx[0][1][:n]), ctx[1][:n]
        else:
            carry, done = self._zero_context(n)
        dist, _, _ = self._act_step(observation, carry, done)
        if isinstance(self.env.action_space, Discrete):
            return dist.probs().cpu().numpy()
        return dist.mean.cpu().numpy()
