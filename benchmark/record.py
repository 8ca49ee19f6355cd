"""What the program's updates produce, captured while they run.

``Recorder(agent)`` is installed around the set-up's reset and first
``train_iteration``, the window's own call: it wraps attributes of that
agent, its vector env and env, and the categorical sampler, keeps what they
hand on, and restores every attribute when it leaves. The window then runs
the program unwrapped. Everything kept is the program's: its env states,
rewards and dones step by step, the random numbers it drew, its actions, its
rollout outputs, the permutations, the rows each loss saw, the optimizer
steps, its losses, Adam's first moments after one step and the parameters
after three. Frames are kept only at a few steps, on the host, so that the
window's memory is the program's own.

``Recorder(agent, rollout_only=True)`` records an update after the window
the same way, but only its env steps, frames at the steps where an episode
ended, and GAE: the check of the auto-reset and of GAE's masking at episode
ends, which the first update (no episode ends in it) cannot see.

On a data-parallel mesh (``rows``, the rank's ``[lo, hi)`` of the env
batch) the program draws every random number for the whole batch and steps
its own rows: the recorder keeps the noise of those rows, so that the record
is of the rows this rank steps."""
from __future__ import annotations

import dataclasses
import math

import torch

from patching import Patches

# Optimizer steps the reference follows.
FOLLOWED_STEPS = 3


def _clone(x):
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return {f.name: _clone(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, torch.Tensor):
        return x.detach().clone()
    return x


class Recorder(Patches):
    """The record of one update; ``gae`` is (module, attribute) of the GAE
    function that the agent's update calls."""

    def __init__(self, agent, frame_steps, gae, rollout_only=False, rows=None):
        super().__init__()
        self.agent = agent
        self.rows = rows
        self.gae_target = gae
        # The steps whose frames are kept; after the window, the first
        # ``frame_steps`` steps in which an episode ended.
        self.frame_steps = frame_steps if rollout_only else set(frame_steps)
        self.rollout_only = rollout_only
        self.reset_noise = None  # the first reset's draw
        self.state0 = None  # the env state the update starts from, and its frames (host)
        self.obs0 = None
        self.ep0 = None  # (episode returns, lengths) it starts from
        self.steps = []  # per env step: dict of what went in and came out
        self.frames = {}  # step -> the frames it returned (host)
        self.u = []  # per rollout step: the uniforms of the Gumbel draw
        self.gae = None  # GAE's inputs (rewards, values, dones, last value) and outputs
        self.data = None  # update_epochs' flat (actions, logp, values, adv, returns)
        self.perms = None
        self.losses = []
        self.mb = []  # (logits, actions) of the loss's rows before the first optimizer step
        self.seen = []  # per loss: (old log-probabilities, old values) of the rows it saw
        self.grad_norm = None  # the first gradient handed to the optimizer step, its norm
        self.mu1 = None
        self.params3 = None
        self.n_opt_steps = 0

    def __enter__(self):
        import importlib

        from srl_tpu_torch.models.distributions import Categorical

        agent, vec = self.agent, self.agent.vec_env
        env = vec.env
        self._wrap_noise(env)
        orig_step = vec.step
        orig_sample = Categorical.sample
        orig_update = agent.update_epochs
        orig_opt = agent.optimizer_step_
        orig_objective = agent._objective
        gae_module = importlib.import_module(self.gae_target[0])
        orig_gae = getattr(gae_module, self.gae_target[1])

        def step(vstate, actions, *args, **kwargs):
            self._pending = {"action": actions.detach().clone()}
            vstate2, tr = orig_step(vstate, actions, *args, **kwargs)
            t = len(self.steps)
            rec = self._pending
            rec.update(state=_clone(vstate2.env_state), ep_return=vstate2.ep_return.clone(),
                       ep_length=vstate2.ep_length.clone(), reward=tr.reward.clone(),
                       done=tr.done.clone())
            rec.setdefault("reset_noise", None)
            self.steps.append(rec)
            if (len(self.frames) < self.frame_steps and bool(tr.done.any())
                    if self.rollout_only else t in self.frame_steps):
                self.frames[t] = tr.obs.to("cpu")
            return vstate2, tr

        def sample(dist, gen, rows=None):
            before = gen.get_state()
            out = orig_sample(dist, gen, rows)
            replay = torch.Generator(device=gen.device)
            replay.set_state(before)
            shape = dist.logits.shape if rows is None else \
                (rows[1],) + tuple(dist.logits.shape[1:])
            u = torch.rand(shape, generator=replay, device=dist.logits.device)
            if rows is not None:
                u = u[rows[0]:rows[0] + dist.logits.shape[0]]
            self.u.append(u.clamp_min(torch.finfo(torch.float32).tiny))
            return out

        def update_epochs(params, opt_state, data, perms, mesh=None):
            self.data = tuple(x.detach().clone() for x in data[1:])
            self.perms = perms.clone()
            return orig_update(params, opt_state, data, perms, mesh)

        def optimizer_step_(params, grads, opt_state, mesh=None):
            if self.grad_norm is None:
                # Before the step: it clips ``grads`` in place.
                self.grad_norm = math.sqrt(sum(float(g.double().square().sum())
                                               for g in grads.values()))
            out = orig_opt(params, grads, opt_state, mesh)
            self.n_opt_steps += 1
            if self.n_opt_steps == 1:
                self.mu1 = _clone(opt_state["mu"])
            if self.n_opt_steps == FOLLOWED_STEPS:
                self.params3 = _clone(params)
            return out

        def objective(dist, vpred, actions, old_logp, old_values, *args, **kwargs):
            self.seen.append((old_logp.detach().clone(), old_values.detach().clone()))
            if self.n_opt_steps == 0:
                self.mb.append((dist.logits.detach().clone(), actions.detach().clone()))
            total, aux = orig_objective(dist, vpred, actions, old_logp, old_values, *args,
                                        **kwargs)
            if len(self.losses) < FOLLOWED_STEPS:
                self.losses.append(total.detach().clone())
            return total, aux

        def compute_gae(rewards, values, dones, last_value, *args, **kwargs):
            adv, ret = orig_gae(rewards, values, dones, last_value, *args, **kwargs)
            if self.gae is None:
                self.gae = _clone({"rewards": rewards, "values": values, "dones": dones,
                                   "last_value": last_value, "adv": adv, "ret": ret})
            return adv, ret

        wraps = [(gae_module, self.gae_target[1], compute_gae), (vec, "step", step)]
        if not self.rollout_only:
            wraps += [(Categorical, "sample", sample), (agent, "update_epochs", update_epochs),
                      (agent, "optimizer_step_", optimizer_step_),
                      (agent, "_objective", objective)]
        for owner, name, fn in wraps:
            self.set(owner, name, lambda _, fn=fn: fn)
        return self

    def _own(self, noise: dict) -> dict:
        """A copy of the noise of the rows this process steps."""
        if self.rows is None:
            return _clone(noise)
        lo, hi = self.rows
        return {k: v[lo:hi].detach().clone() for k, v in noise.items()}

    def _wrap_noise(self, env):
        orig_reset, orig_step = env.draw_reset_noise, env.draw_step_noise

        def draw_reset_noise(gen, n):
            noise = orig_reset(gen, n)
            if self.reset_noise is None and not self.rollout_only:
                self.reset_noise = self._own(noise)
            else:
                self._pending["reset_noise"] = self._own(noise)
            return noise

        def draw_step_noise(gen, n):
            noise = orig_step(gen, n)
            self._pending["step_noise"] = self._own(noise)
            return noise

        self.set(env, "draw_reset_noise", lambda _: draw_reset_noise)
        self.set(env, "draw_step_noise", lambda _: draw_step_noise)

    def note_start(self, state):
        """The state the recorded update starts from (for the first, the
        set-up's reset)."""
        self.state0 = _clone(state.vstate.env_state)
        self.ep0 = (state.vstate.ep_return.clone(), state.vstate.ep_length.clone())
        self.obs0 = state.obs.to("cpu")

    def dones(self) -> int:
        """The episode ends in the recorded steps."""
        return sum(int(s["done"].sum()) for s in self.steps)

    def complete(self) -> bool:
        if self.rollout_only:
            return self.gae is not None and len(self.steps) > 0
        return (self.reset_noise is not None and self.data is not None
                and self.gae is not None and len(self.u) == len(self.steps) > 0)
