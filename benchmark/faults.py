"""Faults planted in the program, to show that the comparison catches
them (``calibrate.py`` on the card, ``tests/`` on the CPU). Each is a
context manager that patches attributes of one agent (or the sampler's
class) and restores them:

* ``frozen``: the optimizer step returns the state unchanged;
* ``half_batch``: each minibatch leaves out half of its rows, the loss's
  means taken over the rest;
* ``action``: one env's action is altered where it is sampled;
* ``frame``: one env's frame is altered where it is rendered;
* ``reward``: one env's reward is altered where the env step computes it;
* ``advantage``: one env's advantages are altered where GAE computes them;
* ``target``: one primitive dropped from one env's frame where it is
  rendered (Kuka's button, MobileRobot's target: moved out of view);
* ``reset``: the fresh episodes' state is altered where the env step's
  auto-reset makes it (the set-up's reset is left as it is);
* ``skip_minibatch``: each epoch's last minibatch is left out;
* ``one_epoch``: the update runs one epoch of its ``noptepochs``;
* ``half_perm``: the epochs' permutations are drawn over half of the
  batch's rows, each row twice.

``MESH_FAULTS`` hold only on a dp mesh (a run of ``ranks.py``), planted on
every rank:

* ``no_allreduce``: each rank steps on its own rows' gradient (the
  exchange between the cards left out);
* ``drop_rank``: the last rank's gradient is left out of the sum;
* ``reward_last_rank``, ``frame_last_rank``: ``reward`` and ``frame``
  planted on the last rank only, so that the check must read every rank.

The faults that alter a frame (``FRAME_FAULTS``) apply only where the
cell's network observes uint8 frames (``kinds``). Where it observes float
states (ground truth, a frozen encoder's), ``STATE_FAULTS`` hold:

* ``observation``: one env's observation is altered where the env makes
  it;

and where the configuration normalizes observations, ``NORM_FAULTS``:

* ``stale_norm``: PPO2's running normalizer never updates its statistics.
"""
from __future__ import annotations

import dataclasses

import torch

from patching import Patches

# The field of each env's state that holds the primitive ``target`` drops.
TARGET_FIELDS = ("buttons", "targets")


def frozen(agent):
    return Patches().set(agent, "optimizer_step_", lambda orig: lambda *a, **k: None)


def half_batch(agent):
    return Patches().set(agent, "_minibatch",
                    lambda orig: lambda data, idx: orig(data, idx[: idx.shape[0] // 2]))


def action(agent):
    from srl_tpu_torch.models.distributions import Categorical

    def make(orig):
        def sample(dist, gen, rows=None):
            out = orig(dist, gen, rows).clone()
            out[0] = (out[0] + 1) % dist.logits.shape[-1]
            return out
        return sample
    return Patches().set(Categorical, "sample", make)


def frame(agent):
    def make(orig):
        def observe(state):
            out = orig(state).clone()
            out[0] = 255 - out[0]
            return out
        return observe
    return Patches().set(agent.vec_env.env, "observe", make)


def reward(agent):
    def make(orig):
        def apply_step(state, act, noise):
            new, r, done = orig(state, act, noise)
            r = r.clone()
            r[0] += 1.0
            return new, r, done
        return apply_step
    return Patches().set(agent.vec_env.env, "apply_step", make)


def advantage(agent):
    import srl_tpu_torch.agents.ppo as ppo_module

    def make(orig):
        def compute_gae(*args, **kwargs):
            adv, ret = orig(*args, **kwargs)
            adv = adv.clone()
            adv[:, 0] += 1.0
            return adv, ret
        return compute_gae
    return Patches().set(ppo_module, "compute_gae", make)


def target(agent):
    def make(orig):
        def observe(state):
            name = next(f for f in TARGET_FIELDS if hasattr(state, f))
            moved = getattr(state, name).clone()
            moved[0, ..., 0] += 100.0
            return orig(dataclasses.replace(state, **{name: moved}))
        return observe
    return Patches().set(agent.vec_env.env, "observe", make)


def reset(agent):
    calls = []

    def make(orig):
        def apply_reset(noise):
            fresh = orig(noise)
            calls.append(1)
            if len(calls) == 1:
                return fresh
            name = next(f.name for f in dataclasses.fields(fresh)
                        if getattr(fresh, f.name).is_floating_point())
            return dataclasses.replace(fresh, **{name: getattr(fresh, name) + 0.05})
        return apply_reset
    return Patches().set(agent.vec_env.env, "apply_reset", make)


def _epochs(agent, keep_epochs, keep_minibatches):
    """``update_epochs`` on the first ``keep_epochs`` permutations and, in
    each, the first ``keep_minibatches`` minibatches."""
    cfg = agent.config

    def make(orig):
        def update_epochs(params, opt_state, data, perms, mesh=None):
            mb = perms.shape[1] // cfg.nminibatches
            n = cfg.nminibatches
            cfg.nminibatches = keep_minibatches(n)
            try:
                return orig(params, opt_state, data,
                            perms[:keep_epochs(perms.shape[0]), :cfg.nminibatches * mb], mesh)
            finally:
                cfg.nminibatches = n
        return update_epochs
    return Patches().set(agent, "update_epochs", make)


def skip_minibatch(agent):
    return _epochs(agent, lambda e: e, lambda m: m - 1)


def one_epoch(agent):
    return _epochs(agent, lambda e: 1, lambda m: m)


def half_perm(agent):
    def make(orig):
        def randperm(n, *args, **kwargs):
            return orig(n // 2, *args, **kwargs).repeat(2)
        return randperm
    return Patches().set(torch, "randperm", make)


FAULTS = {"frozen": frozen, "half_batch": half_batch, "action": action, "frame": frame,
          "reward": reward, "advantage": advantage, "target": target, "reset": reset,
          "skip_minibatch": skip_minibatch, "one_epoch": one_epoch, "half_perm": half_perm}


def no_allreduce(agent):
    return Patches().set(agent, "reduce_grads",
                         lambda orig: lambda grads, mesh: orig(grads, None))


def drop_rank(agent):
    def make(orig):
        def reduce_grads(grads, mesh):
            if mesh is not None and mesh.dp_index == mesh.dp - 1:
                grads = {k: torch.zeros_like(g) for k, g in grads.items()}
            return orig(grads, mesh)
        return reduce_grads
    return Patches().set(agent, "reduce_grads", make)


def _on_last_rank(fault):
    """``fault`` planted on the last rank of the program's world only."""
    def plant(agent):
        world = torch.distributed
        if world.is_initialized() and world.get_rank() == world.get_world_size() - 1:
            return fault(agent)
        return Patches()
    return plant


MESH_FAULTS = {"no_allreduce": no_allreduce, "drop_rank": drop_rank,
               "reward_last_rank": _on_last_rank(reward),
               "frame_last_rank": _on_last_rank(frame)}
FRAME_FAULTS = ("frame", "target", "frame_last_rank")


def observation(agent):
    def make(orig):
        def observe(state):
            out = orig(state).clone()
            out[0] += 1.0
            return out
        return observe
    return Patches().set(agent.vec_env.env, "observe", make)


def stale_norm(agent):
    from srl_tpu_torch.core.normalize import RunningNorm

    return Patches().set(RunningNorm, "update",
                         lambda orig: lambda norm, batch, mesh=None: norm)


STATE_FAULTS = {"observation": observation}
NORM_FAULTS = {"stale_norm": stale_norm}


def kinds(cell, mesh_cell: bool) -> dict:
    """The faults that ``cell`` can have: ``FAULTS``, on a mesh also
    ``MESH_FAULTS``; those of ``FRAME_FAULTS`` only where its network's
    observations are frames, ``STATE_FAULTS`` where they are not;
    ``NORM_FAULTS`` where its configuration normalizes them."""
    found = dict(FAULTS, **(MESH_FAULTS if mesh_cell else {}))
    if not cell.network.FRAMES:
        found = {k: v for k, v in found.items() if k not in FRAME_FAULTS}
        found.update(STATE_FAULTS)
    if cell.config.get("normalize_obs", False):
        found.update(NORM_FAULTS)
    return found
