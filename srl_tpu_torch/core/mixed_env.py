"""Mixed env-family batches: several env families feeding one learner
(counterpart of srl_tpu/core/mixed_env.py).

* ``MixedEnv`` is a static facade over K env families that share an
  observation space (raw pixels of one shape, or SRL states of one
  dimension). It exposes the union action space and the attributes an agent
  reads, so that an agent treats it as one env.
* ``MixedVecEnv`` splits the batch into contiguous per-family slices (family
  f owns ``counts[f]`` consecutive env slots), steps each slice with its own
  ``VecEnv`` (its own auto-reset, its own renderer) and concatenates the
  transitions along the env axis into one learner batch. Its state is a
  tuple of per-family ``VecEnvState``s; reset and step noise, when a caller
  gives them, are per-family lists.

``VecEnv(mixed_env, n)`` returns a ``MixedVecEnv``, so PPO2 trains on mixed
batches unchanged.

Discrete families of different sizes share ``Discrete(max n)``. How a
smaller family executes a shared action beyond its range is an explicit
choice: ``action_tables`` (a per-family lookup) or ``oob_action`` ("modulo"
maps shared ``i`` to ``i % n``, "clip" to ``min(i, n - 1)``). There is no
silent default: any static fold skews the smaller family's action
distribution under an exploring policy, so differing counts without a
choice raise. Box families must match exactly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from srl_tpu_torch.core.env import Transition, VecEnv
from srl_tpu_torch.core.spaces import Box, Discrete
from srl_tpu_torch.utils import trace


def default_align(num_envs: int, n_families: int, n_devices: Optional[int] = None) -> int:
    """Family-slice alignment that keeps each of ``n_devices`` contiguous
    data-parallel shards inside one family: the shard size, or 1 (no
    alignment) when the batch does not split evenly or is too small for a
    shard per family. ``n_devices`` defaults to the ranks of the default
    process group (``parallel.distributed.initialize``), 1 without one, as
    the reference reads ``jax.device_count()``: so an agent built after
    ``initialize`` on a dp mesh of the whole world gives each rank's
    ``mesh.env_slice`` one family (``MixedVecEnv.step`` steps any slice)."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices <= 1 or num_envs % n_devices != 0:
        return 1
    shard = num_envs // n_devices
    if shard * n_families > num_envs:
        return 1
    return shard


class MixedEnv:
    """Static facade over K env families with a shared observation space."""

    is_mixed_family = True

    def __init__(self, families: Sequence, fractions: Optional[Sequence[float]] = None,
                 action_tables: Optional[Sequence[Optional[Sequence[int]]]] = None,
                 oob_action: str = "raise"):
        if not families:
            raise ValueError("MixedEnv needs at least one family")
        self.families = list(families)
        k = len(self.families)
        if fractions is None:
            fractions = [1.0 / k] * k
        if len(fractions) != k or abs(sum(fractions) - 1.0) >= 1e-6:
            raise ValueError(f"fractions {list(fractions)} must be {k} numbers summing to 1")
        self.fractions = [float(f) for f in fractions]

        obs0 = self.families[0].observation_space
        for fam in self.families[1:]:
            sp = fam.observation_space
            if sp.shape != obs0.shape or sp.dtype != obs0.dtype:
                raise ValueError(
                    f"mixed families need a shared obs space; got {sp.shape} vs "
                    f"{obs0.shape}: use raw_pixels at a common shape or equal-dim "
                    f"SRL states")

        spaces = [fam.action_space for fam in self.families]
        if all(isinstance(s, Discrete) for s in spaces):
            n_shared = max(s.n for s in spaces)
            self._action_space = Discrete(n_shared)
            self._tables: List[Optional[np.ndarray]] = []
            for i, s in enumerate(spaces):
                tab = None
                if action_tables is not None and action_tables[i] is not None:
                    tab = np.asarray(action_tables[i], np.int32)
                    if tab.shape != (n_shared,) or tab.max() >= s.n or tab.min() < 0:
                        raise ValueError(f"action table {tab.tolist()} of family {i} must "
                                         f"map {n_shared} actions into [0, {s.n})")
                elif s.n < n_shared:
                    if oob_action == "modulo":
                        tab = (np.arange(n_shared) % s.n).astype(np.int32)
                    elif oob_action == "clip":
                        tab = np.minimum(np.arange(n_shared), s.n - 1).astype(np.int32)
                    else:
                        raise ValueError(
                            f"mixed families have differing discrete action counts "
                            f"({[sp.n for sp in spaces]}); any static fold of the shared "
                            f"Discrete({n_shared}) onto {type(self.families[i]).__name__}'s "
                            f"{s.n} actions skews its action distribution under an "
                            f"exploring policy: pass action_tables with task-specific "
                            f"semantics, or choose oob_action='modulo'|'clip' explicitly")
                self._tables.append(tab)
        else:
            if not all(isinstance(s, Box) and s.shape == spaces[0].shape for s in spaces):
                raise ValueError("mixed continuous families need identical Box action spaces")
            self._action_space = spaces[0]
            self._tables = [None] * k

    @property
    def observation_space(self):
        return self.families[0].observation_space

    @property
    def action_space(self):
        return self._action_space

    @property
    def srl_model(self) -> str:
        return self.families[0].srl_model

    @property
    def max_steps(self) -> int:
        return max(f.max_steps for f in self.families)

    @property
    def is_discrete(self) -> bool:
        return isinstance(self._action_space, Discrete)

    def split_counts(self, num_envs: int, align: int = 1) -> List[int]:
        """Per-family env counts: each fraction of ``num_envs`` rounded down
        to a multiple of ``align`` (at least ``align``), the remainder
        folded into the first family."""
        counts = [max(align, (int(num_envs * f) // align) * align) for f in self.fractions]
        counts[0] += num_envs - sum(counts)
        if counts[0] < 1:
            raise ValueError(f"num_envs {num_envs} is too small for this family split")
        return counts


class MixedVecEnv(VecEnv):
    """Contiguous per-family ``VecEnv`` slices concatenated into one batch."""

    def __init__(self, env: MixedEnv, num_envs: int, align: Optional[int] = None):
        if not isinstance(env, MixedEnv):
            raise TypeError(
                "MixedVecEnv requires a MixedEnv facade (a wrapper forwarding "
                "is_mixed_family would skip its own observe/encode path: wrap the "
                "families, not the MixedEnv)")
        super().__init__(env, num_envs)
        if align is None:
            align = default_align(num_envs, len(env.families))
        self.align = align
        self.counts = env.split_counts(num_envs, align)
        self.vecs = [VecEnv(fam, c) for fam, c in zip(env.families, self.counts)]
        self._offsets = np.concatenate([[0], np.cumsum(self.counts)]).tolist()
        self._device_tables = {}

    def _table(self, i: int, device: torch.device) -> Optional[torch.Tensor]:
        """Family ``i``'s action table on ``device`` (made once per device)."""
        tab = self.env._tables[i]
        if tab is None:
            return None
        key = (i, device)
        if key not in self._device_tables:
            self._device_tables[key] = torch.as_tensor(tab, dtype=torch.int64, device=device)
        return self._device_tables[key]

    def reset(self, gen: Optional[torch.Generator], noise: Optional[list] = None):
        noise = noise or [None] * len(self.vecs)
        states, obs = zip(*(vec.reset(gen, noise=nz) for vec, nz in zip(self.vecs, noise)))
        return tuple(states), torch.cat(obs, 0)

    def step(self, vstate, actions: torch.Tensor, gen: Optional[torch.Generator] = None,
             step_noise: Optional[list] = None, reset_noise: Optional[list] = None, *,
             mesh=None):
        """One step of every family's slice. With ``mesh``, ``actions`` and
        ``vstate`` hold the rank's rows ``mesh.env_slice(num_envs)``: each
        family steps the rows of it that the rank holds (maybe none, while
        it still draws for its whole slice). Traced as one ``env.step``
        holding each family's phases (``VecEnv.step``)."""
        with trace.span("env.step"):
            return self._step_families(vstate, actions, gen, step_noise, reset_noise, mesh)

    def _step_families(self, vstate, actions, gen, step_noise, reset_noise, mesh):
        k = len(self.vecs)
        step_noise = step_noise or [None] * k
        reset_noise = reset_noise or [None] * k
        lo, hi = (0, self.num_envs) if mesh is None else mesh.env_slice(self.num_envs)
        new_states, trs = [], []
        for i, vec in enumerate(self.vecs):
            start, end = self._offsets[i], self._offsets[i + 1]
            f_lo = min(max(lo, start), end)
            f_hi = max(min(hi, end), f_lo)
            a = actions[f_lo - lo:f_hi - lo]
            table = self._table(i, actions.device)
            if table is not None:
                a = table[a.long()]
            rows = None if mesh is None else (f_lo - start, f_hi - start)
            st, tr = vec._step(vstate[i], a, gen, step_noise[i], reset_noise[i], mesh, rows)
            new_states.append(st)
            if tr is not None:
                trs.append(tr)
        merged = Transition(**{f.name: torch.cat([getattr(tr, f.name) for tr in trs], 0)
                               for f in dataclasses.fields(Transition)})
        return tuple(new_states), merged
