"""The process-group mesh and the data-parallel layout of the actor-learner
(counterpart of srl_tpu/parallel/mesh.py).

The reference lays a dp x tp grid of devices out for XLA GSPMD and lets the
compiler insert the collectives. Here a rank of a ``torch.distributed``
process group plays a device: a ``Mesh`` holds its group explicitly, as the
port holds its generators explicitly, and every collective goes through
``mesh.group``, never the implicit default group (so that the tests build
the ranks of a mesh in one process).

* ``dp``, the env batch axis: rank ``r`` owns the contiguous global env rows
  ``[lo, hi) = mesh.env_slice(num_envs)``. Every random draw is made at the
  global size from a generator that all ranks seed alike, and each rank keeps
  its rows, so rank ``r`` steps rows ``[lo, hi)`` of the one-process run bit
  for bit (``core/env.py``, ``agents/common.py``). PPO2's update
  (``agents/ppo.py``) computes the loss terms of the rows each rank owns in
  every global minibatch and all-reduces them and the gradients with SUM:
  the one-process step, up to the order of the reductions.
* ``tp``: the reference shards each weight's output features over ``tp``,
  which changes where weights live, not what is computed. The port's target
  is one card: ``make_mesh`` returns the reference's shape for ``tp > 1``,
  but ``shard_params`` and ``shard_ppo_state`` refuse it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import torch
import torch.distributed as dist

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def env_rows(global_num_envs: int, process_id: int,
             process_count: int) -> Tuple[int, int]:
    """[lo, hi) of the global env batch that ``process_id`` of
    ``process_count`` owns (``distributed.local_env_slice``)."""
    assert global_num_envs % process_count == 0, (
        f"global_num_envs({global_num_envs}) must divide process_count({process_count})"
    )
    per = global_num_envs // process_count
    return process_id * per, (process_id + 1) * per


@dataclasses.dataclass
class Mesh:
    """A ``dp x tp`` grid over the ranks of ``group``, row-major: rank ``r``
    sits at ``(r // tp, r % tp)``. ``seconds`` counts the time spent in this
    mesh's collectives (a card is synchronized before each, so that the time
    is the collective's own)."""

    group: object  # a torch.distributed ProcessGroup, or a backend such as ProcessGroupGloo
    dp: int
    tp: int
    rank: int
    seconds: float = 0.0

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def backend(self) -> str:
        return self.group.name()

    def env_slice(self, num_envs: int) -> Tuple[int, int]:
        """[lo, hi) of a batch of ``num_envs`` envs that this rank owns."""
        return env_rows(num_envs, self.dp_index, self.dp)

    # ---- collectives, all through ``self.group`` ---------------------------
    def _wait(self, work, t: torch.Tensor) -> None:
        work.wait()
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group, in place."""
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        opts = dist.AllreduceOptions()
        opts.reduceOp = _REDUCE_OPS[op]
        self._wait(self.group.allreduce([t], opts), t)
        self.seconds += time.perf_counter() - t0
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated in rank order along ``dim``."""
        t = t.contiguous()
        if t.is_cuda:
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        outs = [torch.empty_like(t) for _ in range(self.dp * self.tp)]
        self._wait(self.group.allgather([outs], [t]), t)
        self.seconds += time.perf_counter() - t0
        return torch.cat(outs, dim)

    def any(self, flags: torch.Tensor) -> bool:
        """Whether any rank has a true entry in ``flags``: one all-reduce of
        one int, read on the host."""
        return bool(self.all_reduce_(flags.any().to(torch.int32).reshape(1), "max"))

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every entry of ``x`` over all ranks (one all-reduce of
        the sum and the count)."""
        packed = torch.stack([x.sum().to(torch.float32),
                              torch.tensor(float(x.numel()), device=x.device)])
        total, count = self.all_reduce_(packed)
        return total / count

    def moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, variance with ddof 0, count) over the rows of ``x`` [n, ...]
        on all ranks, two all-reduces: the count and the sum, then the
        squared deviations from the global mean."""
        x = x.to(torch.float32)
        count = torch.tensor([float(x.shape[0])], device=x.device)
        packed = self.all_reduce_(torch.cat([count, x.sum(0).reshape(-1)]))
        count = packed[0]
        mean = (packed[1:] / count).reshape(x.shape[1:])
        sq = self.all_reduce_(torch.square(x - mean).sum(0))
        return mean, sq / count, count


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1, *,
              group=None) -> Mesh:
    """A ``dp x tp`` mesh over the ranks of ``group`` (the default world
    when None). ``n_devices``, the ranks it spans, is the group's size."""
    if group is None:
        group = dist.group.WORLD
        if group is None:
            raise RuntimeError("no default process group: call "
                               "parallel.distributed.initialize() first, or pass group=")
    size = group.size()
    if n_devices is None:
        n_devices = size
    if dp is None:
        dp = n_devices // tp
    assert dp * tp == n_devices, f"dp({dp}) * tp({tp}) != devices({n_devices})"
    if n_devices != size:
        raise ValueError(f"a mesh spans every rank of its group: {n_devices} devices "
                         f"asked of a group of {size} (make a group of {n_devices} ranks)")
    return Mesh(group=group, dp=dp, tp=tp, rank=group.rank())


def _refuse_tp(mesh: Mesh) -> None:
    if mesh.tp > 1:
        raise ValueError(
            f"tp={mesh.tp}: the port does not shard weights over ranks. The reference's "
            f"tp lays each weight's output features over tp devices, which changes where "
            f"the weights live and not what is computed; the port targets one card and "
            f"keeps every weight whole on each rank. Use a mesh with tp=1 (dp ranks)")


def _map_tree(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: _map_tree(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def shard_batch(tree, mesh: Mesh):
    """This rank's rows of every tensor of ``tree`` whose leading (env or
    batch) axis the reference shards over ``dp`` (longer than 1 and divisible
    by dp); every other leaf is replicated, kept whole."""

    def take(x):
        n = x.shape[0] if x.dim() else 0
        if n > 1 and n % mesh.dp == 0:
            lo, hi = mesh.env_slice(n)
            return x[lo:hi]
        return x

    return _map_tree(take, tree)


def shard_params(params, mesh: Mesh):
    """Parameters (or optimizer state) laid out over ``tp``: with tp=1
    every rank holds them whole, as they are; tp > 1 is refused."""
    _refuse_tp(mesh)
    return params


def shard_ppo_state(state, mesh: Mesh):
    """A PPO2 ``PPOState`` laid out on ``mesh``: this rank's rows of the env
    batch (the vector env's state and the observations), the parameters, the
    optimizer and the normalizer whole. ``agent.train_iteration`` then trains
    data-parallel over the mesh."""
    from srl_tpu_torch.agents.base import PPOState
    from srl_tpu_torch.core.env import take_rows

    if type(state) is not PPOState:
        raise ValueError(f"shard_ppo_state lays out PPO2's PPOState, not "
                         f"{type(state).__name__}: only PPO2 (feed-forward) trains "
                         f"data-parallel, as in the reference")
    if state.mesh is not None:
        raise ValueError("the state is laid out on a mesh already")
    _refuse_tp(mesh)
    lo, hi = mesh.env_slice(state.obs.shape[0])
    return dataclasses.replace(
        state, vstate=take_rows(state.vstate, lo, hi), obs=state.obs[lo:hi],
        params=shard_params(state.params, mesh), opt_state=shard_params(state.opt_state, mesh),
        mesh=mesh)
