"""The process-group mesh and the dp x tp layout of the actor-learner
(counterpart of srl_tpu/parallel/mesh.py).

The reference lays a dp x tp grid of devices out for XLA GSPMD and lets the
compiler insert the collectives. Here a rank of a ``torch.distributed``
process group plays a device: a ``Mesh`` holds its groups explicitly, as the
port holds its generators explicitly, and every collective goes through one
of them, never the implicit default group (so that the tests build the ranks
of a mesh in one process).

* ``dp``, the env batch axis: rank ``r`` owns the contiguous global env rows
  ``[lo, hi) = mesh.env_slice(num_envs)`` of its dp index. Every random draw
  is made at the global size from a generator that all ranks seed alike, and
  each rank keeps its rows, so rank ``r`` steps rows ``[lo, hi)`` of the
  one-process run bit for bit (``core/env.py``, ``agents/common.py``).
  Each agent's update computes the loss terms of the rows each rank owns
  (PPO2's: of every global minibatch) as shares of the global means and
  all-reduces them and the gradients with SUM: the one-process step, up to
  the order of the reductions. ``shard_ppo_state`` lays out the state of
  every agent the reference's does: PPO2, PPO1, A2C, TRPO, ACER and the
  recurrent PPO2, A2C and ACER.
* ``tp``, the output features of the weights: a rank keeps its ``1/tp``
  shard of dim 0 of every leaf whose dim 0 divides by tp (``shard_params``;
  the reference's last dim is the port's dim 0), of the parameters and of
  Adam's ``mu`` and ``nu``, and the whole of every other leaf. This changes
  where weights live, not what is computed: the ranks of a tp group hold the
  same env rows and step them alike, gather the whole weights before a
  forward (``gather_params``), keep their shard's slice of the gradient and
  run the optimizer on their shards only (``BaseRLAgent.reduce_grads``).

The data reductions (``all_reduce_``, ``all_gather``, ``mean``,
``moments``) go over the rank's dp group, the ranks that share its tp
index: over the whole world each row would count tp times. The weight
gather and the gradient norm's partial sums (``tp_all_gather``,
``tp_all_reduce_``) go over its tp group, the ranks that share its dp
index; ``any`` goes over the world.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from srl_tpu_torch.core.device import host_tensor
from srl_tpu_torch.utils import trace

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
    sits at ``(r // tp, r % tp)``. ``dp_group`` holds the ranks of this
    rank's column (``group`` itself when tp is 1, None when dp is 1: a
    reduction over one rank is no collective), ``tp_group`` those of its row
    (``group`` when dp is 1, None when tp is 1). Each collective is a span
    of ``utils/trace`` (``mesh.all_reduce``, ``mesh.all_gather``,
    ``mesh.any``, ``mesh.tp_all_reduce``, ``mesh.tp_all_gather``) and counts
    ``mesh.collectives`` and its input's ``mesh.bytes``; in the tracer's
    detail mode a card is synchronized before and after each, so that the
    span is the collective's own time."""

    group: object  # a torch.distributed ProcessGroup, or a backend such as ProcessGroupGloo
    dp: int
    tp: int
    rank: int
    dp_group: object = None
    tp_group: object = None

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    @property
    def backend(self) -> str:
        return self.group.name()

    def env_slice(self, num_envs: int) -> Tuple[int, int]:
        """[lo, hi) of a batch of ``num_envs`` envs that this rank owns."""
        return env_rows(num_envs, self.dp_index, self.dp)

    # ---- collectives, each through one of the mesh's groups -----------------
    @staticmethod
    def _run(name: str, t: torch.Tensor, start) -> None:
        """The collective ``start()`` on ``t``, waited for, traced as the
        span ``name`` (synchronized around in detail mode)."""
        trace.count("mesh.collectives")
        trace.count("mesh.bytes", t.numel() * t.element_size())
        timed = t.is_cuda and trace.detail()
        if timed:
            torch.cuda.current_stream(t.device).synchronize()
        with trace.span(name):
            start().wait()
            if timed:
                torch.cuda.current_stream(t.device).synchronize()

    def _all_reduce(self, name: str, group, t: torch.Tensor, op: str) -> None:
        opts = dist.AllreduceOptions()
        opts.reduceOp = _REDUCE_OPS[op]
        self._run(name, t, lambda: group.allreduce([t], opts))

    def _all_gather(self, name: str, group, t: torch.Tensor, dim: int) -> torch.Tensor:
        t = t.contiguous()
        outs = [torch.empty_like(t) for _ in range(group.size())]
        self._run(name, t, lambda: group.allgather([outs], [t]))
        return torch.cat(outs, dim)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the dp group, in place."""
        if self.dp_group is not None:
            self._all_reduce("mesh.all_reduce", self.dp_group, t, op)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The dp group's ``t`` concatenated in rank order along ``dim``."""
        if self.dp_group is None:
            return t
        return self._all_gather("mesh.all_gather", self.dp_group, t, dim)

    def tp_all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the tp group, in place."""
        if self.tp_group is not None:
            self._all_reduce("mesh.tp_all_reduce", self.tp_group, t, "sum")
        return t

    def tp_all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The tp group's ``t`` concatenated in tp-index order along dim 0."""
        if self.tp_group is None:
            return t
        return self._all_gather("mesh.tp_all_gather", self.tp_group, t, 0)

    def any(self, flags: torch.Tensor) -> bool:
        """Whether any rank has a true entry in ``flags``: one all-reduce of
        one int over the world, read on the host (``sync.mesh.any``)."""
        flag = flags.any().to(torch.int32).reshape(1)
        self._all_reduce("mesh.any", self.group, flag, "max")
        with trace.sync("mesh.any"):
            return bool(flag)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of every entry of ``x`` over the dp group's ranks (one
        all-reduce of the sum and the count)."""
        packed = torch.stack([x.sum().to(torch.float32),
                              host_tensor(float(x.numel()), device=x.device)])
        total, count = self.all_reduce_(packed)
        return total / count

    def moments(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(mean, variance with ddof 0, count) over the rows of ``x`` [n, ...]
        on the dp group's ranks, two all-reduces: the count and the sum, then
        the squared deviations from the global mean."""
        x = x.to(torch.float32)
        count = host_tensor([float(x.shape[0])], device=x.device)
        packed = self.all_reduce_(torch.cat([count, x.sum(0).reshape(-1)]))
        count = packed[0]
        mean = (packed[1:] / count).reshape(x.shape[1:])
        sq = self.all_reduce_(torch.square(x - mean).sum(0))
        return mean, sq / count, count


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1, *,
              group=None, new_group: Optional[Callable] = None) -> Mesh:
    """A ``dp x tp`` mesh over the ranks of ``group`` (the default world
    when None). ``n_devices``, the ranks it spans, is the group's size.

    With dp and tp both above 1 each rank needs a dp and a tp group:
    ``new_group(ranks)`` makes the group of ``ranks`` (ranks of ``group``).
    Every rank calls it for every sub-group in the same order, the dp groups
    (tp index 0, 1, ...) then the tp groups (dp index 0, 1, ...), as
    ``torch.distributed.new_group`` must be called; it may return None for a
    group without the calling rank. On the default world it defaults to
    ``torch.distributed.new_group``; another ``group`` (the tests' one
    backend per thread on a shared store) passes its own."""
    if group is None:
        group = dist.group.WORLD
        if group is None:
            raise RuntimeError("no default process group: call "
                               "parallel.distributed.initialize() first, or pass group=")
        new_group = new_group or dist.new_group
    size = group.size()
    if n_devices is None:
        n_devices = size
    if dp is None:
        dp = n_devices // tp
    assert dp * tp == n_devices, f"dp({dp}) * tp({tp}) != devices({n_devices})"
    if n_devices != size:
        raise ValueError(f"a mesh spans every rank of its group: {n_devices} devices "
                         f"asked of a group of {size} (make a group of {n_devices} ranks)")
    mesh = Mesh(group=group, dp=dp, tp=tp, rank=group.rank())
    if tp == 1:
        mesh.dp_group = group
    elif dp == 1:
        mesh.tp_group = group
    elif new_group is None:
        raise ValueError(f"a dp{dp} x tp{tp} mesh over a group that is not the default "
                         f"world needs new_group= to make its dp and tp sub-groups")
    else:
        for t in range(tp):
            ranks = [d * tp + t for d in range(dp)]
            made = new_group(ranks)
            if mesh.rank in ranks:
                mesh.dp_group = made
        for d in range(dp):
            ranks = [d * tp + t for t in range(tp)]
            made = new_group(ranks)
            if mesh.rank in ranks:
                mesh.tp_group = made
    return mesh


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


def tp_sharded(shape, tp: int) -> bool:
    """Whether a leaf of ``shape`` (the whole leaf's) is sharded over ``tp``:
    the reference's rule on its output-feature dim, the port's dim 0."""
    return len(shape) >= 1 and tp > 1 and shape[0] % tp == 0 and shape[0] >= tp


def shard_params(params, mesh: Mesh):
    """Parameters (or optimizer state) laid out over ``tp``: this rank's rows
    ``[i * n / tp, (i + 1) * n / tp)`` of dim 0 (``i`` its tp index) of every
    tensor whose dim 0 ``n`` divides by tp; every other leaf whole, as it is.
    The reference shards the output-feature dim, its last: the port's dim 0
    of a ``Linear`` weight ``[out, in]``, a conv weight ``[O, C, kh, kw]``, a
    bias or ``log_std``."""

    def take(x):
        if not tp_sharded(x.shape, mesh.tp):
            return x
        n = x.shape[0] // mesh.tp
        return x[mesh.tp_index * n:(mesh.tp_index + 1) * n].clone()

    return _map_tree(take, params)


def gather_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                  shapes: Dict[str, tuple]) -> Dict[str, torch.Tensor]:
    """The whole leaves of a tp layout (``shard_params``) of ``{name:
    tensor}``, ``shapes`` the whole leaves' shapes: one all-gather over the tp
    group of the rank's sharded leaves flattened, each leaf's shards then
    joined in tp-index order. A collective: every rank of the tp group calls
    it. ``params`` itself when tp is 1."""
    names = [k for k in params if tp_sharded(shapes[k], mesh.tp)]
    if not names:
        return params
    parts = mesh.tp_all_gather(torch.cat([params[k].reshape(-1) for k in names]))
    parts = parts.view(mesh.tp, -1)
    out, offset = dict(params), 0
    for k in names:
        n = params[k].numel()
        out[k] = parts[:, offset:offset + n].reshape(shapes[k])
        offset += n
    return out


# The fields the reference's ``shard_ppo_state`` reads (srl_tpu/parallel/
# mesh.py:76-91; the port's states draw from a generator, not a ``key``).
PPO_STATE_FIELDS = ("params", "opt_state", "vstate", "obs", "obs_norm", "update_idx")


def shard_ppo_state(state, mesh: Mesh):
    """A training state laid out on ``mesh``, as the reference's
    ``shard_ppo_state`` lays out any state with the fields it reads: PPO2's
    and PPO1's, A2C's and TRPO's ``PPOState``, the recurrent agents'
    ``RecurrentPPOState``, ``ACERState`` and ``RecurrentACERState``. The
    rank keeps its rows of the env batch: the vector env's state and the
    observations, the recurrent states' ``done`` and carry, and ACER's
    segment store (its env axis, ``env_rows``); and its tp shards of the
    parameters, of the optimizer's moments and of ACER's average policy
    (``shard_params``). Counters and the normalizer stay whole.
    ``agent.train_iteration`` then trains over the mesh. Any other state
    (ACKTR's, DQN's, SAC's, DDPG's) raises a ValueError: the reference's
    ``shard_ppo_state`` fails on it with an AttributeError."""
    from srl_tpu_torch.core.env import take_rows

    missing = [f for f in PPO_STATE_FIELDS + ("mesh",) if not hasattr(state, f)]
    if missing:
        raise ValueError(
            f"shard_ppo_state cannot lay out a {type(state).__name__}: it has no "
            f"{', '.join(missing)}, and the reference's shard_ppo_state fails on such a "
            f"state with an AttributeError")
    if state.mesh is not None:
        raise ValueError("the state is laid out on a mesh already")
    lo, hi = mesh.env_slice(state.obs.shape[0])
    fields = dict(vstate=take_rows(state.vstate, lo, hi), obs=state.obs[lo:hi],
                  params=shard_params(state.params, mesh),
                  opt_state=shard_params(state.opt_state, mesh), mesh=mesh)
    if hasattr(state, "lstm_state"):
        fields.update(done=state.done[lo:hi],
                      lstm_state=tuple(x[lo:hi] for x in state.lstm_state))
    if hasattr(state, "avg_params"):
        fields.update(avg_params=shard_params(state.avg_params, mesh),
                      buffer=state.buffer.env_rows(lo, hi))
    return dataclasses.replace(state, **fields)
