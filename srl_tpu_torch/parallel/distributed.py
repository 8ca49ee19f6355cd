"""Multi-process wiring on ``torch.distributed`` (counterpart of
srl_tpu/parallel/distributed.py).

The reference joins hosts into one JAX runtime. Here each process is one
rank of a process group, on one card (NCCL) or on the CPU or a card through
host memory (gloo), and the dp x tp mesh spans every rank.

Usage on every process, as ``torchrun`` starts them (it sets
``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``)::

    from srl_tpu_torch.parallel import distributed as dist, shard_ppo_state
    dist.initialize()                       # env-var driven; no-op for one process
    mesh = dist.make_global_mesh(tp=tp)     # every rank; dp = world size / tp
    dist.warmup_collectives(mesh)
    agent = PPO2(env=env, num_envs=global_num_envs, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)   # alike on every rank
    state = shard_ppo_state(agent.init_state(gen, seed), mesh)
    state, metrics = agent.train_iteration(state, gen)

``srl_tpu_torch.parallel.dp_ppo`` is that script. Every random draw is made
for the whole batch and each rank keeps its dp index's rows of it, so
trajectories do not depend on the process count; with ``tp > 1`` the ranks
of a tp group step the same rows and each holds its tp shard of the weights
(``parallel/mesh.py``).
"""
from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.parallel.mesh import Mesh, env_rows, make_mesh

# init_process_group's timeout: the rendezvous and every collective after it.
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
    timeout: datetime.timedelta = DEFAULT_TIMEOUT,
) -> bool:
    """Join the default process group. ``coordinator_address``
    ("host:port"), ``num_processes`` and ``process_id`` default to
    ``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. The
    backend is NCCL for ``device`` "cuda" and gloo for "cpu" unless
    ``backend`` names one (gloo also takes card tensors, through host
    memory); on a card, the process uses card ``LOCAL_RANK`` (0 by default).
    Returns True when a group of processes is (or already was) set up, False
    for the one-process no-op: no address and at most one process."""
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")
    if coordinator_address is None and num_processes in (None, 1):
        return dist.is_initialized() and dist.get_world_size() > 1
    if dist.is_initialized():
        return True
    if num_processes is None or process_id is None:
        raise ValueError(f"joining {coordinator_address} needs num_processes and "
                         f"process_id (WORLD_SIZE and RANK)")
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else _int_env("LOCAL_RANK") or 0)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=timeout)
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v is not None else None


def make_global_mesh(dp: Optional[int] = None, tp: int = 1, *, group=None,
                     new_group=None) -> Mesh:
    """dp x tp mesh over every rank of the default group (or ``group``).
    Ranks are processes, in rank order, so each host's ranks lie
    contiguous along ``dp`` under ``torchrun``: the env batch shards
    host-locally and only the reductions cross hosts. With dp and tp both
    above 1, every rank makes every dp and tp sub-group with
    ``torch.distributed.new_group``, in one order (``mesh.make_mesh``; a
    ``group`` other than the default world passes ``new_group``)."""
    return make_mesh(None, dp, tp, group=group, new_group=new_group)


def warmup_collectives(mesh: Mesh, device=None) -> None:
    """One all-reduce of a zero tensor over each of the mesh's groups (the
    world, the dp group, the tp group), right after it is made, while the
    processes are still in step: a backend that connects on first use then
    does so before per-process work (an env reset, a kernel build) can put
    the processes further apart than its handshake waits. ``device``: the
    card for NCCL, else the CPU."""
    if device is None:
        device = torch.cuda.current_device() if mesh.backend == "nccl" else "cpu"
    mesh.any(torch.zeros(1, dtype=torch.bool, device=device))
    mesh.all_reduce_(torch.zeros(1, device=device))
    mesh.tp_all_reduce_(torch.zeros(1, device=device))


def local_env_slice(
    global_num_envs: int,
    process_id: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[int, int]:
    """[lo, hi) of the global env batch owned by this process (the default
    group's rank and size, or 0 of 1 without one). The global env index
    draws each env's random numbers, so trajectories are independent of the
    process count."""
    initialized = dist.is_initialized()
    pid = (dist.get_rank() if initialized else 0) if process_id is None else process_id
    pc = (dist.get_world_size() if initialized else 1) if process_count is None else process_count
    return env_rows(global_num_envs, pid, pc)
