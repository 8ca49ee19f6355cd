"""A cell on a dp x tp mesh: one process per card, started, watched and
ended by the run's own process.

``launch`` is the launcher's side. It holds a ``torch.distributed.TCPStore``
of its own (the harness's, apart from the program's process groups), picks a
free port for the program's group, and starts ``dp x tp`` copies of a script
(``run.py`` or ``calibrate.py``) with ``--rank r``: rank ``r`` on card ``r``,
with ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK`` set as ``torchrun`` sets them. A rank talks to it in lines on
its standard output: ``BENCH_OUT <text>`` (printed on the launcher's
standard output as it comes) and ``BENCH_RESULT <json>`` (rank 0's result,
handed back once every rank has ended with code 0); other lines go to the
launcher's standard error, and a rank's standard error is the launcher's.

It never waits on a rank that cannot finish, as ``torchrun``'s agent does:
when a rank ends with another code than 0, every rank is killed (its whole
process group) at once and ``launch`` returns 1 with no result. Every
collective, the program's (NCCL or gloo) and the harness's, and every wait
on the store, gives up after ``COLLECTIVE_S`` seconds and ends its rank
with an error, so a rank that hangs or dies leaves the others blocked in a
collective at most that long: the run ends, with no result, within
``COLLECTIVE_S`` of the last collective that the lost rank missed.

``Ranks`` is a rank's side: the harness's own gloo group on the launcher's
store, for the window's start, stop and end, the check's sums over the ranks
and the gathering of each rank's readings on rank 0. ``join`` makes it and
then the program's mesh, as ``srl_tpu_torch/parallel/dp_ppo.py`` does:
``distributed.initialize`` (NCCL on cards), ``make_global_mesh``,
``warmup_collectives``."""
from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import queue
import signal
import socket
import subprocess
import sys
import threading

import torch

# The longest a collective (the program's or the harness's) may wait.
COLLECTIVE_S = 120.0
HOST = "127.0.0.1"
OUT, RESULT = "BENCH_OUT", "BENCH_RESULT"


def add_rank_args(parser: argparse.ArgumentParser) -> None:
    """The arguments ``launch`` gives a rank (not for a user)."""
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--store", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--options", default="{}", help=argparse.SUPPRESS)


def world_of(traffic: dict) -> int:
    return int(traffic["dp"]) * int(traffic["tp"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind((HOST, 0))
        return s.getsockname()[1]


def _pump(rank: int, stream, lines: queue.Queue) -> None:
    for line in stream:
        lines.put((rank, line.rstrip("\n")))
    lines.put((rank, None))


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for p in procs:
        p.wait()


def launch(script: str, argv: list, world: int, options: dict = None,
           t0: float = None):
    """(exit code, rank 0's ``BENCH_RESULT`` or None): ``world`` ranks of
    ``python3 script argv... --rank r ...`` run to their end, or every one
    killed (module docstring). ``options`` (JSON to each rank): ``device``
    ("cuda", the default: rank r on card r, the program's group on NCCL;
    "cpu": gloo) and ``overrides`` (traffic entries, for small runs).
    ``t0``: the run's start on the system's monotonic clock
    (``time.perf_counter``)."""
    store = torch.distributed.TCPStore(HOST, 0, is_master=True, wait_for_workers=False,
                                       timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    env = dict(os.environ, MASTER_ADDR=HOST, MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world))
    # One loopback interface for every socket the ranks open, and each rank
    # threads for its share of the cores.
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    env.setdefault("OMP_NUM_THREADS", str(max(1, len(os.sched_getaffinity(0)) // world)))
    extra = ["--store", f"{HOST}:{store.port}", "--options", json.dumps(options or {})]
    if t0 is not None:
        extra += ["--t0", repr(t0)]
    lines = queue.Queue()
    procs = []
    previous = signal.getsignal(signal.SIGTERM)

    def ended(signum, frame):
        raise SystemExit(128 + signum)

    signal.signal(signal.SIGTERM, ended)
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, script, *argv, "--rank", str(r), *extra],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), stdout=subprocess.PIPE,
                text=True, start_new_session=True))
            threading.Thread(target=_pump, args=(r, procs[-1].stdout, lines),
                             daemon=True).start()
        return _watch(procs, lines)
    finally:
        _kill(procs)
        signal.signal(signal.SIGTERM, previous)
        del store


def _watch(procs, lines: queue.Queue):
    open_streams = len(procs)
    result = None
    while True:
        try:
            rank, line = lines.get(timeout=0.2)
        except queue.Empty:
            rank, line = None, ""
        if rank is not None:
            if line is None:
                open_streams -= 1
            elif line.startswith(OUT + " "):
                print(line[len(OUT) + 1:], flush=True)
            elif line.startswith(RESULT + " ") and rank == 0:
                result = json.loads(line[len(RESULT) + 1:])
            else:
                print(f"[rank {rank}] {line}", file=sys.stderr, flush=True)
        codes = [p.poll() for p in procs]
        failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if failed:
            r, c = failed[0]
            _kill(procs)
            print(f"rank {r} ended with code {c}: every rank was stopped", file=sys.stderr)
            return 1, None
        if all(c == 0 for c in codes) and open_streams == 0:
            if result is None:
                print("the ranks ended without a result", file=sys.stderr)
                return 1, None
            return 0, result


class Ranks:
    """The harness's collectives among the ranks of one run, on a gloo group
    of the launcher's store (never the program's ``Mesh``). Host tensors
    only: a card's tensor is copied over and back."""

    def __init__(self, store_address: str, rank: int, world: int,
                 timeout_s: float = COLLECTIVE_S):
        host, port = store_address.rsplit(":", 1)
        timeout = datetime.timedelta(seconds=timeout_s)
        self.store = torch.distributed.TCPStore(host, int(port), is_master=False,
                                                timeout=timeout)
        self.group = torch.distributed.ProcessGroupGloo(
            torch.distributed.PrefixStore("bench", self.store), rank, world, timeout)
        self.rank, self.world = rank, world
        self.rows = None  # (lo, hi, global envs) of this rank, once the mesh is made

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        host = t.detach().to("cpu", torch.float64).contiguous().clone()
        opts = torch.distributed.AllreduceOptions()
        opts.reduceOp = op
        self.group.allreduce([host], opts).wait()
        return host

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (in float64), as ``t``'s dtype and device."""
        return self._reduce(t, torch.distributed.ReduceOp.SUM).to(t.device, t.dtype)

    def barrier(self) -> None:
        self._reduce(torch.zeros(1), torch.distributed.ReduceOp.SUM)

    def all(self, flag: bool) -> bool:
        """Whether ``flag`` holds on every rank."""
        return bool(self._reduce(torch.tensor([float(flag)]), torch.distributed.ReduceOp.MIN))

    def rank0(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        return bool(self.sum(torch.tensor([float(flag) if self.rank == 0 else 0.0])))

    def worst(self, values: dict) -> dict:
        """Each number the largest over the ranks (a non-number reads as
        infinity); ``resets_checked`` the sum."""
        keys = sorted(values)
        own = [values[k] if k == "resets_checked" or math.isfinite(values[k]) else math.inf
               for k in keys]
        most = self._reduce(torch.tensor(own), torch.distributed.ReduceOp.MAX).tolist()
        total = self.sum(torch.tensor([float(values.get("resets_checked") or 0)]))
        out = dict(zip(keys, most))
        if "resets_checked" in values:
            out["resets_checked"] = int(total)
        return out

    def gather(self, name: str, obj):
        """Every rank's JSON-able ``obj`` on rank 0, in rank order (None
        elsewhere)."""
        self.store.set(f"{name}/{self.rank}", json.dumps(obj))
        if self.rank != 0:
            return None
        return [json.loads(self.store.get(f"{name}/{r}")) for r in range(self.world)]


def join(args, cell):
    """(device, the harness's ``Ranks``, the program's mesh) of this rank:
    the harness's group, then the program's world and mesh."""
    from srl_tpu_torch.parallel import distributed

    options = json.loads(args.options)
    where = options.get("device", "cuda")
    device = torch.device(f"cuda:{args.rank}" if where == "cuda" else where)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ranks = Ranks(args.store, args.rank, world_of(cell.traffic))
    distributed.initialize(device=str(device),
                           timeout=datetime.timedelta(seconds=COLLECTIVE_S))
    mesh = distributed.make_global_mesh(tp=int(cell.traffic["tp"]))
    distributed.warmup_collectives(mesh)
    return device, ranks, mesh


def leave() -> None:
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
