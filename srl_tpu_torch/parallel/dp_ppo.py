"""An agent over the ranks of a ``torch.distributed`` world, on a dp x tp
mesh: PPO2 (the default), or with ``--algo`` and ``--policy`` PPO1, A2C,
TRPO, ACER, and with an lstm policy the recurrent PPO2, A2C and ACER: every
agent whose state ``parallel.shard_ppo_state`` lays out.

    torchrun --nproc-per-node 4 -m srl_tpu_torch.parallel.dp_ppo \\
        --env KukaButtonGymEnv-v0 --render-scale 2 --coarse-obs --num-envs 1024 --updates 20

    torchrun --nproc-per-node 2 -m srl_tpu_torch.parallel.dp_ppo --tp 2 --backend gloo \\
        --env MobileRobotGymEnv-v0 --srl-model raw_pixels --num-envs 256 --updates 2

    torchrun --nproc-per-node 2 -m srl_tpu_torch.parallel.dp_ppo --algo acer \\
        --policy cnnlstm --backend gloo --env MobileRobotGymEnv-v0 --srl-model raw_pixels \\
        --num-envs 256 --n-steps 4 --updates 5

Every process joins the world (``distributed.initialize``: NCCL on cards;
gloo with ``--device cpu``, or ``--backend gloo`` for card tensors through
host memory, as two ranks on one card need), builds the agent with its
default config (``--n-steps``, ``--nminibatches`` and ``--noptepochs``
replace the config's where given) for the global batch of ``--num-envs``,
lays its state out on the mesh of every rank, ``--tp`` ranks to a tp group
(``shard_ppo_state``), and trains ``--updates`` updates (ACER: iterations).
Started alone (no ``MASTER_ADDR``), it trains the same batch in one process.
Flags it does not know build the env as the training CLI's do (``--env``,
``--srl-model``, ``--mixed-envs``, ``--render-scale``, ``--coarse-obs``,
...).

Each rank prints one line ``DP_PPO {json}``: each update's loss under its
name (``loss_metric``: ``pg_loss``, TRPO's ``kl``, ACER's ``loss_policy``),
the whole parameters' sum of squares, env-steps/s of the global batch and of
the rank's rows, the seconds of the world's and dp group's collectives per
update and, apart, of the tp group's (the weight gathers and the norm's
sums), ``state_mb`` (the bytes of the rank's parameters, optimizer moments
and ACER's average policy), the render kernels' launches while training and
the card's peak memory. With
``--fingerprint-steps K`` it first steps a fresh env batch K times with the
actions ``(global env index + step) % n_actions`` and keeps each step's
rewards, dones and a fingerprint of each env's observation (a frame's
bytes weighted by their position, summed exactly in float64); ``--out DIR``
saves those, the final parameters (``leaves``: each one's name and size in
the flat vector) and the first gradient the agent hands on
(``BaseRLAgent.grad_probe``; with tp > 1 none: a rank holds shards) to
``DIR/rank{r}.pt``.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import time
from typing import Optional

import torch

from srl_tpu_torch.agents.ppo import PPOConfig
from srl_tpu_torch.agents.registry import resolve_policy_class
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import take_rows
from srl_tpu_torch.experiments import train as train_cli
from srl_tpu_torch.ops import launches, reset_launches
from srl_tpu_torch.parallel import distributed, shard_ppo_state
from srl_tpu_torch.utils import trace

# The mesh's spans: the world's and dp group's collectives, the tp group's.
COLLECTIVES = ("mesh.all_reduce", "mesh.all_gather", "mesh.any")
TP_COLLECTIVES = ("mesh.tp_all_reduce", "mesh.tp_all_gather")
# The algos whose state shard_ppo_state lays out (with an lstm policy: the
# recurrent PPO2, A2C and ACER), and the loss each update reports under
# ``loss_metric`` (every scalar metric is kept too).
ALGOS = ("ppo2", "ppo1", "a2c", "trpo", "acer")
LOSS_METRIC = {"trpo": "kl", "acer": "loss_policy"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="An agent data-parallel over the ranks of a torch.distributed world",
        epilog="Other flags build the env as the training CLI's do.")
    p.add_argument("--algo", default="ppo2", choices=ALGOS)
    p.add_argument("--policy", default="auto",
                   help="as the training CLI's; an lstm policy selects the recurrent agent")
    p.add_argument("--num-envs", type=int, default=256, help="the global env batch")
    p.add_argument("--updates", type=int, default=2)
    p.add_argument("--n-steps", type=int, default=None,
                   help=f"default: the agent's (PPO2 {PPOConfig.n_steps})")
    p.add_argument("--nminibatches", type=int, default=None,
                   help="PPO2, PPO1 and the recurrent PPO2; default: the agent's")
    p.add_argument("--noptepochs", type=int, default=None,
                   help="PPO2, PPO1 and the recurrent PPO2; default: the agent's")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tp", type=int, default=1,
                   help="ranks to a tp group, each holding 1/tp of the weights' output "
                        "features; dp is the world size over tp")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--timeout", type=float, default=300.0,
                   help="seconds the rendezvous and each collective may wait")
    p.add_argument("--fingerprint-steps", type=int, default=0,
                   help="first step a fresh batch this many times with fixed actions "
                        "(discrete action spaces)")
    p.add_argument("--out", default=None, help="directory for rank{r}.pt")
    p.add_argument("--start-after", default=None, metavar="FILE",
                   help="once in the world, wait for FILE to exist before the job (a "
                        "launcher that starts the processes early gives the signal)")
    return p


def make_agent(args, env_argv, device):
    """The ``--algo``/``--policy`` agent with its default config, the
    config's depth replaced where the flags give it."""
    env = train_cli.build_env(train_cli.parse_args(env_argv), device)
    cls = resolve_policy_class(args.algo, args.policy)
    agent = cls(env=env, num_envs=args.num_envs, policy=args.policy, device=device)
    depth = {k: v for k, v in (("n_steps", args.n_steps), ("nminibatches", args.nminibatches),
                               ("noptepochs", args.noptepochs)) if v is not None}
    unknown = set(depth) - {f.name for f in dataclasses.fields(agent.config)}
    if unknown:
        raise ValueError(f"{cls.__name__} has no {', '.join(sorted(unknown))}")
    agent.config = dataclasses.replace(agent.config, **depth)
    return agent


def _fingerprint(obs: torch.Tensor) -> torch.Tensor:
    """[n] exact float64 fingerprints of uint8 frames, else the observations
    themselves as float64 [n, d]."""
    flat = obs.reshape(obs.shape[0], -1)
    if obs.dtype != torch.uint8:
        return flat.double()
    weights = torch.arange(flat.shape[1], device=obs.device, dtype=torch.float64) % 251 + 1
    return (flat.double() * weights).sum(1)


@torch.no_grad()
def env_fingerprints(agent: PPO2, mesh, seed: int, steps: int) -> dict:
    """Rewards, dones and observation fingerprints of ``steps`` steps of a
    fresh batch with fixed actions: this rank's rows of the one-process
    run's, bit for bit."""
    vec = agent.vec_env
    gen = torch.Generator(device=agent.device).manual_seed(seed)
    vstate, obs = vec.reset(gen)
    lo, hi = (0, vec.num_envs) if mesh is None else mesh.env_slice(vec.num_envs)
    vstate, obs = take_rows(vstate, lo, hi), obs[lo:hi]
    n_actions = agent.env.action_space.n
    out = {"reward": [], "done": [], "obs": [_fingerprint(obs)]}
    for i in range(steps):
        actions = (torch.arange(vec.num_envs, device=agent.device) + i) % n_actions
        vstate, tr = vec.step(vstate, actions[lo:hi], gen, mesh=mesh)
        out["reward"].append(tr.reward)
        out["done"].append(tr.done)
        out["obs"].append(_fingerprint(tr.obs))
    return {k: torch.stack(v).cpu() for k, v in out.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def state_mb(state) -> float:
    """MB (1e6 bytes) of the parameters, the optimizer's moments and ACER's
    average policy a state holds."""
    trees = [state.params, getattr(state, "avg_params", {})]
    trees += [v for v in state.opt_state.values() if isinstance(v, dict)]
    return sum(v.numel() * v.element_size() for t in trees for v in t.values()) / 1e6


def train(agent, mesh, seed: int, updates: int) -> dict:
    """``updates`` updates from seed ``seed`` on ``mesh`` (or in one
    process): per-update loss (under its name) and every scalar metric,
    seconds and collective seconds (the tp
    group's apart), the final whole flat parameters, the state's MB and the
    kernels' launches while training (the counts set to 0 after the initial
    reset) and the first gradient of each site (``grad_probe``). The
    tracer's detail mode is on while it trains, so that the collectives'
    spans are their own time (``parallel.mesh.Mesh``)."""
    was_detailed = trace.detail()
    trace.enable()
    try:
        return _train(agent, mesh, seed, updates)
    finally:
        if not was_detailed:
            trace.disable()


def _train(agent, mesh, seed: int, updates: int) -> dict:
    agent.n_updates = updates
    agent.grad_probe = {}
    gen = torch.Generator(device=agent.device).manual_seed(seed)
    reset_launches()
    state = agent.init_state(gen, seed)
    init_launches = launches()
    params0 = torch.cat([v.reshape(-1) for v in state.params.values()]).cpu()
    if mesh is not None:
        state = shard_ppo_state(state, mesh)
        if agent.device.type == "cuda":
            torch.cuda.empty_cache()  # the whole batch's state (ACER: its store) is gone
    reset_launches()
    metric = LOSS_METRIC.get(agent.name, "pg_loss")
    losses, seconds, collective_s, tp_collective_s, scalars = [], [], [], [], {}

    def clock():
        spent = trace.totals()["seconds"]
        return (sum(spent.get(k, 0.0) for k in COLLECTIVES),
                sum(spent.get(k, 0.0) for k in TP_COLLECTIVES))

    for _ in range(updates):
        _sync(agent.device)
        t0, (c0, tp0) = time.perf_counter(), clock()
        state, metrics = agent.train_iteration(state, gen)
        losses.append(float(metrics[metric]))
        for k, v in metrics.items():
            if v.dim() == 0:
                scalars.setdefault(k, []).append(float(v))
        _sync(agent.device)
        seconds.append(time.perf_counter() - t0)
        c1, tp1 = clock()
        collective_s.append(c1 - c0)
        tp_collective_s.append(tp1 - tp0)
    whole = agent.whole_params(state.params, mesh)
    params = torch.cat([v.reshape(-1) for v in whole.values()]).cpu()
    grads0 = agent.grad_probe if mesh is None or mesh.tp == 1 else None
    agent.grad_probe = None
    return {metric: losses, "loss_metric": metric, "metrics": scalars, "seconds": seconds,
            "collective_s": collective_s, "tp_collective_s": tp_collective_s, "state_mb": state_mb(state),
            "params0": params0, "params": params, "grads0": grads0,
            "leaves": [(k, v.numel()) for k, v in whole.items()],
            "param_sq": float(params.double().square().sum()),
            "rows": int(state.obs.shape[0]), "init_launches": init_launches,
            "launches": launches(),
            "mean_reward_per_step": float(metrics["mean_reward_per_step"])}


def run(args, env_argv, mesh=None) -> dict:
    """The whole job on this rank (``mesh`` None: one process)."""
    device = resolve_device(args.device)
    agent = make_agent(args, env_argv, device)
    result = {"agent": type(agent).__name__, "rank": 0 if mesh is None else mesh.rank,
              "dp": 1 if mesh is None else mesh.dp, "tp": 1 if mesh is None else mesh.tp,
              "backend": None if mesh is None else mesh.backend,
              "family_counts": getattr(agent.vec_env, "counts", None)}
    if args.fingerprint_steps:
        result["fingerprints"] = env_fingerprints(agent, mesh, args.seed, args.fingerprint_steps)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    result.update(train(agent, mesh, args.seed, args.updates))
    steps = agent.config.n_steps * args.num_envs
    result["env_steps_per_s"] = steps * len(result["seconds"]) / sum(result["seconds"])
    result["rank_env_steps_per_s"] = result["env_steps_per_s"] * result["rows"] / args.num_envs
    result["peak_mem_gb"] = (torch.cuda.max_memory_allocated(device) / 2**30
                             if device.type == "cuda" else None)
    return result


def summary(result: dict) -> dict:
    """The printable part of a result."""
    return {k: v for k, v in result.items()
            if k not in ("params0", "params", "grads0", "fingerprints")}


def _wait_for(path: str, seconds: float) -> None:
    deadline = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {seconds} s")
        time.sleep(0.05)


def main(argv: Optional[list] = None) -> dict:
    args, env_argv = build_parser().parse_known_args(argv)
    # float32 matmuls and convolutions in full precision, as the training
    # CLI runs them (the reference's float32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    joined = distributed.initialize(device=args.device, backend=args.backend,
                                    timeout=datetime.timedelta(seconds=args.timeout))
    if args.tp > 1 and not joined:
        raise ValueError(f"--tp {args.tp} needs a world of processes (torchrun, or "
                         f"MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    try:
        mesh = distributed.make_global_mesh(tp=args.tp) if joined else None
        if mesh is not None:
            distributed.warmup_collectives(mesh)
        if args.start_after:
            _wait_for(args.start_after, args.timeout)
        result = run(args, env_argv, mesh)
        if args.out is not None:
            os.makedirs(args.out, exist_ok=True)
            torch.save(result, os.path.join(args.out, f"rank{result['rank']}.pt"))
        print("DP_PPO " + json.dumps(summary(result)), flush=True)
    finally:
        if joined:
            torch.distributed.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
