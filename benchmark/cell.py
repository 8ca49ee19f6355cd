"""One cell of the benchmark in one process: set-up, the timed window, the
traced window and the check.

The program under test is ``srl_tpu_torch``: its env is built as the
training CLI builds it (``experiments/train.make_with_options``), its agent
class comes from the agent registry, and the window calls the agent's
``train_iteration`` in a loop, as ``BaseRLAgent._run`` does. The benchmark
makes the weights from the seed on the device with the cell's network
(``reference/<network>.py``: its layout and scales) and hands the trained
ones to the program through its fine-tuning start (``agent.pretrained``);
a frozen stage that lives in the program's env is built into the env and
handed its leaves by ``handin/<network>.py``.

On a dp mesh (``mesh``, the program's ``parallel.mesh.Mesh``; ``ranks``, the
harness's own collectives, ``ranks.py``) each rank builds the agent for the
global batch, lays its first state out on the mesh (``shard_ppo_state``)
and records its own rows; every rank runs the same updates, and rank 0's
clock ends the window."""
from __future__ import annotations

import time
import types

import torch

from reference import vec_env as ref_env
from record import Recorder
from tracing import Spans, profiled_update, sync

# Rollout steps whose frames the check compares, besides the first state's.
FRAME_STEPS = 8


def build(cell, device, overrides=None):
    """The program's agent of ``cell`` (its traffic updated with
    ``overrides``, for small rehearsals)."""
    from srl_tpu_torch.agents.registry import resolve_policy_class
    from srl_tpu_torch.experiments.train import make_with_options

    cfg, traffic = cell.config, {**cell.traffic, **(overrides or {})}
    cell.traffic = traffic
    # As the training CLI states it: float32 matmuls and convolutions stay
    # float32 (the policy's convolutions and fc512 run in bfloat16).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cell.handin is None:
        env = make_with_options(cfg["env_id"], cfg["env_options"])
    else:
        env = cell.handin.make_env(cfg, device)
    cls = resolve_policy_class(cfg["algo"], cfg["policy"])
    algo = {**cfg["algo_config"], **{k: traffic[k] for k in
                                     ("n_steps", "nminibatches", "noptepochs")}}
    agent = cls(env=env, num_envs=traffic["num_envs"], policy=cfg["policy"],
                config=cls.config_class(**algo), device=device)
    # The lr anneal's horizon: a run of ``total_timesteps``.
    agent.n_updates = max(1, cfg["total_timesteps"] // (algo["n_steps"] * traffic["num_envs"]))
    return agent


def weights(cell, agent, seed: int, device) -> dict:
    """Every leaf of ``seed``, in the reference's layout, after checking
    that the program's policy parameters are the trained leaves, by name and
    shape, and that the program normalizes observations where the
    configuration says so; a frozen stage's leaves are handed to the
    program's env here, before anything records or patches the agent."""
    cfg, net = cell.config, cell.network
    shapes = net.param_shapes(cfg)
    trained = {k: s for k, s in shapes.items() if net.trained(k)}
    program = {k: tuple(v.shape) for k, v in agent.policy.state_dict().items()}
    if program != trained or agent.input_scale != cfg.get("input_scale", 1):
        raise ValueError(f"the program's parameters {program} are not the "
                         f"reference's {trained}")
    if agent.normalize_obs != cfg.get("normalize_obs", False):
        raise ValueError(f"the program normalizes observations: {agent.normalize_obs}; "
                         f"the configuration: {cfg.get('normalize_obs', False)}")
    params = net.init_params(shapes, seed, device)
    frozen = {k: v for k, v in params.items() if not net.trained(k)}
    if frozen:
        cell.handin.hand_in(agent, frozen)
    return params


def start(agent, params0, seed: int, recorder=None, mesh=None):
    """The program's first state from ``seed``: its generator, the reset
    batch and the trained leaves of ``params0`` (laid out on ``mesh``); the
    program's normalizer starts fresh."""
    gen = agent._start(seed)
    policy = agent.policy.state_dict()
    agent.pretrained = types.SimpleNamespace(
        params={k: v for k, v in params0.items() if k in policy}, obs_norm=None)
    state = agent.init_state(gen, seed)
    agent.pretrained = None
    if mesh is not None:
        from srl_tpu_torch.parallel import shard_ppo_state

        state = shard_ppo_state(state, mesh)
    if recorder is not None:
        recorder.note_start(state)
    return state, gen


def frame_steps(seed: int, n_steps: int) -> list:
    gen = torch.Generator()
    gen.manual_seed(seed)
    k = min(FRAME_STEPS, n_steps)
    return sorted(torch.randperm(n_steps, generator=gen)[:k].tolist())


def rows(agent, mesh):
    """[lo, hi) of the env batch that this process steps (None: all)."""
    return None if mesh is None else mesh.env_slice(agent.vec_env.num_envs)


def first_update(agent, params0, seed: int, gae, mesh=None):
    """(state after the first update, its generator, the recorder of it);
    ``gae``: the config's (module, attribute) of the GAE the update calls."""
    rec = Recorder(agent, frame_steps(seed, agent.config.n_steps), tuple(gae),
                   rows=rows(agent, mesh))
    with rec:
        state, gen = start(agent, params0, seed, rec, mesh)
        state, _ = agent.train_iteration(state, gen)
    if not rec.complete():
        raise RuntimeError("the first update did not go through the recorded calls")
    return state, gen, rec


def window(agent, state, gen, seconds: float, device, ranks=None):
    """Whole updates until ``seconds`` have passed, then a synchronise:
    (state, updates, seconds from the start to the end of the last, the
    host's time at the end of each update from the start, for a look: the
    update's own synchronisations keep the host close behind the device).
    With ``ranks`` the window starts and ends on a barrier of the ranks
    after each has synchronised its card, and every rank stops after the
    update in which rank 0's clock passed ``seconds``."""
    sync(device)
    if ranks is not None:
        ranks.barrier()
    marks = []
    t0 = time.perf_counter()
    updates = 0
    while True:
        state, _ = agent.train_iteration(state, gen)
        updates += 1
        elapsed = time.perf_counter() - t0
        marks.append(elapsed)
        done = elapsed >= seconds
        if ranks is not None:
            done = ranks.rank0(done)
        if done:
            break
    sync(device)
    if ranks is not None:
        ranks.barrier()
    return state, updates, time.perf_counter() - t0, marks


def check_updates_cap(cell) -> int:
    """Updates in which every env ends an episode at least once, wherever
    they start: the reference env's longest episode in updates."""
    env = ref_env.make_env(cell.config["env_id"], cell.config["env_options"])
    return -(-(env.max_steps + 1) // cell.traffic["n_steps"])


def check_update(agent, state, gen, gae, cap: int, mesh=None, ranks=None):
    """(state, the record of the first update after the window in which an
    episode ended, the updates run): recorded updates of the program's own
    state, at most ``cap``; the last one's record where none held an end.
    With ``ranks``, the first in which an episode ended on every rank."""
    for k in range(1, cap + 1):
        rec = Recorder(agent, FRAME_STEPS, tuple(gae), rollout_only=True,
                       rows=rows(agent, mesh))
        with rec:
            rec.note_start(state)
            state, _ = agent.train_iteration(state, gen)
        if not rec.complete():
            raise RuntimeError("the update after the window did not go through the "
                               "recorded calls")
        ended = rec.dones() > 0
        if ranks is not None:
            ended = ranks.all(ended)
        if ended:
            break
    return state, rec, k


def profiled(agent, state, gen, spans: dict, device):
    """(state, profile) of one update under ``torch.profiler``, with the
    benchmark's spans marking the layers in the trace."""
    holder = {"state": state}

    def one_update():
        holder["state"], _ = agent.train_iteration(holder["state"], gen)

    with Spans(agent, spans, device):
        profile = profiled_update(one_update, device)
    return holder["state"], profile
