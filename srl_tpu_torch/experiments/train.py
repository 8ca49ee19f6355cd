"""Training entry point (counterpart of srl_tpu/experiments/train.py).

The reference CLI for all twelve of its agents (``--algo
ppo2|ppo1|a2c|trpo|acktr|acer|deepq|sac|ddpg|ars|cma-es|random_agent`` from
``agents/registry``, and ``--policy lstm|lnlstm|cnnlstm|cnnlnlstm`` for
ppo2, a2c, acer and acktr, routed to the Recurrent* agents by
``resolve_policy_class``) on every registered env (Kuka, MobileRobot,
Omnirobot, CarRacing) with every ``--srl-model`` of the registry, optionally
with ``--num-stack`` frames, or on a mixed batch of env families
(``--mixed-envs``: one learner over contiguous per-family slices,
``core/mixed_env.py``; differing action counts fold modulo each family's,
with a warning). Every env gets the options it takes (found by signature, as
the reference does). A learned model (type SRL) is resolved as the
reference resolves it: ``--latest`` takes the newest
``srl_logs/{env}/**/srl_model.pkl``, else ``--srl-config-file`` names its
checkpoint under the env's ``log_folder``; the env (each family of a mixed
batch) is then wrapped in ``SRLEncodedEnv`` (render -> encode) before any
frame stacking. SAC and DDPG take continuous actions only (``-c``; without
it the reference's AssertionError), deepq discrete ones only.

The algo's config is its defaults, then the CLI flags that name a config
field (A2C's ``--lr-schedule``), then ``--hyperparam name:value``; the agent
gets ``--num-envs`` and ``--policy`` where its constructor takes them (ARS
and CMA-ES run one env per population member and ignore ``--num-envs``, as
in the reference). The run
directory has the reference's layout, ``{log-dir}/{env}/{srl_model}/{algo}/
{datetime}/`` with ``args.json``, ``env_globals.json``, ``0.monitor.csv``,
``metrics.jsonl`` (a line per callback, the losses included),
``{algo}_model.pkl`` (best mean reward over the last 100 episodes, once
``--min-episodes-save`` have finished) and ``{algo}_final_model.pkl``, which
the reference's agents load. ``--checkpoint-interval N`` writes the whole
training state every N updates (``checkpoint.pkl``, readable by either
package), and ``--resume LOG_DIR`` continues that run in place (PPO2 and
PPO1, as in the reference; the other agents' ``learn`` takes no state to
resume from, and the CLI refuses with the reference's message).
``--load-rl-model-path`` trains on from a saved policy's parameters and
normalizer (ARS: ``M`` and its normalizer; CMA-ES: the mean at the saved
``best_model``), with a fresh optimizer and env (the reference's run
discards the loaded weights: ROADMAP Queue C). The default config is the
resolved class's (the recurrent PPO2's is ``lstm_ppo_config``);
``--hyperparam`` parses against the registered class, as in the reference.
Flags reach the config only where they name a field: DQN's
``--buffer-size`` and ``--dueling``, DDPG's ``--noise-*`` and
``--batch-size`` do; DQN's ``--prioritized`` (the field is
``prioritized_replay``) and DDPG's ``--memory-limit`` (the field is
``buffer_size``) do not, so they change nothing, as in the reference
(ROADMAP Queue C). A checkpoint of ACER, DQN, SAC or DDPG holds its replay
store too: about 10 GB for ACER and 3.8 GB for SAC at the Kuka pixel run's
width (256 envs, 112x112 frames), 15 GB for DDPG at MobileRobot 224x224's.
Unless ``--no-vis``, the run's live curves are served on ``--port``
(``experiments/live_vis``; a busy port is skipped) and its
``learning_curve.png`` is drawn at most every 2 s from the callback and once
at the end (``experiments/visualize``).

Usage (the README's pixel run, the quickstart, an encoder trained by
``srl_tpu_torch.experiments.train_srl``, a resume):
  python -m srl_tpu_torch.experiments.train --env KukaButtonGymEnv-v0 \\
      --srl-model raw_pixels --algo ppo2 --num-envs 256 --render-scale 2 \\
      --coarse-obs
  python -m srl_tpu_torch.experiments.train --env MobileRobotGymEnv-v0 \\
      --srl-model ground_truth --algo ppo2 --num-envs 4096
  python -m srl_tpu_torch.experiments.train --env MobileRobotGymEnv-v0 \\
      --srl-model autoencoder --algo ppo2 --num-envs 256
  python -m srl_tpu_torch.experiments.train --env KukaButtonGymEnv-v0 \\
      --mixed-envs KukaButtonGymEnv-v0 OmnirobotEnv-v0 --srl-model raw_pixels \\
      --render-scale 2 --num-envs 256
  python -m srl_tpu_torch.experiments.train --resume LOG_DIR
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import inspect
import json
import os
import time
from datetime import datetime

import numpy as np
import torch

from srl_tpu_torch.agents import ActionType
from srl_tpu_torch.agents.base import BaseRLAgent
from srl_tpu_torch.agents.registry import registered_rl, resolve_policy_class
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.frame_stack import FrameStack
from srl_tpu_torch.core.mixed_env import MixedEnv
from srl_tpu_torch.core.spaces import Discrete
from srl_tpu_torch.envs.registry import make_env, registered_env
from srl_tpu_torch.experiments.live_vis import LiveVisServer
from srl_tpu_torch.experiments.visualize import plot_log_dir
from srl_tpu_torch.srl import SRLType
from srl_tpu_torch.srl.registry import registered_srl
from srl_tpu_torch.utils.logging import printGreen, printYellow
from srl_tpu_torch.utils.monitor import MonitorWriter
from srl_tpu_torch.utils.yaml_subset import read_yaml_subset

N_EPISODES_EVAL = 100
DEFAULT_NUM_ENVS = 16
# The reference's --policy choices.
POLICIES = ["auto", "mlp", "cnn", "lstm", "lnlstm", "cnnlstm", "cnnlnlstm"]
# args.json entries a resume keeps from its own command line (the device
# too: a run may resume on another device type).
RESUME_KEEPS = ("resume", "checkpoint_interval", "device")


def build_parser(argv=None) -> argparse.ArgumentParser:
    """The CLI's parser for ``argv``: a first pass finds ``--algo``, whose
    agent then adds its own flags (``customArguments``)."""
    parser = argparse.ArgumentParser(
        description="Train RL algorithms on the registered envs (PyTorch port)")
    parser.add_argument("--algo", default="ppo2", choices=list(registered_rl.keys()))
    parser.add_argument("--env", default="KukaButtonGymEnv-v0",
                        choices=list(registered_env.keys()))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--episode_window", "--episode-window", dest="episode_window",
                        type=int, default=40,
                        help="episodes in the mean reward of metrics.jsonl")
    parser.add_argument("--port", type=int, default=8097,
                        help="port of the live curves' server (0: any free port)")
    parser.add_argument("--log-dir", default="logs/")
    parser.add_argument("--num-timesteps", type=int, default=int(1e6))
    parser.add_argument("--srl-model", default="raw_pixels",
                        choices=list(registered_srl.keys()))
    parser.add_argument("--num-stack", type=int, default=1,
                        help="number of frames to stack")
    parser.add_argument("--render-scale", type=int, default=1, choices=[1, 2, 4, 7],
                        help="Kuka: trace at 224/s and upsample (1 = exact 224x224)")
    parser.add_argument("--coarse-obs", action="store_true",
                        help="with --render-scale 2: hand the traced 112x112 "
                        "image to the CNN, the upsample folded into conv1")
    parser.add_argument("--action-repeat", type=int, default=1)
    parser.add_argument("--srl-config-file", default="config/srl_models.yaml",
                        help="env -> {log_folder, model: checkpoint} map of the "
                        "trained SRL models")
    parser.add_argument("--hyperparam", type=str, nargs="+", default=[],
                        help="'name:value' overrides of the algo's config "
                        "(its getOptParam names)")
    parser.add_argument("--min-episodes-save", type=int, default=100,
                        help="finished episodes before the best model is saved")
    parser.add_argument("--latest", action="store_true",
                        help="use the newest trained SRL model of the env under "
                        "srl_logs/")
    parser.add_argument("--load-rl-model-path", type=str, default=None,
                        help="start from this saved policy's parameters and "
                        "normalizer (fresh optimizer and env)")
    parser.add_argument("--checkpoint-interval", type=int, default=0,
                        help="write the whole training state to checkpoint.pkl "
                        "every N updates (0 = off); enables --resume")
    parser.add_argument("--resume", type=str, default=None, metavar="LOG_DIR",
                        help="continue the run of LOG_DIR in place from its "
                        "args.json and checkpoint.pkl")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace of the training into "
                        "LOG_DIR/profile/")
    parser.add_argument("--updates-per-call", type=int, default=1,
                        help="PPO updates per callback (the episode statistics "
                        "reach the host once per call)")
    parser.add_argument("--recompute-obs", action="store_true",
                        help="pixel PPO: store env states in the rollout and "
                        "re-render each minibatch's frames in the update instead "
                        "of keeping the [T*N, H, W, 3] slab (bit-identical updates)")
    parser.add_argument("--policy", default="auto", choices=POLICIES,
                        help="network architecture")
    parser.add_argument("--shape-reward", action="store_true")
    parser.add_argument("-c", "--continuous-actions", action="store_true")
    parser.add_argument("-joints", "--action-joints", action="store_true")
    parser.add_argument("-r", "--random-target", action="store_true")
    parser.add_argument("--no-vis", action="store_true",
                        help="no live curves' server and no learning_curve.png")
    parser.add_argument("--mixed-envs", nargs="+", default=None, metavar="ENV_ID",
                        choices=list(registered_env.keys()),
                        help="train one learner on a batch of these env families, "
                        "which must share the observation space (raw_pixels at a "
                        "common shape or equal-dim SRL states); --env still names "
                        "the run directory and the SRL config entry")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    args, _ = parser.parse_known_args(argv)
    registered_rl[args.algo][0](device="cpu").customArguments(parser)
    return parser


def parse_args(argv=None):
    return build_parser(argv).parse_args(argv)


def accepted_kwargs(env_cls, kwargs: dict) -> dict:
    """The entries of ``kwargs`` that ``env_cls`` takes. Constructors that
    pass ``**kwargs`` on are followed up the class hierarchy, so a variant
    such as MobileRobot1DEnv takes its base class's options."""
    accepted = set()
    for klass in env_cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is None:
            continue
        params = inspect.signature(init).parameters.values()
        accepted.update(p.name for p in params if p.kind == p.POSITIONAL_OR_KEYWORD
                        or p.kind == p.KEYWORD_ONLY)
        if not any(p.kind == p.VAR_KEYWORD for p in params):
            break
    return {k: v for k, v in kwargs.items() if k in accepted}


def make_with_options(env_id: str, options: dict):
    """The env ``env_id`` built with the entries of ``options`` it takes."""
    return make_env(env_id, **accepted_kwargs(registered_env[env_id][0], options))


def srl_model_path(args):
    """The checkpoint of a learned ``--srl-model``, or None for a mode the
    env provides."""
    if registered_srl[args.srl_model]["type"] != SRLType.SRL:
        return None
    if args.latest:
        printYellow("Using latest srl model")
        return latest_srl_model(args)
    all_models = read_yaml_subset(args.srl_config_file) or {}
    if args.env not in all_models:
        raise KeyError(f"environment '{args.env}' not in srl config file "
                       f"'{args.srl_config_file}'")
    models = all_models[args.env]
    if args.srl_model not in models:
        raise KeyError(f"srl_model '{args.srl_model}' not in config for env {args.env}")
    return os.path.join(models.get("log_folder", ""), models[args.srl_model])


def latest_srl_model(args) -> str:
    """The newest ``srl_logs/{env}/**/srl_model.pkl`` by modification time
    (``--latest``)."""
    pattern = os.path.join("srl_logs", args.env, "**", "srl_model.pkl")
    candidates = glob.glob(pattern, recursive=True)
    if not candidates:
        raise FileNotFoundError(f"No trained SRL models found under srl_logs/{args.env}")
    return max(candidates, key=os.path.getmtime)


def build_env(args, device="cuda"):
    """The env of ``args.env``, or the ``MixedEnv`` of ``--mixed-envs``, each
    env with the options it takes, wrapped in ``SRLEncodedEnv`` for a learned
    ``--srl-model`` (the encoder on ``device``; each family of a mixed batch
    is wrapped, never the MixedEnv), frame-stacked when ``--num-stack`` >
    1."""
    options = {
        "srl_model": args.srl_model,
        "is_discrete": not args.continuous_actions,
        "action_joints": args.action_joints,
        "action_repeat": args.action_repeat,
        "random_target": args.random_target,
        "shape_reward": args.shape_reward,
        "render_scale": args.render_scale,
        "coarse_obs": args.coarse_obs,
    }
    wrap = lambda e: e
    path = srl_model_path(args)
    if path is not None:
        from srl_tpu_torch.srl.models import SRLEncodedEnv, loadSRLModel

        model = loadSRLModel(path, device=device)
        wrap = lambda e: SRLEncodedEnv(e, model)
    if getattr(args, "mixed_envs", None):
        families = [wrap(make_with_options(e, options)) for e in args.mixed_envs]
        sizes = [f.action_space.n for f in families if isinstance(f.action_space, Discrete)]
        if len(set(sizes)) > 1:
            printYellow(
                f"--mixed-envs families have differing action counts {sizes}: shared "
                f"actions beyond a family's range fold back modulo its count (skews that "
                f"family's action distribution under exploration; construct MixedEnv with "
                f"explicit action_tables for task-specific semantics)")
        env = MixedEnv(families, oob_action="modulo")
    else:
        env = wrap(make_with_options(args.env, options))
    if args.num_stack > 1:
        env = FrameStack(env, args.num_stack)
    return env


def make_run_dir(args) -> str:
    base = os.path.join(args.log_dir, args.env, args.srl_model, args.algo,
                        datetime.now().strftime("%y-%m-%d_%Hh%M_%S"))
    log_dir, n = base, 1
    while True:
        try:
            os.makedirs(log_dir)
            return log_dir
        except FileExistsError:
            n += 1
            log_dir = f"{base}_{n}"


def save_env_params(log_dir: str, env) -> None:
    params = {}
    for k, v in vars(env).items():
        if isinstance(v, (int, float, bool, str, list, tuple)):
            params[k] = v
        elif isinstance(v, np.ndarray):
            params[k] = v.tolist()
    with open(os.path.join(log_dir, "env_globals.json"), "w") as f:
        json.dump(params, f, indent=2, default=str)


def make_callback(log_dir: str, args, monitor: MonitorWriter, algo,
                  resume_meta: dict = None):
    """Monitor CSV rows, best-model saving every ``SAVE_INTERVAL`` updates,
    a checkpoint every ``--checkpoint-interval`` updates and a metrics.jsonl
    line per call, the losses included; a resumed run counts on from its
    checkpoint's steps and episodes. Unless ``--no-vis``, each printed line
    redraws ``learning_curve.png`` if the last drawing is over 2 s old."""
    state = {"best": -1e4, "n_logged": 0, "base_timesteps": 0, "base_episodes": 0,
             "last_plot": 0.0}
    if resume_meta:
        state["best"] = resume_meta.get("best", state["best"])
        state["base_timesteps"] = resume_meta.get("num_timesteps", 0)
        state["base_episodes"] = resume_meta.get("n_episodes", 0)
    metrics_path = os.path.join(log_dir, "metrics.jsonl")

    def callback(_locals, _globals):
        ep_returns = _locals["episode_returns"]
        ep_lengths = _locals["episode_lengths"]
        while state["n_logged"] < len(ep_returns):
            i = state["n_logged"]
            # The evolution strategies log returns without lengths.
            monitor.write_episode(ep_returns[i], ep_lengths[i] if i < len(ep_lengths) else 0)
            state["n_logged"] += 1

        update = _locals["update"]
        if (update + 1) % algo.SAVE_INTERVAL == 0 \
                and len(ep_returns) >= args.min_episodes_save:
            mean_reward = float(np.mean(ep_returns[-N_EPISODES_EVAL:]))
            if mean_reward > state["best"]:
                state["best"] = mean_reward
                printGreen(f"Saving new best model: mean reward {mean_reward:.2f} "
                           f"over last {N_EPISODES_EVAL} episodes")
                _locals["self"].save(os.path.join(log_dir, f"{args.algo}_model.pkl"))

        num_timesteps = state["base_timesteps"] + _locals["num_timesteps"]
        n_episodes = state["base_episodes"] + len(ep_returns)
        if args.checkpoint_interval and (update + 1) % args.checkpoint_interval == 0:
            _locals["self"].save_checkpoint(
                os.path.join(log_dir, "checkpoint.pkl"),
                meta={"num_timesteps": num_timesteps, "n_episodes": n_episodes,
                      "update": update, "best": state["best"]})

        window = ep_returns[-args.episode_window:]
        entry = {
            "update": update,
            "num_timesteps": num_timesteps,
            "n_episodes": n_episodes,
            "mean_reward": float(np.mean(window)) if window else None,
            "fps": _locals["fps"],
            **_locals["metrics"],
        }
        with open(metrics_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        if (update + 1) % algo.LOG_INTERVAL == 0 or update + 1 >= _locals["n_updates"]:
            mean = entry["mean_reward"]
            printGreen(f"update {update + 1}/{_locals['n_updates']}  "
                       f"steps {entry['num_timesteps']}  episodes {entry['n_episodes']}  "
                       f"mean reward {mean if mean is not None else float('nan'):.2f}  "
                       f"{entry['fps']:.0f} steps/s")
            if not args.no_vis and ep_returns and time.time() - state["last_plot"] > 2.0:
                state["last_plot"] = time.time()
                monitor.flush()
                plot_log_dir(log_dir, title=plot_title(args), episode_window=args.episode_window)

    return callback


def plot_title(args) -> str:
    return f"{args.env} ({args.srl_model}, {args.algo})"


def algo_kwargs(algo_class, args, parser, hyperparams: dict, device) -> dict:
    """The agent's constructor arguments: those of the CLI's that it takes,
    and its config from the defaults, then the CLI flags that name a config
    field, then the parsed ``--hyperparam`` values."""
    sig = inspect.signature(algo_class.__init__).parameters
    kwargs = {"device": device}
    if "num_envs" in sig:
        kwargs["num_envs"] = args.num_envs or DEFAULT_NUM_ENVS
    if args.policy != "auto" and "policy" in sig:
        kwargs["policy"] = args.policy
    if args.recompute_obs:
        if "recompute_obs" in sig:
            kwargs["recompute_obs"] = True
        else:
            printYellow(f"--recompute-obs has no effect on {args.algo}")
    if "config" not in sig:
        return kwargs
    default = algo_class(device="cpu").config
    cfg = dataclasses.asdict(default)
    cli = {k: v for k, v in vars(args).items()
           if k in cfg and v is not None and parser.get_default(k) != v}
    if cli or hyperparams:
        kwargs["config"] = type(default)(**{**cfg, **cli, **hyperparams})
    return kwargs


def main(argv=None) -> str:
    parser = build_parser(argv)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    # Stated, not inherited: float32 matmuls and convolutions stay full
    # float32 (the policy's convs and fc512 run in bfloat16 by design).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    resume_state, resume_meta = None, None
    if args.resume:
        with open(os.path.join(args.resume, "args.json")) as f:
            stored = json.load(f)
        for k, v in stored.items():
            if k not in RESUME_KEEPS and hasattr(args, k):
                setattr(args, k, v)
        resume_state, resume_meta = BaseRLAgent.load_checkpoint(
            os.path.join(args.resume, "checkpoint.pkl"))
        printYellow(f"Resuming {args.resume} from "
                    f"{resume_meta.get('num_timesteps', 0)} steps")

    algo_class, _, action_types = registered_rl[args.algo]
    if args.continuous_actions:
        assert ActionType.CONTINUOUS in action_types, (
            f"Error: {args.algo} does not support continuous actions")
    else:
        assert ActionType.DISCRETE in action_types, (
            f"Error: {args.algo} does not support discrete actions")
    # ``--hyperparam`` parses against the registered class, as in the
    # reference (the recurrent PPO2 declares no table of its own).
    hyperparams = algo_class.parserHyperParam(args.hyperparam)
    algo_class = resolve_policy_class(args.algo, args.policy)
    if args.resume and "initial_state" not in inspect.signature(algo_class.learn).parameters:
        raise ValueError(f"--resume is not supported for algo '{args.algo}' yet")

    env = build_env(args, device)
    log_dir = args.resume or make_run_dir(args)
    printGreen(f"Log dir: {log_dir}")
    with open(os.path.join(log_dir, "args.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()
                   if isinstance(v, (int, float, str, bool, list, type(None)))}, f, indent=2)
    save_env_params(log_dir, getattr(env, "_env", env))
    agent = algo_class(env=env, **algo_kwargs(algo_class, args, parser, hyperparams, device))
    if args.load_rl_model_path is not None:
        printYellow(f"Fine-tuning from {args.load_rl_model_path}")
        agent.pretrained = algo_class.load(args.load_rl_model_path, env=env,
                                           device=device).state

    learn_kwargs = {}
    # 1.1x so that the last save interval fits (the reference's inflation).
    total = int(args.num_timesteps * 1.1)
    learn_params = inspect.signature(agent.learn).parameters
    if resume_state is not None:
        total = max(0, total - int(resume_meta.get("num_timesteps", 0)))
        learn_kwargs["initial_state"] = resume_state
    if args.updates_per_call > 1 and "updates_per_call" in learn_params:
        learn_kwargs["updates_per_call"] = args.updates_per_call

    monitor = MonitorWriter(log_dir, env_id=args.env, append=args.resume is not None)
    callback = make_callback(log_dir, args, monitor, agent, resume_meta)
    live_server = None
    if not args.no_vis:
        live_server = LiveVisServer(log_dir, port=args.port, window=args.episode_window)
        if live_server.start():
            printGreen(f"Live curves: http://localhost:{live_server.port}")
        else:
            printYellow(f"Port {args.port} is busy: no live curves for this run")
            live_server = None
    t0 = time.time()
    try:
        if args.profile:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=activities) as prof:
                agent.learn(total, seed=args.seed, callback=callback, **learn_kwargs)
            os.makedirs(os.path.join(log_dir, "profile"), exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, "profile", "trace.json"))
        else:
            agent.learn(total, seed=args.seed, callback=callback, **learn_kwargs)
    finally:
        if live_server is not None:
            live_server.stop()
    printGreen(f"Training done in {time.time() - t0:.1f}s")
    agent.save(os.path.join(log_dir, f"{args.algo}_final_model.pkl"))
    monitor.close()
    if not args.no_vis:
        plot_log_dir(log_dir, title=plot_title(args))
    return log_dir


if __name__ == "__main__":
    main()
