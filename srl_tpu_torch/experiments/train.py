"""Training entry point (counterpart of srl_tpu/experiments/train.py).

The port's subset of the reference CLI: ``--algo ppo2`` on every registered
env (Kuka, MobileRobot, Omnirobot, CarRacing) with every ``--srl-model`` of
the registry, optionally with ``--num-stack`` frames, or on a mixed batch of
env families (``--mixed-envs``: one learner over contiguous per-family
slices, ``core/mixed_env.py``; differing action counts fold modulo each
family's, with a warning). Every env gets the options it takes (found by
signature, as the reference does). A learned model (type SRL) is
resolved as the reference resolves it: ``--latest`` takes the newest
``srl_logs/{env}/**/srl_model.pkl``, else ``--srl-config-file`` names its
checkpoint under the env's ``log_folder``; the env (each family of a mixed
batch) is then wrapped in ``SRLEncodedEnv`` (render -> encode) before any
frame stacking. The run directory has the reference's layout,
``{log-dir}/{env}/{srl_model}/{algo}/{datetime}/`` with ``args.json``,
``env_globals.json``, ``0.monitor.csv``, ``metrics.jsonl``,
``ppo2_model.pkl`` (best mean reward over the last 100 episodes, once 100
have finished) and ``ppo2_final_model.pkl``; the reference's
``srl_tpu.agents.ppo.PPO2.load`` reads both checkpoints.

Usage (the README's pixel run, the quickstart, and an encoder trained by
``srl_tpu_torch.experiments.train_srl``):
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
"""
from __future__ import annotations

import argparse
import glob
import inspect
import json
import os
import time
from datetime import datetime

import numpy as np
import torch

from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.frame_stack import FrameStack
from srl_tpu_torch.core.mixed_env import MixedEnv
from srl_tpu_torch.core.spaces import Discrete
from srl_tpu_torch.envs.registry import make_env, registered_env
from srl_tpu_torch.srl import SRLType
from srl_tpu_torch.srl.registry import registered_srl
from srl_tpu_torch.utils.logging import printGreen, printYellow
from srl_tpu_torch.utils.monitor import MonitorWriter
from srl_tpu_torch.utils.srl_models_yaml import read_srl_models

MIN_EPISODES_BEFORE_SAVE = 100
N_EPISODES_EVAL = 100

# Reference flags this port does not have yet (see ROADMAP.md).
NOT_PORTED = ("--recompute-obs", "--remat-policy", "--updates-per-call", "--resume",
              "--load-rl-model-path", "--hyperparam")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train PPO2 on the registered envs (PyTorch port)")
    parser.add_argument("--algo", default="ppo2", choices=["ppo2"])
    parser.add_argument("--env", default="KukaButtonGymEnv-v0",
                        choices=list(registered_env.keys()))
    parser.add_argument("--srl-model", default="raw_pixels",
                        choices=list(registered_srl.keys()))
    parser.add_argument("--srl-config-file", default="config/srl_models.yaml",
                        help="env -> {log_folder, model: checkpoint} map of the "
                        "trained SRL models")
    parser.add_argument("--latest", action="store_true",
                        help="use the newest trained SRL model of the env under "
                        "srl_logs/")
    parser.add_argument("--num-envs", type=int, default=16)
    parser.add_argument("--num-timesteps", type=int, default=int(1e6))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-stack", type=int, default=1,
                        help="number of frames to stack")
    parser.add_argument("--render-scale", type=int, default=1, choices=[1, 2, 4, 7],
                        help="Kuka: trace at 224/s and upsample (1 = exact 224x224)")
    parser.add_argument("--coarse-obs", action="store_true",
                        help="with --render-scale 2: hand the traced 112x112 "
                        "image to the CNN, the upsample folded into conv1")
    parser.add_argument("-c", "--continuous-actions", action="store_true")
    parser.add_argument("-r", "--random-target", action="store_true")
    parser.add_argument("--shape-reward", action="store_true")
    parser.add_argument("--log-dir", default="logs/")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--mixed-envs", nargs="+", default=None, metavar="ENV_ID",
                        choices=list(registered_env.keys()),
                        help="train one learner on a batch of these env families, "
                        "which must share the observation space (raw_pixels at a "
                        "common shape or equal-dim SRL states); --env still names "
                        "the run directory and the SRL config entry")
    parser.add_argument("--no-vis", action="store_true",
                        help="accepted for compatibility: the port draws no plots")
    for flag in NOT_PORTED:
        parser.add_argument(flag, nargs="*", help=argparse.SUPPRESS,
                            dest="not_ported_" + flag[2:].replace("-", "_"))
    args = parser.parse_args(argv)
    for flag in NOT_PORTED:
        if getattr(args, "not_ported_" + flag[2:].replace("-", "_")) is not None:
            parser.error(f"{flag} is not ported to srl_tpu_torch yet; use "
                         "srl_tpu.experiments.train for it")
    return args


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
        pattern = os.path.join("srl_logs", args.env, "**", "srl_model.pkl")
        candidates = glob.glob(pattern, recursive=True)
        if not candidates:
            raise FileNotFoundError(f"No trained SRL models found under srl_logs/{args.env}")
        return max(candidates, key=os.path.getmtime)
    all_models = read_srl_models(args.srl_config_file)
    if args.env not in all_models:
        raise KeyError(f"environment '{args.env}' not in srl config file "
                       f"'{args.srl_config_file}'")
    models = all_models[args.env]
    if args.srl_model not in models:
        raise KeyError(f"srl_model '{args.srl_model}' not in config for env {args.env}")
    return os.path.join(models.get("log_folder", ""), models[args.srl_model])


def build_env(args, device="cuda"):
    """The env of ``args.env``, or the ``MixedEnv`` of ``--mixed-envs``, each
    env with the options it takes, wrapped in ``SRLEncodedEnv`` for a learned
    ``--srl-model`` (the encoder on ``device``; each family of a mixed batch
    is wrapped, never the MixedEnv), frame-stacked when ``--num-stack`` >
    1."""
    options = {
        "srl_model": args.srl_model,
        "is_discrete": not args.continuous_actions,
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


def make_callback(log_dir: str, args, monitor: MonitorWriter, algo):
    """Monitor CSV rows, best-model saving and one metrics.jsonl line per
    update (the losses included)."""
    state = {"best": -1e4, "n_logged": 0}
    metrics_path = os.path.join(log_dir, "metrics.jsonl")

    def callback(_locals, _globals):
        ep_returns = _locals["episode_returns"]
        ep_lengths = _locals["episode_lengths"]
        while state["n_logged"] < len(ep_returns):
            i = state["n_logged"]
            monitor.write_episode(ep_returns[i], ep_lengths[i])
            state["n_logged"] += 1

        update = _locals["update"]
        if len(ep_returns) >= MIN_EPISODES_BEFORE_SAVE:
            mean_reward = float(np.mean(ep_returns[-N_EPISODES_EVAL:]))
            if mean_reward > state["best"]:
                state["best"] = mean_reward
                printGreen(f"Saving new best model: mean reward {mean_reward:.2f} "
                           f"over last {N_EPISODES_EVAL} episodes")
                _locals["self"].save(os.path.join(log_dir, f"{args.algo}_model.pkl"))

        window = ep_returns[-40:]
        entry = {
            "update": update,
            "num_timesteps": _locals["num_timesteps"],
            "n_episodes": len(ep_returns),
            "mean_reward": float(np.mean(window)) if window else None,
            "fps": _locals["fps"],
            **_locals["metrics"],
        }
        with open(metrics_path, "a") as f:
            f.write(json.dumps(entry) + "\n")
        if (update + 1) % algo.LOG_INTERVAL == 0 or update + 1 == _locals["n_updates"]:
            mean = entry["mean_reward"]
            printGreen(f"update {update + 1}/{_locals['n_updates']}  "
                       f"steps {entry['num_timesteps']}  episodes {entry['n_episodes']}  "
                       f"mean reward {mean if mean is not None else float('nan'):.2f}  "
                       f"{entry['fps']:.0f} steps/s")

    return callback


def main(argv=None) -> str:
    args = parse_args(argv)
    device = resolve_device(args.device)
    # Stated, not inherited: float32 matmuls and convolutions stay full
    # float32 (the policy's convs and fc512 run in bfloat16 by design).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    env = build_env(args, device)
    log_dir = make_run_dir(args)
    printGreen(f"Log dir: {log_dir}")
    with open(os.path.join(log_dir, "args.json"), "w") as f:
        json.dump({k: v for k, v in vars(args).items()
                   if not k.startswith("not_ported_")}, f, indent=2)
    save_env_params(log_dir, getattr(env, "_env", env))
    agent = PPO2(env=env, num_envs=args.num_envs, device=device)

    monitor = MonitorWriter(log_dir, env_id=args.env)
    callback = make_callback(log_dir, args, monitor, agent)
    t0 = time.time()
    # 1.1x so that the last save interval fits (the reference's inflation).
    agent.learn(int(args.num_timesteps * 1.1), seed=args.seed, callback=callback)
    printGreen(f"Training done in {time.time() - t0:.1f}s")
    agent.save(os.path.join(log_dir, f"{args.algo}_final_model.pkl"))
    monitor.close()
    return log_dir


if __name__ == "__main__":
    main()
