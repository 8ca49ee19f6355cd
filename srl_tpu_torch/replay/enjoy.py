"""Replay a trained agent (counterpart of srl_tpu/replay/enjoy.py).

``load_config_and_setup`` rebuilds the env of a training run from its
``args.json`` through the training CLI's own ``build_env`` (so
``--mixed-envs`` pods, learned-SRL wrapping, ``--num-stack``,
``--render-scale`` and ``--coarse-obs`` all round-trip) and loads the agent
as the class its ``--algo`` and ``--policy`` resolve to (a ``--policy lstm``
run reloads as its Recurrent* agent), from ``{algo}_model.pkl``, else
``{algo}_final_model.pkl``. Runs of either package load.

``enjoy`` rolls the agent out on the device: observations stay there, and
only each step's ``done``, episode returns and lengths come to the host (the
``done`` mask goes back into ``getAction``, so recurrent agents reset their
state). ``--plot`` keeps env 0's observations (PCA-projected to 2-d when
wider) and, for discrete actions, the action probabilities of env 0, and
draws ``replay_plots.png``; ``--render`` renders env 0 every 10 steps, up to
16 frames (env 0 of family 0 for a mixed pod), into ``replay_frames.png``.
A render that fails raises. The numbers behind each figure come back in the
result whether or not matplotlib is there to draw it.

    python -m srl_tpu_torch.replay.enjoy --log-dir logs/ENV/SRL/ALGO/RUN \\
        [--latest] [--num-timesteps 1000] [--num-envs 4] [--seed 0] \\
        [--render] [--plot] [--stochastic] [--device cpu]
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Iterable, Optional

import numpy as np
import torch

from srl_tpu_torch.agents.registry import resolve_policy_class
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import VecEnv, state_map
from srl_tpu_torch.core.spaces import Discrete
from srl_tpu_torch.experiments import train
from srl_tpu_torch.experiments.visualize import no_pyplot, pyplot
from srl_tpu_torch.utils.logging import printGreen, printYellow

# --render: env 0 every FRAME_EVERY steps, at most MAX_FRAMES frames.
FRAME_EVERY = 10
MAX_FRAMES = 16


def latest_log_dir(base: str) -> str:
    """The newest run directory under ``base`` (logs/env/srl/algo/)."""
    candidates = [d for d in glob.glob(os.path.join(base, "*")) if os.path.isdir(d)]
    assert candidates, f"no runs under {base}"
    return max(candidates, key=os.path.getmtime)


def run_args(train_args: dict):
    """The training CLI's arguments of a run: its parser's defaults under
    the values the run's ``args.json`` stored."""
    argv = ["--algo", train_args["algo"]]
    args = train.build_parser(argv).parse_args(argv)
    for k, v in train_args.items():
        setattr(args, k, v)
    return args


def load_config_and_setup(log_dir: str, device="cuda"):
    """(args.json as a dict, env, agent) of a training run directory, the
    agent and any SRL encoder on ``device``."""
    device = resolve_device(device)
    with open(os.path.join(log_dir, "args.json")) as f:
        train_args = json.load(f)
    args = run_args(train_args)
    env = train.build_env(args, device)
    algo_class = resolve_policy_class(args.algo, args.policy)
    model_path = os.path.join(log_dir, f"{args.algo}_model.pkl")
    if not os.path.exists(model_path):
        model_path = os.path.join(log_dir, f"{args.algo}_final_model.pkl")
        printYellow(f"Best model not found, using final model {model_path}")
    agent = algo_class.load(model_path, env=env, device=device)
    return train_args, env, agent


def frame_source(env, vstate):
    """(env, state) whose ``render_pixels`` draws env 0: family 0's first
    env for a mixed pod, the env inside any frame stack."""
    if getattr(env, "is_mixed_family", False):
        env, state = env.families[0], vstate[0].env_state
    else:
        state = vstate.env_state
    while hasattr(state, "inner"):  # FrameStack: render the stacked env
        env, state = env.env, state.inner
    return env, state_map(lambda x: x[:1], state)


def pca_2d(traj: np.ndarray) -> np.ndarray:
    """``traj`` [T, d] projected on its first two principal axes when
    d > 2 (the SVD's signs are arbitrary), else as it is."""
    if traj.shape[1] <= 2:
        return traj
    traj = traj - traj.mean(0)
    _, _, vt = np.linalg.svd(traj, full_matrices=False)
    return traj @ vt[:2].T


def enjoy(log_dir: str, num_timesteps: int = 1000, num_envs: int = 4, seed: int = 0,
          render: bool = False, plot: bool = False, deterministic: bool = True,
          device="cuda", env_draws: Optional[Iterable[dict]] = None) -> dict:
    """Replay the run of ``log_dir`` for ``num_timesteps // num_envs`` steps
    of ``num_envs`` envs on ``device``, from ``torch.Generator`` seed
    ``seed``. ``env_draws``, when given, supplies the env's random numbers:
    its first item is the keyword arguments of ``VecEnv.reset`` (``noise``),
    each next one those of a ``VecEnv.step`` (``step_noise``,
    ``reset_noise``).

    Returns ``episode_returns``, ``episode_lengths``, ``mean_return`` (None
    without a finished episode), ``env_steps`` and ``rollout_seconds``; with
    ``plot``, ``trajectory`` [steps, <= 2] and, for discrete actions,
    ``mean_proba``; with ``render``, ``frames`` (uint8 [H, W, 3] arrays)
    and ``frame_states`` (the one-env state each was rendered from); and
    the paths of the figures drawn."""
    device = resolve_device(device)
    _, env, agent = load_config_and_setup(log_dir, device)
    vec = VecEnv(env, num_envs)
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = iter(env_draws) if env_draws is not None else None
    vstate, obs = vec.reset(gen, **(next(draws) if draws else {}))

    returns, lengths, traj, probas, frames, frame_states = [], [], [], [], [], []
    n_steps = num_timesteps // num_envs
    dones = np.zeros(num_envs, bool)
    t0 = time.perf_counter()
    for t in range(n_steps):
        actions = agent.getAction(obs, dones=dones, deterministic=deterministic, gen=gen)
        vstate, tr = vec.step(vstate, torch.as_tensor(actions, device=device), gen,
                              **(next(draws) if draws else {}))
        obs = tr.obs
        # One transfer a step: done, and the return and length of the
        # episodes that ended.
        ended = torch.stack([tr.done.to(torch.float64), tr.episode_return.double(),
                             tr.episode_length.double()]).cpu().numpy()
        dones = ended[0].astype(bool)
        returns.extend(ended[1][dones].tolist())
        lengths.extend(ended[2][dones].astype(int).tolist())
        if plot:
            traj.append(obs[0].reshape(-1))
            if isinstance(env.action_space, Discrete):
                probas.append(agent.getActionProba(obs[:1])[0])
        if render and t % FRAME_EVERY == 0 and len(frames) < MAX_FRAMES:
            src, state0 = frame_source(env, vstate)
            frames.append(src.render_pixels(state0)[0, ..., :3])
            frame_states.append(state0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0

    result = {
        "episode_returns": returns,
        "episode_lengths": lengths,
        "mean_return": float(np.mean(returns)) if returns else None,
        "env_steps": n_steps * num_envs,
        "rollout_seconds": seconds,
    }
    printGreen(f"Replayed {n_steps * num_envs} steps: {len(returns)} episodes, mean return "
               f"{result['mean_return']}")
    if plot and traj:
        result["trajectory"] = pca_2d(torch.stack(traj).cpu().numpy())
        if probas:
            result["mean_proba"] = np.mean(np.stack(probas), axis=0)
        result["plot_path"] = draw_plots(result["trajectory"], result.get("mean_proba"),
                                         os.path.join(log_dir, "replay_plots.png"))
    if frames:
        result["frames"] = [f.cpu().numpy() for f in frames]
        result["frame_states"] = frame_states
        result["frames_path"] = draw_frames(result["frames"],
                                            os.path.join(log_dir, "replay_frames.png"))
    return result


def draw_plots(traj: np.ndarray, mean_proba: Optional[np.ndarray], out: str) -> Optional[str]:
    """Env 0's trajectory and, when given, the mean action probabilities,
    to ``out``; None without matplotlib."""
    plt = pyplot()
    if plt is None:
        no_pyplot(out)
        return None
    fig, axes = plt.subplots(1, 2 if mean_proba is not None else 1, figsize=(10, 4.5))
    ax0 = axes[0] if mean_proba is not None else axes
    ax0.plot(traj[:, 0], traj[:, 1] if traj.shape[1] > 1 else traj[:, 0], ".-", ms=2, lw=0.5)
    ax0.set_title("state/latent trajectory (env 0)")
    if mean_proba is not None:
        axes[1].bar(np.arange(len(mean_proba)), mean_proba)
        axes[1].set_title("mean action probabilities")
    fig.tight_layout()
    fig.savefig(out, dpi=100)
    plt.close(fig)
    return out


def draw_frames(frames: list, out: str) -> Optional[str]:
    """The frames side by side, to ``out``; None without matplotlib."""
    plt = pyplot()
    if plt is None:
        no_pyplot(out)
        return None
    fig, axes = plt.subplots(1, len(frames), figsize=(2 * len(frames), 2.2))
    for ax, fr in zip(np.atleast_1d(axes), frames):
        ax.imshow(fr)
        ax.axis("off")
    fig.savefig(out, dpi=80, bbox_inches="tight")
    plt.close(fig)
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Replay a trained agent")
    parser.add_argument("--log-dir", type=str, required=True,
                        help="Run directory (or its parent with --latest)")
    parser.add_argument("--latest", action="store_true",
                        help="replay the newest run directory under --log-dir")
    parser.add_argument("--num-timesteps", type=int, default=1000)
    parser.add_argument("--num-envs", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--render", action="store_true",
                        help="render env 0 every 10 steps into replay_frames.png")
    parser.add_argument("--plot", action="store_true",
                        help="save the trajectory and action-probability plots")
    parser.add_argument("--stochastic", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    log_dir = latest_log_dir(args.log_dir) if args.latest else args.log_dir
    return enjoy(log_dir, args.num_timesteps, args.num_envs, args.seed, render=args.render,
                 plot=args.plot, deterministic=not args.stochastic, device=device)


if __name__ == "__main__":
    main()
