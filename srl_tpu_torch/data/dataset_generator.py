"""Dataset recording for SRL training (counterpart of
srl_tpu/data/dataset_generator.py).

One ``VecEnv`` steps every env in lockstep on the device and episodes are
sliced out of the [T, N] batch, as the reference slices them: each env
keeps a buffer from its episode's first frame, and when its episode ends
the buffer up to the step before goes to the ``EpisodeSaver`` (the frame
returned with ``done`` is the next episode's first, after the auto-reset).
Steps run in chunks of 32 on the device and reach the host as one block.

Policies: random actions (default), a PPO2 trained on ground truth first
(``--run-ppo2``), or the toward-target expert mixed per env and per step
with random actions (``--toward-target-timesteps-proportion``; MobileRobot
only: it reads the state's ``targets``, which Omnirobot's state lacks).

Usage:
  python -m srl_tpu_torch.data.dataset_generator --env MobileRobotGymEnv-v0 \\
      --num-episode 8 --save-path data/ --name mobile_robot_test [--device cpu]
  python -m srl_tpu_torch.data.dataset_generator --env OmnirobotEnv-v0 \\
      --num-episode 8 --save-path data/ --name omnirobot [--run-ppo2]
  python -m srl_tpu_torch.data.dataset_generator --env CarRacingGymEnv-v0 \\
      --num-episode 8 --max-steps 200 --save-path data/ --name car_racing
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np
import torch

from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import VecEnv
from srl_tpu_torch.envs.registry import registered_env
from srl_tpu_torch.srl.episode_saver import EpisodeSaver
from srl_tpu_torch.utils.logging import printGreen

CHUNK = 32


def _make(env_id: str, kwargs: dict):
    from srl_tpu_torch.experiments.train import make_with_options

    return make_with_options(env_id, kwargs)


def generate_dataset(
    env_id: str,
    num_episodes: int,
    save_path: str = "data/",
    name: str = None,
    seed: int = 0,
    num_envs: int = 8,
    random_target: bool = False,
    shape_reward: bool = False,
    policy: str = "random",  # random | ppo2 | toward_target
    toward_target_proportion: float = 1.0,
    max_steps: Optional[int] = None,
    ppo2_timesteps: int = 20_000,
    env_kwargs: Optional[dict] = None,
    device="cuda",
) -> str:
    """Record ``num_episodes`` episodes of pixels; returns the dataset
    folder ``{save_path}/{name}``."""
    dev = resolve_device(device)
    if name is None:
        name = env_id.split("-")[0].lower()
    kwargs = dict(srl_model="raw_pixels", random_target=random_target,
                  shape_reward=shape_reward)
    if max_steps is not None:
        kwargs["max_steps"] = max_steps
    kwargs.update(env_kwargs or {})
    env = _make(env_id, kwargs)
    n_act = getattr(env.action_space, "n", None)

    agent = None
    if policy == "ppo2":
        from srl_tpu_torch.agents.ppo import PPO2

        agent = PPO2(env=_make(env_id, {**kwargs, "srl_model": "ground_truth"}),
                     num_envs=num_envs, device=dev)
        agent.learn(total_timesteps=ppo2_timesteps, seed=seed)

    vec = VecEnv(env, num_envs)
    gen = torch.Generator(device=dev).manual_seed(
        int(np.random.RandomState(seed).randint(2**31)))

    def pick_actions(env_state) -> torch.Tensor:
        if policy == "toward_target" and hasattr(env_state, "robot_pos"):
            # Greedy move along the axis of the larger distance to the target.
            delta = env_state.targets[:, 0] - env_state.robot_pos
            ax = torch.argmax(torch.abs(delta), -1)
            a = torch.where(ax == 0, torch.where(delta[:, 0] > 0, 1, 0),
                            torch.where(delta[:, 1] > 0, 3, 2)).to(torch.int32)
            if toward_target_proportion >= 1.0:
                return a
            rand_a = torch.randint(0, n_act, (num_envs,), generator=gen, device=dev,
                                   dtype=torch.int32)
            use_expert = torch.rand((num_envs,), generator=gen, device=dev) \
                < toward_target_proportion
            return torch.where(use_expert, a, rand_a)
        if agent is not None:
            gt_obs = agent.env.observe(env_state)
            if agent.state.obs_norm is not None:
                gt_obs = agent.state.obs_norm.normalize(gt_obs)
            dist, _ = agent.apply(agent.state.params, gt_obs)
            a = dist.sample(gen)
            return a.to(torch.int32) if n_act is not None else a
        if n_act is not None:
            return torch.randint(0, n_act, (num_envs,), generator=gen, device=dev,
                                 dtype=torch.int32)
        return torch.rand((num_envs,) + env.action_space.shape, generator=gen,
                          device=dev) * 2 - 1

    saver = EpisodeSaver(
        name,
        max_dist=getattr(env, "max_distance", 0.0),
        state_dim=env.ground_truth_dim_() if hasattr(env, "ground_truth_dim_") else -1,
        globals_={"env_id": env_id, "seed": seed, **{k: str(v) for k, v in kwargs.items()}},
        path=save_path,
    )

    t_start = time.time()
    total_steps = 0
    episodes_recorded = 0
    with torch.no_grad():
        vstate, obs = vec.reset(gen)
        if policy == "toward_target" and hasattr(vstate.env_state, "robot_pos") \
                and not hasattr(vstate.env_state, "targets"):
            # The reference's expert reads env_state.targets[:, 0] whenever
            # the state has a robot_pos, and so fails on such an env.
            raise ValueError(f"the toward-target expert needs a state with targets; "
                             f"{env_id}'s has none")
        first = (obs, env.ground_truth(vstate.env_state), env.target_pos(vstate.env_state))
        obs_np, gts, tgts = (x.cpu().numpy() for x in first)
        buffers = [[(obs_np[i], None, 0.0, gts[i], tgts[i])] for i in range(num_envs)]
        while episodes_recorded < num_episodes:
            outs = []
            for _ in range(CHUNK):
                actions = pick_actions(vstate.env_state)
                vstate, tr = vec.step(vstate, actions, gen)
                outs.append((tr.obs, actions, tr.reward, tr.done,
                             env.ground_truth(vstate.env_state),
                             env.target_pos(vstate.env_state)))
            obs_np, act_np, rew_np, done_np, gts, tgts = (
                torch.stack(x).cpu().numpy() for x in zip(*outs))
            total_steps += CHUNK * num_envs
            for t in range(CHUNK):
                for i in range(num_envs):
                    buffers[i].append((obs_np[t, i], act_np[t, i], float(rew_np[t, i]),
                                       gts[t, i], tgts[t, i]))
                    if done_np[t, i] and episodes_recorded < num_episodes:
                        episode = buffers[i][:-1]
                        first_obs, _, _, gt0, tgt0 = episode[0]
                        saver.reset(first_obs, tgt0, gt0)
                        for obs_t, a_t, r_t, gt_t, _ in episode[1:]:
                            saver.step(obs_t, a_t, r_t, False, gt_t)
                        episodes_recorded += 1
                        buffers[i] = [buffers[i][-1]]
                if episodes_recorded >= num_episodes:
                    break

    folder = saver.save()
    fps = total_steps / max(time.time() - t_start, 1e-9)
    printGreen(f"Saved {episodes_recorded} episodes ({len(saver.rewards)} frames) "
               f"to {folder} [{fps:.0f} FPS]")
    return folder


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="Batched dataset generator for SRL "
                                     "training (PyTorch port)")
    parser.add_argument("--env", type=str, default="KukaButtonGymEnv-v0",
                        choices=list(registered_env.keys()))
    parser.add_argument("--num-episode", type=int, default=50)
    parser.add_argument("--save-path", type=str, default="data/")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--num-cpu", "--num-envs", dest="num_envs", type=int, default=8)
    parser.add_argument("--random-target", action="store_true")
    parser.add_argument("--shape-reward", action="store_true")
    parser.add_argument("--run-ppo2", action="store_true")
    parser.add_argument("--toward-target-timesteps-proportion", type=float, default=0.0,
                        help="probability, per env and per step, of taking the "
                        "toward-target action instead of a random one")
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--render-scale", type=int, default=1, choices=[1, 2, 4, 7],
                        help="Kuka: trace at 224/s and upsample to 224x224")
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    name = args.name or args.env.split("-")[0].lower()
    out = os.path.join(args.save_path, name)
    if os.path.exists(out) and not args.force:
        raise ValueError(f"Folder {out} already exists (use --force)")
    policy = "ppo2" if args.run_ppo2 else (
        "toward_target" if args.toward_target_timesteps_proportion > 0 else "random")
    return generate_dataset(
        args.env, args.num_episode, save_path=args.save_path, name=args.name,
        seed=args.seed, num_envs=args.num_envs, random_target=args.random_target,
        shape_reward=args.shape_reward, policy=policy,
        toward_target_proportion=(args.toward_target_timesteps_proportion
                                  if args.toward_target_timesteps_proportion > 0 else 1.0),
        max_steps=args.max_steps, env_kwargs={"render_scale": args.render_scale},
        device=args.device)


if __name__ == "__main__":
    main()
