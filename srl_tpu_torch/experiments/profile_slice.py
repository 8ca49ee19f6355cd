"""Where the time of one PPO2 update goes on the card, for a main path of
the port: by default KukaButtonGymEnv-v0 from raw pixels (render scale 2,
coarse observations, the Nature CNN); ``--env MobileRobotGymEnv-v0`` gives
the MobileRobot pixel run (224x224 frames from the sprite compositor); a
learned ``--srl-model`` with ``--srl-model-path`` profiles PPO2 on that
encoder's states (``SRLEncodedEnv``: render, then encode); ``--mixed-envs
KukaButtonGymEnv-v0 OmnirobotEnv-v0`` the mixed pixel batch (Kuka traced at
render scale 2 and upsampled to 224x224, Omnirobot rasterised at 224x224),
with the rollout's env and render time split by family.

    python -m srl_tpu_torch.experiments.profile_slice [--env ENV_ID]
        [--srl-model NAME [--srl-model-path CHECKPOINT]] [--num-envs 256]
        [--mixed-envs ENV_ID ...]

After one warm-up update it reports, on the host clock with the device
synchronised around each part:

* the wall time of an update and of its two halves, the 128-step rollout and
  the 4 x 4 minibatch epochs;
* a rollout step split into its parts (env dynamics, render (with the
  encoder, for an SRL model), policy, action sampling; env dynamics and
  render per family of a mixed batch), each timed over 128 steps with a
  synchronise between parts (auto-resets left out);
* under ``torch.profiler``, one more update: device time by kernel (top 12),
  kernel launches per update and per env step, and the device's busy and
  idle share of the update's wall time.

The last line is one JSON object with the same numbers. Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.core.mixed_env import MixedEnv, MixedVecEnv
from srl_tpu_torch.envs.registry import registered_env
from srl_tpu_torch.experiments.train import make_with_options
from srl_tpu_torch.srl.registry import registered_srl


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def rollout_split(agent: PPO2, state, gen, n_steps: int) -> dict:
    """Seconds per part over ``n_steps`` steps, synchronising between parts;
    env dynamics and render per family of a mixed batch."""
    vec = agent.vec_env
    # (label suffix, env, its slots [lo, hi) of the batch, action table).
    if isinstance(vec, MixedVecEnv):
        families = [(f" {v.env.name}", v.env, vec._offsets[i], vec._offsets[i + 1],
                     vec._table(i, state.obs.device)) for i, v in enumerate(vec.vecs)]
        env_states = [vs.env_state for vs in state.vstate]
    else:
        families = [("", agent.env, 0, vec.num_envs, None)]
        env_states = [state.vstate.env_state]
    parts = dict(policy=0.0, sample=0.0)
    obs = state.obs
    with torch.no_grad():
        for _ in range(n_steps):
            (dist, _), t = _sync_time(lambda: agent.apply(state.params, obs))
            parts["policy"] += t
            action, t = _sync_time(lambda: dist.sample(gen))
            parts["sample"] += t
            frames = []
            for k, (name, env, lo, hi, table) in enumerate(families):
                a = action[lo:hi] if table is None else table[action[lo:hi].long()]
                noise = env.draw_step_noise(gen, hi - lo)
                (env_states[k], _, _), t = _sync_time(
                    lambda: env.apply_step(env_states[k], a, noise))
                parts["env_step" + name] = parts.get("env_step" + name, 0.0) + t
                frame, t = _sync_time(lambda: env.observe(env_states[k]))
                parts["render" + name] = parts.get("render" + name, 0.0) + t
                frames.append(frame)
            obs = torch.cat(frames)
    return parts


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--env", default="KukaButtonGymEnv-v0",
                        choices=list(registered_env.keys()))
    parser.add_argument("--srl-model", default="raw_pixels",
                        choices=list(registered_srl.keys()))
    parser.add_argument("--srl-model-path", default=None,
                        help="checkpoint of a learned --srl-model")
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--mixed-envs", nargs="+", default=None, metavar="ENV_ID",
                        choices=list(registered_env.keys()),
                        help="profile one learner on a batch of these env families")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_slice measures the card and needs CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # Kuka's pixel run traces at render scale 2 with coarse observations,
    # an encoder reads the upsampled 224x224 frames; the MobileRobot envs
    # take neither option.
    # A mixed batch shares 224x224 frames, so Kuka traces at render scale 2
    # and upsamples there too.
    options = dict(srl_model=args.srl_model, render_scale=2,
                   coarse_obs=args.srl_model == "raw_pixels" and not args.mixed_envs)
    wrap = lambda e: e
    if args.srl_model_path is not None:
        from srl_tpu_torch.srl.models import SRLEncodedEnv, loadSRLModel

        model = loadSRLModel(args.srl_model_path, device="cuda")
        wrap = lambda e: SRLEncodedEnv(e, model)
    if args.mixed_envs:
        env = MixedEnv([wrap(make_with_options(e, options)) for e in args.mixed_envs],
                       oob_action="modulo")
    else:
        env = wrap(make_with_options(args.env, options))
    agent = PPO2(env=env, num_envs=args.num_envs, device="cuda")
    agent.n_updates = 3
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    state = agent.init_state(gen, args.seed)
    state, _ = agent.train_iteration(state, gen)  # warm-up: cuDNN plans, allocator

    (state, _), t_update = _sync_time(lambda: agent.train_iteration(state, gen))
    n_steps = agent.config.n_steps
    from srl_tpu_torch.agents.common import collect_rollout

    policy = lambda obs: agent.apply(state.params, obs)
    _, t_rollout = _sync_time(lambda: collect_rollout(
        agent.vec_env, policy, state.vstate, state.obs, state.obs_norm, gen, n_steps))
    split = rollout_split(agent, state, gen, n_steps)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (state, _), t_prof = _sync_time(lambda: agent.train_iteration(state, gen))
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
    busy_us = sum(dev_us(e) for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=dev_us, reverse=True)[:12]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    result = {
        "card": smi.splitlines()[0],
        "env": args.mixed_envs or args.env,
        "srl_model": args.srl_model,
        "num_envs": args.num_envs,
        "update_s": t_update,
        "rollout_s": t_rollout,
        "epochs_s": t_update - t_rollout,
        "env_steps_per_s": n_steps * args.num_envs / t_update,
        "rollout_split_s": split,
        "profiled_update_s": t_prof,
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / t_prof,
        "kernel_launches_per_update": launches,
        "kernel_launches_per_env_step": launches / n_steps,
        "top_kernels_ms": {e.key[:80]: dev_us(e) / 1e3 for e in top},
    }
    print(f"card: {result['card']}; {result['env']} {args.srl_model}, {args.num_envs} envs")
    print(f"update {t_update:.3f} s = rollout {t_rollout:.3f} s + epochs "
          f"{t_update - t_rollout:.3f} s; {result['env_steps_per_s']:.0f} env-steps/s")
    print("rollout split (s over 128 steps, synchronised): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    print(f"profiled update {t_prof:.3f} s: device busy {busy_us / 1e6:.3f} s, idle "
          f"share {result['device_idle_share']:.3f}, {launches} kernel launches "
          f"({launches / n_steps:.1f} per env step)")
    for name, ms in result["top_kernels_ms"].items():
        print(f"  {ms:9.2f} ms  {name}")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
