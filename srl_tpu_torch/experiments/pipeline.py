"""Benchmark grid: every {env x srl_model x seed} trained in turn
(counterpart of srl_tpu/experiments/pipeline.py).

``validate_srl_models`` checks ``config/srl_models.yaml`` (read without
PyYAML, ``utils/yaml_subset``) for every requested env, as the
reference does, then ``run_grid`` trains each run in this process through
``experiments/train.main``; a failed run raises ``ChildProcessError``.
Arguments the pipeline does not know pass on to every run.

    python -m srl_tpu_torch.experiments.pipeline --env MobileRobotGymEnv-v0 \\
        --srl-model ground_truth raw_pixels --num-iteration 3 \\
        --num-timesteps 100000 [--device cpu] [-- train flags, e.g. --num-envs 256]
"""
from __future__ import annotations

import argparse
import os
import traceback

from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.envs.registry import registered_env
from srl_tpu_torch.srl import SRLType
from srl_tpu_torch.srl.registry import registered_srl
from srl_tpu_torch.utils.logging import printGreen, printYellow
from srl_tpu_torch.utils.yaml_subset import read_yaml_subset


def validate_srl_models(srl_models: list, envs: list, config_file: str):
    """Every env and srl model is registered, and every learned model is
    declared for every env in ``config_file`` (a missing checkpoint only
    warns: it may be trained later)."""
    all_models = read_yaml_subset(config_file) or {}
    for env in envs:
        assert env in registered_env, f"Error: unknown env {env}"
        for model in srl_models:
            assert model in registered_srl, f"Error: unknown srl model {model}"
            if registered_srl[model]["type"] != SRLType.SRL:
                continue
            assert env in all_models, f"Error: env {env} missing from {config_file}"
            assert model in all_models[env], (
                f"Error: srl model {model} not declared for env {env} in {config_file}")
            path = os.path.join(all_models[env].get("log_folder", ""), all_models[env][model])
            if not os.path.exists(path):
                printYellow(f"Warning: checkpoint for {env}/{model} not found at {path} "
                            f"(train it first)")


def run_grid(envs, srl_models, algo="ppo2", num_timesteps=1_000_000, num_iteration=15,
             seed=0, log_dir="logs/", srl_config_file="config/srl_models.yaml",
             extra_args=None, device="cuda") -> list:
    """Train every {env x srl_model x seed} on ``device``, seeds ``seed`` to
    ``seed + num_iteration - 1``; returns the run directories."""
    from srl_tpu_torch.experiments.train import main as train_main

    run_dirs = []
    for env in envs:
        for model in srl_models:
            for it in range(num_iteration):
                run_seed = seed + it
                printGreen(f"\n=== {env} | {model} | {algo} | seed {run_seed} ===")
                argv = ["--algo", algo, "--env", env, "--srl-model", model,
                        "--num-timesteps", str(num_timesteps), "--seed", str(run_seed),
                        "--log-dir", log_dir, "--srl-config-file", srl_config_file,
                        "--no-vis", "--device", str(device)] + list(extra_args or [])
                try:
                    run_dirs.append(train_main(argv))
                except Exception as e:
                    traceback.print_exc()
                    raise ChildProcessError(
                        f"An error occurred for {env}/{model} seed {run_seed}: {e}") from e
    return run_dirs


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(
        description="Pipeline script for benchmarking SRL models on RL tasks")
    parser.add_argument("--algo", type=str, default="ppo2")
    parser.add_argument("--env", type=str, nargs="+", default=["KukaButtonGymEnv-v0"])
    parser.add_argument("--srl-model", type=str, nargs="+",
                        default=["raw_pixels", "ground_truth"])
    parser.add_argument("--num-timesteps", type=int, default=int(1e6))
    parser.add_argument("--num-iteration", type=int, default=15,
                        help="Number of seeds per config")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--log-dir", type=str, default="logs/")
    parser.add_argument("--srl-config-file", type=str, default="config/srl_models.yaml")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, extra = parser.parse_known_args(argv)
    device = resolve_device(args.device)

    validate_srl_models(args.srl_model, args.env, args.srl_config_file)
    return run_grid(args.env, args.srl_model, args.algo, args.num_timesteps,
                    args.num_iteration, args.seed, args.log_dir, args.srl_config_file,
                    extra_args=extra, device=device.type)


if __name__ == "__main__":
    main()
