"""The port's training CLI on the CPU: it writes the reference's run-dir
layout, and the reference's ``PPO2.load`` reads its checkpoint; the flags
of SAC, DDPG, ARS, CMA-ES and the random agent parse and reach their
configs as in the reference's CLI."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.agents.registry import registered_rl as jregistry
from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
from srl_tpu.experiments import train as jtrain
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.agents.registry import registered_rl
from srl_tpu_torch.envs.kuka import KukaButtonEnv as TKuka
from srl_tpu_torch.experiments import train

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("logs")
    # 2 envs x 128 steps: one PPO update of the Nature CNN on 224x224 frames
    # traced at 32x32.
    log_dir = train.main(["--device", "cpu", "--num-envs", "2", "--render-scale", "7",
                          "--num-timesteps", "200", "--log-dir", str(root), "--no-vis"])
    return root, log_dir


def test_run_dir_has_the_reference_layout(run_dir):
    root, log_dir = run_dir
    rel = os.path.relpath(log_dir, root).split(os.sep)
    assert rel[:3] == ["KukaButtonGymEnv-v0", "raw_pixels", "ppo2"] and len(rel) == 4
    assert {"args.json", "env_globals.json", "0.monitor.csv", "metrics.jsonl",
            "ppo2_final_model.pkl"} <= set(os.listdir(log_dir))
    with open(os.path.join(log_dir, "args.json")) as f:
        args = json.load(f)
    assert args["env"] == "KukaButtonGymEnv-v0" and args["num_envs"] == 2
    with open(os.path.join(log_dir, "env_globals.json")) as f:
        assert json.load(f)["render_scale"] == 7
    with open(os.path.join(log_dir, "0.monitor.csv")) as f:
        header = json.loads(f.readline()[1:])
        assert header["env_id"] == "KukaButtonGymEnv-v0"
        assert f.readline().strip() == "r,l,t"
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        lines = [json.loads(x) for x in f]
    assert len(lines) == 1 and lines[0]["num_timesteps"] == 256
    assert all(np.isfinite(lines[0][k]) for k in ("pg_loss", "vf_loss", "entropy"))


def test_reference_loads_the_port_checkpoint(run_dir):
    _, log_dir = run_dir
    path = os.path.join(log_dir, "ppo2_final_model.pkl")
    jagent = JPPO2.load(path, env=JKuka(srl_model="raw_pixels", render_scale=7))
    agent = PPO2.load(path, env=TKuka(srl_model="raw_pixels", render_scale=7),
                      device="cpu")
    # The same parameters on both sides (the forward passes are held against
    # each other in tests/test_torch_policy.py).
    back = bridge.state_dict_to_flax(agent.state.params, "cnn")
    jax.tree.map(np.testing.assert_array_equal,
                 jax.tree.map(np.asarray, jagent.state.params), back)
    assert jagent.policy.torso == "cnn" and jagent.config.n_steps == 128


# Each algo's own flags (its customArguments), as a user passes them.
ALGO_FLAGS = {
    "sac": ["-c", "--num-envs", "8"],
    "ddpg": ["-c", "--noise-action", "normal", "--noise-action-sigma", "0.3", "--noise-param",
             "--noise-param-sigma", "0.1", "--batch-size", "64", "--memory-limit", "1000"],
    "ars": ["--num-population", "6", "--exploration-noise", "0.05", "--step-size", "0.01",
            "--top-population", "3", "--algo-type", "v1", "--max-step-amplitude", "5",
            "--deterministic"],
    "cma-es": ["--num-population", "8", "--mu", "0.1", "--sigma", "0.2", "--deterministic"],
    "random_agent": ["--num-envs", "8"],
}


@pytest.mark.parametrize("algo", list(ALGO_FLAGS))
def test_cli_parses_algo_flags(algo):
    """The algo's flags parse as in the reference's CLI and reach its config
    by the reference's rule: a flag that names a config field and differs
    from its default (DDPG's ``--memory-limit`` names none: the field is
    ``buffer_size``); the agent gets ``--num-envs`` where it takes it."""
    argv = ["--algo", algo] + ALGO_FLAGS[algo]
    parser = train.build_parser(argv + ["--device", "cpu"])
    args = parser.parse_args(argv + ["--device", "cpu"])
    jargs, jparser = jtrain.parse_args(argv)
    ours = vars(args)
    for k, v in vars(jargs).items():
        assert ours[k] == v, k
    jcls = jregistry[algo][0]
    kwargs = train.algo_kwargs(registered_rl[algo][0], args, parser, {}, "cpu")
    if hasattr(jcls(), "config"):
        cfg = dataclasses.asdict(jcls().config)
        cfg.update({k: v for k, v in vars(jargs).items()
                    if k in cfg and v is not None and jparser.get_default(k) != v})
        assert dataclasses.asdict(kwargs.get("config", registered_rl[algo][0](
            device="cpu").config)) == cfg
    else:
        assert "config" not in kwargs
    # The evolution strategies run one env per member and take no num_envs.
    assert kwargs.get("num_envs") == {"sac": 8, "random_agent": 8, "ddpg": 16}.get(algo)
    if algo == "ddpg":
        assert args.memory_limit == 1000 and kwargs["config"].buffer_size == 50000
        assert kwargs["config"].noise_param and kwargs["config"].batch_size == 64
