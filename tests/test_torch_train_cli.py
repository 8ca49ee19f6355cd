"""The port's training CLI on the CPU: it writes the reference's run-dir
layout, and the reference's ``PPO2.load`` reads its checkpoint."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from srl_tpu.agents.ppo import PPO2 as JPPO2
from srl_tpu.envs.kuka import KukaButtonEnv as JKuka
from srl_tpu_torch import bridge
from srl_tpu_torch.agents.ppo import PPO2
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


@pytest.mark.parametrize("flags", [["--algo", "sac"], ["--algo", "ddpg"], ["--algo", "ars"],
                                   ["--algo", "cma-es"], ["--algo", "random_agent"]],
                         ids=" ".join)
def test_cli_rejects_flags_not_ported(flags, capsys):
    with pytest.raises(SystemExit):
        train.parse_args(["--device", "cpu"] + flags)
    assert "not ported" in capsys.readouterr().err
