"""K PPO updates per call (``updates_per_call``) in the port, on the CPU:
the mirrors of tests/test_updates_per_call.py (the update count, the
callback's surface), the reference's rounding up to whole calls of K
updates, and K = 3 against K = 1 bit for bit (the same updates, one host
sync of the episode statistics per call)."""
import numpy as np
import pytest
import torch

from srl_tpu_torch.agents.ppo import PPO2, PPOConfig
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv

torch.set_num_threads(1)


def agent(max_steps=30):
    return PPO2(env=MobileRobotEnv(max_steps=max_steps), num_envs=4,
                config=PPOConfig(n_steps=8), device="cpu")


@pytest.mark.parametrize("n_updates, k, expect", [(6, 3, 6), (4, 3, 6)])
def test_updates_per_call_equivalent_count(n_updates, k, expect):
    state = agent().learn(total_timesteps=8 * 4 * n_updates, seed=0, updates_per_call=k)
    assert state.update_idx == expect


def test_updates_per_call_metrics_surface():
    entries = []
    agent(max_steps=20).learn(total_timesteps=8 * 4 * 4, seed=0, updates_per_call=2,
                              callback=lambda l, g: entries.append(dict(l)))
    assert len(entries) == 2
    assert [e["update"] for e in entries] == [1, 3]
    assert np.isfinite(float(entries[-1]["metrics"]["pg_loss"]))
    assert entries[-1]["num_timesteps"] == 8 * 4 * 4
    assert len(entries[-1]["episode_returns"]) == len(entries[-1]["episode_lengths"]) > 0


def test_three_updates_per_call_equal_one():
    one, three = agent(), agent()
    s1 = one.learn(total_timesteps=8 * 4 * 6, seed=2, updates_per_call=1)
    s3 = three.learn(total_timesteps=8 * 4 * 6, seed=2, updates_per_call=3)
    for k, v in s1.params.items():
        assert torch.equal(v, s3.params[k]), k
    for part in ("mu", "nu"):
        for k, v in s1.opt_state[part].items():
            assert torch.equal(v, s3.opt_state[part][k]), (part, k)
    assert s1.opt_state["count"] == s3.opt_state["count"] == 6 * 16
