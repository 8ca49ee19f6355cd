"""The port learns: PPO2 on MobileRobotGymEnv-v0 from ground truth (the
quickstart configuration), 16 envs, on the CPU, with a pinned seed.

The bar is the toolbox's own (the mean of the last 20 episode returns
climbs from about 0 to above 3). Calibrated with this file run as a script
(``python -m tests.test_torch_learning``) on seeds 0-4: after 80k steps
those means were 13.55-19.25, while after 40k steps seeds 1 and 4 were
still at 0.75 and 0.25, so the test takes 80k steps (about 5 s here).
"""
import numpy as np
import torch

from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.envs.mobile_robot import MobileRobotEnv

torch.set_num_threads(1)


def episode_returns(seed: int, steps: int) -> list:
    agent = PPO2(env=MobileRobotEnv(), num_envs=16, device="cpu")
    returns = []

    def callback(_locals, _globals):
        returns[:] = _locals["episode_returns"]

    agent.learn(steps, seed=seed, callback=callback)
    return returns


def test_ppo2_learns_mobile_robot_from_ground_truth():
    returns = episode_returns(seed=0, steps=80_000)
    assert len(returns) >= 100
    early, late = np.mean(returns[:20]), np.mean(returns[-20:])
    assert early < 3 and late > 3, (early, late)


if __name__ == "__main__":
    for seed in range(5):
        means = {steps: np.mean(episode_returns(seed, steps)[-20:])
                 for steps in (40_000, 80_000)}
        print(f"seed {seed}: mean of the last 20 returns "
              + ", ".join(f"{v:.2f} after {k} steps" for k, v in means.items()))
