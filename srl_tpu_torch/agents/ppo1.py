"""PPO1 (counterpart of srl_tpu/agents/ppo1.py): PPO2's machinery with
stable-baselines PPO1's defaults (256 steps per actor batch, clip 0.2,
ent_coef 0.01, 4 optim epochs, Adam 1e-3 linearly annealed, minibatch 64 at
256 steps, gamma 0.99, lam 0.95).

The original's MPI gradient averaging is PPO2's dp mesh: a state from
``parallel.shard_ppo_state`` trains over the ranks of its mesh as PPO2's
does (``agents/ppo.py``), the lr anneal included."""
from __future__ import annotations

from srl_tpu_torch.agents.ppo import PPO2, PPOConfig


class PPO1(PPO2):
    name = "ppo1"

    def __init__(self, env=None, num_envs: int = 8, policy: str = "auto",
                 config: PPOConfig = None, normalize_obs=None, device="cuda"):
        if config is None:
            config = PPOConfig(n_steps=256, nminibatches=4, noptepochs=4, cliprange=0.2,
                               learning_rate=1e-3, lr_linear_decay=True, ent_coef=0.01,
                               vf_coef=0.5, max_grad_norm=0.5, gamma=0.99, lam=0.95)
        super().__init__(env=env, num_envs=num_envs, policy=policy, config=config,
                         normalize_obs=normalize_obs, device=device)

    @classmethod
    def getOptParam(cls):
        return {
            "lam": (float, (0, 1)),
            "gamma": (float, (0, 1)),
            "learning_rate": (float, (1e-2, 1e-5)),
            "ent_coef": (float, (0, 1)),
            "cliprange": (float, (0, 1)),
            "noptepochs": (int, (1, 10)),
            "n_steps": (int, (64, 2048)),
        }
