"""RL algorithm registry (counterpart of srl_tpu/agents/registry.py): name
-> (agent class, AlgoType, allowed ActionTypes), the reference's twelve
entries."""
from __future__ import annotations

from srl_tpu_torch.agents import ActionType, AlgoType
from srl_tpu_torch.agents.a2c import A2C, RecurrentA2C
from srl_tpu_torch.agents.acer import ACER, RecurrentACER
from srl_tpu_torch.agents.acktr import ACKTR, RecurrentACKTR
from srl_tpu_torch.agents.ars import ARS
from srl_tpu_torch.agents.cma_es import CMAES
from srl_tpu_torch.agents.ddpg import DDPG
from srl_tpu_torch.agents.dqn import DQN
from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.agents.ppo1 import PPO1
from srl_tpu_torch.agents.random_agent import RandomAgent
from srl_tpu_torch.agents.recurrent_ppo import RecurrentPPO2
from srl_tpu_torch.agents.sac import SAC
from srl_tpu_torch.agents.trpo import TRPO
from srl_tpu_torch.core.registry import Registry

registered_rl: Registry = Registry("rl algo")
_BOTH = [ActionType.DISCRETE, ActionType.CONTINUOUS]
registered_rl.register("a2c", (A2C, AlgoType.REINFORCEMENT_LEARNING, _BOTH))
registered_rl.register("acer", (ACER, AlgoType.REINFORCEMENT_LEARNING,
                                [ActionType.DISCRETE]))
registered_rl.register("acktr", (ACKTR, AlgoType.REINFORCEMENT_LEARNING,
                                 [ActionType.DISCRETE]))
registered_rl.register("deepq", (DQN, AlgoType.REINFORCEMENT_LEARNING,
                                 [ActionType.DISCRETE]))
registered_rl.register("ppo2", (PPO2, AlgoType.REINFORCEMENT_LEARNING, _BOTH))
registered_rl.register("ppo1", (PPO1, AlgoType.REINFORCEMENT_LEARNING, _BOTH))
registered_rl.register("trpo", (TRPO, AlgoType.REINFORCEMENT_LEARNING, _BOTH))
registered_rl.register("ars", (ARS, AlgoType.EVOLUTION_STRATEGIES, _BOTH))
registered_rl.register("cma-es", (CMAES, AlgoType.EVOLUTION_STRATEGIES, _BOTH))
registered_rl.register("random_agent", (RandomAgent, AlgoType.OTHER, _BOTH))
registered_rl.register("sac", (SAC, AlgoType.REINFORCEMENT_LEARNING, [ActionType.CONTINUOUS]))
registered_rl.register("ddpg", (DDPG, AlgoType.REINFORCEMENT_LEARNING, [ActionType.CONTINUOUS]))

# The agent class of each algo with an lstm/lnlstm/cnnlstm/cnnlnlstm policy.
_RECURRENT = {"ppo2": RecurrentPPO2, "a2c": RecurrentA2C, "acer": RecurrentACER,
              "acktr": RecurrentACKTR}


def resolve_policy_class(algo: str, policy: str = "auto"):
    """The agent class of an (algo, policy) pair: the recurrent policies
    route to the Recurrent* agents, as the reference's policy selection
    does; the other algos have none (the reference's AssertionError)."""
    if "lstm" not in (policy or ""):
        return registered_rl[algo][0]
    if algo in _RECURRENT:
        return _RECURRENT[algo]
    raise AssertionError("Error: recurrent policies are currently supported for "
                         "ppo2, a2c, acer and acktr")
