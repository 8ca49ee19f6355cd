"""RL algorithm registry (counterpart of srl_tpu/agents/registry.py): name
-> (agent class, AlgoType, allowed ActionTypes), for the agents ported so
far; the reference's entries for them."""
from __future__ import annotations

from srl_tpu_torch.agents import ActionType, AlgoType
from srl_tpu_torch.agents.a2c import A2C
from srl_tpu_torch.agents.ppo import PPO2
from srl_tpu_torch.agents.ppo1 import PPO1
from srl_tpu_torch.agents.trpo import TRPO
from srl_tpu_torch.core.registry import Registry

registered_rl: Registry = Registry("rl algo")
_BOTH = [ActionType.DISCRETE, ActionType.CONTINUOUS]
registered_rl.register("a2c", (A2C, AlgoType.REINFORCEMENT_LEARNING, _BOTH))
registered_rl.register("ppo2", (PPO2, AlgoType.REINFORCEMENT_LEARNING, _BOTH))
registered_rl.register("ppo1", (PPO1, AlgoType.REINFORCEMENT_LEARNING, _BOTH))
registered_rl.register("trpo", (TRPO, AlgoType.REINFORCEMENT_LEARNING, _BOTH))


def resolve_policy_class(algo: str, policy: str = "auto"):
    """The agent class of an (algo, policy) pair. The recurrent policies
    route to the Recurrent* agents in the reference; those are not ported
    yet."""
    algo_class = registered_rl[algo][0]
    if "lstm" not in (policy or ""):
        return algo_class
    raise NotImplementedError(
        f"--policy {policy} (the recurrent agents) is not ported to srl_tpu_torch "
        "yet (A11 step 4); use srl_tpu.experiments.train for it")
