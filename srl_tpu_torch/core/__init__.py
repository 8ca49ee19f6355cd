from srl_tpu_torch.core.env import TpuEnv, Transition, VecEnv, VecEnvState
from srl_tpu_torch.core.registry import Registry
from srl_tpu_torch.core.spaces import Box, Discrete, Space

__all__ = [
    "Box",
    "Discrete",
    "Space",
    "TpuEnv",
    "Transition",
    "VecEnv",
    "VecEnvState",
    "Registry",
]
