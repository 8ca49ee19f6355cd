from srl_tpu_torch.envs.kuka import (
    Kuka2ButtonEnv,
    KukaButtonEnv,
    KukaMovingButtonEnv,
    KukaRandButtonEnv,
)
from srl_tpu_torch.envs.registry import make_env, registered_env

__all__ = [
    "KukaButtonEnv",
    "KukaRandButtonEnv",
    "Kuka2ButtonEnv",
    "KukaMovingButtonEnv",
    "registered_env",
    "make_env",
]
