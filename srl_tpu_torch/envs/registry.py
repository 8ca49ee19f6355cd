"""Environment registry (counterpart of srl_tpu/envs/registry.py): env id ->
env class, for the envs the port has."""
from __future__ import annotations

from srl_tpu_torch.core.registry import Registry
from srl_tpu_torch.envs.kuka import (
    Kuka2ButtonEnv,
    KukaButtonEnv,
    KukaMovingButtonEnv,
    KukaRandButtonEnv,
)
from srl_tpu_torch.envs.mobile_robot import (
    MobileRobot1DEnv,
    MobileRobot2TargetEnv,
    MobileRobotEnv,
    MobileRobotLineTargetEnv,
)

registered_env: Registry = Registry("env")
for _cls in (KukaButtonEnv, KukaRandButtonEnv, Kuka2ButtonEnv, KukaMovingButtonEnv,
             MobileRobotEnv, MobileRobot1DEnv, MobileRobot2TargetEnv,
             MobileRobotLineTargetEnv):
    registered_env.register(_cls.name, _cls)


def make_env(env_id: str, **kwargs):
    """Construct a registered env; an unknown id raises KeyError naming the
    known ones."""
    return registered_env[env_id](**kwargs)
