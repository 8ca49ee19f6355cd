"""Environment registry (counterpart of srl_tpu/envs/registry.py): env id ->
(env class, plotting type), as the reference's ``registered_env`` holds
them."""
from __future__ import annotations

from enum import Enum

from srl_tpu_torch.core.registry import Registry
from srl_tpu_torch.envs.car_racing import CarRacingEnv
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
from srl_tpu_torch.envs.omnirobot import OmniRobotEnv


class PlottingType(Enum):
    PLOT_2D = 1
    PLOT_3D = 2


registered_env: Registry = Registry("env")
for _cls, _plot in (
        (MobileRobotEnv, PlottingType.PLOT_2D), (MobileRobot1DEnv, PlottingType.PLOT_2D),
        (MobileRobot2TargetEnv, PlottingType.PLOT_2D),
        (MobileRobotLineTargetEnv, PlottingType.PLOT_2D),
        (KukaButtonEnv, PlottingType.PLOT_3D), (KukaRandButtonEnv, PlottingType.PLOT_3D),
        (Kuka2ButtonEnv, PlottingType.PLOT_3D), (KukaMovingButtonEnv, PlottingType.PLOT_3D),
        (OmniRobotEnv, PlottingType.PLOT_2D), (CarRacingEnv, PlottingType.PLOT_2D)):
    registered_env.register(_cls.name, (_cls, _plot))


def make_env(env_id: str, **kwargs):
    """Construct a registered env; an unknown id raises KeyError naming the
    known ones."""
    env_class, _ = registered_env[env_id]
    return env_class(**kwargs)
