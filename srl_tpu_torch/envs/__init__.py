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
from srl_tpu_torch.envs.registry import PlottingType, make_env, registered_env

__all__ = [
    "KukaButtonEnv",
    "KukaRandButtonEnv",
    "Kuka2ButtonEnv",
    "KukaMovingButtonEnv",
    "MobileRobotEnv",
    "MobileRobot1DEnv",
    "MobileRobot2TargetEnv",
    "MobileRobotLineTargetEnv",
    "OmniRobotEnv",
    "CarRacingEnv",
    "PlottingType",
    "registered_env",
    "make_env",
]
