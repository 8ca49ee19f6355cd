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

registered_env: Registry = Registry("env")
for _cls in (KukaButtonEnv, KukaRandButtonEnv, Kuka2ButtonEnv, KukaMovingButtonEnv):
    registered_env.register(_cls.name, _cls)


def make_env(env_id: str, **kwargs):
    """Construct a registered env; an unknown id raises KeyError naming the
    known ones."""
    return registered_env[env_id](**kwargs)
