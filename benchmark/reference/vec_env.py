"""The vector env's semantics, written plainly: the env ids of the
configurations, and one auto-resetting step (stable-baselines: where an
episode ends, ``done`` is set for that step, the state is the new episode's
first, and the finished episode's return and length ride on the step)."""
from __future__ import annotations

import dataclasses
import inspect

import torch

from .kuka import KukaButtonEnv, KukaState
from .mobile_robot import MobileRobotEnv, MobileRobotState

# env id -> (env class, its state class)
ENVS = {"KukaButtonGymEnv-v0": (KukaButtonEnv, KukaState),
        "MobileRobotGymEnv-v0": (MobileRobotEnv, MobileRobotState)}


def make_env(env_id: str, options: dict):
    """The env ``env_id`` with the entries of ``options`` its constructor
    takes."""
    cls = ENVS[env_id][0]
    accepted = inspect.signature(cls.__init__).parameters
    return cls(**{k: v for k, v in options.items() if k in accepted})


def state_of(env_id: str, fields: dict):
    """The state dataclass of ``env_id``'s env from a dict of its fields."""
    return ENVS[env_id][1](**fields)


def fields_of(state) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def step(env, state, ep_return, ep_length, action, step_noise, reset_noise):
    """One auto-resetting step of every env: (state', reward, done,
    ep_return', ep_length'). ``reset_noise`` is the fresh episodes' draw,
    needed where any episode ended (None otherwise)."""
    new, reward, done = env.apply_step(state, action, step_noise)
    ep_return = ep_return + reward
    ep_length = ep_length + 1
    if bool(done.any()):
        if reset_noise is None:
            raise ValueError("an episode ended and no reset was drawn")
        fresh = env.apply_reset(reset_noise)
        new = type(new)(**{
            k: torch.where(done.reshape(done.shape + (1,) * (v.dim() - 1)),
                           getattr(fresh, k), v)
            for k, v in fields_of(new).items()})
    return (new, reward, done, torch.where(done, 0.0, ep_return),
            torch.where(done, 0, ep_length))
