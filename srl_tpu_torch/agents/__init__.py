"""The agents' enums (counterpart of srl_tpu/agents/__init__.py)."""
from enum import Enum


class AlgoType(Enum):
    REINFORCEMENT_LEARNING = 1
    EVOLUTION_STRATEGIES = 2
    OTHER = 3


class ActionType(Enum):
    DISCRETE = 1
    CONTINUOUS = 2
