"""Base RL agent (counterpart of srl_tpu/agents/base.py): the pickle
payload helpers shared by the agents."""
from __future__ import annotations

import os
import pickle

import torch


class BaseRLAgent:
    name = "base"
    LOG_INTERVAL = 10

    def __init__(self):
        self.state = None

    @staticmethod
    def _to_numpy(tree):
        """Tensors of a (nested) dict -> numpy arrays."""
        if isinstance(tree, dict):
            return {k: BaseRLAgent._to_numpy(v) for k, v in tree.items()}
        if isinstance(tree, torch.Tensor):
            return tree.detach().cpu().numpy()
        return tree

    @staticmethod
    def _save_pickle(path: str, payload: dict):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(payload, f)
