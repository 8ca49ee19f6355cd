"""The program's side of ``pca_mlp``: its env is the pixel env wrapped in
``SRLEncodedEnv`` around an ``SRLPCA`` (render, encode, act), both built
by their public constructors, and the PCA's leaves of a seed are copied
into the ``SRLPCA``'s tensors."""
from __future__ import annotations

import math
import weakref

import numpy as np

# The program's env -> the SRLPCA inside it.
MODELS = weakref.WeakKeyDictionary()


def make_env(cfg: dict, device):
    """The configuration's pixel env wrapped around a PCA of its frames
    (zeros until ``hand_in``)."""
    from srl_tpu_torch.experiments.train import make_with_options
    from srl_tpu_torch.srl.models import SRLPCA, SRLEncodedEnv

    inner = make_with_options(cfg["env_id"], cfg["env_options"])
    n_pixels, dim = math.prod(inner.observation_space.shape), cfg["state_dim"]
    model = SRLPCA({"state_dim": dim, "mean": np.zeros(n_pixels, np.float32),
                    "components": np.zeros((n_pixels, dim), np.float32)}, device)
    env = SRLEncodedEnv(inner, model)
    MODELS[env] = model
    return env


def hand_in(agent, frozen: dict) -> None:
    """The PCA's leaves ``srl.mean`` and ``srl.components`` put into the
    program's ``SRLPCA``, shapes checked."""
    model = MODELS[agent.env]
    for name, dst in (("srl.mean", model.mean), ("srl.components", model.components)):
        if tuple(dst.shape) != tuple(frozen[name].shape):
            raise ValueError(f"the program's {name} is {tuple(dst.shape)}, the "
                             f"reference's {tuple(frozen[name].shape)}")
        dst.copy_(frozen[name])
