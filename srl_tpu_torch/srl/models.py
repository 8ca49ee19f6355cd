"""SRL model serving (counterpart of srl_tpu/srl/models.py): load a trained
encoder and apply it to a batch of frames on the device.

``loadSRLModel`` reads the reference's checkpoints unchanged
(``srl_model.pkl`` with the Flax tree, or ``pca.pkl``); ``SRLEncodedEnv``
wraps a batched pixel env so that its observation is the encoder's state,
``model.getStates(env.render_pixels(state))`` (render -> encode -> act).
Encoders run under ``torch.inference_mode()``; what they return is an
ordinary tensor (a clone made outside it), so a rollout may store it and a
training step read it.
"""
from __future__ import annotations

import json
import os
import pickle
from typing import Optional

import numpy as np
import torch

from srl_tpu_torch import bridge
from srl_tpu_torch.core.device import resolve_device
from srl_tpu_torch.core.env import BatchedEnv
from srl_tpu_torch.core.spaces import Box, Space
from srl_tpu_torch.srl.nets import SRLModules


def getSRLDim(path: Optional[str] = None, env=None) -> int:
    """The state dimension from the exp_config.json beside the checkpoint,
    else the env's ground-truth dimension."""
    if path is not None:
        with open(os.path.join(os.path.dirname(path), "exp_config.json")) as f:
            return json.load(f)["state-dim"]
    return env.ground_truth_dim()


class SRLBaseModel:
    state_dim: int = -1

    def getState(self, observations) -> torch.Tensor:
        """[B, ...obs] -> [B, state_dim] (one observation -> [state_dim])."""
        raise NotImplementedError

    def getStates(self, observations) -> torch.Tensor:
        return self.getState(observations)


class SRLNeuralNetwork(SRLBaseModel):
    """A trained ``SRLModules`` encoder."""

    def __init__(self, payload: dict, device="cuda"):
        cfg = payload["exp_config"]
        self.device = resolve_device(device)
        self.state_dim = cfg["state-dim"]
        self.losses = cfg["losses"]
        self.image_obs = cfg.get("model-type", "custom_cnn") != "mlp"
        self.obs_shape = tuple(cfg.get("obs-shape", (224, 224, 3)))
        # A split map whose widths sum to 0 means no split.
        split = cfg.get("split-dimensions") or {}
        if sum(split.values()) == 0:
            split = {}
        self.split_dimensions = split
        self.model = SRLModules(self.state_dim, self.losses, self.obs_shape, self.image_obs,
                                cfg.get("n_actions", 4), split)
        self.model.load_state_dict(bridge.srl_flax_to_state_dict(payload["params"]))
        self.model.to(self.device).eval().requires_grad_(False)

    def getState(self, observations) -> torch.Tensor:
        obs = torch.as_tensor(observations, device=self.device)
        squeeze = obs.dim() == len(self.obs_shape)
        if squeeze:
            obs = obs[None]
        if "triplet" not in self.losses and obs.shape[-1] > self.obs_shape[-1]:
            obs = obs[..., : self.obs_shape[-1]]  # the first view of a 6-channel env
        with torch.inference_mode():
            out = self.model.encode(obs)
        out = out.clone()
        return out[0] if squeeze else out


class SRLPCA(SRLBaseModel):
    """The PCA baseline: one projection of the flattened frame."""

    def __init__(self, payload: dict, device="cuda"):
        self.device = resolve_device(device)
        self.state_dim = payload["state_dim"]
        self.mean = torch.as_tensor(np.asarray(payload["mean"]), device=self.device)
        self.components = torch.as_tensor(np.asarray(payload["components"]),
                                          device=self.device)  # [F, D]

    def getState(self, observations) -> torch.Tensor:
        obs = torch.as_tensor(observations, device=self.device).to(torch.float32)
        squeeze = obs.dim() == 3
        if squeeze:
            obs = obs[None]
        out = (obs.reshape(obs.shape[0], -1) / 255.0 - self.mean) @ self.components
        return out[0] if squeeze else out


def loadSRLModel(path: Optional[str] = None, state_dim: int = -1, env=None,
                 device="cuda") -> SRLBaseModel:
    """Load an SRL model: a 'pca' checkpoint (or one holding ``components``)
    is the PCA baseline, anything else an encoder. Only load files this
    program or the reference wrote: unpickling runs code."""
    if path is None:
        raise ValueError("No path to the SRL model given")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if "components" in payload or "pca" in path:
        return SRLPCA(payload, device)
    return SRLNeuralNetwork(payload, device)


class SRLEncodedEnv(BatchedEnv):
    """A batched pixel env whose observation is ``srl_model``'s state of
    its rendered frame. Dynamics, noise, ground truth and every other
    attribute come from the wrapped env; ``srl_model`` reads
    ``"srl_encoded"``, so that PPO2 normalizes the observations."""

    # Never taken from a wrapped env: a mixed-family env would have its
    # families vectorized raw, and the encoder skipped.
    is_mixed_family = False

    def __init__(self, env: BatchedEnv, srl_model: SRLBaseModel):
        if getattr(env, "is_mixed_family", False):
            raise ValueError(
                "SRLEncodedEnv cannot wrap a MixedEnv: the per-family "
                "VecEnvs would vectorize the raw families and skip the "
                "encoder. Wrap each family instead: "
                "MixedEnv([SRLEncodedEnv(f, model) for f in families])")
        self._env = env
        self._srl = srl_model
        self.srl_model = "srl_encoded"
        self.state_dim = srl_model.state_dim
        self.relative_pos = env.relative_pos
        self.max_steps = env.max_steps

    def __getattr__(self, name):
        # Nothing named observe* is forwarded: an observation of the wrapped
        # env would be raw pixels, with the encoder skipped.
        if name == "_env" or name.startswith("observe"):
            raise AttributeError(name)
        return getattr(self._env, name)

    @property
    def action_space(self) -> Space:
        return self._env.action_space

    @property
    def observation_space(self) -> Space:
        return Box(-np.inf, np.inf, (self.state_dim,))

    def draw_reset_noise(self, gen: torch.Generator, n: int) -> dict:
        return self._env.draw_reset_noise(gen, n)

    def apply_reset(self, noise: dict):
        return self._env.apply_reset(noise)

    def draw_step_noise(self, gen: torch.Generator, n: int) -> dict:
        return self._env.draw_step_noise(gen, n)

    def apply_step(self, state, action, noise: dict):
        return self._env.apply_step(state, action, noise)

    def observe(self, state) -> torch.Tensor:
        return self._srl.getStates(self._env.render_pixels(state))

    def render_pixels(self, state) -> torch.Tensor:
        return self._env.render_pixels(state)

    def ground_truth(self, state) -> torch.Tensor:
        return self._env.ground_truth(state)

    def ground_truth_dim(self) -> int:
        return self._env.ground_truth_dim()

    def target_pos(self, state) -> torch.Tensor:
        return self._env.target_pos(state)
