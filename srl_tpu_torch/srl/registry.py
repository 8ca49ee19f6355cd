"""SRL model registry (counterpart of srl_tpu/srl/registry.py): name ->
{type, env restriction, loss set, split dimensions}, the same 24 entries."""
from __future__ import annotations

from srl_tpu_torch.core.registry import Registry


def _entry(srl_type, limited_to=None, losses=None, splits=None):
    return {
        "type": srl_type,
        "limited_to": limited_to,
        "losses": losses or [],
        # Split-dimension map (loss -> slice width, -1 = the remaining dims);
        # empty = every loss reads the whole state vector.
        "splits": splits or {},
    }


registered_srl: Registry = Registry("srl_model")


def _register_all():
    from srl_tpu_torch.srl import SRLType

    env_modes = {
        "raw_pixels": None,
        "ground_truth": None,
        "joints": ["KukaButtonGymEnv-v0"],
        "joints_position": ["KukaButtonGymEnv-v0"],
    }
    for name, limited in env_modes.items():
        registered_srl.register(name, _entry(SRLType.ENVIRONMENT, limited))

    learned = {
        "robotic_priors": ["priors"],
        "inverse": ["inverse"],
        "forward": ["forward"],
        "multi_view_srl": ["triplet"],
        "srl_combination": ["autoencoder", "inverse", "forward"],
        "supervised": ["supervised"],
        "autoencoder": ["autoencoder"],
        "autoencoder_inverse": ["autoencoder", "inverse"],
        "autoencoder_reward": ["autoencoder", "reward"],
        "autoencoder_forward": ["autoencoder", "forward"],
        "random": [],  # random frozen encoder
        "random_inverse": ["inverse"],
        "reward_inverse": ["reward", "inverse"],
        "reward": ["reward"],
        "vae": ["vae"],
        "dae": ["dae"],
        "pca": ["pca"],
    }
    for name, losses in learned.items():
        registered_srl.register(name, _entry(SRLType.SRL, None, losses))

    split_models = {
        "srl_splits": (
            ["autoencoder", "reward", "inverse"],
            {"autoencoder": -1, "reward": 2, "inverse": 2},
        ),
        "srl_split_forward": (
            ["autoencoder", "forward"],
            {"autoencoder": -1, "forward": 2},
        ),
        "srl_3_splits": (
            ["autoencoder", "inverse", "forward"],
            {"autoencoder": -1, "inverse": 2, "forward": 2},
        ),
    }
    for name, (losses, splits) in split_models.items():
        registered_srl.register(name, _entry(SRLType.SRL, None, losses, splits))


_register_all()
