"""State representation learning (counterpart of srl_tpu/srl): the model
registry, the encoder networks, their trainer, dataset recording and the
serving wrapper ``SRLEncodedEnv``."""
from enum import Enum


class SRLType(Enum):
    ENVIRONMENT = 1  # provided by the env itself (ground_truth, joints, pixels)
    SRL = 2  # learned encoder


from srl_tpu_torch.srl.registry import registered_srl  # noqa: E402

__all__ = ["SRLType", "registered_srl"]
