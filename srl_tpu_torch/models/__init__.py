from srl_tpu_torch.models.policies import ActorCritic, MlpTorso, NatureCnnTorso, make_policy

__all__ = ["ActorCritic", "MlpTorso", "NatureCnnTorso", "make_policy"]
