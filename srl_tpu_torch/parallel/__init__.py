from srl_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_params, shard_ppo_state
from srl_tpu_torch.parallel import distributed

__all__ = [
    "make_mesh",
    "shard_batch",
    "shard_params",
    "shard_ppo_state",
    "distributed",
]
