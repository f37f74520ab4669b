from .fused_dp import make_dp_fused_chain, place_dp
from .mesh import best_mesh_shape, make_mesh
from .sharding import (
    latent_shardings,
    param_shardings,
    shard_train_on_batch,
)
from .sweep import make_seed_states, stack_pytrees, sweep_warm_langevin_chains

__all__ = [
    "best_mesh_shape",
    "make_dp_fused_chain",
    "make_mesh",
    "place_dp",
    "latent_shardings",
    "param_shardings",
    "shard_train_on_batch",
    "make_seed_states",
    "stack_pytrees",
    "sweep_warm_langevin_chains",
]
