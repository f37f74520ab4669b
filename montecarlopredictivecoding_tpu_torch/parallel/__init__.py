from .sweep import make_seed_states, stack_pytrees, sweep_warm_langevin_chains

__all__ = [
    "make_seed_states",
    "stack_pytrees",
    "sweep_warm_langevin_chains",
]
