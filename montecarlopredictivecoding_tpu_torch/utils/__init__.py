from .convert import (
    latents_from_numpy,
    params_from_numpy,
    params_to_numpy,
)

__all__ = [
    "latents_from_numpy",
    "params_from_numpy",
    "params_to_numpy",
]
