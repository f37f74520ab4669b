from .checkpoint import (
    load_checkpoint,
    load_torch_state_dict,
    params_to_torch_state_dict,
    save_checkpoint,
    save_torch_state_dict,
    torch_state_dict_to_params,
)
from .convert import (
    latents_from_numpy,
    params_from_numpy,
    params_to_numpy,
)

__all__ = [
    "latents_from_numpy",
    "params_from_numpy",
    "params_to_numpy",
    "load_checkpoint",
    "load_torch_state_dict",
    "params_to_torch_state_dict",
    "save_checkpoint",
    "save_torch_state_dict",
    "torch_state_dict_to_params",
]
