from .factory import (
    get_mcpc_trainer,
    get_mcpc_trainer_one_sample,
    get_model,
    get_pc_trainer,
)

__all__ = [
    "get_mcpc_trainer",
    "get_mcpc_trainer_one_sample",
    "get_model",
    "get_pc_trainer",
]
