from .engine import EngineConfig, EngineState, build_train_on_batch
from .losses import bernoulli_fn, bernoulli_fn_mask, fe_fn, fe_fn_mask, zero_fn
from .model import PCModel, make_mlp_model
from .modules import (
    PC,
    Activation,
    Linear,
    constant_init,
    forward_init,
    gaussian_energy,
    normal_init,
    sample_x_fn,
    sample_x_fn_cte,
    sample_x_fn_normal,
    scaled_gaussian_energy,
    uniform_init,
)
from .optim import OptimizerSpec
from .schedule import SchedulePlan, build_plan, parse_schedule
from .trainer import GenerativeModel, LangevinStep, PCTrainer

__all__ = [
    "EngineConfig",
    "EngineState",
    "build_train_on_batch",
    "bernoulli_fn",
    "bernoulli_fn_mask",
    "fe_fn",
    "fe_fn_mask",
    "zero_fn",
    "PCModel",
    "make_mlp_model",
    "PC",
    "Activation",
    "Linear",
    "constant_init",
    "forward_init",
    "gaussian_energy",
    "normal_init",
    "sample_x_fn",
    "sample_x_fn_cte",
    "sample_x_fn_normal",
    "scaled_gaussian_energy",
    "uniform_init",
    "OptimizerSpec",
    "SchedulePlan",
    "build_plan",
    "parse_schedule",
    "GenerativeModel",
    "LangevinStep",
    "PCTrainer",
]
