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
from .trainer import GenerativeModel, LangevinStep

__all__ = [
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
    "GenerativeModel",
    "LangevinStep",
]
