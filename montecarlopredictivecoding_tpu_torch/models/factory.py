"""Model factory for the canonical experiment configurations.

``get_model`` builds the 4-Linear generative MLP with uniform(-10, 10)
latent init from a reference-style config dict.  Training goes through
``experiments/train_mnist.py``, which needs no trainer object; the trainer
factories of the JAX package (``get_pc_trainer``, ``get_mcpc_trainer``) come
with ``PCTrainer`` itself (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import typing as tp

import torch

from ..core.model import make_mlp_model
from ..core.modules import uniform_init
from ..core.trainer import GenerativeModel


def get_model(
    config: dict,
    generator: tp.Union[int, torch.Generator] = 0,
    sample_x_fn=uniform_init,
    output_pc=None,
    device="cuda",
) -> GenerativeModel:
    """Build the generative MLP + state handle from a config dict with keys
    ``input_size / hidden_size / hidden2_size / output_size /
    activation_fn``."""
    model = make_mlp_model(
        config["input_size"],
        config["hidden_size"],
        config["hidden2_size"],
        config["output_size"],
        activation=config.get("activation_fn", "relu"),
        sample_x_fn=sample_x_fn,
        output_pc=output_pc,
    )
    return GenerativeModel(model, generator, device=device)
