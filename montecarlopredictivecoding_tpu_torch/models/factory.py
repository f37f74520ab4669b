"""Model and trainer factories for the canonical experiment configurations.

* ``get_model``: the 4-Linear generative MLP with uniform(-10, 10) latent
  init, from a config dict;
* ``get_pc_trainer``: ``T_pc`` steps of MAP descent on the latents,
  optionally one weight update at the last step;
* ``get_mcpc_trainer``: a plain-SGD Langevin chain of ``mixing + sampling``
  steps with the Monte-Carlo weight gradient accumulated over the
  ``sampling`` window and applied once;
* ``get_mcpc_trainer_one_sample``: K Langevin steps, weights updated from
  the single last sample.

Configs are plain dicts (sizes, ``activation_fn``, ``loss_fn``,
``input_var``, PC/MCPC optimizer settings), as in the JAX package.
"""

from __future__ import annotations

import typing as tp

import torch

from ..core.model import make_mlp_model
from ..core.modules import uniform_init
from ..core.trainer import GenerativeModel, PCTrainer


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


def get_pc_trainer(
    gen: GenerativeModel,
    config: dict,
    is_mcpc: bool = False,
    training: bool = True,
) -> PCTrainer:
    """PC trainer: MAP descent on the latents for ``T_pc`` steps; weights
    updated at the last step when training (and never when this trainer
    only warm-starts an MCPC chain, ``is_mcpc=True``)."""
    if is_mcpc or not training:
        update_p = "never"
        opt_p_fn, opt_p_kwargs = None, None
    else:
        update_p = "last"
        opt_p_fn = config["optimizer_p_fn"]
        opt_p_kwargs = config["optimizer_p_kwargs"]
    return PCTrainer(
        gen,
        T=config["T_pc"],
        update_x_at="all",
        optimizer_x_fn=config["optimizer_x_fn_pc"],
        optimizer_x_kwargs=config["optimizer_x_kwargs_pc"],
        update_p_at=update_p,
        optimizer_p_fn=opt_p_fn,
        optimizer_p_kwargs=opt_p_kwargs,
    )


def get_mcpc_trainer(
    gen: GenerativeModel,
    config: dict,
    training: bool = True,
) -> PCTrainer:
    """MCPC trainer: ``T = mixing + sampling`` plain-SGD Langevin steps;
    parameter grads accumulate over the ``sampling`` window (the Monte-Carlo
    expectation of the Hebbian gradient over the posterior) and apply once at
    the last step."""
    mixing, sampling = config["mixing"], config["sampling"]
    return PCTrainer(
        gen,
        T=mixing + sampling,
        update_x_at="all",
        optimizer_x_fn="sgd",
        optimizer_x_kwargs=config["optimizer_x_kwargs_mcpc"],
        update_p_at="last" if training else "never",
        accumulate_p_at=[mixing + i for i in range(sampling)],
        optimizer_p_fn=config["optimizer_p_fn_mcpc"] if training else None,
        optimizer_p_kwargs=config.get("optimizer_p_kwargs_mcpc"),
    )


def get_mcpc_trainer_one_sample(
    gen: GenerativeModel,
    config: dict,
    training: bool = True,
) -> PCTrainer:
    """One-sample MCPC variant: K Langevin steps, weight update from the
    single last sample (no accumulation window)."""
    return PCTrainer(
        gen,
        T=config["K"],
        update_x_at="all",
        optimizer_x_fn="sgd",
        optimizer_x_kwargs=config["optimizer_x_kwargs_mcpc"],
        update_p_at="last" if training else "never",
        optimizer_p_fn=config["optimizer_p_fn_mcpc"] if training else None,
        optimizer_p_kwargs=config.get("optimizer_p_kwargs_mcpc"),
    )
