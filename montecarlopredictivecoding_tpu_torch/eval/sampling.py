"""Ancestral sampling from a trained generative stack.

Walk the stack from a zeros input; at each PC site draw ``x ~ N(mu, I)``;
at the sensory layer either return the pre-noise activations
(``is_return_hidden=True``: logits for Bernoulli models) or sample
``N(mu, input_var*I)`` / ``Bernoulli(sigmoid(mu))``.  Every draw comes from
one ``torch.Generator``, the model's unless another is given.
"""

from __future__ import annotations

import typing as tp

import torch

from ..core.losses import bernoulli_fn, fe_fn
from ..core.modules import random_tensor
from ..core.trainer import GenerativeModel


def sample_pc(
    num_samples: int,
    gen: GenerativeModel,
    config: dict,
    generator: tp.Optional[torch.Generator] = None,
    is_return_hidden: bool = False,
) -> torch.Tensor:
    """``num_samples`` ancestral samples ``[num_samples, D]`` on the
    parameters' device: the logits with ``is_return_hidden``, else draws of
    the sensory model the config's ``loss_fn`` names."""
    generator = gen.generator if generator is None else generator
    hidden = gen.model.ancestral_sample(
        gen.params, generator, num_samples, input_dim=config.get("input_size")
    )
    if is_return_hidden:
        return hidden

    loss_fn = config.get("loss_fn")
    if loss_fn is fe_fn or loss_fn == "fe_fn":
        std = float(config["input_var"]) ** 0.5
        return hidden + std * random_tensor("normal", hidden.shape, generator,
                                            hidden.dtype, hidden.device)
    if loss_fn is bernoulli_fn or loss_fn == "bernoulli_fn":
        probs = torch.sigmoid(hidden)
        draws = random_tensor("uniform", probs.shape, generator, probs.dtype, probs.device)
        return (draws <= probs).to(torch.float32)
    return hidden
