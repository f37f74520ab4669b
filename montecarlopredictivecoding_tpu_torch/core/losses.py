"""Sensory-layer losses (the bottom-layer clamp of the generative stack).

All reductions are sums over the whole batch: a trainer divides parameter
gradients by the batch size (and the accumulation-window length) to recover
mean-per-datapoint updates.

Each loss has signature ``loss(output, _target=..., _var=...) -> scalar`` so
``loss_fn_kwargs`` dicts from the reference configs carry over verbatim.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _bce_with_logits(logits: Tensor, targets: Tensor) -> Tensor:
    """Numerically stable elementwise BCE-with-logits:

    ``max(z,0) - z*y + log(1 + exp(-|z|))``
    """
    return (
        torch.clamp(logits, min=0.0)
        - logits * targets
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def fe_fn(output: Tensor, _target: Tensor, _var: float) -> Tensor:
    """Gaussian sensory energy: ``(1/var)*0.5*sum((output-target)^2)``."""
    return (1.0 / _var) * 0.5 * torch.sum((output - _target) ** 2)


def bernoulli_fn(output: Tensor, _target: Tensor, _var=None, _reduction: str = "sum") -> Tensor:
    """Bernoulli sensory energy: summed BCE-with-logits."""
    e = _bce_with_logits(output, _target)
    if _reduction == "sum":
        return torch.sum(e)
    if _reduction == "none":
        return e
    if _reduction == "mean":
        return torch.mean(e)
    raise ValueError(f"unknown reduction {_reduction!r}")


def fe_fn_mask(output: Tensor, _target: Tensor, _var: float, perc: float = 0.5) -> Tensor:
    """Gaussian loss clamping only the last ``round(D*perc)`` features (the
    image-completion posteriors).  ``k == 0`` slices ``[-0:]``, i.e. all."""
    k = round(output.shape[1] * perc)
    return (1.0 / _var) * 0.5 * torch.sum((output[:, -k:] - _target[:, -k:]) ** 2)


def bernoulli_fn_mask(output: Tensor, _target: Tensor, _var=None, perc: float = 0.5) -> Tensor:
    """Bernoulli loss on the last ``round(D*perc)`` features."""
    k = round(output.shape[1] * perc)
    return torch.sum(_bce_with_logits(output[:, -k:], _target[:, -k:]))


def zero_fn(output: Tensor, *args, **kwargs) -> Tensor:
    """Unclamped sensory layer, used for generative/spontaneous sampling."""
    return torch.zeros((), dtype=output.dtype, device=output.device)
