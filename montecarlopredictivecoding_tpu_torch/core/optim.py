"""The Adam parameter step, in optax's order of operations.

``train_mcpc`` of the JAX package updates the parameters with
``optax.adam``; this is that update in plain tensor code:

    mu    = b1·mu + (1-b1)·g
    nu    = b2·nu + (1-b2)·g²
    count = count + 1
    p     = p + (-lr) · (mu / (1-b1^count)) / (sqrt(nu / (1-b2^count)) + eps)

with ``eps`` outside the root.  ``torch.optim.Adam`` folds the two bias
corrections into the step size and the root, which rounds differently, so it
is not used.  The step is pure: it returns new parameters and a new state and
changes neither argument.
"""

from __future__ import annotations

import dataclasses
import typing as tp

import numpy as np
import torch

Params = tp.Tuple[tp.Dict[str, torch.Tensor], ...]


@dataclasses.dataclass(frozen=True)
class AdamState:
    """``count`` steps taken, and the moments, shaped like the params."""

    count: int
    mu: Params
    nu: Params


def _zeros_like(params: Params) -> Params:
    return tuple({k: torch.zeros_like(v) for k, v in p.items()} for p in params)


def adam_init(params: Params) -> AdamState:
    return AdamState(count=0, mu=_zeros_like(params), nu=_zeros_like(params))


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(np.float32(1.0) - np.power(np.float32(decay), np.float32(count)))


@torch.no_grad()
def adam_step(params: Params, grads: Params, state: AdamState, lr: float,
              b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> tp.Tuple[Params, AdamState]:
    """One ``optax.adam(lr, b1, b2, eps)`` update; returns ``(params',
    state')``."""
    count = state.count + 1
    c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
    new_params, new_mu, new_nu = [], [], []
    for p, g, m, v in zip(params, grads, state.mu, state.nu):
        if set(g) != set(p):
            raise ValueError("grads must have the params' structure")
        mu = {k: (1.0 - b1) * g[k] + b1 * m[k] for k in p}
        nu = {k: (1.0 - b2) * (g[k] * g[k]) + b2 * v[k] for k in p}
        new_params.append({
            k: p[k] + (-lr) * ((mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps))
            for k in p
        })
        new_mu.append(mu)
        new_nu.append(nu)
    return tuple(new_params), AdamState(count, tuple(new_mu), tuple(new_nu))
