"""Posterior covariance factors for the DLGM baseline.

Each factor maps a batch of free-parameter vectors ``[B, free]`` to
matrices ``R [B, d, d]`` with the covariance ``C = R Rᵀ``:

* :class:`CholeskyFactor` — lower triangular, diagonal ``exp(·) + δ``;
* :class:`DiagonalFactor` — diagonal only;
* :class:`RankOneFactor` — ``v vᵀ`` off the diagonal, an independent
  positive diagonal (free parameters ``[log-diag, log-v]``); the DLGM's
  default.

The same classes, sizes and formulas as the JAX package's
``models/cholesky.py``; the matrices are built with differentiable tensor
ops, so gradients reach the free parameters.
"""

from __future__ import annotations

import torch


class CholeskyFactor:
    def __init__(self, size: int, delta: float = 1e-4):
        self.size = size
        self.delta = delta

    def free_parameter_size(self) -> int:
        return self.size * (self.size + 1) // 2

    def parameterize(self, free: torch.Tensor) -> torch.Tensor:
        """``[B, size*(size+1)/2]`` -> ``[B, size, size]`` lower triangular:
        the first ``size`` entries make the diagonal, the rest fill the
        strict lower triangle row by row (numpy's ``tril_indices`` order)."""
        b, d = free.shape[0], self.size
        diag = torch.exp(free[:, :d]) + self.delta
        rows, cols = torch.tril_indices(d, d, offset=-1, device=free.device)
        R = free.new_zeros((b, d, d))
        R[:, rows, cols] = free[:, d:]
        return R + torch.diag_embed(diag)


class DiagonalFactor:
    def __init__(self, size: int, delta: float = 1e-6):
        self.size = size
        self.delta = delta

    def free_parameter_size(self) -> int:
        return self.size

    def parameterize(self, free: torch.Tensor) -> torch.Tensor:
        return torch.diag_embed(torch.exp(free) + self.delta)


class RankOneFactor:
    """R = v vᵀ off the diagonal, an independent positive diagonal."""

    def __init__(self, size: int, delta: float = 1e-6):
        self.size = size
        self.delta = delta

    def free_parameter_size(self) -> int:
        return 2 * self.size

    def parameterize(self, free: torch.Tensor) -> torch.Tensor:
        d = torch.exp(free[:, : self.size]) + self.delta
        v = torch.exp(free[:, self.size :]) + self.delta
        eye = torch.eye(self.size, dtype=torch.bool, device=free.device)
        return torch.where(eye, torch.diag_embed(d), v[:, :, None] * v[:, None, :])


def factor_from_free_size(latent_dim: int, free_size: int):
    """The factor whose free-parameter width is ``free_size`` at
    ``latent_dim``: a torch checkpoint records only the covariance head's
    width.  The tiny-d collisions (d=1: Cholesky and Diagonal; d=3: Cholesky
    and RankOne) raise rather than pick one; d > 3 is unambiguous."""
    matches = [
        cls(latent_dim)
        for cls in (CholeskyFactor, DiagonalFactor, RankOneFactor)
        if cls(latent_dim).free_parameter_size() == free_size
    ]
    if len(matches) == 1:
        return matches[0]
    if matches:
        names = ", ".join(type(m).__name__ for m in matches)
        raise ValueError(
            f"free size {free_size} at latent dim {latent_dim} is ambiguous "
            f"({names}) — pass the factor explicitly"
        )
    raise ValueError(
        f"no factor with free size {free_size} at latent dim {latent_dim}"
    )
