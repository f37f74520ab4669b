"""Moving parameters and latents between numpy arrays and this package.

The JAX package's parameters are a tuple of ``{"w": [in, out], "b": [out]}``
dicts (as ``jax.device_get`` returns them) and its latents a tuple of
``[B, d]`` arrays.  This package keeps the same layout in torch tensors, so
conversion is a copy with no transposes.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch


def params_from_numpy(params_np: tp.Sequence[dict], device="cuda",
                      dtype: torch.dtype = torch.float32) -> tp.Tuple[dict, ...]:
    """Tuple of ``{"w", "b"}`` numpy dicts -> the same tuple of tensors."""
    return tuple(
        {k: torch.tensor(np.asarray(v), dtype=dtype, device=device)
         for k, v in p.items()}
        for p in params_np
    )


def params_to_numpy(params: tp.Sequence[dict]) -> tp.Tuple[dict, ...]:
    """Tuple of tensor dicts -> the same tuple of numpy dicts."""
    return tuple(
        {k: v.detach().cpu().numpy() for k, v in p.items()} for p in params
    )


def latents_from_numpy(latents_np: tp.Sequence, device="cuda",
                       dtype: torch.dtype = torch.float32) -> tp.Tuple[torch.Tensor, ...]:
    """Tuple of ``[B, d]`` numpy arrays -> the same tuple of tensors."""
    return tuple(
        torch.tensor(np.asarray(x), dtype=dtype, device=device)
        for x in latents_np
    )
