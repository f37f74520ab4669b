"""Synthetic stimulus datasets for the neural-variability experiments
(figure 5): whole numpy arrays ``[num_samples, size*size]`` in [0, 1], made
from a seed, so the same seed gives the same array in any package."""

from __future__ import annotations

import numpy as np


def grating_dataset(
    num_samples: int,
    size: int = 28,
    num_orientations: int = 8,
    wavelength: float = 10.0,
    seed: int = 0,
) -> np.ndarray:
    """Sinusoidal gratings at orientations drawn from ``num_orientations``
    equal steps of the circle, flattened, f32."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, num_orientations, size=num_samples)
    angles = (2 * np.pi / num_orientations) * idx
    x, y = np.meshgrid(np.arange(size), np.arange(size))
    c = size // 2
    out = np.empty((num_samples, size * size), dtype=np.float32)
    for i, a in enumerate(angles):
        x_rot = (x - c) * np.cos(a) + (y - c) * np.sin(a)
        g = np.sin(2 * np.pi * x_rot / wavelength) / 2 + 0.5
        out[i] = g.astype(np.float32).ravel()
    return out


def noise_dataset(num_samples: int, size: int = 28, seed: int = 0) -> np.ndarray:
    """One fixed binary-noise image repeated ``num_samples`` times."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(size, size) > 0.5).astype(np.float32).ravel()
    return np.tile(img[None, :], (num_samples, 1))


def chunk_dataset(tensor: np.ndarray, chunk_size: int) -> list:
    """The leading axis cut into chunks of ``chunk_size`` (the last may be
    shorter)."""
    n = tensor.shape[0]
    return [tensor[s : min(s + chunk_size, n)] for s in range(0, n, chunk_size)]
