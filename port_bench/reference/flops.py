"""Operations, bytes and peaks of the MCPC chain on one NVIDIA H100 SXM.

A chain step's matrix products, forward and backward, at B rows over the
widths (d0, d1, d2, D): the first layer's product has a zero input and is
not counted.  A sampling step adds the Hebbian products, half a step's
worth.  Counted whatever route computes them.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): f32
outside the tensor cores 67 TFLOP/s; TF32 on the tensor cores 495 TFLOP/s,
and an f32-accurate product as three TF32 products (split TF32) at a third
of it, 165 TFLOP/s, the fastest rate at which an f32-accurate product can
run on the card; HBM 3.35 TB/s.
"""

from __future__ import annotations

import typing as tp

PEAK_F32_FMA = 67e12
PEAK_TF32 = 495e12
SPLIT_TF32_PRODUCTS = 3
PEAK_F32_ACCURATE = PEAK_TF32 / SPLIT_TF32_PRODUCTS
PEAK_BYTES = 3.35e12


def step_flops(dims, B: int) -> int:
    """Matrix-product FLOPs of one chain step: forward and backward."""
    d0, d1, d2, D = dims
    return 2 * 2 * B * (d0 * d1 + d1 * d2 + d2 * D)


def chain_flops(dims, B: int, steps: int, sampling: int = 0) -> int:
    """A chain call's FLOPs: ``steps`` steps, ``sampling`` of them with the
    Hebbian products."""
    return step_flops(dims, B) * steps + step_flops(dims, B) // 2 * sampling


def chain_bytes(dims, B: int, sampling: int = 0) -> int:
    """Bytes a chain call must read and write once: the parameters, the
    latents in and out, the target, and the gradients where it sums them."""
    d0, d1, d2, D = dims
    n = d0 + d1 + d2
    params = d0 + d0 * d1 + d1 + d1 * d2 + d2 + d2 * D + D
    return 4 * (params + 2 * B * n + B * D + (params if sampling else 0))


def chain_bound_s(dims, B: int, steps: int, sampling: int = 0,
                  peak: float = PEAK_F32_ACCURATE) -> tp.Tuple[float, str]:
    """(least seconds the card could take for the call, "flops" or "bytes":
    the bound that applies)."""
    by_flops = chain_flops(dims, B, steps, sampling) / peak
    by_bytes = chain_bytes(dims, B, sampling) / PEAK_BYTES
    return (by_flops, "flops") if by_flops >= by_bytes else (by_bytes, "bytes")

