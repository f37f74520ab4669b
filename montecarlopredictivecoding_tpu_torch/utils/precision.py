"""The port's f32 numeric policy: TF32 off where a result is held to the
JAX package's f32.

On an H100 cuBLAS and cuDNN may run f32 products in TF32 (10 mantissa
bits); the functions that compare with the JAX package at ``Precision.HIGHEST``
run inside these context managers, which turn it off and restore the flags
on the way out.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    """TF32 off for the products inside (the recomputed scalars are held to
    the kernel's f32 ones; the metrics' products sum hundreds of terms)."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@contextlib.contextmanager
def full_f32_conv():
    """TF32 off for the cuDNN convolutions and the matrix products inside,
    restored on the way out.  ``torch.backends.cudnn.allow_tf32`` is True by
    default, so a convolution on the card would otherwise run in TF32 (10
    mantissa bits, about 1e-3 relative after ResNet-9's eight layers) where
    the JAX package computes f32.  The ResNet-9 and Inception functions run
    inside it; nothing else of the port changes."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with full_f32_matmul():
            yield
    finally:
        torch.backends.cudnn.allow_tf32 = before
