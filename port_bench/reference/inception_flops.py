"""Operations and bytes of the InceptionV3 pool3 forward
(``reference/inception.py``) on one NVIDIA H100 SXM.

The convolutions' FLOPs, 2 a multiply-add, counted from the reference's own
layer table: each BasicConv2d's kernel and the output size it gives when
the network runs shapes only (on PyTorch's ``meta`` device) at 299 x 299.
The BatchNorm, relu, pools, resize and mean are left out of the FLOPs: they
are the bytes side.  A forward of B images must read its images and the
parameters once and write its features once; its least time is the larger
of its FLOPs at the f32-accurate peak and those bytes at HBM's rate, the
peaks of ``reference/flops.py``.
"""

from __future__ import annotations

import functools
import typing as tp

import torch

from port_bench.reference import flops
from port_bench.reference import inception as ref

Row = tp.Tuple[str, int, int, int, int, int, int]


@functools.lru_cache(maxsize=None)
def conv_table() -> tp.Tuple[Row, ...]:
    """(module, in, out, kh, kw, output height, output width) of the 94
    convolutions of a forward (the network resizes its input to 299 x 299),
    in the order they run."""
    with torch.device("meta"):
        model = ref.PoolThree().eval()
    rows: tp.List[Row] = []

    def hook(name):
        def record(m, inputs, out):
            o, i, kh, kw = m.conv.weight.shape
            rows.append((name, i, o, kh, kw, out.shape[2], out.shape[3]))
        return record

    for name, m in ref.convs(model):
        m.register_forward_hook(hook(name))
    with torch.no_grad():
        model(torch.empty((1, 3, 28, 28), device="meta"))
    return tuple(rows)


def image_flops() -> int:
    """Convolution FLOPs of one image's features."""
    return sum(2 * o * h * w * i * kh * kw for _, i, o, kh, kw, h, w in conv_table())


def n_params() -> int:
    """Convolution weights and the four BatchNorm vectors of every layer."""
    return sum(o * i * kh * kw + 4 * o for _, i, o, kh, kw, _, _ in conv_table())


def forward_bytes(B: int) -> int:
    """Bytes a forward of B images must move: the 28 x 28 images and the
    parameters read once, the 2048 features written once, float32."""
    return 4 * (B * 28 * 28 + n_params() + B * ref.FEATURES)


def forward_bound_s(B: int, peak: float = flops.PEAK_F32_ACCURATE) -> tp.Tuple[float, str]:
    """(least seconds a forward of B images could take, "flops" or "bytes")."""
    by_flops = B * image_flops() / peak
    by_bytes = forward_bytes(B) / flops.PEAK_BYTES
    return (by_flops, "flops") if by_flops >= by_bytes else (by_bytes, "bytes")


def call_batches(n: int, batch: int) -> tp.List[int]:
    """The batch sizes of an extractor call over ``n`` images."""
    return [min(batch, n - s) for s in range(0, n, batch)]
