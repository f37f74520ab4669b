"""Readers of the FID cell's traced window: the program's ``mcpc.fid.*``
spans (``eval/fid.get_fid``) and the kernels launched inside them.

A kernel belongs to a convolution when its launch lies inside a host
operator of ``CONV_OPS`` (``F.conv2d`` and the ATen calls under it), which
counts cuDNN's own layout kernels with the convolution that needed them.
On a program without the spans (an older commit) every reader returns
None.
"""

from __future__ import annotations

import typing as tp

from port_bench.lib import program_spans, readers
from port_bench.lib.program_spans import inside, named
from port_bench.lib.trace import merge
from port_bench.reference import inception_flops

KIND = "fid"
FEATURES = "mcpc.fid.features"
STATS = ("mcpc.fid.stats", "mcpc.fid.distance")
CONV_OPS = ("aten::conv2d", "aten::convolution", "aten::_convolution", "aten::cudnn_convolution")


def spanned(ctx) -> bool:
    """Whether this is the FID cell's window and the program marks its
    extractor calls."""
    return ctx.kind == KIND and bool(named(ctx.timeline, FEATURES))


def features_kernels(tl) -> tp.List[tp.Tuple[tp.Any, bool]]:
    """(kernel, launched by a convolution) of every kernel launched inside
    the ``mcpc.fid.features`` spans."""
    spans = merge(named(tl, FEATURES))
    convs = merge((ts, ts + dur) for name, ts, dur in tl.host if name in CONV_OPS)
    return [(k, inside(convs, k.launch_ts)) for k in tl.kernels
            if k.launch_ts is not None and inside(spans, k.launch_ts)]


def features_roofline(ctx) -> tp.Optional[float]:
    """The window's extractor forwards' least time (FLOPs at the
    f32-accurate peak or bytes at HBM's rate, the larger, a batch) over the
    device time of the kernels launched in ``mcpc.fid.features``, %."""
    if not spanned(ctx):
        return None
    device_us = sum(k.dur for k, _ in features_kernels(ctx.timeline))
    if device_us <= 0:
        return None
    bound_s = sum(inception_flops.forward_bound_s(b)[0] for b in ctx.window.feature_batches)
    return 100.0 * bound_s / (device_us / 1e6)


def features_other_ms(ctx) -> tp.Optional[float]:
    """Device ms a call of the kernels in ``mcpc.fid.features`` that no
    convolution launched: BatchNorm, relu, pools, concatenations, the
    resize, copies."""
    if not spanned(ctx):
        return None
    tl = ctx.timeline
    other = sum(k.dur for k, conv in features_kernels(tl) if not conv)
    return other / len(named(tl, FEATURES)) / 1e3


def stats_ms(ctx) -> tp.Optional[float]:
    """Host ms a call in ``mcpc.fid.stats`` and ``mcpc.fid.distance``."""
    if not spanned(ctx):
        return None
    tl = ctx.timeline
    total = sum(e - s for name in STATS for s, e in named(tl, name))
    return total / len(named(tl, FEATURES)) / 1e3


def mfu(ctx) -> tp.Optional[float]:
    return readers.mfu(ctx, KIND) if spanned(ctx) else None


def idle_share(ctx) -> tp.Optional[float]:
    return readers.idle_share(ctx, KIND) if spanned(ctx) else None


def unspanned_idle_share(ctx) -> tp.Optional[float]:
    """The share of the window's device-idle time outside every ``mcpc.*``
    span, %: ``make_mnist_fid_stats``' reads of the cached statistics and
    whatever else ``get_fid`` does between its stages."""
    return program_spans.unspanned_idle_share(ctx, KIND) if spanned(ctx) else None


def host_waits(ctx) -> tp.Optional[float]:
    """Blocking runtime calls starting in any ``mcpc.*`` span, a call."""
    return program_spans.host_waits(ctx, KIND, FEATURES)
