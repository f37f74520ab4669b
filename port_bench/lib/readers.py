"""What the per-layer readers share.  Each reader takes the traced run's
context (``timeline``, ``window``, ``cell``, ``kind``) and returns a number,
or None where its cell gives it nothing to read."""

from __future__ import annotations

import bisect
import typing as tp

from port_bench.reference import flops

CHAIN_KERNEL = "mcpc_chain_kernel"
SUM_KERNEL = "sum_partials_kernel"


def mfu(ctx, kind: str) -> tp.Optional[float]:
    """The window's model FLOPs over its time at the f32-accurate peak, %."""
    if ctx.kind != kind or ctx.window.flops <= 0:
        return None
    return 100.0 * ctx.window.flops / ctx.timeline.window_s / flops.PEAK_F32_ACCURATE


def chain_roofline(ctx, kind: str) -> tp.Optional[float]:
    """The least time of the window's chain calls (the larger of their
    FLOPs at the f32-accurate peak and their bytes at HBM's rate) over the
    chain kernel's device time, %."""
    if ctx.kind != kind:
        return None
    device_us = sum(k.dur for k in ctx.timeline.kernels_like(CHAIN_KERNEL))
    if device_us <= 0:
        return None
    bound_s = sum(c["count"] * flops.chain_bound_s(c["dims"], c["B"], c["steps"], c["sampling"])[0]
                  for c in ctx.window.chain_calls)
    return 100.0 * bound_s / (device_us / 1e6)


def idle_share(ctx, kind: str) -> tp.Optional[float]:
    """The share of the window in which the device ran no kernel, copy or
    set, %."""
    if ctx.kind != kind:
        return None
    tl = ctx.timeline
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)


def span_gap_ms(ctx, kind: str, span: str) -> tp.Optional[float]:
    """The mean time, ms, inside the benchmark's spans ``span`` during which
    the device ran nothing."""
    if ctx.kind != kind:
        return None
    spans = ctx.timeline.spans_named(span)
    if not spans:
        return None
    return sum(ctx.timeline.idle_in(s, e) for s, e in spans) / len(spans) / 1e3


def kernels_in_spans_ms(ctx, kind: str, span: str, exclude: tp.Sequence[str]) -> tp.Optional[float]:
    """Device ms, per ``span``, of the kernels launched inside the spans
    ``span`` whose names hold none of ``exclude``."""
    if ctx.kind != kind:
        return None
    tl = ctx.timeline
    spans = sorted(tl.spans_named(span))
    if not spans:
        return None
    starts = [s for s, _ in spans]
    total = 0.0
    for k in tl.kernels:
        if k.launch_ts is None or any(x in k.name for x in exclude):
            continue
        i = bisect.bisect_right(starts, k.launch_ts) - 1
        if i >= 0 and k.launch_ts <= spans[i][1]:
            total += k.dur
    return total / len(spans) / 1e3


def mean_kernel_us(ctx, kind: str, name: str) -> tp.Optional[float]:
    """Mean device µs of the kernels whose names hold ``name``."""
    if ctx.kind != kind:
        return None
    ks = ctx.timeline.kernels_like(name)
    return sum(k.dur for k in ks) / len(ks) if ks else None
