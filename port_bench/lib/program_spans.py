"""Readers of the program's own spans (``mcpc.*``, placed by the port's
``utils.observability.span`` at its layer boundaries) in the traced
window's timeline.

"Idle" is what ``Timeline.idle_in`` counts: time in which the device ran no
kernel, copy or set.  A span's "self" intervals are its own less the union
of the named child spans inside it.  A program without these spans (an
older commit) gives every reader here nothing to read: they return None.
"""

from __future__ import annotations

import bisect
import typing as tp

from port_bench.lib.trace import merge

PREFIX = "mcpc."
# the CUDA runtime calls that block the host until the card has done the
# work before them (a synchronous cudaMemcpy included)
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy")

Intervals = tp.List[tp.Tuple[float, float]]


def in_window(tl, spans: tp.Iterable[tp.Tuple[float, float]]) -> Intervals:
    """The spans that overlap the window, clipped to it, sorted."""
    return sorted((max(s, tl.t0), min(e, tl.t1)) for s, e in spans if s < tl.t1 and e > tl.t0)


def named(tl, name: str) -> Intervals:
    return in_window(tl, tl.spans_named(name))


def program(tl) -> Intervals:
    """Every ``mcpc.*`` span in the window."""
    return in_window(tl, ((ts, ts + dur) for n, ts, dur in tl.spans if n.startswith(PREFIX)))


def minus(spans: Intervals, cut: Intervals) -> Intervals:
    """The parts of the sorted ``spans`` that no interval of ``cut``
    covers."""
    cut = merge(cut)
    out: Intervals = []
    j = 0
    for s, e in spans:
        while j < len(cut) and cut[j][1] <= s:
            j += 1
        k = j
        while k < len(cut) and cut[k][0] < e and s < e:
            a, b = cut[k]
            if a > s:
                out.append((s, a))
            s = max(s, b)
            k += 1
        if s < e:
            out.append((s, e))
    return out


def inside(merged: Intervals, t: float) -> bool:
    """Whether ``t`` lies in one of the sorted, disjoint intervals."""
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t < merged[i][1]


def self_idle_us(ctx, kind: str, span: str, children: tp.Sequence[str] = ()) -> tp.Optional[float]:
    """Mean device-idle µs, a ``span``, in its self intervals (less the
    spans ``children``)."""
    if ctx.kind != kind:
        return None
    tl = ctx.timeline
    parents = named(tl, span)
    if not parents:
        return None
    cut = [iv for child in children for iv in named(tl, child)]
    return sum(tl.idle_in(s, e) for s, e in minus(parents, cut)) / len(parents)


def self_idle_ms(ctx, kind: str, span: str, children: tp.Sequence[str] = ()) -> tp.Optional[float]:
    us = self_idle_us(ctx, kind, span, children)
    return None if us is None else us / 1e3


def host_waits(ctx, kind: str, per: str) -> tp.Optional[float]:
    """The runtime calls of ``WAITS`` that start inside any ``mcpc.*`` span,
    over the number of spans ``per``."""
    if ctx.kind != kind:
        return None
    tl = ctx.timeline
    n = len(named(tl, per))
    if n == 0:
        return None
    spans = merge(program(tl))
    return float(sum(1 for name, ts, _ in tl.host if name in WAITS and inside(spans, ts))) / n


def unspanned_idle_share(ctx, kind: str) -> tp.Optional[float]:
    """The share of the window's device-idle time that lies outside every
    ``mcpc.*`` span, %."""
    if ctx.kind != kind:
        return None
    tl = ctx.timeline
    spans = program(tl)
    idle = minus([(tl.t0, tl.t1)], tl.busy)
    total = sum(e - s for s, e in idle)
    if not spans or total <= 0:
        return None
    return 100.0 * sum(e - s for s, e in minus(idle, spans)) / total


def launches_inside(tl, kernel: str, span: str) -> tp.Optional[float]:
    """The share of the kernels whose names hold ``kernel`` whose launch
    (the correlated runtime call's start) lies inside a span ``span``, %:
    the check that the program's spans and the card's kernels share a
    clock."""
    ks = tl.kernels_like(kernel)
    if not ks:
        return None
    spans = merge(tl.spans_named(span))
    return 100.0 * sum(1 for k in ks if k.launch_ts is not None and inside(spans, k.launch_ts)) / len(ks)
