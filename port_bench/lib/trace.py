"""The traced run's timeline, reduced to what the per-layer readers read.

The window runs under ``torch.profiler`` (the program's
``utils.observability.profile_trace``: host activity and the card's kernels
and copies), with the benchmark's own spans (``record_function``) around the
calls into each layer.  The Chrome trace it writes is read back here: the
device's busy time is the union of kernel, copy and set intervals, clipped
to the ``bench.window`` span; an idle gap is charged to the innermost host
event running at its middle.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import heapq
import json
import os
import types
import typing as tp

WINDOW = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
BREAKDOWN_ENTRIES = 10
NAME_CHARS = 120


@contextlib.contextmanager
def no_span(name: str):
    yield


def span(name: str):
    """A host span of the benchmark's own, seen by the profiler."""
    import torch

    return torch.profiler.record_function(name)


def merge(intervals: tp.Iterable[tp.Tuple[float, float]]) -> tp.List[tp.Tuple[float, float]]:
    """The union of [start, end) intervals, sorted and disjoint."""
    out: tp.List[tp.List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(merged: tp.Sequence[tp.Tuple[float, float]], s: float, e: float) -> float:
    """Length of [s, e) that the merged intervals cover."""
    total = 0.0
    i = max(bisect.bisect_right(merged, (s, float("inf"))) - 1, 0)
    while i < len(merged) and merged[i][0] < e:
        a, b = merged[i]
        total += max(0.0, min(b, e) - max(a, s))
        i += 1
    return total


def short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[: NAME_CHARS - 3] + "..."


@dataclasses.dataclass
class Kernel:
    name: str
    ts: float          # microseconds, the trace's clock
    dur: float
    launch_ts: tp.Optional[float]  # host time of its launch, where correlated


@dataclasses.dataclass
class Timeline:
    """One traced window: its bounds (µs), the device's kernels and busy
    intervals in it, the benchmark's spans and the host's events."""

    t0: float
    t1: float
    kernels: tp.List[Kernel]
    busy: tp.List[tp.Tuple[float, float]]
    spans: tp.List[tp.Tuple[str, float, float]]
    host: tp.List[tp.Tuple[str, float, float]]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return covered(self.busy, self.t0, self.t1) / 1e6

    def spans_named(self, name: str) -> tp.List[tp.Tuple[float, float]]:
        return [(ts, ts + dur) for n, ts, dur in self.spans if n == name]

    def kernels_like(self, text: str) -> tp.List[Kernel]:
        return [k for k in self.kernels if text in k.name]

    def idle_in(self, s: float, e: float) -> float:
        """µs of [s, e) in which the device ran nothing."""
        return (e - s) - covered(self.busy, s, e)

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps'
        time by the host activity under them (seconds, at most ten each)."""
        by_op: tp.Dict[str, float] = {}
        for k in self.kernels:
            by_op[short(k.name)] = by_op.get(short(k.name), 0.0) + k.dur / 1e6
        gaps: tp.Dict[str, float] = {}
        prev, idle = self.t0, []
        for s, e in self.busy + [(self.t1, self.t1)]:
            if s > prev:
                idle.append((prev, s))
            prev = max(prev, e)
        for (s, e), name in zip(idle, innermost(self.host, [0.5 * (s + e) for s, e in idle])):
            gaps[short(name)] = gaps.get(short(name), 0.0) + (e - s) / 1e6
        top = lambda d: [[n, v] for n, v in sorted(d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]
        return {"device_ops": top(by_op), "idle_gaps": top(gaps)}


def innermost(host, points: tp.Sequence[float]) -> tp.List[str]:
    """For each of the sorted ``points``, the name of the shortest host event
    (name, ts, dur) that spans it, or "(no host event)"."""
    host = sorted(host, key=lambda h: h[1])
    names, i, by_end, by_dur, alive = [], 0, [], [], set()
    for p in points:
        while i < len(host) and host[i][1] <= p:
            heapq.heappush(by_end, (host[i][1] + host[i][2], i))
            heapq.heappush(by_dur, (host[i][2], i))
            alive.add(i)
            i += 1
        while by_end and by_end[0][0] < p:
            alive.discard(heapq.heappop(by_end)[1])
        while by_dur and by_dur[0][1] not in alive:
            heapq.heappop(by_dur)
        names.append(host[by_dur[0][1]][0] if by_dur else "(no host event)")
    return names


def read_timeline(path: str) -> Timeline:
    """The ``bench.window`` span's timeline from a Chrome trace file."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    launches: tp.Dict[int, float] = {}
    device, spans, host = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((cat, e["name"], ts, dur, e.get("args", {}).get("correlation")))
        elif cat == "user_annotation":
            spans.append((e["name"], ts, dur))
            host.append((e["name"], ts, dur))
        elif cat in HOST_CATS:
            host.append((e["name"], ts, dur))
            if cat in ("cuda_runtime", "cuda_driver"):
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = ts
    windows = [(ts, ts + dur) for n, ts, dur in spans if n == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    t0, t1 = windows[-1]
    inside = [d for d in device if d[2] < t1 and d[2] + d[3] > t0]
    kernels = [Kernel(name, ts, dur, launches.get(corr))
               for cat, name, ts, dur, corr in inside if cat == "kernel"]
    busy = merge((max(ts, t0), min(ts + dur, t1)) for _, _, ts, dur, _ in inside)
    host = [h for h in host if h[1] < t1 and h[1] + h[2] > t0]
    return Timeline(t0, t1, kernels, busy, spans, host)


@contextlib.contextmanager
def traced(enabled: bool):
    """Yields a holder whose ``timeline`` is set after the block, when
    ``enabled``; the trace file is removed once read."""
    holder = types.SimpleNamespace(timeline=None)
    if not enabled:
        yield holder
        return
    from montecarlopredictivecoding_tpu_torch.utils.observability import profile_trace

    with profile_trace() as prof:
        yield holder
    try:
        holder.timeline = read_timeline(prof.trace_path)
    finally:
        os.remove(prof.trace_path)
