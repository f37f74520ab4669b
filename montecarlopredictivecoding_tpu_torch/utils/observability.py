"""Observability: progress logging, the plot-progress diagnostic, a profiler
context, the program's spans and the warning that an option sends work down
a slower path.

Reference counterparts: tqdm postfix logging, the plot-progress subsystem
rendering energy/loss/overall against t per batch with its "loss absorbed
into hidden-layer energy" health check, and the "this will slow down
training" warnings.  :func:`profile_trace` records a ``torch.profiler``
trace (host and, on a card, device activity) where the JAX package records
a ``jax.profiler`` one; :func:`span` marks the port's layer boundaries in
that trace.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
import typing as tp
import warnings

import numpy as np
import torch


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named host span at one of the port's layer boundaries
    (``mcpc.*``): ``torch.profiler.record_function(name)`` while a profiler
    records, so the span lands in its trace on the clock of the card's
    kernels and copies; otherwise one shared no-op context, which costs a
    check of the profiler's state and makes nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def slow_down_warning(caller: str, option: str, suggestion: str) -> None:
    """Warn that an expensive option is enabled."""
    warnings.warn(
        f"{caller}: option <{option}> slows down training; set it to "
        f"{suggestion} unless you need it.",
        RuntimeWarning,
        stacklevel=3,
    )


def _host(values) -> np.ndarray:
    """A results entry (a tensor on any device, or an array) on the host."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu()
    return np.asarray(values)


class ProgressLogger:
    """Lightweight per-batch progress reporting (the tqdm-postfix role):
    call with each ``train_on_batch`` results dict; prints loss/energy/overall
    and steps/sec.  A row's ``seconds`` runs from the previous row's end to
    the end of this row's reads of ``results``, which wait for the batch's
    device work."""

    def __init__(self, every: int = 1, prefix: str = ""):
        self.every = every
        self.prefix = prefix
        self.h = 0
        self.history: list = []
        self._t_last = time.perf_counter()

    def __call__(self, results: dict, T: tp.Optional[int] = None) -> None:
        row = {
            "h": self.h,
            "loss": float(_host(results["loss"])[-1]),
            "energy": float(_host(results["energy"])[-1]),
            "overall": float(_host(results["overall"])[-1]),
        }
        # after the reads, which wait for this batch's device work
        now = time.perf_counter()
        dt = now - self._t_last
        self._t_last = now
        row["seconds"] = dt
        if T:
            row["steps_per_sec"] = T / dt
        self.history.append(row)
        if self.h % self.every == 0:
            msg = (
                f"{self.prefix}h={row['h']} | l: {row['loss']:.3e} | "
                f"e: {row['energy']:.3e} | o: {row['overall']:.3e} | "
                f"{dt:.2f}s"
            )
            if T:
                msg += f" | {row['steps_per_sec']:,.0f} steps/s"
            print(msg)
        self.h += 1


def plot_progress(
    per_batch_results: tp.Sequence[dict],
    path: tp.Optional[str] = None,
    title: str = "inference progress",
):
    """The plot-progress diagnostic: loss / energy / overall against the
    inference step t, one line per batch h.

    A healthy run shows, per h, loss decreasing and energy increasing along t
    (loss being absorbed into hidden-layer energy), overall decreasing, and
    the loss curves dropping as h grows (weight updates taking in the
    energy).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axs = plt.subplots(1, 3, figsize=(12, 3.5), sharex=True)
    keys = ["loss", "energy", "overall"]
    n = len(per_batch_results)
    cmap = plt.get_cmap("viridis")
    for h, results in enumerate(per_batch_results):
        color = cmap(h / max(n - 1, 1))
        for ax, key in zip(axs, keys):
            ax.plot(_host(results[key]), color=color, alpha=0.8)
    for ax, key in zip(axs, keys):
        ax.set_xlabel("t")
        ax.set_title(key)
    fig.suptitle(title)
    fig.tight_layout()
    if path is None:
        working_home = os.environ.get("WORKING_HOME", ".")
        os.makedirs(os.path.join(working_home, "plot_progress"), exist_ok=True)
        path = os.path.join(working_home, "plot_progress", "combined.png")
    fig.savefig(path)
    plt.close(fig)
    return path


@contextlib.contextmanager
def profile_trace(log_dir: tp.Optional[str] = None):
    """Record a ``torch.profiler`` trace of the block: host activity and,
    where a card is present, its kernels and copies.  Yields the profiler
    (``key_averages()`` sums the time by operation); on exit the trace goes
    to ``<log_dir>/trace-<pid>-<ms>.json`` (Chrome's trace format; default
    ``log_dir``: ``mcpc_profile`` under the temporary directory), and the
    profiler's ``trace_path`` names it."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "mcpc_profile")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(
        log_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json")
    prof.export_chrome_trace(prof.trace_path)


def energy_absorption_report(per_batch_results: tp.Sequence[dict]) -> dict:
    """Quantify the "loss absorbed into hidden energy" health check: per
    batch, the fraction of the initial loss that moved into layer energy by
    the last step, plus monotonicity of overall."""
    rows = []
    for results in per_batch_results:
        loss = _host(results["loss"]).astype(np.float64)
        energy = _host(results["energy"]).astype(np.float64)
        overall = _host(results["overall"]).astype(np.float64)
        denom = max(loss[0] - loss[-1], 1e-12)
        rows.append(
            {
                "loss_drop": float(loss[0] - loss[-1]),
                "energy_rise": float(energy[-1] - energy[0]),
                "absorption": float((energy[-1] - energy[0]) / denom),
                "overall_monotone_frac": float(np.mean(np.diff(overall) <= 0)),
            }
        )
    return {
        "per_batch": rows,
        "mean_absorption": float(np.mean([r["absorption"] for r in rows])),
        "mean_overall_monotone_frac": float(
            np.mean([r["overall_monotone_frac"] for r in rows])
        ),
    }
