"""Shared experiment plumbing: seeds, paths, scaling, checkpoint loading.

One seed plays the role of the per-script seeds of the original experiments:
``ExperimentContext.generator(fold)`` gives a ``torch.Generator`` per use.
``scale`` lets every experiment run at a fraction of the published step
counts for smoke testing (``--full`` restores them).  ``device`` is where
the experiment runs: ``"cuda"`` (the kernels) unless asked for ``"cpu"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import warnings
import zlib

import torch


@dataclasses.dataclass
class ExperimentContext:
    path_models: str
    path_figures: str
    scale: float = 1.0  # multiplier on inference-step counts
    seed: int = 30
    device: str = "cuda"

    def generator(self, fold: int = 0) -> torch.Generator:
        """A generator for one use, keyed by the seed and ``fold``."""
        return torch.Generator().manual_seed(self.seed * 1_000_003 + fold)

    def steps(self, n: int, minimum: int = 2) -> int:
        """Scale a published step count."""
        return max(int(round(n * self.scale)), minimum)

    def fig_path(self, name: str) -> str:
        os.makedirs(self.path_figures, exist_ok=True)
        return os.path.join(self.path_figures, name)


def standard_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--models", default="models", help="checkpoint directory")
    p.add_argument("--figures", default="figures", help="figure output directory")
    p.add_argument(
        "--scale",
        type=float,
        default=0.05,
        help="fraction of the published inference-step counts (1.0 = full)",
    )
    p.add_argument("--full", action="store_true", help="published-scale run")
    p.add_argument("--seed", type=int, default=30)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernels) or 'cpu' (their plain versions)")
    return p


def context_from_args(args) -> ExperimentContext:
    return ExperimentContext(
        path_models=args.models,
        path_figures=args.figures,
        scale=1.0 if args.full else args.scale,
        seed=args.seed,
        device=args.device,
    )


def load_generative_checkpoint(ctx: ExperimentContext, name: str, config: dict):
    """Load a generative-MLP checkpoint by name, on ``ctx.device``.

    The native checkpoint ``<ctx.path_models>/<name>.msgpack``, else a
    freshly initialized model, with a warning, so experiments stay runnable
    without assets.
    """
    from ..models.factory import get_model
    from ..utils.checkpoint import load_checkpoint

    gen = get_model(config, ctx.generator(zlib.crc32(name.encode()) % 1000),
                    device=ctx.device)
    native = os.path.join(ctx.path_models, name + ".msgpack")
    if os.path.isfile(native):
        gen.params = load_checkpoint(native, gen.params, device=ctx.device)
        return gen
    warnings.warn(
        f"checkpoint {name!r} not found in {ctx.path_models}; using random "
        "initialization. Train one with experiments/train_mnist.py.",
        RuntimeWarning,
    )
    return gen
