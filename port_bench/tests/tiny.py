"""Tiny cells for the CPU tests: the real mixes at a few rows, widths and
steps, and TF32 products emulated (operands rounded to TF32, to nearest
with ties away from zero, then float32 products and sums)."""

from __future__ import annotations

import json
from pathlib import Path

import torch

from port_bench.lib.cell import BENCH_DIR, Cell

SMALL = {"input_size": 4, "hidden_size": 8, "hidden2_size": 8, "output_size": 16}
# the masked Adam phase parts rows under TF32 only from some width up: at
# SMALL its control stays within the limits, at MID it parts them as at full size
MID = {"input_size": 10, "hidden_size": 64, "hidden2_size": 64, "output_size": 196}
SHRINK = {
    "train": dict(batch=8, warm_steps=6, mixing=2, sampling=3, pool_batches=8),
    "sample": dict(batch=8, warm_steps=20, mixing=10, sampling=30, capture_stride=5,
                   pool_batches=4, check_chains=2),
    "eval": dict(batch=16, batches_per_call=3, warm_steps=250, pool_batches=5, check_calls=1),
}
END_TO_END = {"train": ["train_images_per_s", "train_batch_ms_p95"],
              "sample": ["sample_row_steps_per_s"], "eval": ["eval_images_per_s"]}
SEED = 2 ** 31 + 12345  # past 32 signed bits, as the driver's seeds are


def cell(kind: str, model: dict = None, root: Path = BENCH_DIR.parent) -> Cell:
    mix = json.loads((root / "port_bench" / "mixes" / f"{kind}.json").read_text())
    mix.update(SHRINK[kind])
    metrics = [{"name": n, "unit": "x"} for n in END_TO_END[kind] + ["setup_s"]]
    model = model or (MID if kind == "eval" else SMALL)
    return Cell(f"tiny.{kind}", dict(model), mix, metrics, [], 1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return tf32(a) @ tf32(b)
