"""Figure 5b's replay of ``chip_smoke.py`` phase 8 at other seed models.

    python3 scripts/figure5b_replay.py [--seeds 0 1]

Runs ``figure_5.similarity_increase_digit`` at full width for the given
seed models at the smoke's epochs (``FIG5_EPOCHS``), with the smoke's
``ChainRecorder`` standing in for ``mcpc_chain``, then holds the figure's
first Langevin chain (seed 0's spontaneous chain) by the phase's own
function, ``hold_replay``: the same bits on a repeated launch, and the row
rule against the plain version in f32 and float64, cut to 500 steps.  The
smoke runs seeds 0-2 (the figure script's default); with seeds 0-1 the
replayed chain is another one.  Exits 1 if the hold fails.  Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, HERE)
    smoke = importlib.import_module("chip_smoke")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1])
    args = ap.parse_args()
    from montecarlopredictivecoding_tpu_torch.experiments import common, figure_5

    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = f"[{smoke.card_line()}]"
    ctx = common.ExperimentContext(os.path.join(HERE, "models"),
                                   os.path.join(HERE, "build", "figure5b_replay"),
                                   scale=1.0, device="cuda")
    recorder = smoke.ChainRecorder(torch, chain.mcpc_chain)
    chain.mcpc_chain = recorder
    try:
        figure_5.similarity_increase_digit(ctx, epochs=smoke.FIG5_EPOCHS,
                                           seeds=tuple(args.seeds))
    finally:
        chain.mcpc_chain = recorder.fn
    rec = recorder.calls[1]
    smoke.check(rec["kw"].get("capture_stride"), "the figure-5 chain is not captured")
    failed = smoke.hold_replay(torch, chain, 8, f"figure 5b at seeds {tuple(args.seeds)}, "
                               "seed 0's spontaneous chain", rec, smoke.FID, tag)
    print(f"figure 5b at seeds {tuple(args.seeds)}: the replay "
          f"{'FAILS: ' + '; '.join(failed) if failed else 'holds'} {tag}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
