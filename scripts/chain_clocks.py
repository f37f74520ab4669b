"""Where a step of the packed chain kernel spends its SM clocks, on one GPU.

    python3 scripts/chain_clocks.py [--steps 2000] [--batch 256] [--rows N] [--bf16]
                                    [--warps]

For both widths (20-128-128-784 and 10-256-256-784) and three chains (a
Langevin chain, an Adam warm phase alone, a Langevin chain that takes the
parameter gradients on every step) it runs ``chain_phase_clocks`` and prints
the plan, the time per step (CUDA events around the call, median of 3 after
a warm-up) and the clocks per step that thread 0 of a block spends in each
phase, averaged over the blocks.  The two wait phases hold the step's
hand-offs: "wait for partials" runs from the end of the backward through the
block's arrivals and the noise draws to the end of the wait until every
rank's partials are in, "wait for relu(x)" from the end of the update to the
end of the wait until every owner's act(x) is in (the f32 build waits on
mbarriers there, the bf16 build at its two cluster barriers).  ``--rows`` forces
the rows a cluster (one of the wrapper's ``CLUSTER_ROWS``) instead of the
plan's own choice: this is how the plan's rule for the rows was measured.
``--bf16`` times the bf16 build (``bf16_matmul=True``: the tensor-core
products) instead of the f32 one.  ``--warps`` runs the f32 kernel's
profiling build (``-DMCPC_WARP_CLOCKS``, built into a directory of its own
under ``build/``) and prints, below each chain, every warp's clocks a step
averaged over the blocks: from the step's start to its first forward job,
from its first forward job to the end of its last, and the same for its
backward jobs; then the slowest warp's and the mean warp's forward and
backward jobs beside the phases that hold them.
Needs a CUDA device and nvcc; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import importlib
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import montecarlopredictivecoding_tpu_torch as port  # noqa: E402

chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

WIDTHS = {"fid": (20, 128, 128, 784), "mse": (10, 256, 256, 784)}


def event_ms(fn, reps: int = 3):
    """(median ms of ``fn`` over ``reps`` calls after a warm-up, the last output)."""
    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), out


def print_warps(per_warp, per_step, T: int) -> None:
    """Each warp's clocks a step (``chain.WARP_PARTS``), averaged over the
    blocks, then the slowest and the mean warp beside the phases."""
    w = (per_warp.double().mean(dim=0) / T).tolist()   # [warps][parts]
    for i, parts in enumerate(w):
        print(f"  warp {i:2d}: " + ", ".join(
            f"{name} {c:.0f}" for name, c in zip(chain.WARP_PARTS, parts)))
    fwd = [p[1] for p in w]
    bwd = [p[2] for p in w]
    phase = dict(zip(chain.PHASES, per_step))
    print(f"  forward: phase {phase['forward']:.0f}, slowest warp's jobs {max(fwd):.0f} "
          f"(warp {fwd.index(max(fwd))}), mean {sum(fwd) / len(fwd):.0f}; "
          f"backward: phase {phase['backward']:.0f}, slowest {max(bwd):.0f} "
          f"(warp {bwd.index(max(bwd))}), mean {sum(bwd) / len(bwd):.0f}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=2000)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--rows", type=int, default=None)
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--warps", action="store_true")
    args = parser.parse_args()
    if args.warps and args.bf16:
        parser.error("--warps times the f32 build")
    if not torch.cuda.is_available():
        print("chain_clocks: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip())
    from montecarlopredictivecoding_tpu_torch.ops import _build

    # the libraries this run needs, one nvcc each, all at once
    _build.build_all([("mcpc_chain", args.bf16)]
                     + ([("mcpc_chain", False, True)] if args.warps else []))
    row_counts = chain.CLUSTER_ROWS if args.rows is None else (args.rows,)
    T = args.steps
    chains = {
        "langevin": dict(T=T, lr=0.01),
        "warm": dict(T=0, warm_T=T, lr=0.01),
        "langevin, gradients on every step": dict(T=T, lr=0.01, with_pgrads=True),
    }
    chains = {name: dict(kw, bf16_matmul=args.bf16) for name, kw in chains.items()}
    for width, dims in WIDTHS.items():
        gen = torch.Generator().manual_seed(args.seed)
        model = port.make_mlp_model(*dims)
        params = model.init(gen, device=dev)
        latents = model.init_latents(
            params, torch.zeros(args.batch, dims[0], device=dev), gen)
        target = (torch.rand(args.batch, dims[3], generator=gen) > 0.5).float().to(dev)
        for name, kw in chains.items():
            try:
                plan = chain.device_plan(
                    chain._chain_args(params, latents, target, 1, **kw), args.batch, dev,
                    row_counts)
            except ValueError as e:
                print(f"{width} {name}: {e}")
                continue
            ms, clocks = event_ms(lambda: chain.chain_phase_clocks(
                params, latents, target, 1, rows=args.rows, warps=args.warps, **kw))
            if args.warps:
                clocks, per_warp = clocks
            per_step = (clocks.double().mean(dim=0) / T).tolist()
            print(f"{width} {dims} B={args.batch} {name}{' bf16' if args.bf16 else ''}: "
                  f"{plan.describe(chain.max_active_clusters(dev, plan, bf16=args.bf16))}; "
                  f"{1e3 * ms / T:.3f} us/step; SM clocks a step: "
                  + ", ".join(f"{p} {c:.0f}" for p, c in zip(chain.PHASES, per_step))
                  + f"; sum {sum(per_step):.0f}", flush=True)
            if args.warps:
                print_warps(per_warp, per_step, T)
    return 0


if __name__ == "__main__":
    sys.exit(main())
