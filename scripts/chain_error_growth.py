"""Where a chain's f32 rounding grows: the packed kernel and the plain f32
version, each against the plain version run in float64, step by step, on one
GPU.

    python3 scripts/chain_error_growth.py [--batch B] [--steps T] [--adam] \\
        [--loss bernoulli|bernoulli_mask] [--mask-perc P] [--seed S]

A Langevin chain (20-128-128-784, relu, lr 0.03, noise variance 2, every
step captured) from a random model and its random initial latents; with
``--adam``, the Adam MAP descent of a warm phase instead (lr 0.1, no
noise).  Prints one JSON line: for some steps, the largest |x - x64| over the captured
latents of the kernel and of the plain f32 version; the counts of rows
whose error ever passes 1e-4 in each; and the rows where the kernel's error
ends largest, with their cluster (the plan's rows a cluster), the step at
which the kernel's and the plain version's errors first passed 1e-4, and
their final errors.  An error that stays at rounding size and then jumps in
a few rows, in one version and not the other, is the chain amplifying a
rounding difference; a wrong kernel differs from the first steps on.  Needs
a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--loss", default="bernoulli_mask")
    ap.add_argument("--mask-perc", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--adam", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    B, T = args.batch, args.steps
    dims = (20, 128, 128, 784)
    gen = torch.Generator().manual_seed(args.seed)
    model = port.make_mlp_model(*dims)
    params = model.init(gen, device=dev)
    latents = model.init_latents(params, torch.zeros(B, dims[0], device=dev), gen)
    target = (torch.rand(B, dims[3], generator=gen) > 0.5).float().to(dev)
    kw = dict(T=T, lr=0.03, noise_var=2.0, loss=args.loss, capture_stride=1,
              return_scalars=True)
    if args.adam:
        kw.update(T=0, warm_T=T, warm_lr=0.1, lr=0.1, noise_var=None)
    if args.loss.endswith("_mask"):
        kw["mask_perc"] = args.mask_perc
    traj = chain.mcpc_chain(params, latents, target, args.seed, **kw)[2]
    plain = chain.mcpc_chain_reference(params, latents, target, args.seed, **kw)[2]
    exact = chain.mcpc_chain_reference(
        tuple({k: v.double() for k, v in p.items()} for p in params),
        tuple(x.double() for x in latents), target.double(), args.seed, **kw)[2]
    # [T, B]: each row's largest error at each step
    err_k = (traj.double() - exact).abs().amax(dim=2)
    err_p = (plain.double() - exact).abs().amax(dim=2)
    del traj, plain, exact

    def first_past(err, row):
        past = torch.nonzero(err[:, row] > 1e-4)
        return int(past[0, 0]) if past.numel() else None

    plan = chain.chain_plan(dims, B, warm=args.adam, with_pgrads=False,
                            budget=chain.smem_budget(dev),
                            max_clusters=chain.max_active_clusters(dev))
    steps = sorted({t for t in (0, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, T - 1) if t < T})
    worst = torch.argsort(err_k[-1], descending=True)[:5].tolist()
    print(json.dumps({
        "batch": B, "steps": T, "adam": args.adam, "loss": args.loss,
        "rows_a_cluster": plan.rows,
        "max_err_by_step": {t: [float(err_k[t].max()), float(err_p[t].max())] for t in steps},
        "rows_past_1e-4": [int((err_k > 1e-4).any(0).sum()), int((err_p > 1e-4).any(0).sum())],
        "kernel_worst_rows": [
            {"row": r, "cluster": r // plan.rows, "kernel_first_past_1e-4": first_past(err_k, r),
             "plain_first_past_1e-4": first_past(err_p, r),
             "final": [float(err_k[-1, r]), float(err_p[-1, r])]}
            for r in worst],
    }))


if __name__ == "__main__":
    main()
