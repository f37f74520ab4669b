"""Hold one captured chain of ``chip_smoke.py`` phase 1 to float64 on several
input draws, on one GPU.

    python3 scripts/capture_rule_draws.py [--parent TREE] [--draws N]

The chain is phase 1's "captures, Langevin phase": 20-128-128-784, B=37,
200 Adam steps (lr 0.1) then 500 Langevin steps (lr 0.03, noise variance 2),
every Langevin step captured.  Its inputs are drawn as ``chip_smoke.py``
draws them (the shared generator after phase 1's chain cases), as it drew
them while the two unpacked cases of phase 1 took their numbers from the
same generator, and from ``N`` fresh seeds.  For each draw it prints the
kernel's and the plain f32 version's largest trajectory difference from the
plain version run in float64 (with its step and row), the number of rows
beyond 1e-3, whether the old rule holds (the kernel's largest difference at
most 1e-4 further from float64 than the plain f32 version's), and the
verdict of ``chip_smoke.py``'s row rule (``row_hold``, with the plain
version's witnesses) on every part of the result.  With ``--parent`` it
also runs the kernel of another checkout (unpacked there with ``git
archive``) on the same inputs, in a process of its own, and says whether the
two kernels give the same bits.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys

import torch

SEED, FID, MSE = 1234, (20, 128, 128, 784), (10, 256, 256, 784)
CHAIN = dict(warm_T=200, warm_lr=0.1, T=500, lr=0.03, noise_var=2.0,
             capture_stride=1, return_scalars=True)
# (dims, B) of phase 1's chain cases before the options, in order; the
# unpacked cases added later draw from a generator of their own
PHASE1 = ([(FID, 256)] * 3 + [(MSE, 256)] + [(FID, 256)] * 2
          + [(FID, 250), (FID, 8), (FID, 1), (MSE, 256)] + [(FID, 256)] * 3)
UNPACKED_CASES = [(FID, 1100), (MSE, 256)]


def draws(port, dev, n: int):
    """{name: (params, latents, target)} of every draw."""
    def case(gen, dims, B):
        model = port.make_mlp_model(*dims)
        params = model.init(gen, device=dev)
        latents = model.init_latents(params, torch.zeros(B, dims[0], device=dev), gen)
        target = (torch.rand(B, dims[3], generator=gen) > 0.5).float().to(dev)
        return params, latents, target

    def smoke(shapes):
        gen = torch.Generator().manual_seed(SEED)
        for dims, B in shapes:
            case(gen, dims, B)
        torch.randn(15, 120356, generator=gen)   # the summing pass's partials
        return case(gen, FID, 37)

    out = {"chip_smoke": smoke(PHASE1),
           "chip_smoke with the unpacked cases on the shared generator":
               smoke(PHASE1 + UNPACKED_CASES)}
    for s in range(1, n + 1):
        out[f"seed {SEED + 100 * s}"] = case(torch.Generator().manual_seed(SEED + 100 * s),
                                             FID, 37)
    return out


def kernel_runs(tree: str, n: int, path: str) -> None:
    """Run ``tree``'s kernel on every draw and save the results to ``path``."""
    sys.path.insert(0, os.path.abspath(tree))
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    dev = torch.device("cuda")
    out = {}
    for name, (p, l, t) in draws(port, dev, n).items():
        got = chain.mcpc_chain(p, l, t, SEED, **CHAIN)
        out[name] = ([x.cpu() for x in got[0]], got[2].cpu())
    torch.save(out, path)


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--draws", type=int, default=4)
    ap.add_argument("--save-kernel-runs", nargs=2, metavar=("TREE", "PATH"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.save_kernel_runs:
        tree, path = args.save_kernel_runs
        kernel_runs(tree, args.draws, path)
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, here)
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    dev = torch.device("cuda")
    parent = None
    if args.parent:
        path = os.path.join(here, "build", "capture_rule_parent.pt")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--draws", str(args.draws),
                        "--save-kernel-runs", args.parent, path], check=True)
        parent = torch.load(path, weights_only=False)

    def worst(e):
        """'largest at step s row r' of a [steps, B] error"""
        i = int(e.argmax())
        step, row = divmod(i, e.shape[1])
        return f"{float(e.max()):.3e} at step {step} row {row}"

    sys.path.insert(0, here)
    smoke = importlib.import_module("chip_smoke")
    held = held_rows = 0
    sets = draws(port, dev, args.draws)
    for name, (p, l, t) in sets.items():
        got = chain.mcpc_chain(p, l, t, SEED, **CHAIN)
        ref = chain.mcpc_chain_reference(p, l, t, SEED, **CHAIN)
        ref64 = chain.mcpc_chain_reference(
            tuple({k: v.double() for k, v in q.items()} for q in p),
            tuple(x.double() for x in l), t.double(), SEED, **CHAIN)
        k, f, d = (o[2].double() for o in (got, ref, ref64))
        ek, ef = ((x - d).abs().amax(dim=2) for x in (k, f))   # [steps, B]
        rule = float(ek.max()) <= float(ef.max()) + 1e-4
        held += rule
        text, failed, _ = smoke.row_hold(torch, chain, name, got, ref, ref64,
                                         smoke.Witnesses(torch, chain, p, l, t, SEED, CHAIN),
                                         CHAIN)
        held_rows += not failed
        line = (f"{name}: trajectory from float64: kernel {worst(ek)}, plain f32 "
                f"{worst(ef)}; rows beyond 1e-3: kernel {int((ek.amax(0) > 1e-3).sum())}, "
                f"plain f32 {int((ef.amax(0) > 1e-3).sum())}; the old rule holds: {rule}; "
                f"the row rule {'FAILS' if failed else 'holds'}: {text}")
        if parent is not None:
            lat, traj = parent[name]
            same = torch.equal(traj, got[2].cpu()) and all(
                torch.equal(a, b.cpu()) for a, b in zip(lat, got[0]))
            line += f"; the parent's kernel gives the same bits: {same}"
        print(line)
    print(f"the old rule holds on {held} of {len(sets)} draws, the row rule on {held_rows}")


if __name__ == "__main__":
    main()
