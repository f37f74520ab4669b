"""Chain (c) of ``chip_smoke.py``'s phase 2 over several draws of the
latents: how far the unpacked kernel of a checkout ends from the plain
version in f32, how far both end from the plain version in float64, and how
far the plain version ends from both when its products are taken as
split-TF32 ones (``ops/mcpc_chain.tf32_split_matmul``: the split alone,
summed in float64 and rounded to f32, apart from how a tensor core's sums
round).

    python3 scripts/chain_c_draws.py [TREE] [--label NAME] [--draws N] [--steps T]
                                     [--batch B] [--device cpu]

``TREE`` is the root of a checkout whose kernel is run (default: this one).
The model, its seed, the data batch and chain (c)'s options are the smoke's,
imported from this checkout's ``chip_smoke.py``; draw 0 is the smoke's
latents (``init_latents`` from seed ``SEED + 1``), draw k those from ``SEED
+ 1 + k``.  Prints one JSON line: per draw the largest distance over the
latents between each pair, and how many rows the kernel has further than
1e-4 from the plain f32 version.  On these Langevin chains a latent that
passes relu's kink within rounding of zero can go either way, and from there
its row follows another path: that is what a large distance in one row
means.  On the CPU the kernel's call runs the plain version itself, so
``kernel_plain`` is 0 there: that mode checks the script at a small size.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def split_products(chain):
    """Every float32 ``a @ b`` as :func:`tf32_split_matmul` takes it."""
    plain = torch.Tensor.__matmul__

    def split(a, b):
        if a.dtype == torch.float32 and b.dtype == torch.float32:
            return chain.tf32_split_matmul(a, b)
        return plain(a, b)

    torch.Tensor.__matmul__ = split
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = plain


def main() -> None:
    sys.path.insert(0, HERE)
    smoke = importlib.import_module("chip_smoke")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--steps", type=int, default=smoke.CHAIN_C["T"])
    ap.add_argument("--batch", type=int, default=smoke.BATCH)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    from montecarlopredictivecoding_tpu_torch.data.mnist import get_mnist_data
    from montecarlopredictivecoding_tpu_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    config = smoke.MODEL_CONFIG
    model = get_model(config, smoke.SEED, device=dev)
    data = next(iter(get_mnist_data(config, device=dev)[2]))[0][: args.batch]
    params64 = [{k: v.double() for k, v in p.items()} for p in model.params]
    kw = dict(smoke.CHAIN_C, T=args.steps)

    def far(a, b):
        return float(torch.cat([(x.double() - y.double()).abs() for x, y in zip(a, b)],
                               dim=1).max())

    rows = []
    for draw in range(args.draws):
        latents = model.model.init_latents(
            model.params, torch.zeros(args.batch, config["input_size"], device=dev),
            torch.Generator().manual_seed(smoke.SEED + 1 + draw))
        got = chain.mcpc_chain(model.params, latents, data, smoke.SEED, **kw)[0]
        ref = chain.mcpc_chain_reference(model.params, latents, data, smoke.SEED, **kw)[0]
        ref64 = chain.mcpc_chain_reference(params64, tuple(x.double() for x in latents),
                                           data.double(), smoke.SEED, **kw)[0]
        with split_products(chain):
            split = chain.mcpc_chain_reference(model.params, latents, data, smoke.SEED,
                                               **kw)[0]
        row_far = torch.cat([(x - y).abs() for x, y in zip(got, ref)], dim=1).amax(dim=1)
        rows.append({"draw": draw, "kernel_plain": far(got, ref), "kernel_f64": far(got, ref64),
                     "plain_f64": far(ref, ref64), "split_plain": far(split, ref),
                     "split_f64": far(split, ref64),
                     "rows_over_1e-4": int((row_far > 1e-4).sum())})
    print(json.dumps({"tree": args.label or args.tree, "device": args.device,
                      "batch": args.batch, "steps": args.steps, "draws": rows}))


if __name__ == "__main__":
    main()
