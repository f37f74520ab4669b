"""Chain (c) of ``chip_smoke.py``'s phase 2 over several draws of the
latents: how far the unpacked kernel of a checkout ends from the plain
version in f32, how far both end from the plain version in float64, how far
the plain version ends from both when its products are taken as split-TF32
ones (``ops/mcpc_chain.tf32_split_matmul``: the split alone, summed in
float64 and rounded to f32, apart from how a tensor core's sums round), and
the verdicts of the smoke's old rule (the largest difference from the plain
f32 version within ``P2_ATOL``) and of its row rule (``row_hold`` against
float64, with the plain version's witnesses).

    python3 scripts/chain_c_draws.py [TREE] [--label NAME] [--draws N] [--steps T]
                                     [--batch B] [--device cpu] [--faults]

``TREE`` is the root of a checkout whose kernel is run (default: this one).
The model, its seed, the data batch, chain (c)'s options and both rules are
the smoke's, imported from this checkout's ``chip_smoke.py``; draw 0 is the
smoke's latents (``init_latents`` from seed ``SEED + 1``), draw k those from
``SEED + 1 + k``.  Prints one JSON line: per draw the largest distance over
the latents between each pair, how many rows the kernel has further than
1e-4 from the plain f32 version, both verdicts and, for each row the row
rule had to look at, the kernel's, the plain version's and the witnesses'
distances from float64.  On these Langevin chains a latent that passes
relu's kink within rounding of zero can go either way, and from there its
row follows another path: that is what a large distance in one row means.
``--faults`` also runs the kernel on draw 0 with one of its arguments
wrong (``FAULTS``: the step size, the number of steps, the seed, the noise
variance) and holds each against the right plain version by both rules,
which must fail it.  On the CPU the kernel's call runs the plain version
itself, so ``kernel_plain`` is 0 there: that mode checks the script at a
small size.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# faults reachable through the kernel's own arguments: (name, how the
# options and the seed change)
FAULTS = (("lr * (1 + 1e-3)", lambda kw, seed: (dict(kw, lr=kw["lr"] * (1 + 1e-3)), seed)),
          ("one Langevin step fewer", lambda kw, seed: (dict(kw, T=kw["T"] - 1), seed)),
          ("seed + 1", lambda kw, seed: (kw, seed + 1)),
          ("noise_var * 1.01", lambda kw, seed: (dict(kw, noise_var=kw["noise_var"] * 1.01),
                                                 seed)))


def verdicts(smoke, chain, got, ref, ref64, witnesses, kw) -> dict:
    """Both rules on one chain (c) result: the old one and the row rule,
    with the rows the row rule had to look at (at most 8)."""
    far = float(torch.cat([(x - y).abs() for x, y in zip(got[0], ref[0])], dim=1).max())
    text, failed, _ = smoke.row_hold(torch, chain, "chain (c)", got, ref, ref64, witnesses, kw)
    d_got = smoke.unit_distances(torch, "latents", got[0], ref64[0])[0]
    d_ref = smoke.unit_distances(torch, "latents", ref[0], ref64[0])[0]
    looked = torch.nonzero(d_got > d_ref + smoke.P1_ATOL).flatten()[:8].tolist()
    rows = []
    if looked:
        d_w = [smoke.unit_distances(torch, "latents", w, ref64[0])[0]
               for w in witnesses.of("latents")]
        rows = [{"row": r, "kernel": float(d_got[r]), "plain": float(d_ref[r]),
                 "witnesses": [float(d[r]) for d in d_w]} for r in looked]
    return {"old_rule": "holds" if far <= smoke.P2_ATOL else "FAILS",
            "row_rule": "FAILS" if failed else "holds", "row_rule_text": text, "rows": rows}


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    smoke = importlib.import_module("chip_smoke")
    cases = importlib.import_module("rule_cases")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--draws", type=int, default=8)
    ap.add_argument("--steps", type=int, default=smoke.CHAIN_C["T"])
    ap.add_argument("--batch", type=int, default=smoke.BATCH)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--faults", action="store_true")
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

    rows, faults = [], []
    for draw in range(args.draws):
        latents = model.model.init_latents(
            model.params, torch.zeros(args.batch, config["input_size"], device=dev),
            torch.Generator().manual_seed(smoke.SEED + 1 + draw))
        got = chain.mcpc_chain(model.params, latents, data, smoke.SEED, **kw)
        ref = chain.mcpc_chain_reference(model.params, latents, data, smoke.SEED, **kw)
        ref64 = chain.mcpc_chain_reference(params64, tuple(x.double() for x in latents),
                                           data.double(), smoke.SEED, **kw)
        with cases.split_products(chain):
            split = chain.mcpc_chain_reference(model.params, latents, data, smoke.SEED,
                                               **kw)[0]
        witnesses = smoke.Witnesses(torch, chain, model.params, latents, data, smoke.SEED, kw)
        row_far = torch.cat([(x - y).abs() for x, y in zip(got[0], ref[0])], dim=1).amax(dim=1)
        rows.append({"draw": draw, "kernel_plain": far(got[0], ref[0]),
                     "kernel_f64": far(got[0], ref64[0]), "plain_f64": far(ref[0], ref64[0]),
                     "split_plain": far(split, ref[0]), "split_f64": far(split, ref64[0]),
                     "rows_over_1e-4": int((row_far > 1e-4).sum()),
                     **verdicts(smoke, chain, got, ref, ref64, witnesses, kw)})
        if args.faults and draw == 0:
            for name, change in FAULTS:
                kw_f, seed_f = change(kw, smoke.SEED)
                bad = chain.mcpc_chain(model.params, latents, data, seed_f, **kw_f)
                faults.append({"fault": name, "kernel_plain": far(bad[0], ref[0]),
                               **verdicts(smoke, chain, bad, ref, ref64, witnesses, kw)})
    out = {"tree": args.label or args.tree, "device": args.device, "batch": args.batch,
           "steps": args.steps, "draws": rows}
    if args.faults:
        out["faults"] = faults
    print(json.dumps(out))


if __name__ == "__main__":
    main()
