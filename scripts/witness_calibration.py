"""How many witnesses ``chip_smoke.py``'s row rule needs, on one GPU.

    python3 scripts/witness_calibration.py [--copies 16] [--update-ulps N]

Runs the kernel, the plain version in f32 and in float64, and ``--copies``
stacked witness copies (``chip_smoke.Witnesses``, the latents moved by up
to ``--update-ulps`` ulps a step; 0 leaves only the products' reversed order) on the
chains the rule was calibrated on: chain (c) over 8 draws of its latents
(as ``scripts/chain_c_draws.py`` draws them), phase 1's captured chain over
6 draws (``scripts/capture_rule_draws.py``) and figure 2's four chains (cut
to 200 warm and 500 Langevin steps, and the PC posterior at its full
length).  For each chain and row part it prints one JSON line: the units,
how many the kernel sits beyond the plain f32 version's distance from
float64 plus the allowance, and for the first 4, 8 and all copies how many
units are sensitive (the plain f32 version or a copy parts beyond the
allowance), how many of the kernel's units that leaves uncovered, and the
kernel's largest distance over its unit's own envelope (the furthest
correct order on that unit, plus the allowance).  The last line sums the
uncovered units by copies.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOW = {"latents": "P1_ATOL", "traj": "P1_ATOL", "moments": "P1_MOMENT_REL"}


def coverage(smoke, chain, params, latents, target, seed, kw, copies, ulps):
    """Per row part: the kernel's, plain f32's and each copy's distances."""
    got = chain.mcpc_chain(params, latents, target, seed, **kw)
    ref = chain.mcpc_chain_reference(params, latents, target, seed, **kw)
    base = chain.mcpc_chain_reference(*smoke.to_double(params, latents, target), seed,
                                      **smoke.doubled(kw))
    gp, rp, bp = (smoke.option_parts(o, kw) for o in (got, ref, base))
    wit = smoke.Witnesses(torch, chain, params, latents, target, seed, kw, copies=copies,
                          ulps=ulps).stacked()
    out = {}
    for part in ("latents", "traj", "moments"):
        if gp.get(part) is None:
            continue
        allow = getattr(smoke, ALLOW[part])
        d_got = smoke.unit_distances(torch, part, gp[part], bp[part])[0]
        d_ref = smoke.unit_distances(torch, part, rp[part], bp[part])[0]
        parted = torch.stack([smoke.unit_distances(torch, part, w[part], rp[part])[0]
                              for w in wit])
        d_w = torch.stack([smoke.unit_distances(torch, part, w[part], bp[part])[0]
                           for w in wit])
        beyond = d_got > d_ref + allow
        row = {"units": d_got.numel(), "kernel_beyond": int(beyond.sum())}
        for k in sorted({4, 8, copies}):
            sens = torch.maximum(parted[:k].amax(0), d_ref) > allow
            env = torch.maximum(d_w[:k].amax(0), d_ref)
            sel = beyond & sens
            row[f"copies_{k}"] = {
                "sensitive": int(sens.sum()), "uncovered": int((beyond & ~sens).sum()),
                "over_own_envelope": float((d_got[sel] / (env[sel] + allow)).max())
                if bool(sel.any()) else 0.0}
        out[part] = row
    return out


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    smoke = importlib.import_module("chip_smoke")
    draws = importlib.import_module("capture_rule_draws")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--copies", type=int, default=16)
    ap.add_argument("--update-ulps", type=int, default=smoke.UPDATE_ULPS)
    args = ap.parse_args()
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    from montecarlopredictivecoding_tpu_torch.data.mnist import get_mnist_data
    from montecarlopredictivecoding_tpu_torch.experiments import common, figure_2
    from montecarlopredictivecoding_tpu_torch.models import get_model

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cases = []
    model = get_model(smoke.MODEL_CONFIG, smoke.SEED, device=dev)
    data = next(iter(get_mnist_data(smoke.MODEL_CONFIG, device=dev)[2]))[0]
    for draw in range(8):
        lat = model.model.init_latents(model.params, torch.zeros(smoke.BATCH, 20, device=dev),
                                       torch.Generator().manual_seed(smoke.SEED + 1 + draw))
        cases.append((f"chain (c), draw {draw}", model.params, lat, data, smoke.SEED,
                      smoke.CHAIN_C))
    for name, (p, lat, t) in draws.draws(port, dev, 4).items():
        cases.append((f"captured chain, {name}", p, lat, t, draws.SEED, draws.CHAIN))
    ctx = common.ExperimentContext(os.path.join(HERE, "models"),
                                   os.path.join(HERE, "build", "witness_calibration"),
                                   scale=1.0, device="cuda")
    recorder = smoke.ChainRecorder(torch, chain.mcpc_chain)
    chain.mcpc_chain = recorder
    try:
        figure_2.posterior_non_linear_model(ctx, img_kept=0.5)
    finally:
        chain.mcpc_chain = recorder.fn
    for label, rec in zip(("probe MAP 1", "probe MAP 2", "PC posterior", "MCPC posterior"),
                          recorder.calls):
        kw = rec["kw"]
        cut = dict(kw, warm_T=min(kw.get("warm_T", 0), 200), T=min(kw["T"], 500))
        cases.append((f"figure 2, {label}, cut", *rec["inputs"], cut))
        if label == "PC posterior":
            cases.append((f"figure 2, {label}, full length", *rec["inputs"], kw))
    uncovered = {}
    for name, params, lat, target, seed, kw in cases:
        out = coverage(smoke, chain, params, lat, target, seed, kw, args.copies,
                       args.update_ulps)
        for row in out.values():
            for key, val in row.items():
                if key.startswith("copies_"):
                    uncovered[key] = uncovered.get(key, 0) + val["uncovered"]
        print(json.dumps({"chain": name, "update_ulps": args.update_ulps, **out}), flush=True)
    print(json.dumps({"update_ulps": args.update_ulps, "uncovered": uncovered,
                      "card": smoke.card_line()}))


if __name__ == "__main__":
    main()
