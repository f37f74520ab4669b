"""Whether the kernel's first batch of ``train_mcpc(preset="mse")`` is a
correct f32 order, on one GPU.

    python3 scripts/mse_batch_diagnosis.py [--device cuda]

That batch (10-256-256-784 relu, B=256: 250 Adam steps at lr 0.7, then 150
Langevin steps with the gradients of the last 100, the gradient slice
read-modify-written through L2) is recorded through the entry point, as
``chip_smoke.py`` phase 3 records it.  Then:

- the kernel run again with every Langevin step captured (it must give the
  training's bits), and its gradients against those its own trajectory
  implies: each sampling step's pre-update state through the plain
  version's one-step gradients, summed in float64; the plain f32 version
  the same way.  Per tensor, the largest difference relative to the
  tensor's largest entry (``own_trajectory``);
- the Langevin phase alone, started from the kernel's own state at the
  end of its warm phase (its first captured step), held by the smoke's row
  rule part by part under the witnesses of 16 copies (8 summed) and of
  the smoke's counts (``from_the_kernels_warm_end``): where the unflagged
  gradient entries of the whole batch come from rows that parted in the
  warm phase, they fall to the other correct orders' level here;
- the warm phase alone, every step captured, in the kernel, the plain f32
  version, float64 and the plain version with its products summed in two
  halves: the rows where each sits more than 1e-4 from the plain f32
  version at the last captured step (the plain version itself: from
  float64), and for each of the
  kernel's, the step it first differs, the step it passes 1e-4 and the
  difference just before and at that step (``departures``).

A step that turns on a rounding moves a row by an Adam step (about lr)
after steps where it sat at rounding size; the same rows part in the other
correct orders.  Prints JSON lines.  Needs a CUDA device and nvcc
(``--device cpu`` runs the plain version in the kernel's place, to check
the script).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def per_tensor(grads, base) -> dict:
    """Each gradient tensor's largest difference from ``base``, relative to
    the largest entry of ``base``'s."""
    out = {}
    for i, (g, b) in enumerate(zip(grads, base)):
        for k in ("w", "b"):
            scale = float(b[k].double().abs().max()) or 1e-30
            out[f"{k}{i}"] = float((g[k].double() - b[k].double()).abs().max()) / scale
    return out


def trajectory_grads(chain, smoke, params, target, traj, dims, steps):
    """The gradients the captured states of ``steps`` imply, in float64."""
    _, offs, _ = chain.aligned_layout(dims[:3])
    p64, _, t64 = smoke.to_double(params, (), target)
    total = None
    for t in steps:
        lat = tuple(traj[t][:, o : o + d].double() for o, d in zip(offs, dims[:3]))
        g = chain.mcpc_chain_reference(p64, lat, t64, 0, T=1, lr=0.1, noise_var=None,
                                       mixing=0, with_pgrads=True, loss="bernoulli")[1]
        total = g if total is None else tuple({k: a[k] + b[k] for k in a}
                                              for a, b in zip(total, g))
    return total


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    smoke = importlib.import_module("chip_smoke")
    cases = importlib.import_module("rule_cases")
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)
    torch.backends.cuda.matmul.allow_tf32 = False
    recorder = smoke.ChainRecorder(torch, train_mnist.mcpc_chain)
    train_mnist.mcpc_chain = recorder
    try:
        train_mnist.train_mcpc(1, os.path.join(HERE, "build", "mse_batch_diagnosis"),
                               seed=smoke.SEED, batches_per_epoch=1, log=False, preset="mse",
                               device=dev)
    finally:
        train_mnist.mcpc_chain = recorder.fn
    params, latents, target, seed = recorder.calls[0]["inputs"]
    kw = recorder.calls[0]["kw"]
    dims = smoke.MSE

    captured = chain.mcpc_chain(params, latents, target, seed, **dict(kw, capture_stride=1))
    same = smoke.bits_equal(torch, {"latents": captured[0], "pgrads": captured[1]},
                            recorder.calls[0]["parts"])
    plain = chain.mcpc_chain_reference(params, latents, target, seed,
                                       **dict(kw, capture_stride=1))
    sampling = range(kw["mixing"], kw["T"])
    print(json.dumps({"own_trajectory": {
        "capture_gives_the_training_bits": same,
        "kernel": per_tensor(captured[1], trajectory_grads(chain, smoke, params, target,
                                                           captured[2], dims, sampling)),
        "plain f32": per_tensor(plain[1], trajectory_grads(chain, smoke, params, target,
                                                           plain[2], dims, sampling))}}),
          flush=True)

    _, offs, _ = chain.aligned_layout(dims[:3])
    start = tuple(captured[2][0][:, o : o + d].contiguous() for o, d in zip(offs, dims[:3]))
    lang = dict(kw, warm_T=0)
    got = chain.mcpc_chain(params, start, target, seed, **lang)
    ref = chain.mcpc_chain_reference(params, start, target, seed, **lang)
    ref64 = chain.mcpc_chain_reference(*smoke.to_double(params, start, target), seed,
                                       **smoke.doubled(lang))
    gp, rp, bp = (smoke.option_parts(o, lang) for o in (got, ref, ref64))
    held = {}
    for n, m in sorted({(16, 8), (smoke.STACKED_COPIES, smoke.SUM_COPIES)}):
        wit = smoke.Witnesses(torch, chain, params, start, target, seed, lang, copies=n,
                              sum_copies=m)
        for part, allow, _ in smoke.PART_RULES:
            if gp.get(part) is not None:
                v = smoke.unit_rule(torch, part, gp[part], rp[part], bp[part], allow, wit)
                held[f"{n}/{m} copies, {part}"] = {
                    k: v.get(k) for k in ("ok", "units", "beyond", "sensitive", "unexcused")}
    print(json.dumps({"from_the_kernels_warm_end": held}), flush=True)

    warm = {k: v for k, v in kw.items() if k not in ("mixing", "with_pgrads")}
    warm.update(T=0, capture_stride=1)
    runs = {"kernel": chain.mcpc_chain(params, latents, target, seed, **warm),
            "plain f32": chain.mcpc_chain_reference(params, latents, target, seed, **warm),
            "float64": chain.mcpc_chain_reference(*smoke.to_double(params, latents, target),
                                                  seed, **warm)}
    with cases.other_order("halves"):
        runs["products in halves"] = chain.mcpc_chain_reference(params, latents, target, seed,
                                                                **warm)
    paths = {k: v[2].double() for k, v in runs.items()}
    apart = {k: (paths[k] - paths["float64" if k == "plain f32" else "plain f32"]).abs().amax(2)
             for k in ("kernel", "plain f32", "products in halves")}   # [steps, B]
    rows = {k: torch.nonzero(d[-1] > 1e-4).flatten().tolist() for k, d in apart.items()}
    out = []
    d = apart["kernel"]
    for r in rows["kernel"]:
        first = int(torch.nonzero(d[:, r] > 0).flatten()[0])
        past = int(torch.nonzero(d[:, r] > 1e-4).flatten()[0])
        out.append({"row": r, "first_differs": first, "passes_1e-4": past,
                    "before": float(d[past - 1, r]), "at": float(d[past, r]),
                    "end": float(d[-1, r])})
    print(json.dumps({"departures": {"rows_beyond_1e-4_after_the_warm_phase": rows,
                                     "kernel_rows": out},
                      "card": smoke.card_line() if dev.type == "cuda" else "cpu"}), flush=True)


if __name__ == "__main__":
    main()
