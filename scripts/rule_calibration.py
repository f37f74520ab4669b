"""How many witnesses ``chip_smoke.py``'s row rule needs, and how it tells
correct f32 orders from faults on the long Adam chains, where most rows
part, on one GPU.

    python3 scripts/rule_calibration.py [--copies 16 32 64] [--fresh 16] [--chains NAME ...]

Chains, each at its full length on the smoke's own inputs: phase 5's
MSE-rec of ``pc_mse_1`` and of ``mcpc_mse_1`` (250 Adam steps at lr 0.7 on
the first test batch, B=1024), the joint sampler's warm start (250 Adam
steps at lr 0.7, x3 moved off its prediction, B=256), figure 2's two
probe MAP chains (2000 Adam steps at lr 0.1, B=1024) and its PC posterior
(2000 such steps, every one captured, B=16); and the first batch of each
trainer's mse preset through its entry point: ``train_mcpc(preset="mse")``
(10-256-256-784 relu, B=256: 250 Adam steps at lr 0.7, then 150 Langevin
steps with the gradients of the last 100) and ``train_pc(preset="mse")``
(30-256-256-784 tanh, B=128: 250 Adam steps at lr 0.1 with the last step's
gradients).  On each, runs stand in for the kernel
(``scripts/rule_cases.py``):

- correct orders: the kernel itself; the products summed in two halves of
  k, or taken in float64 and rounded once; the latents started one ulp
  away (three draws of the directions); on figure 2's chains the
  split-TF32 products of ``tf32_split_matmul``; and ``--fresh`` fresh
  witnesses (the witnesses' rounding, drawn from another seed);
- faults: lr (and warm lr) × (1 + 1e-3); Adam's bias correction off; one
  row's update skipped for one step halfway through, in the row where the
  witnesses part least and in the one where they part most.

Every run is held by the smoke's own ``unit_rule`` under the witnesses of
each ``--copies`` count ``N``, built as the smoke builds them
(``Witnesses(copies=N, sum_copies=N // 2)``, its seeds).  For each chain,
run and part it prints one JSON line: the old largest-element rule's
verdict, and for each count the row rule's (``ok``), its unflagged units
and their cap, the flagged ones, the RMS ratio over the worst correct
order, whether the old rule held where every correct order keeps it
(``clause``: kept, FAILS, or does not apply), and the part-level bound's
ratio: the unit furthest from float64 over the furthest any correct
order's unit lies, plus the allowance (``reach_part``).  The last line
gives, per count, the correct orders other than the kernel that fail a
part, the kernel's failing parts, the faults that pass, and the parts
where such a clause alone would fail a run the rule passes; and
``chosen``: the least count under which no correct order but the kernel
fails any part of any chain (null if none).  Needs a CUDA
device and nvcc (``--device cpu`` runs the plain version in the kernel's
place, to check the script).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHAINS = ("MSE-rec pc_mse_1", "MSE-rec mcpc_mse_1", "joint sampler, PC warm start",
          "probe MAP, batch 1", "probe MAP, batch 2", "PC posterior",
          "MCPC training, mse, batch 1", "PC training, mse, batch 1")
FIGURE_2 = CHAINS[3:6]
TRAINING = CHAINS[6:]


def recorded_chains(smoke, port, chain, dev, wanted):
    """{name: (params, latents, target, seed, kw)} of the wanted chains, as
    the smoke records them."""
    from montecarlopredictivecoding_tpu_torch.data.mnist import get_mnist_data
    from montecarlopredictivecoding_tpu_torch.eval import metrics
    from montecarlopredictivecoding_tpu_torch.experiments import common, figure_2, train_mnist
    from montecarlopredictivecoding_tpu_torch.models import get_pc_trainer

    ctx = common.ExperimentContext(os.path.join(HERE, "models"),
                                   os.path.join(HERE, "build", "rule_calibration"),
                                   scale=1.0, device=dev.type)
    out = {}

    def record(fn):
        recorder = smoke.ChainRecorder(torch, chain.mcpc_chain)
        chain.mcpc_chain = recorder
        try:
            fn()
        finally:
            chain.mcpc_chain = recorder.fn
        return [(*r["inputs"], r["kw"]) for r in recorder.calls]

    for name, dims, act in (("pc_mse_1", smoke.PC_MSE, "tanh"), ("mcpc_mse_1", smoke.MSE, "relu")):
        if f"MSE-rec {name}" not in wanted:
            continue
        cfg = smoke.eval_config(port, dims, act, 0.7)
        batch = next(iter(get_mnist_data(cfg, device=dev)[2]))
        gen_e = common.load_generative_checkpoint(ctx, name, cfg)
        out[f"MSE-rec {name}"] = record(lambda: metrics.get_mse_rec(gen_e, cfg, [batch]))[0]
    if "joint sampler, PC warm start" in wanted:
        cfg, joint = smoke.joint_sampler_model(port, HERE, dev)
        pseudo = torch.zeros(smoke.BATCH, smoke.FID[0], device=dev)
        p, lat, t, seed, kw = record(lambda: get_pc_trainer(
            joint, cfg, is_mcpc=True, training=False).train_on_batch(pseudo, loss_fn=None))[0]
        lat = smoke.off_prediction(torch, lat, torch.Generator().manual_seed(smoke.SEED + 6))
        out["joint sampler, PC warm start"] = (p, lat, t, seed, kw)
    if any(n in FIGURE_2 for n in wanted):
        calls = record(lambda: figure_2.posterior_non_linear_model(ctx, img_kept=0.5))
        for i, name in enumerate(FIGURE_2):
            if name in wanted:
                out[name] = calls[i]
    runs = os.path.join(HERE, "build", "rule_calibration")
    if TRAINING[0] in wanted:
        # one_batch calls the chain by the name train_mnist imported
        recorder = smoke.ChainRecorder(torch, train_mnist.mcpc_chain)
        train_mnist.mcpc_chain = recorder
        try:
            train_mnist.train_mcpc(1, os.path.join(runs, "mcpc_mse"), seed=smoke.SEED,
                                   batches_per_epoch=1, log=False, preset="mse", device=dev)
        finally:
            train_mnist.mcpc_chain = recorder.fn
        out[TRAINING[0]] = (*recorder.calls[0]["inputs"], recorder.calls[0]["kw"])
    if TRAINING[1] in wanted:
        out[TRAINING[1]] = record(lambda: train_mnist.train_pc(
            1, os.path.join(runs, "pc_mse"), seed=smoke.SEED, batches_per_epoch=1, log=False,
            preset="mse", device=dev))[0]
    return out


def runs_of(cases, chain, params, latents, target, seed, kw, rows, quiet, busy, probe):
    """{name: (correct order?, the run's output)}."""
    def plain(lat=latents, **over):
        return chain.mcpc_chain_reference(params, lat, target, seed, **dict(kw, **over))

    out = {"kernel": (True, chain.mcpc_chain(params, latents, target, seed, **kw))}
    for how in ("halves", "float64"):
        with cases.other_order(how):
            out[f"products in {how}"] = (True, plain())
    for draw in range(3):
        out[f"latents one ulp off, draw {draw}"] = (True, plain(cases.one_ulp_off(latents,
                                                                                  900 + draw)))
    out["lr * (1 + 1e-3)"] = (False, plain(lr=kw["lr"] * (1 + 1e-3),
                                           warm_lr=kw["warm_lr"] * (1 + 1e-3)))
    with cases.patched(chain, "_chain_args", cases.no_bias_correction):
        out["Adam's bias correction off"] = (False, plain())
    step = kw["warm_T"] // 2
    for label, row in (("quiet", quiet), ("busy", busy)):
        with cases.patched(chain, "activation_fn", cases.stale_row(rows, row, step)):
            out[f"row {row}'s update skipped at step {step} ({label} row)"] = (False, plain())
    if probe:
        with cases.split_products(chain):
            out["split-TF32 products"] = (True, plain())
    return out


def reach_part(smoke, part, got, ref, base, allow, witnesses) -> float:
    """The part-level bound's ratio: the unit furthest from float64 over the
    furthest unit of any correct order (the plain f32 version and the
    witnesses) plus the allowance."""
    far = [smoke.unit_distances(torch, part, ref, base)[0]] + [
        torch.nan_to_num(smoke.unit_distances(torch, part, w, base)[0], nan=0.0)
        for w in witnesses.of(part)]
    reach = max(float(d.max()) for d in far)
    return float(smoke.unit_distances(torch, part, got, base)[0].max()) / (reach + allow)


def clause(smoke, part, got, ref, base, allow, witnesses) -> str:
    """The old largest-element rule where every correct order keeps it:
    "kept" where the run keeps it, "FAILS" where it breaks it and the
    plain f32 version and every witness keep it, else "does not apply" (a
    NaN of a witness is an element it does not compute)."""
    limit = float(smoke.unit_distances(torch, part, ref, base)[1].max()) + allow
    if float(smoke.unit_distances(torch, part, got, base)[1].max()) <= limit:
        return "kept"
    kept = all(float(torch.nan_to_num(smoke.unit_distances(torch, part, w, base)[1],
                                      nan=0.0).max()) <= limit for w in witnesses.of(part))
    return "FAILS" if kept else "does not apply"


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    smoke = importlib.import_module("chip_smoke")
    cases = importlib.import_module("rule_cases")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--copies", type=int, nargs="+", default=[16, 32, 64])
    ap.add_argument("--fresh", type=int, default=16)
    ap.add_argument("--chains", nargs="+", default=list(CHAINS), choices=CHAINS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    counts = sorted(set(args.copies))
    found = {n: {"correct orders failing": [], "kernel failing": [], "faults passing": [],
                 "clause would fail": []} for n in counts}
    seconds = {}
    for name, (params, latents, target, seed, kw) in recorded_chains(
            smoke, port, chain, dev, args.chains).items():
        ref = chain.mcpc_chain_reference(params, latents, target, seed, **kw)
        ref64 = chain.mcpc_chain_reference(*smoke.to_double(params, latents, target), seed,
                                           **smoke.doubled(kw))
        rp, bp = smoke.option_parts(ref, kw), smoke.option_parts(ref64, kw)
        wits = {n: smoke.Witnesses(torch, chain, params, latents, target, seed, kw, copies=n,
                                   sum_copies=n // 2) for n in counts}
        # the rows where the fewest witnesses part least and most on the latents
        spread = torch.stack([smoke.unit_distances(torch, "latents", w, rp["latents"])[0]
                              for w in wits[counts[0]].of("latents")]).amax(0)
        rows = latents[0].shape[0]
        quiet, busy = int(spread.argmin()), int(spread.argmax())
        runs = {run: (sound, smoke.option_parts(out, kw)) for run, (sound, out) in runs_of(
            cases, chain, params, latents, target, seed, kw, rows, quiet, busy,
            name in FIGURE_2).items()}
        fresh = smoke.Witnesses(torch, chain, params, latents, target, seed, kw,
                                copies=args.fresh, sum_copies=args.fresh,
                                jitter_seed=smoke.SEED + 240)
        for j in range(args.fresh):
            parts = {}
            for part, _, _ in smoke.PART_RULES:
                if rp.get(part) is None:
                    continue
                one = fresh.of(part)[j]
                if part == "scalars":
                    # a captured step a witness does not compute: the plain version's
                    one = {k: torch.where(torch.isnan(v), rp[part][k].double(), v.double())
                           for k, v in one.items()}
                parts[part] = one
            runs[f"fresh witness {j}"] = (True, parts)
        for run, (sound, gp) in runs.items():
            failed = {n: False for n in counts}
            for part, allow, err in smoke.PART_RULES:
                if gp.get(part) is None:
                    continue
                a, b, c = ([x] for x in (gp[part], rp[part], bp[part])) if part in (
                    "traj", "traj3") else (gp[part], rp[part], bp[part])
                line = {"old_rule": "holds" if err(a, c) <= err(b, c) + allow else "FAILS"}
                for n in counts:
                    v = smoke.unit_rule(torch, part, gp[part], rp[part], bp[part], allow, wits[n])
                    one = {"ok": v["ok"], "beyond": v["beyond"]}
                    if v["witnessed"]:
                        one.update(
                            unflagged=v["unexcused"], flagged=v["sensitive"],
                            cap=int(v["sensitive"] * smoke.UNFLAGGED_SHARE),
                            rms_ratio=v["rms"] / v["rms_worst"],
                            clause=clause(smoke, part, gp[part], rp[part], bp[part], allow,
                                          wits[n]),
                            reach_part=reach_part(smoke, part, gp[part], rp[part], bp[part],
                                                  allow, wits[n]))
                        if v["ok"] and one["clause"] == "FAILS":
                            found[n]["clause would fail"].append(f"{name}: {run}: {part}")
                    line[n] = one
                    failed[n] |= not v["ok"]
                    where = f"{name}: {run}: {part}"
                    if sound and not v["ok"]:
                        found[n]["kernel failing" if run == "kernel" else
                                 "correct orders failing"].append(where)
                print(json.dumps({"chain": name, "run": run, "correct_order": sound,
                                  "part": part, **line}), flush=True)
            for n in counts:
                if not sound and not failed[n]:
                    found[n]["faults passing"].append(f"{name}: {run}")
        seconds[name] = {n: w.seconds for n, w in wits.items()}
    chosen = next((n for n in counts if not found[n]["correct orders failing"]), None)
    print(json.dumps({"by_count": found, "chosen": chosen, "witness seconds": seconds,
                      "card": smoke.card_line() if dev.type == "cuda" else "cpu"}))


if __name__ == "__main__":
    main()
