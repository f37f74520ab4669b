"""How ``chip_smoke.py``'s row rule tells correct f32 orders from faults on
the long Adam chains, where most rows part, on one GPU.

    python3 scripts/rule_calibration.py [--copies 8 32] [--chains NAME ...]

Chains, each at its full length on the smoke's own inputs: phase 5's
MSE-rec of ``pc_mse_1`` and of ``mcpc_mse_1`` (250 Adam steps at lr 0.7 on
the first test batch, B=1024), the joint sampler's warm start (250 Adam
steps at lr 0.7, x3 moved off its prediction, B=256), figure 2's two
probe MAP chains (2000 Adam steps at lr 0.1, B=1024) and its PC posterior
(2000 such steps, every one captured, B=16).  On each, runs of
the plain version stand in for the kernel (``scripts/rule_cases.py``):

- correct orders: the kernel itself; the products summed in two halves of
  k, or taken in float64 and rounded once; the latents started one ulp
  away (three draws of the directions); on figure 2's chains the
  split-TF32 products of ``tf32_split_matmul``, whose tensor-core kernel
  failed the smoke's old rule on the probe MAP chain;
- faults: lr (and warm lr) × (1 + 1e-3); Adam's bias correction off; one
  row's update skipped for one step halfway through, in the row where the
  witnesses part least and in the one where they part most.

For each chain, run and part it prints one JSON line: the units, how many
sit beyond the plain f32 version's distance from float64 plus the
allowance (``beyond``), and for the first 8, the smoke's
(``STACKED_COPIES``) and ``--copies`` stacked witness copies: how many
units they flag (``sensitive``), which ``beyond`` units they do not flag
(``unflagged``, ``unflagged_rows``) and how much further those sit than the
plain f32 version (``unflagged_excess``), how many flagged ones sit beyond
their own unit's envelope (the furthest correct order there) plus the
allowance and by how much at most (``over_own``, ``own_ratio``), the
largest distance of a flagged unit over the furthest any correct order
reaches on the part's flagged units (``reach_ratio``), and the part's RMS
distance from float64 over the worst correct order's (``rms_ratio``); then
the old largest-element rule's verdict and the smoke's row rule's
(``rule``, with its unexcused units and RMS ratio where its witnesses ran).
The last line gives, per chain, each run's largest RMS ratio under the
row rule.  Needs a CUDA device and nvcc (``--device cpu`` runs the plain
version in the kernel's place, to check the script).
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
          "probe MAP, batch 1", "probe MAP, batch 2", "PC posterior")
FIGURE_2 = CHAINS[3:]


class FirstCopies:
    """A ``Witnesses`` seen through its first ``k`` stacked copies."""

    def __init__(self, smoke, witnesses, k):
        self.smoke, self.w, self.k, self.seconds = smoke, witnesses, k, 0.0

    def of(self, part):
        runs = self.w.of(part)
        stacked = part in self.smoke.ROW_PARTS or (
            part == "scalars" and self.w.kw.get("capture_stride"))
        return runs[: self.k] if stacked else runs


def recorded_chains(smoke, port, chain, dev, wanted):
    """{name: (params, latents, target, seed, kw)} of the wanted chains, as
    the smoke records them."""
    from montecarlopredictivecoding_tpu_torch.data.mnist import get_mnist_data
    from montecarlopredictivecoding_tpu_torch.eval import metrics
    from montecarlopredictivecoding_tpu_torch.experiments import common, figure_2
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


def anatomy(smoke, part, got, ref, base, allow, witnesses, ks):
    """The numbers of one part's line (see the module's docstring)."""
    d_got, e_got = smoke.unit_distances(torch, part, got, base)
    d_ref, e_ref = smoke.unit_distances(torch, part, ref, base)
    beyond = d_got > d_ref + allow
    row = {"units": d_got.numel(), "beyond": int(beyond.sum())}
    if part not in smoke.ROW_PARTS:
        return row
    runs = witnesses.of(part)
    d_w = torch.stack([smoke.unit_distances(torch, part, w, base)[0] for w in runs])
    parted = torch.stack([smoke.unit_distances(torch, part, w, ref)[0] for w in runs])
    rms_w = [smoke._rms(torch, smoke.unit_distances(torch, part, w, base)[1]) for w in runs]
    excess = d_got - d_ref
    for k in ks:
        sens = torch.maximum(parted[:k].amax(0), d_ref) > allow
        env = torch.maximum(d_w[:k].amax(0), d_ref)
        flagged, unflagged = beyond & sens, beyond & ~sens
        ratio = d_got / (env + allow)
        reach = float(env[sens].max()) if bool(sens.any()) else 0.0
        row[f"copies_{k}"] = {
            "sensitive": int(sens.sum()), "unflagged": int(unflagged.sum()),
            "unflagged_rows": torch.nonzero(unflagged).flatten()[:4].tolist(),
            "unflagged_excess": float(excess[unflagged].max()) if bool(unflagged.any()) else 0.0,
            "over_own": int((flagged & (ratio > 1)).sum()),
            "own_ratio": float(ratio[flagged].max()) if bool(flagged.any()) else 0.0,
            "reach_ratio": float((d_got[flagged] / (reach + allow)).max())
            if bool(flagged.any()) else 0.0,
            "rms_ratio": smoke._rms(torch, e_got) / max([smoke._rms(torch, e_ref)] + rms_w[:k])}
    return row


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    smoke = importlib.import_module("chip_smoke")
    cases = importlib.import_module("rule_cases")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--copies", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--chains", nargs="+", default=list(CHAINS), choices=CHAINS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    ks = sorted({smoke.STACKED_COPIES, *args.copies})
    summary = {}
    for name, (params, latents, target, seed, kw) in recorded_chains(
            smoke, port, chain, dev, args.chains).items():
        ref = chain.mcpc_chain_reference(params, latents, target, seed, **kw)
        ref64 = chain.mcpc_chain_reference(*smoke.to_double(params, latents, target), seed,
                                           **smoke.doubled(kw))
        rp, bp = smoke.option_parts(ref, kw), smoke.option_parts(ref64, kw)
        wit = smoke.Witnesses(torch, chain, params, latents, target, seed, kw,
                              copies=max(ks))
        held = FirstCopies(smoke, wit, smoke.STACKED_COPIES)  # the smoke's witnesses
        # the rows where the witnesses part least and most on the latents
        spread = torch.stack([smoke.unit_distances(torch, "latents", w, rp["latents"])[0]
                              for w in held.of("latents")]).amax(0)
        rows = latents[0].shape[0]
        quiet, busy = int(spread.argmin()), int(spread.argmax())
        worst = {}
        for run, (sound, out) in runs_of(cases, chain, params, latents, target, seed, kw, rows,
                                         quiet, busy, name in FIGURE_2).items():
            gp = smoke.option_parts(out, kw)
            for part, allow, err in smoke.PART_RULES:
                if gp.get(part) is None:
                    continue
                line = anatomy(smoke, part, gp[part], rp[part], bp[part], allow, wit, ks)
                a, b, c = ([x] for x in (gp[part], rp[part], bp[part])) if part in (
                    "traj", "traj3") else (gp[part], rp[part], bp[part])
                line["old_rule"] = "holds" if err(a, c) <= err(b, c) + allow else "FAILS"
                verdict = smoke.unit_rule(torch, part, gp[part], rp[part], bp[part], allow, held)
                line["rule"] = "holds" if verdict["ok"] else "FAILS"
                if verdict["witnessed"]:
                    line["rule_unexcused"] = verdict["unexcused"]
                    line["rule_rms_ratio"] = verdict["rms"] / verdict["rms_worst"]
                    worst[run] = max(worst.get(run, 0.0), line["rule_rms_ratio"])
                print(json.dumps({"chain": name, "run": run, "correct_order": sound,
                                  "part": part, **line}), flush=True)
        summary[name] = {"rule_rms_ratio": worst, "witness seconds": wit.seconds}
    print(json.dumps({"summary": summary,
                      "card": smoke.card_line() if dev.type == "cuda" else "cpu"}))


if __name__ == "__main__":
    main()
