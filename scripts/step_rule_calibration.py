"""Correct f32 orders and faults held by the step rule (``step_rule.py``) on
the eight long chains that ``scripts/rule_calibration.py`` calibrated the
row rule on, on one GPU.

    python3 scripts/step_rule_calibration.py [--chains NAME ...] [--witnesses 4]

The chains are ``rule_calibration.py``'s, recorded as the smoke records
them at their full length: MSE-rec of ``pc_mse_1`` and ``mcpc_mse_1``, the
joint sampler's warm start (x3 at its prediction, as the sampler runs it),
figure 2's two probe MAP chains and its PC posterior, and the first batch
of each trainer's mse preset.  On each, every run is held by
``step_rule.check`` from its own captured states:

- correct orders: the kernel; the plain f32 version on the card; its
  products summed in two halves of k, or taken in float64 and rounded
  once; ``--witnesses`` of the row rule's witnesses (products summed in
  reverse, the latents moved by up to an ulp a step, keyed moves of
  other seeds); the plain version from latents one ulp off (three draws);
  on figure 2's chains the split-TF32 products of ``tf32_split_matmul``,
  held with their own unit roundoff (3 * 2^-22, the split's error of a
  product);
- faults: lr (and warm lr) x (1 + 1e-3); Adam's bias correction off; one
  row's update skipped for one step at the first phase's middle, made by
  the plain version (``rule_cases.stale_row``) and injected into the
  kernel's captures (``step_rule.skip_row``), in the row where the kernel
  ends nearest to the plain f32 version (quiet) and the one furthest from
  it (busy); on the chains with gradient sums, the smoke's two faults of
  the gradient sums alone (``GRAD_FAULTS``) injected into the kernel's
  output (``step_rule.grads_changed``); on the MCPC mse batch, the smoke's
  four faults through the kernel's arguments (``ARG_FAULTS``).

A run with gradient sums is held besides as the smoke holds it
(``chip_smoke.grad_hold``): each gradient tensor within ``P1_GRAD_REL`` of
its largest entry from the float64 sums over the run's own states.  A
correct order fails if it fails either; a fault passes if it passes both.
Each run prints one JSON line (its verdict, each part's largest ratio to
the bound, its gradients' distance); the last line counts the correct
orders that fail, the faults that pass, each fault's smallest ratio (its
largest part's, the least over the chains), each run kind's largest ratio
and largest gradient distance, the
``sincos_2pi`` errors used, the seconds and the card.  Needs a CUDA device
and nvcc (``--device cpu`` runs the plain version in the kernel's place,
to check the script).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT_TF32_U = 3 * 2.0 ** -22


def main() -> None:
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    smoke = importlib.import_module("chip_smoke")
    cases = importlib.import_module("rule_cases")
    calibration = importlib.import_module("rule_calibration")
    sr = importlib.import_module("step_rule")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chains", nargs="+", default=list(calibration.CHAINS),
                    choices=calibration.CHAINS)
    ap.add_argument("--witnesses", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    t_start = time.perf_counter()
    plain_err = sr.sincos_error(chain.sincos_2pi, dev)
    if dev.type == "cuda":
        probe = importlib.import_module(
            "montecarlopredictivecoding_tpu_torch.benchmarks.vpu_op_bench")
        kernel_err = sr.sincos_error(probe.device_sincos_2pi, dev)
    else:
        kernel_err = plain_err
    plain = chain.mcpc_chain_reference
    found = {"correct orders failing": [], "faults passing": []}
    largest, smallest_fault, grad_far = {}, {}, {}

    def hold(name, run_name, run, inputs, kw, correct, err, u=sr.U32, cap=None, kind=None):
        t0 = time.perf_counter()
        if cap is None:
            cap = sr.capture(run, inputs, kw)
        v = sr.hold(cap, inputs, kw, sincos_err=err, u=u)
        far = sr.grad_distance(v, cap.held["pgrads"])[0]
        ok = v["ok"] and not smoke.grad_hold(name, v, cap.held["pgrads"])[1]
        worst = max(p["ratio"] for p in v["parts"].values())
        kind = kind or run_name.split(",")[0]
        if v["grads64"] is not None:
            grad_far[kind] = max(grad_far.get(kind, 0.0), far)
        if correct:
            largest[kind] = max(largest.get(kind, 0.0), worst)
            if not ok:
                found["correct orders failing"].append(f"{name}: {run_name}")
        else:
            smallest_fault[kind] = min(smallest_fault.get(kind, float("inf")), worst)
            if ok:
                found["faults passing"].append(f"{name}: {run_name}")
        print(json.dumps({"chain": name, "run": run_name, "correct_order": correct,
                          "ok": ok, "step_rule_ok": v["ok"], "bits": v["bits"],
                          "parts": {k: {"ratio": p["ratio"], "at": p["at"]}
                                    for k, p in v["parts"].items()},
                          "gradient_distance": far if v["grads64"] is not None else None,
                          "seconds": time.perf_counter() - t0}), flush=True)
        return v

    def patched(name, fn):
        def run(*a, **kw):
            with cases.patched(chain, name, fn):
                return plain(*a, **kw)
        return run

    def ordered(how):
        def run(*a, **kw):
            with cases.other_order(how):
                return plain(*a, **kw)
        return run

    def split(*a, **kw):
        with cases.split_products(chain):
            return plain(*a, **kw)

    recorded = calibration.recorded_chains(smoke, port, chain, dev, args.chains)
    for name, (params, latents, target, seed, kw) in recorded.items():
        inputs = (params, latents, target, seed)
        rows = latents[0].shape[0]
        kernel = chain.mcpc_chain if dev.type == "cuda" else plain
        cap = sr.capture(kernel, inputs, kw)
        hold(name, "kernel", None, inputs, kw, True, kernel_err, cap=cap)
        _, dist, _ = smoke.plain_distance(torch, chain, cap, inputs, kw)
        quiet, busy = int(dist.argmin()), int(dist.argmax())
        hold(name, "plain f32", plain, inputs, kw, True, plain_err)
        for how in ("halves", "float64"):
            hold(name, f"products in {how}", ordered(how), inputs, kw, True, plain_err)
        for j in range(args.witnesses):
            def witness(*a, j=j, **k):
                with smoke.jittered_rounding(torch, chain, rows, smoke.SEED + 240 + j, params,
                                             keyed=True):
                    return plain(*a, **k)
            hold(name, f"witness, seed {j}", witness, inputs, kw, True, plain_err)
        for draw in range(3):
            off = cases.one_ulp_off(latents, 900 + draw)
            hold(name, f"latents one ulp off, draw {draw}", plain, (params, off, target, seed),
                 kw, True, plain_err)
        if name in calibration.FIGURE_2:
            hold(name, "split-TF32 products", split, inputs, kw, True, plain_err,
                 u=SPLIT_TF32_U)
        hold(name, "lr * (1 + 1e-3)", lambda *a, **k: plain(*a, **dict(
            k, lr=k["lr"] * (1 + 1e-3), warm_lr=k.get("warm_lr", 0.1) * (1 + 1e-3))), inputs,
            kw, False, plain_err)
        hold(name, "Adam's bias correction off", patched("_chain_args", cases.no_bias_correction),
             inputs, kw, False, plain_err)
        step = cap.phases[0].steps // 2
        for label, row in (("quiet", quiet), ("busy", busy)):
            stale = cases.stale_run(plain, chain, rows, row, step, kw.get("warm_T", 0))
            made = f"one row skipped ({label}), made by the plain version"
            hold(name, f"{made}, row {row}", stale, inputs, kw, False, plain_err, kind=made)
            injected = f"one row skipped ({label}), injected into the kernel's captures"
            hold(name, f"{injected}, row {row}", None, inputs, kw, False, kernel_err,
                 cap=sr.skip_row(cap, 0, step, row), kind=injected)
        if kw.get("with_pgrads"):
            for fault, change in smoke.GRAD_FAULTS:
                hold(name, f"{fault}, injected into the kernel's output", None, inputs, kw,
                     False, kernel_err, cap=sr.grads_changed(cap, change), kind=fault)
        if name == calibration.TRAINING[0]:
            for fault, change in smoke.ARG_FAULTS:
                def faulty(p, lat, t, s, change=change, **k):
                    k, s = change(k, s)
                    return kernel(p, lat, t, s, **k)
                hold(name, f"{fault} (through the kernel's arguments)", faulty, inputs, kw,
                     False, kernel_err)
        del cap
    print(json.dumps({**found, "largest ratio by correct order": largest,
                      "smallest ratio by fault": smallest_fault,
                      "largest gradient distance by run": grad_far,
                      "sincos_2pi error": {"kernel": kernel_err, "plain": plain_err},
                      "seconds": time.perf_counter() - t_start,
                      "card": smoke.card_line() if dev.type == "cuda" else "cpu"}))


if __name__ == "__main__":
    main()
