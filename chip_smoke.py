"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phase 0  prints the card and its power limit, turns TF32 off (so every f32
         matrix product of the plain versions is full f32) and builds every
         CUDA kernel of the port from the sources in this checkout.
Phase 1  holds each kernel against its plain PyTorch version on the card, on
         the same CUDA inputs (run in f32 and in float64), at the shapes the
         serving path gives it.
Phase 2  drives the serving path at full width through the entry points a
         user calls: ``get_model`` -> ``get_mnist_data`` -> ``init_latents``
         -> ``mcpc_chain``, for (a) the bench chain (B=256, T=10000,
         lr 0.01, noise variance 2) and (b) the figure-2 inference chain
         (2000 Adam MAP steps at lr 0.1, then T=10000 at lr 0.03).  The launch
         counts are zeroed just before and read just after; then (a) is held
         against the plain version and both chains are timed with CUDA
         events (median of 3 after one warm-up).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
either is printed.  There is no CPU fallback: without a CUDA device the
script exits non-zero.
"""

from __future__ import annotations

import importlib
import json
import os
import statistics
import subprocess
import sys
import time

# published H100 SXM peaks at 700 W (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3 bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# the MCPC 'fid' model: 20-128-128-784, relu, Bernoulli sensory loss
# (experiments/train_mnist.py::mcpc_training_config of the JAX package)
MODEL_CONFIG = {
    "input_size": 20, "hidden_size": 128, "hidden2_size": 128,
    "output_size": 784, "activation_fn": "relu", "loss_fn": "bernoulli",
    "batch_size_train": 256, "batch_size_val": 256, "batch_size_test": 256,
}
BATCH = 256
SEED = 1234
CHAIN_A = dict(T=10000, lr=0.01, noise_var=2.0, loss="bernoulli")
CHAIN_B = dict(T=10000, lr=0.03, noise_var=2.0, loss="bernoulli",
               warm_T=2000, warm_lr=0.1)

# Tolerances.  Phase 1 holds the kernel against the plain version run in
# float64 on the same inputs: the kernel may sit at most P1_ATOL (latents) /
# P1_RTOL (scalars) further from it than the plain f32 version does.  An
# Adam warm start leaves the chain ill-conditioned in f32, so the plain f32
# version itself can sit 3e-4 (Bernoulli, 50 + 201 steps) to 5e-3
# (Gaussian, 50 + 21 steps) from float64 (PERF.md).
# Phase 2 holds chain (a), 10000 steps of f32 arithmetic summed in another
# order, against the plain f32 version.
P1_ATOL, P1_RTOL = 1e-4, 1e-5
P2_ATOL, P2_RTOL = 2e-3, 1e-4


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 3):
    """(median ms over ``reps`` runs after one warm-up, last output)."""
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


def chain_bound_ms(dims, B: int, steps: int) -> float:
    """Least time an H100 could take: the larger of the matrix-product FLOPs
    over the f32 peak and the bytes read and written once over HBM's rate."""
    d0, d1, d2, D = dims
    macs = d0 * d1 + d1 * d2 + d2 * D
    flops = 2 * 2 * B * macs * steps  # forward and backward products
    n = d0 + d1 + d2
    params = d0 + d0 * d1 + d1 + d1 * d2 + d2 + d2 * D + D
    nbytes = 4 * (params + 2 * B * n + B * D)
    return 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def max_abs(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def scalar_rel(sa, sb) -> float:
    return max(
        float(((sa[k] - sb[k]).abs() / sb[k].abs().clamp_min(1e-30)).max())
        for k in ("loss", "energy")
    )


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    from montecarlopredictivecoding_tpu_torch.data import get_mnist_data
    from montecarlopredictivecoding_tpu_torch.models import get_model
    from montecarlopredictivecoding_tpu_torch.ops import _build

    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    dev = torch.device("cuda")

    # ---------------------------------------------------------- phase 0
    card = card_line()
    print(card)
    tag = f"[{card}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t0 = time.perf_counter()
    lib_path = _build.build("mcpc_chain")
    print(f"phase 0: built {os.path.relpath(lib_path, here)} in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in open(str(lib_path) + ".log"):
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    # ---------------------------------------------------------- phase 1
    gen = torch.Generator().manual_seed(SEED)

    def random_case(dims, B):
        model = port.make_mlp_model(*dims)
        params = model.init(gen, device=dev)
        latents = model.init_latents(params, torch.zeros(B, dims[0], device=dev), gen)
        target = (torch.rand(B, dims[3], generator=gen) > 0.5).float().to(dev)
        return params, latents, target

    fid, mse = (20, 128, 128, 784), (10, 256, 256, 784)
    warm = dict(warm_T=50, warm_lr=0.1, lr=0.03, return_scalars=True)
    cases = [
        ("fid bernoulli warm50+T201", fid, dict(warm, T=201, loss="bernoulli")),
        ("fid gaussian warm50+T21", fid, dict(warm, T=21, loss="gaussian", input_var=0.5)),
        ("fid none warm50+T21", fid, dict(warm, T=21, loss="none")),
        ("mse bernoulli warm10+T51", mse, dict(warm, warm_T=10, T=51, loss="bernoulli")),
        ("fid bernoulli batch_tile=128", fid, dict(warm, T=21, loss="bernoulli", batch_tile=128)),
    ]
    for name, dims, kw in cases:
        params, latents, target = random_case(dims, BATCH)
        if kw["loss"] == "gaussian":
            target = 2.0 * target - 1.0
        got = chain.mcpc_chain(params, latents, target, SEED, **kw)
        torch.cuda.synchronize()
        ref = chain.mcpc_chain_reference(params, latents, target, SEED, **kw)
        # the plain version in float64 on the same inputs: the exact answer
        # both f32 versions are measured against
        ref64 = chain.mcpc_chain_reference(
            tuple({k: v.double() for k, v in p.items()} for p in params),
            tuple(x.double() for x in latents), target.double(), SEED, **kw)
        dx, rel = max_abs(got[0], ref[0]), scalar_rel(got[2], ref[2])
        dx64, rel64 = max_abs(got[0], ref64[0]), scalar_rel(got[2], ref64[2])
        p_dx64, p_rel64 = max_abs(ref[0], ref64[0]), scalar_rel(ref[2], ref64[2])
        rows = chain.kernel_rows(dims, kw["warm_T"] > 0, dev)
        print(f"phase 1: {name}: B={BATCH} rows/block={rows} max|dx| kernel-plain "
              f"{dx:.3e}, kernel-plain64 {dx64:.3e}, plain-plain64 {p_dx64:.3e} "
              f"(atol {P1_ATOL}); scalars max rel kernel-plain {rel:.3e}, "
              f"kernel-plain64 {rel64:.3e}, plain-plain64 {p_rel64:.3e} "
              f"(rtol {P1_RTOL})")
        check(dx64 <= p_dx64 + P1_ATOL,
              f"phase 1 {name}: latents {dx64} from float64, plain f32 {p_dx64}")
        check(rel64 <= p_rel64 + P1_RTOL,
              f"phase 1 {name}: scalars {rel64} from float64, plain f32 {p_rel64}")

    # ---------------------------------------------------------- phase 2
    gen_model = get_model(MODEL_CONFIG, SEED, device=dev)
    params = gen_model.params
    _, _, test = get_mnist_data(MODEL_CONFIG, device=dev)
    data, _ = next(iter(test))
    check(tuple(data.shape) == (BATCH, 784), f"data batch is {tuple(data.shape)}")
    check(bool(((data == 0) | (data == 1)).all()), "data batch is not binarized")
    pseudo = torch.zeros(BATCH, MODEL_CONFIG["input_size"], device=dev)
    latents = gen_model.model.init_latents(params, pseudo,
                                           torch.Generator().manual_seed(SEED + 1))
    energy0 = float(sum(gen_model.model.apply(params, latents, pseudo).energies))

    def run_a():
        return chain.mcpc_chain(params, latents, data, SEED,
                                return_scalars=True, **CHAIN_A)

    def run_b():
        return chain.mcpc_chain(params, latents, data, SEED,
                                return_scalars=True, **CHAIN_B)

    chain.mcpc_chain.launches = 0
    out_a, out_b = run_a(), run_b()
    torch.cuda.synchronize()
    launches = chain.mcpc_chain.launches
    print(f"phase 2: main path launches of mcpc_chain: {launches}")
    check(launches >= 2, "the main path did not launch the mcpc_chain kernel")
    for name, out in (("a", out_a), ("b", out_b)):
        lat, pgrads, scal = out
        check(pgrads is None, "pgrads returned without with_pgrads")
        check([tuple(x.shape) for x in lat] == [(BATCH, 20), (BATCH, 128), (BATCH, 128)],
              f"chain ({name}) latents have the wrong shapes")
        check(all(bool(torch.isfinite(x).all()) for x in lat), f"chain ({name}) not finite")
        e = float(scal["energy"])
        print(f"phase 2: chain ({name}) energy {energy0:.1f} -> {e:.1f}, "
              f"Bernoulli loss {float(scal['loss']):.1f}")
        check(e < energy0, f"chain ({name}) did not lower the energy")

    a_ms, _ = cuda_ms(torch, run_a)
    b_ms, _ = cuda_ms(torch, run_b)

    def plain_a():
        return chain.mcpc_chain_reference(params, latents, data, SEED,
                                          return_scalars=True, **CHAIN_A)

    def plain_b():
        return chain.mcpc_chain_reference(params, latents, data, SEED,
                                          return_scalars=True, **CHAIN_B)

    pa_ms, ref_a = cuda_ms(torch, plain_a)
    pb_ms, _ = cuda_ms(torch, plain_b)
    dx, rel = max_abs(out_a[0], ref_a[0]), scalar_rel(out_a[2], ref_a[2])
    print(f"phase 2: chain (a) kernel vs plain: max|dx|={dx:.3e} (atol {P2_ATOL}), "
          f"scalars max rel={rel:.3e} (rtol {P2_RTOL})")
    check(dx <= P2_ATOL, f"phase 2: chain (a) latents differ by {dx}")
    check(rel <= P2_RTOL, f"phase 2: chain (a) scalars differ by {rel}")

    dims = fid
    bound_a = chain_bound_ms(dims, BATCH, CHAIN_A["T"])
    bound_b = chain_bound_ms(dims, BATCH, CHAIN_B["T"] + CHAIN_B["warm_T"])
    for name, ms, pms, bound, steps in (
        ("a", a_ms, pa_ms, bound_a, CHAIN_A["T"]),
        ("b", b_ms, pb_ms, bound_b, CHAIN_B["T"] + CHAIN_B["warm_T"]),
    ):
        print(f"phase 2: chain ({name}) B={BATCH} steps={steps}: kernel "
              f"{ms:.3f} ms/chain, {1e3 * ms / steps:.3f} us/step, "
              f"{steps / (ms / 1e3):.1f} steps/s; plain {pms:.3f} ms/chain; "
              f"bound {bound:.3f} ms (operations) {tag}")
    print("phase 2: library_ms null: no single PyTorch call computes a "
          "whole Langevin chain")

    rows = chain.kernel_rows(dims, False, dev)
    print(json.dumps({"kernels": [{
        "name": "mcpc_chain",
        "route": "cuda",
        "source": "montecarlopredictivecoding_tpu_torch/ops/csrc/mcpc_chain.cu",
        "replaces": "montecarlopredictivecoding_tpu/ops/pallas_mcpc.py:426",
        "launches": launches,
        "max_abs_err": dx,
        "ms": a_ms,
        "plain_ms": pa_ms,
        "bound_ms": bound_a,
        "bound_by": "operations",
        "library_ms": None,
    }]}))
    print(f"chain (a): rows/block={rows}, blocks={-(-BATCH // rows)} {tag}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        code = 1
    sys.exit(code)
