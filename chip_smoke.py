"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phase 0  prints the card and its power limit, turns TF32 off (so every f32
         matrix product of the plain versions is full f32) and builds every
         CUDA kernel of the port from the sources in this checkout, one
         ``nvcc`` per source, all started together.
Phase 1  holds each kernel against its plain PyTorch version on the card, on
         the same CUDA inputs (run in f32 and in float64), at the shapes the
         main paths give it: the chain with and without parameter gradients
         (``with_pgrads``, ``warm_pgrads``, batches that leave pad rows in
         the last cluster or fill only part of one, both widths, both
         losses), the unpacked baseline (``packed=False``), and the pass
         that sums the partial gradients (timed paced by the host, one call
         between two events, which is what the ``kernels`` line reports as
         ``ms``, and on the device alone, behind a spinning kernel:
         ``device_ms``).  Each line prints the
         packed kernel's plan: cluster size, rows a cluster, clusters, SMs
         at work, shared memory a block, gradient slice resident or not.
Phase 2  drives the serving path at full width through the entry points a
         user calls: ``get_model`` -> ``get_mnist_data`` -> ``init_latents``
         -> ``mcpc_chain``, for (a) the bench chain (B=256, T=10000,
         lr 0.01, noise variance 2), (b) the figure-2 inference chain
         (2000 Adam MAP steps at lr 0.1, then T=10000 at lr 0.03) and (c)
         the unpacked baseline on the bench chain's inputs (T=1000).  The
         launch counts are zeroed just before and read just after; then (a)
         and (c) are held against the plain version and the chains are timed
         with CUDA events (kernel: median of 3 after one warm-up; plain
         version: once).
Phase 3  drives the training path at full width: ``get_model`` ->
         ``get_mnist_data`` (train split, B=256) -> ``one_batch`` for
         TRAIN_BATCHES batches (250 Adam MAP steps at lr 0.7, 50 + 100
         Langevin steps at lr 0.1, Adam on the parameters at lr 0.01) ->
         ``save_checkpoint`` -> ``load_checkpoint``, with the same inference
         chain on one fixed test batch before and after.  The launch counts
         are zeroed just before and read just after.  It checks one chain
         launch and one summing pass per batch, finite and changed
         parameters, a reloaded checkpoint equal bit for bit, the first
         batch's gradients and updated parameters against the plain version,
         bit-identical gradients from two runs, and that the test batch's
         Bernoulli loss fell.  It prints ms per batch (CUDA events, median),
         images/s, the bound and the split by switching parts off.  (The
         split inside the kernel, by its own clocks, is
         ``scripts/chain_clocks.py``.)

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
FID, MSE = (20, 128, 128, 784), (10, 256, 256, 784)
CHAIN_A = dict(T=10000, lr=0.01, noise_var=2.0, loss="bernoulli")
CHAIN_B = dict(T=10000, lr=0.03, noise_var=2.0, loss="bernoulli",
               warm_T=2000, warm_lr=0.1)
CHAIN_C = dict(T=1000, lr=0.01, noise_var=2.0, loss="bernoulli", packed=False)
TRAIN_BATCHES = 40

# Tolerances.  Phase 1 holds a kernel against the plain version run in
# float64 on the same inputs: the kernel may sit at most P1_ATOL (latents) /
# P1_RTOL (scalars) / P1_GRAD_REL (each gradient tensor, relative to its
# largest entry) further from it than the plain f32 version does.  An Adam
# warm start leaves the chain ill-conditioned in f32, so the plain f32
# version itself can sit 3e-4 (Bernoulli, 50 + 201 steps) to 5e-3 (Gaussian,
# 50 + 21 steps) from float64 (PERF.md).  A gradient is a sum over 256 rows
# and tens of steps of products of such latents, taken in another order
# than cuBLAS takes it: its allowance is the latents' 1e-4 on values of
# about 10, i.e. 1e-5, doubled for the f32 sum itself.
# Phase 2 holds chains (a) and (c), thousands of steps of f32 arithmetic
# summed in another order, against the plain f32 version.
# Phase 3 holds the first training batch (400 steps, Adam at lr 0.7) like
# phase 1, and its updated parameters on the entries whose gradient is at
# least P3_CLEAR of the tensor's largest: Adam's first step is lr*sign(g),
# so an entry whose gradient is only rounding noise may differ by 2*lr.
P1_ATOL, P1_RTOL, P1_GRAD_REL = 1e-4, 1e-5, 2e-5
P2_ATOL, P2_RTOL = 2e-3, 1e-4
P3_CLEAR, P3_PARAM_ATOL = 1e-3, 1e-6


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


def cuda_ms(torch, fn, reps: int = 3, warm_up: bool = True):
    """(median ms over ``reps`` runs, after one warm-up unless told
    otherwise; the last output)."""
    out = fn() if warm_up else None
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


def queued_ms(torch, fn, reps: int = 20):
    """(median device ms of ``fn`` over ``reps`` calls; the last output).  The
    calls are enqueued behind a kernel that spins for some 25 ms, so each
    pair of events brackets the work on the device and not the host's time to
    launch it, which for a pass of a few microseconds is most of a
    host-paced timing."""
    out = fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in pairs:
        start.record()
        out = fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs), out


def step_flops(dims, B: int) -> int:
    """Matrix-product FLOPs of one chain step: forward and backward."""
    d0, d1, d2, D = dims
    return 2 * 2 * B * (d0 * d1 + d1 * d2 + d2 * D)


def chain_bound_ms(dims, B: int, steps: int, sampling: int = 0) -> float:
    """Least time an H100 could take: the larger of the matrix-product FLOPs
    over the f32 peak (a sampling step adds the Hebbian products, half a
    step's worth) and the bytes read and written once over HBM's rate."""
    d0, d1, d2, D = dims
    flops = step_flops(dims, B) * steps + step_flops(dims, B) // 2 * sampling
    n = d0 + d1 + d2
    params = d0 + d0 * d1 + d1 + d1 * d2 + d2 + d2 * D + D
    nbytes = 4 * (params + 2 * B * n + B * D + (params if sampling else 0))
    return 1e3 * max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def max_abs(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def scalar_rel(sa, sb) -> float:
    return max(
        float(((sa[k] - sb[k]).abs() / sb[k].abs().clamp_min(1e-30)).max())
        for k in ("loss", "energy")
    )


def grad_rel(ga, gb) -> float:
    """Largest difference of any gradient tensor, relative to the largest
    entry of that tensor in ``gb``."""
    return max(
        float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30))
        for a, b in zip(ga, gb) for k in ("w", "b")
    )


def to_double(params, latents, target):
    return (tuple({k: v.double() for k, v in p.items()} for p in params),
            tuple(x.double() for x in latents), target.double())


def grads_equal(torch, ga, gb) -> bool:
    return all(torch.equal(a[k], b[k]) for a, b in zip(ga, gb) for k in ("w", "b"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    from montecarlopredictivecoding_tpu_torch.core.optim import adam_init, adam_step
    from montecarlopredictivecoding_tpu_torch.data import get_mnist_data
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
    from montecarlopredictivecoding_tpu_torch.models import get_model
    from montecarlopredictivecoding_tpu_torch.ops import _build
    from montecarlopredictivecoding_tpu_torch.utils import load_checkpoint, save_checkpoint

    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    dev = torch.device("cuda")

    def zero_counts():
        chain.mcpc_chain.launches = 0
        chain.mcpc_chain.launches_unpacked = 0
        chain.sum_block_partials.launches = 0

    def read_counts():
        return (chain.mcpc_chain.launches, chain.mcpc_chain.launches_unpacked,
                chain.sum_block_partials.launches)

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
    sources = ["mcpc_chain", "mcpc_chain_unpacked"]
    lib_paths = _build.build_all(sources)
    print(f"phase 0: built {', '.join(os.path.relpath(p, here) for p in lib_paths)} "
          f"in {time.perf_counter() - t0:.1f} s")
    for name, lib_path in zip(sources, lib_paths):
        with open(str(lib_path) + ".log") as log:
            for line in log:
                # "Compiling entry function" names the kernel and, as its
                # template argument, the rows per block
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    print(f"  ptxas {name}:", line.strip())

    # ---------------------------------------------------------- phase 1
    gen = torch.Generator().manual_seed(SEED)

    def random_case(dims, B):
        model = port.make_mlp_model(*dims)
        params = model.init(gen, device=dev)
        latents = model.init_latents(params, torch.zeros(B, dims[0], device=dev), gen)
        target = (torch.rand(B, dims[3], generator=gen) > 0.5).float().to(dev)
        return params, latents, target

    def chain_plan(dims, B, kw):
        return chain.chain_plan(dims, B, warm=kw.get("warm_T", 0) > 0,
                                with_pgrads=kw.get("with_pgrads", False),
                                budget=chain.smem_budget(dev),
                                max_clusters=chain.max_active_clusters(dev))

    def plan_text(dims, B, kw):
        plan = chain_plan(dims, B, kw)
        return plan.describe(chain.max_active_clusters(dev, plan))

    warm = dict(warm_T=50, warm_lr=0.1, lr=0.03, return_scalars=True)
    pg = dict(warm, T=60, mixing=20, with_pgrads=True)
    cases = [
        ("fid bernoulli warm50+T201", FID, BATCH, dict(warm, T=201, loss="bernoulli")),
        ("fid gaussian warm50+T21", FID, BATCH,
         dict(warm, T=21, loss="gaussian", input_var=0.5)),
        ("fid none warm50+T21", FID, BATCH, dict(warm, T=21, loss="none")),
        ("mse bernoulli warm10+T51", MSE, BATCH,
         dict(warm, warm_T=10, T=51, loss="bernoulli")),
        ("fid bernoulli batch_tile=128", FID, BATCH,
         dict(warm, T=21, loss="bernoulli", batch_tile=128)),
        ("fid bernoulli warm50+T60 mixing20 pgrads", FID, BATCH, dict(pg)),
        ("fid bernoulli pgrads B=250 (pad rows)", FID, 250, dict(pg)),
        ("fid bernoulli pgrads B=8", FID, 8, dict(pg)),
        ("fid bernoulli pgrads B=1 (one cluster, one pad row)", FID, 1, dict(pg)),
        ("mse bernoulli warm50+T60 mixing20 pgrads", MSE, BATCH, dict(pg)),
        ("fid bernoulli warm50 T=0 warm_pgrads", FID, BATCH,
         dict(warm, T=0, with_pgrads=True, warm_pgrads=True)),
        ("fid gaussian warm50+T60 mixing20 pgrads", FID, BATCH,
         dict(pg, loss="gaussian", input_var=0.5)),
        ("fid bernoulli unpacked T60 mixing20 pgrads", FID, BATCH,
         dict(T=60, lr=0.03, mixing=20, with_pgrads=True, packed=False)),
    ]
    for name, dims, B, kw in cases:
        params, latents, target = random_case(dims, B)
        if kw.get("loss") == "gaussian":
            target = 2.0 * target - 1.0
        got = chain.mcpc_chain(params, latents, target, SEED, **kw)
        torch.cuda.synchronize()
        ref = chain.mcpc_chain_reference(params, latents, target, SEED, **kw)
        # the plain version in float64 on the same inputs: the exact answer
        # both f32 versions are measured against
        ref64 = chain.mcpc_chain_reference(*to_double(params, latents, target),
                                           SEED, **kw)
        mapping = (plan_text(dims, B, kw) if kw.get("packed", True)
                   else f"rows/block={chain.unpacked_rows(dims, dev)}")
        dx, dx64, p_dx64 = (max_abs(got[0], ref[0]), max_abs(got[0], ref64[0]),
                            max_abs(ref[0], ref64[0]))
        line = (f"phase 1: {name}: B={B} [{mapping}] max|dx| kernel-plain "
                f"{dx:.3e}, kernel-plain64 {dx64:.3e}, plain-plain64 {p_dx64:.3e} "
                f"(atol {P1_ATOL})")
        check(dx64 <= p_dx64 + P1_ATOL,
              f"phase 1 {name}: latents {dx64} from float64, plain f32 {p_dx64}")
        if kw.get("return_scalars"):
            rel, rel64, p_rel64 = (scalar_rel(got[2], ref[2]), scalar_rel(got[2], ref64[2]),
                                   scalar_rel(ref[2], ref64[2]))
            line += (f"; scalars max rel kernel-plain {rel:.3e}, kernel-plain64 "
                     f"{rel64:.3e}, plain-plain64 {p_rel64:.3e} (rtol {P1_RTOL})")
            check(rel64 <= p_rel64 + P1_RTOL,
                  f"phase 1 {name}: scalars {rel64} from float64, plain f32 {p_rel64}")
        if kw.get("with_pgrads"):
            g, g64, p_g64 = (grad_rel(got[1], ref[1]), grad_rel(got[1], ref64[1]),
                             grad_rel(ref[1], ref64[1]))
            line += (f"; gradients max rel to the tensor's largest entry kernel-plain "
                     f"{g:.3e}, kernel-plain64 {g64:.3e}, plain-plain64 {p_g64:.3e} "
                     f"(allowance {P1_GRAD_REL})")
            check(g64 <= p_g64 + P1_GRAD_REL,
                  f"phase 1 {name}: gradients {g64} from float64, plain f32 {p_g64}")
            check(not bool(got[1][0]["w"].any()), f"phase 1 {name}: gW0 is not zero")
        else:
            check(got[1] is None, f"phase 1 {name}: pgrads without with_pgrads")
        print(line)

    # the summing pass at the training path's shape: one partial a cluster
    n_partial = sum(chain._partial_sizes(FID))
    blocks = chain_plan(FID, BATCH, dict(warm_T=1, with_pgrads=True)).clusters
    partials = (torch.randn(blocks, n_partial, generator=gen) * 1e3).to(dev)
    # ms / plain_ms / library_ms of the kernels line: one call between two
    # events, the host waiting in between (the measure since the pass exists)
    sum_ms, summed = cuda_ms(torch, lambda: chain.sum_block_partials(partials), reps=20)
    sum_plain_ms, summed_plain = cuda_ms(
        torch, lambda: chain.sum_block_partials_reference(partials), reps=20)
    sum_lib_ms, summed_lib = cuda_ms(torch, lambda: partials.sum(dim=0), reps=20)
    # the same three on the device alone
    sum_dev_ms, _ = queued_ms(torch, lambda: chain.sum_block_partials(partials))
    sum_plain_dev_ms, _ = queued_ms(
        torch, lambda: chain.sum_block_partials_reference(partials))
    sum_lib_dev_ms, _ = queued_ms(torch, lambda: partials.sum(dim=0))
    sum_err = float((summed - summed_plain).abs().max())
    sum_bound = 1e3 * 4 * (blocks + 1) * n_partial / PEAK_BYTES_PER_S
    print(f"phase 1: sum_block_partials [{blocks}, {n_partial}]: max|d| kernel-plain "
          f"{sum_err:.1e} (must be 0: the same additions in the same order), "
          f"kernel-torch.sum {float((summed - summed_lib).abs().max()):.3e}; paced by the "
          f"host (median of 20, one call between two events) kernel {sum_ms:.4f} ms, "
          f"plain {sum_plain_ms:.4f} ms, torch.sum {sum_lib_ms:.4f} ms; on the device "
          f"(median of 20 calls queued behind a spinning kernel) kernel {sum_dev_ms:.4f} ms, "
          f"plain {sum_plain_dev_ms:.4f} ms, torch.sum {sum_lib_dev_ms:.4f} ms; bound "
          f"{sum_bound:.5f} ms (bytes) {tag}")
    check(sum_err == 0.0, f"phase 1: sum_block_partials differs by {sum_err}")

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

    def run_c():
        return chain.mcpc_chain(params, latents, data, SEED, **CHAIN_C)

    zero_counts()
    out_a, out_b, out_c = run_a(), run_b(), run_c()
    torch.cuda.synchronize()
    serve_counts = read_counts()
    print(f"phase 2: main path launches: mcpc_chain {serve_counts[0]}, "
          f"mcpc_chain_unpacked {serve_counts[1]}, sum_block_partials {serve_counts[2]}")
    check(serve_counts[0] >= 2, "the serving path did not launch the mcpc_chain kernel")
    check(serve_counts[1] >= 1, "the serving path did not launch the unpacked kernel")
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
    check(out_c[1] is None and all(bool(torch.isfinite(x).all()) for x in out_c[0]),
          "chain (c) is not finite")

    a_ms, _ = cuda_ms(torch, run_a)
    b_ms, _ = cuda_ms(torch, run_b)
    c_ms, _ = cuda_ms(torch, run_c)

    # the plain versions take 12-15 s a chain: timed once, without a warm-up
    pa_ms, ref_a = cuda_ms(torch, lambda: chain.mcpc_chain_reference(
        params, latents, data, SEED, return_scalars=True, **CHAIN_A), reps=1, warm_up=False)
    pb_ms, _ = cuda_ms(torch, lambda: chain.mcpc_chain_reference(
        params, latents, data, SEED, return_scalars=True, **CHAIN_B), reps=1, warm_up=False)
    pc_ms, ref_c = cuda_ms(torch, lambda: chain.mcpc_chain_reference(
        params, latents, data, SEED, **CHAIN_C), reps=1, warm_up=False)
    dx, rel = max_abs(out_a[0], ref_a[0]), scalar_rel(out_a[2], ref_a[2])
    print(f"phase 2: chain (a) kernel vs plain: max|dx|={dx:.3e} (atol {P2_ATOL}), "
          f"scalars max rel={rel:.3e} (rtol {P2_RTOL})")
    check(dx <= P2_ATOL, f"phase 2: chain (a) latents differ by {dx}")
    check(rel <= P2_RTOL, f"phase 2: chain (a) scalars differ by {rel}")
    dx_c = max_abs(out_c[0], ref_c[0])
    print(f"phase 2: chain (c) unpacked kernel vs plain: max|dx|={dx_c:.3e} (atol {P2_ATOL})")
    check(dx_c <= P2_ATOL, f"phase 2: chain (c) latents differ by {dx_c}")

    bound_a = chain_bound_ms(FID, BATCH, CHAIN_A["T"])
    bound_b = chain_bound_ms(FID, BATCH, CHAIN_B["T"] + CHAIN_B["warm_T"])
    bound_c = chain_bound_ms(FID, BATCH, CHAIN_C["T"])
    for name, ms, pms, bound, steps in (
        ("a", a_ms, pa_ms, bound_a, CHAIN_A["T"]),
        ("b", b_ms, pb_ms, bound_b, CHAIN_B["T"] + CHAIN_B["warm_T"]),
        ("c, unpacked", c_ms, pc_ms, bound_c, CHAIN_C["T"]),
    ):
        print(f"phase 2: chain ({name}) B={BATCH} steps={steps}: kernel "
              f"{ms:.3f} ms/chain, {1e3 * ms / steps:.3f} us/step, "
              f"{steps / (ms / 1e3):.1f} steps/s; plain {pms:.3f} ms/chain; "
              f"bound {bound:.3f} ms (operations) {tag}")
    print("phase 2: library_ms null: no single PyTorch call computes a "
          "whole Langevin chain")

    # ---------------------------------------------------------- phase 3
    config = train_mnist.mcpc_training_config()
    sampling, lr_p = config["sampling"], config["optimizer_p_kwargs_mcpc"]["lr"]
    train_steps = config["T_pc"] + config["mixing"] + sampling
    trainee = get_model(config, SEED, device=dev)
    train, _, _ = get_mnist_data(config, device=dev)
    # the fixed test batch and its inference chain: phase 2's batch and
    # latents, the training schedule without the parameter gradients
    infer = dict(train_mnist.chain_options(config), with_pgrads=False,
                 return_scalars=True)

    def test_loss(p):
        return float(chain.mcpc_chain(p, latents, data, SEED, **infer)[2]["loss"])

    draw = torch.Generator().manual_seed(SEED + 2)
    params_t, opt_state = trainee.params, adam_init(trainee.params)
    first, batch_ms = None, []
    zero_counts()
    loss_before = test_loss(params_t)
    for i, (batch, _) in enumerate(train):
        if i >= TRAIN_BATCHES:
            break
        check(tuple(batch.shape) == (BATCH, 784), f"train batch is {tuple(batch.shape)}")
        lat_i = trainee.model.init_latents(params_t, pseudo, draw)
        seed_i = int(torch.randint(0, 2**31 - 1, (), generator=draw))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        new_params, opt_state = train_mnist.one_batch(
            params_t, opt_state, lat_i, seed_i, batch, config=config)
        end.record()
        end.synchronize()
        batch_ms.append(start.elapsed_time(end))
        if first is None:
            first = (params_t, lat_i, seed_i, batch, new_params)
        params_t = new_params
    ckpt = os.path.join(here, "build", "chip_smoke", "mcpc_smoke.msgpack")
    save_checkpoint(ckpt, params_t)
    reloaded = load_checkpoint(ckpt, trainee.params, device=dev)
    loss_after = test_loss(reloaded)
    torch.cuda.synchronize()
    train_counts = read_counts()
    print(f"phase 3: main path launches over {TRAIN_BATCHES} batches and 2 inference "
          f"chains: mcpc_chain {train_counts[0]}, sum_block_partials {train_counts[2]}")
    check(train_counts[0] == TRAIN_BATCHES + 2,
          f"{train_counts[0]} chain launches for {TRAIN_BATCHES} batches + 2 chains")
    check(train_counts[2] == TRAIN_BATCHES,
          f"{train_counts[2]} summing passes for {TRAIN_BATCHES} batches")
    for p, q, p0 in zip(reloaded, params_t, trainee.params):
        for k in ("w", "b"):
            check(bool(torch.isfinite(q[k]).all()), "trained parameters are not finite")
            check(torch.equal(p[k], q[k]) and p[k].dtype == q[k].dtype,
                  "the reloaded checkpoint differs from the trained parameters")
        check(not torch.equal(q["b"], p0["b"]), "training left a bias unchanged")
    check(torch.equal(params_t[0]["w"], trainee.params[0]["w"]),
          "W0 moved although its gradient is zero")
    print(f"phase 3: checkpoint {os.path.relpath(ckpt, here)} reloads bit for bit; "
          f"Bernoulli loss of the fixed test batch (B={BATCH}, the training chain without "
          f"gradients) {loss_before:.1f} -> {loss_after:.1f} after {TRAIN_BATCHES} batches")
    check(loss_after < loss_before, "training did not lower the test batch's loss")

    # the first batch against the plain version, in f32 and float64
    p0, lat0, seed0, batch0, p1 = first
    opts = train_mnist.chain_options(config)
    got = chain.mcpc_chain(p0, lat0, batch0, seed0, **opts)
    again = chain.mcpc_chain(p0, lat0, batch0, seed0, **opts)
    torch.cuda.synchronize()
    same = grads_equal(torch, got[1], again[1]) and all(
        torch.equal(x, y) for x, y in zip(got[0], again[0]))
    print(f"phase 3: two runs of the first batch's chain give bit-identical "
          f"gradients and latents: {same}")
    check(same, "two runs on the same inputs differ")
    check(not bool(got[1][0]["w"].any()), "pgrads[0]['w'] is not exactly zero")
    tr_plain_ms, ref = cuda_ms(torch, lambda: chain.mcpc_chain_reference(
        p0, lat0, batch0, seed0, **opts), reps=1, warm_up=False)
    p0_64, lat0_64, batch0_64 = to_double(p0, lat0, batch0)
    ref64 = chain.mcpc_chain_reference(p0_64, lat0_64, batch0_64, seed0, **opts)
    g, g64, p_g64 = (grad_rel(got[1], ref[1]), grad_rel(got[1], ref64[1]),
                     grad_rel(ref[1], ref64[1]))
    print(f"phase 3: first batch, gradients max rel to the tensor's largest entry: "
          f"kernel-plain {g:.3e}, kernel-plain64 {g64:.3e}, plain-plain64 {p_g64:.3e} "
          f"(allowance {P1_GRAD_REL})")
    check(g64 <= p_g64 + P1_GRAD_REL,
          f"phase 3: gradients {g64} from float64, plain f32 {p_g64}")
    scale = sampling * BATCH
    want, _ = adam_step(p0_64, tuple({k: v / scale for k, v in gr.items()}
                                     for gr in ref64[1]), adam_init(p0_64), lr_p)
    worst, held, total = 0.0, 0, 0
    for new, exact, gr in zip(p1, want, ref64[1]):
        for k in ("w", "b"):
            clear = gr[k].abs() >= P3_CLEAR * gr[k].abs().max()
            held += int(clear.sum())
            total += clear.numel()
            if bool(clear.any()):
                worst = max(worst, float((new[k].double() - exact[k])[clear].abs().max()))
    print(f"phase 3: first batch, updated parameters vs the float64 plain version on the "
          f"{held} of {total} entries whose gradient is at least {P3_CLEAR} of its "
          f"tensor's largest: max|d|={worst:.3e} (atol {P3_PARAM_ATOL})")
    check(held > total // 2 and worst <= P3_PARAM_ATOL,
          f"phase 3: updated parameters differ by {worst} on {held} entries")

    # where a training batch's time goes: the chain alone, with and without
    # the sampling steps' gradients, and its warm phase alone
    train_ms = statistics.median(batch_ms[1:])
    chain_pg_ms, _ = cuda_ms(torch, lambda: chain.mcpc_chain(p0, lat0, batch0, seed0, **opts))
    chain_nopg_ms, _ = cuda_ms(torch, lambda: chain.mcpc_chain(
        p0, lat0, batch0, seed0, **dict(opts, with_pgrads=False)))
    warm_only_ms, _ = cuda_ms(torch, lambda: chain.mcpc_chain(
        p0, lat0, batch0, seed0, **dict(opts, with_pgrads=False, T=0)))
    bound_train = chain_bound_ms(FID, BATCH, train_steps, sampling)
    print(f"phase 3: training batch B={BATCH}, {train_steps} steps of which {sampling} "
          f"sample: {train_ms:.3f} ms/batch (median of {len(batch_ms) - 1}, first "
          f"{batch_ms[0]:.3f}), {BATCH / (train_ms / 1e3):.1f} images/s; plain chain "
          f"{tr_plain_ms:.3f} ms; bound {bound_train:.3f} ms (operations, "
          f"{(step_flops(FID, BATCH) * train_steps + step_flops(FID, BATCH) // 2 * sampling) / 1e9:.2f}"
          f" GFLOP) {tag}")
    print(f"phase 3: chain + summing pass {chain_pg_ms:.3f} ms; the same chain without "
          f"gradients {chain_nopg_ms:.3f} ms (its {config['T_pc']} warm steps alone "
          f"{warm_only_ms:.3f} ms); the {sampling} sampling steps add "
          f"{chain_pg_ms - chain_nopg_ms:.3f} ms, "
          f"{1e3 * (chain_pg_ms - chain_nopg_ms) / sampling:.3f} us each; the Adam step and "
          f"the rest of one_batch {train_ms - chain_pg_ms:.3f} ms {tag}")

    launches = [s + t for s, t in zip(serve_counts, train_counts)]
    pallas = "montecarlopredictivecoding_tpu/ops/pallas_mcpc.py"
    csrc = "montecarlopredictivecoding_tpu_torch/ops/csrc/"
    print(json.dumps({"kernels": [
        {
            "name": "mcpc_chain", "route": "cuda", "source": csrc + "mcpc_chain.cu",
            "replaces": pallas + ":426", "launches": launches[0],
            "max_abs_err": dx, "ms": a_ms, "plain_ms": pa_ms,
            "bound_ms": bound_a, "bound_by": "operations", "library_ms": None,
        },
        {
            "name": "mcpc_sum_partials", "route": "cuda", "source": csrc + "mcpc_chain.cu",
            "replaces": pallas + ":531", "launches": launches[2],
            "max_abs_err": sum_err, "ms": sum_ms, "plain_ms": sum_plain_ms,
            "bound_ms": sum_bound, "bound_by": "bytes", "library_ms": sum_lib_ms,
            "device_ms": sum_dev_ms, "plain_device_ms": sum_plain_dev_ms,
            "library_device_ms": sum_lib_dev_ms,
        },
        {
            "name": "mcpc_chain_unpacked", "route": "cuda",
            "source": csrc + "mcpc_chain_unpacked.cu",
            "replaces": pallas + ":1013", "launches": launches[1],
            "max_abs_err": dx_c, "ms": c_ms, "plain_ms": pc_ms,
            "bound_ms": bound_c, "bound_by": "operations", "library_ms": None,
        },
    ]}))
    print(f"chain (a): {plan_text(FID, BATCH, CHAIN_A)} {tag}")
    print(f"training chain: {plan_text(FID, BATCH, opts)} {tag}")
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
