"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phase 0  prints the card and its power limit, turns TF32 off (so every f32
         matrix product of the plain versions is full f32) and builds every
         CUDA kernel of the port from the sources in this checkout, one
         ``nvcc`` per library (each chain source for f32 and for bf16
         products, the per-op probe's and InceptionV3's convolution
         kernel's for f32), all started together, and
         prints each instantiation's registers and spills as ptxas reports
         them; it fails if a chain instantiation spills or holds more
         registers than its build's launch bound allows
         (``_build.resource_faults``).  The synthetic MNIST set that stands in for
         the IDX files is made once and shared by every phase.  While nvcc
         runs, the plain versions on phase 2's inputs, which no kernel
         feeds, run on the card (``early_plain_runs``: chains (a), (b) cut,
         (c), tanh (a) and bf16 (a) and (c) at 1000 steps), each timed
         once.  Then the chain kernels' ``sincos_2pi`` (through the probe's
         library) on all 2^23 inputs the noise can give it against float64:
         its largest error is the step rule's one measured constant.
Phase 1  holds each kernel against its plain PyTorch version on the card, on
         the same CUDA inputs (run in f32 and in float64), at the shapes the
         main paths give it: the chain with and without parameter gradients
         (``with_pgrads``, ``warm_pgrads``, batches that leave pad rows in
         the last cluster or fill only part of one, both widths, both
         losses), the unpacked chain (``packed=False``; at B=256, at B=1100
         beyond one 1024-row tile, and at 10-256-256-784 with its gradient
         slice in device memory), and the pass
         that sums the partial gradients (timed paced by the host, one call
         between two events, which is what the ``kernels`` line reports as
         ``ms``, and on the device alone, behind a spinning kernel:
         ``device_ms``).  Each line prints the
         plan of the call's kernel (packed or unpacked): cluster size, rows a
         cluster, clusters, SMs at work, shared memory a block, gradient slice
         resident or not.
Phase 1  also holds the chain's options by the step rule (``step_rule.py``;
(options) the block above ``step_hold``), at full width and B=37 (the
         last cluster has pad rows), on chains of 200 Adam steps and 500
         Langevin steps: captures of the Langevin phase and of
         a warm-only chain, per-step scalars every 7 steps in both phases,
         the masked Bernoulli loss at perc 0.5 (with gradients) and at a perc
         that rounds to 0 (all columns), the Adam moments handed out, a
         continuation from given moments, and a warm phase split into three
         calls that hand the moments on, each call held; then, at B=1024
         (4 waves of 18-row clusters), a masked, captured Langevin chain and
         a short Adam chain that hands its moments out.
Phase 1  also holds tanh and the output-PC site by the step rule, at B=37
(tanh,   (4 rows a cluster) and B=256 (18 rows; 10 at
output   30-256-256-784): tanh at 20-128-128-784 and at the mse preset's
PC)      30-256-256-784, on 50 Adam steps and 100 Langevin steps: with
         gradients, warm-only with ``warm_pgrads``, masked and captured,
         masked with scalars every 7 steps; and the output-PC site at
         20-128-128-784 in three calls, each from the kernel's last output: a
         warm phase that hands its moments out, a continuation from them,
         then Langevin steps with noise, gradients and captures (``traj3``).
Phase 2  drives the serving path at full width through the entry points a
         user calls: ``get_model`` -> ``get_mnist_data`` -> ``init_latents``
         -> ``mcpc_chain``, for (a) the bench chain (B=256, T=10000,
         lr 0.01, noise variance 2), (b) the figure-2 inference chain
         (2000 Adam MAP steps at lr 0.1, then T=10000 at lr 0.03) and (c)
         the unpacked chain on the bench chain's inputs (T=1000).  The
         launch counts are zeroed just before and read just after; then (c)
         and (a) are held by the step rule at their full length (chain (a)'s
         10,000 steps captured, 3.9 GB on the card; chain (c)'s, which the
         unpacked kernel cannot capture, by prefixes), the largest
         difference from the plain f32 version printed beside it, and the
         chains are timed
         with CUDA events (kernel: median of 3 after one warm-up; plain
         version: once, (b)'s cut to a tenth of its steps), and (c) again at
         T=10000 between two timings of (a), with its plan.
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
         ``scripts/chain_clocks.py``.)  Then the mse preset through its entry
         point, ``train_mcpc(preset="mse")`` (10-256-256-784 relu, B=256,
         the same schedule) for MSE_BATCHES batches: its plan (the gradient
         slice must be in device memory, read-modify-written through L2), one
         chain launch and one summing pass a batch (counts zeroed just before
         and read just after), the checkpoint reloaded bit for bit, a fixed
         test batch's loss lower; the first batch's chain held at its full
         length by the step rule (the training's launch captured again,
         split at the warm phase's end: latents, gradients, Adam moments),
         both one-row skips injected into its captures and the two faults
         of GRAD_FAULTS into its gradient sums, each of which must fail it
         (the gradients within P1_GRAD_REL of the float64 sums over the
         kernel's own states, as every step-rule hold with gradients),
         its parameters after the Adam step held from the kernel's own
         gradients (``step_rule.param_hold``); the four faults of
         ARG_FAULTS passed through that chain's arguments in the kernel's
         place, each of which must fail the hold; ms a batch beside
         the chain's share and the bound.

Phase 4  drives the figure-2 masked-digit posterior (panels c, d) at full
         width through ``PCTrainer``: ``experiments/figure_2.py``'s
         ``posterior_non_linear_model`` with the ``models/mcpc_ml_2.msgpack``
         checkpoint (20-128-128-784): the linear probe on 2 batches of 1024
         (2000 Adam MAP steps each), the PC posterior of up to 16 masked 4s
         (2000 Adam steps, every step captured) and the MCPC posterior from
         there (1000 + 9000 Langevin steps, masked at 0.5, every step
         captured).  The counts are zeroed just before and read just after;
         every ``train_on_batch`` must take the kernel (no engine call), and
         the posteriors must be finite rows that sum to 1.  It prints each
         call's time (CUDA events), microseconds a step and how much of it
         the ``mcpc_chain`` call took.  A stand-in for ``mcpc_chain`` keeps
         each call's inputs and options; afterwards each chain is held by
         the step rule at its full length (launched again with every step
         captured, which must give the figure's bits), and both one-row
         skips injected into the PC posterior's captures must fail it.
         Last, it times the MCPC chain alone without its captures.

Phase 5  drives this slice's paths at full width (synthetic MNIST; the
         checkpoints in ``models/``), with the counts zeroed just before and
         read just after: PC training (``train_mnist.train_pc``, preset ml,
         25-128-128-784 tanh, B=128, 10 batches, and preset mse,
         30-256-256-784 tanh, MSE_BATCHES batches), the masked-reconstruction
         MSE (``eval.metrics.get_mse_rec``) of ``pc_mse_1`` (30-256-256-784
         tanh) and ``mcpc_mse_1`` (10-256-256-784 relu) on 2 test batches of
         1024, the marginal likelihood (``get_marginal_likelihood``, 5000
         samples) of ``pc_ml_1`` and ``mcpc_ml_1`` on 2 validation batches of
         1024, the output-PC joint sampler (figure 3's recipe on the fid
         model with a trailing PC site and ``mcpc_fid_3``'s parameters,
         B=256, 250 Adam steps at lr 0.7 then 10,000 Langevin steps at
         JOINT_LR, through ``PCTrainer``), and figure 3 (``experiments/figure_3.py``): panel a
         (the 1-D model, in the step engine, at SCALE_3A of its steps) and
         panel b (B=1, 250 + 1000 + 30000 steps, captured outputs); nothing
         is drawn.  Every ``PCTrainer`` call but panel a's must take the
         kernel.  It prints each call's time (CUDA events) beside its bound.
         The first PC training batch of each preset, each model's first MSE
         batch, the joint sampler's and panel b's chains are held by the
         step rule at their full length (``hold_replay``: launched again on
         their recorded inputs with every step captured, which must give
         the recorded bits), and so is chain (a) with tanh.

Phase 6  drives the bf16 opt-in (``bf16_matmul``) at full width
(bf16)   (20-128-128-784, Bernoulli).  It counts the tensor-core products
         (HMMA) in each chain library's SASS: every chain kernel of the bf16
         libraries must hold them, in the BF16 forms, no kernel of the f32
         ones.  It holds both kernels' bf16 builds
         against the plain bf16 version by two rules (BF16_* below): one
         Langevin step of relu, tanh and the unpacked kernel, with gradients,
         at B=37 and B=256; then relu and tanh with 50 Adam and 100 Langevin
         steps and gradients, relu warm-only with ``warm_pgrads`` and the
         unpacked chain with gradients (150 steps), at B=37 and B=256, one
         step of relu, tanh and the unpacked kernel at B=1024 (four waves),
         the output-PC site at B=256, the
         unpacked kernel's one step at B=1100 and 150 steps with gradients at
         10-256-256-784, and
         the options' instantiation at B=37 (masked and captured, tanh with
         scalar slots, a continuation handing its moments out, the output-PC
         site), in f32 and float64, with the per-row mean energy beside each.
         Then, counts zeroed just before and read just after: ``PCTrainer``
         with ``use_kernel_bf16=True`` (a PC training batch at preset ml;
         ``"auto"`` must stay f32), bench.py's bf16 rows with f32 beside bf16
         (chain (a) at B=256 and B=1024, T=10000; the training step, 250
         Adam + 50 + 100 Langevin steps + the Adam step on the parameters,
         at B=256 and B=1024; CUDA events, median), and the unpacked chain
         (c) in bf16.  Chain (a) and (c) in bf16 are held and timed against
         the plain version at T=1000, and chain (a)'s SM clocks a step by
         phase (``chain_phase_clocks``) are read over PHASE_CLOCK_T steps, f32
         beside bf16.  Last, ``train_mcpc(fused=False)``:
         10 batches at B=256 through ``PCTrainer``, 2 chain launches and one
         summing pass a batch, no engine call, the parameters finite and
         changed, the test batch's loss lower; ms a batch beside phase 3's
         ``one_batch``.

Phase 7  drives table 1 and figure 2e at full width (synthetic MNIST, the
(table 1, checkpoints in ``models/``), with cuDNN's TF32 flag back at torch's
fig. 2e)  default, True, so that the port's ResNet-9 and Inception functions must
         turn it off themselves (``full_f32_conv``): (i) the ResNet-9
         features of the 10,000 synthetic test images from
         ``models/resnet9.msgpack`` on the card, held against the same module
         on the CPU for R9_CPU_IMAGES of them (and, printed, the same module
         with TF32 left on), ms per 1000 images; (ii) the FID reference
         statistics built fresh in a temporary root, the pixel statistics
         held to the repository's caches at float64 rounding and the
         ResNet-9 statistics within R9_STATS_RTOL; (iii) ``table_1.py``'s
         three columns for TABLE_SEEDS (FID with ResNet-9 and pixel features
         at 5000 samples, MSE on the full test set through ``PCTrainer`` and
         the chain kernel, marginal likelihood on the full validation set at
         5000 samples), every value and each column's time printed, the MSE
         column's counts zeroed just before and read just after (at least one
         ``mcpc_chain`` launch, no engine fallback); (iv) ``train_dlgm``
         (preset fid, B=64) and ``train_resnet9_entry`` (B=128): ms a step
         (CUDA events, median), the loss falls, the ResNet-9 file reloads bit
         for bit; (v) figure 2e (``comparison_ideal_observer``) with the
         shipped ResNet-9: the KL table, its launches (counts zeroed just
         before, read just after), no engine fallback.

Phase 8  drives figures 2 (a, b), 4, 5 and 6 (``experiments/figure_2.py``,
(figures ``figure_4.py``, ``figure_5.py``, ``figure_6.py``), nothing drawn.  The
2ab, 4,   kernel paths at full width and the published step counts, counts
5, 6)    zeroed just before and read just after: figure 5b
         (``similarity_increase_digit``) for seeds FIG5_SEEDS at epochs
         FIG5_EPOCHS from ``models/epoch_save``, each seed in turn through
         the sweep (a warm start of 1000 Adam steps, then 500 + 9500
         Langevin steps captured every 20, B=256, four stimuli); figure 5a
         (``variability_stimulus_onset_nonlinear``) in both modes on
         ``mcpc_fid_1`` (MCPC B=256, PC B=100, 8000 steps a call captured
         every 4); figure 4e (``image_reconstruction``, B=1024, 250 Adam steps
         on ``mcpc_mse_1`` and ``pc_mse_1``, masked) and 4d
         (``image_generation``).  Every ``PCTrainer`` call must take the
         kernel; it prints each kind of call's time beside its bound.  One
         figure-5 chain and the 4e launch on ``mcpc_mse_1`` are held by the
         step rule at their full length as in phase 5.  Then the 1-D
         models, which the step engine runs (figure 2 (a, b)
         at FIG2_SCALE, 4a and 4c on 3 data batches, figure 6 at
         FIG_ENGINE_SCALE; 4b is left to the CPU tests), with their engine
         time a step on the card and, for figure 6, on the CPU; figure 2's
         samples must sit near the posterior N(0.44, 0.2).  Last, the
         stacked DLGM's metrics (``StackedMetrics``) on the card against the
         CPU.

Phase 9  drives data-parallel MCPC training, the native loader, observability
(data    and the dry run at the fid model's full width (20-128-128-784, B=256,
parallel) 250 Adam + 50 + 100 Langevin steps, Adam at lr 0.01), counts zeroed
         just before each path and read just after: (1) world size 1 under
         NCCL in this process: DP_W1_BATCHES batches of
         ``train_mcpc(mesh=1)`` with the noise on beside ``train_mcpc()``,
         bit-identical, and each batch's step timed (``one_batch_dp``
         against ``one_batch``: the dp wrapper's cost); (2) world size 2,
         two ranks on the one card under gloo (``phase9_rank``; spawned as
         phase 0 starts, they load the port while nvcc runs and wait):
         ``make_dp_fused_chain`` on one batch without noise against the
         whole batch's kernel call, with noise at DP_WRAP_SEED bit-equal to
         ``mcpc_chain`` on each shard with its wrapped shard seed,
         DP_W2_BATCHES batches of ``train_mcpc(mesh=2)`` without noise
         against ``train_mcpc()`` by the JAX test's rule, and
         ``dryrun_multichip(2, "cuda")`` in that group; (3) the native
         loader (``native_available()``, an IDX file of LOADER_ROWS images
         read and gathered against numpy, an epoch of shuffled batches timed
         both ways); (4) OBS_BATCHES trainer-path batches through
         ``ProgressLogger`` and ``energy_absorption_report``, the first under
         ``profile_trace``, whose trace's top device operations it prints.
Phase 10 the per-op probe (``benchmarks/vpu_op_bench.py`` of the port, the
(probe)  JAX package's last Pallas kernel): each of its 14 variants at
         B=256 and 64, over 64 steps from 0.3 and over 5 and 13 steps from
         the signed start (``PROBE_HOLDS``), against its plain version on
         the card (``card_tolerance``; the random ones at noise scale 1,
         where a wrong draw shows, and at the probe's 1e-6), the card's
         ``sincos_2pi`` against the plain one, the plain versions' time a
         step; then its entry point, ``main`` at B=256 and 64 with
         PROBE_ARGS' lengths (the command line's are 100,000 and 500,000),
         both kernels' launches counted: each variant's µs a step, its
         excess over ``baseline`` and its bound from the operations a step
         needs (``STEP_OPS``; the pipe that sets it), with ``bm_poly``
         beside ``bm_hw`` and ``sigmoid_tanh`` beside ``sigmoid``.

Phase 11 InceptionV3's BasicConv2d kernel (``ops/inception_conv.py``,
(FID     ``scripts/inception_conv_layers.py``): each of the 94 layers on the
convs)   input it gets in a forward of INCEPTION_BATCH images (the benchmark's
         seeded weights) against a float64 convolution, BatchNorm and relu:
         the kernel's worst-row gap at most INCEPTION_GAP, beside the FMA
         route's (cuDNN, TF32 off) and a planted single-pass TF32 variant's,
         which must read at least INCEPTION_PLANTED times the kernel's; a
         forward's 94 launches counted; the kernel's time a forward beside
         its bound, its plain version's and the library's (cuDNN's
         convolution, PyTorch's BatchNorm and relu).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero before
either is printed.  There is no CPU fallback: without a CUDA device the
script exits non-zero.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import itertools
import json
import multiprocessing
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

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
PC_ML, PC_MSE = (25, 128, 128, 784), (30, 256, 256, 784)   # the tanh presets
CHAIN_A = dict(T=10000, lr=0.01, noise_var=2.0, loss="bernoulli")
CHAIN_B = dict(T=10000, lr=0.03, noise_var=2.0, loss="bernoulli",
               warm_T=2000, warm_lr=0.1)
CHAIN_C = dict(T=1000, lr=0.01, noise_var=2.0, loss="bernoulli", packed=False)
# chain (c) at chain (a)'s length, timed beside it: the same cluster plan and
# step, the unpacked noise index
CHAIN_C_LONG = dict(CHAIN_C, T=CHAIN_A["T"])
# the other chains on phase 2's inputs whose plain versions the kernels are
# held to: chain (b) cut to a tenth of its steps (its plain version is only
# timed), tanh (a) cut to 1000 steps (phase 5), bf16 (a) cut to 1000 steps
# and bf16 (c) (phase 6)
CHAIN_B_CUT = dict(CHAIN_B, warm_T=CHAIN_B["warm_T"] // 10, T=CHAIN_B["T"] // 10)
TANH_A_CUT = dict(CHAIN_A, activation="tanh", T=1000, return_scalars=True)
BF16_A = dict(CHAIN_A, T=1000, bf16_matmul=True)
BF16_C = dict(CHAIN_C, bf16_matmul=True)
TRAIN_BATCHES = 40
# the mse preset of both trainers (phases 3 and 5): batches through each entry
# point; and the faults passed through the MCPC batch's chain arguments in the
# kernel's place, each of which its hold must fail
MSE_BATCHES = 10
ARG_FAULTS = (
    ("lr and warm_lr * (1 + 1e-3)", lambda kw, seed: (dict(
        kw, lr=kw["lr"] * (1 + 1e-3), warm_lr=kw["warm_lr"] * (1 + 1e-3)), seed)),
    ("mixing - 1 (one step more in the gradients)",
     lambda kw, seed: (dict(kw, mixing=kw["mixing"] - 1), seed)),
    ("the seed + 1", lambda kw, seed: (kw, seed + 1)),
    ("noise_var * 1.01", lambda kw, seed: (dict(kw, noise_var=kw["noise_var"] * 1.01), seed)),
)
# faults of the gradient sums alone, injected into the MCPC batch's
# captures (``step_rule.grads_changed``), each of which its hold must fail
GRAD_FAULTS = (
    ("the gradient sums rounded to bf16", lambda g: g.bfloat16().to(g.dtype)),
    ("the gradient sums * (1 + 1e-4)", lambda g: g * (1 + 1e-4)),
)
# the options' check: 200 Adam steps and 500 Langevin steps at B=37
OPT_B = 37
OPT_CHAIN = dict(warm_T=200, warm_lr=0.1, T=500, lr=0.03, noise_var=2.0)
# and at figure 2's probe batch, 57 clusters of 18 rows in 4 waves, on
# chains of 20 steps: at B=1024 a few rows amplify a rounding difference
# into 1e-3..1e-2 after 31 to 281 Langevin steps, in either f32 version
# (scripts/chain_error_growth.py), which no allowance of the kernel's own
# error can tell from a fault; before that every row sits at rounding size
WIDE_B = 1024
WIDE_CASES = [
    ("Langevin phase, masked perc 0.5, every step captured",
     dict(T=20, lr=0.03, noise_var=2.0, loss="bernoulli_mask", mask_perc=0.5,
          capture_stride=1, return_scalars=True)),
    ("20 Adam steps, moments handed out, scalars every 3 steps",
     dict(T=0, warm_T=20, warm_lr=0.1, lr=0.1, noise_var=None, emit_warm_opt_state=True,
          scalar_stride=3, return_scalars=True)),
]

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
# Chains that amplify rounding (phases 1-5, 8) are held by the step rule
# (``step_rule.py``, the block above ``step_hold``): every step from the
# kernel's own state, to a bound derived for that step.  Their gradient sums
# are held besides within P1_GRAD_REL of each tensor's largest entry from
# the float64 sums over the kernel's own states: the rule's bound of a sum
# of B x steps terms in any order is too wide to see a fault of 1e-4 of the
# sums (GRAD_FAULTS).
# Phase 3 holds the first training batch (400 steps, Adam at lr 0.7) like
# phase 1, and its updated parameters on the entries whose gradient is at
# least P3_CLEAR of the tensor's largest: Adam's first step is lr*sign(g),
# so an entry whose gradient is only rounding noise may differ by 2*lr.
P1_ATOL, P1_RTOL, P1_GRAD_REL = 1e-4, 1e-5, 2e-5
P1_MOMENT_REL = 2e-5   # Adam moments, relative to their tensor's largest entry
# the old largest-element rule of phase 2's chains, which scripts/chain_c_draws.py prints
P2_ATOL = 2e-3
P3_CLEAR, P3_PARAM_ATOL = 1e-3, 1e-6

# tanh and the output-PC site in phase 1: 50 Adam steps, 100 Langevin steps
TANH_CHAIN = dict(warm_T=50, warm_lr=0.1, T=100, lr=0.03, noise_var=2.0,
                  activation="tanh")
OUT_PC = dict(output_var=0.5, loss="none")
# phase 5: PC training batches, the batches of each metric, figure 3a's scale
# (its 10,250 steps run one small autograd step at a time on the host)
PC_TRAIN_BATCHES, EVAL_BATCHES, ML_SAMPLES, SCALE_3A = 10, 2, 5000, 0.2
# phase 6: batches of train_mcpc(fused=False)
TRAINER_BATCHES = 10
# the joint sampler's Langevin step: with the output site's variance 1, x2
# sees the curvature sigma_max(W3)^2 = 4478 of mcpc_fid_3, so a step above
# 2 / 4478 diverges (at lr 0.1 the latents pass 1e6 within 30 steps)
JOINT_LR = 1e-4
# phase 6, bf16 products.  Two correct implementations sum a product in
# different orders; where a sum lands near a bf16 rounding boundary the next
# product's operand rounds the other way (one bf16 ulp, 2^-8 relative) and a
# chain amplifies that, so a bf16 kernel is held to the plain bf16 version
# by two rules.  (i) After one Langevin step without noise: at least
# BF16_AGREE of the latents within BF16_STEP_ATOL and of the gradient
# entries within BF16_STEP_GRAD_REL of their tensor's largest (f32
# summation size; the rest are where an operand rounded the other way), and
# no part further from the plain bf16 version than BF16_SHARE of the bf16
# effect (the plain bf16 version's distance from the plain f32 one).  (ii)
# On longer chains every part within BF16_SHARE of the bf16 effect of the
# plain bf16 version run in f32, or within phase 1's allowance where the
# effect is smaller; and, as phase 1 does, at most that much further from
# the plain bf16 version run in float64 (the same rounding points) than the
# plain bf16 version run in f32 is.  Run in float64, the plain bf16 version
# is not the exact answer the f32 ones approach: its sums too land on the
# other side of a bf16 boundary now and then.  Rule (ii) measures a distance
# as the root mean square over a part's elements (gradients and moments
# relative to their tensor's largest entry; the scalars by their largest
# relative difference): a flip moves a few rows, the bf16 effect every
# element, and one element near relu's kink can carry either as far.  By
# the largest difference, chain (c) in bf16 sat 0.101 from its plain version
# after 1000 steps against a bf16 effect of 0.103, and both f32 versions of
# a 300-step unpacked chain sat 0.057 from the float64 one against 0.065.
# A kernel that ignores the flag sits at the whole effect, and the script
# checks that rule (i) would fail the plain f32 version; one that takes
# tanh' from the rounded H left about half the latents beyond
# BF16_STEP_ATOL after one step (the plain version so broken, on the CPU).
# The training batch's 250 Adam steps at lr 0.7 part any two summation
# orders as far as bf16 does (on the CPU, the plain version with its sums
# taken in double instead: 1.3 times the effect), so it is held only at
# cut length.
BF16_AGREE, BF16_STEP_ATOL, BF16_STEP_GRAD_REL, BF16_SHARE = 0.98, 1e-5, 2e-6, 0.5
# phase 7: table 1's seeds (the script's run is seeds 1-3; seed 3 is cut to
# keep the smoke in its time with phase 9); CPU images to hold the card's ResNet-9 features
# against, and the bounds: features within R9_FEAT_RTOL of the largest (f32
# sums in another order sit near 1e-6; TF32 convolutions near 1e-3); the
# pixel statistics within float64 rounding of the repository's caches (the
# same numpy data and moments); the ResNet-9 statistics within
# R9_STATS_RTOL of theirs (the JAX package on the CPU reproduces those files
# exactly, so the features' f32 tolerance is what remains); DLGM and
# ResNet-9 training steps
TABLE_SEEDS = (1, 2)
R9_CPU_IMAGES, R9_FEAT_RTOL = 256, 1e-5
PIXEL_STATS_RTOL, R9_STATS_RTOL = 1e-12, 1e-4
DLGM_STEPS, R9_STEPS = 200, 100
FID_SAMPLES = 5000  # samples a model, as table 1's FID column takes
# phase 8: figure 5b's seed models and epochs (the figure script's default
# run), figure 6's noise variances, and the scales of the figures the step
# engine runs (one small autograd step at a time, about 1.6 ms a step on the
# card): figure 2's, and the others' at their smallest step counts.  The
# stacked DLGM's NLL on the card within STACKED_RTOL of the CPU's (f32 sums
# and solves of 201 x 201 factors in another order)
FIG5_SEEDS, FIG5_EPOCHS = (0, 1, 2), (0, 5, 10, 15)
FIG2_SCALE, FIG_ENGINE_SCALE, FIG6_NOISE = 0.2, 0.01, (2.0, 16.0)
STACKED_RTOL = 1e-4
# the published dense bf16 and TF32 tensor-core peaks of an H100 SXM
# (NVIDIA data sheet, 700 W): the least time the card could take for bf16
# products, and for f32 ones as split-TF32 products, three TF32 products
# for each f32 one (SPLIT_TF32_PRODUCTS), the bound of a tensor-core route
# for the f32 build (PERF.md: one was measured and not kept)
PEAK_BF16_FLOPS = 989e12
PEAK_TF32_FLOPS = 495e12
SPLIT_TF32_PRODUCTS = 3
# phase 6: the steps of chain (a) over which the phase clocks are read
PHASE_CLOCK_T = 2000
# phase 9: data-parallel training.  World size 1 (NCCL, in this process):
# DP_W1_BATCHES batches of train_mcpc(mesh=1) with the noise on beside
# train_mcpc(), which must give the same bits (one rank: the shard is the
# batch, the shard seed the seed, the all-reduce a copy).  World size 2
# (gloo on CUDA tensors, two spawned ranks on the one card: NCCL takes one
# rank a card): the dp chain on one batch without noise, each rank's rows by
# phase 1's latent rule and the summed gradients within P1_GRAD_REL of the
# whole batch's kernel call (only the order of the sum differs); with noise
# at DP_WRAP_SEED, whose shard seed on rank 1 wraps int32, each shard
# bit-equal to mcpc_chain on it; DP_W2_BATCHES batches of train_mcpc(mesh=2)
# without noise, each step bit-equal to the two shards' chains run on one
# rank with their gradients added, and against the single-device run by the
# JAX test's _quantile_close (DP_QUANTILE: tolerance, share beyond it,
# largest) on the entries whose gradient is clear of rounding (P3_CLEAR) in
# every batch: elsewhere Adam's first steps are lr * sign(g) of a sum the
# two runs take in other orders (on every entry the rule is printed).  The native
# loader on LOADER_ROWS images of 28 x 28; OBS_BATCHES trainer-path batches
# through ProgressLogger, the first under profile_trace
DP_W1_BATCHES, DP_W2_BATCHES = 10, 4
DP_WRAP_SEED = 2**31 - 2
DP_QUANTILE = (5e-4, 0.01, 0.02)
DP_RANK_TIMEOUT_S = 300
LOADER_ROWS = 60000
OBS_BATCHES = 3
# phase 11: InceptionV3's convolution kernel at the extractor's batch; a
# layer's kernel gap from float64 at most INCEPTION_GAP (the card read at
# most 8.8e-7 over the 94 layers at B = 64 and 8, the FMA route 2.9e-6),
# and the planted single-pass TF32 variant at least INCEPTION_PLANTED times
# the kernel's gap on every layer (it read 466 times or more)
INCEPTION_BATCH = 64
INCEPTION_SEED = 7
INCEPTION_GAP = 2e-6
INCEPTION_PLANTED = 30

# phase 10: the per-op probe held at each batch its entry point runs, from
# 0.3 over 64 steps (the unrolled loop alone) and from the signed start over
# 5 (the remainder alone) and 13 steps (both), where the start still shows;
# then its entry point at the smoke's lengths, least of 3 calls a length; the
# plain versions' time a step between PROBE_PLAIN_T steps; the choices of
# the JAX package it weighs
PROBE_B, PROBE_BATCHES = 256, (256, 64)
PROBE_HOLDS = (("0.3", 64), ("signed", 5), ("signed", 13))
PROBE_ARGS = [str(b) for b in PROBE_BATCHES] + ["--t-lo", "10000", "--t-hi", "50000",
                                                "--reps", "3"]
PROBE_PLAIN_T = (16, 64)
PROBE_PAIRS = (("bm_poly", "bm_hw"), ("sigmoid_tanh", "sigmoid"))


class SmokeFailure(RuntimeError):
    pass


def _step_rule():
    """``step_rule.py`` beside this script, imported once the port is."""
    return importlib.import_module("step_rule")


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


def early_plain_runs(torch, chain, params, latents, data) -> dict:
    """The plain versions on phase 2's inputs that phases 2, 5 and 6 print
    or hold the kernels to, none of which depends on a kernel: run while nvcc
    builds the kernels, each timed once without a warm-up (the host's cores
    shared with nvcc).  {name: (ms or None, result)}."""
    def timed(**kw):
        return cuda_ms(torch, lambda: chain.mcpc_chain_reference(params, latents, data, SEED,
                                                                 **kw), reps=1, warm_up=False)

    return {"a": timed(return_scalars=True, **CHAIN_A),
            "b": timed(return_scalars=True, **CHAIN_B_CUT),
            "c": timed(**CHAIN_C), "tanh": timed(**TANH_A_CUT),
            "a16": timed(**BF16_A), "a16 in f32": timed(**dict(BF16_A, bf16_matmul=False)),
            "c16": timed(**BF16_C)}


def conv_net_flops(torch, model, x) -> int:
    """Multiply-add FLOPs of ``model``'s convolutions and linear layers on
    input ``x`` (2 a multiply-add), from the output shapes a forward pass
    gives."""
    flops = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
            flops[0] += 2 * out.numel() * k
        elif isinstance(mod, torch.nn.Linear):
            flops[0] += 2 * out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    try:
        with torch.no_grad():
            model.eval()(x)
    finally:
        for h in handles:
            h.remove()
    return flops[0]


def profiled_ms(torch, fn, calls: int = 10):
    """(wall ms a call under the profiler, device-busy ms a call, the three
    kernels with the most device time) over ``calls`` calls of ``fn`` after
    one warm-up, from ``torch.profiler``'s CUDA activity: the busy time sums
    the kernels' rows only (an operator's row repeats its kernels' time);
    None where the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / calls

    def device_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))

    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=device_us, reverse=True)
    busy = sum(device_us(e) for e in events) / 1e3 / calls
    top = [(e.key, device_us(e) / 1e3 / calls, e.count // calls) for e in events[:3]]
    return wall, (busy if busy > 0 else None), top


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


def chain_bound_ms(dims, B: int, steps: int, sampling: int = 0,
                   peak: float = PEAK_F32_FLOPS) -> float:
    """Least time an H100 could take: the larger of the matrix-product FLOPs
    over the ``peak`` (f32 outside the tensor cores unless told otherwise; a
    sampling step adds the Hebbian products, half a step's worth) and the
    bytes read and written once over HBM's rate."""
    d0, d1, d2, D = dims
    flops = step_flops(dims, B) * steps + step_flops(dims, B) // 2 * sampling
    n = d0 + d1 + d2
    params = d0 + d0 * d1 + d1 + d1 * d2 + d2 + d2 * D + D
    nbytes = 4 * (params + 2 * B * n + B * D + (params if sampling else 0))
    return 1e3 * max(flops / peak, nbytes / PEAK_BYTES_PER_S)


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
            tuple(x.double() for x in latents), None if target is None else target.double())


def moment_rel(ma, mb) -> float:
    return max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
               for a, b in zip(ma, mb))


def option_parts(out, kw) -> dict:
    """The named parts of a chain's result (``step_rule.parts_of``)."""
    return _step_rule().parts_of(out, kw)


def off_prediction(torch, latents, generator):
    """The latents with x3 moved at least one unit off its prediction, away
    or towards it at random.  Where |x3 - logits| is within the rounding of
    two different sums of the logits, the first Adam step on x3 (lr *
    sign(x3 - logits)) follows that rounding and the chains part by up to
    2 lr; at the prediction itself every element is such a case, and with an
    offset of N(0, 1) about one element in 10^5 is.  The kernel is held to
    its plain version where the chain is a function of its inputs."""
    z = torch.randn(latents[3].shape, generator=generator).to(latents[3].device)
    return latents[:3] + (latents[3] + torch.where(z >= 0, 1.0 + z, z - 1.0),)


def mean_row_energy(torch, params, latents, activation: str) -> float:
    """The latent layers' energy of each batch row, 0.5 |err0|^2 + 0.5
    |err1|^2 + 0.5 |err2|^2 in f32 from the f32 parameters, averaged over the
    rows: a per-row statistic of where a chain ended."""
    act = torch.tanh if activation == "tanh" else torch.relu
    x0, x1, x2 = latents[:3]
    e = ((x0 - params[0]["b"]).pow(2).sum(1)
         + (x1 - (act(x0) @ params[1]["w"] + params[1]["b"])).pow(2).sum(1)
         + (x2 - (act(x1) @ params[2]["w"] + params[2]["b"])).pow(2).sum(1))
    return float(0.5 * e.mean())


def rms_abs(a, b) -> float:
    """Root mean square of the differences of two tuples of tensors, over all
    their elements."""
    sq = n = 0.0
    for x, y in zip(a, b):
        sq += float(((x.double() - y.double()) ** 2).sum())
        n += y.numel()
    return (sq / n) ** 0.5


def rms_rel(a, b) -> float:
    """The same with each tensor's differences divided by its largest entry
    in ``b`` (gradients, given as dicts, and Adam moments)."""
    if a and isinstance(a[0], dict):
        a = [x[k] for x in a for k in ("w", "b")]
        b = [y[k] for y in b for k in ("w", "b")]
    return rms_abs([x / y.abs().max().clamp_min(1e-30) for x, y in zip(a, b)],
                   [y / y.abs().max().clamp_min(1e-30) for y in b])


def agree_share(pairs, tol_of) -> float:
    """Share of the elements of the (got, want) tensor pairs with |got -
    want| <= tol_of(want)."""
    inside = total = 0
    for a, b in pairs:
        inside += int(((a - b).abs() <= tol_of(b)).sum())
        total += b.numel()
    return inside / total


def grads_equal(torch, ga, gb) -> bool:
    return all(torch.equal(a[k], b[k]) for a, b in zip(ga, gb) for k in ("w", "b"))


def bits_equal(torch, a, b) -> bool:
    """Two results' parts hold the same bits (``step_rule.bits_equal``)."""
    return _step_rule().bits_equal(a, b)


class ChainRecorder:
    """Stands in for ``ops.mcpc_chain.mcpc_chain`` while phases 4 and 5 run: it
    keeps a copy of each call's inputs and options, its result but the
    trajectory (so the caching allocator sees what it sees without the
    recorder), the CUDA events around the call and the device-memory
    segments the call had to allocate, and calls the wrapper.  The wrapper
    counts a launch on the module's ``mcpc_chain``, which is this object
    while it stands in, so its ``launches`` attributes are the wrapper's
    own."""

    def __init__(self, torch, fn):
        self.torch, self.fn, self.calls = torch, fn, []

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))
    launches_unpacked = property(lambda self: self.fn.launches_unpacked,
                                 lambda self, n: setattr(self.fn, "launches_unpacked", n))
    launches_bf16 = property(lambda self: self.fn.launches_bf16,
                             lambda self, n: setattr(self.fn, "launches_bf16", n))
    launches_unpacked_bf16 = property(
        lambda self: self.fn.launches_unpacked_bf16,
        lambda self, n: setattr(self.fn, "launches_unpacked_bf16", n))

    def _segments(self) -> int:
        if not self.torch.cuda.is_available():
            return 0
        return self.torch.cuda.memory_stats().get("segment.all.allocated", 0)

    def __call__(self, params, latents, target, seed, **kw):
        def copy(xs):
            return tuple(x.clone() for x in xs)

        kept = dict(kw, **{k: copy(kw[k]) for k in ("warm_mu", "warm_nu")
                           if kw.get(k) is not None})
        inputs = (tuple({k: v.clone() for k, v in p.items()} for p in params),
                  copy(latents), None if target is None else target.clone(), seed)
        # the events only where there is a device (scripts record on the CPU)
        cuda = latents[0].is_cuda
        start, end = (self.torch.cuda.Event(enable_timing=True) for _ in range(2)) if cuda \
            else (None, None)
        segments = self._segments()
        if cuda:
            start.record()
        out = self.fn(params, latents, target, seed, **kw)
        if cuda:
            end.record()
        parts = option_parts(out, kw)
        parts.pop("traj", None)
        parts.pop("traj3", None)
        self.calls.append(dict(inputs=inputs, kw=kept, parts=parts, events=(start, end),
                               new_segments=self._segments() - segments))
        return out


def quantile_close(a, b, tol: float, frac: float, max_abs_: float) -> str:
    """The JAX test's rule for two Adam trajectories (tests/test_train_mesh.py):
    under ``frac`` of the elements beyond ``tol``, none beyond ``max_abs_``;
    '' where it holds, else what failed."""
    diff = (a - b).abs()
    share, worst = float((diff > tol).double().mean()), float(diff.max())
    return "" if share < frac and worst < max_abs_ else f"{share:.4f} beyond {tol}, largest {worst}"


def clear_entries(torch, grads_by_batch) -> list:
    """Phase 9's set-aside for two Adam trajectories: per layer, ``{w, b}``
    masks of the entries whose gradient is at least P3_CLEAR of its
    tensor's largest in every batch (``grads_by_batch``: each batch's
    gradients, a list of ``{w, b}`` dicts).  Elsewhere Adam's first steps
    are lr * sign(g) of a sum that two runs take in other orders."""
    return [{k: functools.reduce(torch.logical_and, [
        g[i][k].abs() >= P3_CLEAR * g[i][k].abs().max() for g in grads_by_batch]).cpu()
        for k in ("w", "b")} for i in range(len(grads_by_batch[0]))]


def dp_rule(params_a, params_b, clear) -> tuple:
    """Phase 9's rule on two runs' parameters: ``quantile_close`` with
    DP_QUANTILE per tensor on every entry (printed only) and on the clear
    entries of ``clear_entries`` (held).  (on every entry, on the clear
    ones, clear entries, entries): '' where a tensor holds."""
    pairs = [(a[k].cpu(), b[k].cpu(), m[k]) for a, b, m in zip(params_a, params_b, clear)
             for k in ("w", "b")]
    far_all = [quantile_close(a, b, *DP_QUANTILE) for a, b, _ in pairs]
    far_clear = [quantile_close(a[m], b[m], *DP_QUANTILE) if bool(m.any()) else ""
                 for a, b, m in pairs]
    return (far_all, far_clear, sum(int(m.sum()) for _, _, m in pairs),
            sum(m.numel() for _, _, m in pairs))


# ------------------------------------------------------------ the row rule
# Chains that amplify rounding (thousands of Langevin steps, Adam chains)
# part wherever a latent sits within rounding of relu's kink or an Adam step
# follows the sign of a gradient near zero: there two correct f32 orders take
# different paths, in a few rows, and the largest element over the whole
# batch says only whether such a row happened.  So a kernel is held to the
# plain version run in float64 unit by unit: a unit is a batch row of the
# latents or of the Adam moments, a batch row of a trajectory across all its
# captured steps, or one entry of a gradient tensor or of the scalars.
#  (i) On every unit the kernel sits at most the allowance further from
#      float64 than the plain f32 version does (phase 1's rule, per unit).
#  (ii) Where that fails, the unit is set aside only if correct f32
#      arithmetic parts there: the plain f32 version from float64, or one of
#      the witnesses (below) from the plain f32 version, beyond the
#      allowance (an entry also where they disagree in sign).  The kernel's
#      own output never names such a unit.  Units beyond the allowance that
#      no witness flags may number at most UNFLAGGED_SHARE of the flagged
#      ones; a unit the kernel leaves not finite fails the part.
#  (iii) Where (i) fails, the part's root-mean-square distance from
#      float64 is held to RMS_FACTOR times the furthest correct order's
#      (the plain f32 version's or a witness's), plus the allowance.
# A set-aside unit has no bound of its own, and a part may be sensitive on
# every unit: on the long Adam chains (MSE-rec, the joint sampler's warm
# start, figure 2's probe MAP and PC posterior) other correct orders sat up
# to 6.7 times their unit's own furthest witness with 16 copies (217 times
# with 8) and up to 1.17 times the furthest any witness reached on the
# part (a one-row fault from 0.12 times), and the witnesses part on every
# row of the warm start.  There the RMS tells rounding from faults: no
# correct order's part sat above 1.12 times the worst witness's (1.01 on
# rows), lr x (1 + 1e-3) reached 1.83 times or more on every chain, Adam's
# bias correction off 226 (``scripts/rule_calibration.py``, one H100,
# PERF.md §6): hence RMS_FACTOR between them.  A fault confined to one row
# passes wherever correct orders part in that row, and in a part with 128
# or more flagged units; where fewer are flagged it fails (ii).  The old
# largest-element rule is printed beside every verdict; a clause holding
# the kernel to it wherever every correct order keeps it was measured and
# left out: on the card's eight long chains it failed only correct orders
# (fresh witnesses, with 16 copies), and with 32 or 64 it decided nothing.
# The witnesses are the plain version with other rounding at every step
# (``jittered_rounding``): every product summed over k in reverse, and the
# latents moved by up to UPDATE_ULPS ulp as each step starts, as a fused
# multiply-add rounds the update once where the plain version rounds twice.
# For the rows and the captured scalars they are STACKED_COPIES copies of
# the batch in one call (each copy its own rows' noise and its own moves);
# for gradients and uncaptured scalars, sums over the batch, SUM_COPIES
# copies in one more call whose sums are taken copy by copy (``sums_apart``:
# one call costs about what one separate run does).  They run only where
# (i) fails, so a chain that passes (i) costs nothing more.
# Both counts hold for every hold alike and were set from correct orders
# alone: on the eight long chains of ``rule_calibration.py`` (figure 2's
# and MSE-rec's, the joint sampler's warm start, each trainer's first mse
# batch), 16 fresh witnesses (another seed) and the other correct orders
# were held as the kernel is.  With 16/8 copies 12 of their parts failed,
# with 32/16 6 and with 64/32 4 (probe MAP batch 1's scalars twice, the
# mse MCPC batch's latents and gradients once each): no count tried frees
# every correct order, and the fewest fail at the most copies the smoke's
# time allows.  What a fresh correct order leaves unflagged is a row where
# one order in 30 or more parts: it fails a part that flags fewer than 128
# units (PERF.md §6, ROADMAP §3).  The faults failed and passed alike at
# every count, and the kernel, which failed the mse batch at 16/8 and 32/16
# as several fresh witnesses did, passed every chain at 64/32.
RMS_FACTOR, UNFLAGGED_SHARE = 1.25, 1 / 128
UPDATE_ULPS = 1
STACKED_COPIES, SUM_COPIES = 64, 32
ROW_PARTS = ("latents", "traj", "traj3", "moments")
# each part's allowance and its old largest-element error
PART_RULES = (("latents", P1_ATOL, max_abs), ("traj", P1_ATOL, max_abs),
              ("traj3", P1_ATOL, max_abs), ("scalars", P1_RTOL, scalar_rel),
              ("pgrads", P1_GRAD_REL, grad_rel), ("moments", P1_MOMENT_REL, moment_rel))


@contextlib.contextmanager
def stacked_noise(chain, c, B: int, copies: int):
    """The plain version's noise for ``copies`` stacked copies of a batch of
    ``B`` rows: each copy draws its own rows' noise (``c``: the one batch's
    chain arguments)."""
    names = ("_noise_index", "_noise_index3", "_unpacked_normals")
    saved = {n: getattr(chain, n) for n in names}
    chain._noise_index = lambda _c, _B, dev: tuple(
        t.repeat(copies, 1) for t in saved["_noise_index"](c, B, dev))
    chain._noise_index3 = lambda _c, _B, dev: saved["_noise_index3"](c, B, dev).repeat(copies, 1)
    chain._unpacked_normals = lambda _c, _B, t, dev: saved["_unpacked_normals"](
        c, B, t, dev).repeat(copies, 1)
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(chain, n, fn)


def nudge_ulps(torch, x, ulps: int, generator):
    """``x`` (float32) with each finite nonzero element moved by a whole
    number of ulps drawn uniformly from [-ulps, ulps]."""
    k = torch.randint(-ulps, ulps + 1, x.shape, generator=generator, device=x.device,
                      dtype=torch.int32)
    bits = x.contiguous().view(torch.int32)
    ok = torch.isfinite(x) & ((bits & 0x7FFFFFFF) > ulps)
    return torch.where(ok, (bits + k).view(torch.float32), x)


def keyed_ulps(torch, chain, x, ulps: int, seed: int):
    """``x`` (float32) with each finite nonzero element moved by a whole
    number of ulps in [-ulps, ulps], a hash of its bits and ``seed``."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    k = chain._fmix32((bits + seed) & 0xFFFFFFFF) % (2 * ulps + 1) - ulps
    ok = torch.isfinite(x) & ((bits & 0x7FFFFFFF) > ulps)
    return torch.where(ok, (bits + k).to(torch.int32).view(torch.float32), x)


@contextlib.contextmanager
def jittered_rounding(torch, chain, rows: int, seed: int, params=(), ulps: int = UPDATE_ULPS,
                      keyed: bool = False):
    """The plain version with other rounding at every step, for a batch of
    ``rows`` rows (``params``: the call's parameters, whose weights' reversed
    copies are kept): every f32 ``a @ b`` summed over k in reverse order, and
    the latents, as each step starts, moved by up to ``ulps`` ulps,
    uniform whole ulps drawn anew for every element at every step (another
    rounding of the last update: a fused multiply-add rounds it once where
    the plain version rounds twice).  ``keyed`` (the step rule's witnesses):
    each update's result moved instead, by a hash of its bits and ``seed``,
    so that the state a step stores is the state the next one reads, and a
    chain split into two calls moves as the whole chain does."""
    plain, activation_fn = torch.Tensor.__matmul__, chain.activation_fn
    updates = {n: getattr(chain, n) for n in ("langevin_update", "adam_step")}
    gens, flipped = {}, {}
    weights = {p["w"].data_ptr() for p in params}

    def matmul(a, b):
        if a.dtype != torch.float32 or b.dtype != torch.float32:
            return plain(a, b)
        if b.data_ptr() not in weights:
            return plain(a.flip(-1), b.flip(-2))
        # a weight or its transpose: flipped once, as it stays the same (and
        # stays allocated) through the chain
        key = (b.data_ptr(), tuple(b.shape), b.stride())
        if key not in flipped:
            flipped[key] = b.flip(-2)
        return plain(a.flip(-1), flipped[key])

    def jittered_activation(name):
        act = activation_fn(name)

        def step(X):
            # the chain's activation sees the whole latents once a step,
            # before anything is computed from them
            if X.dim() == 2 and X.shape[0] == rows and X.dtype == torch.float32:
                if X.device not in gens:
                    gens[X.device] = torch.Generator(device=X.device).manual_seed(seed)
                X.copy_(nudge_ulps(torch, X, ulps, gens[X.device]))
            return act(X)
        return step

    def moved(update):
        def run(*args):
            out = update(*args)
            if out.dim() == 2 and out.shape[0] == rows and out.dtype == torch.float32:
                return keyed_ulps(torch, chain, out, ulps, seed)
            return out
        return run

    torch.Tensor.__matmul__ = matmul
    if keyed:
        for n, fn in updates.items():
            setattr(chain, n, moved(fn))
    else:
        chain.activation_fn = jittered_activation
    try:
        yield
    finally:
        torch.Tensor.__matmul__ = plain
        chain.activation_fn = activation_fn
        for n, fn in updates.items():
            setattr(chain, n, fn)


@contextlib.contextmanager
def sums_apart(torch, chain, n: int, B: int):
    """The plain version on ``n`` stacked copies of a batch of ``B`` rows
    with its sums over the batch taken copy by copy: the parameter
    gradients come out as a list of one tuple a copy, each scalar with a
    trailing axis of one sum a copy.  Each such sum of ``_reference`` goes
    through a function patched here: the Hebbian products ``h.T @ e``
    (each copy's rows summed in reverse, as the witnesses' products),
    ``t.sum(dim=0)`` and ``torch.sum(t)`` of a ``[n B, d]`` tensor; the
    flat gradient vector holds a block a copy in each of its pieces."""
    rows = n * B
    matmul, tensor_sum, torch_sum = torch.Tensor.__matmul__, torch.Tensor.sum, torch.sum
    sizes, from_flat = chain._partial_sizes, chain._pgrads_from_flat

    def ours(t):
        return isinstance(t, torch.Tensor) and t.dim() == 2 and t.shape[0] == rows

    def hebbian(a, b):
        # a = h.T: a transposed view whose columns are the stacked rows
        if not (ours(b) and a.dim() == 2 and a.shape[1] == rows and a.stride(0) == 1):
            return matmul(a, b)
        each = a.reshape(a.shape[0], n, B).permute(1, 0, 2)
        return torch.bmm(each.flip(-1), b.reshape(n, B, -1).flip(-2))

    def row_sum(t, *args, **kwargs):
        if ours(t) and (args, kwargs) in (((0,), {}), ((), {"dim": 0})):
            return tensor_sum(t.reshape(n, B, -1), dim=1).reshape(-1)
        return tensor_sum(t, *args, **kwargs)

    def sum_all(t, *args, **kwargs):
        if ours(t) and not args and not kwargs:
            return tensor_sum(t.reshape(n, B, -1), dim=(1, 2))
        return torch_sum(t, *args, **kwargs)

    def scaled(dims):
        return tuple(n * k for k in sizes(dims))

    def per_copy(flat, params, dims):
        pieces = [p.view(n, -1) for p in flat.split(scaled(dims))]
        chain._partial_sizes = sizes
        try:
            return [from_flat(torch.cat([p[k] for p in pieces]), params, dims)
                    for k in range(n)]
        finally:
            chain._partial_sizes = scaled

    torch.Tensor.__matmul__, torch.Tensor.sum, torch.sum = hebbian, row_sum, sum_all
    chain._partial_sizes, chain._pgrads_from_flat = scaled, per_copy
    try:
        yield
    finally:
        torch.Tensor.__matmul__, torch.Tensor.sum, torch.sum = matmul, tensor_sum, torch_sum
        chain._partial_sizes, chain._pgrads_from_flat = sizes, from_flat


class Witnesses:
    """The witnesses of one hold, run when a part first asks for them: the
    plain version on the hold's inputs with other rounding (the row rule's
    block says which runs): ``copies`` stacked copies for the rows and the
    captured scalars, ``sum_copies`` for the sums over the batch, the
    latents moved by up to ``ulps`` ulps a step, the moves drawn from
    ``jitter_seed`` (and the next seed for the sums)."""

    def __init__(self, torch, chain, params, latents, target, seed, kw,
                 copies: int = STACKED_COPIES, sum_copies: int = SUM_COPIES,
                 ulps: int = UPDATE_ULPS, jitter_seed: int = SEED + 40):
        self.torch, self.chain = torch, chain
        self.args, self.kw = (params, latents, target, seed), kw
        self.copies, self.sum_copies, self.ulps = copies, sum_copies, ulps
        self.jitter_seed = jitter_seed
        self._stacked = self._summed = None
        self.seconds = 0.0

    def _timed(self, fn):
        t0 = time.perf_counter()
        out = fn()
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return out

    def stacked(self) -> list:
        """The copies' parts: latents, trajectories and Adam moments; the
        captured scalars recomputed from each copy's trajectory (the last
        step's row, which is not captured, NaN); no gradients."""
        if self._stacked is None:
            self._stacked = self._timed(self._run_stacked)
        return self._stacked

    def _stacks(self, part) -> bool:
        return part in ROW_PARTS or (part == "scalars" and bool(self.kw.get("capture_stride")))

    def _stacked_call(self, n: int, jitter_seed: int, kw, apart: bool = False):
        """The parts of one call of the plain version on ``n`` stacked copies
        of the batch, each copy its own rows' noise and its own moves
        (``apart``: each copy's sums its own)."""
        torch, chain = self.torch, self.chain
        params, latents, target, seed = self.args
        B = latents[0].shape[0]
        c = chain._chain_args(params, latents, target, seed, **kw)
        lat = tuple(x.repeat(n, 1) for x in latents)
        kw_n = dict(kw, **{k: tuple(m.repeat(n, 1) for m in kw[k])
                           for k in ("warm_mu", "warm_nu") if kw.get(k) is not None})
        if kw.get("packed", True):
            kw_n["batch_tile"] = n * B
        tgt = None if target is None else target.repeat(n, 1)
        c_n = chain._chain_args(params, lat, tgt, seed, **kw_n)
        with stacked_noise(chain, c, B, n), \
                jittered_rounding(torch, chain, n * B, jitter_seed, params, self.ulps), \
                (sums_apart(torch, chain, n, B) if apart else contextlib.nullcontext()):
            out = chain._reference(c_n, params, lat, tgt, kw_n.get("warm_mu"),
                                   kw_n.get("warm_nu"))
        return option_parts(out, kw), c

    def _run_stacked(self) -> list:
        torch, chain, kw, n = self.torch, self.chain, self.kw, self.copies
        params, latents, target, _ = self.args
        B = latents[0].shape[0]
        parts, c = self._stacked_call(n, self.jitter_seed, kw)
        copies = []
        for k in range(n):
            rows = slice(k * B, (k + 1) * B)
            one = {"latents": tuple(x[rows] for x in parts["latents"])}
            for name in ("traj", "traj3"):
                if parts.get(name) is not None:
                    one[name] = parts[name][:, rows]
            if parts.get("moments") is not None:
                one["moments"] = tuple(m[rows] for m in parts["moments"])
            if parts.get("traj") is not None and kw.get("return_scalars"):
                loss, energy = chain.traj_scalar_rows(one["traj"], params, target, c,
                                                      one.get("traj3"))
                nan = torch.full((parts["scalars"]["loss"].numel() - loss.numel(),),
                                 float("nan"), dtype=torch.float64, device=loss.device)
                one["scalars"] = {"loss": torch.cat([loss.double(), nan]),
                                  "energy": torch.cat([energy.double(), nan])}
            copies.append(one)
        return copies

    def summed(self) -> list:
        """The parts summed over the batch (gradients, uncaptured scalars)
        of ``sum_copies`` copies, each copy's sums its own."""
        if self._summed is None:
            self._summed = self._timed(self._run_summed)
        return self._summed

    def _run_summed(self) -> list:
        n = self.sum_copies
        kw = {k: v for k, v in self.kw.items() if k != "capture_stride"}
        parts, _ = self._stacked_call(n, self.jitter_seed + 1, kw, apart=True)
        runs = [{} for _ in range(n)]
        for k, one in enumerate(runs):
            if parts["pgrads"] is not None:
                one["pgrads"] = parts["pgrads"][k]
            if parts.get("scalars") is not None:
                # a loss of "none" is one zero for every copy
                one["scalars"] = {name: v[..., k] if v.dim() == 2 else v
                                  for name, v in parts["scalars"].items()}
        return runs

    def of(self, part) -> list:
        """``part`` of every witness run this part is held by."""
        if self._stacks(part):
            return [w[part] for w in self.stacked()]
        return [w[part] for w in self.summed()]


def _flat_rel(torch, tensors, bases, by_entry: bool):
    """Each element's distance from its base, divided by the base tensor's
    largest entry (or, ``by_entry``, by the base entry itself), flattened."""
    out = []
    for a, b in zip(tensors, bases):
        b = b.double()
        scale = b.abs().clamp_min(1e-30) if by_entry else b.abs().max().clamp_min(1e-30)
        out.append(((a.double() - b).abs() / scale).reshape(-1))
    return torch.cat(out)


def unit_distances(torch, part, x, base):
    """(each unit's distance from ``base`` [N], every element's [M]) of one
    part, in float64.  Rows: latents and moments (each moment tensor relative
    to its base's largest entry) by batch row, a trajectory by batch row
    across its steps; entries: gradients relative to their tensor's largest
    entry, scalars relative to themselves."""
    if part in ("traj", "traj3"):
        diff = (x.double() - base.double()).abs()
        return diff.amax(dim=(0, 2)), diff.reshape(-1)
    if part == "latents":
        diff = torch.cat([(a.double() - b.double()).abs() for a, b in zip(x, base)], dim=1)
        return diff.amax(dim=1), diff.reshape(-1)
    if part == "moments":
        diff = torch.cat([(a.double() - b.double()).abs() / b.double().abs().max().clamp_min(1e-30)
                          for a, b in zip(x, base)], dim=1)
        return diff.amax(dim=1), diff.reshape(-1)
    if part == "pgrads":
        flat = _flat_rel(torch, [g[k] for g in x for k in ("w", "b")],
                         [g[k] for g in base for k in ("w", "b")], by_entry=False)
        return flat, flat
    flat = _flat_rel(torch, [x[k] for k in ("loss", "energy")],
                     [base[k] for k in ("loss", "energy")], by_entry=True)
    return flat, flat


def entry_values(torch, part, x):
    """The entries of a gradient or scalars part, flattened (for their
    signs)."""
    if part == "pgrads":
        return torch.cat([g[k].double().reshape(-1) for g in x for k in ("w", "b")])
    return torch.cat([x[k].double().reshape(-1) for k in ("loss", "energy")])


def _rms(torch, elems) -> float:
    return float(torch.nanmean(elems * elems) ** 0.5)


def unit_rule(torch, part, got, ref, base, allow, witnesses) -> dict:
    """The row rule on one part (see its block above): ``got``, ``ref`` and
    ``base`` (the float64 reference, or ``ref`` itself) as parts; the
    witnesses a ``Witnesses``.  Returns what it found: ``ok``, and the
    numbers its line prints."""
    d_got, e_got = unit_distances(torch, part, got, base)
    d_ref, e_ref = unit_distances(torch, part, ref, base)
    n = d_got.numel()
    strict = d_got <= d_ref + allow
    out = dict(units=n, beyond=int((~strict).sum()), witnessed=False, ok=bool(strict.all()))
    if out["ok"]:
        return out
    runs = witnesses.of(part)
    out["witnessed"] = True
    dist = [unit_distances(torch, part, w, base) for w in runs]
    # where the witnesses part from the plain f32 version (NaN: a unit no
    # witness computes, which counts as agreeing)
    parted = torch.stack([d_ref] + [torch.nan_to_num(unit_distances(torch, part, w, ref)[0],
                                                     nan=0.0) for w in runs]).amax(dim=0)
    sensitive = parted > allow
    if part not in ROW_PARTS:
        signs = torch.stack([torch.sign(entry_values(torch, part, v)) for v in [ref] + runs])
        signs = torch.nan_to_num(signs, nan=0.0)
        sensitive |= (signs.amax(dim=0) > 0) & (signs.amin(dim=0) < 0)
    rms_got = float(torch.mean(e_got * e_got) ** 0.5)
    rms_worst = max([_rms(torch, e_ref)] + [_rms(torch, e) for _, e in dist])
    set_aside = ~strict & sensitive
    n_sens, unexcused = int(sensitive.sum()), int((~strict & ~sensitive).sum())
    out.update(ok=(unexcused <= n_sens * UNFLAGGED_SHARE
                   and bool(torch.isfinite(d_got).all())
                   and rms_got <= RMS_FACTOR * rms_worst + allow),
               witnesses=len(runs), sensitive=n_sens, set_aside=int(set_aside.sum()),
               unexcused=unexcused, rms=rms_got, rms_worst=rms_worst,
               spread=float(parted.max()))
    return out


def rule_text(part, allow, old, new) -> str:
    """One part's line: the old rule's verdict beside the row rule's."""
    e, e64, p64 = old
    text = (f"{part}: kernel-plain {e:.3e}; old rule (largest element) "
            f"{'holds' if e64 <= p64 + allow else 'FAILS'} (from the reference: kernel "
            f"{e64:.3e}, plain f32 {p64:.3e}, allowance {allow}); row rule "
            f"{'holds' if new['ok'] else 'FAILS'}: {new['units']} units, "
            f"{new['beyond']} beyond the plain f32 version's distance + allowance")
    if new["witnessed"]:
        text += (f", {new['witnesses']} witnesses part on {new['sensitive']} (spread "
                 f"{new['spread']:.3e}), "
                 f"set aside {new['set_aside']}, unflagged {new['unexcused']} (at most "
                 f"{int(new['sensitive'] * UNFLAGGED_SHARE)}); RMS from the "
                 f"reference: kernel {new['rms']:.3e}, worst correct order "
                 f"{new['rms_worst']:.3e} (limit x{RMS_FACTOR})")
    return text


def doubled(kw):
    """A call's options with its Adam moments in float64."""
    return {k: tuple(m.double() for m in v) if k in ("warm_mu", "warm_nu") else v
            for k, v in kw.items()}


def pad_lanes_of(torch, chain, dims, device):
    """The pad lanes of the aligned packed layout of ``dims``' latents."""
    _, offsets, width = chain.aligned_layout(dims[:3])
    lanes = torch.ones(width, dtype=torch.bool, device=device)
    for o, d in zip(offsets, dims[:3]):
        lanes[o : o + d] = False
    return lanes


def row_hold(torch, chain, name, got, ref, ref64, witnesses, kw, dims=FID):
    """Hold every part of a result by the row rule: (the report, what
    failed, what the old largest-element rule failed).  ``ref64`` None holds
    it against the plain f32 version ``ref`` itself; ``witnesses`` is a
    ``Witnesses`` on the same inputs."""
    gp, rp = option_parts(got, kw), option_parts(ref, kw)
    bp = rp if ref64 is None else option_parts(ref64, kw)
    line, failed, old_failed = [], [], []
    for part, allow, err in PART_RULES:
        if part not in gp or gp[part] is None:
            continue
        if part in ("traj", "traj3"):
            pads = (gp[part][:, :, pad_lanes_of(torch, chain, dims, gp[part].device)]
                    if part == "traj" else gp[part][:, :, dims[3]:])
            if bool(pads.any()):
                failed.append(f"{name}: pad lanes of the {part} captures are not 0")
            a, b, c = ([x] for x in (gp[part], rp[part], bp[part]))
        else:
            a, b, c = gp[part], rp[part], bp[part]
        old = (err(a, b), err(a, c), err(b, c))
        if not old[1] <= old[2] + allow:
            old_failed.append(f"{name}: {part}")
        new = unit_rule(torch, part, gp[part], rp[part], bp[part], allow, witnesses)
        line.append(rule_text(part, allow, old, new))
        if not new["ok"]:
            failed.append(f"{name}: {part} by the row rule ({new.get('unexcused', new['beyond'])} "
                          f"units unflagged, RMS {new.get('rms', 0.0):.3e})")
    if witnesses.seconds:
        line.append(f"witnesses {witnesses.seconds:.2f} s")
    return "; ".join(line), failed, old_failed


# ----------------------------------------------------------- the step rule
# Every f32 hold of a chain that amplifies rounding (phase 1's options, tanh
# and output-PC cases; phase 2's chains (a) and (c); phase 3's mse batch
# and its faults; phase 4's figure-2 chains; phase 5's and phase 8's
# replays and tanh (a)) is the step rule (``step_rule.py``, whose docstring
# derives its bound): the kernel launched again with every step captured,
# and every step held, in float64 from the kernel's own state, to a bound
# that holds for any summation order, at the chain's full length.  The
# kernel's distance from the plain f32 chain is printed beside it as
# information, not as a verdict: at the end for chains of at most
# PLAIN_MAX_STEPS steps, else at that step (from the kernel's captures).
# The row rule above stays for ``scripts/rule_calibration.py``; the smoke
# calls it no longer.
PLAIN_MAX_STEPS = 500


def kernel_state(cap, n: int, kw):
    """The held chain's latents after ``n`` of its steps, from its captures:
    ``([B, N] float64, x3 or None)``."""
    warm_T = kw.get("warm_T", 0)
    ph = cap.phases[0] if n <= warm_T and warm_T else cap.phases[-1]
    t = n if ph.kind == "warm" else n - warm_T
    lat = ph.parts["latents"]   # the widths; x3's, where there is one, last
    X, X3 = ph.states(t, t, tuple(x.shape[1] for x in lat) + (0,) * (4 - len(lat)))
    return X[0], None if X3 is None else X3[0]


def plain_distance(torch, chain, cap, inputs, kw, ref=None):
    """The kernel's distance from the plain f32 chain on the same inputs
    (information, not a verdict): (the largest |d|, each row's largest, the
    steps after which it is taken).  ``ref``: the plain version's result at
    full length, else it runs here, cut to PLAIN_MAX_STEPS steps."""
    warm_T, T = kw.get("warm_T", 0), kw["T"]
    n = warm_T + T
    if ref is None:
        n = min(n, PLAIN_MAX_STEPS)
        own = ("capture_stride", "scalar_stride", "return_scalars", "emit_warm_opt_state",
               "with_pgrads", "warm_pgrads")
        cut = dict({k: v for k, v in kw.items() if k not in own},
                   warm_T=min(warm_T, n), T=n - min(warm_T, n))
        ref = chain.mcpc_chain_reference(*inputs, **cut)
    X, X3 = kernel_state(cap, n, kw)
    lat = ref[0]
    d = (X - torch.cat([x.double() for x in lat[:3]], dim=1)).abs().amax(dim=1)
    if X3 is not None:
        d = torch.maximum(d, (X3 - lat[3].double()).abs().amax(dim=1))
    return float(d.max()), d, n


def step_hold(torch, chain, name, run, inputs, kw, sincos_err, original=None, ref=None,
              keep=False):
    """Hold a chain call by the step rule (the block above): ``run`` the
    chain (the kernel's wrapper, or a fault through its arguments),
    ``original`` the call's parts (None: the call is made here), ``ref``
    the plain f32 version's result on the same inputs at full length (None:
    run here, cut to PLAIN_MAX_STEPS).  Returns (the report, what failed,
    the verdict, the capture if ``keep`` else None, the rows' distances
    from the plain f32 chain)."""
    sr = _step_rule()
    cap = sr.capture(run, inputs, kw, original)
    verdict = sr.hold(cap, inputs, kw, sincos_err=sincos_err)
    far, rows, n = plain_distance(torch, chain, cap, inputs, kw, ref)
    text = (sr.verdict_text(verdict) + f"; the kernel's distance from the plain f32 chain "
            f"after {n} of {kw.get('warm_T', 0) + kw['T']} steps {far:.3e} (information)")
    failed = []
    if not verdict["ok"]:
        bad = [f"{p} {r['ratio']:.3g} at {r['at']}" for p, r in verdict["parts"].items()
               if not r["ok"]] + [f"{w} differ" for w, ok in verdict["bits"] if not ok]
        failed.append(f"{name}: the step rule fails: " + "; ".join(bad))
    grad_text, grad_failed = grad_hold(name, verdict, cap.held["pgrads"])
    return text + grad_text, failed + grad_failed, verdict, (cap if keep else None), rows


def grad_hold(name, verdict, pgrads) -> tuple:
    """The gradient sums ``pgrads`` within P1_GRAD_REL of each tensor's
    largest entry from the float64 sums over the held chain's own states
    (``verdict``, a ``step_rule.hold``).  (the report, what failed)."""
    if verdict["grads64"] is None:
        return "", []
    far, where = _step_rule().grad_distance(verdict, pgrads)
    text = (f"; gradients from the float64 sums over the kernel's own states: {far:.3e} of "
            f"the largest entry, at g{where} (allowance {P1_GRAD_REL})")
    if far <= P1_GRAD_REL:
        return text, []
    return text, [f"{name}: gradient g{where} {far:.3e} of its largest entry from the float64 "
                  f"sums over the kernel's own states (allowance {P1_GRAD_REL})"]


def skip_holds(name, cap, inputs, kw, rows, sincos_err) -> tuple:
    """Both one-row skips injected into the kernel's captures (``cap``):
    one row's update of the first phase's middle step skipped, in the row
    nearest to and in the row furthest from the plain f32 chain (``rows``,
    each row's distance), each of which must fail the step rule.  (the
    report, what failed)."""
    sr = _step_rule()
    step = cap.phases[0].steps // 2
    texts, failed = [], []
    for label, row in (("quiet", int(rows.argmin())), ("busy", int(rows.argmax()))):
        v = sr.hold(sr.skip_row(cap, 0, step, row), inputs, kw, sincos_err=sincos_err)
        part, worst = max(v["parts"].items(), key=lambda p: p[1]["ratio"])
        texts.append(f"{label} row {row} at step {step}: step rule "
                     f"{'holds' if v['ok'] else 'FAILS'} ({part} {worst['ratio']:.3g} at "
                     f"{worst['at']})")
        if v["ok"]:
            failed.append(f"{name}: row {row}'s update skipped at step {step} ({label}) passes "
                          f"the step rule")
    return "; ".join(texts), failed


def hold_replay(torch, chain, phase, label, rec, tag, sincos_err) -> list:
    """Hold a recorded chain call (a ``ChainRecorder`` entry) by the step
    rule at its full length: the kernel launched again on the call's inputs
    with every step captured must end with the call's bits, and every step
    is held from its own state.  Prints its line; returns what failed."""
    kw = rec["kw"]
    text, failed, *_ = step_hold(torch, chain, label, chain.mcpc_chain, rec["inputs"], kw,
                                 sincos_err, original=rec["parts"])
    shown = {k: v for k, v in kw.items() if k not in ("warm_mu", "warm_nu")}
    print(f"phase {phase}: {label}: options {shown}; {text} {tag}")
    return failed


def param_rule(torch, param_opt, apply_updates, p0_64, p1, grads64, scale,
               orders=()) -> tuple:
    """Phase 3's rule on the parameters after one Adam step: ``p1`` against
    the step taken in float64 from ``p0_64`` with the float64 plain version's
    gradient sums ``grads64`` divided by ``scale``, on the entries whose
    gradient is at least P3_CLEAR of its tensor's largest (Adam's first step
    is lr * sign(g)).  Of those, an entry whose sign one of ``orders`` (the
    gradients of correct orders) turns is set aside.  Returns (the largest
    difference on the rest, the clear entries, all entries, the set-aside
    ones)."""
    updates64, _ = param_opt.update(tuple({k: v / scale for k, v in gr.items()}
                                          for gr in grads64), param_opt.init(p0_64), p0_64)
    want = apply_updates(p0_64, updates64)
    worst, n_clear, total, n_aside = 0.0, 0, 0, 0
    for i, (new, exact, gr) in enumerate(zip(p1, want, grads64)):
        for k in ("w", "b"):
            clear = gr[k].abs() >= P3_CLEAR * gr[k].abs().max()
            n_clear += int(clear.sum())
            total += clear.numel()
            turned = torch.zeros_like(clear)
            for o in orders:
                turned |= clear & (torch.sign(o[i][k].double()) != torch.sign(gr[k]))
            n_aside += int(turned.sum())
            held = clear & ~turned
            if bool(held.any()):
                worst = max(worst, float((new[k].double() - exact[k])[held].abs().max()))
    return worst, n_clear, total, n_aside


def eval_config(port, dims, activation, lr) -> dict:
    """Table 1's MSE and ML configurations (experiments/table_1.py of the
    JAX package): 250 Adam MAP steps at ``lr``, Bernoulli, B=1024."""
    return {"batch_size_train": 128, "batch_size_val": 1024, "batch_size_test": 1024,
            "input_size": dims[0], "hidden_size": dims[1], "hidden2_size": dims[2],
            "output_size": dims[3], "loss_fn": port.bernoulli_fn,
            "activation_fn": activation, "input_var": None, "T_pc": 250,
            "optimizer_x_fn_pc": "adam", "optimizer_x_kwargs_pc": {"lr": lr}}


def joint_sampler_model(port, here: str, dev):
    """Phase 5's output-PC joint sampler (figure 3's recipe at MNIST width):
    its configuration and its model, with ``mcpc_fid_3``'s weights."""
    from montecarlopredictivecoding_tpu_torch.models import get_model
    from montecarlopredictivecoding_tpu_torch.utils import load_checkpoint

    cfg = dict(MODEL_CONFIG, loss_fn=port.zero_fn, T_pc=250, optimizer_x_fn_pc="adam",
               optimizer_x_kwargs_pc={"lr": 0.7}, mixing=0, sampling=10000,
               optimizer_x_kwargs_mcpc={"lr": JOINT_LR})
    joint = get_model(cfg, SEED, device=dev, output_pc=port.PC(
        energy_fn=port.scaled_gaussian_energy(1.0)))
    joint.params = load_checkpoint(os.path.join(here, "models", "mcpc_fid_3.msgpack"),
                                   joint.params, device=dev)
    return cfg, joint


def start_phase9_ranks(here: str):
    """Phase 9's two ranks, spawned as phase 0 starts so that they import
    and reach the card while nvcc runs; daemons, so they end with this
    process.  Each waits for ``go`` in ``tmp`` (``phase9_rank``).  Returns
    (the processes, ``tmp``)."""
    os.makedirs(os.path.join(here, "build", "chip_smoke"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="phase9_", dir=os.path.join(here, "build", "chip_smoke"))
    spawn = multiprocessing.get_context("spawn")
    ranks = [spawn.Process(target=phase9_rank, args=(r, here, tmp), daemon=True)
             for r in range(2)]
    for proc in ranks:
        proc.start()
    return ranks, tmp


def phase9_rank(rank: int, here: str, tmp: str) -> None:
    """One of phase 9's two ranks, a spawned process on cuda:0 in a gloo
    group of 2 (``file://`` rendezvous in ``tmp``): the dp chain without and
    with noise against ``mcpc_chain``, ``train_mcpc(mesh=2)`` and the dry
    run in this group.  It loads the port and reaches the card, then waits
    until the parent writes ``tmp/go`` (or ends).  Prints its lines, raises
    on a failed check (a non-zero exit), and leaves ``rank<r>.pt`` in
    ``tmp``: the trained parameters and the launches of its dp paths.  The
    synthetic MNIST set is the parent's, from ``tmp/mnist.npz`` (the same
    seeds make the same arrays; reading them saves making them)."""
    # below nvcc's priority while it builds (the parent waits for this
    # rank once it says go, so the rank's own work is not slowed)
    os.nice(10)
    import torch
    import torch.distributed as dist

    sys.path.insert(0, here)
    for name in ("dryrun", "experiments.train_mnist", "parallel", "models"):
        importlib.import_module("montecarlopredictivecoding_tpu_torch." + name)
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda")
    parent = os.getppid()
    while not os.path.exists(os.path.join(tmp, "go")):
        if os.getppid() != parent:
            return
        time.sleep(0.05)
    mnist = importlib.import_module("montecarlopredictivecoding_tpu_torch.data.mnist")
    with np.load(os.path.join(tmp, "mnist.npz")) as f:
        arrays = (f["train_x"], f["train_y"]), (f["test_x"], f["test_y"])
    mnist._synthetic_mnist = lambda n_train, n_test, seed=0: arrays
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rendezvous"),
                            rank=rank, world_size=2)
    try:
        out = phase9_rank_body(torch, rank, tmp)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


def phase9_rank_body(torch, rank: int, tmp: str) -> dict:
    from montecarlopredictivecoding_tpu_torch import dryrun
    from montecarlopredictivecoding_tpu_torch.data import get_mnist_data
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
    from montecarlopredictivecoding_tpu_torch.models import get_model
    from montecarlopredictivecoding_tpu_torch.parallel import make_dp_fused_chain, make_mesh, place_dp
    from montecarlopredictivecoding_tpu_torch.parallel.fused_dp import (
        all_reduce_tree, shard_rows, shard_seed)

    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    dev = torch.device("cuda", 0)
    tag = f"[{card_line()}]"
    launched = [0, 0]

    def counted(fn):
        """Run one dp path with the counts zeroed just before and read just
        after, and add them up."""
        chain.mcpc_chain.launches = chain.sum_block_partials.launches = 0
        out = fn()
        torch.cuda.synchronize()
        launched[0] += chain.mcpc_chain.launches
        launched[1] += chain.sum_block_partials.launches
        return out

    def say(line):
        print(f"phase 9 [rank {rank}]: {line}", flush=True)

    config = train_mnist.mcpc_training_config()
    gen = get_model(config, SEED, device=dev)
    train, _, _ = get_mnist_data(config, device=dev)
    data = next(iter(train))[0]
    latents = gen.model.init_latents(
        gen.params, torch.zeros(BATCH, config["input_size"], device=dev),
        torch.Generator().manual_seed(SEED + 9))
    mesh = make_mesh(data=2, model=1, device=dev)
    rows = shard_rows(mesh, BATCH)
    placed = place_dp(mesh, gen.params, latents, data)

    # without noise: the rows evolve alone (a row's arithmetic does not
    # depend on the others), the gradients are summed in another order than
    # the whole batch's kernel call sums them.  Held against that call, not
    # float64: after 250 Adam steps at lr 0.7 two f32 summation orders part
    # by up to 0.1 (the plain version on the CPU, on 128 rows against 256)
    quiet = train_mnist.chain_options(config, None)
    new, pgrads = counted(lambda: make_dp_fused_chain(gen.model, mesh, **quiet)(*placed, SEED))
    whole = chain.mcpc_chain(gen.params, latents, data, SEED, **quiet)
    mine = tuple(x[rows] for x in whole[0])
    bits = all(torch.equal(a, b) for a, b in zip(new, mine))
    dx, g = max_abs(new, mine), grad_rel(pgrads, whole[1])
    say(f"make_dp_fused_chain, noise off, rows {rows.start}-{rows.stop - 1} of {BATCH}: latents "
        f"{dx:.3e} from the whole batch's kernel call (allowance {P1_ATOL}; bit-equal: {bits}), "
        f"summed gradients {g:.3e} of each tensor's largest from its (allowance "
        f"{P1_GRAD_REL}) {tag}")
    check(dx <= P1_ATOL, f"phase 9 rank {rank}: dp latents {dx} from the whole batch's")
    check(g <= P1_GRAD_REL, f"phase 9 rank {rank}: dp gradients {g} from the whole batch's")

    # with noise at a seed whose shard seed wraps: this rank's call is
    # mcpc_chain on its shard with the shard seed
    noisy = train_mnist.chain_options(config, 2.0)
    new2, pgrads2 = counted(
        lambda: make_dp_fused_chain(gen.model, mesh, **noisy)(*placed, DP_WRAP_SEED))
    seed_r = shard_seed(DP_WRAP_SEED, rank)
    own = chain.mcpc_chain(*placed, seed_r, **noisy)
    own_sum = all_reduce_tree(own[1], mesh.get_group("data"))
    same = (all(torch.equal(a, b) for a, b in zip(new2, own[0]))
            and grads_equal(torch, pgrads2, own_sum))
    say(f"noise on, seed {DP_WRAP_SEED}: shard seed {seed_r}; latents and summed gradients "
        f"bit-equal to mcpc_chain on the shard with it: {same}")
    check(same, f"phase 9 rank {rank}: the noisy shard differs from mcpc_chain on it")
    check(rank == 0 or seed_r < 0, "phase 9: rank 1's shard seed did not wrap")

    # train_mcpc(mesh=2), each batch's step kept; afterwards each step again
    # on one rank's worth of work: the two shards' chains with their shard
    # seeds, their gradients added (a sum of two is the same bits in either
    # order, as the all-reduce of two ranks gives it) and param_step over
    # the global batch must give the step's bits
    recorded = []
    dp_step = train_mnist.one_batch_dp

    def recording(params, opt_state, latents, seed, data, **kw):
        out = dp_step(params, opt_state, latents, seed, data, **kw)
        recorded.append((params, opt_state, latents, seed, data, out[0]))
        return out

    train_mnist.one_batch_dp = recording
    try:
        trained = counted(lambda: train_mnist.train_mcpc(
            1, os.path.join(tmp, "dp"), batches_per_epoch=DP_W2_BATCHES, log=False,
            langevin_var=None, mesh=2, device=dev))
    finally:
        train_mnist.one_batch_dp = dp_step
    exact = len(recorded) == DP_W2_BATCHES
    for params, opt_state, lat, seed, data, stepped in recorded:
        halves = [chain.mcpc_chain(params, tuple(x[r * BATCH // 2:(r + 1) * BATCH // 2]
                                                 for x in lat),
                                   data[r * BATCH // 2:(r + 1) * BATCH // 2],
                                   shard_seed(seed, r), **quiet)[1] for r in range(2)]
        summed = tuple({k: a[k] + b[k] for k in a} for a, b in zip(*halves))
        want = train_mnist.param_step(params, opt_state, summed, data.shape[0], config=config)[0]
        exact = exact and all(torch.equal(p[k], q[k]) for p, q in zip(stepped, want)
                              for k in ("w", "b"))
    say(f"train_mcpc(mesh=2), {DP_W2_BATCHES} batches without noise: each step bit-equal to "
        f"the two shards' chains on one rank, their gradients added, and param_step over the "
        f"global batch: {exact}")
    check(exact, f"phase 9 rank {rank}: a train_mcpc(mesh=2) step is not the shards' sum")
    counted(lambda: dryrun.dryrun_multichip(2, "cuda"))
    return {"params": [{k: v.cpu() for k, v in p.items()} for p in trained.params],
            "launches": launched}


def run_phase9(torch, here: str, dev, tag: str, zero_counts, read_counts, ranks,
               tmp9: str) -> list:
    """Phase 9: data-parallel training at world sizes 1 and 2 (``ranks``:
    the two waiting rank processes, ``tmp9`` their directory;
    ``start_phase9_ranks``), the native loader, observability and the dry
    run.  Returns the launch counts of its main paths, as ``read_counts``
    gives them."""
    import torch.distributed as dist
    from torch.autograd import DeviceType

    from montecarlopredictivecoding_tpu_torch.core.trainer import LangevinStep
    from montecarlopredictivecoding_tpu_torch.data import get_mnist_data, native_loader
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
    from montecarlopredictivecoding_tpu_torch.models import (
        get_mcpc_trainer, get_model, get_pc_trainer)
    from montecarlopredictivecoding_tpu_torch.utils import (
        ProgressLogger, energy_absorption_report, profile_trace)

    config9 = train_mnist.mcpc_training_config()

    def same_params(pa, pb) -> bool:
        return all(torch.equal(a[k], b[k]) for a, b in zip(pa, pb) for k in ("w", "b"))

    # (1) world size 1 under NCCL in this process: train_mcpc(mesh=1) beside
    # train_mcpc(), each batch's step timed (CUDA events and the host clock)
    step_ms = {"one_batch": [], "one_batch_dp": []}
    step_host_ms = {"one_batch": [], "one_batch_dp": []}
    steps = {name: getattr(train_mnist, name) for name in step_ms}

    def timed_step(name):
        def run(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t_host = time.perf_counter()
            start.record()
            out = steps[name](*args, **kw)
            end.record()
            end.synchronize()
            step_host_ms[name].append(1e3 * (time.perf_counter() - t_host))
            step_ms[name].append(start.elapsed_time(end))
            return out
        return run

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp9, "rendezvous"),
                            rank=0, world_size=1)
    try:
        for name in steps:
            setattr(train_mnist, name, timed_step(name))
        zero_counts()
        gen_dp = train_mnist.train_mcpc(1, os.path.join(tmp9, "mesh1"), log=False, mesh=1,
                                        batches_per_epoch=DP_W1_BATCHES, device=dev)
        gen_one = train_mnist.train_mcpc(1, os.path.join(tmp9, "single"), log=False,
                                         batches_per_epoch=DP_W1_BATCHES, device=dev)
        torch.cuda.synchronize()
        counts9 = read_counts()
    finally:
        for name, fn in steps.items():
            setattr(train_mnist, name, fn)
        dist.destroy_process_group()
    identical = same_params(gen_dp.params, gen_one.params)
    print(f"phase 9: world size 1 (NCCL): main path launches over 2 x {DP_W1_BATCHES} batches: "
          f"mcpc_chain {counts9[0]}, sum_block_partials {counts9[2]}; train_mcpc(mesh=1) "
          f"bit-identical to train_mcpc(), noise on: {identical}")
    check(identical, "phase 9: train_mcpc(mesh=1) differs from train_mcpc()")
    check(counts9[0] == counts9[2] == 2 * DP_W1_BATCHES,
          f"phase 9: {counts9[0]} chain launches for 2 x {DP_W1_BATCHES} batches")
    ms9 = {name: (statistics.median(step_ms[name][1:]), statistics.median(step_host_ms[name][1:]))
           for name in steps}
    print(f"phase 9: a batch's step (median of {DP_W1_BATCHES - 1} after the first; CUDA "
          f"events, host clock): one_batch_dp {ms9['one_batch_dp'][0]:.3f}, "
          f"{ms9['one_batch_dp'][1]:.3f} ms; one_batch {ms9['one_batch'][0]:.3f}, "
          f"{ms9['one_batch'][1]:.3f} ms; the dp wrapper's cost "
          f"{ms9['one_batch_dp'][0] - ms9['one_batch'][0]:.3f} ms (events) {tag}")

    # (2) world size 2: two ranks on this card under gloo, against the
    # single-device run without noise
    ref_grads = []
    param_step = train_mnist.param_step

    def recording(params, opt_state, pgrads, batch_size, **kw):
        ref_grads.append([{k: v.clone() for k, v in g.items()} for g in pgrads])
        return param_step(params, opt_state, pgrads, batch_size, **kw)

    train_mnist.param_step = recording
    try:
        zero_counts()
        gen_ref = train_mnist.train_mcpc(1, os.path.join(tmp9, "reference"), log=False,
                                         batches_per_epoch=DP_W2_BATCHES, langevin_var=None,
                                         device=dev)
        torch.cuda.synchronize()
        counts9 = [a + b for a, b in zip(counts9, read_counts())]
    finally:
        train_mnist.param_step = param_step
    # the entries whose gradient is at least P3_CLEAR of its tensor's largest
    # in every batch: elsewhere Adam's first steps follow the rounding of
    # the gradient sums (lr * sign(g)), which the two runs take in other
    # orders, and a step may differ by up to 2 * lr
    clear = clear_entries(torch, ref_grads)
    t9 = time.perf_counter()
    mnist = importlib.import_module("montecarlopredictivecoding_tpu_torch.data.mnist")
    (train_x, train_y), (test_x, test_y) = mnist._synthetic_mnist(60000, 10000)
    np.savez(os.path.join(tmp9, "mnist.npz"), train_x=train_x, train_y=train_y,
             test_x=test_x, test_y=test_y)
    open(os.path.join(tmp9, "go"), "w").close()
    try:
        for proc in ranks:
            proc.join(DP_RANK_TIMEOUT_S)
    finally:
        for proc in ranks:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    codes = [proc.exitcode for proc in ranks]
    check(codes == [0, 0], f"phase 9: the world-size-2 ranks exited with {codes}")
    outs = [torch.load(os.path.join(tmp9, f"rank{r}.pt")) for r in range(2)]
    rank_launches = [sum(o["launches"][i] for o in outs) for i in range(2)]
    counts9 = [counts9[0] + rank_launches[0], counts9[1], counts9[2] + rank_launches[1],
               counts9[3], counts9[4]]
    check(same_params(outs[0]["params"], outs[1]["params"]),
          "phase 9: the two ranks' parameters differ")
    far_all, far_clear, n_clear, n_all = dp_rule(gen_ref.params, outs[0]["params"], clear)
    print(f"phase 9: world size 2 (gloo on cuda:0, 2 ranks spawned in phase 0, "
          f"{time.perf_counter() - t9:.1f} s from their go): launches of the dp paths "
          f"mcpc_chain {rank_launches[0]}, sum_block_partials {rank_launches[1]}; "
          f"train_mcpc(mesh=2), {DP_W2_BATCHES} batches without noise, against train_mcpc() "
          f"by the JAX test's rule {DP_QUANTILE}, per tensor (w, b of each layer): on every "
          f"entry {far_all}; on the {n_clear} of {n_all} entries whose gradient is at least "
          f"{P3_CLEAR} of its tensor's largest in every batch {far_clear}")
    check(not any(far_clear),
          f"phase 9: train_mcpc(mesh=2) against train_mcpc() where the gradients are clear: "
          f"{far_clear}")

    # (3) the native loader: an IDX file of LOADER_ROWS images, read and
    # gathered natively and by numpy, and an epoch of shuffled batches
    check(native_loader.native_available(), "phase 9: the native loader did not build")
    rng9 = np.random.RandomState(SEED)
    images = rng9.randint(0, 256, (LOADER_ROWS, 28, 28), dtype=np.uint8)
    idx_path = os.path.join(tmp9, "train-images-idx3-ubyte")
    with open(idx_path, "wb") as f:
        f.write(struct.pack(">HBB3I", 0, 0x08, 3, *images.shape))
        f.write(images.tobytes())
    t_read = time.perf_counter()
    native_images = native_loader.read_idx_native(idx_path)
    t_read, t_py = time.perf_counter() - t_read, time.perf_counter()
    with open(idx_path, "rb") as f:
        f.read(16)
        numpy_images = np.frombuffer(f.read(), dtype=np.uint8).reshape(images.shape)
    t_py = time.perf_counter() - t_py
    check(np.array_equal(native_images, images) and np.array_equal(numpy_images, images),
          "phase 9: the IDX file reads back wrong")
    # x * (1/255) in float32 against numpy's x / 255: the JAX test's 1e-7
    flat = native_loader.preprocess_images(native_images.reshape(LOADER_ROWS, -1))
    scale_err = float(np.abs(flat - native_images.reshape(LOADER_ROWS, -1) / np.float32(255)).max())
    check(scale_err <= 1e-7, f"phase 9: preprocess_images {scale_err} from numpy's")
    order = rng9.permutation(LOADER_ROWS)
    starts = range(0, LOADER_ROWS, BATCH)
    for s0 in (starts[0], starts[-1]):
        check(np.array_equal(native_loader.gather_batch(flat, order[s0:s0 + BATCH]),
                             flat[order[s0:s0 + BATCH]]), "phase 9: gather_batch differs")
    epoch_s = {}
    for way, gather in (("native", native_loader.gather_batch), ("numpy", lambda d, i: d[i]),
                        ("native again", native_loader.gather_batch),
                        ("numpy again", lambda d, i: d[i])):
        t_epoch = time.perf_counter()
        for s0 in starts:
            gather(flat, order[s0:s0 + BATCH])
        epoch_s[way] = time.perf_counter() - t_epoch
    print(f"phase 9: native loader ({native_loader.library_path().name}): an IDX file of "
          f"{LOADER_ROWS} x 28 x 28 read in {1e3 * t_read:.1f} ms (numpy {1e3 * t_py:.1f} ms), "
          f"equal; scaled to [0, 1] {scale_err:.1e} from numpy's; an epoch of {len(starts)} shuffled batches of {BATCH} rows gathered in "
          + ", ".join(f"{way} {1e3 * v:.1f} ms" for way, v in epoch_s.items())
          + f" (the card machine's CPU) {tag}")

    # (4) observability: trainer-path batches (a PC warm start, then the
    # MCPC trainer) through ProgressLogger, the first under the profiler
    gen_obs = get_model(config9, SEED, device=dev)
    warm_obs = get_pc_trainer(gen_obs, config9, is_mcpc=True, training=True)
    mc_obs = get_mcpc_trainer(gen_obs, config9, training=True)
    train9, _, _ = get_mnist_data(config9, device=dev)
    logger = ProgressLogger(prefix="phase 9: ProgressLogger ")
    per_batch = []

    def trainer_batch(batch):
        """(the PC warm start's results, the MCPC trainer's), every step"""
        pseudo9 = torch.zeros((batch.shape[0], config9["input_size"]), device=dev)
        warm = warm_obs.train_on_batch(pseudo9, loss_fn=config9["loss_fn"],
                                       loss_fn_kwargs={"_target": batch})
        res = mc_obs.train_on_batch(pseudo9, loss_fn=config9["loss_fn"],
                                    loss_fn_kwargs={"_target": batch},
                                    callback_after_t=LangevinStep(var=2.0),
                                    is_sample_x_at_batch_start=False)
        torch.cuda.synchronize()
        return warm, res

    zero_counts()
    for i, (batch, _) in enumerate(train9):
        if i >= OBS_BATCHES:
            break
        if i == 0:
            with profile_trace(os.path.join(here, "build", "chip_smoke", "profile")) as prof:
                warm, res = trainer_batch(batch)
        else:
            warm, res = trainer_batch(batch)
        logger(res, T=config9["T_pc"] + config9["mixing"] + config9["sampling"])
        per_batch.append(warm)
    counts_obs = read_counts()
    counts9 = [a + b for a, b in zip(counts9, counts_obs)]
    check(counts_obs[0] == 2 * OBS_BATCHES and len(logger.history) == OBS_BATCHES,
          f"phase 9: {counts_obs[0]} chain launches for {OBS_BATCHES} trainer-path batches")
    with open(prof.trace_path) as f:
        trace_events = json.load(f)["traceEvents"]

    def device_ms(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0)) / 1e3

    top = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                 key=device_ms, reverse=True)[:5]
    check(bool(top) and device_ms(top[0]) > 0, "phase 9: the trace holds no device time")
    print(f"phase 9: profile_trace around one trainer-path batch wrote "
          f"{os.path.relpath(prof.trace_path, here)} ({len(trace_events)} events); top device "
          f"operations: " + "; ".join(f"{e.key[:60]} {device_ms(e):.3f} ms x{e.count}"
                                       for e in top) + f" {tag}")
    report = energy_absorption_report(per_batch)
    # the health check of PC inference: the warm starts' Adam MAP descent
    print(f"phase 9: energy_absorption_report over the {OBS_BATCHES} warm starts: mean absorption "
          f"{report['mean_absorption']:.4f}, overall falling on "
          f"{report['mean_overall_monotone_frac']:.4f} of the steps")
    shutil.rmtree(tmp9)
    return counts9


def run_phase11(torch, here: str, tag: str) -> dict:
    """Phase 11: InceptionV3's BasicConv2d kernel on each of the 94 layers
    against float64, a forward's launches, and its times; returns its entry
    of the kernels line (ms a forward of INCEPTION_BATCH images)."""
    sys.path.insert(0, os.path.join(here, "scripts"))
    layers_mod = importlib.import_module("inception_conv_layers")
    inc = importlib.import_module("montecarlopredictivecoding_tpu_torch.eval.inception")
    ic = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.inception_conv")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = layers_mod.weights(INCEPTION_SEED, dev)
    x = layers_mod.images(INCEPTION_BATCH, INCEPTION_SEED + 1, dev)
    before = ic.conv_bn_relu.launches
    layers = layers_mod.layer_inputs(params, x)
    torch.cuda.synchronize()
    forward_launches = ic.conv_bn_relu.launches - before
    check(len(layers) == 94 and forward_launches == 94,
          f"phase 11: a forward ran {len(layers)} layers and {forward_launches} launches, not 94")
    with torch.no_grad():
        rows = [layers_mod.gaps(L) for L in layers]
    torch.cuda.synchronize()
    for L, r in zip(layers, rows):
        check(r["kernel"] <= INCEPTION_GAP,
              f"phase 11: {L.name}: the kernel is {r['kernel']} from float64")
        check(r["single_pass"] >= INCEPTION_PLANTED * r["kernel"],
              f"phase 11: {L.name}: single-pass TF32 reads {r['single_pass']}, under "
              f"{INCEPTION_PLANTED} times the kernel's {r['kernel']}")
    worst = {k: max(r[k] for r in rows) for k in ("kernel", "fma", "single_pass")}
    print(f"phase 11: the 94 layers at B={INCEPTION_BATCH} against float64, worst-row gap: "
          f"kernel at most {worst['kernel']:.3e} (INCEPTION_GAP {INCEPTION_GAP}), FMA route "
          f"{worst['fma']:.3e}, single-pass TF32 {worst['single_pass']:.3e} (at least "
          f"{min(r['single_pass'] / r['kernel'] for r in rows):.1f} times the kernel's on each "
          f"layer); {time.perf_counter() - t0:.1f} s")
    for L, r in zip(layers, rows):
        print(f"  {L.name}: kernel {r['kernel']:.3e}, FMA {r['fma']:.3e}, "
              f"single-pass {r['single_pass']:.3e}")
    t = layers_mod.times(layers)
    flops = sum(L.flops() for L in layers)
    bound_ms = 1e3 * flops / layers_mod.PEAK_FLOPS
    print(f"phase 11: a forward's 94 layers at B={INCEPTION_BATCH}: kernel {t['kernel_ms']:.3f} ms "
          f"({flops / t['kernel_ms'] / 1e9:.2f} TFLOP/s), bound {bound_ms:.3f} ms (FLOPs at "
          f"165 TFLOP/s; {100 * bound_ms / t['kernel_ms']:.1f}%), plain version "
          f"{t['plain_ms']:.3f} ms, library {t['library_ms']:.3f} ms {tag}")
    return {
        "name": "inception_conv", "route": "cuda",
        "source": "montecarlopredictivecoding_tpu_torch/ops/csrc/inception_conv.cu",
        "replaces": None, "launches": forward_launches,
        "max_abs_err": worst["kernel"], "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": bound_ms, "bound_by": "operations", "library_ms": t["library_ms"],
        # a forward of the 94 layers at INCEPTION_BATCH images; max_abs_err is
        # the worst layer's worst-row gap from float64 (relative)
        "per": f"forward, B={INCEPTION_BATCH}", "fma_gap": worst["fma"],
        "single_pass_gap": worst["single_pass"],
    }


def run_phase10(torch, tag: str) -> dict:
    """Phase 10: the per-op probe held against its plain version on the
    card, then driven through its entry point; returns its entry of the
    kernels line (times a step, B=256)."""
    probe = importlib.import_module("montecarlopredictivecoding_tpu_torch.benchmarks.vpu_op_bench")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    held = {}  # (name, noise scale) -> the largest |Δ| over batches and starts
    for B in PROBE_BATCHES:
        for start, steps in PROBE_HOLDS:
            x0 = None if start == "0.3" else probe.signed_start(B, SEED, dev)
            for name in probe.VARIANTS:
                for scale in ((1.0, 1e-6) if name in probe.RANDOM_VARIANTS else (1e-6,)):
                    got = probe.run_variant(name, B, steps, SEED, noise_scale=scale, x0=x0)
                    want = probe.run_variant_reference(name, B, steps, SEED, dev,
                                                       noise_scale=scale, x0=x0)
                    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
                          f"phase 10: {name}: the kernel's tile is not finite or not [{B}, 384]")
                    err, tol = max_abs([got], [want]), probe.card_tolerance(name, want)
                    check(err <= tol, f"phase 10: {name} at B={B}, {steps} steps from {start}, "
                                      f"noise scale {scale}: the kernel is {err} from the plain "
                                      f"version (tolerance {tol})")
                    held[name, scale] = max(err, held.get((name, scale), 0.0))
    sincos_err = probe.sincos_errors()["device_vs_plain"]
    check(sincos_err <= probe.SINCOS_ATOL,
          f"phase 10: the card's sincos_2pi is {sincos_err} from the plain version")
    holds = len(PROBE_BATCHES) * len(PROBE_HOLDS) * (len(probe.VARIANTS) + len(probe.RANDOM_VARIANTS))
    print(f"phase 10: {holds} holds at B={', '.join(map(str, PROBE_BATCHES))}, from 0.3 "
          f"and the signed start ({', '.join(f'{s} over {t}' for s, t in PROBE_HOLDS)} steps): "
          f"max|d| kernel-plain "
          + ", ".join(f"{n}{'' if s == 1e-6 else ' (noise 1)'} {e:.2e}"
                      for (n, s), e in held.items())
          + f"; sincos_2pi on {probe.SINCOS_POINTS} points {sincos_err:.2e}")

    def plain_ms(name, steps):
        return probe.min_ms(
            lambda seed: probe.run_variant_reference(name, PROBE_B, steps, seed, dev), 3)

    plain_us = {}
    for name in probe.VARIANTS:
        lo, hi = (plain_ms(name, steps) for steps in PROBE_PLAIN_T)
        plain_us[name] = (hi - lo) / (PROBE_PLAIN_T[1] - PROBE_PLAIN_T[0]) * 1e3
    print(f"phase 10: the holds and the plain versions' times end after "
          f"{time.perf_counter() - t0:.1f} s")

    # the main path: the probe's entry point, its launches counted
    t1 = time.perf_counter()
    probe.run_variant.launches = probe.device_sincos_2pi.launches = 0
    results = probe.main(PROBE_ARGS)
    launches, sincos_launches = probe.run_variant.launches, probe.device_sincos_2pi.launches
    entry_s = time.perf_counter() - t1
    check(launches > 0 and sincos_launches > 0,
          f"phase 10: the probe's entry point launched the probe kernel {launches} and the "
          f"sincos_2pi kernel {sincos_launches} times")
    rows = results["batches"][PROBE_B]["variants"]
    small = results["batches"][int(PROBE_ARGS[1])]["variants"]
    print(f"phase 10: main({' '.join(PROBE_ARGS)}): {launches} probe launches, "
          f"{sincos_launches} sincos_2pi launches in {entry_s:.1f} s")
    for name in probe.VARIANTS:
        r = rows[name]
        print(f"phase 10: {name}: {r['us']:.4f} us/step (+{r['us'] - rows['baseline']['us']:.4f} "
              f"over baseline), bound {r['bound_us']:.4f} ({r['pipe']}), {r['us'] / r['bound_us']:.2f}x;"
              f" at B={PROBE_ARGS[1]} {small[name]['us']:.4f} (B={PROBE_B} takes "
              f"{r['us'] / small[name]['us']:.2f}x for {PROBE_B // int(PROBE_ARGS[1])}x the "
              f"elements); plain version "
              f"{plain_us[name]:.1f} us/step {tag}")
    for mine, other in PROBE_PAIRS:
        a, b = rows[mine]["us"], rows[other]["us"]
        print(f"phase 10: {mine} {a:.4f} against {other} {b:.4f} us/step: {a / b:.3f} of its time; "
              f"excess over baseline {a - rows['baseline']['us']:.4f} against "
              f"{b - rows['baseline']['us']:.4f} {tag}")
    worst = max(err for (_, scale), err in held.items() if scale == 1e-6)
    return {
        "name": "vpu_op_probe", "route": "cuda",
        "source": "montecarlopredictivecoding_tpu_torch/ops/csrc/op_probe.cu",
        "replaces": "benchmarks/vpu_op_bench.py:110", "launches": launches,
        "max_abs_err": worst, "ms": rows["bm_poly"]["us"] / 1e3,
        "plain_ms": plain_us["bm_poly"] / 1e3, "bound_ms": rows["bm_poly"]["bound_us"] / 1e3,
        "bound_by": "operations", "library_ms": None,
        # times are of one step of bm_poly (marginal fit) at B=256
        "per": f"step, bm_poly, B={PROBE_B}", "clock_mhz": results["batches"][PROBE_B]["clock_mhz"],
        "sincos_max_abs_err": sincos_err, "sincos_launches": sincos_launches,
        "variants": {name: {
            "us_per_step": rows[name]["us"], "bound_us_per_step": rows[name]["bound_us"],
            "bound_pipe": rows[name]["pipe"], "plain_us_per_step": plain_us[name],
            "us_per_step_B64": small[name]["us"], "max_abs_err": held[name, 1e-6],
            **({"max_abs_err_noise_1": held[name, 1.0]} if (name, 1.0) in held else {}),
        } for name in probe.VARIANTS},
    }


def main() -> int:
    t_main = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    port = importlib.import_module("montecarlopredictivecoding_tpu_torch")
    from montecarlopredictivecoding_tpu_torch.core.optim import OptimizerSpec, apply_updates
    from montecarlopredictivecoding_tpu_torch.data import get_mnist_data
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
    from montecarlopredictivecoding_tpu_torch.models import get_model
    from montecarlopredictivecoding_tpu_torch.ops import _build
    from montecarlopredictivecoding_tpu_torch.utils import load_checkpoint, save_checkpoint

    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    dev = torch.device("cuda")
    # the repo holds no IDX files, so every get_mnist_data call makes the
    # synthetic set anew (about 5 s of numpy on the host); the phases share
    # one, made once, as the same seeds would make it every time
    mnist = importlib.import_module("montecarlopredictivecoding_tpu_torch.data.mnist")
    mnist._synthetic_mnist = functools.lru_cache(maxsize=None)(mnist._synthetic_mnist)

    def zero_counts():
        chain.mcpc_chain.launches = 0
        chain.mcpc_chain.launches_unpacked = 0
        chain.sum_block_partials.launches = 0
        chain.mcpc_chain.launches_bf16 = 0
        chain.mcpc_chain.launches_unpacked_bf16 = 0

    def read_counts():
        """(packed, unpacked, summing pass, packed bf16, unpacked bf16)"""
        return (chain.mcpc_chain.launches, chain.mcpc_chain.launches_unpacked,
                chain.sum_block_partials.launches, chain.mcpc_chain.launches_bf16,
                chain.mcpc_chain.launches_unpacked_bf16)

    # ---------------------------------------------------------- phase 0
    card = card_line()
    print(card)
    tag = f"[{card}]"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    # each chain source twice, f32 and bf16 products, and the per-op probe
    # once (f32), InceptionV3's convolution kernel once: six nvcc started
    # together
    libraries = [(name, bf16) for name in ("mcpc_chain", "mcpc_chain_unpacked")
                 for bf16 in (False, True)] + [("op_probe", False), ("inception_conv", False)]
    # phase 9's ranks start now, and the synthetic MNIST set (numpy on the
    # host) is made, while nvcc runs
    ranks9, tmp9 = start_phase9_ranks(here)

    def phase2_inputs():
        """Phase 2's model, test batch and latents, and the plain versions
        on them (``early_plain_runs``)."""
        gen_model = get_model(MODEL_CONFIG, SEED, device=dev)
        _, _, test = get_mnist_data(MODEL_CONFIG, device=dev)
        data, _ = next(iter(test))
        pseudo = torch.zeros(BATCH, MODEL_CONFIG["input_size"], device=dev)
        latents = gen_model.model.init_latents(gen_model.params, pseudo,
                                               torch.Generator().manual_seed(SEED + 1))
        runs = early_plain_runs(torch, chain, gen_model.params, latents, data)
        torch.cuda.synchronize()
        return gen_model, test, data, pseudo, latents, runs

    with ThreadPoolExecutor(max_workers=1) as pool:
        made = pool.submit(mnist._synthetic_mnist, 60000, 10000)
        early = pool.submit(phase2_inputs)
        lib_paths = _build.build_all(libraries)
        t_built = time.perf_counter() - t0
        made.result()
        *inputs2, pre = early.result()
    print(f"phase 0: the plain versions on phase 2's inputs ran while nvcc built the kernels; "
          f"the kernels were built at {t_built:.1f} s, the plain versions done at "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"phase 0: built {', '.join(os.path.relpath(p, here) for p in lib_paths)} "
          f"in {time.perf_counter() - t0:.1f} s")
    for (source, bf16), lib_path in zip(libraries, lib_paths):
        name = source + ("_bf16" if bf16 else "")
        with open(str(lib_path) + ".log") as log:
            print(f"phase 0: {name}: {log.readline().strip()}")
        # every instantiation: registers a thread and spills (ptxas -v)
        resources = _build.ptxas_resources(lib_path)
        for kernel, (regs, stores, loads) in sorted(resources.items()):
            print(f"  ptxas {name}: {kernel}: {regs} registers, spill stores {stores} B, "
                  f"spill loads {loads} B")
        if source.startswith("mcpc_chain"):
            # no chain instantiation spills or passes its launch bound
            threads = chain.block_threads(bf16)
            faults = _build.resource_faults(resources, threads)
            check(not faults, f"phase 0: {name}: " + "; ".join(faults))
            print(f"phase 0: {name}: {threads} threads a block, no chain kernel spills, "
                  f"at most {max(r[0] for k, r in resources.items() if 'chain_kernel' in k)} "
                  f"registers of {_build.launch_bound_registers(threads)}")

    # the step rule's one measured constant: the card's sincos_2pi (the
    # chain kernels' own, through the probe's library) over all 2^23 inputs
    # the noise can give it, against float64
    probe = importlib.import_module("montecarlopredictivecoding_tpu_torch.benchmarks.vpu_op_bench")
    t_sc = time.perf_counter()
    sincos_err = _step_rule().sincos_error(probe.device_sincos_2pi, "cuda")
    plain_sincos = _step_rule().sincos_error(chain.sincos_2pi, "cuda")
    print(f"phase 0: sincos_2pi over all 2^23 inputs, largest error against float64: the "
          f"card's {sincos_err:.6e} (the step rule's), the plain version's on the card "
          f"{plain_sincos:.6e}; {time.perf_counter() - t_sc:.2f} s {tag}")
    check(0.0 < sincos_err < 1e-6, f"phase 0: the card's sincos_2pi errs by {sincos_err}")

    # ---------------------------------------------------------- phase 1
    gen = torch.Generator().manual_seed(SEED)

    def random_case(dims, B, generator=None):
        """random parameters, latents and target, from ``gen`` unless told"""
        g = gen if generator is None else generator
        model = port.make_mlp_model(*dims)
        params = model.init(g, device=dev)
        latents = model.init_latents(params, torch.zeros(B, dims[0], device=dev), g)
        target = (torch.rand(B, dims[3], generator=g) > 0.5).float().to(dev)
        return params, latents, target

    # the cases of the unpacked chain added in its redesign draw from a
    # generator of their own, so every other case keeps the inputs it had
    gen_c = torch.Generator().manual_seed(SEED + 11)

    def chain_plan(dims, B, kw):
        """the plan of the call's own kernel, packed or unpacked, f32 or bf16"""
        packed, bf16 = kw.get("packed", True), kw.get("bf16_matmul", False)
        return chain.chain_plan(dims, B, warm=kw.get("warm_T", 0) > 0,
                                with_pgrads=kw.get("with_pgrads", False),
                                budget=chain.smem_budget(dev, packed, bf16),
                                max_clusters=chain.max_active_clusters(dev, packed=packed,
                                                                       bf16=bf16),
                                output_pc=kw.get("output_var") is not None, bf16=bf16)

    def plan_text(dims, B, kw):
        plan = chain_plan(dims, B, kw)
        packed, bf16 = kw.get("packed", True), kw.get("bf16_matmul", False)
        return (("" if packed else "unpacked: ") + ("bf16: " if bf16 else "")
                + plan.describe(chain.max_active_clusters(dev, plan, packed=packed,
                                                          bf16=bf16)))

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
        ("fid bernoulli warm50 T=0 warm_pgrads", FID, BATCH,
         dict(warm, T=0, with_pgrads=True, warm_pgrads=True)),
        ("fid gaussian warm50+T60 mixing20 pgrads", FID, BATCH,
         dict(pg, loss="gaussian", input_var=0.5)),
        ("fid bernoulli unpacked T60 mixing20 pgrads", FID, BATCH,
         dict(T=60, lr=0.03, mixing=20, with_pgrads=True, packed=False)),
        # beyond one 1024-row tile (the unpacked noise never shifts the seed);
        # 20 steps, as the other cases past 1024 rows (WIDE_B)
        ("fid bernoulli unpacked T20 mixing5 pgrads B=1100", FID, 1100,
         dict(T=20, lr=0.03, mixing=5, with_pgrads=True, packed=False), gen_c),
        # the gradient slice read-modify-written through L2
        ("mse bernoulli unpacked T60 mixing20 pgrads", MSE, BATCH,
         dict(T=60, lr=0.03, mixing=20, with_pgrads=True, packed=False), gen_c),
    ]
    for name, dims, B, kw, *generator in cases:
        params, latents, target = random_case(dims, B, *generator)
        if kw.get("loss") == "gaussian":
            target = 2.0 * target - 1.0
        got = chain.mcpc_chain(params, latents, target, SEED, **kw)
        torch.cuda.synchronize()
        ref = chain.mcpc_chain_reference(params, latents, target, SEED, **kw)
        # the plain version in float64 on the same inputs: the exact answer
        # both f32 versions are measured against
        ref64 = chain.mcpc_chain_reference(*to_double(params, latents, target),
                                           SEED, **kw)
        mapping = plan_text(dims, B, kw)
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
    # the chain libraries' SASS, which phase 6 counts, is disassembled now,
    # one cuobjdump a library in parallel, while the rest of phase 1 holds
    # chains and times nothing
    sass_pool = ThreadPoolExecutor(max_workers=4)
    sass_jobs = [sass_pool.submit(_build.sass_counts, lib_path, "HMMA")
                 for (source, _), lib_path in zip(libraries, lib_paths)
                 if source.startswith("mcpc_chain")]

    # the chain's options, against the plain version in f32 and float64: each
    # part may sit at most its allowance further from float64 than the plain
    # f32 version does
    params, latents, target = random_case(FID, OPT_B)
    draw_m = torch.Generator().manual_seed(SEED + 3)
    mu = tuple((0.1 * torch.randn(x.shape, generator=draw_m)).to(dev) for x in latents)
    nu = tuple((0.01 * torch.rand(x.shape, generator=draw_m)).to(dev) for x in latents)
    warm_only = dict(OPT_CHAIN, T=0)
    option_cases = [
        ("captures, Langevin phase", dict(OPT_CHAIN, capture_stride=1, return_scalars=True)),
        ("captures, warm-only chain", dict(warm_only, capture_stride=1, return_scalars=True)),
        ("scalar_stride 7, Langevin phase",
         dict(OPT_CHAIN, scalar_stride=7, return_scalars=True)),
        ("scalar_stride 7, warm-only chain",
         dict(warm_only, scalar_stride=7, return_scalars=True)),
        ("masked bernoulli perc 0.5, gradients over the last 100 steps",
         dict(OPT_CHAIN, loss="bernoulli_mask", mask_perc=0.5, return_scalars=True,
              with_pgrads=True, mixing=400)),
        ("masked bernoulli perc 0.0001 (rounds to 0: all columns)",
         dict(OPT_CHAIN, loss="bernoulli_mask", mask_perc=0.0001, return_scalars=True)),
        ("emit_warm_opt_state", dict(OPT_CHAIN, emit_warm_opt_state=True,
                                     return_scalars=True)),
        ("continuation from given moments, warm_count 7",
         dict(OPT_CHAIN, warm_mu=mu, warm_nu=nu, warm_count=7, emit_warm_opt_state=True,
              return_scalars=True, capture_stride=5)),
    ]
    _, offs, XW = chain.aligned_layout(FID[:3])

    def held(name, got, inputs, kw):
        """Hold a kernel call by the step rule (``step_hold``): (the report,
        what failed); ``inputs`` are the call's (params, latents, target,
        seed)."""
        text, failed, *_ = step_hold(torch, chain, name, chain.mcpc_chain, inputs, kw,
                                     sincos_err, original=option_parts(got, kw))
        return text, failed

    option_inputs = {OPT_B: (params, latents, target), WIDE_B: random_case(FID, WIDE_B)}
    for name, B, kw in ([(n, OPT_B, kw) for n, kw in option_cases]
                        + [(n, WIDE_B, kw) for n, kw in WIDE_CASES]):
        p_in, l_in, t_in = option_inputs[B]
        got = chain.mcpc_chain(p_in, l_in, t_in, SEED, **kw)
        torch.cuda.synchronize()
        if kw.get("scalar_stride"):
            n_slots = chain.scalar_slots(kw["T"], kw["warm_T"], kw["scalar_stride"])
            check(option_parts(got, kw)["scalars"]["loss"].shape == (n_slots,),
                  f"phase 1 {name}: not {n_slots} scalar slots")
        text, failed = held(name, got, (p_in, l_in, t_in, SEED), kw)
        print(f"phase 1: {name}: B={B} warm {kw.get('warm_T', 0)} + T {kw['T']} "
              f"[{plan_text(FID, B, kw)}] {text}")
        check(not failed, "phase 1 " + "; ".join(failed))
        del got
    del option_inputs

    # a warm phase in three calls that hand the Adam state on: each call held
    # by the step rule from the moments handed to it, the end beside the plain
    # f32 version's one call
    one_kw = dict(warm_only, emit_warm_opt_state=True)
    ref = chain.mcpc_chain_reference(params, latents, target, SEED, **one_kw)
    lat, count, state, texts, failed = latents, 0, None, [], []
    for steps in (60, 70, 70):
        extra = {}
        if state is not None:
            extra = dict(warm_count=count, **{
                key: tuple(m[:, o : o + d] for o, d in zip(offs, FID[:3]))
                for key, m in zip(("warm_mu", "warm_nu"), state)})
        kw_s = dict(one_kw, warm_T=steps, **extra)
        out = chain.mcpc_chain(params, lat, target, SEED, **kw_s)
        text, f = held(f"continuation, call of {steps} steps from {count}", out,
                       (params, lat, target, SEED), kw_s)
        texts.append(f"call of {steps} steps from {count}: {text}")
        failed += f
        lat, _, state = out
        count += steps
    torch.cuda.synchronize()
    print(f"phase 1: warm phase of 200 steps in three calls (60 + 70 + 70) handing the "
          f"Adam state on: B={OPT_B} " + "; ".join(texts) + f"; the end's distance from the "
          f"plain f32 version's one call {max_abs(lat, ref[0]):.3e} (information)")
    check(not failed, "phase 1 " + "; ".join(failed))

    # tanh and the output-PC site, held by the same rule
    tanh_cases = [
        ("warm + Langevin, gradients over the last 50 steps",
         dict(TANH_CHAIN, with_pgrads=True, mixing=50, return_scalars=True)),
        ("warm-only, warm_pgrads",
         dict(TANH_CHAIN, T=0, with_pgrads=True, warm_pgrads=True, return_scalars=True)),
        ("masked perc 0.5, every step captured",
         dict(TANH_CHAIN, loss="bernoulli_mask", mask_perc=0.5, capture_stride=1,
              return_scalars=True)),
        ("masked perc 0.5, scalars every 7 steps",
         dict(TANH_CHAIN, loss="bernoulli_mask", mask_perc=0.5, scalar_stride=7,
              return_scalars=True)),
    ]
    for dims in (FID, PC_MSE):
        for B in (OPT_B, BATCH):
            p_in, l_in, t_in = random_case(dims, B)
            for name, kw in tanh_cases:
                got = chain.mcpc_chain(p_in, l_in, t_in, SEED, **kw)
                torch.cuda.synchronize()
                text, failed = held(f"tanh {name}", got, (p_in, l_in, t_in, SEED), kw)
                print(f"phase 1: tanh, {name}: {'-'.join(map(str, dims))} B={B} "
                      f"[{plan_text(dims, B, kw)}] {text}")
                check(not failed, "phase 1 " + "; ".join(failed))
                del got

    def output_pc_case(B, generator=None):
        """The fid model with a trailing PC site, x3 at least one unit off
        its prediction; from ``gen`` unless told."""
        g = gen if generator is None else generator
        model = port.make_mlp_model(*FID, output_pc=port.PC(
            energy_fn=port.scaled_gaussian_energy(OUT_PC["output_var"])))
        params = model.init(g, device=dev)
        lat = model.init_latents(params, torch.zeros(B, FID[0], device=dev), g)
        return params, off_prediction(torch, lat, g)

    def out_moments(m):
        """(m, v, m3, v3) as handed out -> the per-latent moments a call takes."""
        return {key: tuple(t[:, o : o + d] for o, d in zip(offs, FID[:3])) + (t3[:, :FID[3]],)
                for key, t, t3 in (("warm_mu", m[0], m[2]), ("warm_nu", m[1], m[3]))}

    for B in (OPT_B, BATCH):
        p_in, lat = output_pc_case(B)
        stage_kw = dict(OUT_PC, warm_T=50, warm_lr=0.1, T=0, lr=0.05, emit_warm_opt_state=True,
                        return_scalars=True)
        for name in ("warm phase handing its moments out", "continuation from them",
                     "Langevin steps with noise, gradients and captures"):
            got = chain.mcpc_chain(p_in, lat, None, SEED, **stage_kw)
            torch.cuda.synchronize()
            text, failed = held(f"output-PC {name}", got, (p_in, lat, None, SEED), stage_kw)
            print(f"phase 1: output-PC site, {name}: B={B} warm {stage_kw.get('warm_T', 0)} + "
                  f"T {stage_kw['T']} [{plan_text(FID, B, stage_kw)}] {text}")
            check(not failed, "phase 1 " + "; ".join(failed))
            check(len(got[0]) == 4 and tuple(got[0][3].shape) == (B, FID[3]),
                  f"phase 1 output-PC {name}: no x3 of [{B}, {FID[3]}]")
            lat, parts = got[0], option_parts(got, stage_kw)
            if "moments" in parts:   # the next call resumes them
                stage_kw = dict(OUT_PC, warm_T=30, warm_lr=0.1, T=0, lr=0.05,
                                emit_warm_opt_state=True, return_scalars=True,
                                warm_count=stage_kw.get("warm_count", 0) + stage_kw["warm_T"],
                                **out_moments(parts["moments"]))
            if name.startswith("continuation"):
                stage_kw = dict(OUT_PC, T=100, lr=0.05, noise_var=2.0, with_pgrads=True,
                                mixing=50, capture_stride=5, return_scalars=True)
            del got

    print(f"phase 1 ends at {time.perf_counter() - t_start:.1f} s")
    # ---------------------------------------------------------- phase 2
    gen_model, test, data, pseudo, latents = inputs2
    params = gen_model.params
    check(tuple(data.shape) == (BATCH, 784), f"data batch is {tuple(data.shape)}")
    check(bool(((data == 0) | (data == 1)).all()), "data batch is not binarized")
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
    # (c) at T=10000 between two timings of (a) in the same call
    c_long_ms, out_c_long = cuda_ms(torch, lambda: chain.mcpc_chain(
        params, latents, data, SEED, **CHAIN_C_LONG))
    a2_ms, _ = cuda_ms(torch, run_a)
    check(all(bool(torch.isfinite(x).all()) for x in out_c_long[0]),
          "chain (c) at T=10000 is not finite")
    print(f"phase 2: chain (c) B={BATCH} T={CHAIN_C_LONG['T']}: kernel {c_long_ms:.3f} ms, "
          f"{1e3 * c_long_ms / CHAIN_C_LONG['T']:.3f} us/step; chain (a) {a_ms:.3f} and "
          f"{a2_ms:.3f} ms around it: (c)/(a) {c_long_ms / statistics.mean((a_ms, a2_ms)):.4f}; "
          f"[{plan_text(FID, BATCH, CHAIN_C)}] {tag}")

    # the plain versions (ran while nvcc built the kernels), (b)'s cut to a
    # tenth of its steps (warm 200 + T 1000)
    (pa_ms, ref_a), (pb_ms, _), (pc_ms, ref_c) = (pre.pop(k) for k in ("a", "b", "c"))
    b_cut = CHAIN_B_CUT
    # both held by the step rule at their full length: chain (a)'s 10,000
    # steps captured (3.9 GB on the card), chain (c)'s by prefixes (the
    # unpacked kernel has no captures).  The largest difference from the
    # plain f32 version is printed beside it (the kernels line's max_abs_err)
    kw_a = dict(CHAIN_A, return_scalars=True)
    dx, rel = max_abs(out_a[0], ref_a[0]), scalar_rel(out_a[2], ref_a[2])
    text_a, failed_a, *_ = step_hold(torch, chain, "chain (a)", chain.mcpc_chain,
                                     (params, latents, data, SEED), kw_a, sincos_err,
                                     original=option_parts(out_a, kw_a), ref=ref_a)
    print(f"phase 2: chain (a), {CHAIN_A['T']} steps: kernel vs plain f32 max|dx|={dx:.3e}, "
          f"scalars max rel={rel:.3e}; {text_a} {tag}")
    check(not failed_a, "phase 2: " + "; ".join(failed_a))
    dx_c = max_abs(out_c[0], ref_c[0])
    text_c, failed_c, *_ = step_hold(torch, chain, "chain (c)", chain.mcpc_chain,
                                     (params, latents, data, SEED), CHAIN_C, sincos_err,
                                     original=option_parts(out_c, CHAIN_C), ref=ref_c)
    print(f"phase 2: chain (c), unpacked, {CHAIN_C['T']} steps: kernel vs plain f32 "
          f"max|dx|={dx_c:.3e}; {text_c} {tag}")
    check(not failed_c, "phase 2: " + "; ".join(failed_c))

    bound_a = chain_bound_ms(FID, BATCH, CHAIN_A["T"])
    bound_b = chain_bound_ms(FID, BATCH, CHAIN_B["T"] + CHAIN_B["warm_T"])
    bound_c = chain_bound_ms(FID, BATCH, CHAIN_C["T"])
    # the f32 products as split-TF32 ones on the tensor cores would take
    # them: three TF32 products for each f32 one, at the TF32 peak
    bound_tc_a, bound_tc_c = (
        chain_bound_ms(FID, BATCH, steps, peak=PEAK_TF32_FLOPS / SPLIT_TF32_PRODUCTS)
        for steps in (CHAIN_A["T"], CHAIN_C["T"]))
    for name, ms, pms, bound, steps, plain_steps in (
        ("a", a_ms, pa_ms, bound_a, CHAIN_A["T"], CHAIN_A["T"]),
        ("b", b_ms, pb_ms, bound_b, CHAIN_B["T"] + CHAIN_B["warm_T"],
         b_cut["T"] + b_cut["warm_T"]),
        ("c, unpacked", c_ms, pc_ms, bound_c, CHAIN_C["T"], CHAIN_C["T"]),
    ):
        print(f"phase 2: chain ({name}) B={BATCH} steps={steps}: kernel "
              f"{ms:.3f} ms/chain, {1e3 * ms / steps:.3f} us/step, "
              f"{steps / (ms / 1e3):.1f} steps/s; plain {pms:.3f} ms for {plain_steps} "
              f"steps (timed while nvcc ran); bound {bound:.3f} ms (operations, at the f32 peak of the CUDA cores) "
              f"{tag}")
    print(f"phase 2: a split-TF32 route's bound (three TF32 products an f32 one, at the "
          f"TF32 tensor-core peak): chain (a) {bound_tc_a:.3f} ms, share {bound_tc_a / a_ms:.4f}; "
          f"chain (c) {bound_tc_c:.3f} ms, share {bound_tc_c / c_ms:.4f} {tag}")
    print("phase 2: library_ms null: no single PyTorch call computes a "
          "whole Langevin chain")

    print(f"phase 2 ends at {time.perf_counter() - t_start:.1f} s")
    # ---------------------------------------------------------- phase 3
    config = train_mnist.mcpc_training_config()
    sampling = config["sampling"]
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
    param_opt = train_mnist.param_optimizer(config)
    params_t, opt_state = trainee.params, param_opt.init(trainee.params)
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
    worst, n_clear, total, _ = param_rule(torch, param_opt, apply_updates, p0_64, p1, ref64[1],
                                          sampling * BATCH)
    print(f"phase 3: first batch, updated parameters vs the float64 plain version on the "
          f"{n_clear} of {total} entries whose gradient is at least {P3_CLEAR} of its "
          f"tensor's largest: max|d|={worst:.3e} (atol {P3_PARAM_ATOL})")
    check(n_clear > total // 2 and worst <= P3_PARAM_ATOL,
          f"phase 3: updated parameters differ by {worst} on {n_clear} entries")

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

    # the mse preset through its entry point: train_mcpc(preset="mse") at
    # 10-256-256-784, where the gradient slice does not fit beside the weights
    # and each sampling step read-modify-writes its partial through L2
    mse_config = train_mnist.apply_preset(train_mnist.mcpc_training_config(), "mse", "mcpc")
    mse_opts = train_mnist.chain_options(mse_config)
    mse_plan = chain_plan(MSE, BATCH, mse_opts)
    print(f"phase 3: mse preset, the training chain's plan [{plan_text(MSE, BATCH, mse_opts)}]")
    check(not mse_plan.grads_resident,
          "phase 3: the mse preset's gradient slice is resident, not in device memory")
    mse_model = get_model(mse_config, SEED, device=dev)
    pseudo_mse = torch.zeros(BATCH, MSE[0], device=dev)
    lat_mse = mse_model.model.init_latents(mse_model.params, pseudo_mse,
                                           torch.Generator().manual_seed(SEED + 7))
    infer_mse = dict(mse_opts, with_pgrads=False, return_scalars=True)

    def mse_test_loss(p):
        return float(chain.mcpc_chain(p, lat_mse, data, SEED, **infer_mse)[2]["loss"])

    loss_before = mse_test_loss(mse_model.params)
    ckpt = os.path.join(here, "build", "chip_smoke", "mcpc_mse_smoke.msgpack")
    # the chain is called by the name train_mnist imported; each batch is
    # timed around one_batch, the first one's parameters kept
    mse_rec = ChainRecorder(torch, train_mnist.mcpc_chain)
    real_one_batch, batch_events, stepped = train_mnist.one_batch, [], []

    def one_batch_timed(*args, **kwargs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = real_one_batch(*args, **kwargs)
        end.record()
        batch_events.append((start, end))
        if not stepped:
            stepped.append(out[0])
        return out

    train_mnist.mcpc_chain, train_mnist.one_batch = mse_rec, one_batch_timed
    try:
        torch.cuda.synchronize()
        zero_counts()
        trained_mse = train_mnist.train_mcpc(1, ckpt, seed=SEED, batches_per_epoch=MSE_BATCHES,
                                             log=False, preset="mse", device=dev)
        torch.cuda.synchronize()
        mse_counts = read_counts()
    finally:
        train_mnist.mcpc_chain, train_mnist.one_batch = mse_rec.fn, real_one_batch
    print(f"phase 3: mse preset, main path launches over {MSE_BATCHES} batches of "
          f"train_mcpc(preset='mse'): mcpc_chain {mse_counts[0]}, sum_block_partials "
          f"{mse_counts[2]}")
    check(mse_counts[0] == MSE_BATCHES and mse_counts[2] == MSE_BATCHES,
          f"phase 3: {mse_counts[0]} chain launches and {mse_counts[2]} summing passes for "
          f"{MSE_BATCHES} mse batches")
    reloaded = load_checkpoint(ckpt, mse_model.params, device=dev)
    for p, q in zip(reloaded, trained_mse.params):
        for k in ("w", "b"):
            check(bool(torch.isfinite(q[k]).all()), "mse: trained parameters are not finite")
            check(torch.equal(p[k], q[k]) and p[k].dtype == q[k].dtype,
                  "mse: the reloaded checkpoint differs from the trained parameters")
    loss_after = mse_test_loss(reloaded)
    print(f"phase 3: mse preset, checkpoint {os.path.relpath(ckpt, here)} reloads bit for bit; "
          f"Bernoulli loss of the fixed test batch {loss_before:.1f} -> {loss_after:.1f} "
          f"after {MSE_BATCHES} batches")
    check(loss_after < loss_before, "mse: training did not lower the test batch's loss")

    # the first batch at its full length by the step rule: the training's
    # launch captured again (split at the warm phase's end), every step held
    # from the kernel's own state; both one-row skips injected into those
    # captures must fail it; then the parameters after the Adam step, held
    # from the kernel's own gradients; then the faults of ARG_FAULTS through
    # the chain's arguments in the kernel's place, each of which must fail
    rec = mse_rec.calls[0]
    inputs0, kw = rec["inputs"], rec["kw"]
    mse_plain_ms, ref = cuda_ms(torch, lambda: chain.mcpc_chain_reference(*inputs0, **kw),
                                reps=1, warm_up=False)
    text, failed, _, cap, rows = step_hold(torch, chain, "mse, first batch", chain.mcpc_chain,
                                           inputs0, kw, sincos_err, original=rec["parts"],
                                           ref=ref, keep=True)
    print(f"phase 3: mse preset, first batch ({kw['warm_T']} Adam + {kw['T']} Langevin steps, "
          f"gradients over the last {kw['T'] - kw['mixing']}), held at its full length: {text}; "
          f"the plain version {mse_plain_ms:.3f} ms {tag}")
    check(not failed, "phase 3: " + "; ".join(failed))
    text, failed = skip_holds("mse, first batch", cap, inputs0, kw, rows, sincos_err)
    print(f"phase 3: mse preset, first batch, one row's update skipped, injected into the "
          f"kernel's captures: {text}")
    check(not failed, "phase 3: " + "; ".join(failed))
    for name, change in GRAD_FAULTS:
        faulty = _step_rule().grads_changed(cap, change)
        v = _step_rule().hold(faulty, inputs0, kw, sincos_err=sincos_err)
        text, failed = grad_hold(f"mse, fault {name}", v, faulty.held["pgrads"])
        print(f"phase 3: mse preset, first batch with the fault {name}, injected into the "
              f"kernel's output: step rule {'holds' if v['ok'] else 'FAILS'} (gradients "
              f"{v['parts']['pgrads']['ratio']:.3g} of the bound at {v['parts']['pgrads']['at']})"
              f"{text}")
        check(bool(failed) or not v["ok"], f"phase 3: mse, the fault {name} passes")
    del cap
    spec = OptimizerSpec("adam", lr=mse_config["optimizer_p_kwargs_mcpc"]["lr"])
    held_p = _step_rule().param_hold(rec["inputs"][0], stepped[0], rec["parts"]["pgrads"],
                                     mse_config["sampling"] * BATCH, spec.lr, spec.betas, spec.eps)
    print(f"phase 3: mse preset, first batch, the parameters after the Adam step against the "
          f"interval the kernel's own gradients give (step_rule.param_hold): "
          f"{'holds' if held_p['ok'] else 'FAILS'}, largest ratio {held_p['ratio']:.3g} at "
          f"{held_p['at']} ({held_p['checked']} entries)")
    check(held_p["ok"], f"phase 3: mse, the parameters after the Adam step: {held_p}")
    for name, change in ARG_FAULTS:
        def faulty(p, lat, t, seed, change=change, **k):
            k, seed = change(k, seed)
            return chain.mcpc_chain(p, lat, t, seed, **k)
        text, failed, *_ = step_hold(torch, chain, f"mse, fault {name}", faulty, inputs0, kw,
                                     sincos_err, ref=ref)
        print(f"phase 3: mse preset, first batch with the fault {name}: {text}")
        check(bool(failed), f"phase 3: mse, the fault {name} passes the step rule")
    mse_batch_ms = [s_.elapsed_time(e_) for s_, e_ in batch_events]
    mse_chain_ms = [r["events"][0].elapsed_time(r["events"][1]) for r in mse_rec.calls]
    mse_ms, mse_chain = statistics.median(mse_batch_ms[1:]), statistics.median(mse_chain_ms[1:])
    bound_mse = chain_bound_ms(MSE, BATCH, train_steps, sampling)
    print(f"phase 3: mse preset, training batch B={BATCH} 10-256-256-784: {mse_ms:.3f} ms/batch "
          f"(median of {len(mse_batch_ms) - 1}, first {mse_batch_ms[0]:.3f}), "
          f"{BATCH / (mse_ms / 1e3):.1f} images/s; mcpc_chain {mse_chain:.3f} ms of it "
          f"({mse_chain / mse_ms:.3f}); bound {bound_mse:.3f} ms (operations, "
          f"{(step_flops(MSE, BATCH) * train_steps + step_flops(MSE, BATCH) // 2 * sampling) / 1e9:.2f}"
          f" GFLOP) {tag}")
    del ref

    print(f"phase 3 ends at {time.perf_counter() - t_start:.1f} s")
    # ---------------------------------------------------------- phase 4
    from montecarlopredictivecoding_tpu_torch.core.trainer import PCTrainer
    from montecarlopredictivecoding_tpu_torch.experiments import common, figure_2

    check(os.path.isfile(os.path.join(here, "models", "mcpc_ml_2.msgpack")),
          "models/mcpc_ml_2.msgpack is missing")
    ctx = common.ExperimentContext(os.path.join(here, "models"),
                                   os.path.join(here, "build", "chip_smoke", "figures"),
                                   scale=1.0, device="cuda")
    fig_config = figure_2._mnist_config(ctx)
    calls = []
    train_on_batch = PCTrainer.train_on_batch

    def timed(self, inputs, *args, **kwargs):
        """PCTrainer.train_on_batch between two CUDA events, with the path
        it took."""
        kernel_before = self.kernel_calls
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = train_on_batch(self, inputs, *args, **kwargs)
        end.record()
        end.synchronize()
        calls.append(dict(trainer=self, B=inputs.shape[0], steps=self.T,
                          mode=self.opt_x_spec.name, ms=start.elapsed_time(end),
                          kernel=self.kernel_calls > kernel_before))
        return out

    recorder = ChainRecorder(torch, chain.mcpc_chain)
    PCTrainer.train_on_batch = timed
    chain.mcpc_chain = recorder
    try:
        torch.cuda.synchronize()
        zero_counts()
        t_fig = time.perf_counter()
        preds_pc, preds_mc = figure_2.posterior_non_linear_model(ctx, img_kept=0.5)
        torch.cuda.synchronize()
        fig_s = time.perf_counter() - t_fig
        fig_counts = read_counts()
    finally:
        PCTrainer.train_on_batch = train_on_batch
        chain.mcpc_chain = recorder.fn
    trainers = {id(c["trainer"]): c["trainer"] for c in calls}.values()
    fallbacks = sum(t.engine_calls for t in trainers)
    print(f"phase 4: main path launches: mcpc_chain {fig_counts[0]}, "
          f"sum_block_partials {fig_counts[2]}; PCTrainer calls {len(calls)}, "
          f"engine fallbacks {fallbacks}")
    check(fig_counts[0] > 0, "the figure-2 path did not launch the mcpc_chain kernel")
    check(fallbacks == 0 and all(c["kernel"] for c in calls),
          "a figure-2 PCTrainer call ran in the step engine")
    check(fig_counts[0] == len(calls), f"{fig_counts[0]} launches for {len(calls)} calls")
    labels = ["probe MAP, batch 1", "probe MAP, batch 2", "PC posterior", "MCPC posterior"]
    check(len(calls) == len(labels), f"{len(calls)} PCTrainer calls, expected {len(labels)}")
    check(len(recorder.calls) == len(calls),
          f"{len(recorder.calls)} chain calls for {len(calls)} PCTrainer calls")
    for label, c, rec in zip(labels, calls, recorder.calls):
        chain_call_ms = rec["events"][0].elapsed_time(rec["events"][1])
        print(f"phase 4: {label}: B={c['B']}, {c['steps']} {c['mode']} steps, "
              f"{c['ms']:.3f} ms, {1e3 * c['ms'] / c['steps']:.3f} us/step, bound "
              f"{chain_bound_ms(FID, c['B'], c['steps']):.3f} ms; of the call, mcpc_chain "
              f"{chain_call_ms:.3f} ms (it allocated {rec['new_segments']} new device-memory "
              f"segments) and the trainer's own work around it "
              f"{c['ms'] - chain_call_ms:.3f} ms {tag}")

    # every chain of the figure held by the step rule at its full length,
    # from the kernel launched again on the call's inputs with every step
    # captured (which must end with the figure's bits); both one-row skips
    # injected into the PC posterior's captures must fail it
    fig_failed = []
    for label, rec in zip(labels, recorder.calls):
        kw = rec["kw"]
        shown = {k: v for k, v in kw.items() if k not in ("warm_mu", "warm_nu")}
        text, failed, _, cap, rows = step_hold(torch, chain, label, chain.mcpc_chain,
                                               rec["inputs"], kw, sincos_err,
                                               original=rec["parts"],
                                               keep=label == "PC posterior")
        print(f"phase 4: {label}: the trainer's mcpc_chain options {shown}; {text} {tag}")
        fig_failed += failed
        if cap is not None:
            text, failed = skip_holds(label, cap, rec["inputs"], kw, rows, sincos_err)
            print(f"phase 4: {label}, one row's update skipped, injected into the kernel's "
                  f"captures: {text}")
            fig_failed += failed
        del cap
    check(not fig_failed, "phase 4 " + "; ".join(fig_failed))

    n_img = preds_pc.shape[1]
    check(preds_pc.shape == (fig_config["T_pc"], n_img, 10) and 1 <= n_img <= 16,
          f"preds_pc is {preds_pc.shape}")
    check(preds_mc.shape == (fig_config["sampling"], n_img, 10),
          f"preds_mc is {preds_mc.shape}")
    rows_err = 0.0
    for p in (preds_pc, preds_mc):
        check(bool(np.isfinite(p).all()), "a figure-2 posterior is not finite")
        rows_err = max(rows_err, float(np.abs(p.sum(-1) - 1.0).max()))
    check(rows_err <= 1e-5, f"posterior rows sum to 1 within {rows_err}")
    pc_final, mc_mean = preds_pc[-1].mean(0), preds_mc.mean((0, 1))
    print(f"phase 4: figure 2 (c, d) at full width: {n_img} masked 4s, preds_pc "
          f"{tuple(preds_pc.shape)}, preds_mc {tuple(preds_mc.shape)}, finite, rows sum "
          f"to 1 within {rows_err:.1e}; mean P(4): PC MAP {pc_final[4]:.3f}, MCPC "
          f"{mc_mean[4]:.3f}; the whole computation {fig_s:.3f} s (data and the probe's "
          f"training included; PCTrainer calls {sum(c['ms'] for c in calls) / 1e3:.3f} s) "
          f"{tag}")
    # the MCPC posterior's chain alone, with and without its captures
    fig_params = common.load_generative_checkpoint(ctx, "mcpc_ml_2", fig_config).params
    lat16 = gen_model.model.init_latents(fig_params, torch.zeros(n_img, 20, device=dev),
                                         torch.Generator().manual_seed(SEED + 4))
    _, _, fig_test = get_mnist_data(fig_config, device=dev)
    y16 = next(iter(fig_test))[0][:n_img]
    mc_kw = dict(T=fig_config["mixing"] + fig_config["sampling"],
                 lr=fig_config["optimizer_x_kwargs_mcpc"]["lr"], noise_var=2.0,
                 loss="bernoulli_mask", mask_perc=0.5, return_scalars=True)
    cap_ms, _ = cuda_ms(torch, lambda: chain.mcpc_chain(fig_params, lat16, y16, SEED,
                                                        capture_stride=1, **mc_kw))
    nocap_ms, _ = cuda_ms(torch, lambda: chain.mcpc_chain(fig_params, lat16, y16, SEED,
                                                          **mc_kw))
    print(f"phase 4: the MCPC posterior's chain alone, B={n_img}, {mc_kw['T']} steps "
          f"[{plan_text(FID, n_img, mc_kw)}]: every step captured {cap_ms:.3f} ms "
          f"(the trajectory's scalars recomputed included), no capture {nocap_ms:.3f} ms, "
          f"{1e3 * nocap_ms / mc_kw['T']:.3f} us/step {tag}")

    print(f"phase 4 ends at {time.perf_counter() - t_start:.1f} s")
    # ---------------------------------------------------------- phase 5
    from montecarlopredictivecoding_tpu_torch.core.trainer import LangevinStep
    from montecarlopredictivecoding_tpu_torch.eval import metrics
    from montecarlopredictivecoding_tpu_torch.experiments import figure_3
    from montecarlopredictivecoding_tpu_torch.models import get_mcpc_trainer, get_pc_trainer

    for name in ("pc_mse_1", "mcpc_mse_1", "pc_ml_1", "mcpc_ml_1", "mcpc_fid_3"):
        check(os.path.isfile(os.path.join(here, "models", name + ".msgpack")),
              f"models/{name}.msgpack is missing")

    mse_models = [("pc_mse_1", eval_config(port, PC_MSE, "tanh", 0.7), PC_MSE),
                  ("mcpc_mse_1", eval_config(port, MSE, "relu", 0.7), MSE)]
    ml_models = [("pc_ml_1", eval_config(port, PC_ML, "tanh", 0.3)),
                 ("mcpc_ml_1", eval_config(port, FID, "relu", 0.7))]
    _, val_split, test_split = get_mnist_data(mse_models[0][1], device=dev)
    test_batches = [b for _, b in zip(range(EVAL_BATCHES), test_split)]
    val_batches = [b for _, b in zip(range(EVAL_BATCHES), val_split)]
    check(all(tuple(x.shape) == (1024, 784) for x, _ in test_batches + val_batches),
          "an evaluation batch is not [1024, 784]")

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    calls = []
    recorder = ChainRecorder(torch, chain.mcpc_chain)
    PCTrainer.train_on_batch = timed
    chain.mcpc_chain = recorder
    parts5, times5 = {}, {}
    try:
        torch.cuda.synchronize()
        zero_counts()

        def part(name, fn):
            """Run one path; remember its PCTrainer calls and its time."""
            first = len(calls)
            start, end = events()
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            parts5[name] = (first, len(calls))
            times5[name] = start.elapsed_time(end)
            return out

        trained = part("PC training", lambda: train_mnist.train_pc(
            1, os.path.join(here, "build", "chip_smoke", "pc_ml_smoke.msgpack"),
            seed=SEED, batches_per_epoch=PC_TRAIN_BATCHES, log=False, preset="ml",
            device=dev))
        trained_mse = part("PC training, mse", lambda: train_mnist.train_pc(
            1, os.path.join(here, "build", "chip_smoke", "pc_mse_smoke.msgpack"),
            seed=SEED, batches_per_epoch=MSE_BATCHES, log=False, preset="mse", device=dev))
        mse = {}
        for name, cfg, _ in mse_models:
            gen_e = common.load_generative_checkpoint(ctx, name, cfg)
            mse[name] = part(f"MSE-rec {name}",
                             lambda: metrics.get_mse_rec(gen_e, cfg, test_batches))
        ml = {}
        for name, cfg in ml_models:
            gen_e = common.load_generative_checkpoint(ctx, name, cfg)
            ml[name] = part(f"ML {name}", lambda: metrics.get_marginal_likelihood(
                gen_e, cfg, val_batches, n_samples=ML_SAMPLES,
                generator=torch.Generator().manual_seed(SEED + 5)))

        # the output-PC joint sampler: figure 3's recipe at MNIST width
        joint_cfg, joint = joint_sampler_model(port, here, dev)
        check(chain.output_pc_var(joint.model) == 1.0, "the joint sampler has no output-PC site")
        pseudo_j = torch.zeros(BATCH, FID[0], device=dev)

        def joint_sampler():
            get_pc_trainer(joint, joint_cfg, is_mcpc=True, training=False).train_on_batch(
                pseudo_j, loss_fn=None)
            return get_mcpc_trainer(joint, joint_cfg, training=False).train_on_batch(
                pseudo_j, loss_fn=None, callback_after_t=LangevinStep(var=2.0),
                is_sample_x_at_batch_start=False, is_return_results_every_t=False)

        joint_res = part("joint sampler", joint_sampler)
        fig_ctx = common.ExperimentContext(os.path.join(here, "models"),
                                           os.path.join(here, "build", "chip_smoke", "figures"),
                                           scale=1.0, device="cuda")
        fig3b = part("figure 3b", lambda: figure_3.generation_non_linear_model(fig_ctx))
        torch.cuda.synchronize()
        counts5 = read_counts()
    finally:
        PCTrainer.train_on_batch = train_on_batch
        chain.mcpc_chain = recorder.fn
    # figure 3a's model is outside the chain's family: the step engine runs it
    engine_before = chain.mcpc_chain.launches
    t3a = time.perf_counter()
    fig3a = figure_3.generation_linear_model(
        common.ExperimentContext(fig_ctx.path_models, fig_ctx.path_figures, scale=SCALE_3A,
                                 device="cuda"))
    torch.cuda.synchronize()
    t3a = time.perf_counter() - t3a
    check(chain.mcpc_chain.launches == engine_before, "figure 3a launched the chain kernel")

    trainers5 = {id(c["trainer"]): c["trainer"] for c in calls}.values()
    fallbacks5 = sum(t.engine_calls for t in trainers5)
    print(f"phase 5: main path launches: mcpc_chain {counts5[0]}, sum_block_partials "
          f"{counts5[2]}; PCTrainer calls {len(calls)}, engine fallbacks {fallbacks5}")
    expect = {"PC training": PC_TRAIN_BATCHES, "PC training, mse": MSE_BATCHES,
              "MSE-rec pc_mse_1": EVAL_BATCHES,
              "MSE-rec mcpc_mse_1": EVAL_BATCHES, "ML pc_ml_1": 0, "ML mcpc_ml_1": 0,
              "joint sampler": 2, "figure 3b": 2}
    for name, n in expect.items():
        a, b = parts5[name]
        check(b - a == n, f"phase 5 {name}: {b - a} PCTrainer calls, expected {n}")
    check(fallbacks5 == 0 and all(c["kernel"] for c in calls),
          "a phase-5 PCTrainer call ran in the step engine")
    check(counts5[0] == len(calls) == len(recorder.calls),
          f"{counts5[0]} launches for {len(calls)} PCTrainer calls")
    # a summing pass for each call's gradients and one for its scalar slots
    sums5 = sum(bool(r["kw"].get("with_pgrads")) + bool(r["kw"].get("scalar_stride"))
                for r in recorder.calls)
    check(counts5[2] == sums5 and sums5 >= PC_TRAIN_BATCHES,
          f"{counts5[2]} summing passes for {sums5} calls with gradients or scalar slots")

    bounds5 = {"PC training": (PC_ML, 128, 250, 1), "PC training, mse": (PC_MSE, 128, 250, 1),
               "MSE-rec pc_mse_1": (PC_MSE, 1024, 250, 0),
               "MSE-rec mcpc_mse_1": (MSE, 1024, 250, 0), "joint sampler": (FID, BATCH, 0, 0),
               "figure 3b": (FID, 1, 0, 0)}
    for name, (a, b) in parts5.items():
        for i in range(a, b):
            c, rec = calls[i], recorder.calls[i]
            dims, _, _, sampling = bounds5[name]
            chain_call_ms = rec["events"][0].elapsed_time(rec["events"][1])
            bound = chain_bound_ms(dims, c["B"], c["steps"], sampling)
            print(f"phase 5: {name}, call {i - a + 1}: B={c['B']}, {c['steps']} {c['mode']} "
                  f"steps, {c['ms']:.3f} ms, {1e3 * c['ms'] / c['steps']:.3f} us/step, bound "
                  f"{bound:.3f} ms ({step_flops(dims, c['B']) * c['steps'] / 1e9:.2f} GFLOP, "
                  f"operations); mcpc_chain {chain_call_ms:.3f} ms "
                  f"[{plan_text(dims, c['B'], rec['kw'])}] {tag}")
        print(f"phase 5: {name}: {times5[name]:.3f} ms in all (host work included) {tag}")
        if name.startswith("PC training"):
            # a batch's time: the median of the calls after the first
            call_ms = [c["ms"] for c in calls[a + 1 : b]]
            chain_ms = [r["events"][0].elapsed_time(r["events"][1])
                        for r in recorder.calls[a + 1 : b]]
            print(f"phase 5: {name}: {statistics.median(call_ms):.3f} ms/batch (median of "
                  f"{len(call_ms)} after the first), mcpc_chain "
                  f"{statistics.median(chain_ms):.3f} ms of it "
                  f"({statistics.median(chain_ms) / statistics.median(call_ms):.3f}); bound "
                  f"{chain_bound_ms(*bounds5[name]):.3f} ms {tag}")

    # what each path computed
    for name, gen_t in (("PC training", trained), ("PC training, mse", trained_mse)):
        for p_ in gen_t.params:
            check(all(bool(torch.isfinite(v).all()) for v in p_.values()),
                  f"{name} left a parameter not finite")
        rec0 = recorder.calls[parts5[name][0]]
        check(not torch.equal(gen_t.params[3]["b"], rec0["inputs"][0][3]["b"]),
              f"{name} left b3 unchanged")
        check(torch.equal(gen_t.params[0]["w"], rec0["inputs"][0][0]["w"]),
              f"{name} moved W0 although its gradient is zero")
    for name, value in mse.items():
        check(0.0 < value < 1.0, f"MSE-rec of {name} is {value}")
    for name, value in ml.items():
        check(np.isfinite(value) and value < 0.0, f"the marginal likelihood of {name} is {value}")
    print(f"phase 5: masked-reconstruction MSE on {EVAL_BATCHES} x 1024 test images: "
          + ", ".join(f"{k} {v:.5f}" for k, v in mse.items())
          + f"; marginal likelihood ({ML_SAMPLES} samples, {EVAL_BATCHES} x 1024 validation "
          f"images): " + ", ".join(f"{k} {v:.3f} nats" for k, v in ml.items()))
    x_j = joint.latents
    check(len(x_j) == 4 and all(bool(torch.isfinite(x).all()) for x in x_j),
          "the joint sampler's latents are not finite")
    print(f"phase 5: joint sampler after 250 + 10000 steps: x0 (top latent) mean "
          f"{float(x_j[0].mean()):.4f}, variance {float(x_j[0].var()):.4f}; x3 (sensory) mean "
          f"{float(x_j[3].mean()):.4f}, variance {float(x_j[3].var()):.4f}; last step energy "
          f"{float(joint_res['energy'][-1]):.1f}")
    ims = fig3b["ims"]
    check(ims.ndim == 3 and ims.shape[1:] == (28, 28) and bool(np.isfinite(ims).all())
          and ims.min() >= 0.0 and ims.max() <= 1.0, f"figure 3b frames {ims.shape}")
    check(abs(fig3a["mean"] - 1.0) < 0.5 and abs(fig3a["var"] - 5.0) < 2.0,
          f"figure 3a marginal mean {fig3a['mean']} variance {fig3a['var']} (want 1, 5)")
    print(f"phase 5: figure 3b: {ims.shape[0]} frames every {fig3b['stride']} steps, mean "
          f"intensity {float(ims.mean()):.4f}; figure 3a (step engine, scale {SCALE_3A}, "
          f"{len(fig3a['x0'])} samples): x0 mean {fig3a['mean']:.4f} (1.0), variance "
          f"{fig3a['var']:.4f} (5.0), {t3a:.3f} s {tag}")

    # chosen launches held by the step rule at their full length
    # (hold_replay): the kernel launched again on their recorded inputs with
    # every step captured must end with their bits
    held5 = [("PC training, batch 1", parts5["PC training"][0]),
             ("PC training, mse, batch 1", parts5["PC training, mse"][0]),
             ("MSE-rec pc_mse_1, batch 1", parts5["MSE-rec pc_mse_1"][0]),
             ("MSE-rec mcpc_mse_1, batch 1", parts5["MSE-rec mcpc_mse_1"][0]),
             ("joint sampler, PC warm start", parts5["joint sampler"][0]),
             ("joint sampler, Langevin", parts5["joint sampler"][0] + 1),
             ("figure 3b, PC warm start", parts5["figure 3b"][0]),
             ("figure 3b, Langevin", parts5["figure 3b"][0] + 1)]
    fig5_failed = []
    for label, i in held5:
        fig5_failed += hold_replay(torch, chain, 5, label, recorder.calls[i], tag, sincos_err)
    check(not fig5_failed, "phase 5 " + "; ".join(fig5_failed))

    # tanh on chain (a)'s inputs: the kernel (median of 3) beside relu's time
    # in phase 2, held by the step rule at its full length; the plain version
    # ran at 1000 steps while nvcc built the kernels, its distance from the
    # kernel's captured state there printed beside it
    tanh_a = dict(CHAIN_A, activation="tanh", return_scalars=True)
    tanh_ms, out_tanh = cuda_ms(torch, lambda: chain.mcpc_chain(
        params, latents, data, SEED, **tanh_a))
    tanh_plain_ms, ref_t = pre.pop("tanh")
    text_t, failed_t, _, cap_t, _ = step_hold(torch, chain, "tanh chain (a)", chain.mcpc_chain,
                                              (params, latents, data, SEED), tanh_a, sincos_err,
                                              original=option_parts(out_tanh, tanh_a), keep=True)
    X_t, _ = kernel_state(cap_t, TANH_A_CUT["T"], tanh_a)
    dx_t = float((X_t - torch.cat([x.double() for x in ref_t[0]], dim=1)).abs().max())
    del cap_t
    check(all(bool(torch.isfinite(x).all()) for x in out_tanh[0]), "tanh chain (a) not finite")
    print(f"phase 5: chain (a) with tanh, B={BATCH} T={CHAIN_A['T']}: kernel {tanh_ms:.3f} ms, "
          f"{1e3 * tanh_ms / CHAIN_A['T']:.3f} us/step; relu {a_ms:.3f} ms in phase 2 "
          f"({1e3 * a_ms / CHAIN_A['T']:.3f} us/step); bound {bound_a:.3f} ms (operations); "
          f"plain version at T={TANH_A_CUT['T']} {tanh_plain_ms:.3f} ms (timed while nvcc ran), "
          f"max|dx| from the kernel's state there {dx_t:.3e}; {text_t} {tag}")
    check(not failed_t, "phase 5: " + "; ".join(failed_t))
    del ref_t

    print(f"phase 5 ends at {time.perf_counter() - t_start:.1f} s")
    # ---------------------------------------------------------- phase 6
    # bf16 products: both kernels' bf16 builds against the plain bf16
    # version, by the rules of BF16_* (module top)
    bf = dict(bf16_matmul=True)
    bf16_failed = []
    # the bf16 libraries' products run on the tensor cores: HMMA in every
    # chain kernel of theirs, all in the BF16 forms, none in the f32
    # libraries (cuobjdump -sass)
    t_sass = time.perf_counter()
    for job in sass_jobs:
        job.result()
    sass_pool.shutdown()
    for (source, bf16), lib_path in zip(libraries, lib_paths):
        if not source.startswith("mcpc_chain"):
            continue
        forms = ("HMMA.16816.F32.BF16", "HMMA.1688.F32.BF16")
        counts = {op: _build.sass_counts(lib_path, op) for op in ("HMMA",) + forms}
        hmma = {_build.kernel_name(f): {op: counts[op][f] for op in counts}
                for f in counts["HMMA"] if "mcpc_chain_kernel" in f}
        name = source + ("_bf16" if bf16 else "")
        print(f"phase 6: HMMA in {name}: " + ", ".join(
            f"{k}: " + " ".join(f"{op} {n}" for op, n in c.items())
            for k, c in sorted(hmma.items())))
        check(len(hmma) == (16 if source == "mcpc_chain" else 4),
              f"{name}: {len(hmma)} chain kernels in its SASS")
        check(all(c["HMMA"] >= 3 and c["HMMA"] == sum(c[op] for op in forms)
                  for c in hmma.values()) if bf16 else not any(c["HMMA"] for c in hmma.values()),
              f"{name}: HMMA where it should not be, missing where it should, or in "
              f"another form than {' or '.join(forms)}")
    print(f"phase 6: the SASS counts took {time.perf_counter() - t_sass:.1f} s (the libraries "
          f"disassembled during phase 1)")

    def bf16_runs(p_in, l_in, t_in, kw):
        """(kernel bf16, plain bf16, plain bf16 in float64, plain f32)"""
        kb = dict(kw, **bf)
        got = chain.mcpc_chain(p_in, l_in, t_in, SEED, **kb)
        torch.cuda.synchronize()
        ref = chain.mcpc_chain_reference(p_in, l_in, t_in, SEED, **kb)
        ref64 = chain.mcpc_chain_reference(*to_double(p_in, l_in, t_in), SEED, **doubled(kb))
        f32 = chain.mcpc_chain_reference(p_in, l_in, t_in, SEED, **kw)
        return got, ref, ref64, f32

    def one_step_held(name, runs):
        """Rule (i): (the report, what failed)."""
        got, ref, _, f32 = runs
        lat_tol = lambda b: BF16_STEP_ATOL   # noqa: E731
        grad_tol = lambda b: BF16_STEP_GRAD_REL * b.abs().max()   # noqa: E731

        def grad_pairs(a):
            return [(x[k], y[k]) for x, y in zip(a[1], ref[1]) for k in ("w", "b")]

        share, share_f32 = (agree_share(zip(o[0], ref[0]), lat_tol) for o in (got, f32))
        gshare, gshare_f32 = (agree_share(grad_pairs(o), grad_tol) for o in (got, f32))
        d, eff = max_abs(got[0], ref[0]), max_abs(f32[0], ref[0])
        g, geff = grad_rel(got[1], ref[1]), grad_rel(f32[1], ref[1])
        text = (f"latents within {BF16_STEP_ATOL} of the plain bf16 version: kernel "
                f"{share:.5f}, plain f32 {share_f32:.5f}; gradient entries within "
                f"{BF16_STEP_GRAD_REL} of their largest: kernel {gshare:.5f}, plain f32 "
                f"{gshare_f32:.5f}; max|dx| kernel-plain {d:.3e} (bf16 effect {eff:.3e}); "
                f"gradients kernel-plain {g:.3e} (bf16 effect {geff:.3e})")
        failed = []
        if not (share >= BF16_AGREE and gshare >= BF16_AGREE):
            failed.append(f"{name}: {share} of the latents, {gshare} of the gradients agree")
        if not (d <= BF16_SHARE * eff and g <= BF16_SHARE * geff):
            failed.append(f"{name}: latents {d} (effect {eff}), gradients {g} (effect {geff})")
        if share_f32 >= BF16_AGREE:
            failed.append(f"{name}: the rule does not tell f32 from bf16 here")
        return text, failed

    def share_held(name, runs, kw, dims=FID):
        """Rule (ii): (the report, what failed)."""
        got, ref, ref64, f32 = (option_parts(o, kw) for o in runs)
        line, failed = [], []
        for part, err, floor in (("latents", rms_abs, P1_ATOL), ("traj", rms_abs, P1_ATOL),
                                 ("traj3", rms_abs, P1_ATOL),
                                 ("scalars", scalar_rel, P1_RTOL),
                                 ("pgrads", rms_rel, P1_GRAD_REL),
                                 ("moments", rms_rel, P1_MOMENT_REL)):
            if got.get(part) is None:
                continue
            if part in ("traj", "traj3"):
                g, r, r64, f = ([o[part]] for o in (got, ref, ref64, f32))
            else:
                g, r, r64, f = (o[part] for o in (got, ref, ref64, f32))
            e, e64, p64 = err(g, r), err(g, r64), err(r, r64)
            eff, eff64 = err(f, r), err(f, r64)
            line.append(f"{part} kernel-plain {e:.3e} (bf16 effect {eff:.3e}), "
                        f"kernel-plain64 {e64:.3e}, plain-plain64 {p64:.3e} (effect "
                        f"{eff64:.3e})")
            if part == "latents":
                line.append(f"latents' largest difference kernel-plain "
                            f"{max_abs(g, r):.3e} (bf16 effect {max_abs(f, r):.3e})")
            if not (e <= BF16_SHARE * eff or e <= floor):
                failed.append(f"{name}: {part} kernel-plain {e}, bf16 effect {eff}")
            if not (e64 <= p64 + BF16_SHARE * eff64 or e64 <= floor):
                failed.append(f"{name}: {part} kernel-plain64 {e64}, plain-plain64 {p64}, "
                              f"bf16 effect {eff64}")
        act = kw.get("activation", "relu")
        energies = [mean_row_energy(torch, p_row, o["latents"], act) for o in (got, ref, f32)]
        line.append("mean row energy kernel {:.4f}, plain bf16 {:.4f}, plain f32 {:.4f}"
                    .format(*energies))
        return "; ".join(line), failed

    one_step = dict(T=1, lr=0.1, noise_var=None, with_pgrads=True, mixing=0)
    long_kw = dict(warm_T=50, warm_lr=0.1, T=100, lr=0.03, noise_var=2.0, with_pgrads=True,
                   mixing=20, return_scalars=True)
    draw6 = torch.Generator().manual_seed(SEED + 6)
    bf16_cases = [
        ("relu, one step", one_step, 1),
        ("tanh, one step", dict(one_step, activation="tanh"), 1),
        ("unpacked, one step", dict(one_step, packed=False), 1),
        ("relu, warm 50 + Langevin 100, gradients", long_kw, 2),
        ("tanh, warm 50 + Langevin 100, gradients", dict(long_kw, activation="tanh"), 2),
        ("relu, warm-only 50, warm_pgrads",
         dict(warm_T=50, warm_lr=0.1, T=0, lr=0.1, with_pgrads=True, warm_pgrads=True,
              return_scalars=True), 2),
        ("unpacked, Langevin 150, gradients",
         dict(T=150, lr=0.01, noise_var=2.0, with_pgrads=True, mixing=50, packed=False), 2),
    ]
    for B in (OPT_B, BATCH):
        p_in, l_in, t_in = random_case(FID, B)
        mu6 = tuple((0.1 * torch.randn(x.shape, generator=draw6)).to(dev) for x in l_in)
        nu6 = tuple((0.01 * torch.rand(x.shape, generator=draw6)).to(dev) for x in l_in)
        cases = [(n, kw, rule, (p_in, l_in, t_in)) for n, kw, rule in bf16_cases]
        if B == OPT_B:   # the options' instantiation
            cases += [
                ("options: masked perc 0.5, captured every 5 steps",
                 dict(long_kw, loss="bernoulli_mask", mask_perc=0.5, capture_stride=5), 2,
                 (p_in, l_in, t_in)),
                ("options: tanh, scalars every 7 steps",
                 dict(long_kw, activation="tanh", scalar_stride=7), 2, (p_in, l_in, t_in)),
                ("options: continuation from given moments, handing them out",
                 dict(warm_T=50, warm_lr=0.1, T=0, lr=0.1, warm_mu=mu6, warm_nu=nu6,
                      warm_count=7, emit_warm_opt_state=True, return_scalars=True), 2,
                 (p_in, l_in, t_in)),
                ("options: the output-PC site, gradients, captures",
                 dict(long_kw, capture_stride=10, **OUT_PC), 2,
                 output_pc_case(B) + (None,)),
            ]
        for name, kw, rule, (p_row, l_row, t_row) in cases:
            runs = bf16_runs(p_row, l_row, t_row, kw)
            if rule == 1:
                text, failed = one_step_held(name, runs)
            else:
                text, failed = share_held(name, runs, kw)
            print(f"phase 6: bf16 {name}: B={B} [{plan_text(FID, B, dict(kw, **bf))}] rule "
                  f"({'i' * rule}): {text}")
            bf16_failed += failed
            del runs
    # both kernels' tensor-core products in four waves (B=1024), and the
    # output-PC site at the main path's batch; drawn from a generator of
    # their own, so the other cases keep their inputs
    gen_12 = torch.Generator().manual_seed(SEED + 12)
    for name, B, kw, rule, inputs in (
        ("relu, one step", 1024, one_step, 1, None),
        ("tanh, one step", 1024, dict(one_step, activation="tanh"), 1, None),
        ("unpacked, one step", 1024, dict(one_step, packed=False), 1, None),
        ("the output-PC site, gradients, captures", BATCH,
         dict(long_kw, capture_stride=10, **OUT_PC), 2, "output_pc"),
    ):
        p_row, l_row, t_row = (output_pc_case(B, gen_12) + (None,) if inputs
                               else random_case(FID, B, gen_12))
        runs = bf16_runs(p_row, l_row, t_row, kw)
        text, failed = (one_step_held(name, runs) if rule == 1
                        else share_held(name, runs, kw))
        print(f"phase 6: bf16 {name}: B={B} [{plan_text(FID, B, dict(kw, **bf))}] rule "
              f"({'i' * rule}): {text}")
        bf16_failed += failed
        del runs
    # the unpacked kernel beyond one tile, and at 10-256-256-784 with its
    # gradient slice through L2
    for name, dims, B, kw, rule in (
        ("unpacked, one step", FID, 1100, dict(one_step, packed=False), 1),
        ("unpacked at 10-256-256-784, Langevin 150, gradients", MSE, BATCH,
         dict(T=150, lr=0.01, noise_var=2.0, with_pgrads=True, mixing=50, packed=False), 2),
    ):
        p_row, l_row, t_row = random_case(dims, B, gen_c)
        runs = bf16_runs(p_row, l_row, t_row, kw)
        text, failed = (one_step_held(name, runs) if rule == 1
                        else share_held(name, runs, kw))
        print(f"phase 6: bf16 {name}: B={B} [{plan_text(dims, B, dict(kw, **bf))}] rule "
              f"({'i' * rule}): {text}")
        bf16_failed += failed
        del runs
    check(not bf16_failed, "phase 6 " + "; ".join(bf16_failed))
    print(f"phase 6: the holds end at {time.perf_counter() - t_start:.1f} s")

    # the bf16 path as users take it, the counts zeroed just before and read
    # just after: PCTrainer's opt-in, bench.py's bf16 rows, chain (c) in bf16
    cfg_ml = train_mnist.apply_preset(train_mnist.pc_training_config(), "ml", "pc")
    gen_ml = get_model(cfg_ml, SEED, device=dev)
    pc_batch = data[: cfg_ml["batch_size_train"]]
    pc_pseudo = torch.zeros(pc_batch.shape[0], cfg_ml["input_size"], device=dev)
    data_1024 = torch.cat([b for b, _ in itertools.islice(iter(test), 4)])
    check(tuple(data_1024.shape) == (1024, 784), f"a batch of {tuple(data_1024.shape)}")
    lat_1024 = gen_model.model.init_latents(
        params, torch.zeros(1024, FID[0], device=dev), torch.Generator().manual_seed(SEED + 7))
    bench_in = {BATCH: (latents, data), 1024: (lat_1024, data_1024)}
    train_opts = train_mnist.chain_options(config)
    param_opt6 = train_mnist.param_optimizer(config)

    def train_step(lat, d, bf16):
        """bench.py's training step: one_batch with the flag"""
        _, pg = chain.mcpc_chain(params, lat, d, SEED, **dict(train_opts, bf16_matmul=bf16))
        scale = config["sampling"] * d.shape[0]
        upd, _ = param_opt6.update(tuple({k: v / scale for k, v in g.items()} for g in pg),
                                   param_opt6.init(params), params)
        return apply_updates(params, upd)

    zero_counts()
    trainers = {}
    for mode in (True, "auto"):
        trainer = train_mnist.get_pc_trainer(gen_ml, cfg_ml, is_mcpc=False, training=True)
        trainer.use_kernel_bf16 = mode
        before = read_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        trainer.train_on_batch(pc_pseudo, loss_fn=cfg_ml["loss_fn"],
                               loss_fn_kwargs={"_target": pc_batch},
                               is_return_results_every_t=False)
        end.record()
        end.synchronize()
        trainers[mode] = (trainer, [a - b for a, b in zip(read_counts(), before)],
                          start.elapsed_time(end))
    for mode, (trainer, counts, ms) in trainers.items():
        print(f"phase 6: PCTrainer use_kernel_bf16={mode!r}, a PC training batch at preset "
              f"ml (B={pc_batch.shape[0]}, {cfg_ml['T_pc']} Adam steps): kernel calls "
              f"{trainer.kernel_calls}, engine calls {trainer.engine_calls}; launches f32 "
              f"{counts[0]}, bf16 {counts[3]}; {ms:.3f} ms {tag}")
        check(trainer.kernel_calls == 1 and trainer.engine_calls == 0,
              f"PCTrainer use_kernel_bf16={mode!r} did not take the kernel")
    check(trainers[True][1][3] == 1 and trainers[True][1][0] == 0,
          "use_kernel_bf16=True did not launch the bf16 kernel")
    check(trainers["auto"][1][0] == 1 and trainers["auto"][1][3] == 0,
          "use_kernel_bf16='auto' did not stay f32")

    bench_rows = {}
    for B in (BATCH, 1024):
        lat_b, d_b = bench_in[B]
        for bf16 in (False, True):
            ms, out = cuda_ms(torch, lambda: chain.mcpc_chain(
                params, lat_b, d_b, SEED, return_scalars=True, bf16_matmul=bf16, **CHAIN_A))
            check(all(bool(torch.isfinite(x).all()) for x in out[0]),
                  f"chain (a) B={B} bf16={bf16} not finite")
            step_ms, new_p = cuda_ms(torch, lambda: train_step(lat_b, d_b, bf16), reps=5)
            check(all(bool(torch.isfinite(p[k]).all()) for p in new_p for k in ("w", "b")),
                  f"training step B={B} bf16={bf16} not finite")
            bench_rows[B, bf16] = (ms, step_ms)
        for bf16 in (False, True):
            ms, step_ms = bench_rows[B, bf16]
            steps = train_opts["warm_T"] + train_opts["T"]
            print(f"phase 6: bench row {'bf16' if bf16 else 'f32 '} B={B}: chain (a) T="
                  f"{CHAIN_A['T']} {ms:.3f} ms, {1e3 * ms / CHAIN_A['T']:.3f} us/step, "
                  f"{CHAIN_A['T'] / (ms / 1e3):.1f} steps/s; training step {step_ms:.3f} ms, "
                  f"{1e3 * step_ms / steps:.3f} us/step, {B / (step_ms / 1e3):.1f} images/s; "
                  f"bound (a) {chain_bound_ms(FID, B, CHAIN_A['T'], peak=PEAK_BF16_FLOPS if bf16 else PEAK_F32_FLOPS):.3f} ms; "
                  f"[{plan_text(FID, B, dict(CHAIN_A, bf16_matmul=bf16))}] {tag}")
    # chains (a) and (c) in bf16 cut to T=1000, held by rule (ii) and timed
    # beside the plain version and their bounds
    bf16_a, bf16_c = BF16_A, BF16_C
    a16_ms, out_a16 = cuda_ms(torch, lambda: chain.mcpc_chain(params, latents, data, SEED,
                                                              **bf16_a))
    c16_ms, out_c16 = cuda_ms(torch, lambda: chain.mcpc_chain(params, latents, data, SEED,
                                                              **bf16_c))
    torch.cuda.synchronize()
    counts6 = read_counts()
    print(f"phase 6: main path launches: mcpc_chain_bf16 {counts6[3]}, "
          f"mcpc_chain_unpacked_bf16 {counts6[4]}, mcpc_chain {counts6[0]}, "
          f"sum_block_partials {counts6[2]}")
    check(counts6[3] >= 1, "the bf16 path did not launch the packed bf16 kernel")
    check(counts6[4] >= 1, "the bf16 path did not launch the unpacked bf16 kernel")
    chains16 = {}
    for name, kw16, out16, ms16 in (("a", bf16_a, out_a16, a16_ms),
                                    ("c, unpacked", bf16_c, out_c16, c16_ms)):
        # the plain versions ran while nvcc built the kernels; chain (c)'s
        # plain f32 version is phase 2's
        plain_ms16, ref16 = pre.pop("c16" if kw16 is bf16_c else "a16")
        f32_16 = ref_c if kw16 is bf16_c else pre.pop("a16 in f32")[1]
        err16, eff16 = max_abs(out16[0], ref16[0]), max_abs(f32_16[0], ref16[0])
        rms16, rms_eff16 = rms_abs(out16[0], ref16[0]), rms_abs(f32_16[0], ref16[0])
        bound16 = chain_bound_ms(FID, BATCH, kw16["T"], peak=PEAK_BF16_FLOPS)
        bound16_f32 = chain_bound_ms(FID, BATCH, kw16["T"])
        chains16[name] = (ms16, plain_ms16, err16, bound16, bound16_f32)
        print(f"phase 6: chain ({name}) bf16, B={BATCH} T={kw16['T']}: kernel {ms16:.3f} ms, "
              f"{1e3 * ms16 / kw16['T']:.3f} us/step; plain bf16 {plain_ms16:.3f} ms (timed while nvcc ran); rms|dx| "
              f"kernel-plain {rms16:.3e}, bf16 effect {rms_eff16:.3e} (share {BF16_SHARE}); "
              f"max|dx| kernel-plain {err16:.3e}, bf16 effect {eff16:.3e}; mean "
              f"row energy kernel {mean_row_energy(torch, params, out16[0], 'relu'):.4f}, plain "
              f"{mean_row_energy(torch, params, ref16[0], 'relu'):.4f}; bound {bound16:.3f} ms "
              f"at the bf16 tensor-core peak, {bound16_f32:.3f} ms at the f32 peak of the CUDA "
              f"cores (operations) {tag}")
        check(rms16 <= BF16_SHARE * rms_eff16,
              f"phase 6: chain ({name}) bf16 {rms16} (rms) from the plain version, "
              f"effect {rms_eff16}")
    # where a step's SM clocks go, f32 beside bf16, at chain (a) cut to
    # PHASE_CLOCK_T steps (thread 0 of each block, barrier waits included)
    for bf16 in (False, True):
        kw_pc = dict(CHAIN_A, T=PHASE_CLOCK_T, bf16_matmul=bf16)
        clocks = chain.chain_phase_clocks(params, latents, data, SEED, **kw_pc)
        per_step = (clocks.double().mean(dim=0) / PHASE_CLOCK_T).tolist()
        total_clk = sum(per_step)
        print(f"phase 6: phase clocks, chain (a) {'bf16' if bf16 else 'f32 '} T={PHASE_CLOCK_T} "
              f"[{plan_text(FID, BATCH, kw_pc)}]: SM clocks a step "
              + ", ".join(f"{p} {c:.0f} ({100 * c / total_clk:.1f}%)"
                          for p, c in zip(chain.PHASES, per_step))
              + f"; sum {total_clk:.0f} {tag}")

    # train_mcpc's trainer path: two PCTrainer calls a batch, both to the chain
    made, spans = [], []

    def recording(factory, kind):
        def make(*args, **kwargs):
            trainer = factory(*args, **kwargs)
            call = trainer.train_on_batch

            def timed(*a, **k):
                if kind == "warm":
                    spans.append([torch.cuda.Event(enable_timing=True),
                                  torch.cuda.Event(enable_timing=True)])
                    spans[-1][0].record()
                out = call(*a, **k)
                if kind == "mcpc":
                    spans[-1][1].record()
                return out

            trainer.train_on_batch = timed
            made.append(trainer)
            return trainer
        return make

    factories = train_mnist.get_pc_trainer, train_mnist.get_mcpc_trainer
    train_mnist.get_pc_trainer = recording(factories[0], "warm")
    train_mnist.get_mcpc_trainer = recording(factories[1], "mcpc")
    initial = get_model(config, SEED, device=dev).params
    loss_before6 = test_loss(initial)
    zero_counts()
    try:
        trained = train_mnist.train_mcpc(
            1, os.path.join(here, "build", "chip_smoke", "mcpc_trainer_path"), seed=SEED,
            batches_per_epoch=TRAINER_BATCHES, log=False, fused=False, device="cuda")
    finally:
        train_mnist.get_pc_trainer, train_mnist.get_mcpc_trainer = factories
    torch.cuda.synchronize()
    counts_tp = read_counts()
    loss_after6 = test_loss(trained.params)
    path_ms = [s.elapsed_time(e) for s, e in spans]
    engine_calls = sum(t.engine_calls for t in made)
    print(f"phase 6: train_mcpc(fused=False), {TRAINER_BATCHES} batches of B={BATCH}: chain "
          f"launches {counts_tp[0]}, summing passes {counts_tp[2]}, kernel calls "
          f"{sum(t.kernel_calls for t in made)}, engine calls {engine_calls}; "
          f"{statistics.median(path_ms[1:]):.3f} ms/batch (median of {len(path_ms) - 1}, "
          f"first {path_ms[0]:.3f}) against one_batch's {train_ms:.3f} ms (phase 3); test "
          f"batch's Bernoulli loss {loss_before6:.1f} -> {loss_after6:.1f} {tag}")
    check(counts_tp[0] == 2 * TRAINER_BATCHES and counts_tp[2] == TRAINER_BATCHES,
          f"train_mcpc(fused=False): {counts_tp[0]} chain launches and {counts_tp[2]} summing "
          f"passes for {TRAINER_BATCHES} batches")
    check(engine_calls == 0 and len(made) == 2, "train_mcpc(fused=False) ran the engine")
    for p, p0 in zip(trained.params, initial):
        check(all(bool(torch.isfinite(p[k]).all()) for k in ("w", "b")),
              "train_mcpc(fused=False): parameters not finite")
        check(not torch.equal(p["b"], p0["b"]), "train_mcpc(fused=False) left a bias unchanged")
    check(loss_after6 < loss_before6, "train_mcpc(fused=False) did not lower the test loss")
    print(f"phase 6 ends at {time.perf_counter() - t_start:.1f} s")
    # ---------------------------------------------------------- phase 7
    # table 1 end to end and figure 2e.  cuDNN's TF32 flag goes back to
    # torch's default (True): the port's ResNet-9 and Inception functions
    # must turn it off themselves, and this phase holds that they do.
    from montecarlopredictivecoding_tpu_torch.data.mnist import load_mnist_arrays
    from montecarlopredictivecoding_tpu_torch.eval import fid as fid_mod
    from montecarlopredictivecoding_tpu_torch.experiments import table_1
    from montecarlopredictivecoding_tpu_torch.models import resnet9 as r9
    from montecarlopredictivecoding_tpu_torch.models.dlgm import DLGM

    # table 1 reads the FID statistics under ./MNIST_data, as the JAX
    # package does: run it from the checkout's root
    os.chdir(here)
    torch.backends.cudnn.allow_tf32 = True
    r9_path = os.path.join(here, "models", "resnet9.msgpack")
    model_r9, state_r9 = r9.load_resnet9(r9_path, device=dev)
    feats_fn = fid_mod.make_resnet9_features(state_r9)
    _, (te_x, _) = load_mnist_arrays(os.path.join(here, "MNIST_data"))
    feats_fn(te_x[:R9_CPU_IMAGES])  # cuDNN's set-up
    torch.cuda.synchronize()
    t7 = time.perf_counter()
    feats = feats_fn(te_x)
    feat_ms = 1e3 * (time.perf_counter() - t7)
    check(torch.backends.cudnn.allow_tf32, "the feature function left cuDNN's TF32 flag off")
    check(feats.shape == (len(te_x), 256) and bool(np.isfinite(feats).all()),
          f"ResNet-9 features of shape {feats.shape}, or not finite")
    cpu_state = r9.ResNet9State({k: v.cpu() for k, v in state_r9.params.items()},
                                {k: v.cpu() for k, v in state_r9.batch_stats.items()}, None)
    cpu_feats = fid_mod.make_resnet9_features(cpu_state)(te_x[:R9_CPU_IMAGES])
    feat_err = float(np.abs(feats[:R9_CPU_IMAGES] - cpu_feats).max() / np.abs(cpu_feats).max())
    # the same module with TF32 left on, to show what the hold tells apart
    with torch.no_grad():
        model_r9.eval()
        x_sub = torch.from_numpy(te_x[:R9_CPU_IMAGES].reshape(-1, 1, 28, 28)).to(dev)
        tf32_feats = torch.func.functional_call(
            model_r9, {**state_r9.params, **state_r9.batch_stats}, (x_sub,),
            {"return_features": True})[1].cpu().numpy()
    tf32_err = float(np.abs(tf32_feats - cpu_feats).max() / np.abs(cpu_feats).max())
    image_flops = conv_net_flops(torch, model_r9, x_sub[:1])
    feat_bound_ms = 1e3 * image_flops * 1000 / PEAK_F32_FLOPS
    print(f"phase 7: ResNet-9 features of the {len(te_x)} synthetic test images on the card: "
          f"{feat_ms:.3f} ms in all, {1e3 * feat_ms / len(te_x):.3f} ms per 1000 images (batches "
          f"of 500, host copies included), bound {feat_bound_ms:.3f} ms per 1000 "
          f"({image_flops / 1e9:.4f} GFLOP an image at the f32 peak, operations); card "
          f"against the CPU on {R9_CPU_IMAGES} images: "
          f"max|d| {feat_err:.3e} of the largest (bound {R9_FEAT_RTOL}); with cuDNN's TF32 "
          f"left on: {tf32_err:.3e} {tag}")
    check(feat_err <= R9_FEAT_RTOL, f"phase 7: card features {feat_err} from the CPU's")

    # (ii) the reference statistics, built fresh
    stats_root = tempfile.mkdtemp(prefix="fid_stats_", dir=os.path.join(here, "build",
                                                                        "chip_smoke"))
    cache = os.path.join(here, "MNIST_data", "MNIST")
    for extractor, tag_name in ((fid_mod.pixel_features, "pixel_features"),
                                (feats_fn, "resnet9")):
        t7 = time.perf_counter()
        fresh = fid_mod.make_mnist_fid_stats(extractor, root=stats_root)
        build_s = time.perf_counter() - t7
        for split, got in zip(("val", "test"), fresh):
            ref = fid_mod.FIDStats.load(os.path.join(
                cache, f"{split}_img_{tag_name}_synthetic-v1n10000.npz"))
            d_mu = float(np.abs(got.mu - ref.mu).max() / np.abs(ref.mu).max())
            d_sig = float(np.abs(got.sigma - ref.sigma).max() / np.abs(ref.sigma).max())
            dist = fid_mod.compute_fid(got, ref)
            print(f"phase 7: {tag_name} {split} statistics built fresh in {build_s:.2f} s: "
                  f"max|d mu| {d_mu:.3e}, max|d sigma| {d_sig:.3e} of the largest, FID to "
                  f"the repo's cache {dist:.3e}")
            bound = PIXEL_STATS_RTOL if tag_name == "pixel_features" else R9_STATS_RTOL
            check(d_mu <= bound and d_sig <= bound,
                  f"phase 7: {tag_name} {split} statistics {d_mu}, {d_sig} from the cache")
    shutil.rmtree(stats_root)

    # (iii) table 1 at full width
    ctx7 = common.ExperimentContext(os.path.join(here, "models"),
                                    os.path.join(here, "build", "chip_smoke", "figures"),
                                    scale=1.0, device=str(dev))
    columns, col_s = {}, {}

    def column(name, fn):
        torch.cuda.synchronize()
        t_col = time.perf_counter()
        columns[name] = fn()
        torch.cuda.synchronize()
        col_s[name] = time.perf_counter() - t_col

    column("FID (ResNet-9)", lambda: table_1.get_models_fids(
        ctx7, seeds=TABLE_SEEDS, n_samples=FID_SAMPLES, feature_fn=feats_fn))
    column("FID (pixels)", lambda: table_1.get_models_fids(
        ctx7, seeds=TABLE_SEEDS, n_samples=FID_SAMPLES))
    calls = []
    PCTrainer.train_on_batch = timed
    try:
        torch.cuda.synchronize()
        zero_counts()
        column("MSE", lambda: table_1.get_models_mse(ctx7, seeds=TABLE_SEEDS))
        counts_mse = read_counts()
    finally:
        PCTrainer.train_on_batch = train_on_batch
    mse_calls = list(calls)
    column("marginal likelihood", lambda: table_1.get_models_ml(
        ctx7, seeds=TABLE_SEEDS, n_samples=ML_SAMPLES))
    fallbacks7 = sum(t.engine_calls for t in {id(c["trainer"]): c["trainer"]
                                              for c in mse_calls}.values())
    for name, table in columns.items():
        check(table.shape == (len(TABLE_SEEDS), 3) and bool(np.isfinite(table).all()),
              f"phase 7: table 1's {name} column is not finite")
        for i, s in enumerate(TABLE_SEEDS):
            print(f"phase 7: table 1 {name}, seed {s}: MCPC {table[i, 0]:.6f}, PC "
                  f"{table[i, 1]:.6f}, DLGM {table[i, 2]:.6f}")
        print(f"phase 7: table 1 {name}: {col_s[name]:.3f} s for {len(TABLE_SEEDS)} seeds "
              f"(host work included) {tag}")
    check(bool((columns["MSE"] > 0).all() and (columns["MSE"] < 1).all()),
          "phase 7: an MSE outside (0, 1)")
    check(bool((columns["marginal likelihood"] < 0).all()), "phase 7: a log-likelihood above 0")
    print(f"phase 7: table 1's MSE column: mcpc_chain launches {counts_mse[0]}, "
          f"sum_block_partials {counts_mse[2]}, PCTrainer "
          f"calls {len(mse_calls)} (kernel {sum(c['kernel'] for c in mse_calls)}), engine "
          f"fallbacks {fallbacks7}; a call {min(c['ms'] for c in mse_calls):.3f}-"
          f"{max(c['ms'] for c in mse_calls):.3f} ms (B {sorted({c['B'] for c in mse_calls})})")
    check(counts_mse[0] >= 1, "table 1's MSE column did not launch the chain kernel")
    check(fallbacks7 == 0 and all(c["kernel"] for c in mse_calls),
          "a call of table 1's MSE column ran in the step engine")

    # (iv) DLGM and ResNet-9 training steps at their batch sizes
    step_ms, step_loss = {}, {}

    def timed_step(name, fn):
        def step(*a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            end.synchronize()
            step_ms.setdefault(name, []).append(start.elapsed_time(end))
            loss = out if isinstance(out, torch.Tensor) else out[1]
            step_loss.setdefault(name, []).append(float(loss))
            return out
        return step

    dlgm_step, r9_make = DLGM.train_step, r9.make_train_step
    DLGM.train_step = lambda self, x, eps=None: timed_step("DLGM", dlgm_step)(self, x, eps)
    r9.make_train_step = lambda model, tx: timed_step("ResNet-9", r9_make(model, tx))
    try:
        dlgm = train_mnist.train_dlgm(1, os.path.join(here, "build", "chip_smoke", "dlgm_fid"),
                                      seed=SEED, log=False, preset="fid",
                                      batches_per_epoch=DLGM_STEPS, device=dev)
        _, r9_state = train_mnist.train_resnet9_entry(
            1, os.path.join(here, "build", "chip_smoke", "resnet9"), seed=SEED,
            batches_per_epoch=R9_STEPS, log_every=0, device=dev)
    finally:
        DLGM.train_step, r9.make_train_step = dlgm_step, r9_make
    check(torch.backends.cudnn.allow_tf32, "the ResNet-9 train step left cuDNN's TF32 flag off")
    for name, B in (("DLGM", 64), ("ResNet-9", 128)):
        ms, losses = step_ms[name], step_loss[name]
        first, last = losses[0], statistics.mean(losses[-5:])
        print(f"phase 7: {name} training, {len(ms)} steps of B={B}: "
              f"{statistics.median(ms[1:]):.3f} ms a step (median; first {ms[0]:.3f}); loss "
              f"{first:.4f} -> {last:.4f} (mean of the last 5) {tag}")
        check(len(ms) == (DLGM_STEPS if name == "DLGM" else R9_STEPS), f"{name}: steps missing")
        check(np.isfinite(losses).all() and last < first, f"phase 7: {name}'s loss did not fall")
    # where a step's time goes: the device's busy time against the wall
    x64 = next(iter(get_mnist_data({"batch_size_train": 64, "batch_size_val": 64,
                                    "batch_size_test": 64}, device=dev)[0]))[0]
    train128 = next(iter(get_mnist_data({"batch_size_train": 128, "batch_size_val": 128,
                                         "batch_size_test": 128}, device=dev)[0]))
    r9_step = r9.make_train_step(r9.ResNet9().to(dev), port.OptimizerSpec("adam", lr=1e-3).make())
    x128, y128 = train128[0].reshape(-1, 1, 28, 28), train128[1]
    for name, fn in (("DLGM", lambda: dlgm.train_step(x64)),
                     ("ResNet-9", lambda: r9_step(r9_state, x128, y128))):
        wall, busy, top = profiled_ms(torch, fn)
        step = statistics.median(step_ms[name][1:])
        shown = "not measured (no device time in the trace)" if busy is None else (
            f"{busy:.3f} ms busy a step, idle {100 * (1 - busy / step):.1f}% of the "
            f"unprofiled {step:.3f} ms")
        print(f"phase 7: {name} step under torch.profiler, 10 steps: {wall:.3f} ms wall a step, "
              f"device {shown}; most device time: " + "; ".join(
                  f"{k[:60]} {ms:.3f} ms ({n} a step)" for k, ms, n in top) + f" {tag}")
    _, reloaded = r9.load_resnet9(os.path.join(here, "build", "chip_smoke", "resnet9.msgpack"),
                                  device=dev)
    check(all(torch.equal(reloaded.params[k], v) for k, v in r9_state.params.items()),
          "phase 7: the ResNet-9 file does not reload bit for bit")
    check(all(bool(torch.isfinite(t).all()) for t in dlgm.gen_params["T"][0].values()),
          "phase 7: DLGM parameters not finite")

    # (v) figure 2e with the shipped ResNet-9
    calls = []
    PCTrainer.train_on_batch = timed
    try:
        torch.cuda.synchronize()
        zero_counts()
        t7 = time.perf_counter()
        kls = figure_2.comparison_ideal_observer(ctx7, resnet_state=state_r9)
        torch.cuda.synchronize()
        fig2e_s = time.perf_counter() - t7
        counts_2e = read_counts()
    finally:
        PCTrainer.train_on_batch = train_on_batch
    fallbacks_2e = sum(t.engine_calls for t in {id(c["trainer"]): c["trainer"]
                                                for c in calls}.values())
    print(f"phase 7: figure 2e: KL(ideal observer || ·) " + ", ".join(
        f"{k} {v:.6f}" for k, v in kls.items()) + f"; {fig2e_s:.3f} s (host work included); "
          f"mcpc_chain launches {counts_2e[0]}, sum_block_partials {counts_2e[2]}, "
          f"PCTrainer calls {len(calls)}, engine "
          f"fallbacks {fallbacks_2e}; " + ", ".join(
              f"B={c['B']} {c['steps']} {c['mode']} steps {c['ms']:.3f} ms" for c in calls)
          + f" {tag}")
    check(all(np.isfinite(v) and v >= 0 for v in kls.values()), "figure 2e: a KL not finite")
    check(counts_2e[0] >= 1 and fallbacks_2e == 0, "figure 2e did not run through the kernel")
    torch.backends.cudnn.allow_tf32 = False
    counts7 = tuple(a + b for a, b in zip(counts_mse, counts_2e))
    print(f"phase 7 ends at {time.perf_counter() - t_start:.1f} s")
    # ---------------------------------------------------------- phase 8
    # figures 2 (a, b), 4, 5 and 6.  The kernel paths (figure 5's chains,
    # 4e's MAP inference) at the published step counts; the 1-D models,
    # which the step engine runs, at FIG_ENGINE_SCALE on 3 data batches
    from montecarlopredictivecoding_tpu_torch.experiments import figure_4, figure_5, figure_6
    from montecarlopredictivecoding_tpu_torch.models import dlgm_stacked

    for seed in FIG5_SEEDS:
        for epoch in FIG5_EPOCHS:
            name = figure_5.epoch_checkpoint(seed, epoch)
            check(os.path.isfile(os.path.join(here, "models", name + ".msgpack")),
                  f"models/{name}.msgpack is missing")
    fig_dir = os.path.join(here, "build", "chip_smoke", "figures")
    ctx8 = common.ExperimentContext(os.path.join(here, "models"), fig_dir, scale=1.0,
                                    device="cuda")
    calls = []
    recorder = ChainRecorder(torch, chain.mcpc_chain)
    parts8, wall8, out8 = {}, {}, {}

    def part8(name, fn):
        """Run one path; remember its PCTrainer calls, its result and its
        wall time (host work included)."""
        first = len(calls)
        torch.cuda.synchronize()
        t_part = time.perf_counter()
        out8[name] = fn()
        torch.cuda.synchronize()
        wall8[name] = time.perf_counter() - t_part
        parts8[name] = (first, len(calls))

    PCTrainer.train_on_batch = timed
    chain.mcpc_chain = recorder
    try:
        zero_counts()
        part8("figure 5b", lambda: figure_5.similarity_increase_digit(
            ctx8, epochs=FIG5_EPOCHS, seeds=FIG5_SEEDS))
        for mode in ("mcpc", "pc"):
            part8(f"figure 5a {mode}",
                  lambda: figure_5.variability_stimulus_onset_nonlinear(ctx8, mode))
        part8("figure 4e", lambda: figure_4.image_reconstruction(ctx8))
        part8("figure 4d", lambda: figure_4.image_generation(ctx8))
        torch.cuda.synchronize()
        counts8 = read_counts()
    finally:
        PCTrainer.train_on_batch = train_on_batch
        chain.mcpc_chain = recorder.fn
    trainers8 = {id(c["trainer"]): c["trainer"] for c in calls}.values()
    fallbacks8 = sum(t.engine_calls for t in trainers8)
    print(f"phase 8: main path launches: mcpc_chain {counts8[0]}, sum_block_partials "
          f"{counts8[2]}; PCTrainer calls {len(calls)}, engine fallbacks {fallbacks8}")
    n_fig5 = 2 * 4 * len(FIG5_EPOCHS) * len(FIG5_SEEDS)   # (warm, chain) a stimulus
    expect8 = {"figure 5b": n_fig5, "figure 5a mcpc": 4, "figure 5a pc": 3, "figure 4e": 2,
               "figure 4d": 0}
    for name, n in expect8.items():
        a, b = parts8[name]
        check(b - a == n, f"phase 8 {name}: {b - a} PCTrainer calls, expected {n}")
    check(fallbacks8 == 0 and all(c["kernel"] for c in calls),
          "a phase-8 PCTrainer call ran in the step engine")
    check(counts8[0] == len(calls) == len(recorder.calls),
          f"{counts8[0]} launches for {len(calls)} PCTrainer calls")
    dims8 = {"figure 4e": (MSE, PC_MSE)}   # mcpc_mse_1, then pc_mse_1; else FID
    for name, (a, b) in parts8.items():
        groups = {}
        for i in range(a, b):
            c = calls[i]
            dims = dims8.get(name, (FID,) * (b - a))[i - a]
            groups.setdefault((dims, c["B"], c["steps"], c["mode"]), []).append(i)
        shown = []
        for (dims, B, steps, mode), idx in groups.items():
            ms = [calls[i]["ms"] for i in idx]
            chain_ms = [recorder.calls[i]["events"][0].elapsed_time(
                recorder.calls[i]["events"][1]) for i in idx]
            shown.append(
                f"{len(idx)} x {'-'.join(map(str, dims))} B={B}, {steps} {mode} steps: "
                f"{min(ms):.3f}-{max(ms):.3f} ms a call (mcpc_chain {min(chain_ms):.3f}-"
                f"{max(chain_ms):.3f}), {1e3 * statistics.median(ms) / steps:.3f} us/step "
                f"(median), bound {chain_bound_ms(dims, B, steps):.3f} ms "
                f"[{plan_text(dims, B, recorder.calls[idx[0]]['kw'])}]")
        print(f"phase 8: {name}: {wall8[name]:.3f} s in all (host work included)"
              + "".join("; " + s_ for s_ in shown) + f" {tag}")

    # what each path computed
    kls = out8["figure 5b"]
    check(kls.shape == (3, len(FIG5_EPOCHS), len(FIG5_SEEDS)) and bool(np.isfinite(kls).all()),
          f"figure 5b: KLs of shape {kls.shape}, or not finite")
    for k, stim in enumerate(figure_5.STIMULI):
        print(f"phase 8: figure 5b KL(spontaneous || {stim.strip()}) by epoch "
              f"{FIG5_EPOCHS}, mean over seeds {FIG5_SEEDS}: "
              + ", ".join(f"{v:.4f}" for v in kls[k].mean(-1)))
    for mode in ("mcpc", "pc"):
        res = out8[f"figure 5a {mode}"]
        mean = res["mean"]
        check(bool(np.isfinite(mean).any()) and np.isnan(mean).sum() < len(mean) // 2,
              f"figure 5a {mode}: the rolling variability is not finite")
        half = len(mean) // 2
        print(f"phase 8: figure 5a {mode}: {len(mean)} captures; rolling std of the latents, "
              f"mean over the units: {np.nanmean(mean[:half]):.4f} before the onset, "
              f"{np.nanmean(mean[half:]):.4f} after it")
    rec4e = out8["figure 4e"]
    for k in ("img_pc", "img_mc", "img_dlgm"):
        img = rec4e[k]
        check(img.shape == (1024, 784) and bool(np.isfinite(img).all())
              and img.min() >= 0.0 and img.max() <= 1.0, f"figure 4e {k}: {img.shape}")
    hidden = rec4e["data"][:, :392]   # the top half, which the models did not see
    print("phase 8: figure 4e, B=1024: MSE on the hidden half, thresholded at 0.5: "
          + ", ".join(f"{k[4:]} {np.mean(((rec4e[k][:, :392] > 0.5) - hidden) ** 2):.5f}"
        for k in ("img_pc", "img_mc", "img_dlgm")))
    for k in ("pc", "dlgm"):
        img = out8["figure 4d"][k]
        check(img.shape == (256, 28, 28) and bool(np.isfinite(img).all())
              and img.min() >= 0.0 and img.max() <= 1.0, f"figure 4d {k}: {img.shape}")

    # one figure-5 chain (captured every 20 steps, B=256) and one figure-4e
    # launch (masked, B=1024), held by the step rule at their full length as
    # in phase 5
    i5 = parts8["figure 5b"][0] + 1
    check(recorder.calls[i5]["kw"].get("capture_stride"), "the figure-5 chain is not captured")
    fig8_failed = hold_replay(torch, chain, 8, "figure 5b, seed 0's spontaneous chain",
                              recorder.calls[i5], tag, sincos_err)
    fig8_failed += hold_replay(torch, chain, 8, "figure 4e, mcpc_mse_1",
                               recorder.calls[parts8["figure 4e"][0]], tag, sincos_err)
    check(not fig8_failed, "phase 8 " + "; ".join(fig8_failed))

    # the step engine's paths: the 1-D models at FIG_ENGINE_SCALE on the card,
    # then figure 6's on the CPU for the engine's cost a step on each
    engine_calls = []

    def host_timed(self, inputs, *args, **kwargs):
        """PCTrainer.train_on_batch on the host's clock (synchronised), with
        the path it took."""
        kernel_before = self.kernel_calls
        t_call = time.perf_counter()
        out = train_on_batch(self, inputs, *args, **kwargs)
        if inputs.is_cuda:
            torch.cuda.synchronize()
        engine_calls.append(dict(device=inputs.device.type, steps=self.T,
                                 s=time.perf_counter() - t_call,
                                 kernel=self.kernel_calls > kernel_before))
        return out

    small = common.ExperimentContext(ctx8.path_models, fig_dir, scale=FIG_ENGINE_SCALE,
                                     device="cuda")
    datas = figure_4._make_datas(small, 3, 256)
    engine_parts = [
        ("figure 2 (a, b)", lambda c: figure_2.posterior_linear_model(
            common.ExperimentContext(c.path_models, fig_dir, scale=FIG2_SCALE,
                                     device=c.device))),
        ("figure 4a", lambda c: figure_4.comparison_linear_model(c, datas=datas)),
        ("figure 4c", lambda c: figure_4.pc_linear_learning(c, datas=datas)),
        ("figure 6", lambda c: figure_6.varying_langevin_noise(c, FIG6_NOISE)),
    ]
    PCTrainer.train_on_batch = host_timed
    launches_before = read_counts()
    try:
        for name, fn in engine_parts:
            first = len(engine_calls)
            t_part = time.perf_counter()
            out8[name] = fn(small)
            torch.cuda.synchronize()
            wall8[name] = time.perf_counter() - t_part
            parts8[name] = (first, len(engine_calls))
        first = len(engine_calls)
        t_part = time.perf_counter()
        cpu6 = figure_6.varying_langevin_noise(
            common.ExperimentContext(ctx8.path_models, fig_dir, scale=FIG_ENGINE_SCALE,
                                     device="cpu"), FIG6_NOISE)
        wall8["figure 6, CPU"] = time.perf_counter() - t_part
        parts8["figure 6, CPU"] = (first, len(engine_calls))
    finally:
        PCTrainer.train_on_batch = train_on_batch
    check(read_counts() == launches_before, "a step-engine figure launched a kernel")
    check(not any(c["kernel"] for c in engine_calls), "a 1-D figure took the fused chain")
    engine_s = 0.0
    for name in [n for n, _ in engine_parts] + ["figure 6, CPU"]:
        a, b = parts8[name]
        steps = sum(c["steps"] for c in engine_calls[a:b])
        s_calls = sum(c["s"] for c in engine_calls[a:b])
        if name != "figure 6, CPU":
            engine_s += wall8[name]
        print(f"phase 8: {name} (step engine, {engine_calls[a]['device']}): "
              f"{wall8[name]:.3f} s in all, {b - a} PCTrainer calls, {steps} engine steps, "
              f"{1e6 * s_calls / steps:.1f} us a step {tag}")
    fig2 = out8["figure 2 (a, b)"]
    print(f"phase 8: figure 2 (a, b) at scale {FIG2_SCALE}: MAP {fig2['map']:.4f} (0.44), "
          f"{len(fig2['samples'])} samples: mean {fig2['samples_mean']:.4f} (0.44), variance "
          f"{fig2['samples_var']:.4f} (0.2)")
    check(abs(fig2["map"] - 0.44) < 0.05 and abs(fig2["samples_mean"] - 0.44) < 0.15
          and abs(fig2["samples_var"] - 0.2) < 0.1,
          "figure 2 (a, b): the samples are not near the posterior N(0.44, 0.2)")
    fig4a = out8["figure 4a"]
    print(f"phase 8: figure 4a: sample variance MCPC {fig4a['mcpc_var']:.4f}, PC "
          f"{fig4a['pc_var']:.4f} (data 5); (mu, W) MCPC {fig4a['mcpc_params']}, PC "
          f"{fig4a['pc_params']}")
    check(np.isfinite(fig4a["mcpc_var"]) and fig4a["mcpc_var"] > fig4a["pc_var"],
          "figure 4a: MCPC's variance is not above PC's")
    check(all(bool(np.isfinite(t).all()) for t in out8["figure 4c"]["trajectories"]),
          "figure 4c: a trajectory is not finite")
    fig6 = out8["figure 6"]
    print(f"phase 8: figure 6, noise variances {list(FIG6_NOISE)}: generated variance "
          f"{list(np.round(fig6['gen_vars'], 4))} (CPU {list(np.round(cpu6['gen_vars'], 4))}), "
          f"learned |W| {list(np.round(np.abs(fig6['weights'][:, 1]), 4))}")
    check(bool(np.isfinite(fig6["generated"]).all())
          and abs(fig6["weights"][0, 1]) > abs(fig6["weights"][1, 1]),
          "figure 6: the correct noise did not learn the larger |W|")
    print(f"phase 8: the step engine's figures took {engine_s:.3f} s on the card; figure 4b "
          f"(4 x 3 x 3 x 151 engine steps even on 3 batches) is left to the CPU tests "
          f"(tests/test_torch_figure4.py)")

    # the stacked DLGM's metrics on the card, against the same on the CPU
    g8 = torch.Generator().manual_seed(SEED)
    gen_st = dlgm_stacked.init_generative_stacked(g8, **dlgm_stacked.MNIST_PRESETS["mnist"],
                                                  device=dev)
    rec_st, factors_st = dlgm_stacked.init_recognition_stacked(
        g8, **dlgm_stacked.RECOGNITION_PRESETS["mnist"], device=dev)
    x8 = next(iter(get_mnist_data({"batch_size_train": 32, "batch_size_val": 32,
                                   "batch_size_test": 32}, device=dev)[2]))[0]
    draws = [[torch.randn(32 * 4, d, generator=g8) for d in (201, 200)]]

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cpu(v) for v in tree]
        return tree.cpu() if isinstance(tree, torch.Tensor) else tree

    on_card = dlgm_stacked.StackedMetrics(gen_st, rec_st, factors_st, seed=SEED)
    torch.cuda.synchronize()
    t8 = time.perf_counter()
    nll_card = on_card.importance_nll([(x8, None)], particle_size=4, eps=draws)
    mse_card = on_card.get_mse_rec([(x8, None)])
    ml_card = on_card.get_marginal_likelihood([(x8, None)], n_samples=500)
    torch.cuda.synchronize()
    stacked_s = time.perf_counter() - t8
    on_cpu = dlgm_stacked.StackedMetrics(to_cpu(gen_st), to_cpu(rec_st), factors_st, seed=SEED)
    nll_cpu = on_cpu.importance_nll([(x8.cpu(), None)], particle_size=4, eps=draws)
    mse_cpu = on_cpu.get_mse_rec([(x8.cpu(), None)])
    print(f"phase 8: StackedMetrics, preset mnist (201 + 200 latents, Cholesky factors), 32 "
          f"images: importance NLL (4 particles) {nll_card:.4f} (CPU {nll_cpu:.4f}), masked MSE "
          f"{mse_card:.5f} (CPU {mse_cpu:.5f}), marginal likelihood (500 samples) "
          f"{ml_card:.3f}; {stacked_s:.3f} s on the card {tag}")
    check(all(np.isfinite(v) for v in (nll_card, mse_card, ml_card)),
          "StackedMetrics: a metric is not finite")
    check(abs(nll_card - nll_cpu) <= STACKED_RTOL * abs(nll_cpu),
          f"StackedMetrics: the card's NLL {nll_card} against the CPU's {nll_cpu}")
    print(f"phase 8 ends at {time.perf_counter() - t_start:.1f} s")
    # ---------------------------------------------------------- phase 9
    counts9 = run_phase9(torch, here, dev, tag, zero_counts, read_counts, ranks9, tmp9)
    print(f"phase 9 ends at {time.perf_counter() - t_start:.1f} s")
    # --------------------------------------------------------- phase 10
    probe_entry = run_phase10(torch, tag)
    print(f"phase 10 ends at {time.perf_counter() - t_start:.1f} s")
    # --------------------------------------------------------- phase 11
    inception_entry = run_phase11(torch, here, tag)
    print(f"phase 11 ends at {time.perf_counter() - t_start:.1f} s")
    launches = [sum(run) for run in zip(serve_counts, train_counts, mse_counts, fig_counts,
                                        counts5, counts6, counts_tp, counts7, counts8, counts9)]
    pallas = "montecarlopredictivecoding_tpu/ops/pallas_mcpc.py"
    csrc = "montecarlopredictivecoding_tpu_torch/ops/csrc/"
    print(f"chip_smoke: wall time {time.perf_counter() - t_main:.1f} s from the start of main, "
          f"of which nvcc (the six libraries built in parallel) {t_built:.1f} s {tag}")
    print(json.dumps({"kernels": [
        {
            "name": "mcpc_chain", "route": "cuda", "source": csrc + "mcpc_chain.cu",
            "replaces": pallas + ":426", "launches": launches[0],
            "max_abs_err": dx, "ms": a_ms, "plain_ms": pa_ms,
            "bound_ms": bound_a, "bound_by": "operations", "library_ms": None,
            # bound_ms is the work at the f32 peak of the CUDA cores, where
            # it runs; bound_tc_ms the same products as split-TF32 ones at
            # the TF32 tensor-core peak, a route measured and not kept
            "share": bound_a / a_ms, "bound_tc_ms": bound_tc_a,
            "share_tc": bound_tc_a / a_ms,
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
            "share": bound_c / c_ms, "bound_tc_ms": bound_tc_c,
            "share_tc": bound_tc_c / c_ms,
            # at T=10000 beside chain (a) in the same call (phase 2)
            "ms_T10000": c_long_ms, "chain_a_ms_T10000": [a_ms, a2_ms],
        },
        # the bf16 builds, at chain (a)'s inputs cut to T=1000 and chain (c):
        # bound by operations at the bf16 tensor-core peak, which is what
        # the card could do for this work; bound_f32_ms is the same work at
        # the f32 peak of the CUDA cores
        {
            "name": "mcpc_chain_bf16", "route": "cuda", "source": csrc + "mcpc_chain.cu",
            "replaces": pallas + ":426", "launches": launches[3],
            "max_abs_err": chains16["a"][2], "ms": chains16["a"][0],
            "plain_ms": chains16["a"][1], "bound_ms": chains16["a"][3],
            "bound_by": "operations", "library_ms": None,
            "share": chains16["a"][3] / chains16["a"][0],
            "bound_f32_ms": chains16["a"][4], "steps": bf16_a["T"],
            # chain (a) at T=10000 (bench.py's bf16 rows), B=256 and B=1024
            "ms_T10000": {str(B): bench_rows[B, True][0] for B in (BATCH, 1024)},
        },
        {
            "name": "mcpc_chain_unpacked_bf16", "route": "cuda",
            "source": csrc + "mcpc_chain_unpacked.cu",
            "replaces": pallas + ":1013", "launches": launches[4],
            "max_abs_err": chains16["c, unpacked"][2], "ms": chains16["c, unpacked"][0],
            "plain_ms": chains16["c, unpacked"][1], "bound_ms": chains16["c, unpacked"][3],
            "bound_by": "operations", "library_ms": None,
            "share": chains16["c, unpacked"][3] / chains16["c, unpacked"][0],
            "bound_f32_ms": chains16["c, unpacked"][4], "steps": bf16_c["T"],
        },
        probe_entry,
        inception_entry,
    ]}))
    print(f"chain (a): {plan_text(FID, BATCH, CHAIN_A)} {tag}")
    print(f"chain (c): {plan_text(FID, BATCH, CHAIN_C)} {tag}")
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
