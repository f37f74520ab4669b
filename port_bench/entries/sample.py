"""Posterior sampling as figure 5b drives it (``experiments/figure_5.py``,
``_sample_latent_chain``): for each chain a PC trainer's Adam warm start
and an MCPC trainer's Langevin chain clamped to a batch of images, through
``PCTrainer.train_on_batch`` (two kernel calls), with the latents captured
every ``capture_stride`` steps and kept on the card.  One chain after
another; every chain has a generator of its own, seeded from the run's
seed, from which the trainers draw its latents and chain seeds.

The comparison takes chains drawn from the seed among those the window
finished (a reservoir sample) and holds each, from its own inputs, in two
stages: the warm start (the first capture) against the plain reference's
Adam steps in float64 from the same initial latents, and every stretch of
``capture_stride`` Langevin steps, from each capture, against the
reference's steps from the program's own captured state (the Langevin
phase amplifies rounding over its 10,000 steps, so it is followed from the
program's state; the warm start is checked by itself).  A row's gap is its
largest element gap over its largest reference element; a stage's number
is the median row's gap (``common.row_share_gap``), and for the Langevin
stage the worst stretch's.
"""

from __future__ import annotations

import random
import types
import typing as tp

import torch

from port_bench.lib import common
from port_bench.lib.common import Number
from port_bench.reference import flops
from port_bench.reference import mcpc as ref

KIND = "sample"
WARM_GAP_LIMIT = 1e-3
STRETCH_GAP_LIMIT = 1e-5
CHECK_BLOCK = 100  # captures a block of the reference's stretches


def _config(cell) -> dict:
    m = cell.mix
    return common.port_config(
        cell.dims, batch_size_test=m["batch"], T_pc=m["warm_steps"], optimizer_x_fn_pc="adam",
        optimizer_x_kwargs_pc={"lr": m["warm_lr"]}, mixing=m["mixing"],
        sampling=m["sampling"], optimizer_x_kwargs_mcpc={"lr": m["langevin_lr"]})


def inputs(cell, seed: int, device) -> types.SimpleNamespace:
    m = cell.mix
    B = m["batch"]
    return types.SimpleNamespace(
        params=common.make_params(cell.dims, seed, device), B=B, seed=seed,
        pool=common.make_images(B * m["pool_batches"], cell.dims[3], seed, device))


def chain_rows(inp, i: int) -> torch.Tensor:
    n = inp.pool.shape[0] // inp.B
    j = i % n
    return inp.pool[j * inp.B : (j + 1) * inp.B]


def chain_generator_seed(inp, i: int) -> int:
    return common.derive(inp.seed, 10, i)


def setup(cell, seed: int, device, span) -> types.SimpleNamespace:
    from montecarlopredictivecoding_tpu_torch.core.trainer import GenerativeModel, LangevinStep
    from montecarlopredictivecoding_tpu_torch.models import factory

    inp = inputs(cell, seed, device)
    st = types.SimpleNamespace(inp=inp, cell=cell, config=_config(cell), factory=factory,
                               langevin=LangevinStep(var=cell.mix["langevin_var"]))
    st.gen = GenerativeModel(common.port_model(cell.dims), torch.Generator(),
                             params=inp.params, device=device)
    st.pseudo = torch.zeros((inp.B, cell.dims[0]), device=device)
    st.chains = 0
    st.kept: tp.List[tuple] = []
    st.pick = random.Random(common.derive(seed, 11))
    chain(st, span)  # loads the kernels and warms every shape
    return st


def chain(st, span):
    """One chain of figure 5b: (its index, its captures [n, B, N], its final
    latents [B, N])."""
    i = st.chains
    gen, config = st.gen, st.config
    gen.generator = torch.Generator().manual_seed(chain_generator_seed(st.inp, i))
    target = {"_target": chain_rows(st.inp, i)}
    loss_fn = config["loss_fn"]
    with span("bench.chain"):
        pc = st.factory.get_pc_trainer(gen, config, is_mcpc=True, training=False)
        mc = st.factory.get_mcpc_trainer(gen, config, training=False)
        with span("bench.train_on_batch"):
            pc.train_on_batch(st.pseudo, loss_fn=loss_fn, loss_fn_kwargs=target,
                              is_return_results_every_t=False)
        with span("bench.train_on_batch"):
            res = mc.train_on_batch(st.pseudo, loss_fn=loss_fn, loss_fn_kwargs=target,
                                    callback_after_t=st.langevin,
                                    is_sample_x_at_batch_start=False, is_return_xs=True,
                                    capture_stride=st.cell.mix["capture_stride"])
    st.chains += 1
    return i, res["xs"], gen.latents


def window(st, seconds: float, span) -> types.SimpleNamespace:
    """Chains one after another for ``seconds``; ``check_chains`` of them
    kept by reservoir sampling."""
    m = st.cell.mix
    keep = m["check_chains"]
    marks = common.Marks(st.inp.pool.device)
    n = 0
    while marks.elapsed() < seconds:
        done = chain(st, span)
        marks.mark()
        if len(st.kept) < keep:
            st.kept.append(done)
        else:
            j = st.pick.randrange(n + 1)
            if j < keep:
                st.kept[j] = done
        del done
        n += 1
    elapsed = marks.close()
    steps = m["warm_steps"] + m["mixing"] + m["sampling"]
    calls = [{"dims": st.cell.dims, "B": st.inp.B, "steps": m["warm_steps"], "sampling": 0,
              "count": n},
             {"dims": st.cell.dims, "B": st.inp.B, "steps": m["mixing"] + m["sampling"],
              "sampling": 0, "count": n}]
    return types.SimpleNamespace(
        seconds=elapsed, items=n, attempted=n, failed=0,
        end_to_end={"sample_row_steps_per_s": n * st.inp.B * steps / elapsed},
        chain_calls=calls, flops=n * flops.chain_flops(st.cell.dims, st.inp.B, steps))


def release(st) -> None:
    st.gen = None


def numbers(cell, inp, kept) -> tp.List[Number]:
    """The warm stage's and the Langevin stage's gaps of the kept chains
    ((index, captures as a tuple by latent or one tensor, final latents))."""
    m = cell.mix
    stride = m["capture_stride"]
    warm_gap = stretch_gap = 0.0
    for i, caps, final in kept:
        caps = torch.cat(caps, -1) if isinstance(caps, (tuple, list)) else caps
        final = torch.cat(final, -1) if isinstance(final, (tuple, list)) else final
        g = torch.Generator().manual_seed(chain_generator_seed(inp, i))
        X0 = common.replay_latents(g, inp.B, cell.dims).to(caps.device, torch.float64)
        common.replay_chain_seed(g)  # the warm start's chain seed, which it does not use
        seed = common.replay_chain_seed(g)
        chain64 = ref.Chain(inp.params, chain_rows(inp, i))
        warm = ref.adam_warm(chain64, X0, m["warm_steps"], m["warm_lr"])[0]
        warm_gap = max(warm_gap, float(common.row_share_gap(common.row_gaps(caps[0], warm))))
        ends = torch.cat([caps[1:], final[None]])
        for k0 in range(0, caps.shape[0], CHECK_BLOCK):
            k1 = min(k0 + CHECK_BLOCK, caps.shape[0])
            t0 = stride * torch.arange(k0, k1, dtype=torch.int64, device=caps.device)
            X, _, _ = ref.langevin(chain64, caps[k0:k1].double(), stride, m["langevin_lr"],
                                   m["langevin_var"], seed, t0=t0)
            gaps = common.row_share_gap(common.row_gaps(ends[k0:k1], X))
            stretch_gap = max(stretch_gap, float(gaps.max()))
    return [Number("warm_gap", warm_gap, WARM_GAP_LIMIT),
            Number("stretch_gap", stretch_gap, STRETCH_GAP_LIMIT)]


def check(st) -> tp.List[Number]:
    return numbers(st.cell, st.inp, st.kept)


def reference_chain(cell, inp, i: int, dtype, mm=torch.matmul):
    """The plain reference's chain ``i`` in ``dtype``: (captures, final)."""
    m = cell.mix
    g = torch.Generator().manual_seed(chain_generator_seed(inp, i))
    X = common.replay_latents(g, inp.B, cell.dims).to(inp.pool.device, dtype)
    common.replay_chain_seed(g)
    seed = common.replay_chain_seed(g)
    c = ref.Chain(inp.params, chain_rows(inp, i), dtype=dtype, mm=mm)
    X = ref.adam_warm(c, X, m["warm_steps"], m["warm_lr"])[0]
    X, _, caps = ref.langevin(c, X, m["mixing"] + m["sampling"], m["langevin_lr"],
                              m["langevin_var"], seed, capture_stride=m["capture_stride"])
    return caps, X


def control(cell, seed: int, device, mm=torch.matmul) -> tp.List[Number]:
    """The reference in float32 with the product ``mm`` (TF32 on the card)
    as the program: its chain 1's stages held to the float64 reference."""
    inp = inputs(cell, seed, device)
    caps, final = reference_chain(cell, inp, 1, torch.float32, mm)
    return numbers(cell, inp, [(1, caps, final)])
