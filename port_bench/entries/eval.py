"""Scoring a checkpoint as table 1's MSE column does: ``eval/metrics.
get_mse_rec`` over ``batches_per_call`` test batches a call (Adam MAP
inference with the last half of each image's pixels clamped, through
``PCTrainer`` and the kernel; the deepest latent decoded, thresholded, the
MSE on the hidden half; a host read-back a batch).  Calls one after
another; each call's generator, from which the trainer draws the latents,
is seeded from the run's seed.

The comparison takes calls drawn from the seed among those the window
finished (a reservoir sample) and holds two stages: each batch's final
latents against the plain reference's masked Adam steps in float64 from the
same initial latents (the median row's gap, the worst batch's: rows at the
edge of Adam's chaotic steps part under any rounding), and the returned MSE
against the reference's decoding of the program's own latents (relative).
"""

from __future__ import annotations

import random
import types
import typing as tp

import torch

from port_bench.lib import common, trace
from port_bench.lib.common import Number
from port_bench.reference import flops
from port_bench.reference import mcpc as ref

KIND = "eval"
LATENT_GAP_LIMIT = 1e-3
MSE_GAP_LIMIT = 4e-6


def _config(cell) -> dict:
    m = cell.mix
    return common.port_config(cell.dims, T_pc=m["warm_steps"], optimizer_x_fn_pc="adam",
                              optimizer_x_kwargs_pc={"lr": m["warm_lr"]})


def inputs(cell, seed: int, device) -> types.SimpleNamespace:
    m = cell.mix
    B = m["batch"]
    return types.SimpleNamespace(
        params=common.make_params(cell.dims, seed, device), B=B, seed=seed,
        pool=common.make_images(B * m["pool_batches"], cell.dims[3], seed, device))


def call_batches(cell, inp, i: int) -> tp.List[torch.Tensor]:
    """Call ``i``'s batches, in turn from the pool."""
    n = inp.pool.shape[0] // inp.B
    k = cell.mix["batches_per_call"]
    return [inp.pool[((i * k + j) % n) * inp.B : ((i * k + j) % n + 1) * inp.B]
            for j in range(k)]


def call_generator_seed(inp, i: int) -> int:
    return common.derive(inp.seed, 20, i)


def mask_lo(cell) -> int:
    """The first clamped column: the last ``round(D * mask_perc)`` are."""
    D = cell.dims[3]
    return D - round(D * cell.mix["mask_perc"])


def setup(cell, seed: int, device, span) -> types.SimpleNamespace:
    from montecarlopredictivecoding_tpu_torch.core import trainer
    from montecarlopredictivecoding_tpu_torch.eval import metrics

    inp = inputs(cell, seed, device)
    st = types.SimpleNamespace(inp=inp, cell=cell, config=_config(cell), metrics=metrics,
                               trainer=trainer)
    st.gen = trainer.GenerativeModel(common.port_model(cell.dims), torch.Generator(),
                                     params=inp.params, device=device)
    st.calls = 0
    st.kept: tp.List[tuple] = []
    st.pick = random.Random(common.derive(seed, 21))
    call(st, span, keep=False)  # loads the kernels and warms every shape
    return st


def call(st, span, keep: bool):
    """One ``get_mse_rec`` call: (its index, its MSE, each batch's final
    latents [B, N] where ``keep``)."""
    i = st.calls
    st.gen.generator = torch.Generator().manual_seed(call_generator_seed(st.inp, i))
    finals: tp.List[tuple] = []
    gen = st.gen

    def batches():
        for data in call_batches(st.cell, st.inp, i):
            yield data, None
            if keep:
                finals.append(gen.latents)

    original = st.trainer.PCTrainer.train_on_batch

    def spanned(self, *args, **kwargs):
        with span("bench.train_on_batch"):
            return original(self, *args, **kwargs)

    traced = span is not trace.no_span  # the untraced path runs the function as it is
    with span("bench.get_mse_rec"):
        if traced:
            st.trainer.PCTrainer.train_on_batch = spanned
        try:
            mse = st.metrics.get_mse_rec(gen, st.config, batches())
        finally:
            st.trainer.PCTrainer.train_on_batch = original
    st.calls += 1
    return i, mse, [torch.cat(f, -1) for f in finals]


def window(st, seconds: float, span) -> types.SimpleNamespace:
    """Calls one after another for ``seconds``; ``check_calls`` of them kept
    by reservoir sampling (whether a call is kept is drawn before it runs)."""
    m = st.cell.mix
    keep = m["check_calls"]
    marks = common.Marks(st.inp.pool.device)
    n = 0
    while marks.elapsed() < seconds:
        slot = n if n < keep else st.pick.randrange(n + 1)
        done = call(st, span, keep=slot < keep)
        marks.mark()
        if slot < keep:
            if slot < len(st.kept):
                st.kept[slot] = done
            else:
                st.kept.append(done)
        n += 1
    elapsed = marks.close()
    B, k = st.inp.B, m["batches_per_call"]
    calls = [{"dims": st.cell.dims, "B": B, "steps": m["warm_steps"], "sampling": 0,
              "count": n * k}]
    return types.SimpleNamespace(
        seconds=elapsed, items=n, attempted=n, failed=0,
        end_to_end={"eval_images_per_s": n * k * B / elapsed},
        chain_calls=calls, flops=n * k * flops.chain_flops(st.cell.dims, B, m["warm_steps"]))


def release(st) -> None:
    st.gen = None


def reference_mse(cell, batches, finals, dtype=torch.float64, params=None, mm=torch.matmul):
    """get_mse_rec's MSE of the latents ``finals`` decoded by the reference:
    the deepest latent's logits thresholded at 0, the mean squared error on
    the unclamped columns, averaged over the images."""
    lo = mask_lo(cell)
    total, n = 0.0, 0
    for data, X in zip(batches, finals):
        c = ref.Chain(params, data, dtype=dtype, mm=mm)
        img = (c.decode(c.split(X.to(dtype))[2]) > 0).to(dtype)
        total += float(torch.sum(torch.mean((img[:, :lo] - data[:, :lo].to(dtype)) ** 2, dim=1)))
        n += data.shape[0]
    return total / n


def reference_latents(cell, inp, i: int, dtype, mm=torch.matmul) -> tp.List[torch.Tensor]:
    """Call ``i``'s final latents by the reference, batch by batch."""
    m = cell.mix
    g = torch.Generator().manual_seed(call_generator_seed(inp, i))
    out = []
    for data in call_batches(cell, inp, i):
        X = common.replay_latents(g, inp.B, cell.dims).to(inp.pool.device, dtype)
        common.replay_chain_seed(g)  # the call's chain seed, which Adam does not use
        c = ref.Chain(inp.params, data, dtype=dtype, mask_lo=mask_lo(cell), mm=mm)
        out.append(ref.adam_warm(c, X, m["warm_steps"], m["warm_lr"])[0])
    return out


def numbers(cell, inp, kept) -> tp.List[Number]:
    latent_gap = mse_gap = 0.0
    for i, mse, finals in kept:
        refs = reference_latents(cell, inp, i, torch.float64)
        for X, R in zip(finals, refs):
            latent_gap = max(latent_gap, float(common.row_share_gap(common.row_gaps(X, R))))
        r_mse = reference_mse(cell, call_batches(cell, inp, i), finals, params=inp.params)
        mse_gap = max(mse_gap, abs(mse - r_mse) / r_mse)
    return [Number("latent_gap", latent_gap, LATENT_GAP_LIMIT),
            Number("mse_gap", mse_gap, MSE_GAP_LIMIT)]


def check(st) -> tp.List[Number]:
    return numbers(st.cell, st.inp, st.kept)


def control(cell, seed: int, device, mm=torch.matmul) -> tp.List[Number]:
    """The reference in float32 with the product ``mm`` (TF32 on the card)
    as the program: call 1's latents and MSE held to the float64
    reference."""
    inp = inputs(cell, seed, device)
    finals = reference_latents(cell, inp, 1, torch.float32, mm)
    mse = reference_mse(cell, call_batches(cell, inp, 1), finals, torch.float32, inp.params, mm)
    return numbers(cell, inp, [(1, mse, finals)])
