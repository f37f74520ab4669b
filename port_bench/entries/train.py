"""MCPC training through ``experiments/train_mnist.one_batch``.

Each batch is the loop body of ``train_mcpc``: the model's ``init_latents``
draws the latents from the model's CPU generator, a chain seed is drawn
from it, and ``one_batch`` runs the warm and Langevin phases, the Hebbian
gradient sums, the summing pass and the Adam step on the parameters.  The
batches are issued back to back, as ``train_mcpc`` issues them; every batch
takes rows of its own from a pool of distinct images.

Set-up builds one training state (parameters and Adam state) and drives it
through the first ``check_steps`` batches, which also load the kernels; the
window goes on from that same state.  The comparison holds those first
batches to the plain reference in float64, each from the parameters and
Adam state the program started it from (a step's Adam update moves an entry
whose gradient sits at rounding by the whole learning rate, so steps are
not chained through the reference's own parameters), on the same images,
latents and chain seeds: each step's gradient as the optimizer got it (from
its first moment) by its worst leaf, the median of the steps', and the
parameters' change over the steps by its worst leaf.  The warm phase's
Adam steps part a few rows under any rounding, which moves a single
gradient's leaves; the median step's is steady from seed to seed.
"""

from __future__ import annotations

import statistics
import types
import typing as tp

import torch

from port_bench.lib import common
from port_bench.lib.common import Number
from port_bench.reference import flops
from port_bench.reference import mcpc as ref

KIND = "train"
# the limits of the compared numbers (PERF.md gives the readings they are
# set from)
GRAD_GAP_LIMIT = 6e-5
CHANGE_GAP_LIMIT = 5e-3
# leaves whose reference gradient is under this share of the median leaf's
# move by rounding alone and are not compared
NOUGHT_SHARE = 1e-3


def _config(cell) -> dict:
    m = cell.mix
    return common.port_config(
        cell.dims, T_pc=m["warm_steps"], optimizer_x_fn_pc="adam",
        optimizer_x_kwargs_pc={"lr": m["warm_lr"]}, mixing=m["mixing"],
        sampling=m["sampling"], optimizer_x_kwargs_mcpc={"lr": m["langevin_lr"]},
        optimizer_p_fn_mcpc="adam", optimizer_p_kwargs_mcpc={"lr": m["param_lr"]})


def inputs(cell, seed: int, device) -> types.SimpleNamespace:
    """Weights, the image pool and the program's generator seed."""
    m = cell.mix
    B = m["batch"]
    pool = common.make_images(B * m["pool_batches"], cell.dims[3], seed, device)
    return types.SimpleNamespace(params=common.make_params(cell.dims, seed, device),
                                 pool=pool, B=B, gen_seed=common.derive(seed, 3))


def batch_rows(inp, i: int) -> torch.Tensor:
    n = inp.pool.shape[0] // inp.B
    j = i % n
    return inp.pool[j * inp.B : (j + 1) * inp.B]


def setup(cell, seed: int, device, span) -> types.SimpleNamespace:
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist

    inp = inputs(cell, seed, device)
    st = types.SimpleNamespace(inp=inp, cell=cell, B=inp.B, config=_config(cell),
                               params=inp.params)
    st.model = common.port_model(cell.dims)
    st.gen = torch.Generator().manual_seed(inp.gen_seed)
    st.pseudo = torch.zeros((st.B, cell.dims[0]), device=device)
    st.one_batch = train_mnist.one_batch
    st.opt_state = train_mnist.param_optimizer(st.config).init(st.params)
    st.snapshots = [(st.params, st.opt_state)]
    st.batches = 0
    for _ in range(cell.mix["check_steps"]):
        step(st, span)
        st.snapshots.append((st.params, st.opt_state))
    return st


def step(st, span) -> None:
    """One batch of ``train_mcpc``'s loop."""
    with span("bench.init_latents"):
        latents = st.model.init_latents(st.params, st.pseudo, st.gen)
        chain_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=st.gen))
    data = batch_rows(st.inp, st.batches)
    with span("bench.one_batch"):
        st.params, st.opt_state = st.one_batch(
            st.params, st.opt_state, latents, chain_seed, data, config=st.config,
            langevin_var=st.cell.mix["langevin_var"])
    st.batches += 1


def window(st, seconds: float, span) -> types.SimpleNamespace:
    """Batches back to back for ``seconds``, a mark after each."""
    marks = common.Marks(st.inp.pool.device)
    while marks.elapsed() < seconds:
        step(st, span)
        marks.mark()
    elapsed = marks.close()
    times = marks.item_ms()
    n = len(times)
    m = st.cell.mix
    calls = {"dims": st.cell.dims, "B": st.B, "steps": m["warm_steps"] + m["mixing"] + m["sampling"],
             "sampling": m["sampling"], "count": n}
    return types.SimpleNamespace(
        seconds=elapsed, items=n, attempted=n, failed=0,
        end_to_end={"train_images_per_s": n * st.B / elapsed,
                    "train_batch_ms_p95": common.p95(times)},
        chain_calls=[calls],
        flops=n * flops.chain_flops(st.cell.dims, st.B, calls["steps"], m["sampling"]))


def release(st) -> None:
    """Drop what the window made; the set-up's snapshots stay for the check."""
    st.params = st.opt_state = None


def reference_gradient(cell, inp, i: int, params, dtype=torch.float64, mm=torch.matmul):
    """The reference's gradient (as the optimizer gets it) of batch ``i`` at
    ``params``: the batch's latents and chain seed replayed from the
    program's generator."""
    m = cell.mix
    gen = torch.Generator().manual_seed(inp.gen_seed)
    for _ in range(i + 1):
        X = common.replay_latents(gen, inp.B, cell.dims)
        seed = common.replay_chain_seed(gen)
    params = [{k: v.to(dtype) for k, v in p.items()} for p in params]
    chain = ref.Chain(params, batch_rows(inp, i), dtype=dtype, mm=mm)
    X = ref.adam_warm(chain, X.to(inp.pool.device, dtype), m["warm_steps"], m["warm_lr"])[0]
    _, sums, _ = ref.langevin(chain, X, m["mixing"] + m["sampling"], m["langevin_lr"],
                              m["langevin_var"], seed, grads_from=m["mixing"])
    scale = 1.0 / (m["sampling"] * inp.B)
    return [{k: v * scale for k, v in g.items()} for g in ref.pgrads_tree(sums, cell.dims)]


def adam_state(state, dtype=torch.float64):
    """(count, mu, nu) of the port's Adam state, or of the reference's."""
    if not isinstance(state, tuple) or len(state) != 3:
        state = state[0]  # the port's chain: (ScaleByAdamState, the scale's ())
        state = (state.count, state.mu, state.nu)
    count, mu, nu = state
    conv = lambda tree: [{k: v.to(dtype) for k, v in p.items()} for p in tree]
    return count, conv(mu), conv(nu)


def program_steps(st):
    """Each set-up step of the program as (parameters before, Adam state
    before, parameters after, the gradient the optimizer got: worked out
    from its first moment)."""
    b1, w = ref.f32(0.9), ref.f32(1.0 - 0.9)
    steps = []
    for (p0, s0), (p1, s1) in zip(st.snapshots, st.snapshots[1:]):
        mu0, mu1 = adam_state(s0)[1], adam_state(s1)[1]
        grads = [{k: (a[k] - b1 * b[k]) / w for k in a} for a, b in zip(mu1, mu0)]
        steps.append((p0, adam_state(s0), p1, grads))
    return steps


def numbers(cell, inp, steps) -> tp.List[Number]:
    """Each step held to the float64 reference from the state it started
    from: the gradient by its worst leaf, the median of the steps'; the
    parameters' change over the steps by its worst leaf."""
    m = cell.mix
    b1, b2 = ref.f32(0.9), ref.f32(0.999)
    keep = None
    grad_gaps = []
    total = total_ref = None
    for i, (p0, s0, p1, grads) in enumerate(steps):
        r_grads = reference_gradient(cell, inp, i, p0)
        refs = common.leaf_norms(r_grads)
        if keep is None:  # the first step's reference gradient sets the rule
            med = sorted(refs)[len(refs) // 2]
            keep = [r >= NOUGHT_SHARE * med for r in refs]
        grad_gaps.append(common.worst_leaf_gap(common.leaf_norms(grads), refs, keep))
        p0 = [{k: v.double() for k, v in p.items()} for p in p0]
        r_p1, _ = ref.adam_params(p0, s0, r_grads, m["param_lr"], b1=b1, b2=b2)
        step = [{k: p1[j][k].double() - p0[j][k] for k in p0[j]} for j in range(len(p0))]
        step_ref = [{k: r_p1[j][k] - p0[j][k] for k in p0[j]} for j in range(len(p0))]
        if total is None:
            total, total_ref = step, step_ref
        else:
            total = [{k: a[k] + b[k] for k in a} for a, b in zip(total, step)]
            total_ref = [{k: a[k] + b[k] for k in a} for a, b in zip(total_ref, step_ref)]
    change_gap = common.worst_leaf_gap(common.leaf_norms(total), common.leaf_norms(total_ref),
                                       keep)
    return [Number("grad_gap", float(statistics.median(grad_gaps)), GRAD_GAP_LIMIT),
            Number("change_gap", change_gap, CHANGE_GAP_LIMIT)]


def check(st) -> tp.List[Number]:
    return numbers(st.cell, st.inp, program_steps(st))


def control(cell, seed: int, device, mm=torch.matmul) -> tp.List[Number]:
    """The reference in float32 with the product ``mm`` (TF32 on the card)
    put in the program's place for the set-up's steps, each held to the
    float64 reference from the state it started from."""
    inp = inputs(cell, seed, device)
    m = cell.mix
    params, state = inp.params, ref.adam_init(inp.params)
    steps = []
    for i in range(m["check_steps"]):
        grads = reference_gradient(cell, inp, i, params, torch.float32, mm)
        new, new_state = ref.adam_params(params, state, grads, m["param_lr"], b1=ref.f32(0.9),
                                         b2=ref.f32(0.999))
        steps.append((params, adam_state(state), new, grads))
        params, state = new, new_state
    return numbers(cell, inp, steps)
