"""PC training through ``PCTrainer``, as ``experiments/train_mnist.train_pc``
drives it.

The model comes from ``models.factory.get_model`` and the trainer from
``get_pc_trainer(is_mcpc=False, training=True)`` with the configuration of
``apply_preset(pc_training_config(), "mse", "pc")``, its widths and
schedule set from the cell.  Each batch is one ``train_on_batch``: the
latents drawn at batch start from the model's CPU generator, ``T`` Adam MAP
steps on them and the last step's parameter gradients in one chain call
(``warm_pgrads``) with its summing pass, and the trainer's Adam step on the
parameters.  Batches are issued back to back, each on rows of its own from
a pool of distinct images.  After the window the trainer's counters must
show every batch on the chain's path with a parameter update, and on a card
one packed f32 chain launch and one summing pass a window batch: otherwise
the run raises.  A trainer without the counter of parameter updates fails
at once, before a batch.  (``train_batch_ms_p95`` is not reported: on a
slower host the trainer's host work sets the batch and its tail spreads
past the metric's bound.)

Set-up drives the first ``check_steps`` batches, which also load the
kernels, and keeps each one's parameters, Adam state and final latents;
the window goes on from that state.  The comparison launches those batches
again through a fresh trainer from the same parameters and generator seed
with every step captured, which must give the timed calls' latents,
parameters and Adam state bit for bit (``replay_apart``: the tensors that
differ).  Then it holds, in float64 against ``port_bench/reference/pc.py``,
each batch from the state the program started it from:

* ``step_gap``: each captured step against one reference Adam step from
  the program's state before it, the moments rebuilt from the reference's
  gradients at the program's states (the median row's gap, the worst
  step's);
* ``final_gap``: the final latents against ``T`` reference steps from the
  same initial latents (the median row's gap: Adam's steps part a few rows
  under any rounding);
* ``grad_gap``: the gradient the parameters' Adam received (from its first
  moment) against the reference's at the program's last state (the worst
  kept leaf's norm of the difference);
* ``change_gap``: the parameters' change against the reference's Adam step
  from the program's parameters and state, over the entries whose reference
  gradient is clear of rounding (the worst kept leaf's).

A row's gap is its largest element gap over its largest reference element.
"""

from __future__ import annotations

import importlib
import types
import typing as tp

import torch

from port_bench.lib import common
from port_bench.lib.common import Number
from port_bench.reference import flops
from port_bench.reference import mcpc as ref
from port_bench.reference import pc

KIND = "train_pc"
# the limits of the compared numbers (PERF.md gives the readings they are
# set from)
STEP_GAP_LIMIT = 1e-5
FINAL_GAP_LIMIT = 1e-5
GRAD_GAP_LIMIT = 4e-6
CHANGE_GAP_LIMIT = 6e-5
# leaves whose reference gradient is under this share of the median leaf's
# move by rounding alone and are not compared
NOUGHT_SHARE = 1e-3
# entries of a leaf whose reference gradient is under this share of the
# leaf's largest can change sign under rounding, which turns Adam's first
# step (lr times the sign) around: the change is compared on the rest
CLEAR_SHARE = 1e-4

CHAIN_MODULE = "montecarlopredictivecoding_tpu_torch.ops.mcpc_chain"


def _config(cell) -> dict:
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist

    d0, d1, d2, D = cell.dims
    m = cell.mix
    config = train_mnist.apply_preset(train_mnist.pc_training_config(), "mse", "pc")
    config.update(input_size=d0, hidden_size=d1, hidden2_size=d2, output_size=D,
                  activation_fn=cell.model["activation_fn"], batch_size_train=m["batch"],
                  T_pc=m["warm_steps"], optimizer_x_kwargs_pc={"lr": m["warm_lr"]},
                  optimizer_p_kwargs={"lr": m["param_lr"]})
    return config


def inputs(cell, seed: int, device) -> types.SimpleNamespace:
    """Weights, the image pool and the model's generator seed."""
    m = cell.mix
    B = m["batch"]
    pool = common.make_images(B * m["pool_batches"], cell.dims[3], seed, device)
    return types.SimpleNamespace(params=common.make_params(cell.dims, seed, device),
                                 pool=pool, B=B, gen_seed=common.derive(seed, 30))


def batch_rows(inp, i: int) -> torch.Tensor:
    n = inp.pool.shape[0] // inp.B
    j = i % n
    return inp.pool[j * inp.B : (j + 1) * inp.B]


def launch_counts(st) -> tp.Optional[tp.Tuple[int, int, int]]:
    """(packed f32 chain launches, bf16 ones, summing passes) so far, on a
    card (the plain version counts none)."""
    if st.inp.pool.device.type != "cuda":
        return None
    c = st.chain_mod
    return c.mcpc_chain.launches, c.mcpc_chain.launches_bf16, c.sum_block_partials.launches


def make_trainer(st, params, gen_seed: int):
    """A model from ``get_model`` holding ``params`` and a CPU generator
    seeded ``gen_seed``, and its training ``PCTrainer``."""
    gen = st.factory.get_model(st.config, gen_seed, device=st.inp.pool.device)
    gen.params = params
    gen.generator = torch.Generator().manual_seed(gen_seed)
    return gen, st.factory.get_pc_trainer(gen, st.config, is_mcpc=False, training=True)


def setup(cell, seed: int, device, span) -> types.SimpleNamespace:
    from montecarlopredictivecoding_tpu_torch.models import factory

    inp = inputs(cell, seed, device)
    st = types.SimpleNamespace(inp=inp, cell=cell, config=_config(cell), factory=factory,
                               chain_mod=importlib.import_module(CHAIN_MODULE), batches=0)
    st.gen, st.trainer = make_trainer(st, inp.params, inp.gen_seed)
    if not hasattr(st.trainer, "kernel_param_updates"):
        raise RuntimeError("this PCTrainer does not count the chain path's parameter updates")
    st.pseudo = torch.zeros((st.inp.B, cell.dims[0]), device=device)
    st.snapshots = []
    for _ in range(cell.mix["check_steps"]):
        p0, s0 = st.gen.params, st.trainer._opt_p_state
        step(st, span)
        st.snapshots.append(types.SimpleNamespace(
            p0=p0, s0=s0, p1=st.gen.params, s1=st.trainer._opt_p_state, final=st.gen.latents))
    return st


def train_on_batch(st, trainer, i: int, **kw):
    return trainer.train_on_batch(st.pseudo, loss_fn=st.config["loss_fn"],
                                  loss_fn_kwargs={"_target": batch_rows(st.inp, i)}, **kw)


def step(st, span) -> None:
    """One batch of ``train_pc``'s loop."""
    with span("bench.train_on_batch"):
        train_on_batch(st, st.trainer, st.batches, is_return_results_every_t=False)
    st.batches += 1


def check_path(st, before, n: int) -> None:
    """Raises unless every batch took the chain's path with a parameter
    update and, on a card, each window batch one packed f32 chain launch and
    one summing pass."""
    t = st.trainer
    got = (t.kernel_calls, t.engine_calls, t.kernel_param_updates)
    if got != (st.batches, 0, st.batches):
        raise RuntimeError(f"{st.batches} batches: kernel calls, engine calls, kernel "
                           f"parameter updates {got}")
    if before is not None:
        done = tuple(b - a for a, b in zip(before, launch_counts(st)))
        if done != (n, 0, n):
            raise RuntimeError(f"{n} window batches: f32 chain launches, bf16 chain launches, "
                               f"summing passes {done}")


def window(st, seconds: float, span) -> types.SimpleNamespace:
    """Batches back to back for ``seconds``."""
    before = launch_counts(st)
    marks = common.Marks(st.inp.pool.device)
    n = 0
    while marks.elapsed() < seconds:
        step(st, span)
        n += 1
    elapsed = marks.close()
    check_path(st, before, n)
    m = st.cell.mix
    calls = {"dims": st.cell.dims, "B": st.inp.B, "steps": m["warm_steps"], "sampling": 1,
             "count": n}
    return types.SimpleNamespace(
        seconds=elapsed, items=n, attempted=n, failed=0,
        end_to_end={"train_images_per_s": n * st.inp.B / elapsed},
        chain_calls=[calls],
        flops=n * flops.chain_flops(st.cell.dims, st.inp.B, m["warm_steps"], sampling=1))


def release(st) -> None:
    """Drop what the window made; the set-up's snapshots stay for the check."""
    st.gen = st.trainer = None


def tensors(tree) -> tp.List[tp.Any]:
    """The tensors and counts of a tree of dicts, tuples and Adam states."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tensors(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tensors(t)]
    if hasattr(tree, "mu"):
        return [tree.count] + tensors(tree.mu) + tensors(tree.nu)
    return [tree]


def apart(a, b) -> int:
    """How many tensors (or counts) of two trees differ in any bit."""
    a, b = tensors(a), tensors(b)
    same = lambda x, y: torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    return sum(1 for x, y in zip(a, b) if not same(x, y)) + abs(len(a) - len(b))


def adam_state(state, params, dtype=torch.float64):
    """(count, mu, nu) of the port's Adam state in ``dtype``; zeros before
    the first step."""
    if state is None:
        zero = [{k: torch.zeros_like(v, dtype=dtype) for k, v in p.items()} for p in params]
        return 0, zero, [dict(z) for z in zero]
    s = state[0]  # the port's chain: (ScaleByAdamState, the scale's ())
    conv = lambda tree: [{k: v.to(dtype) for k, v in p.items()} for p in tree]
    return s.count, conv(s.mu), conv(s.nu)


def received(snap) -> tp.List[dict]:
    """The gradient the parameters' Adam received, from its first moment."""
    b1, w = ref.f32(0.9), ref.f32(1.0 - 0.9)
    mu0, mu1 = adam_state(snap.s0, snap.p0)[1], adam_state(snap.s1, snap.p0)[1]
    return [{k: (a[k] - b1 * b[k]) / w for k in a} for a, b in zip(mu1, mu0)]


def relaunch(st) -> tp.List[types.SimpleNamespace]:
    """The set-up's batches again, through a fresh trainer from the same
    parameters and generator seed, with every step captured: a record a
    batch of what the comparison holds."""
    gen, trainer = make_trainer(st, st.snapshots[0].p0, st.inp.gen_seed)
    records = []
    for i, snap in enumerate(st.snapshots):
        res = train_on_batch(st, trainer, i, is_return_results_every_t=True, is_return_xs=True,
                             capture_stride=1)
        states = torch.cat([torch.cat(res["xs"], -1), torch.cat(gen.latents, -1)[None]])
        records.append(types.SimpleNamespace(
            i=i, p0=snap.p0, s0=adam_state(snap.s0, snap.p0), p1=snap.p1, grads=received(snap),
            states=states, apart=apart((gen.latents, gen.params, trainer._opt_p_state),
                                       (snap.final, snap.p1, snap.s1))))
        del res
    return records


def step_refs(chain, states: torch.Tensor, m: dict) -> torch.Tensor:
    """One reference Adam step from each of the states but the last [T+1, B,
    N], the moments rebuilt from the reference's gradients at the states
    before it: the states [T, B, N] it reaches."""
    T = states.shape[0] - 1
    G = chain.terms(states[:-1])[0]
    (w1, w1c, w2, w2c), cs = ref.adam_constants(0.9, 0.999, T)
    mom, v = torch.zeros_like(G[0]), torch.zeros_like(G[0])
    move = torch.empty_like(G)
    for t, (c1, c2) in enumerate(cs):
        mom = w1 * mom + w1c * G[t]
        v = w2 * v + w2c * G[t] * G[t]
        move[t] = (mom / c1) / (torch.sqrt(v / c2) + 1e-8)
    return states[:-1] - m["warm_lr"] * move


def diff_gap(prog, refs, keep) -> float:
    """The largest norm of a kept leaf's difference over the larger of its
    reference's norm and the median kept leaf's."""
    diffs = [float(torch.linalg.vector_norm(p[k].double() - r[k]))
             for p, r in zip(prog, refs) for k in ("w", "b")]
    norms = common.leaf_norms(refs)
    kept = sorted(n for n, k in zip(norms, keep) if k)
    med = kept[len(kept) // 2]
    return max(d / max(n, med) for d, n, k in zip(diffs, norms, keep) if k)


def change_gap(p0, p1, r_p1, r_grads, keep) -> float:
    """The worst kept leaf's norm of the change's difference over the
    reference change's norm, on the entries clear of rounding."""
    worst = 0.0
    j = 0
    for a, b, r, g in zip(p0, p1, r_p1, r_grads):
        for k in ("w", "b"):
            if keep[j]:
                clear = g[k].abs() >= CLEAR_SHARE * g[k].abs().max()
                d = (b[k].double() - a[k]) - (r[k] - a[k])
                worst = max(worst, float(torch.linalg.vector_norm(d[clear])
                                         / torch.linalg.vector_norm((r[k] - a[k])[clear])))
            j += 1
    return worst


def numbers(cell, inp, records) -> tp.List[Number]:
    """The records (batches 0, 1, ... of the set-up, in order) held to the
    float64 reference; each number is the worst batch's."""
    m = cell.mix
    B, T, dims = inp.B, m["warm_steps"], cell.dims
    device = inp.pool.device
    gen = torch.Generator().manual_seed(inp.gen_seed)
    keep = None
    gaps = {"step_gap": 0.0, "final_gap": 0.0, "grad_gap": 0.0, "change_gap": 0.0}
    for rec in records:
        X0 = common.replay_latents(gen, B, dims).to(device, torch.float64)
        common.replay_chain_seed(gen)  # the batch's chain seed, which Adam does not use
        chain = pc.Chain(rec.p0, batch_rows(inp, rec.i))
        states = rec.states.double()
        R = step_refs(chain, states, m)
        gaps["step_gap"] = max(gaps["step_gap"], float(
            common.row_share_gap(common.row_gaps(states[1:], R)).max()))
        del R
        final = pc.adam_states(chain, X0, T, m["warm_lr"])[-1]
        gaps["final_gap"] = max(gaps["final_gap"], float(
            common.row_share_gap(common.row_gaps(states[-1], final))))
        sums = ref.pgrads_tree(pc.hebbian_sums(chain, states[-2]), dims)
        r_grads = [{k: v / B for k, v in g.items()} for g in sums]
        if keep is None:  # the first batch's reference gradient sets the rule
            refs = common.leaf_norms(r_grads)
            med = sorted(refs)[len(refs) // 2]
            keep = [r >= NOUGHT_SHARE * med for r in refs]
        gaps["grad_gap"] = max(gaps["grad_gap"], diff_gap(rec.grads, r_grads, keep))
        p0 = [{k: v.double() for k, v in p.items()} for p in rec.p0]
        r_p1, _ = pc.param_step(p0, rec.s0, sums, B, m["param_lr"])
        gaps["change_gap"] = max(gaps["change_gap"], change_gap(p0, rec.p1, r_p1, r_grads, keep))
    limits = {"step_gap": STEP_GAP_LIMIT, "final_gap": FINAL_GAP_LIMIT,
              "grad_gap": GRAD_GAP_LIMIT, "change_gap": CHANGE_GAP_LIMIT}
    return ([Number("replay_apart", float(sum(r.apart for r in records)), 0.0)]
            + [Number(k, v, limits[k]) for k, v in gaps.items()])


def check(st) -> tp.List[Number]:
    return numbers(st.cell, st.inp, relaunch(st))


def control(cell, seed: int, device, mm=torch.matmul) -> tp.List[Number]:
    """The reference in float32 with the product ``mm`` (TF32 on the card)
    put in the program's place for the set-up's batches, each held to the
    float64 reference from the state it started from."""
    inp = inputs(cell, seed, device)
    m = cell.mix
    gen = torch.Generator().manual_seed(inp.gen_seed)
    params, state = inp.params, ref.adam_init(inp.params)
    records = []
    for i in range(m["check_steps"]):
        X0 = common.replay_latents(gen, inp.B, cell.dims).to(device)
        common.replay_chain_seed(gen)
        states, sums = pc.train_batch(params, X0, batch_rows(inp, i), m["warm_steps"],
                                      m["warm_lr"], torch.float32, mm)
        new, new_state = pc.param_step(params, state, sums, inp.B, m["param_lr"])
        count, mu, nu = state
        conv = lambda tree: [{k: v.double() for k, v in p.items()} for p in tree]
        records.append(types.SimpleNamespace(
            i=i, p0=params, s0=(count, conv(mu), conv(nu)), p1=new,
            grads=[{k: (v / inp.B).double() for k, v in g.items()} for g in sums],
            states=states, apart=0))
        params, state = new, new_state
    return numbers(cell, inp, records)
