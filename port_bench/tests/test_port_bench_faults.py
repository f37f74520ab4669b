"""The comparison that decides ``correct`` against the faults a cell can
have, planted underneath a whole tiny run on the CPU (the harness's look for
a card skipped): a step that returns its state unchanged; half of the batch
left out, the mean taken over the rest; an answer altered where it is
produced.  (No cell spans chips, so none can leave out an exchange.)  And
the control: the reference with TF32 products (emulated here) in the
program's place fails at least one number of every cell."""

import importlib

import pytest
import torch

from port_bench import run as bench
from port_bench.lib.cell import entry_module
from port_bench.tests import tiny

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
train_mnist = importlib.import_module("montecarlopredictivecoding_tpu_torch.experiments.train_mnist")
metrics = importlib.import_module("montecarlopredictivecoding_tpu_torch.eval.metrics")
CPU = torch.device("cpu")


def setup_module():
    torch.set_num_threads(1)


def _outputs(kw):
    """Positions of the chain's outputs: (trajectory or None, moments or None)."""
    k = 2
    traj = None
    if kw.get("capture_stride", 0) > 0:
        traj, k = k, k + 1
    k += 1 if kw.get("return_scalars") else 0
    return traj, (k if kw.get("emit_warm_opt_state") else None)


def unchanged_state(original):
    """Every step leaves the latents where they are."""
    def chain(params, latents, target, seed, **kw):
        kw = dict(kw, lr=0.0, noise_var=None, warm_lr=0.0)
        return original(params, latents, target, seed, **kw)
    return chain


def half_batch(original):
    """The chain runs on the first half of the rows; the rest keep their
    latents, and the gradient sums are doubled: the mean over the rest."""
    def chain(params, latents, target, seed, **kw):
        h = latents[0].shape[0] // 2
        outs = list(original(params, tuple(x[:h] for x in latents),
                             None if target is None else target[:h], seed, **kw))
        outs[0] = tuple(torch.cat([a, x[h:]]) for a, x in zip(outs[0], latents))
        if outs[1] is not None:
            outs[1] = [{k: 2.0 * v for k, v in g.items()} for g in outs[1]]
        dims = tuple(x.shape[1] for x in latents[:3])
        rest = chain_mod._pack_aligned(tuple(x[h:] for x in latents[:3]), dims)
        traj, moments = _outputs(kw)
        if traj is not None:
            t = outs[traj]
            outs[traj] = torch.cat([t, rest[None].expand(t.shape[0], -1, -1)], 1)
        if moments is not None:
            outs[moments] = tuple(torch.cat([m, torch.zeros_like(rest)]) for m in outs[moments])
        return tuple(outs)
    return chain


def altered_gradients(original):
    """One gradient sum is off by a hundredth."""
    def chain(params, latents, target, seed, **kw):
        outs = list(original(params, latents, target, seed, **kw))
        if outs[1] is not None:
            outs[1] = [dict(g) for g in outs[1]]
            outs[1][3]["w"] = outs[1][3]["w"] * 1.01
        return tuple(outs)
    return chain


def altered_capture(original):
    """One captured state of the Langevin chain is off by a thousandth."""
    def chain(params, latents, target, seed, **kw):
        outs = list(original(params, latents, target, seed, **kw))
        traj, _ = _outputs(kw)
        if traj is not None:
            t = outs[traj].clone()
            t[t.shape[0] // 2] *= 1.001
            outs[traj] = t
        return tuple(outs)
    return chain


def altered_mse(original):
    """The returned MSE is off by a thousandth."""
    return lambda *a, **k: original(*a, **k) * 1.001


FAULTS = {
    "train": {"unchanged_state": None, "half_batch": half_batch,
              "altered_answer": altered_gradients},
    "sample": {"unchanged_state": unchanged_state, "half_batch": half_batch,
               "altered_answer": altered_capture},
    "eval": {"unchanged_state": unchanged_state, "half_batch": half_batch,
             "altered_answer": None},
}


@pytest.mark.parametrize("kind, fault", [(k, f) for k in FAULTS for f in FAULTS[k]])
def test_fault_is_not_correct(kind, fault, monkeypatch):
    make = FAULTS[kind][fault]
    if kind == "train" and fault == "unchanged_state":
        # the training step returns its state as it got it
        monkeypatch.setattr(train_mnist, "one_batch", lambda p, s, *a, **k: (p, s))
    elif kind == "eval" and fault == "altered_answer":
        monkeypatch.setattr(metrics, "get_mse_rec", altered_mse(metrics.get_mse_rec))
    elif kind == "train":
        monkeypatch.setattr(train_mnist, "mcpc_chain", make(train_mnist.mcpc_chain))
    else:
        monkeypatch.setattr(chain_mod, "mcpc_chain", make(chain_mod.mcpc_chain))
    res = bench.run(tiny.cell(kind), tiny.SEED, 0.2, False, CPU)
    assert not res["correct"], res["limits"]


@pytest.mark.parametrize("kind", ["train", "sample", "eval"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(kind, seed):
    c = tiny.cell(kind)
    numbers = entry_module(c).control(c, seed, CPU, mm=tiny.tf32_matmul)
    assert not all(n.ok for n in numbers), numbers


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mcpc_fid.train", "mcpc_fid.sample", "mcpc_mse.eval"])
def test_control_at_the_cells_size_on_the_card(workload):
    """The control on the card at the cell's own size, TF32 products on the
    tensor cores (``port_bench/control.py`` runs the same for more seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from port_bench.lib.cell import load_cell

    c = load_cell(workload)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        numbers = entry_module(c).control(c, 7, torch.device("cuda", 0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert not all(n.ok for n in numbers), numbers
