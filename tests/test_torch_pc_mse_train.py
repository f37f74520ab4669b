"""PC training of table 1's reconstruction model (the ``mse`` preset of
``train_pc``: tanh) through ``PCTrainer``, on the CPU at small widths, held
to the benchmark's plain reference ``port_bench/reference/pc.py``.

Each batch is ``train_pc``'s loop body: latents drawn at batch start from
the model's generator, ``T`` Adam MAP steps and the last step's parameter
gradients in one chain call (its plain version here), then the trainer's
Adam step on the parameters.  Two batches in a row, each held from the
parameters and Adam state it started from, on the latents replayed from
the generator: the final latents, the gradient the parameters' Adam
received (from its first moment) and the parameters after the step.  A
forced relu and a skipped parameter update fail the holds.  The trainer's
``mcpc.trainer.*`` spans nest inside ``mcpc.train_on_batch`` under a
profiler and change no bit, and ``kernel_param_updates`` counts batches."""

import functools
import importlib
import json

import pytest
import torch

from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
from montecarlopredictivecoding_tpu_torch.models.factory import get_model, get_pc_trainer
from montecarlopredictivecoding_tpu_torch.utils import observability as obs
from port_bench.reference import mcpc as ref
from port_bench.reference import pc

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
trainer_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.core.trainer")

torch.set_num_threads(1)

DIMS = (6, 16, 16, 32)
B = 8
T = 20
BATCHES = 2
CONFIG = dict(train_mnist.apply_preset(train_mnist.pc_training_config(), "mse", "pc"),
              input_size=6, hidden_size=16, hidden2_size=16, output_size=32, T_pc=T)
LR_X = CONFIG["optimizer_x_kwargs_pc"]["lr"]
LR_P = CONFIG["optimizer_p_kwargs"]["lr"]

# The tolerances, each over its reference's largest entry.  Latents: 20
# Adam steps in float32 against float64 round each step at about 6e-8 of
# a latent and Adam's normalised steps do not amplify it over so few steps
# (the plain version reads 3e-7); relu in tanh's place moves them by whole
# units.  Gradients: float32 sums over the batch and the widths, 2e-7 of
# the largest entry read.  Parameters: measured in the step's own scale,
# the learning rate; float32 rounds a parameter of 0.4 at 3e-5 of it, and
# a skipped step is off by the whole of it.
LATENT_TOL = 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-3


def target(i):
    g = torch.Generator().manual_seed(100 + i)
    return (torch.rand((B, DIMS[3]), generator=g) > 0.5).float()


def run_batches(seed=0):
    """``BATCHES`` batches of ``train_pc``'s loop: (the trainer, each batch's
    record)."""
    gen = get_model(CONFIG, seed, device="cpu")
    trainer = get_pc_trainer(gen, CONFIG, is_mcpc=False, training=True)
    records = []
    for i in range(BATCHES):
        rec = {"state": gen.generator.get_state(), "p0": gen.params,
               "s0": trainer._opt_p_state, "y": target(i)}
        trainer.train_on_batch(torch.zeros((B, DIMS[0])), loss_fn=CONFIG["loss_fn"],
                               loss_fn_kwargs={"_target": rec["y"]},
                               is_return_results_every_t=False)
        rec.update(p1=gen.params, s1=trainer._opt_p_state, latents=gen.latents)
        records.append(rec)
    return trainer, records


@functools.lru_cache(maxsize=None)
def sound():
    return run_batches()[1]


def moments(state, params):
    """(count, mu, nu) of the trainer's parameter Adam state in float64."""
    if state is None:
        zero = [{k: torch.zeros_like(v, dtype=torch.float64) for k, v in p.items()}
                for p in params]
        return 0, zero, [dict(z) for z in zero]
    s = state[0]
    conv = lambda tree: [{k: v.double() for k, v in p.items()} for p in tree]
    return s.count, conv(s.mu), conv(s.nu)


def gaps(rec) -> dict:
    """The batch against the reference from the same start: each quantity's
    largest difference over its reference's largest entry (the parameters
    over the learning rate)."""
    g = torch.Generator()
    g.set_state(rec["state"])
    X0 = torch.cat([-10.0 + 20.0 * torch.rand((B, d), generator=g) for d in DIMS[:3]], 1)
    states, sums = pc.train_batch(rec["p0"], X0, rec["y"], T, LR_X)
    final = torch.cat(rec["latents"], 1).double()
    out = {"latents": float((final - states[-1]).abs().max() / states[-1].abs().max())}
    s0, s1 = moments(rec["s0"], rec["p0"]), moments(rec["s1"], rec["p0"])
    b1, w = ref.f32(0.9), ref.f32(1.0 - 0.9)
    got = [{k: (a[k] - b1 * b[k]) / w for k in a} for a, b in zip(s1[1], s0[1])]
    out["gradients"] = max(float((got[j][k] - sums[j][k] / B).abs().max()
                                 / (sums[j][k] / B).abs().max())
                           for j in range(4) for k in ("w", "b") if (j, k) != (0, "w"))
    p0 = [{k: v.double() for k, v in p.items()} for p in rec["p0"]]
    want, _ = pc.param_step(p0, s0, sums, B, LR_P)
    out["parameters"] = max(float((rec["p1"][j][k].double() - want[j][k]).abs().max()) / LR_P
                            for j in range(4) for k in ("w", "b"))
    return out


TOLS = {"latents": LATENT_TOL, "gradients": GRAD_TOL, "parameters": PARAM_TOL}


@pytest.mark.parametrize("quantity", list(TOLS))
@pytest.mark.parametrize("batch", range(BATCHES))
def test_batch_matches_the_reference(batch, quantity):
    got = gaps(sound()[batch])[quantity]
    assert got <= TOLS[quantity], (batch, quantity, got)


def test_the_second_batch_continues_the_first():
    """The second batch starts from the first's parameters and Adam state,
    and the generator goes on: fresh latents, Adam's count 2."""
    first, second = sound()
    assert second["p0"] is first["p1"] and second["s0"] is first["s1"]
    assert second["s1"][0].count == 2
    assert not torch.equal(torch.cat(second["latents"], 1), torch.cat(first["latents"], 1))


def relu_chain(original):
    return lambda *a, **kw: original(*a, **dict(kw, activation="relu"))


@pytest.mark.parametrize("fault, fails", [("relu", "latents"), ("skipped_update", "parameters")])
def test_a_fault_fails_the_holds(fault, fails, monkeypatch):
    if fault == "relu":
        monkeypatch.setattr(chain_mod, "mcpc_chain", relu_chain(chain_mod.mcpc_chain))
    else:
        monkeypatch.setattr(trainer_mod, "apply_updates", lambda params, updates: params)
    got = gaps(run_batches()[1][0])
    assert got[fails] > 100 * TOLS[fails], got


def same(a, b) -> bool:
    """Equal trees of tensors and Adam states, bit for bit."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if hasattr(a, "mu"):
        return a.count == b.count and same(a.mu, b.mu) and same(a.nu, b.nu)
    return a == b


def recorded(prof):
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X" and e.get("cat") == "user_annotation"
            and e["name"].startswith("mcpc.")]


def test_trainer_spans_nest_and_change_nothing(tmp_path):
    with obs.profile_trace(str(tmp_path)) as prof:
        _, traced = run_batches()
    spans = recorded(prof)
    outer = [(s, e) for n, s, e in spans if n == "mcpc.train_on_batch"]
    assert len(outer) == BATCHES
    for name in ("mcpc.trainer.param_update", "mcpc.trainer.warm_state"):
        inner = [(s, e) for n, s, e in spans if n == name]
        assert len(inner) == BATCHES, name
        assert all(any(s0 <= s and e <= e0 for s0, e0 in outer) for s, e in inner), name
    kept = lambda records: [(r["p1"], r["latents"], r["s1"]) for r in records]
    assert same(kept(traced), kept(sound()))


def test_kernel_param_updates_counts_batches():
    trainer, _ = run_batches()
    assert (trainer.kernel_calls, trainer.engine_calls, trainer.kernel_param_updates) == (
        BATCHES, 0, BATCHES)
    warm_only = get_pc_trainer(get_model(CONFIG, 1, device="cpu"), CONFIG, is_mcpc=True)
    warm_only.train_on_batch(torch.zeros((B, DIMS[0])), loss_fn=CONFIG["loss_fn"],
                             loss_fn_kwargs={"_target": target(0)},
                             is_return_results_every_t=False)
    assert (warm_only.kernel_calls, warm_only.kernel_param_updates) == (1, 0)
