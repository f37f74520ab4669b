"""The cell ``pc_mse.train_pc`` at a tiny size on the CPU: a whole run
compares correct; each fault planted underneath reads ``correct`` false
(a chain that leaves its state unchanged, half of the batch left out, relu
in tanh's place, the parameters' Adam step skipped), and so does the
control, the reference with TF32 products (emulated here) in the program's
place; the cell's readers return None on a timeline without the program's
spans; and the FLOP count against a hand count."""

import importlib
import json
import types

import pytest
import torch

from port_bench import run as bench
from port_bench.lib import cell as cells
from port_bench.lib.cell import BENCH_DIR, Cell, entry_module
from port_bench.lib.trace import Timeline
from port_bench.reference import flops
from port_bench.tests import test_port_bench_faults as faults
from port_bench.tests import tiny

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
trainer_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.core.trainer")
CPU = torch.device("cpu")
MODEL = {"input_size": 6, "hidden_size": 16, "hidden2_size": 16, "output_size": 36,
         "activation_fn": "tanh"}
# 250 steps at these widths part the control from the program as at full size
MID = {"input_size": 30, "hidden_size": 64, "hidden2_size": 64, "output_size": 196,
       "activation_fn": "tanh"}
METRICS = ["train_images_per_s"]


def setup_module():
    torch.set_num_threads(1)


def tiny_cell(model=MODEL, **mix) -> Cell:
    m = json.loads((BENCH_DIR / "mixes" / "train_pc.json").read_text())
    m.update(dict(batch=8, warm_steps=20, pool_batches=4), **mix)
    metrics = [{"name": n, "unit": "x"} for n in METRICS + ["setup_s"]]
    return Cell("tiny.train_pc", dict(model), m, metrics, [], 1)


def relu_chain(original):
    """The chain launched with relu in tanh's place."""
    return lambda *a, **kw: original(*a, **dict(kw, activation="relu"))


def test_tiny_cell_is_correct():
    res = bench.run(tiny_cell(), tiny.SEED, 0.3, False, CPU)
    w = res.pop("_window")
    assert w.items >= 1 and res["attempted"] == w.items and res["failed"] == 0
    assert res["correct"], res["limits"]
    assert set(res["limits"]) == {"replay_apart", "step_gap", "final_gap", "grad_gap",
                                  "change_gap"}
    assert set(res["metrics"]) == set(METRICS) | {"setup_s"}


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "relu", "skipped_param_step"])
def test_fault_is_not_correct(fault, monkeypatch):
    if fault == "skipped_param_step":
        monkeypatch.setattr(trainer_mod, "apply_updates", lambda params, updates: params)
    else:
        make = {"unchanged_state": faults.unchanged_state, "half_batch": faults.half_batch,
                "relu": relu_chain}[fault]
        monkeypatch.setattr(chain_mod, "mcpc_chain", make(chain_mod.mcpc_chain))
    res = bench.run(tiny_cell(), tiny.SEED, 0.2, False, CPU)
    assert not res["correct"], res["limits"]


def test_a_trainer_without_the_counter_fails_at_once(monkeypatch):
    """An older program's trainer has no ``kernel_param_updates``: the cell
    raises in set-up, before any batch."""
    init = trainer_mod.PCTrainer.__init__

    def older(self, *a, **kw):
        init(self, *a, **kw)
        del self.kernel_param_updates

    monkeypatch.setattr(trainer_mod.PCTrainer, "__init__", older)
    calls = []
    monkeypatch.setattr(trainer_mod.PCTrainer, "train_on_batch",
                        lambda self, *a, **kw: calls.append(1))
    with pytest.raises(RuntimeError, match="does not count"):
        bench.run(tiny_cell(), tiny.SEED, 0.2, False, CPU)
    assert calls == []


def test_an_engine_batch_fails_the_path_check(monkeypatch):
    """A batch that leaves the chain for the step engine raises after the
    window."""
    monkeypatch.setattr(trainer_mod.PCTrainer, "_kernel_eligible",
                        lambda self, *a, **kw: None)
    with pytest.raises(RuntimeError, match="engine calls"):
        bench.run(tiny_cell(), tiny.SEED, 0.2, False, CPU)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(seed):
    c = tiny_cell(MID, warm_steps=250, check_steps=1)
    numbers = entry_module(c).control(c, seed, CPU, mm=tiny.tf32_matmul)
    assert not all(n.ok for n in numbers), numbers


def test_readers_return_none_without_the_spans():
    """On a timeline with no program spans (an older program) the cell's
    span readers read nothing; the kernel and window readers read what they
    find."""
    c = cells.load_cell("pc_mse.train_pc")
    tl = Timeline(0.0, 1e6, [], [(0.0, 5e5)], [("bench.window", 0.0, 1e6)], [])
    window = types.SimpleNamespace(flops=1e9, chain_calls=[])
    ctx = types.SimpleNamespace(timeline=tl, window=window, cell=c, kind="train_pc")
    got = {m["name"]: cells.metric_reader(m["name"]).read(ctx) for m in c.per_layer}
    assert set(got) == {"mfu.train_pc", "chain_roofline.train_pc", "idle_share.train_pc",
                        "trainer_self_idle_ms.train_pc", "pc_param_update_ms.train_pc",
                        "warm_state_idle_us.train_pc", "host_waits.train_pc"}
    for name in ("chain_roofline", "trainer_self_idle_ms", "pc_param_update_ms",
                 "warm_state_idle_us", "host_waits"):
        assert got[f"{name}.train_pc"] is None, name
    assert got["idle_share.train_pc"] == pytest.approx(50.0)
    other = types.SimpleNamespace(timeline=tl, window=window, cell=c, kind="train")
    assert all(cells.metric_reader(m["name"]).read(other) is None for m in c.per_layer)


def test_flops_against_a_hand_count():
    """35.13 GFLOP a batch at the published widths: 250 steps of forward and
    backward products, 2 x 2 x 128 x (30·256 + 256·256 + 256·784), and the
    last step's Hebbian products, half a step."""
    c = cells.load_cell("pc_mse.train_pc")
    assert c.dims == (30, 256, 256, 784) and c.mix["batch"] == 128
    step = 2 * 2 * 128 * (30 * 256 + 256 * 256 + 256 * 784)
    assert step == 140_247_040
    got = flops.chain_flops(c.dims, 128, 250, sampling=1)
    assert got == 250 * step + step // 2 == 35_131_883_520
