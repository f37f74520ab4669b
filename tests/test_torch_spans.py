"""The port's spans (``utils.observability.span``): one shared no-op while no
profiler records; under ``profile_trace`` the ``mcpc.*`` spans at the layer
boundaries, nested by containment on the host thread; results and the
launch counters the same with and without a profiler recording."""

import dataclasses
import importlib
import json

import pytest
import torch

import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu_torch.eval import metrics
from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
from montecarlopredictivecoding_tpu_torch.models.factory import get_mcpc_trainer, get_pc_trainer
from montecarlopredictivecoding_tpu_torch.utils import observability as obs

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

torch.set_num_threads(1)

DIMS = (4, 8, 8, 16)
B = 8
CONFIG = dict(train_mnist.mcpc_training_config(), input_size=4, hidden_size=8, hidden2_size=8,
              output_size=16, T_pc=4, mixing=1, sampling=3)


def recorded(prof):
    """The trace's ``mcpc.*`` spans as (name, start, end), in start order."""
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"].startswith("mcpc.")), key=lambda s: s[1])


def names(spans):
    return [n for n, _, _ in spans]


def inside(spans, inner, outer):
    """Each ``inner`` span lies within an ``outer`` span."""
    outers = [(s, e) for n, s, e in spans if n == outer]
    return all(any(s0 <= s and e <= e0 for s0, e0 in outers)
               for n, s, e in spans if n == inner)


def counters(trainer=None):
    c = chain_mod.mcpc_chain
    out = [c.launches, c.launches_unpacked, c.launches_bf16, c.launches_unpacked_bf16,
           chain_mod.sum_block_partials.launches]
    if trainer is not None:
        out += [trainer.kernel_calls, trainer.engine_calls]
    return out


def same(a, b):
    """Equal trees of tensors, bit for bit."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if dataclasses.is_dataclass(a):
        return type(a) is type(b) and same(dataclasses.astuple(a), dataclasses.astuple(b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def batch(seed):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((B, DIMS[3]), generator=g) > 0.5).float()


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) made with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refused)
    first = obs.span("mcpc.a")
    assert first is obs.span("mcpc.b") is obs.span("mcpc.a")
    with obs.span("mcpc.a"), obs.span("mcpc.b"):
        pass


def test_span_under_a_profiler_lands_in_its_trace(tmp_path):
    with obs.profile_trace(str(tmp_path)) as prof:
        s = obs.span("mcpc.test")
        assert isinstance(s, torch.profiler.record_function)
        with s:
            torch.ones(4).sum()
    assert names(recorded(prof)) == ["mcpc.test"]
    assert obs.span("mcpc.test") is obs.span("mcpc.other")


def one_batch_inputs():
    model = mt.make_mlp_model(*DIMS)
    g = torch.Generator().manual_seed(3)
    params = model.init(g, device="cpu")
    latents = model.init_latents(params, torch.zeros(B, DIMS[0]), g)
    state = train_mnist.param_optimizer(CONFIG).init(params)
    return params, state, latents, batch(4)


def test_one_batch_spans_and_results(tmp_path):
    """``one_batch`` is one ``mcpc.one_batch`` span a call with the chain's
    ``mcpc.chain`` inside; its parameters, Adam state and the counters are
    the same traced as untraced."""
    params, state, latents, data = one_batch_inputs()
    before = counters()
    plain = train_mnist.one_batch(params, state, latents, 11, data, config=CONFIG)
    moved = [a - b for a, b in zip(counters(), before)]
    before = counters()
    with obs.profile_trace(str(tmp_path)) as prof:
        for _ in range(2):
            traced = train_mnist.one_batch(params, state, latents, 11, data, config=CONFIG)
    assert [(a - b) / 2 for a, b in zip(counters(), before)] == moved
    spans = recorded(prof)
    assert names(spans) == ["mcpc.one_batch", "mcpc.chain"] * 2
    assert inside(spans, "mcpc.chain", "mcpc.one_batch")
    assert same(plain, traced)


def trainer_run(profile_dir=None, use_kernel="auto"):
    """A Langevin ``train_on_batch`` with captures from fresh latents:
    (its results, the latents after it, the counters' moves, the spans)."""
    gen = mt.GenerativeModel(mt.make_mlp_model(*DIMS), 5, device="cpu")
    tr = get_mcpc_trainer(gen, CONFIG, training=False)
    tr.use_kernel = use_kernel
    before = counters(tr)
    run = lambda: tr.train_on_batch(
        torch.zeros(B, DIMS[0]), loss_fn=mt.bernoulli_fn, loss_fn_kwargs={"_target": batch(6)},
        callback_after_t=mt.LangevinStep(var=2.0), is_return_xs=True, capture_stride=1)
    if profile_dir is None:
        res, spans = run(), None
    else:
        with obs.profile_trace(profile_dir) as prof:
            res = run()
        spans = recorded(prof)
    return res, gen.latents, [a - b for a, b in zip(counters(tr), before)], spans


def test_train_on_batch_chain_path_spans_and_results(tmp_path):
    """The chain path (``mcpc_chain``'s plain version on the CPU) with
    captures: ``mcpc.init_latents`` and ``mcpc.chain`` inside
    ``mcpc.train_on_batch``, ``mcpc.capture_rows`` inside ``mcpc.chain``;
    the results, latents and counters as untraced."""
    res, latents, moved, _ = trainer_run()
    t_res, t_latents, t_moved, spans = trainer_run(str(tmp_path))
    assert moved == t_moved and moved[-2:] == [1, 0]  # kernel_calls, engine_calls
    assert names(spans) == ["mcpc.train_on_batch", "mcpc.init_latents", "mcpc.chain",
                            "mcpc.capture_rows"]
    assert inside(spans, "mcpc.init_latents", "mcpc.train_on_batch")
    assert inside(spans, "mcpc.chain", "mcpc.train_on_batch")
    assert inside(spans, "mcpc.capture_rows", "mcpc.chain")
    assert same(res, t_res) and same(latents, t_latents)


def test_train_on_batch_engine_path_has_no_span_inside_its_steps(tmp_path):
    """The step engine's per-step loop carries no span: the call's and the
    latents' draw alone."""
    res, latents, moved, _ = trainer_run(use_kernel=False)
    t_res, t_latents, t_moved, spans = trainer_run(str(tmp_path), use_kernel=False)
    assert moved == t_moved and moved[-2:] == [0, 1]
    assert names(spans) == ["mcpc.train_on_batch", "mcpc.init_latents"]
    assert inside(spans, "mcpc.init_latents", "mcpc.train_on_batch")
    assert same(res, t_res) and same(latents, t_latents)


@pytest.mark.parametrize("k", [1, 3])
def test_get_mse_rec_one_score_span_a_batch(k, tmp_path):
    """``get_mse_rec`` over k batches: k ``mcpc.mse_rec.score`` spans, each
    after its batch's ``mcpc.train_on_batch``, then one
    ``mcpc.mse_rec.readback`` after the last of them and inside no
    ``mcpc.train_on_batch``; the MSE and latents as untraced."""
    config = dict(CONFIG, T_pc=4, optimizer_x_kwargs_pc={"lr": 0.1})
    batches = [(batch(20 + i), None) for i in range(k)]

    def score():
        gen = mt.GenerativeModel(mt.make_mlp_model(*DIMS), 7, device="cpu")
        return metrics.get_mse_rec(gen, config, batches), gen.latents

    mse, latents = score()
    with obs.profile_trace(str(tmp_path)) as prof:
        t_mse, t_latents = score()
    spans = recorded(prof)
    top = [n for n in names(spans)
           if n in ("mcpc.train_on_batch", "mcpc.mse_rec.score", "mcpc.mse_rec.readback")]
    assert top == ["mcpc.train_on_batch", "mcpc.mse_rec.score"] * k + ["mcpc.mse_rec.readback"]
    assert not inside(spans, "mcpc.mse_rec.score", "mcpc.train_on_batch")
    assert not inside(spans, "mcpc.mse_rec.readback", "mcpc.train_on_batch")
    (readback,) = [s for s in spans if s[0] == "mcpc.mse_rec.readback"]
    assert readback[1] >= max(e for n, _, e in spans if n == "mcpc.mse_rec.score")
    assert mse == t_mse and same(latents, t_latents)


def test_pc_trainer_warm_start_spans(tmp_path):
    """The PC trainer's Adam warm start takes the chain too: one
    ``mcpc.chain`` inside its ``mcpc.train_on_batch``, then the graft of
    the chain's Adam moments (``mcpc.trainer.warm_state``) inside it; no
    capture rows without captures and no parameter update."""
    gen = mt.GenerativeModel(mt.make_mlp_model(*DIMS), 8, device="cpu")
    tr = get_pc_trainer(gen, CONFIG, is_mcpc=True, training=False)
    with obs.profile_trace(str(tmp_path)) as prof:
        tr.train_on_batch(torch.zeros(B, DIMS[0]), loss_fn=mt.bernoulli_fn,
                          loss_fn_kwargs={"_target": batch(9)}, is_return_results_every_t=False)
    spans = recorded(prof)
    assert names(spans) == ["mcpc.train_on_batch", "mcpc.init_latents", "mcpc.chain",
                            "mcpc.trainer.warm_state"]
    assert tr.kernel_calls == 1 and inside(spans, "mcpc.chain", "mcpc.train_on_batch")
    assert inside(spans, "mcpc.trainer.warm_state", "mcpc.train_on_batch")
