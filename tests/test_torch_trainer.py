"""The port's PCTrainer, engine, schedules and optimizers against the JAX
package's, on the same numpy parameters, latents and targets.

Kernel path: the port's ``PCTrainer`` on CPU tensors runs the fused chain's
plain version; the JAX one runs with ``use_pallas=True`` in interpret mode.
The port's ``_chain_seed`` is patched to the seed the JAX trainer draws from
its key, so the noise is on and equal on both sides.  Engine path: the noise
is off (the two packages draw normals from different generators).

Tolerances: latents and parameters atol 1e-5 after one chain (the same f32
arithmetic summed in another order; measured up to ~5e-7), 5e-5 where the
port and the JAX package take different paths (engine against kernel, as the
JAX package's own tests allow); scalars rtol 1e-5; Adam moments atol 1e-6
of their largest entry.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.core import schedule as jschedule
from montecarlopredictivecoding_tpu.core.optim import OptimizerSpec as JSpec
from montecarlopredictivecoding_tpu_torch.core import optim as toptim
from montecarlopredictivecoding_tpu_torch.core import schedule as tschedule
from montecarlopredictivecoding_tpu_torch.utils import (
    latents_from_numpy,
    params_from_numpy,
)

torch.set_num_threads(1)

DIMS = (4, 8, 8, 16)
B = 8


def _arrays(seed=0, B=B, dims=DIMS, jmodel=None):
    jm = jmodel or mcpc.make_mlp_model(*dims)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    # one latent per PC site, as wide as the Linear before it
    widths = [next(jm.modules[j].out_dim for j in range(i, -1, -1)
                   if type(jm.modules[j]).__name__ == "Linear") for i in jm.pc_indices]
    latents = tuple(rng.uniform(-3, 3, (B, d)).astype(np.float32) for d in widths)
    target = (rng.random((B, dims[3])) > 0.5).astype(np.float32)
    return params, latents, target


class Pair:
    """A JAX trainer and the port's, on the same parameters and latents."""

    def __init__(self, trainer_kw, kernel=True, seed=0, tmodel=None, jmodel=None,
                 B=B):
        jm = jmodel or mcpc.make_mlp_model(*DIMS)
        tm = tmodel or mt.make_mlp_model(*DIMS)
        self.params, self.latents, self.target = _arrays(seed, B, jmodel=jm)
        self.jgen = mcpc.GenerativeModel(jm, key=0, params=self.params)
        self.jgen.latents = tuple(jnp.asarray(x) for x in self.latents)
        self.tgen = mt.GenerativeModel(tm, 0, params=params_from_numpy(self.params, "cpu"),
                                       device="cpu")
        self.tgen.latents = latents_from_numpy(self.latents, "cpu")
        self.jtr = mcpc.PCTrainer(self.jgen, **trainer_kw)
        self.ttr = mt.PCTrainer(self.tgen, **trainer_kw)
        self.jtr.use_pallas = kernel
        self.ttr.use_kernel = "auto" if kernel else False
        self.inputs = (jnp.zeros((B, DIMS[0])), torch.zeros(B, DIMS[0]))

    def run(self, call, key=5, **kw):
        """``call(pkg) -> kwargs`` of train_on_batch for either package."""
        jkey = jax.random.PRNGKey(key)
        seed = int(jax.random.randint(jkey, (), 0, 2**31 - 1))
        self.ttr._chain_seed = lambda generator: seed
        jres = self.jtr.train_on_batch(self.inputs[0], key=jkey, **call(mcpc, jnp), **kw)
        tres = self.ttr.train_on_batch(self.inputs[1], **call(mt, torch), **kw)
        return jres, tres

    def targets(self, pkg_np):
        return jnp.asarray(self.target) if pkg_np is jnp else torch.from_numpy(self.target)

    def assert_state(self, atol=1e-5):
        for a, b in zip(self.tgen.latents, self.jgen.latents):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)
        for pa, pb in zip(self.tgen.params, self.jgen.params):
            for k in pb:
                np.testing.assert_allclose(pa[k].numpy(), np.asarray(pb[k]), rtol=0,
                                           atol=atol)


def _assert_results(tres, jres, rtol=1e-5, atol=1e-5):
    assert set(tres) == set(jres)
    for k, v in jres.items():
        if isinstance(v, tuple):
            for a, b in zip(tres[k], v):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)
        elif k in ("loss", "energy", "overall"):
            assert tres[k].shape == v.shape, k
            np.testing.assert_allclose(tres[k].numpy(), np.asarray(v), rtol=rtol,
                                       atol=rtol, err_msg=k)
        else:
            assert tuple(tres[k].shape) == v.shape, k
            np.testing.assert_allclose(tres[k].numpy(), np.asarray(v), rtol=0,
                                       atol=atol, err_msg=k)


def _assert_adam_state(t_state, j_state):
    """The port's Adam state over the latents against optax's."""
    jst = [s for s in jax.tree_util.tree_leaves(
        j_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    found = []

    def walk(s):
        if isinstance(s, toptim.ScaleByAdamState):
            found.append(s)
        elif isinstance(s, tuple):
            for x in s:
                walk(x)

    walk(t_state)
    assert len(found) == len(jst) == 1
    assert found[0].count == int(jst[0].count)
    for name in ("mu", "nu"):
        for a, b in zip(getattr(found[0], name)["latents"], getattr(jst[0], name)["latents"]):
            ref = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), ref, rtol=0,
                                       atol=1e-6 * max(float(np.abs(ref).max()), 1e-30))


MCPC = dict(T=8, update_x_at="all", optimizer_x_fn="sgd",
            optimizer_x_kwargs={"lr": 0.02}, update_p_at="last",
            accumulate_p_at=[3, 4, 5, 6, 7], optimizer_p_fn="adam",
            optimizer_p_kwargs={"lr": 0.01})


@pytest.mark.parametrize("every_t", [False, True])
@pytest.mark.parametrize("kernel", [True, False])
def test_trainer_fast_path_matches_engine(kernel, every_t):
    """The MCPC configuration (sgd Langevin chain, accumulated Hebbian
    gradients, one Adam update): latents, parameters and the results dict.
    On the kernel path with noise and, with ``every_t``, the per-step scalar
    slots; on the engine path noise off."""
    pair = Pair(MCPC, kernel=kernel)
    jres, tres = pair.run(lambda pkg, np_: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": pair.targets(np_)},
        callback_after_t=pkg.LangevinStep(var=2.0 if kernel else None),
        is_sample_x_at_batch_start=False, is_return_results_every_t=every_t))
    assert (pair.ttr.kernel_calls, pair.ttr.engine_calls) == ((1, 0) if kernel else (0, 1))
    pair.assert_state()
    _assert_results(tres, jres)
    assert tres["loss"].shape == ((8,) if every_t else (1,))


@pytest.mark.parametrize("kernel", [True, False])
def test_trainer_capture_fast_path(kernel):
    """xs, representations and outputs captured every third step (from the
    kernel's trajectory on the kernel path), with their per-step scalars."""
    pair = Pair(dict(T=12, optimizer_x_fn="sgd", optimizer_x_kwargs={"lr": 0.02},
                     update_p_at="never", optimizer_p_fn=None), kernel=kernel)
    jres, tres = pair.run(lambda pkg, np_: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": pair.targets(np_)},
        callback_after_t=pkg.LangevinStep(var=2.0 if kernel else None),
        is_sample_x_at_batch_start=False, is_return_xs=True,
        is_return_representations=True, is_return_outputs=True, capture_stride=3))
    assert tres["representations"].shape == (4, B, DIMS[0])
    assert tres["outputs"].shape == (4, B, DIMS[3])
    pair.assert_state()
    _assert_results(tres, jres)


ADAM = dict(optimizer_x_fn="adam", optimizer_x_kwargs={"lr": 0.05},
            update_p_at="never", optimizer_p_fn=None)


@pytest.mark.parametrize("kernel", [True, False])
def test_trainer_warm_mode_pc_inference_matches_engine(kernel):
    """Adam on the latents (the PC MAP configuration): latents, scalars, and
    the Adam state the trainer keeps."""
    pair = Pair(dict(ADAM, T=30), kernel=kernel)
    jres, tres = pair.run(lambda pkg, np_: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": pair.targets(np_)},
        is_sample_x_at_batch_start=False, is_return_results_every_t=False))
    pair.assert_state()
    _assert_results(tres, jres)
    _assert_adam_state(pair.ttr._opt_x_state, pair.jtr._opt_x_state)


@pytest.mark.parametrize("kernel", [True, False])
def test_trainer_warm_mode_pc_training_matches_engine(kernel):
    """A full PC training step (Adam on x every step, update_p='last'):
    latents and the applied weight update."""
    pair = Pair(dict(ADAM, T=20, update_p_at="last", optimizer_p_fn="adam",
                     optimizer_p_kwargs={"lr": 0.01}), kernel=kernel)
    jres, tres = pair.run(lambda pkg, np_: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": pair.targets(np_)},
        is_sample_x_at_batch_start=False, is_return_results_every_t=False))
    pair.assert_state()
    _assert_results(tres, jres)


@pytest.mark.parametrize("update_p", ["never", "last"])
def test_trainer_warm_continuation_keeps_adam_state(update_p, monkeypatch):
    """A second call without resampling resumes the Adam moments and count
    in the chain (a continuation dispatch), as the JAX kernel path does."""
    kw = dict(ADAM, T=12)
    if update_p == "last":
        kw.update(update_p_at="last", optimizer_p_fn="adam",
                  optimizer_p_kwargs={"lr": 0.01})
    pair = Pair(kw)
    dispatches = []
    orig = pair.ttr._run_kernel
    monkeypatch.setattr(pair.ttr, "_run_kernel",
                        lambda d, *a, **k: (dispatches.append(d), orig(d, *a, **k))[1])
    call = lambda pkg, np_: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": pair.targets(np_)},
        is_sample_x_at_batch_start=False, is_return_results_every_t=False)
    pair.run(call, key=7)
    jres, tres = pair.run(call, key=8)
    assert [d["warm_cont"] for d in dispatches] == [False, True]
    pair.assert_state()
    _assert_results(tres, jres)
    _assert_adam_state(pair.ttr._opt_x_state, pair.jtr._opt_x_state)


def test_warm_continuation_three_calls_matches_one_long_chain():
    """Three continuation calls of T=10 on the chain equal one engine run of
    T=30 in the JAX package."""
    pair = Pair(dict(ADAM, T=10, optimizer_x_kwargs={"lr": 0.03}))
    call = lambda pkg, np_: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": pair.targets(np_)},
        is_sample_x_at_batch_start=False, is_return_results_every_t=False)
    for _ in range(3):
        pair.ttr.train_on_batch(pair.inputs[1], **call(mt, torch))
    assert pair.ttr.kernel_calls == 3
    jgen = mcpc.GenerativeModel(mcpc.make_mlp_model(*DIMS), key=0, params=pair.params)
    jgen.latents = tuple(jnp.asarray(x) for x in pair.latents)
    jtr = mcpc.PCTrainer(jgen, **dict(ADAM, T=30, optimizer_x_kwargs={"lr": 0.03}))
    jtr.use_pallas = False
    jtr.train_on_batch(pair.inputs[0], key=jax.random.PRNGKey(9), **call(mcpc, jnp))
    for a, b in zip(pair.tgen.latents, jgen.latents):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=5e-5)
    _assert_adam_state(pair.ttr._opt_x_state, jtr._opt_x_state)


@pytest.mark.parametrize("warm", [False, True])
def test_trainer_masked_dispatch_matches_engine(warm):
    """Masked sensory losses ride the chain, in the Langevin chain (the
    figure-2 masked posteriors, noise on) and in the Adam MAP descent."""
    kw = dict(ADAM, T=12) if warm else dict(
        T=12, optimizer_x_fn="sgd", optimizer_x_kwargs={"lr": 0.02},
        update_p_at="never", optimizer_p_fn=None)
    pair = Pair(kw)
    jres, tres = pair.run(lambda pkg, np_: dict(
        loss_fn=pkg.bernoulli_fn_mask,
        loss_fn_kwargs={"_target": pair.targets(np_), "perc": 0.5},
        callback_after_t=None if warm else pkg.LangevinStep(var=2.0),
        is_sample_x_at_batch_start=False, is_return_representations=True))
    assert pair.ttr.kernel_calls == 1
    pair.assert_state()
    _assert_results(tres, jres)


def test_eligibility_matrix():
    """The dispatch decision and the fallback reason, config class by config
    class, as the JAX trainer takes them (``use_pallas=True``); the bf16
    opt-in rides the chain like f32."""
    params, latents, target = _arrays()

    def decide(trainer_kw, batch_kw, tmodel=None, jmodel=None, bf16=False):
        pair = Pair(trainer_kw, tmodel=tmodel, jmodel=jmodel)
        took = []
        orig = pair.jtr._run_pallas
        pair.jtr._run_pallas = lambda *a, **k: (took.append(1), orig(*a, **k))[1]
        call = lambda pkg, np_: dict(
            is_return_results_every_t=False, is_sample_x_at_batch_start=False,
            **batch_kw(pkg, np_, pair.targets(np_)))
        jres = pair.jtr.train_on_batch(pair.inputs[0], key=jax.random.PRNGKey(1),
                                       **call(mcpc, jnp))
        pair.ttr.use_kernel_bf16 = bf16
        pair.ttr.train_on_batch(pair.inputs[1], **call(mt, torch))
        assert bool(took) == (pair.ttr.kernel_calls == 1), (trainer_kw, took)
        assert pair.ttr._kernel_fallback_reason == pair.jtr._kernel_fallback_reason
        return bool(took)

    sgd = dict(T=4, optimizer_x_fn="sgd", optimizer_x_kwargs={"lr": 0.02},
               update_p_at="never", optimizer_p_fn=None)
    adam = dict(sgd, optimizer_x_fn="adam", optimizer_x_kwargs={"lr": 0.05})
    bern = lambda pkg, np_, y: dict(loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": y})

    # hot paths ride the chain
    assert decide(sgd, bern)
    assert decide(adam, bern)
    assert decide(sgd, lambda pkg, np_, y: dict(
        loss_fn=pkg.fe_fn_mask, loss_fn_kwargs={"_target": y, "_var": 0.5, "perc": 0.5}))
    assert decide(dict(sgd, update_p_at="last", optimizer_p_fn="adam",
                       accumulate_p_at=[2, 3]), bern)
    assert decide(sgd, lambda pkg, np_, y: dict(loss_fn=pkg.zero_fn))
    # what the engine runs, for the JAX package's reasons
    assert not decide({**sgd, "x_lr_discount": 0.9}, bern)
    assert not decide({**sgd, "energy_coefficient": 0.5}, bern)
    assert not decide({**sgd, "loss_x_fn": lambda x: 0.01 * x * x}, bern)
    assert not decide({**sgd, "early_stop_fn": lambda **kw: kw["overall"] < 0.0}, bern)
    assert not decide({**sgd, "optimizer_x_kwargs": {"lr": 0.02, "momentum": 0.9}}, bern)
    assert not decide({**adam, "optimizer_x_kwargs": {"lr": 0.05, "weight_decay": 0.1}},
                      bern)
    assert not decide(adam, lambda pkg, np_, y: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": y, "_reduction": "mean"}))
    assert not decide(sgd, lambda pkg, np_, y: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": y},
        is_return_batchelement_loss=True))
    assert not decide(sgd, lambda pkg, np_, y: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": y}, is_optimize_inputs=True))
    assert not decide(adam, lambda pkg, np_, y: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": y},
        callback_after_t=pkg.LangevinStep(var=2.0)))
    assert not decide({**sgd, "update_x_at": [0, 1]}, bern)
    assert not decide(dict(sgd, update_p_at=[1, 3], optimizer_p_fn="adam"), bern)
    assert not decide(dict(sgd, update_p_at="last", optimizer_p_fn="adam",
                           accumulate_p_at=[1, 3]), bern)
    assert not decide(dict(adam, update_p_at="last", optimizer_p_fn="adam",
                           accumulate_p_at=[2, 3]), bern)
    assert not decide(sgd, lambda pkg, np_, y: dict(
        loss_fn=lambda out, _target: ((out - _target) ** 2).sum(),
        loss_fn_kwargs={"_target": y}))
    # masked energies are outside the kernel family
    masked = lambda pkg: pkg.PCModel([m if not isinstance(m, pkg.PC) else pkg.PC(
        M=(1.0,) * 8) if i == 4 else m for i, m in enumerate(pkg.make_mlp_model(*DIMS).modules)])
    assert not decide(sgd, bern, tmodel=masked(mt), jmodel=masked(mcpc))
    # tanh and the output-PC site ride the chain, as in the JAX package
    tanh = lambda pkg: pkg.make_mlp_model(*DIMS, activation="tanh")
    assert decide(sgd, bern, tmodel=tanh(mt), jmodel=tanh(mcpc)) is True
    out_pc = lambda pkg: pkg.make_mlp_model(
        *DIMS, output_pc=pkg.PC(energy_fn=pkg.scaled_gaussian_energy(0.5)))
    assert decide(sgd, lambda pkg, np_, y: dict(loss_fn=pkg.zero_fn),
                  tmodel=out_pc(mt), jmodel=out_pc(mcpc)) is True
    # a sensory loss on an output-PC joint sampler goes to the engine
    assert not decide(sgd, bern, tmodel=out_pc(mt), jmodel=out_pc(mcpc))
    # bf16 products take the chain, as use_pallas_bf16 does in the JAX trainer
    assert decide(sgd, bern, bf16=True) is True
    assert decide(adam, bern, bf16=True) is True
    assert not decide({**sgd, "x_lr_discount": 0.9}, bern, bf16=True)


PC_TRAIN = dict(T=6, update_x_at="all", optimizer_x_fn="adam",
                optimizer_x_kwargs={"lr": 0.05}, update_p_at="last", optimizer_p_fn="adam",
                optimizer_p_kwargs={"lr": 0.01})


@pytest.mark.parametrize("mode", [True, "auto", False])
@pytest.mark.parametrize("warm", [False, True])
def test_trainer_bf16_opt_in_matches_jax(mode, warm):
    """``use_kernel_bf16`` against the JAX trainer's ``use_pallas_bf16``, set
    alike on both sides: an MCPC batch (Langevin, noise on, gradients over
    the last 5 steps, the Adam step on the parameters) or a PC training
    batch (Adam on the latents, the last step's gradients).  True runs bf16
    products; "auto" and False run f32, as in the JAX trainer, so their
    state sits the bf16 effect away from True's.  Tolerances as the file's."""
    def call(pkg, np_):
        return dict(loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": pair.targets(np_)},
                    callback_after_t=None if warm else pkg.LangevinStep(var=2.0),
                    is_sample_x_at_batch_start=False)

    results = {}
    for m in dict.fromkeys((mode, True)):
        pair = Pair(PC_TRAIN if warm else MCPC)
        pair.jtr.use_pallas_bf16 = m
        pair.ttr.use_kernel_bf16 = m
        jres, tres = pair.run(call)
        assert pair.ttr.kernel_calls == 1 and pair.ttr.engine_calls == 0
        pair.assert_state()
        _assert_results(tres, jres)
        results[m] = pair.tgen
    if mode is not True:
        gap = max(float((a - b).abs().max())
                  for a, b in zip(results[mode].latents, results[True].latents))
        assert gap > 1e-4


def test_top_level_exports_engine_config():
    """``EngineConfig`` is exported at the top of the port, as at the top of
    the JAX package."""
    assert mt.EngineConfig is mt.core.EngineConfig
    assert mcpc.EngineConfig is mcpc.core.EngineConfig


def test_awkward_batch_falls_back_to_engine():
    """A batch > 1024 with no tile divisor >= 128 (prime) goes to the
    engine, with the once-per-reason warning; the chain itself refuses it."""
    chain_mod = __import__("importlib").import_module(
        "montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    model = mt.make_mlp_model(*DIMS)
    gen = mt.GenerativeModel(model, 1, device="cpu")
    Bp = 1031
    lat = gen.sample_latents(torch.zeros(Bp, DIMS[0]))
    target = (torch.rand(Bp, DIMS[3], generator=torch.Generator().manual_seed(0)) > 0.5
              ).float()
    with pytest.raises(ValueError, match="tile"):
        chain_mod.mcpc_chain(gen.params, lat, target, 0, T=2, lr=0.02)
    tr = mt.PCTrainer(gen, T=4, optimizer_x_fn="sgd", optimizer_x_kwargs={"lr": 0.02},
                      update_p_at="never", optimizer_p_fn=None)
    tr.use_kernel = True
    call = dict(loss_fn=mt.bernoulli_fn, loss_fn_kwargs={"_target": target},
                is_return_results_every_t=False)
    with pytest.warns(RuntimeWarning, match="tile divisor"):
        tr.train_on_batch(torch.zeros(Bp, DIMS[0]), **call)
    with warnings.catch_warnings(record=True) as rec:  # once per reason
        warnings.simplefilter("always")
        res = tr.train_on_batch(torch.zeros(Bp, DIMS[0]), **call)
    assert not [w for w in rec if "slows down" in str(w.message)]
    assert (tr.kernel_calls, tr.engine_calls) == (0, 2)
    assert np.isfinite(float(res["loss"][-1]))


# ------------------------------------------------------------ the engine

ENGINE_CASES = {
    "dynamic_lr": (dict(T=10, optimizer_x_fn="sgd", optimizer_x_kwargs={"lr": 0.05},
                        x_lr_discount=0.5, x_lr_amplifier=1.1, update_p_at="never",
                        optimizer_p_fn=None), {}),
    "early_stop": (dict(T=12, optimizer_x_fn="sgd", optimizer_x_kwargs={"lr": 0.02},
                        early_stop_fn=lambda t, **kw: t >= 5, update_p_at="last",
                        optimizer_p_fn="adam"), {}),
    "momentum": (dict(T=8, optimizer_x_fn="sgd",
                      optimizer_x_kwargs={"lr": 0.02, "momentum": 0.9},
                      update_p_at="last", accumulate_p_at="last_half",
                      optimizer_p_fn="sgd", optimizer_p_kwargs={"lr": 0.1}), {}),
    "adam_weight_decay": (dict(T=8, optimizer_x_fn="adam",
                               optimizer_x_kwargs={"lr": 0.05, "weight_decay": 0.01},
                               update_p_at="all", optimizer_p_fn="adamw",
                               optimizer_p_kwargs={"lr": 0.01, "weight_decay": 0.1}), {}),
    "energy_coefficient_loss_x": (dict(T=8, optimizer_x_fn="sgd",
                                       optimizer_x_kwargs={"lr": 0.02},
                                       energy_coefficient=0.5,
                                       loss_x_fn=lambda x: 0.01 * x * x,
                                       update_p_at=[3, 7], optimizer_p_fn="adam"), {}),
    "optimize_inputs": (dict(T=6, optimizer_x_fn="sgd", optimizer_x_kwargs={"lr": 0.02},
                             loss_inputs_fn=lambda u: 0.5 * (u * u).sum(),
                             update_p_at="never", optimizer_p_fn=None),
                        dict(is_optimize_inputs=True)),
    "captures_stride": (dict(T=9, optimizer_x_fn="sgd", optimizer_x_kwargs={"lr": 0.02},
                             update_x_at=[0, 2, 4, 6, 8], update_p_at="never",
                             optimizer_p_fn=None),
                        dict(is_return_xs=True, is_return_outputs=True,
                             is_return_representations=True,
                             is_return_batchelement_loss=True, capture_stride=2)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_matches_jax_engine(case):
    """Configurations only the engine runs, noise off: latents, parameters
    and every result."""
    trainer_kw, batch_kw = ENGINE_CASES[case]
    pair = Pair(trainer_kw, kernel=False)
    jres, tres = pair.run(lambda pkg, np_: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": pair.targets(np_)},
        is_sample_x_at_batch_start=False, **batch_kw))
    assert pair.ttr.engine_calls == 1
    pair.assert_state(atol=2e-5)
    _assert_results(tres, jres, rtol=2e-5, atol=2e-5)


def test_readme_quick_start_matches_jax_engine():
    """The README's 1-D linear-Gaussian example (PC warm start, then the
    sampler continuing from the MAP), shortened and with the noise off,
    against the JAX engine; then with the noise on, the port's samples
    against the closed-form posterior."""
    jm = mcpc.PCModel([mcpc.Linear(1, 1), mcpc.PC(), mcpc.Linear(1, 1)])
    tm = mt.PCModel([mt.Linear(1, 1), mt.PC(), mt.Linear(1, 1)])
    params = jax.device_get(jm.init(jax.random.PRNGKey(0)))
    chains = 64
    outs = []
    for pkg, np_, model in ((mcpc, jnp, jm), (mt, torch, tm)):
        if pkg is mcpc:
            gen = pkg.GenerativeModel(model, key=0, params=params)
        else:
            gen = pkg.GenerativeModel(model, 0, params=params_from_numpy(params, "cpu"),
                                      device="cpu")
        pseudo = np_.zeros((chains, 1))
        target = np_.full((chains, 1), 2.0)
        gen.latents = (np_.asarray(np.linspace(-3, 3, chains, dtype=np.float32)[:, None])
                       if pkg is mcpc else (torch.linspace(-3, 3, chains)[:, None],))
        if pkg is mcpc:
            gen.latents = (gen.latents,)
        pc = pkg.PCTrainer(gen, T=100, optimizer_x_fn="adam",
                           optimizer_x_kwargs={"lr": 0.05},
                           update_p_at="never", optimizer_p_fn=None)
        pc.train_on_batch(pseudo, loss_fn=pkg.fe_fn, is_sample_x_at_batch_start=False,
                          loss_fn_kwargs={"_target": target, "_var": 1.0})
        sampler = pkg.PCTrainer(gen, T=50, optimizer_x_fn="sgd",
                                optimizer_x_kwargs={"lr": 0.01},
                                update_p_at="never", optimizer_p_fn=None)
        res = sampler.train_on_batch(
            pseudo, loss_fn=pkg.fe_fn, loss_fn_kwargs={"_target": target, "_var": 1.0},
            callback_after_t=pkg.LangevinStep(var=None), is_sample_x_at_batch_start=False,
            is_return_representations=True)
        outs.append((np.asarray(gen.latents[0]), np.asarray(res["representations"])))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=0, atol=1e-5)

    # noise on: the samples' moments against the closed form
    gen = mt.GenerativeModel(tm, 3, params=params_from_numpy(params, "cpu"), device="cpu")
    pseudo, target = torch.zeros((512, 1)), torch.full((512, 1), 2.0)
    sampler = mt.PCTrainer(gen, T=1500, optimizer_x_fn="sgd",
                           optimizer_x_kwargs={"lr": 0.05},
                           update_p_at="never", optimizer_p_fn=None)
    res = sampler.train_on_batch(pseudo, loss_fn=mt.fe_fn,
                                 loss_fn_kwargs={"_target": target, "_var": 1.0},
                                 callback_after_t=mt.LangevinStep(var=2.0),
                                 is_return_representations=True)
    assert sampler.engine_calls == 1
    samples = res["representations"][500:].numpy().ravel()
    mu0 = float(params[0]["b"][0])
    w, b = float(params[1]["w"][0, 0]), float(params[1]["b"][0])
    var = 1.0 / (1.0 + w * w)
    mean = var * (mu0 + w * (2.0 - b))
    assert abs(samples.mean() - mean) < 0.05
    # unadjusted Langevin at lr 0.05 inflates the variance by about lr/4
    assert abs(samples.var() - var) < 0.05 + 0.1 * var


# ------------------------------------------------- schedules, optimizers

SCHEDULES = [
    (8, "all", "last", [3, 4, 5, 6, 7], False),
    (6, "all", "last", "never", False),
    (6, "all", "all", "never", False),
    (6, [0, 2, 4], "all", "never", False),
    (10, "all", [2, 5, 9], "never", False),
    (10, "last_half", [4, 9], [2, 3, 4], False),
    (7, "all", "last", "last_half", True),
    (5, "never", "never", "never", False),
    (9, "all", [8], [1, 5, 8], True),
]


@pytest.mark.parametrize("T,ux,up,acc,force", SCHEDULES)
def test_build_plan_matches_jax(T, ux, up, acc, force):
    for spec in (ux, up, acc):
        assert tschedule.parse_schedule(spec, T) == jschedule.parse_schedule(spec, T)
    got = tschedule.build_plan(T, ux, up, acc, force_p_grads=force)
    want = jschedule.build_plan(T, ux, up, acc, force_p_grads=force)
    for f in ("T", "update_x_at", "update_p_at", "accumulate_p_at", "p_zero_steps",
              "p_grad_needed", "p_divisor_steps"):
        assert getattr(got, f) == getattr(want, f), f
    assert [vars(s) for s in got.segments] == [vars(s) for s in want.segments]


def test_schedule_parsing_and_errors():
    assert tschedule.parse_schedule("all", 4) == (0, 1, 2, 3)
    assert tschedule.parse_schedule("last", 4) == (3,)
    assert tschedule.parse_schedule("last_half", 4) == (2, 3)
    assert tschedule.parse_schedule("never", 4) == ()
    assert tschedule.parse_schedule([3, 1, 3], 4) == (1, 3)
    with pytest.raises(ValueError, match="unknown schedule"):
        tschedule.parse_schedule("first", 4)
    with pytest.raises(ValueError, match="out of range"):
        tschedule.parse_schedule([4], 4)


@pytest.mark.parametrize("name,kwargs", [
    ("sgd", {"lr": 0.1}),
    ("sgd", {"lr": 0.1, "momentum": 0.9}),
    ("sgd", {"lr": 0.1, "weight_decay": 0.05}),
    ("adam", {"lr": 0.01}),
    ("adam", {"lr": 0.01, "betas": (0.5, 0.9), "eps": 1e-6, "weight_decay": 0.1}),
    ("adamw", {"lr": 0.01, "weight_decay": 0.1}),
])
def test_optimizer_spec_matches_optax(name, kwargs):
    """Five steps of each transform on a tree of parameters, atol 1e-6."""
    tspec = toptim.OptimizerSpec.from_torch_style(name, kwargs)
    jspec = JSpec.from_torch_style(name, kwargs)
    assert tspec == toptim.OptimizerSpec(**vars(jspec))
    rng = np.random.default_rng(3)
    tree = ({"w": rng.normal(size=(3, 4)).astype(np.float32),
             "b": rng.normal(size=(4,)).astype(np.float32)},)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    ttree = toptim.tree_map(torch.from_numpy, tree)
    jtx, ttx = jspec.make(), tspec.make()
    jst, tst = jtx.init(jtree), ttx.init(ttree)
    for _ in range(5):
        g = ({"w": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32)},)
        ju, jst = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), jst, jtree)
        jtree = optax.apply_updates(jtree, ju)
        tu, tst = ttx.update(toptim.tree_map(torch.from_numpy, g), tst, ttree)
        ttree = toptim.apply_updates(ttree, tu)
    for k in ("w", "b"):
        np.testing.assert_allclose(ttree[0][k].numpy(), np.asarray(jtree[0][k]),
                                   rtol=0, atol=1e-6)


def test_tree_helpers_round_trip():
    tree = {"latents": (torch.ones(2), torch.zeros(3)), "inputs": torch.full((1,), 2.0)}
    leaves = toptim.tree_leaves(tree)
    assert [t.shape[0] for t in leaves] == [2, 3, 1]
    back = toptim.tree_unflatten(tree, [t + 1 for t in leaves])
    assert torch.equal(back["latents"][1], torch.ones(3))
    assert isinstance(back["latents"], tuple)
    assert toptim.tree_map(lambda t: t, None) is None


def test_static_loss_kwargs_bind_once():
    """'perc' is bound into the loss function once, so the engine's cache
    keeps hitting across calls."""
    from montecarlopredictivecoding_tpu_torch.core import trainer as ttrainer

    a = ttrainer._static_loss_partial(mt.bernoulli_fn_mask, (("perc", 0.5),))
    b = ttrainer._static_loss_partial(mt.bernoulli_fn_mask, (("perc", 0.5),))
    assert a is b and isinstance(a, functools.partial)
