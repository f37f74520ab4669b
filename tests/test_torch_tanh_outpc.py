"""tanh and the output-PC site of the port's ``mcpc_chain`` on CPU tensors,
which is the plain version, against ``mcpc_chain_pallas(..., interpret=True)``
on the same numpy inputs; and ``PCTrainer`` on tanh and output-PC models
against the JAX ``PCTrainer(use_pallas=True)`` on equal latents and seeds.

Tolerances as in tests/test_torch_mcpc_chain.py and
tests/test_torch_chain_options.py: latents, ``x3`` and captured latents atol
1e-5, scalars rtol 1e-5 (atol 1e-5), Adam moments atol 1e-6 of their
tensor's largest entry, gradients 2e-6 of theirs.  The noise is on unless a
case says otherwise.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.ops import mcpc_chain_pallas
from montecarlopredictivecoding_tpu.ops import pallas_mcpc as jops
from montecarlopredictivecoding_tpu_torch.core import optim
from montecarlopredictivecoding_tpu_torch.utils import (
    latents_from_numpy,
    params_from_numpy,
)

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

torch.set_num_threads(1)

DIMS = (4, 8, 8, 16)
ODD = (5, 7, 9, 13)   # widths that do not divide by 8
OUT_VAR = 0.5


def _inputs(dims=DIMS, B=8, seed=0, output_pc=False):
    jm = mcpc.make_mlp_model(*dims)
    params_np = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    latents = tuple(rng.uniform(-3, 3, (B, d)).astype(np.float32) for d in dims[:3])
    if output_pc:
        latents += (rng.normal(size=(B, dims[3])).astype(np.float32),)
    target = (rng.random((B, dims[3])) > 0.5).astype(np.float32)
    return params_np, latents, target


def _moments(dims, B, sites, seed=9):
    rng = np.random.default_rng(seed)
    widths = list(dims[:3]) + ([dims[3]] if sites == 4 else [])
    mu = tuple((0.1 * rng.normal(size=(B, d))).astype(np.float32) for d in widths)
    nu = tuple((0.01 * rng.random((B, d))).astype(np.float32) for d in widths)
    return mu, nu


def _run_both(params_np, latents, target, seed, **kw):
    jkw, tkw = dict(kw), dict(kw)
    for name in ("warm_mu", "warm_nu"):
        if name in kw:
            jkw[name] = tuple(jnp.asarray(m) for m in kw[name])
            tkw[name] = tuple(torch.from_numpy(m) for m in kw[name])
    j_target = None if target is None else jnp.asarray(target)
    jout = mcpc_chain_pallas(
        params_np, tuple(jnp.asarray(x) for x in latents), j_target,
        jnp.int32(seed), interpret=True, **jkw,
    )
    tout = chain_mod.mcpc_chain(
        params_from_numpy(params_np, "cpu"), latents_from_numpy(latents, "cpu"),
        None if target is None else torch.from_numpy(target), seed, **tkw,
    )
    return jout, tout


def _close(t, j, what, atol=1e-5):
    ref = np.asarray(j)
    assert tuple(t.shape) == ref.shape and t.dtype == torch.float32, what
    np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=atol, err_msg=what)


def _assert_result(tout, jout, kw):
    """Every part of the JAX wrapper's result, in its order."""
    assert len(tout) == len(jout)
    out_pc = kw.get("output_var") is not None
    assert len(tout[0]) == len(jout[0]) == (4 if out_pc else 3)
    for i, (a, b) in enumerate(zip(tout[0], jout[0])):
        _close(a, b, f"latent {i}")
    if kw.get("with_pgrads"):
        for tg, jg in zip(tout[1], jout[1]):
            for k in ("w", "b"):
                ref = np.asarray(jg[k])
                scale = max(float(np.abs(ref).max()), 1e-30)
                np.testing.assert_allclose(tg[k].numpy(), ref, rtol=0,
                                           atol=2e-6 * scale, err_msg=f"pgrads {k}")
    else:
        assert tout[1] is None and jout[1] is None
    k = 2
    if kw.get("capture_stride"):
        _close(tout[k], jout[k], "traj")
        k += 1
        if out_pc:
            _close(tout[k], jout[k], "traj3")
            # pad lanes of the output-PC captures stay zero
            assert not tout[k][:, :, kw["D"]:].any()
            k += 1
    if kw.get("return_scalars"):
        for name in ("loss", "energy"):
            ref = np.asarray(jout[k][name])
            assert tuple(tout[k][name].shape) == ref.shape, name
            np.testing.assert_allclose(tout[k][name].numpy(), ref, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        k += 1
    if kw.get("emit_warm_opt_state"):
        assert len(tout[k]) == len(jout[k]) == (4 if out_pc else 2)
        for a, b in zip(tout[k], jout[k]):
            ref = np.asarray(b)
            assert tuple(a.shape) == ref.shape
            scale = max(float(np.abs(ref).max()), 1e-30)
            np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=1e-6 * scale)
        k += 1
    assert k == len(tout)


TANH = dict(activation="tanh")
OUT = dict(output_var=OUT_VAR, loss="none")

# name -> (dims, B, options); every case runs the noise unless noise_var=None
CASES = {
    "tanh_warm_langevin_pgrads": (DIMS, 8, dict(TANH, warm_T=6, T=9, lr=0.03,
                                                with_pgrads=True, mixing=3,
                                                return_scalars=True)),
    "tanh_warm_only_warm_pgrads": (ODD, 7, dict(TANH, warm_T=8, T=0, lr=0.1,
                                                with_pgrads=True, warm_pgrads=True,
                                                return_scalars=True)),
    "tanh_masked_captured": (DIMS, 8, dict(TANH, warm_T=3, T=11, lr=0.03,
                                           loss="bernoulli_mask", mask_perc=0.5,
                                           capture_stride=2, return_scalars=True)),
    "tanh_scalar_stride_gaussian": (ODD, 6, dict(TANH, T=13, lr=0.03, loss="gaussian",
                                                 input_var=0.5, scalar_stride=4,
                                                 return_scalars=True)),
    "tanh_emit_and_resume": (DIMS, 8, dict(TANH, warm_T=5, T=3, lr=0.03,
                                           emit_warm_opt_state=True, warm_count=4,
                                           return_scalars=True)),
    "tanh_two_batch_tiles": (DIMS, 16, dict(TANH, warm_T=2, T=7, lr=0.03, batch_tile=8,
                                            with_pgrads=True, mixing=2)),
    "outpc_warm_langevin": (DIMS, 8, dict(OUT, warm_T=6, T=9, lr=0.1,
                                          return_scalars=True)),
    "outpc_pgrads_odd_T": (ODD, 6, dict(OUT, T=11, lr=0.05, with_pgrads=True, mixing=4,
                                        return_scalars=True)),
    "outpc_captured": (DIMS, 8, dict(OUT, warm_T=3, T=10, lr=0.05, capture_stride=3,
                                     return_scalars=True)),
    "outpc_captured_warm_only": (ODD, 5, dict(OUT, warm_T=7, T=0, lr=0.1,
                                              capture_stride=2, return_scalars=True)),
    "outpc_scalar_stride": (DIMS, 8, dict(OUT, T=12, lr=0.05, scalar_stride=5,
                                          return_scalars=True)),
    "outpc_emit_and_resume": (DIMS, 8, dict(OUT, warm_T=5, T=4, lr=0.05,
                                            emit_warm_opt_state=True, warm_count=3,
                                            return_scalars=True)),
    "outpc_emit_then_langevin_pgrads_captures": (
        DIMS, 8, dict(OUT, warm_T=4, T=7, lr=0.05, emit_warm_opt_state=True,
                      with_pgrads=True, mixing=2, capture_stride=3, return_scalars=True)),
    "outpc_two_batch_tiles": (DIMS, 16, dict(OUT, warm_T=2, T=5, lr=0.05, batch_tile=8,
                                             return_scalars=True)),
    "outpc_tanh_no_noise": (ODD, 6, dict(OUT, **TANH, warm_T=3, T=6, lr=0.05,
                                         noise_var=None, with_pgrads=True, mixing=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_chain_matches_interpret_kernel(case):
    """Each case against ``mcpc_chain_pallas(interpret=True)``: latents, the
    output-PC latent, gradients, captures (``traj3`` too), scalars and Adam
    moments, with the tolerances of the module docstring."""
    dims, B, kw = CASES[case]
    out_pc = "output_var" in kw
    params_np, latents, target = _inputs(dims, B, output_pc=out_pc)
    kw = dict(kw)
    if "warm_count" in kw:
        kw["warm_mu"], kw["warm_nu"] = _moments(dims, B, 4 if out_pc else 3)
    jout, tout = _run_both(params_np, latents, None if out_pc else target, 7, **kw)
    _assert_result(tout, jout, dict(kw, D=dims[3]))


def test_output_pc_noise_takes_four_draws_a_pair():
    """With an output-PC site the latents read draws 4p, 4p+1 and x3 reads
    4p+2, 4p+3 at ``local_row * pD + col``: one Langevin step from zero
    gradients (zero weights and biases, latents at 0) moves each element by
    exactly ``noise_std`` times that draw."""
    dims, B = DIMS, 3
    params_np, _, _ = _inputs(dims, B)
    params_np = jax.tree_util.tree_map(np.zeros_like, params_np)
    latents = tuple(np.zeros((B, d), np.float32) for d in dims)
    jout, tout = _run_both(params_np, latents, None, 11, T=1, lr=0.02, noise_var=2.0,
                           **OUT)
    std = np.float32(np.sqrt(0.02 * 2.0))
    _, offs, XW = chain_mod.aligned_layout(dims[:3])
    rows = torch.arange(B)[:, None]
    for i, (o, d) in enumerate(zip(offs, dims[:3])):
        idx = rows * XW + (torch.arange(d) + o)[None, :]
        z, _ = chain_mod.box_muller(chain_mod.counter_bits_at(idx, 11, 0),
                                    chain_mod.counter_bits_at(idx, 11, 1))
        np.testing.assert_allclose(tout[0][i].numpy(), (std * z).numpy(), rtol=0, atol=1e-6)
    idx3 = rows * 128 + torch.arange(dims[3])[None, :]
    z3, _ = chain_mod.box_muller(chain_mod.counter_bits_at(idx3, 11, 2),
                                 chain_mod.counter_bits_at(idx3, 11, 3))
    np.testing.assert_allclose(tout[0][3].numpy(), (std * z3).numpy(), rtol=0, atol=1e-6)
    for a, b in zip(tout[0], jout[0]):
        _close(a, b, "one step")


@pytest.mark.parametrize("kw,match", [
    (dict(output_var=1.0, loss="bernoulli"), "loss='none'"),
    (dict(output_var=1.0, loss="none", packed=False), "packed=True"),
    (dict(activation="tanh", packed=False), "relu only"),
    (dict(activation="mish"), "unsupported activation"),
])
def test_chain_refuses_what_the_jax_wrapper_refuses(kw, match):
    params_np, latents, target = _inputs(DIMS, 4, output_pc=kw.get("output_var") is not None)
    with pytest.raises(ValueError, match=match):
        chain_mod.mcpc_chain(params_from_numpy(params_np, "cpu"),
                             latents_from_numpy(latents, "cpu"),
                             torch.from_numpy(target), 0, T=2, lr=0.1, **kw)
    # output_var needs the fourth latent
    with pytest.raises(ValueError, match="4 latents"):
        chain_mod.mcpc_chain(params_from_numpy(params_np, "cpu"),
                             latents_from_numpy(latents[:3], "cpu"), None, 0, T=2,
                             lr=0.1, output_var=1.0, loss="none")


def test_model_helpers_take_tanh_and_output_pc():
    """``model_activation``/``supports_model`` take tanh; ``output_pc_var``
    reads the trailing site's variance as the JAX helper does."""
    out = mt.PC(energy_fn=mt.scaled_gaussian_energy(0.25))
    tanh_m = mt.make_mlp_model(*DIMS, activation="tanh")
    out_m = mt.make_mlp_model(*DIMS, output_pc=out)
    assert chain_mod.model_activation(tanh_m) == "tanh"
    assert chain_mod.supports_model(tanh_m) and chain_mod.supports_model(tanh_m, "tanh")
    assert not chain_mod.supports_model(tanh_m, "relu")
    assert chain_mod.output_pc_var(out_m) == 0.25
    assert chain_mod.output_pc_var(tanh_m) is None
    # the plain Gaussian energy is the variance-1 case, as in the JAX helper
    plain = mt.make_mlp_model(*DIMS, output_pc=mt.PC())
    assert chain_mod.output_pc_var(plain) == jops.output_pc_var(
        mcpc.make_mlp_model(*DIMS, output_pc=mcpc.PC())) == 1.0
    masked = mt.make_mlp_model(*DIMS, output_pc=mt.PC(
        energy_fn=mt.scaled_gaussian_energy(0.25), S=np.ones((16, 16), np.float32)))
    assert chain_mod.output_pc_var(masked) is None
    j_out = mcpc.make_mlp_model(*DIMS, output_pc=mcpc.PC(
        energy_fn=mcpc.scaled_gaussian_energy(0.25)))
    assert jops.output_pc_var(j_out) == chain_mod.output_pc_var(out_m)


# ------------------------------------------------------------ the trainer


def _models(pkg, dims, activation="relu", output_var=None):
    out = None
    if output_var is not None:
        out = pkg.PC(energy_fn=pkg.scaled_gaussian_energy(output_var))
    return pkg.make_mlp_model(*dims, activation=activation, output_pc=out)


class Pair:
    """A JAX ``PCTrainer(use_pallas=True)`` and the port's, over the same
    parameters and latents (the pairing of tests/test_torch_trainer.py)."""

    def __init__(self, trainer_kw, dims=DIMS, B=8, activation="relu", output_var=None,
                 seed=0):
        jm = _models(mcpc, dims, activation, output_var)
        tm = _models(mt, dims, activation, output_var)
        self.params = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
        rng = np.random.default_rng(seed + 100)
        widths = list(dims[:3]) + ([dims[3]] if output_var is not None else [])
        self.latents = tuple(rng.uniform(-2, 2, (B, d)).astype(np.float32) for d in widths)
        self.target = (rng.random((B, dims[3])) > 0.5).astype(np.float32)
        self.jgen = mcpc.GenerativeModel(jm, key=0, params=self.params)
        self.jgen.latents = tuple(jnp.asarray(x) for x in self.latents)
        self.tgen = mt.GenerativeModel(tm, 0, params=params_from_numpy(self.params, "cpu"),
                                       device="cpu")
        self.tgen.latents = latents_from_numpy(self.latents, "cpu")
        self.jtr = mcpc.PCTrainer(self.jgen, **trainer_kw)
        self.ttr = mt.PCTrainer(self.tgen, **trainer_kw)
        self.jtr.use_pallas = True
        self.inputs = (jnp.zeros((B, dims[0])), torch.zeros(B, dims[0]))

    def run(self, call, key=5):
        """``call(pkg, target) -> kwargs`` of train_on_batch for either side;
        the port's chain seed is the one the JAX trainer draws from ``key``."""
        jkey = jax.random.PRNGKey(key)
        seed = int(jax.random.randint(jkey, (), 0, 2**31 - 1))
        self.ttr._chain_seed = lambda generator: seed
        jres = self.jtr.train_on_batch(self.inputs[0], key=jkey,
                                       **call(mcpc, jnp.asarray(self.target)))
        tres = self.ttr.train_on_batch(self.inputs[1],
                                       **call(mt, torch.from_numpy(self.target)))
        assert self.ttr.kernel_calls >= 1 and self.ttr.engine_calls == 0
        return jres, tres

    def assert_state(self, atol=1e-5):
        assert len(self.tgen.latents) == len(self.jgen.latents)
        for a, b in zip(self.tgen.latents, self.jgen.latents):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol)
        for pa, pb in zip(self.tgen.params, self.jgen.params):
            for k in pb:
                np.testing.assert_allclose(pa[k].numpy(), np.asarray(pb[k]), rtol=0,
                                           atol=atol)


def _assert_results(tres, jres):
    """Results dicts: captures atol 1e-5, scalars rtol 1e-5."""
    assert set(tres) == set(jres)
    for k, v in jres.items():
        if isinstance(v, tuple):
            assert len(tres[k]) == len(v), k
            for a, b in zip(tres[k], v):
                _close(a, b, k)
        elif k in ("loss", "energy", "overall"):
            np.testing.assert_allclose(tres[k].numpy(), np.asarray(v), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
        elif k != "stop_t":
            _close(tres[k], v, k)


def _torch_adam_moments(tr):
    """``(mu, nu, count)`` of the port trainer's Adam state over the latents."""
    mu, nu, count = optim.adam_moments(tr._opt_x_state, {"latents": tr.gen.latents})
    return mu["latents"], nu["latents"], count


def _assert_adam_moments(tr, jtr):
    """The grafted Adam moments over the latents, atol 1e-6 of the largest."""
    tm = _torch_adam_moments(tr)
    jm = jtr._adam_moments(jtr._opt_x_state)
    assert int(tm[2]) == int(jm[2])
    for a_s, b_s in zip(tm[:2], jm[:2]):
        assert len(a_s) == len(b_s)
        for a, b in zip(a_s, b_s):
            ref = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), ref, rtol=0,
                                       atol=1e-6 * max(float(np.abs(ref).max()), 1e-30))


SGD = dict(T=9, update_x_at="all", optimizer_x_fn="sgd", optimizer_x_kwargs={"lr": 0.03},
           update_p_at="last", accumulate_p_at=[5, 6, 7, 8], optimizer_p_fn="adam",
           optimizer_p_kwargs={"lr": 0.01})
ADAM = dict(T=7, update_x_at="all", optimizer_x_fn="adam", optimizer_x_kwargs={"lr": 0.05},
            update_p_at="never", optimizer_p_fn=None)


def test_trainer_tanh_langevin_outputs_and_xs():
    """A tanh MCPC chain with gradients, captures of ``xs`` and ``outputs``
    (outputs_t = tanh(x2_t) W3 + b3: the repair of the relu that stood
    there) and per-step scalars, against the JAX trainer."""
    pair = Pair(SGD, activation="tanh")
    jres, tres = pair.run(lambda pkg, y: dict(
        loss_fn=pkg.bernoulli_fn, loss_fn_kwargs={"_target": y},
        callback_after_t=pkg.LangevinStep(var=2.0), is_sample_x_at_batch_start=False,
        is_return_outputs=True, is_return_xs=True, capture_stride=2))
    assert tres["outputs"].shape == (5, 8, 16)
    pair.assert_state()
    _assert_results(tres, jres)


def test_trainer_tanh_adam_with_continuation():
    """Adam MAP steps on a tanh model (the PC phase), then a continuation
    that resumes the grafted Adam state: latents, scalars and moments."""
    pair = Pair(ADAM, activation="tanh", dims=ODD)
    call = lambda pkg, y: dict(loss_fn=pkg.bernoulli_fn_mask,
                               loss_fn_kwargs={"_target": y, "perc": 0.5},
                               is_sample_x_at_batch_start=False)
    for key in (5, 6):
        jres, tres = pair.run(call, key=key)
        pair.assert_state()
        _assert_results(tres, jres)
        _assert_adam_moments(pair.ttr, pair.jtr)


def test_trainer_output_pc_warm_start_then_joint_sampler():
    """The joint sampler's recipe on an output-PC model: an Adam warm start
    with ``loss_fn=None`` (its moments grafted, x3's included), then an
    unclamped Langevin chain capturing ``xs`` (x3 fourth) and ``outputs``
    (x3 itself)."""
    pair = Pair(ADAM, output_var=OUT_VAR)
    jres, tres = pair.run(lambda pkg, y: dict(loss_fn=None,
                                              is_sample_x_at_batch_start=False))
    pair.assert_state()
    _assert_results(tres, jres)
    _assert_adam_moments(pair.ttr, pair.jtr)
    assert len(_torch_adam_moments(pair.ttr)[0]) == 4

    sampler = Pair(dict(SGD, update_p_at="never", optimizer_p_fn=None, accumulate_p_at="never"),
                   output_var=OUT_VAR)
    sampler.jgen.latents = pair.jgen.latents
    sampler.tgen.latents = pair.tgen.latents
    jres, tres = sampler.run(lambda pkg, y: dict(
        loss_fn=None, callback_after_t=pkg.LangevinStep(var=2.0),
        is_sample_x_at_batch_start=False, is_return_xs=True, is_return_outputs=True))
    assert len(tres["xs"]) == 4 and tres["outputs"].shape == (9, 8, 16)
    sampler.assert_state()
    _assert_results(tres, jres)


def test_trainer_output_pc_pgrads():
    """An output-PC model trained by the chain's gradients (S = (logits -
    x3) / var enters gW3 and gb3), against the JAX trainer."""
    pair = Pair(SGD, output_var=OUT_VAR, dims=ODD)
    jres, tres = pair.run(lambda pkg, y: dict(
        loss_fn=pkg.zero_fn, callback_after_t=pkg.LangevinStep(var=2.0),
        is_sample_x_at_batch_start=False, is_return_results_every_t=False))
    pair.assert_state()
    _assert_results(tres, jres)
