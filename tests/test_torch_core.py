"""The PyTorch port's core (modules, losses, PCModel, GenerativeModel,
get_model) against the JAX package on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.core import modules as jmod
from montecarlopredictivecoding_tpu.models import get_model as jax_get_model
from montecarlopredictivecoding_tpu_torch.core import modules as tmod
from montecarlopredictivecoding_tpu_torch.models import get_model
from montecarlopredictivecoding_tpu_torch.utils import (
    latents_from_numpy,
    params_from_numpy,
    params_to_numpy,
)

torch.set_num_threads(1)

ATOL = 1e-6


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("name", ["relu", "tanh", "sigmoid", "identity", "gelu", "mish"])
def test_activations_match_jax(name):
    x = _rand(np.random.default_rng(0), 64, 7, scale=3.0)
    _close(tmod.activation_fn(name)(torch.from_numpy(x)),
           jmod.activation_fn(name)(jnp.asarray(x)))


def test_unknown_activation_raises():
    with pytest.raises(ValueError):
        tmod.activation_fn("swish")


def test_energies_and_masks_match_jax():
    rng = np.random.default_rng(1)
    mu, x = _rand(rng, 5, 3), _rand(rng, 5, 3)
    S = ((1.0, 0.0, 0.5), (0.0, 1.0, 0.0), (0.25, 0.0, 1.0))
    M = (1.0, 0.0, 1.0)
    for jpc, tpc in [
        (jmod.PC(), tmod.PC()),
        (jmod.PC(M=M), tmod.PC(M=M)),
        (jmod.PC(S=S), tmod.PC(S=S)),
        (jmod.PC(energy_fn=jmod.scaled_gaussian_energy(0.3)),
         tmod.PC(energy_fn=tmod.scaled_gaussian_energy(0.3))),
    ]:
        _close(tpc.energy(torch.from_numpy(mu), torch.from_numpy(x)),
               jpc.energy(jnp.asarray(mu), jnp.asarray(x)))
    assert tmod.scaled_gaussian_energy(0.3).gaussian_var == 0.3
    with pytest.raises(ValueError):
        tmod.PC(S=((1.0,),)).energy(torch.from_numpy(mu), torch.from_numpy(x))


def test_losses_match_jax():
    """Elementwise values to atol 1e-6; batch sums (summed in another order)
    to rtol 1e-6."""
    rng = np.random.default_rng(2)
    out = _rand(rng, 6, 10, scale=4.0)
    tgt = (rng.random((6, 10)) > 0.5).astype(np.float32)
    t_out, t_tgt = torch.from_numpy(out), torch.from_numpy(tgt)
    j_out, j_tgt = jnp.asarray(out), jnp.asarray(tgt)

    def sums_close(a, b):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)

    _close(mt.bernoulli_fn(t_out, t_tgt, _reduction="none"),
           mcpc.bernoulli_fn(j_out, j_tgt, _reduction="none"))
    for red in ("sum", "mean"):
        sums_close(mt.bernoulli_fn(t_out, t_tgt, _reduction=red),
                   mcpc.bernoulli_fn(j_out, j_tgt, _reduction=red))
    sums_close(mt.fe_fn(t_out, t_tgt, 0.3), mcpc.fe_fn(j_out, j_tgt, 0.3))
    for perc in (0.5, 0.3, 0.01):
        sums_close(mt.fe_fn_mask(t_out, t_tgt, 0.3, perc),
                   mcpc.fe_fn_mask(j_out, j_tgt, 0.3, perc))
        sums_close(mt.bernoulli_fn_mask(t_out, t_tgt, perc=perc),
                   mcpc.bernoulli_fn_mask(j_out, j_tgt, perc=perc))
    _close(mt.zero_fn(t_out), mcpc.zero_fn(j_out))
    with pytest.raises(ValueError):
        mt.bernoulli_fn(t_out, t_tgt, _reduction="max")


def _shared_mlp(dims=(4, 8, 8, 16), B=5, seed=3, output_pc=False):
    """A JAX model, its params as numpy, and latents/target from numpy."""
    kw = {}
    if output_pc:
        kw = dict(output_pc=jmod.PC(energy_fn=jmod.scaled_gaussian_energy(0.5)))
    jm = mcpc.make_mlp_model(*dims, **kw)
    params_np = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    widths = list(dims[:3]) + ([dims[3]] if output_pc else [])
    latents = tuple(_rand(rng, B, d, scale=2.0) for d in widths)
    return jm, params_np, latents


@pytest.mark.parametrize("output_pc", [False, True])
def test_pcmodel_apply_and_predict_match_jax(output_pc):
    jm, params_np, latents = _shared_mlp(output_pc=output_pc)
    kw = {}
    if output_pc:
        kw = dict(output_pc=tmod.PC(energy_fn=tmod.scaled_gaussian_energy(0.5)))
    tm = mt.make_mlp_model(4, 8, 8, 16, **kw)
    tp_ = params_from_numpy(params_np, "cpu")
    inputs = np.zeros((5, 4), np.float32)
    jr = jm.apply(params_np, latents, jnp.asarray(inputs))
    tr = tm.apply(tp_, latents_from_numpy(latents, "cpu"), torch.from_numpy(inputs))
    _close(tr.output, jr.output)
    assert len(tr.energies) == len(jr.energies) == len(latents)
    for a, b in zip(tr.energies, jr.energies):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)
    for a, b in zip(tr.energies_per_datapoint, jr.energies_per_datapoint):
        assert a.shape == b.shape
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)
    for a, b in zip(tr.mus, jr.mus):
        _close(a, b)
    _close(tm.predict(tp_, torch.from_numpy(inputs)),
           jm.predict(params_np, jnp.asarray(inputs)))
    assert tm.num_parameters(tp_) == jm.num_parameters(params_np)
    assert (tm.num_parameters(tp_, exclude_first_linear=True)
            == jm.num_parameters(params_np, exclude_first_linear=True))
    for a, b in zip(tm.weight_norms(tp_), jm.weight_norms(params_np)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6)
    assert tm.get_least_T() == jm.get_least_T()
    assert tm.num_pc_layers == jm.num_pc_layers


def test_holding_error_and_forward_init():
    m = mt.PCModel([mt.Linear(2, 3), mt.PC(is_holding_error=True), mt.Linear(3, 2)])
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    x = torch.randn(4, 3)
    res = m.apply(params, (x,), torch.ones(4, 2))
    _close(res.errors[0], x - res.mus[0])
    # forward_init: fresh latents equal the incoming prediction
    lat = m.init_latents(params, torch.ones(4, 2))
    _close(lat[0], torch.ones(4, 2) @ params[0]["w"] + params[0]["b"])


def test_init_distributions_and_generators():
    m = mt.make_mlp_model(20, 128, 128, 784)
    params = m.init(torch.Generator().manual_seed(0), device="cpu")
    for p, (i, o) in zip(params, [(20, 20), (20, 128), (128, 128), (128, 784)]):
        assert p["w"].shape == (i, o) and p["b"].shape == (o,)
        bound = 1.0 / i ** 0.5
        assert float(p["w"].abs().max()) <= bound
        assert float(p["w"].abs().max()) > 0.9 * bound
    again = m.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(a["w"], b["w"]) for a, b in zip(params, again))
    lat = m.init_latents(params, torch.zeros(64, 20), torch.Generator().manual_seed(1))
    assert [x.shape for x in lat] == [(64, 20), (64, 128), (64, 128)]
    flat = torch.cat([x.reshape(-1) for x in lat])
    assert float(flat.min()) >= -10.0 and float(flat.max()) <= 10.0
    assert abs(float(flat.mean())) < 0.5 and abs(float(flat.var()) - 100 / 3) < 2.0
    s = m.ancestral_sample(params, torch.Generator().manual_seed(2), 7)
    assert s.shape == (7, 784) and torch.isfinite(s).all()
    g = tmod.normal_init({"mu": torch.zeros(5000), "generator": torch.Generator()})
    assert abs(float(g.std()) - 1.0) < 0.05
    _close(tmod.constant_init({"mu": torch.zeros(3)}), torch.full((3,), 3.0))


def test_get_model_and_generative_model():
    cfg = {"input_size": 4, "hidden_size": 8, "hidden2_size": 8,
           "output_size": 16, "activation_fn": "relu"}
    gen = get_model(cfg, 0, device="cpu")
    jgen = jax_get_model(cfg, 0)
    assert [m.__class__.__name__ for m in gen.model.modules] == [
        m.__class__.__name__ for m in jgen.model.modules]
    assert [tuple(p["w"].shape) for p in gen.params] == [
        tuple(p["w"].shape) for p in jgen.params]
    lat = gen.sample_latents(torch.zeros(3, 4))
    assert gen.get_model_xs() is lat and gen.get_x(1).shape == (3, 8)
    assert gen.predict(torch.zeros(3, 4)).shape == (3, 16)
    assert gen.ancestral_sample(2).shape == (2, 16)
    # the same seed gives the same parameters
    gen2 = get_model(cfg, 0, device="cpu")
    assert all(torch.equal(a["b"], b["b"]) for a, b in zip(gen.params, gen2.params))
    assert mt.LangevinStep().var == 2.0


def test_params_and_latents_round_trip():
    _, params_np, latents = _shared_mlp()
    back = params_to_numpy(params_from_numpy(params_np, "cpu"))
    for a, b in zip(back, params_np):
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == np.float32 and np.array_equal(a[k], b[k])
    for a, b in zip(latents_from_numpy(latents, "cpu"), latents):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)
