"""The port's fused chain (``ops/mcpc_chain.py``) against the JAX package's
Pallas kernel run in interpret mode, on the same numpy inputs.

Tolerances: latents atol 1e-5 (both sides run the same f32 arithmetic with
sums taken in another order; measured max |dx| ~2e-6 at these sizes),
scalars rtol 1e-5 (f32 batch sums of ~1e3-1e5).  The noise is the same
counter hash on both sides, so it is compared bit for bit.
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
from montecarlopredictivecoding_tpu_torch.ops import _build
from montecarlopredictivecoding_tpu_torch.utils import (
    latents_from_numpy,
    params_from_numpy,
)

# the package exports the function ``mcpc_chain`` under the module's name
chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

torch.set_num_threads(1)


# ---------------------------------------------------------------- noise


@pytest.mark.parametrize("seed,draw", [(0, 0), (3, 7), (-5, 12), (2**31 - 1, 1)])
def test_counter_bits_bit_identical(seed, draw):
    shape = (8, 384)
    ref = np.asarray(jops._mock_bits(shape, jnp.int32(seed), jnp.int32(draw)))
    got = chain_mod.counter_bits(shape, seed, draw, device="cpu").numpy()
    assert got.dtype == np.int64 and got.min() >= 0 and got.max() < 2**32
    assert np.array_equal(got, ref.astype(np.int64))


def test_uniforms_sincos_and_box_muller_match_jax():
    shape, seed, draw = (64, 256), 11, 4
    ju1, ju2 = jops._uniforms(shape, mock=(jnp.int32(seed), jnp.int32(draw)))
    b1 = chain_mod.counter_bits(shape, seed, draw, device="cpu")
    b2 = chain_mod.counter_bits(shape, seed, draw + 1, device="cpu")
    tu1, tu2 = chain_mod.uniforms(b1, b2)
    np.testing.assert_allclose(tu1.numpy(), np.asarray(ju1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tu2.numpy(), np.asarray(ju2), rtol=0, atol=1e-6)
    jc, js = jops._sincos_2pi(ju2)
    tc, ts = chain_mod.sincos_2pi(tu2)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-6)
    # Box-Muller pair: JAX's _normals lays r*cos | r*sin side by side
    jz = np.asarray(jops._normals((64, 512), mock=(jnp.int32(seed), jnp.int32(draw))))
    zc, zs = chain_mod.box_muller(b1, b2)
    np.testing.assert_allclose(zc.numpy(), jz[:, :256], rtol=0, atol=1e-6)
    np.testing.assert_allclose(zs.numpy(), jz[:, 256:], rtol=0, atol=1e-6)


# -------------------------------------------------------------- helpers


def test_layout_and_tile_helpers_match_jax():
    for dims in [(20, 128, 128), (10, 256, 256), (4, 8, 8), (130, 1, 257)]:
        assert chain_mod.aligned_layout(dims) == jops.aligned_layout(dims)
    for B in [1, 8, 256, 1024, 1030, 2048, 3000, 4099]:
        assert chain_mod._pick_batch_tile(B) == jops._pick_batch_tile(B)


def test_supports_model_matches_jax():
    from montecarlopredictivecoding_tpu.core import modules as jmod
    from montecarlopredictivecoding_tpu_torch.core import modules as tmod

    cases = [
        (mcpc.make_mlp_model(4, 8, 8, 16), mt.make_mlp_model(4, 8, 8, 16)),
        (mcpc.make_mlp_model(4, 8, 8, 16, output_pc=jmod.PC()),
         mt.make_mlp_model(4, 8, 8, 16, output_pc=tmod.PC())),
        (mcpc.PCModel([jmod.Linear(2, 2), jmod.PC(), jmod.Linear(2, 2)]),
         mt.PCModel([tmod.Linear(2, 2), tmod.PC(), tmod.Linear(2, 2)])),
    ]
    for jm, tm in cases:
        assert chain_mod.supports_model(tm) == jops.supports_model(jm)
        assert chain_mod.model_activation(tm) == jops.model_activation(jm)
    relu = mt.make_mlp_model(4, 8, 8, 16)
    assert chain_mod.supports_model(relu, activation="relu")
    masked = mt.PCModel([
        m if not isinstance(m, tmod.PC) else tmod.PC(M=(1.0,) * 4)
        for m in relu.modules
    ])
    assert not chain_mod.supports_model(masked)
    # tanh is supported by the JAX kernel but not ported yet
    tanh = mt.make_mlp_model(4, 8, 8, 16, activation="tanh")
    assert jops.supports_model(mcpc.make_mlp_model(4, 8, 8, 16, activation="tanh"))
    assert not chain_mod.supports_model(tanh)
    assert chain_mod.model_activation(tanh) is None


# ------------------------------------------------------- chain vs JAX


def _inputs(dims=(4, 8, 8, 16), B=8, seed=0, gaussian_target=False):
    """Params from the JAX model's init, latents and target from numpy."""
    jm = mcpc.make_mlp_model(*dims)
    params_np = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    latents = tuple(
        rng.uniform(-10, 10, (B, d)).astype(np.float32) for d in dims[:3]
    )
    if gaussian_target:
        target = rng.uniform(-1, 1, (B, dims[3])).astype(np.float32)
    else:
        target = (rng.random((B, dims[3])) > 0.5).astype(np.float32)
    return params_np, latents, target


def _run_both(params_np, latents, target, seed, **kw):
    jout = mcpc_chain_pallas(
        params_np, tuple(jnp.asarray(x) for x in latents),
        None if target is None else jnp.asarray(target), jnp.int32(seed),
        interpret=True, **kw,
    )
    tout = chain_mod.mcpc_chain(
        params_from_numpy(params_np, "cpu"), latents_from_numpy(latents, "cpu"),
        None if target is None else torch.from_numpy(target), seed, **kw,
    )
    return jout, tout


def _assert_chain_close(jout, tout, scalars):
    assert len(jout) == len(tout)
    assert tout[1] is None
    for a, b in zip(tout[0], jout[0]):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    if scalars:
        for k in ("loss", "energy"):
            assert tout[2][k].shape == (1,)
            np.testing.assert_allclose(
                tout[2][k].numpy(), np.asarray(jout[2][k]), rtol=1e-5, atol=1e-5
            )


CHAIN_CASES = {
    "noise_odd_T": dict(T=21, lr=0.03),
    "noise_even_T_warm": dict(T=20, lr=0.03, warm_T=5, warm_lr=0.1),
    "no_noise_warm": dict(T=21, lr=0.03, noise_var=None, warm_T=5),
    "warm_only_T0": dict(T=0, lr=0.03, warm_T=5),
    "gaussian": dict(T=21, lr=0.03, loss="gaussian", input_var=0.5, warm_T=5),
    "none": dict(T=20, lr=0.03, loss="none"),
    "no_steps": dict(T=0, lr=0.03),
}


@pytest.mark.parametrize("case", sorted(CHAIN_CASES))
def test_chain_matches_interpret_kernel(case):
    kw = dict(CHAIN_CASES[case], return_scalars=True)
    params_np, latents, target = _inputs(
        gaussian_target=kw.get("loss") == "gaussian")
    jout, tout = _run_both(params_np, latents, target, 7, **kw)
    _assert_chain_close(jout, tout, scalars=True)
    if kw["T"] + kw.get("warm_T", 0) > 0:  # the chain really moved
        assert not np.allclose(tout[0][1].numpy(), latents[1])


def test_chain_batch_tiles_and_no_target():
    """batch_tile=8 at B=16: per-tile seeds; target None means zeros."""
    params_np, latents, target = _inputs(B=16, seed=1)
    kw = dict(T=21, lr=0.03, batch_tile=8, warm_T=3)
    jout, tout = _run_both(params_np, latents, target, 2, **kw)
    _assert_chain_close(jout, tout, scalars=False)
    jout, tout = _run_both(params_np, latents, None, 2, T=6, lr=0.03,
                           return_scalars=True)
    _assert_chain_close(jout, tout, scalars=True)


def test_cpu_wrapper_is_the_plain_version_and_counts_no_launch():
    params_np, latents, target = _inputs()
    p, x, y = (params_from_numpy(params_np, "cpu"),
               latents_from_numpy(latents, "cpu"), torch.from_numpy(target))
    before = chain_mod.mcpc_chain.launches
    a = chain_mod.mcpc_chain(p, x, y, 4, T=9, lr=0.05, warm_T=2, return_scalars=True)
    b = chain_mod.mcpc_chain_reference(p, x, y, 4, T=9, lr=0.05, warm_T=2,
                                       return_scalars=True)
    assert chain_mod.mcpc_chain.launches == before
    for u, v in zip(a[0], b[0]):
        assert torch.equal(u, v)
    assert torch.equal(a[2]["loss"], b[2]["loss"])
    # a different seed moves the chain by O(noise)
    c = chain_mod.mcpc_chain(p, x, y, 5, T=9, lr=0.05, warm_T=2)
    assert float((c[0][1] - a[0][1]).abs().max()) > 1e-2


UNPORTED = {
    "with_pgrads": True,
    "capture_stride": 2,
    "scalar_stride": 2,
    "output_var": 1.0,
    "mask_perc": 0.5,
    "bf16_matmul": True,
    "packed": False,
    "warm_mu": (),
    "warm_nu": (),
    "warm_count": 1,
    "warm_pgrads": True,
    "emit_warm_opt_state": True,
    "activation": "tanh",
    "loss": "bernoulli_mask",
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_options_raise(name):
    params_np, latents, target = _inputs()
    p, x, y = (params_from_numpy(params_np, "cpu"),
               latents_from_numpy(latents, "cpu"), torch.from_numpy(target))
    for fn in (chain_mod.mcpc_chain, chain_mod.mcpc_chain_reference):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            fn(p, x, y, 0, T=2, lr=0.1, **{name: UNPORTED[name]})


def test_invalid_arguments_raise():
    params_np, latents, target = _inputs()
    p, x, y = (params_from_numpy(params_np, "cpu"),
               latents_from_numpy(latents, "cpu"), torch.from_numpy(target))
    with pytest.raises(ValueError, match="divisible"):
        chain_mod.mcpc_chain(p, x, y, 0, T=2, lr=0.1, batch_tile=3)
    with pytest.raises(ValueError, match="loss"):
        chain_mod.mcpc_chain(p, x, y, 0, T=2, lr=0.1, loss="poisson")
    with pytest.raises(ValueError, match="target"):
        chain_mod.mcpc_chain(p, x, y[:, :5], 0, T=2, lr=0.1)
    with pytest.raises(TypeError, match="keyword"):
        chain_mod.mcpc_chain(p, x, y, 0, T=2, lr=0.1, interpret=True)
    # a batch with no tile divisor >= 128 is refused, as in the JAX wrapper
    big = tuple(torch.zeros(1031, t.shape[1]) for t in x)
    with pytest.raises(ValueError, match="tile"):
        chain_mod.mcpc_chain(p, big, None, 0, T=1, lr=0.1)


def test_build_paths_are_keyed_by_source():
    path = _build.library_path("mcpc_chain")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("mcpc_chain-") and path.suffix == ".so"
    assert path == _build.library_path("mcpc_chain")
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
