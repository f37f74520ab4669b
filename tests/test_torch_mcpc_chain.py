"""The port's fused chain (``ops/mcpc_chain.py``) against the JAX package's
Pallas kernel run in interpret mode, on the same numpy inputs.

Tolerances: latents atol 1e-5 (both sides run the same f32 arithmetic with
sums taken in another order; measured max |dx| ~2e-6 at these sizes),
scalars rtol 1e-5 (f32 batch sums of ~1e3-1e5).  The noise is the same
counter hash on both sides, so it is compared bit for bit.  Parameter
gradients are sums over the batch and the sampling steps with entries up to
~1e4, taken in another order on the two sides: each tensor is held to 2e-6
of its largest entry (measured: at most ~3e-7).
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
    # tanh is supported, as by the JAX kernel
    tanh = mt.make_mlp_model(4, 8, 8, 16, activation="tanh")
    jtanh = mcpc.make_mlp_model(4, 8, 8, 16, activation="tanh")
    assert jops.supports_model(jtanh) and chain_mod.supports_model(tanh)
    assert chain_mod.model_activation(tanh) == jops.model_activation(jtanh) == "tanh"
    assert not chain_mod.supports_model(tanh, activation="relu")


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


def _assert_pgrads_close(tp_, jp, params_np):
    """Each gradient tensor within 2e-6 of its largest entry."""
    assert len(tp_) == len(jp) == 4
    for i, (tg, jg) in enumerate(zip(tp_, jp)):
        assert set(tg) == {"w", "b"}
        for k in ("w", "b"):
            ref = np.asarray(jg[k])
            assert tuple(tg[k].shape) == ref.shape == params_np[i][k].shape
            assert tg[k].dtype == torch.float32
            scale = max(float(np.abs(ref).max()), 1e-30)
            np.testing.assert_allclose(tg[k].numpy(), ref, rtol=0, atol=2e-6 * scale)
    assert not tp_[0]["w"].any()


def _assert_chain_close(jout, tout, scalars, pgrads=False):
    assert len(jout) == len(tout)
    assert (tout[1] is not None) == pgrads
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


PGRAD_CASES = {
    "bernoulli": dict(T=20, lr=0.03, mixing=5, with_pgrads=True),
    "gaussian": dict(T=20, lr=0.03, mixing=5, with_pgrads=True, loss="gaussian",
                     input_var=0.5),
    "none": dict(T=20, lr=0.03, mixing=5, with_pgrads=True, loss="none"),
    "two_tiles": dict(T=20, lr=0.03, mixing=5, with_pgrads=True, batch_tile=8),
    "odd_T": dict(T=21, lr=0.03, mixing=6, with_pgrads=True),
    "mixing_0": dict(T=9, lr=0.03, mixing=0, with_pgrads=True),
    "mixing_T": dict(T=9, lr=0.03, mixing=9, with_pgrads=True),
    "warm": dict(T=20, lr=0.03, mixing=5, with_pgrads=True, warm_T=5, warm_lr=0.1),
    "warm_pgrads_T0": dict(T=0, lr=0.03, warm_T=6, warm_lr=0.1, with_pgrads=True,
                           warm_pgrads=True),
    "warm_and_chain": dict(T=10, lr=0.03, mixing=4, with_pgrads=True, warm_T=4,
                           warm_pgrads=True),
}


@pytest.mark.parametrize("case", sorted(PGRAD_CASES))
def test_pgrads_match_interpret_kernel(case):
    """Hebbian parameter gradients with the noise on."""
    kw = dict(PGRAD_CASES[case], return_scalars=True)
    params_np, latents, target = _inputs(
        B=16, seed=3, gaussian_target=kw.get("loss") == "gaussian")
    jout, tout = _run_both(params_np, latents, target, 11, **kw)
    _assert_chain_close(jout, tout, scalars=True, pgrads=True)
    _assert_pgrads_close(tout[1], jout[1], params_np)
    if case == "mixing_T":  # no step samples
        assert all(not g[k].any() for g in tout[1] for k in g)
    elif case == "none":  # S is zero: the sensory layer gets no gradient
        assert not tout[1][3]["w"].any() and not tout[1][3]["b"].any()
        assert tout[1][2]["w"].any()
    else:
        assert all(tout[1][i]["w"].any() for i in (1, 2, 3))


UNPACKED_CASES = {
    "noise_pgrads": dict(T=11, lr=0.03, mixing=3, with_pgrads=True),
    "noise_odd_dims": dict(T=6, lr=0.03, dims=(5, 7, 9, 16)),
    "gaussian_pgrads": dict(T=8, lr=0.03, mixing=0, with_pgrads=True,
                            loss="gaussian", input_var=0.5),
    "none_no_noise": dict(T=8, lr=0.03, loss="none", noise_var=None,
                          with_pgrads=True),
}


@pytest.mark.parametrize("case", sorted(UNPACKED_CASES))
def test_unpacked_chain_matches_interpret_kernel(case):
    """packed=False: the baseline kernel, with its own noise indexing (odd
    latent widths split cos | sin unevenly)."""
    kw = dict(UNPACKED_CASES[case], packed=False)
    dims = kw.pop("dims", (4, 8, 8, 16))
    params_np, latents, target = _inputs(
        dims=dims, B=8, seed=2, gaussian_target=kw.get("loss") == "gaussian")
    jout, tout = _run_both(params_np, latents, target, 5, **kw)
    pg = kw.get("with_pgrads", False)
    _assert_chain_close(jout, tout, scalars=False, pgrads=pg)
    if pg:
        _assert_pgrads_close(tout[1], jout[1], params_np)
    # the packed chain draws other noise from the same seed
    if kw.get("noise_var", 2.0):
        packed = chain_mod.mcpc_chain(
            params_from_numpy(params_np, "cpu"), latents_from_numpy(latents, "cpu"),
            torch.from_numpy(target), 5, **dict(kw, packed=True))
        assert float((packed[0][1] - tout[0][1]).abs().max()) > 1e-2


@pytest.mark.parametrize("kw,match", [
    (dict(packed=False, warm_T=2), "warm-start"),
    (dict(packed=False, activation="tanh"), "relu only"),
    (dict(packed=False, return_scalars=True), "packed=True"),
    (dict(packed=False, with_pgrads=True, warm_pgrads=True), "warm_T"),
    (dict(packed=False, batch_tile=4), "packed=True"),
    (dict(packed=False, loss="bernoulli_mask", mask_perc=0.5), "packed=True"),
    (dict(with_pgrads=True, warm_pgrads=True), "warm_T"),
    # the JAX kernel dies on its missing accumulators (a NameError)
    (dict(warm_pgrads=True, warm_T=2), "with_pgrads"),
])
def test_unpacked_and_pgrad_options_refused_as_in_jax(kw, match):
    params_np, latents, target = _inputs()
    p, x, y = (params_from_numpy(params_np, "cpu"),
               latents_from_numpy(latents, "cpu"), torch.from_numpy(target))
    with pytest.raises(ValueError, match=match):
        chain_mod.mcpc_chain(p, x, y, 0, T=2, lr=0.1, **kw)
    with pytest.raises((ValueError, NameError)):
        mcpc_chain_pallas(params_np, tuple(jnp.asarray(v) for v in latents),
                          jnp.asarray(target), jnp.int32(0), T=2, lr=0.1,
                          interpret=True, **kw)


def test_sum_block_partials_cpu_is_the_ordered_sum():
    rng = np.random.default_rng(0)
    partials = torch.from_numpy(rng.normal(size=(5, 37)).astype(np.float32) * 1e3)
    before = chain_mod.sum_block_partials.launches
    got = chain_mod.sum_block_partials(partials)
    assert chain_mod.sum_block_partials.launches == before
    want = partials[0].clone()
    for b in range(1, 5):
        want = want + partials[b]
    assert torch.equal(got, want)
    assert torch.equal(got, chain_mod.sum_block_partials_reference(partials))
    with pytest.raises(ValueError, match="n_blocks"):
        chain_mod.sum_block_partials(partials[0])


_MU = tuple(np.zeros((8, d), np.float32) for d in (4, 8, 8))

# Every option the port did not take at first, by name: each raises the JAX
# wrapper's ValueError when misused, like it (bf16_matmul has no misuse; its
# tests are tests/test_torch_bf16.py).
UNPORTED = {
    "capture_stride": (dict(T=0, capture_stride=2), ValueError, "requires steps"),
    "scalar_stride": (dict(scalar_stride=2), ValueError, "return_scalars"),
    "output_var": (dict(output_var=1.0), ValueError, "4 latents"),
    "mask_perc": (dict(loss="gaussian_mask"), ValueError, "mask_perc"),
    "warm_mu": (dict(warm_mu=_MU, warm_nu=_MU, warm_count=1), ValueError, "warm_T > 0"),
    "warm_nu": (dict(warm_T=2, warm_mu=_MU, warm_count=1), ValueError, "warm_nu"),
    "warm_count": (dict(warm_T=2, warm_mu=_MU, warm_nu=_MU), ValueError, "warm_count"),
    "emit_warm_opt_state": (dict(emit_warm_opt_state=True), ValueError, "warm_T > 0"),
    "activation": (dict(activation="tanh", packed=False), ValueError, "relu only"),
    "loss": (dict(loss="bernoulli_mask"), ValueError, "mask_perc"),
}


@pytest.mark.parametrize("name", sorted(UNPORTED))
def test_unported_options_raise(name):
    kw, error, match = UNPORTED[name]
    params_np, latents, target = _inputs()
    p, x, y = (params_from_numpy(params_np, "cpu"),
               latents_from_numpy(latents, "cpu"), torch.from_numpy(target))
    tkw = {k: tuple(torch.from_numpy(m) for m in v) if k in ("warm_mu", "warm_nu") else v
           for k, v in kw.items()}
    for fn in (chain_mod.mcpc_chain, chain_mod.mcpc_chain_reference):
        with pytest.raises(error, match=match):
            fn(p, x, y, 0, **dict(dict(T=2, lr=0.1), **tkw))
    if error is ValueError:  # the JAX wrapper refuses the same call
        jkw = {k: tuple(jnp.asarray(m) for m in v) if k in ("warm_mu", "warm_nu") else v
               for k, v in kw.items()}
        with pytest.raises(ValueError, match=match):
            mcpc_chain_pallas(params_np, tuple(jnp.asarray(v) for v in latents),
                              jnp.asarray(target), jnp.int32(0),
                              **dict(dict(T=2, lr=0.1), **jkw), interpret=True)


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
    assert _build.library_path("mcpc_chain_unpacked").name.startswith(
        "mcpc_chain_unpacked-")
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    """Both sources include csrc/mcpc_common.cuh: an edited header must not
    load a stale library."""
    import shutil

    shutil.copytree(_build.CSRC, tmp_path / "csrc")
    monkeypatch.setattr(_build, "CSRC", tmp_path / "csrc")
    before = [_build.library_path(n) for n in ("mcpc_chain", "mcpc_chain_unpacked")]
    assert before == [_build.library_path(n) for n in ("mcpc_chain", "mcpc_chain_unpacked")]
    with open(tmp_path / "csrc" / "mcpc_common.cuh", "a") as f:
        f.write("// edited\n")
    after = [_build.library_path(n) for n in ("mcpc_chain", "mcpc_chain_unpacked")]
    assert all(a != b for a, b in zip(after, before))
