"""bf16 products (``bf16_matmul=True``) of the port's ``mcpc_chain`` on CPU
tensors, which is the plain version, against ``mcpc_chain_pallas(...,
bf16_matmul=True, interpret=True)`` on the same numpy inputs.

Both round the same operands to bf16 (to nearest, ties to even) and sum the
products in f32; a product of two bf16 values is exact in f32, so the two
differ only in the order of the f32 sums.  Mostly that leaves them at f32
rounding distance, and the tolerances are the f32 ones of
tests/test_torch_tanh_outpc.py: latents, ``x3`` and captures atol 1e-5
(measured up to 5e-7), scalars rtol 1e-5 (atol 1e-5), Adam moments atol 1e-6
of their tensor's largest entry, gradients 2e-6 of theirs.  But where one
of the sums lands within that rounding of a bf16 boundary, the next
product's operand rounds the other way in one of the two (one bf16 ulp,
2^-8 relative), and the chain carries that on: in one case here
(``tanh_masked_captured_pgrads``) 5 of the 64 elements of a latent move by
up to 5e-5 and a weight gradient by 0.26 of its bf16 effect.  So each part
may also sit up to FLIP_SHARE (half, the rule chip_smoke.py holds the
kernels to) of its bf16 effect from the JAX kernel, the bf16 effect being
the distance between the port's f32 and bf16 chains on the same inputs
(2e-4 to 6e-3 on the latents here).  A chain that ignored the flag sits at
the whole effect and fails; ``test_flag_is_not_ignored`` says so case by
case, and ``test_tanh_derivative_reads_the_unrounded_activation`` holds one
step to the closed form at 1e-5.  The noise is on unless a case says
otherwise.
"""

import importlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
from montecarlopredictivecoding_tpu.ops import mcpc_chain_pallas
from montecarlopredictivecoding_tpu_torch.utils import (
    latents_from_numpy,
    params_from_numpy,
)

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

torch.set_num_threads(1)

DIMS = (4, 8, 8, 16)
ODD = (5, 7, 9, 13)   # widths that do not divide by 8
LAT_ATOL = 1e-5
FLIP_SHARE = 0.5
BF = dict(bf16_matmul=True)


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


def _torch_kw(kw):
    return {k: tuple(torch.from_numpy(m) for m in v) if k in ("warm_mu", "warm_nu") else v
            for k, v in kw.items()}


def _jax(params_np, latents, target, seed, **kw):
    jkw = {k: tuple(jnp.asarray(m) for m in v) if k in ("warm_mu", "warm_nu") else v
           for k, v in kw.items()}
    return mcpc_chain_pallas(
        params_np, tuple(jnp.asarray(x) for x in latents),
        None if target is None else jnp.asarray(target), jnp.int32(seed),
        interpret=True, **jkw)


def _port(params_np, latents, target, seed, **kw):
    return chain_mod.mcpc_chain(
        params_from_numpy(params_np, "cpu"), latents_from_numpy(latents, "cpu"),
        None if target is None else torch.from_numpy(target), seed, **_torch_kw(kw))


def _close(t, j, f32, what, atol=LAT_ATOL, rtol=0.0):
    """``t`` within ``atol + rtol |j|`` of ``j``, or within FLIP_SHARE of the
    bf16 effect ``|f32 - j|``."""
    ref = np.asarray(j)
    got = t.numpy()
    assert got.shape == ref.shape and t.dtype == torch.float32, what
    effect = float(np.abs(f32.numpy() - ref).max())
    excess = np.abs(got - ref) - (atol + rtol * np.abs(ref))
    assert excess.max() <= 0.0 or np.abs(got - ref).max() <= FLIP_SHARE * effect, (
        f"{what}: max |d| {np.abs(got - ref).max()}, bf16 effect {effect}")


def _assert_result(tout, jout, f32, kw):
    """Every part of the JAX wrapper's result, in its order; ``f32`` is the
    port's result without the flag, which measures the bf16 effect."""
    assert len(tout) == len(jout) == len(f32)
    out_pc = kw.get("output_var") is not None
    assert len(tout[0]) == len(jout[0]) == (4 if out_pc else 3)
    for i, (a, b, f) in enumerate(zip(tout[0], jout[0], f32[0])):
        _close(a, b, f, f"latent {i}")
    if kw.get("with_pgrads"):
        for tg, jg, fg in zip(tout[1], jout[1], f32[1]):
            for k in ("w", "b"):
                scale = max(float(np.abs(np.asarray(jg[k])).max()), 1e-30)
                _close(tg[k], jg[k], fg[k], f"pgrads {k}", atol=2e-6 * scale)
    else:
        assert tout[1] is None and jout[1] is None
    k = 2
    if kw.get("capture_stride"):
        _close(tout[k], jout[k], f32[k], "traj")
        k += 1
        if out_pc:
            _close(tout[k], jout[k], f32[k], "traj3")
            k += 1
    if kw.get("return_scalars"):
        for name in ("loss", "energy"):
            _close(tout[k][name], jout[k][name], f32[k][name], name, atol=1e-5, rtol=1e-5)
        k += 1
    if kw.get("emit_warm_opt_state"):
        assert len(tout[k]) == len(jout[k]) == (4 if out_pc else 2)
        for a, b, f in zip(tout[k], jout[k], f32[k]):
            scale = max(float(np.abs(np.asarray(b)).max()), 1e-30)
            _close(a, b, f, "moments", atol=1e-6 * scale)
        k += 1
    assert k == len(tout)


TANH = dict(activation="tanh")
OUT = dict(output_var=0.5, loss="none")

# name -> (dims, B, options); every case runs with bf16_matmul=True
CASES = {
    "relu_warm_langevin_pgrads": (DIMS, 8, dict(warm_T=6, T=9, lr=0.03, with_pgrads=True,
                                                mixing=3, return_scalars=True)),
    "tanh_warm_langevin_pgrads": (DIMS, 8, dict(TANH, warm_T=6, T=9, lr=0.03,
                                                with_pgrads=True, mixing=3,
                                                return_scalars=True)),
    "relu_warm_only_warm_pgrads": (ODD, 7, dict(warm_T=8, T=0, lr=0.1, with_pgrads=True,
                                                warm_pgrads=True, return_scalars=True)),
    "tanh_warm_only_warm_pgrads": (ODD, 7, dict(TANH, warm_T=8, T=0, lr=0.1,
                                                with_pgrads=True, warm_pgrads=True,
                                                return_scalars=True)),
    # the captured steps' scalars are recomputed in f32 from the f32
    # weights, the final step's come from the bf16 products
    "relu_masked_captured": (DIMS, 8, dict(warm_T=3, T=11, lr=0.03, loss="bernoulli_mask",
                                           mask_perc=0.5, capture_stride=2,
                                           return_scalars=True)),
    "tanh_masked_captured_pgrads": (DIMS, 8, dict(TANH, warm_T=3, T=11, lr=0.03,
                                                  loss="bernoulli_mask", mask_perc=0.5,
                                                  capture_stride=3, with_pgrads=True,
                                                  mixing=4, return_scalars=True)),
    "relu_scalar_stride_gaussian": (ODD, 6, dict(T=13, lr=0.03, loss="gaussian",
                                                 input_var=0.5, scalar_stride=4,
                                                 return_scalars=True)),
    "tanh_scalar_stride_warm_only": (DIMS, 8, dict(TANH, warm_T=10, T=0, lr=0.1,
                                                   scalar_stride=3, return_scalars=True)),
    "relu_emit_and_resume": (DIMS, 8, dict(warm_T=5, T=3, lr=0.03, emit_warm_opt_state=True,
                                           warm_count=4, return_scalars=True)),
    "tanh_emit_and_resume": (ODD, 6, dict(TANH, warm_T=5, T=0, lr=0.1,
                                          emit_warm_opt_state=True, warm_count=2,
                                          return_scalars=True)),
    "relu_two_batch_tiles": (DIMS, 16, dict(warm_T=2, T=7, lr=0.03, batch_tile=8,
                                            with_pgrads=True, mixing=2)),
    "tanh_two_batch_tiles": (DIMS, 16, dict(TANH, warm_T=2, T=7, lr=0.03, batch_tile=8,
                                            with_pgrads=True, mixing=2,
                                            return_scalars=True)),
    "outpc_warm_langevin_pgrads": (DIMS, 8, dict(OUT, warm_T=6, T=9, lr=0.05,
                                                 with_pgrads=True, mixing=3,
                                                 return_scalars=True)),
    "outpc_captured_emit": (ODD, 6, dict(OUT, warm_T=4, T=7, lr=0.05,
                                         emit_warm_opt_state=True, capture_stride=3,
                                         return_scalars=True)),
    "unpacked_pgrads": (DIMS, 8, dict(T=9, lr=0.03, with_pgrads=True, mixing=3,
                                      packed=False)),
    "unpacked_gaussian_no_noise": (ODD, 5, dict(T=6, lr=0.05, loss="gaussian",
                                                noise_var=None, with_pgrads=True,
                                                mixing=0, packed=False)),
}


def _case(case):
    dims, B, kw = CASES[case]
    out_pc = "output_var" in kw
    params_np, latents, target = _inputs(dims, B, output_pc=out_pc)
    kw = dict(kw, **BF)
    if "warm_count" in kw:
        kw["warm_mu"], kw["warm_nu"] = _moments(dims, B, 4 if out_pc else 3)
    return dims, params_np, latents, None if out_pc else target, kw


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_chain_matches_interpret_kernel(case):
    """Each case against ``mcpc_chain_pallas(bf16_matmul=True,
    interpret=True)``: latents, gradients, captures, scalars and Adam
    moments, with the tolerances of the module docstring."""
    dims, params_np, latents, target, kw = _case(case)
    jout = _jax(params_np, latents, target, 7, **kw)
    tout = _port(params_np, latents, target, 7, **kw)
    f32 = _port(params_np, latents, target, 7, **dict(kw, bf16_matmul=False))
    _assert_result(tout, jout, f32, kw)


@pytest.mark.parametrize("layout", ["blockdiag", "perlayer"])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_both_jax_matmul_layouts_match_one_port_call(layout, act):
    """The JAX kernel's two product layouts round the same operands (the
    block-diagonal one also sums zeros), so one port call matches both."""
    params_np, latents, target = _inputs(DIMS, 8)
    kw = dict(warm_T=4, T=7, lr=0.03, with_pgrads=True, mixing=2, return_scalars=True,
              activation=act, **BF)
    tout = _port(params_np, latents, target, 3, **kw)
    jout = _jax(params_np, latents, target, 3, matmul_layout=layout, **kw)
    f32 = _port(params_np, latents, target, 3, **dict(kw, bf16_matmul=False))
    _assert_result(tout, jout, f32, kw)


@pytest.mark.parametrize("case", ["relu_warm_langevin_pgrads", "tanh_warm_langevin_pgrads",
                                  "relu_masked_captured", "outpc_warm_langevin_pgrads",
                                  "unpacked_pgrads"])
def test_flag_is_not_ignored(case):
    """The f32 chain sits more than 10 times the latents' tolerance from the
    JAX bf16 kernel, so a port that ignored ``bf16_matmul`` would fail the
    cases above (it would sit at the whole bf16 effect, not half of it); the
    bf16 one sits within half of that distance."""
    dims, params_np, latents, target, kw = _case(case)
    jout = _jax(params_np, latents, target, 7, **kw)
    f32 = _port(params_np, latents, target, 7, **dict(kw, bf16_matmul=False))
    bf16 = _port(params_np, latents, target, 7, **kw)
    gap = max(float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b in zip(f32[0], jout[0]))
    near = max(float(np.abs(a.numpy() - np.asarray(b)).max()) for a, b in zip(bf16[0], jout[0]))
    assert gap > 10 * LAT_ATOL
    assert near <= FLIP_SHARE * gap


def test_tanh_derivative_reads_the_unrounded_activation():
    """One tanh step without noise, closed form in float64: G = err - (1 -
    tanh(x)^2) * back, with ``back`` from the bf16 operands.  The port and
    the JAX kernel match it; the same step with 1 - bf16(tanh(x))^2 sits more
    than 10 times the tolerance away, so a port that took tanh' from the
    rounded activation would fail here."""
    params_np, latents, target = _inputs(DIMS, 8, seed=4)
    lr = 0.1
    kw = dict(T=1, lr=lr, noise_var=None, activation="tanh", **BF)
    tout = _port(params_np, latents, target, 0, **kw)
    jout = _jax(params_np, latents, target, 0, **kw)

    def bf16(a):
        return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float64)

    w = [bf16(params_np[i]["w"]) for i in (1, 2, 3)]
    b = [np.asarray(params_np[i]["b"], np.float64) for i in range(4)]
    x = [np.asarray(v, np.float64) for v in latents]
    h = [np.tanh(np.asarray(v, np.float32)).astype(np.float64) for v in latents]
    e0 = x[0] - b[0]
    e1 = x[1] - (bf16(h[0]) @ w[0] + b[1])
    e2 = x[2] - (bf16(h[1]) @ w[1] + b[2])
    logits = bf16(h[2]) @ w[2] + b[3]
    s = 1.0 / (1.0 + np.exp(-logits)) - target
    back = [bf16(e1) @ w[0].T, bf16(e2) @ w[1].T, bf16(-s) @ w[2].T]
    errs = [e0, e1, e2]
    for i in range(3):
        right = x[i] - lr * (errs[i] - (1.0 - h[i] ** 2) * back[i])
        wrong = x[i] - lr * (errs[i] - (1.0 - bf16(h[i]) ** 2) * back[i])
        np.testing.assert_allclose(tout[0][i].numpy(), right, rtol=0, atol=LAT_ATOL)
        np.testing.assert_allclose(np.asarray(jout[0][i]), right, rtol=0, atol=LAT_ATOL)
        if i > 0:   # x0's own tanh' sees back0 = err1 W1^T, as large as the others
            assert np.abs(wrong - right).max() > 10 * LAT_ATOL


def test_bf16_round_matches_jax_bit_for_bit():
    """Round to nearest, ties to even: the port's rounding of an operand
    equals ``astype(jnp.bfloat16)`` on every bit pattern class (normals,
    ties, subnormals, signed zeros, the overflow to infinity)."""
    rng = np.random.default_rng(0)
    ties = (rng.integers(0, 2**15, 512, dtype=np.uint32) << 16) | 0x8000
    bits = np.concatenate([rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
                           ties, np.array([0x0, 0x80000000, 0x00000001, 0x007FFFFF,
                                           0x7F7FFFFF, 0x3F808000, 0x3F818000],
                                          np.uint32)])
    vals = bits.view(np.float32)
    vals = vals[np.isfinite(vals)]
    want = np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32))
    got = chain_mod.bf16_round(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # a float64 operand rounds at the same points
    got64 = chain_mod.bf16_round(torch.from_numpy(vals.astype(np.float64)))
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(got64.numpy().astype(np.float32).view(np.uint32),
                                  want.view(np.uint32))


def test_capture_rows_are_f32_and_the_final_row_is_bf16():
    """With captures and ``return_scalars`` the captured steps' rows are
    recomputed in full f32 from the trajectory and the f32 weights (the JAX
    wrapper's ``_traj_scalar_rows``), while the final row comes from the
    chain's own bf16 products.  With T=5 and a stride of 2 the last capture
    is the final step, so the two rows of that step differ by the bf16
    effect alone."""
    params_np, latents, target = _inputs(DIMS, 8, seed=2)
    kw = dict(warm_T=2, T=5, lr=0.03, capture_stride=2, return_scalars=True, **BF)
    _, _, traj, scal = _port(params_np, latents, target, 5, **kw)
    assert scal["energy"].shape == (4,)
    params, y = params_from_numpy(params_np, "cpu"), torch.from_numpy(target)
    c = chain_mod._chain_args(params, latents_from_numpy(latents, "cpu"), y, 5, **kw)
    loss, energy = chain_mod.traj_scalar_rows(traj, params, y, c)
    assert torch.equal(scal["loss"][:-1], loss) and torch.equal(scal["energy"][:-1], energy)
    # the final row: the bf16 products' scalars at the last captured latents
    _, offs, _ = chain_mod.aligned_layout(DIMS[:3])
    last = tuple(traj[-1][:, o : o + d].numpy() for o, d in zip(offs, DIMS[:3]))
    one = _port(params_np, last, target, 5, T=1, lr=0.03, noise_var=None,
                return_scalars=True, **BF)[2]
    for name in ("loss", "energy"):
        np.testing.assert_allclose(scal[name][-1:].numpy(), one[name].numpy(), rtol=1e-6)
        assert float(scal[name][-1]) != float(scal[name][-2])


def test_unknown_keywords_still_raise():
    params_np, latents, target = _inputs(DIMS, 4)
    with pytest.raises(TypeError, match="keyword"):
        _port(params_np, latents, target, 0, T=1, lr=0.1, bf16=True)
