"""The chain's options (captures, per-step scalar slots, masked losses, the
Adam-state hand-off) in the port's ``mcpc_chain`` on CPU tensors, which is
the plain version, against ``mcpc_chain_pallas(..., interpret=True)`` on
the same numpy inputs.

Tolerances as in tests/test_torch_mcpc_chain.py: latents and captured
latents atol 1e-5, scalars rtol 1e-5, Adam moments atol 1e-6 of their
tensor's largest entry, gradients 2e-6 of theirs.  The noise is on.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
from montecarlopredictivecoding_tpu.ops import mcpc_chain_pallas
from montecarlopredictivecoding_tpu.ops import pallas_mcpc as jops
from montecarlopredictivecoding_tpu_torch.utils import (
    latents_from_numpy,
    params_from_numpy,
)

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

torch.set_num_threads(1)

DIMS = (4, 8, 8, 16)


def _inputs(B=8, seed=0, gaussian_target=False):
    jm = mcpc.make_mlp_model(*DIMS)
    params_np = jax.device_get(jm.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    latents = tuple(rng.uniform(-10, 10, (B, d)).astype(np.float32) for d in DIMS[:3])
    if gaussian_target:
        target = rng.uniform(-1, 1, (B, DIMS[3])).astype(np.float32)
    else:
        target = (rng.random((B, DIMS[3])) > 0.5).astype(np.float32)
    return params_np, latents, target


def _moments(B=8, seed=9):
    rng = np.random.default_rng(seed)
    mu = tuple((0.1 * rng.normal(size=(B, d))).astype(np.float32) for d in DIMS[:3])
    nu = tuple((0.01 * rng.random((B, d))).astype(np.float32) for d in DIMS[:3])
    return mu, nu


def _run_both(params_np, latents, target, seed, **kw):
    jkw, tkw = dict(kw), dict(kw)
    for name in ("warm_mu", "warm_nu"):
        if name in kw:
            jkw[name] = tuple(jnp.asarray(m) for m in kw[name])
            tkw[name] = tuple(torch.from_numpy(m) for m in kw[name])
    jout = mcpc_chain_pallas(
        params_np, tuple(jnp.asarray(x) for x in latents), jnp.asarray(target),
        jnp.int32(seed), interpret=True, **jkw,
    )
    tout = chain_mod.mcpc_chain(
        params_from_numpy(params_np, "cpu"), latents_from_numpy(latents, "cpu"),
        torch.from_numpy(target), seed, **tkw,
    )
    return jout, tout


def _assert_close(t, j, what="out"):
    """Latents and trajectories atol 1e-5, scalar dicts rtol 1e-5, moment
    pairs 1e-6 of their largest entry, gradients 2e-6 of theirs."""
    if isinstance(j, dict):
        assert set(t) == set(j), what
        for k in j:
            if isinstance(j[k], dict) or j[k] is None:
                _assert_close(t[k], j[k], f"{what}.{k}")
            else:
                assert tuple(t[k].shape) == np.asarray(j[k]).shape, what
                np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                           rtol=1e-5, atol=1e-5, err_msg=what)
    elif j is None:
        assert t is None, what
    elif isinstance(j, (tuple, list)):
        assert len(t) == len(j), what
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_close(a, b, f"{what}[{i}]")
    else:
        ref = np.asarray(j)
        assert tuple(t.shape) == ref.shape and t.dtype == torch.float32, what
        np.testing.assert_allclose(t.numpy(), ref, rtol=0, atol=1e-5, err_msg=what)


def _assert_moments(t, j):
    assert len(t) == len(j) == 2
    for a, b in zip(t, j):
        ref = np.asarray(b)
        assert tuple(a.shape) == ref.shape
        scale = max(float(np.abs(ref).max()), 1e-30)
        np.testing.assert_allclose(a.numpy(), ref, rtol=0, atol=1e-6 * scale)


def _assert_pgrads(t, j):
    for tg, jg in zip(t, j):
        for k in ("w", "b"):
            ref = np.asarray(jg[k])
            scale = max(float(np.abs(ref).max()), 1e-30)
            np.testing.assert_allclose(tg[k].numpy(), ref, rtol=0, atol=2e-6 * scale)


# ---------------------------------------------------------------- captures

CAPTURE_CASES = {
    "langevin_stride3": dict(T=13, lr=0.03, capture_stride=3),
    "langevin_stride1_warm": dict(T=6, lr=0.03, warm_T=4, capture_stride=1),
    "warm_only_stride2": dict(T=0, lr=0.03, warm_T=7, capture_stride=2),
    "langevin_pgrads": dict(T=12, lr=0.03, capture_stride=5, with_pgrads=True, mixing=4),
    "gaussian": dict(T=9, lr=0.03, capture_stride=4, loss="gaussian", input_var=0.5),
}


@pytest.mark.parametrize("scalars", [True, False])
@pytest.mark.parametrize("case", sorted(CAPTURE_CASES))
def test_captures_match_interpret_kernel(case, scalars):
    """The trajectory ``[ceil(steps / stride), B, XW]`` (the Langevin phase,
    or the warm phase of a warm-only chain), pad lanes 0, and with
    ``return_scalars`` the captured steps' recomputed rows then the final
    step's."""
    kw = dict(CAPTURE_CASES[case], return_scalars=scalars)
    params_np, latents, target = _inputs(gaussian_target=kw.get("loss") == "gaussian")
    jout, tout = _run_both(params_np, latents, target, 7, **kw)
    assert len(tout) == len(jout) == (4 if scalars else 3)
    _assert_close(tout[0], jout[0], "latents")
    traj = tout[2]
    steps = kw["T"] or kw["warm_T"]
    assert traj.shape == (-(-steps // kw["capture_stride"]), 8, 384)
    _assert_close(traj, jout[2], "traj")
    pad = np.ones(384, bool)
    for o, d in zip(chain_mod.aligned_layout(DIMS[:3])[1], DIMS[:3]):
        pad[o : o + d] = False
    assert not traj[:, :, pad].any()
    if kw.get("with_pgrads"):
        _assert_pgrads(tout[1], jout[1])
    if scalars:
        assert tout[3]["loss"].shape == (traj.shape[0] + 1,)
        _assert_close(tout[3], jout[3], "scalars")


def test_traj_scalar_rows_chunking_matches_one_block(monkeypatch):
    """Long trajectories are recomputed in row chunks; the chunks give the
    rows of one block."""
    params_np, latents, target = _inputs()
    p, y = params_from_numpy(params_np, "cpu"), torch.from_numpy(target)
    c = chain_mod._chain_args(p, latents_from_numpy(latents, "cpu"), y, 0,
                              T=20, lr=0.03, capture_stride=1, return_scalars=True)
    traj = chain_mod.mcpc_chain(p, latents_from_numpy(latents, "cpu"), y, 0,
                                T=20, lr=0.03, capture_stride=1)[2]
    whole = chain_mod.traj_scalar_rows(traj, p, y, c)
    monkeypatch.setattr(chain_mod, "_SCALAR_RECOMPUTE_ROWS", 3 * 8)
    chunked = chain_mod.traj_scalar_rows(traj, p, y, c)
    for a, b in zip(whole, chunked):
        assert a.shape == (20,)
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0)


# ------------------------------------------------------- per-step scalars

SLOT_CASES = {
    "langevin_stride3": dict(T=13, lr=0.03, scalar_stride=3),
    "langevin_stride1": dict(T=7, lr=0.03, scalar_stride=1, warm_T=3),
    "langevin_stride_divides": dict(T=12, lr=0.03, scalar_stride=4),
    "warm_only_stride4": dict(T=0, lr=0.03, warm_T=9, scalar_stride=4),
    "langevin_pgrads_gaussian": dict(T=10, lr=0.03, scalar_stride=3, with_pgrads=True,
                                     mixing=2, loss="gaussian", input_var=0.5),
    "none_loss": dict(T=8, lr=0.03, scalar_stride=2, loss="none"),
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
def test_scalar_slots_match_interpret_kernel(case):
    """One slot per ``scalar_stride``-th step of the Langevin phase (of the
    warm phase of a warm-only chain) plus the final step's."""
    kw = dict(SLOT_CASES[case], return_scalars=True)
    params_np, latents, target = _inputs(gaussian_target=kw.get("loss") == "gaussian")
    jout, tout = _run_both(params_np, latents, target, 3, **kw)
    steps = kw["T"] or kw["warm_T"]
    n_slots = -(-steps // kw["scalar_stride"]) + 1
    assert chain_mod.scalar_slots(kw["T"], kw.get("warm_T", 0), kw["scalar_stride"]) == n_slots
    assert jops._scalar_slots(kw["T"], kw.get("warm_T", 0), kw["scalar_stride"])[0] == n_slots
    assert tout[2]["loss"].shape == (n_slots,)
    _assert_close(tout, jout)
    if kw.get("with_pgrads"):
        _assert_pgrads(tout[1], jout[1])
    # the final slot is the final step's pre-update scalars
    final = chain_mod.mcpc_chain(
        params_from_numpy(params_np, "cpu"), latents_from_numpy(latents, "cpu"),
        torch.from_numpy(target), 3,
        **{k: v for k, v in kw.items() if k != "scalar_stride"})[2]
    for k in ("loss", "energy"):
        torch.testing.assert_close(tout[2][k][-1:], final[k])


# ------------------------------------------------------------- masked losses

@pytest.mark.parametrize("perc", [0.5, 0.0001, 0.3])
@pytest.mark.parametrize("loss", ["bernoulli_mask", "gaussian_mask"])
def test_masked_losses_match_interpret_kernel(loss, perc):
    """Only the last round(D * perc) output columns are clamped; 0.0001
    rounds to 0, which clamps all of them."""
    kw = dict(T=12, lr=0.03, warm_T=3, loss=loss, mask_perc=perc, return_scalars=True,
              with_pgrads=True, mixing=4)
    if loss == "gaussian_mask":
        kw["input_var"] = 0.5
    params_np, latents, target = _inputs(B=16, seed=2,
                                         gaussian_target=loss == "gaussian_mask")
    jout, tout = _run_both(params_np, latents, target, 5, **kw)
    _assert_close(tout[0], jout[0], "latents")
    _assert_close(tout[2], jout[2], "scalars")
    _assert_pgrads(tout[1], jout[1])
    unmasked = dict(kw, loss=loss[: -len("_mask")])
    del unmasked["mask_perc"]
    whole = chain_mod.mcpc_chain(
        params_from_numpy(params_np, "cpu"), latents_from_numpy(latents, "cpu"),
        torch.from_numpy(target), 5, **unmasked)
    mask_k = round(DIMS[3] * perc)
    gb3 = tout[1][3]["b"]
    if mask_k == 0:  # all columns: the unmasked loss
        for a, b in zip(tout[0], whole[0]):
            assert torch.equal(a, b)
    else:  # the unclamped columns get no sensory gradient
        assert not gb3[: DIMS[3] - mask_k].any() and gb3[DIMS[3] - mask_k:].any()
        assert float(tout[2]["loss"]) < float(whole[2]["loss"])


# ----------------------------------------------------------- Adam state

@pytest.mark.parametrize("T", [0, 5])
def test_emit_warm_opt_state_matches_interpret_kernel(T):
    """The moments after the warm phase, ``[B, XW]`` aligned, returned
    last."""
    kw = dict(T=T, lr=0.03, warm_T=6, warm_lr=0.1, emit_warm_opt_state=True,
              return_scalars=True, capture_stride=2)
    params_np, latents, target = _inputs()
    jout, tout = _run_both(params_np, latents, target, 4, **kw)
    assert len(tout) == len(jout) == 5
    _assert_close(tout[:4], jout[:4])
    m, v = tout[4]
    assert m.shape == v.shape == (8, 384)
    assert bool((v >= 0).all()) and m.abs().max() > 0
    _assert_moments(tout[4], jout[4])


@pytest.mark.parametrize("count", [0, 7])
def test_warm_continuation_matches_interpret_kernel(count):
    """Resuming moments and a step count: the bias powers start at
    b^(count + 1)."""
    mu, nu = _moments()
    kw = dict(T=4, lr=0.03, warm_T=6, warm_lr=0.1, warm_mu=mu, warm_nu=nu,
              warm_count=count, emit_warm_opt_state=True, return_scalars=True)
    params_np, latents, target = _inputs()
    jout, tout = _run_both(params_np, latents, target, 6, **kw)
    _assert_close(tout[:3], jout[:3])
    _assert_moments(tout[3], jout[3])


def test_continuation_in_three_calls_matches_one_call():
    """Warm 4 + 5 + 6 steps handing the state on equal 15 in one call."""
    params_np, latents, target = _inputs()
    p, y = params_from_numpy(params_np, "cpu"), torch.from_numpy(target)
    kw = dict(T=0, lr=0.03, warm_lr=0.1, emit_warm_opt_state=True)
    one = chain_mod.mcpc_chain(p, latents_from_numpy(latents, "cpu"), y, 1,
                               warm_T=15, **kw)
    _, offs, _ = chain_mod.aligned_layout(DIMS[:3])
    lat, count, state = latents_from_numpy(latents, "cpu"), 0, None
    for steps in (4, 5, 6):
        extra = {}
        if state is not None:
            extra = dict(warm_count=count, **{
                name: tuple(m[:, o : o + d] for o, d in zip(offs, DIMS[:3]))
                for name, m in zip(("warm_mu", "warm_nu"), state)})
        lat, _, state = chain_mod.mcpc_chain(p, lat, y, 1, warm_T=steps, **kw, **extra)
        count += steps
    for a, b in zip(lat, one[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    for a, b in zip(state, one[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()))


@pytest.mark.parametrize("betas", [(0.9, 0.999), (0.5, 0.75), (0.95, 0.98)])
def test_bias_powers_are_bit_equal_to_jnp_power(betas):
    """``bias0`` of the JAX wrapper: ``jnp.power`` of float32 scalars."""
    b1, b2 = betas
    f = jax.jit(lambda c: jnp.stack([
        jnp.power(jnp.float32(b1), (c + 1).astype(jnp.float32)),
        jnp.power(jnp.float32(b2), (c + 1).astype(jnp.float32))]))
    for count in list(range(0, 40)) + [99, 250, 1000, 1999, 2000, 9999, 12345]:
        want = np.asarray(f(jnp.int32(count)))
        got = np.array(chain_mod.bias_powers(b1, b2, count), dtype=np.float32)
        assert np.array_equal(got.view(np.int32), want.view(np.int32)), count


# -------------------------------------------------------- refused options

MOMENTS = _moments()

REFUSED = [
    (dict(T=2, capture_stride=2, emit_warm_opt_state=True), "emit_warm_opt_state requires warm_T"),
    (dict(T=2, warm_mu=MOMENTS[0], warm_nu=MOMENTS[1], warm_count=1), "warm_T > 0"),
    (dict(T=2, warm_T=2, warm_mu=MOMENTS[0], warm_count=1), "warm_nu and warm_count"),
    (dict(T=2, warm_T=2, warm_mu=MOMENTS[0], warm_nu=MOMENTS[1]), "warm_nu and warm_count"),
    (dict(T=2, warm_T=2, warm_mu=MOMENTS[0][:2], warm_nu=MOMENTS[1][:2], warm_count=1),
     "all 3 latent sites"),
    (dict(T=0, capture_stride=2), "capture_stride requires steps"),
    (dict(T=2, scalar_stride=2), "return_scalars"),
    (dict(T=2, scalar_stride=2, return_scalars=True, packed=False), "packed=True"),
    (dict(T=2, scalar_stride=2, capture_stride=1, return_scalars=True), "mutually exclusive"),
    (dict(T=0, scalar_stride=2, return_scalars=True), "scalar_stride requires steps"),
    (dict(T=2, loss="bernoulli_mask"), "mask_perc"),
    (dict(T=2, loss="gaussian_mask", mask_perc=0.5, packed=False), "packed=True"),
]


@pytest.mark.parametrize("kw,match", REFUSED)
def test_option_errors_as_in_jax(kw, match):
    params_np, latents, target = _inputs()
    tkw, jkw = dict(kw), dict(kw)
    for name in ("warm_mu", "warm_nu"):
        if name in kw:
            tkw[name] = tuple(torch.from_numpy(m) for m in kw[name])
            jkw[name] = tuple(jnp.asarray(m) for m in kw[name])
    for fn in (chain_mod.mcpc_chain, chain_mod.mcpc_chain_reference):
        with pytest.raises(ValueError, match=match):
            fn(params_from_numpy(params_np, "cpu"), latents_from_numpy(latents, "cpu"),
               torch.from_numpy(target), 0, lr=0.1, **tkw)
    with pytest.raises(ValueError, match=match):
        mcpc_chain_pallas(params_np, tuple(jnp.asarray(x) for x in latents),
                          jnp.asarray(target), jnp.int32(0), lr=0.1,
                          interpret=True, **jkw)


def test_capture_on_the_unpacked_chain_is_refused():
    """The JAX wrapper returns no trajectory there without a word; the port
    says so."""
    params_np, latents, target = _inputs()
    with pytest.raises(ValueError, match="capture_stride requires packed=True"):
        chain_mod.mcpc_chain(params_from_numpy(params_np, "cpu"),
                             latents_from_numpy(latents, "cpu"),
                             torch.from_numpy(target), 0, T=2, lr=0.1,
                             capture_stride=1, packed=False)
