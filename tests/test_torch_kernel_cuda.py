"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it runs on a GPU
machine without JAX (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_kernel_cuda.py -q -m cuda --noconftest

Without a CUDA device every test here skips.  Tolerances: latents atol 1e-4
and scalars rtol 1e-5 on these short chains (the kernel sums in another
order than cuBLAS; measured differences are ~2e-6).  Parameter gradients
are batch sums with entries up to ~1e5, so each tensor is held to 1e-5 of its
largest entry.  The per-op probe (``benchmarks/vpu_op_bench.py``): its
``card_tolerance`` (1e-5, scaled for the random variants by the tile's
largest |x|) and 1e-6 for the card's ``sincos_2pi``.
"""

import importlib

import pytest
import torch

import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu_torch.benchmarks import vpu_op_bench as probe
from montecarlopredictivecoding_tpu_torch.ops.mcpc_chain import sincos_2pi

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dims, B, device, seed=3):
    gen = torch.Generator().manual_seed(seed)
    model = mt.make_mlp_model(*dims)
    params = model.init(gen, device=device)
    latents = model.init_latents(params, torch.zeros(B, dims[0], device=device), gen)
    target = (torch.rand(B, dims[3], generator=gen) > 0.5).float().to(device)
    return params, latents, target


@pytest.mark.cuda
@pytest.mark.parametrize("dims,B,kw", [
    ((20, 128, 128, 784), 64, dict(T=21, warm_T=5, loss="bernoulli")),
    ((20, 128, 128, 784), 40, dict(T=20, loss="gaussian", batch_tile=20)),
    ((10, 256, 256, 784), 32, dict(T=11, warm_T=3, loss="none")),
    ((4, 8, 8, 16), 5, dict(T=7, noise_var=None, loss="bernoulli")),
])
def test_kernel_matches_plain_version(cuda_device, dims, B, kw):
    params, latents, target = _case(dims, B, cuda_device)
    before = chain_mod.mcpc_chain.launches
    a = chain_mod.mcpc_chain(params, latents, target, 9, lr=0.03,
                             return_scalars=True, **kw)
    torch.cuda.synchronize()
    assert chain_mod.mcpc_chain.launches == before + 1
    b = chain_mod.mcpc_chain_reference(params, latents, target, 9, lr=0.03,
                                       return_scalars=True, **kw)
    for u, v in zip(a[0], b[0]):
        assert u.is_cuda and u.shape == v.shape
        torch.testing.assert_close(u, v, rtol=0, atol=1e-4)
    for k in ("loss", "energy"):
        torch.testing.assert_close(a[2][k], b[2][k], rtol=1e-5, atol=1e-5)


def _assert_pgrads_close(got, want, rel=1e-5):
    for g, w in zip(got, want):
        for k in ("w", "b"):
            assert g[k].is_cuda and g[k].shape == w[k].shape
            scale = max(float(w[k].abs().max()), 1e-30)
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=rel * scale)
    assert not got[0]["w"].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dims,B,kw", [
    ((20, 128, 128, 784), 64, dict(T=30, mixing=10, warm_T=5, loss="bernoulli")),
    # B not a multiple of the rows of a cluster: the last one has pad rows
    ((20, 128, 128, 784), 37, dict(T=20, mixing=5, loss="bernoulli")),
    # one cluster with fewer rows than it holds
    ((20, 128, 128, 784), 1, dict(T=20, mixing=5, warm_T=4, loss="bernoulli")),
    ((20, 128, 128, 784), 8, dict(T=20, mixing=5, warm_T=4, loss="bernoulli")),
    ((20, 128, 128, 784), 250, dict(T=12, mixing=4, warm_T=4, loss="bernoulli")),
    ((10, 256, 256, 784), 8, dict(T=12, mixing=4, warm_T=4, loss="bernoulli")),
    ((10, 256, 256, 784), 37, dict(T=12, mixing=4, loss="gaussian")),
    ((10, 256, 256, 784), 250, dict(T=12, mixing=4, warm_T=4, loss="bernoulli")),
    # d0 = 10 over 8 ranks: slices of 2 and 1 columns
    ((10, 128, 128, 784), 37, dict(T=12, mixing=4, warm_T=4, loss="bernoulli")),
    # d0 = 4 over 8 ranks: the last four ranks own no column of x0
    ((4, 128, 128, 784), 37, dict(T=12, mixing=4, warm_T=4, loss="bernoulli")),
    ((4, 128, 128, 784), 256, dict(T=12, mixing=4, warm_T=4, loss="gaussian")),
    ((4, 8, 8, 16), 5, dict(T=12, mixing=4, warm_T=4, loss="bernoulli")),
    ((10, 256, 256, 784), 21, dict(T=0, warm_T=8, warm_pgrads=True)),
    ((20, 128, 128, 784), 40, dict(T=20, mixing=0, loss="gaussian", batch_tile=20)),
    ((10, 256, 256, 784), 30, dict(T=11, mixing=3, warm_T=3, loss="none")),
    ((20, 128, 128, 784), 21, dict(T=0, warm_T=8, warm_pgrads=True)),
    ((4, 8, 8, 16), 5, dict(T=7, mixing=2, noise_var=None)),
    ((20, 128, 128, 784), 37, dict(T=20, mixing=5, packed=False)),
    ((5, 7, 9, 16), 19, dict(T=9, mixing=0, packed=False, loss="gaussian")),
])
def test_kernel_pgrads_match_plain_version(cuda_device, dims, B, kw):
    params, latents, target = _case(dims, B, cuda_device)
    packed = kw.get("packed", True)
    count = "launches" if packed else "launches_unpacked"
    before = getattr(chain_mod.mcpc_chain, count)
    before_sum = chain_mod.sum_block_partials.launches
    kw = dict(kw, lr=0.03, with_pgrads=True)
    a = chain_mod.mcpc_chain(params, latents, target, 9, **kw)
    torch.cuda.synchronize()
    assert getattr(chain_mod.mcpc_chain, count) == before + 1
    assert chain_mod.sum_block_partials.launches == before_sum + 1
    b = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    for u, v in zip(a[0], b[0]):
        torch.testing.assert_close(u, v, rtol=0, atol=1e-4)
    _assert_pgrads_close(a[1], b[1])
    # no atomics: a second run gives the same bits
    again = chain_mod.mcpc_chain(params, latents, target, 9, **kw)
    for g, h in zip(a[1], again[1]):
        assert torch.equal(g["w"], h["w"]) and torch.equal(g["b"], h["b"])


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [(20, 128, 128, 784), (10, 256, 256, 784)])
def test_two_runs_of_a_training_chain_are_bit_identical(cuda_device, dims):
    """The partial backward products are added in rank order and the
    gradients without atomics, so nothing depends on the blocks' timing."""
    params, latents, target = _case(dims, 250, cuda_device)
    kw = dict(T=30, mixing=10, warm_T=10, warm_lr=0.7, lr=0.1, with_pgrads=True,
              return_scalars=True)
    a = chain_mod.mcpc_chain(params, latents, target, 5, **kw)
    b = chain_mod.mcpc_chain(params, latents, target, 5, **kw)
    for u, v in zip(a[0], b[0]):
        assert torch.equal(u, v)
    for g, h in zip(a[1], b[1]):
        assert torch.equal(g["w"], h["w"]) and torch.equal(g["b"], h["b"])
    for k in ("loss", "energy"):
        assert torch.equal(a[2][k], b[2][k])


@pytest.mark.cuda
@pytest.mark.parametrize("dims,warm,with_pgrads,output_pc", [
    ((20, 128, 128, 784), True, True, False),
    ((20, 128, 128, 784), False, False, False),
    ((10, 256, 256, 784), True, True, False),
    ((4, 8, 8, 16), True, True, False),
    ((20, 128, 128, 784), True, False, True),
    ((30, 256, 256, 784), True, True, True),
])
def test_plan_agrees_with_the_kernel_and_the_card_runs_it(cuda_device, dims, warm,
                                                          with_pgrads, output_pc):
    plan = chain_mod.chain_plan(dims, 256, warm=warm, with_pgrads=with_pgrads,
                                budget=chain_mod.smem_budget(cuda_device),
                                max_clusters=chain_mod.max_active_clusters(cuda_device),
                                output_pc=output_pc)
    lib = chain_mod._library()
    assert lib.mcpc_chain_cluster_size() == plan.cluster_size
    grads = (2 if plan.grads_resident else 1) if with_pgrads else 0
    assert lib.mcpc_chain_smem_bytes(*dims, plan.rows, int(warm), grads,
                                     int(output_pc)) == plan.smem_bytes
    assert chain_mod.max_active_clusters(cuda_device, plan) >= 1


@pytest.mark.cuda
def test_launch_refuses_a_plan_the_kernel_was_not_sized_for(cuda_device):
    """The shared-memory layout and the slices exist on both sides of the C
    interface: a launch whose two sides disagree fails instead of running."""
    import dataclasses
    params, latents, target = _case((20, 128, 128, 784), 8, cuda_device)
    c = chain_mod._chain_args(params, latents, target, 0, T=2, lr=0.1)
    plan = chain_mod.device_plan(c, 8, cuda_device)
    before = chain_mod.mcpc_chain.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        chain_mod._kernel(c, params, latents, target,
                          plan=dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 4))
    uneven = ((0, 20),) + ((20, 20),) * 7   # one rank owns all of x0
    with pytest.raises(RuntimeError, match="launch failed"):
        chain_mod._kernel(c, params, latents, target, plan=dataclasses.replace(
            plan, slices=(uneven,) + plan.slices[1:]))
    assert chain_mod.mcpc_chain.launches == before
    chain_mod._kernel(c, params, latents, target, plan=plan)
    assert chain_mod.mcpc_chain.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [18, 10, 4, 2])
def test_every_built_row_count_matches_the_plain_version(cuda_device, rows):
    """The plan picks one row count a call; ``chain_phase_clocks`` can force
    each, so every instantiation of the kernel is launched here."""
    params, latents, target = _case((20, 128, 128, 784), 37, cuda_device)
    assert rows in chain_mod.CLUSTER_ROWS
    kw = dict(T=9, warm_T=3, lr=0.03)
    c = chain_mod._chain_args(params, latents, target, 9, **kw)
    plan = chain_mod.device_plan(c, 37, cuda_device, (rows,))
    assert plan.rows == rows
    got, _ = chain_mod._kernel(c, params, latents, target, plan=plan)
    want, _ = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    for u, v in zip(got, want):
        torch.testing.assert_close(u, v, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("nblocks,n", [(16, 120356), (1, 1000), (7, 30001), (40, 4100)])
def test_sum_block_partials_shapes(cuda_device, nblocks, n):
    """float4 body, scalar body (n not a multiple of 4), more partials than
    one group of loads."""
    gen = torch.Generator().manual_seed(1)
    partials = (torch.randn(nblocks, n, generator=gen) * 1e3).to(cuda_device)
    got = chain_mod.sum_block_partials(partials)
    assert torch.equal(got, chain_mod.sum_block_partials_reference(partials))


@pytest.mark.cuda
def test_unpacked_kernel_matches_plain_version(cuda_device):
    params, latents, target = _case((20, 128, 128, 784), 48, cuda_device)
    before = chain_mod.mcpc_chain.launches_unpacked
    a = chain_mod.mcpc_chain(params, latents, target, 4, T=25, lr=0.03, packed=False)
    torch.cuda.synchronize()
    assert chain_mod.mcpc_chain.launches_unpacked == before + 1
    assert a[1] is None
    b = chain_mod.mcpc_chain_reference(params, latents, target, 4, T=25, lr=0.03,
                                       packed=False)
    for u, v in zip(a[0], b[0]):
        torch.testing.assert_close(u, v, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_sum_block_partials_kernel_is_the_ordered_sum(cuda_device):
    gen = torch.Generator().manual_seed(0)
    partials = (torch.randn(16, 120356, generator=gen) * 1e3).to(cuda_device)
    before = chain_mod.sum_block_partials.launches
    got = chain_mod.sum_block_partials(partials)
    torch.cuda.synchronize()
    assert chain_mod.sum_block_partials.launches == before + 1
    assert torch.equal(got, chain_mod.sum_block_partials_reference(partials))
    # the per-step scalar slots are summed in double by the same pass
    wide = partials.double() * 1e-3
    assert torch.equal(chain_mod.sum_block_partials(wide),
                       chain_mod.sum_block_partials_reference(wide))
    with pytest.raises(TypeError, match="float32"):
        chain_mod.sum_block_partials(partials.half())


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda_device):
    params, latents, target = _case((4, 8, 8, 16), 4, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        chain_mod.mcpc_chain(params, tuple(x.double() for x in latents),
                             target, 0, T=2, lr=0.1)
    with pytest.raises(ValueError, match="one device"):
        chain_mod.mcpc_chain(params, latents, target.cpu(), 0, T=2, lr=0.1)


# ------------------------------------------------ options of the chain

FID = (20, 128, 128, 784)

OPTION_CASES = {
    "capture_langevin": dict(T=20, warm_T=5, capture_stride=3, return_scalars=True),
    "capture_warm_only": dict(T=0, warm_T=9, capture_stride=2, return_scalars=True),
    "scalar_stride_langevin": dict(T=20, warm_T=5, scalar_stride=7, return_scalars=True),
    "scalar_stride_warm_only": dict(T=0, warm_T=15, scalar_stride=7, return_scalars=True),
    "mask_bernoulli_half": dict(T=20, warm_T=5, loss="bernoulli_mask", mask_perc=0.5,
                                return_scalars=True, with_pgrads=True, mixing=5),
    "mask_gaussian_rounds_to_all": dict(T=20, loss="gaussian_mask", mask_perc=0.0001,
                                        input_var=0.5, return_scalars=True),
    "emit_warm_opt_state": dict(T=6, warm_T=9, emit_warm_opt_state=True,
                                return_scalars=True),
}


def _assert_same_outputs(got, want, moments_rel=1e-5):
    """Latents (and the trajectory) atol 1e-4, scalars rtol 1e-5, gradients
    1e-5 and moments ``moments_rel`` of their tensor's largest entry."""
    assert len(got) == len(want)
    for u, v in zip(got[0], want[0]):
        torch.testing.assert_close(u, v, rtol=0, atol=1e-4)
    if want[1] is not None:
        _assert_pgrads_close(got[1], want[1])
    for g, w in zip(got[2:], want[2:]):
        if isinstance(w, dict):
            for k in ("loss", "energy"):
                assert g[k].shape == w[k].shape
                torch.testing.assert_close(g[k], w[k], rtol=1e-5, atol=1e-5)
        elif isinstance(w, tuple):
            for a, b in zip(g, w):
                scale = max(float(b.abs().max()), 1e-30)
                torch.testing.assert_close(a, b, rtol=0, atol=moments_rel * scale)
        else:
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(OPTION_CASES))
@pytest.mark.parametrize("B", [37, 8])
def test_kernel_options_match_plain_version(cuda_device, case, B):
    kw = dict(OPTION_CASES[case], lr=0.03)
    params, latents, target = _case(FID, B, cuda_device)
    if kw.get("loss", "").startswith("gaussian"):
        target = 2.0 * target - 1.0
    before = chain_mod.mcpc_chain.launches
    got = chain_mod.mcpc_chain(params, latents, target, 9, **kw)
    torch.cuda.synchronize()
    assert chain_mod.mcpc_chain.launches == before + 1
    want = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    _assert_same_outputs(got, want)
    if kw.get("capture_stride"):
        # pad lanes of the trajectory stay zero
        traj = got[2]
        _, offs, XW = chain_mod.aligned_layout(FID[:3])
        pad = torch.ones(XW, dtype=torch.bool, device=cuda_device)
        for o, d in zip(offs, FID[:3]):
            pad[o : o + d] = False
        assert not traj[:, :, pad].any()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [18, 10, 4, 2])
def test_every_built_row_count_takes_every_option(cuda_device, rows):
    """Captures, per-step scalars, a mask and the Adam hand-off in one call,
    at each instantiation of the kernel, with pad rows (B = 37)."""
    params, latents, target = _case(FID, 37, cuda_device)
    gen = torch.Generator().manual_seed(4)
    mu = tuple((0.1 * torch.randn(x.shape, generator=gen)).to(cuda_device) for x in latents)
    nu = tuple((0.01 * torch.rand(x.shape, generator=gen)).to(cuda_device) for x in latents)
    for kw in (
        dict(T=0, warm_T=8, capture_stride=3, loss="bernoulli_mask", mask_perc=0.5,
             emit_warm_opt_state=True, warm_mu=mu, warm_nu=nu, warm_count=7,
             return_scalars=True),
        dict(T=11, warm_T=4, scalar_stride=4, loss="bernoulli_mask", mask_perc=0.5,
             emit_warm_opt_state=True, return_scalars=True, with_pgrads=True, mixing=3),
    ):
        kw = dict(kw, lr=0.03)
        c = chain_mod._chain_args(params, latents, target, 9, **kw)
        plan = chain_mod.device_plan(c, 37, cuda_device, (rows,))
        assert plan.rows == rows
        got = chain_mod._kernel(c, params, latents, target, plan=plan,
                                warm_mu=kw.get("warm_mu"), warm_nu=kw.get("warm_nu"))
        want = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
        _assert_same_outputs(got, want)


@pytest.mark.cuda
def test_capture_at_the_training_batch(cuda_device):
    """B = 256: 15 clusters of 18 rows, every step captured."""
    params, latents, target = _case(FID, 256, cuda_device)
    kw = dict(T=12, warm_T=3, lr=0.03, capture_stride=1, return_scalars=True)
    got = chain_mod.mcpc_chain(params, latents, target, 9, **kw)
    want = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    assert got[2].shape == (12, 256, 384)
    _assert_same_outputs(got, want)


@pytest.mark.cuda
def test_continuation_in_three_calls_matches_one_call(cuda_device):
    """Warm 4 + 5 + 6 steps handing the Adam state on equal 15 steps in one
    launch, to rounding: the bias powers resume at b^(count+1)."""
    params, latents, target = _case(FID, 37, cuda_device)
    kw = dict(T=0, lr=0.03, warm_lr=0.1, emit_warm_opt_state=True)
    one = chain_mod.mcpc_chain(params, latents, target, 9, warm_T=15, **kw)
    lat, count, state = latents, 0, None
    _, offs, _ = chain_mod.aligned_layout(FID[:3])
    for steps in (4, 5, 6):
        extra = {}
        if state is not None:
            extra = dict(warm_count=count, **{
                name: tuple(m[:, o : o + d] for o, d in zip(offs, FID[:3]))
                for name, m in zip(("warm_mu", "warm_nu"), state)})
        lat, _, state = chain_mod.mcpc_chain(params, lat, target, 9, warm_T=steps,
                                             **kw, **extra)
        count += steps
    for u, v in zip(lat, one[0]):
        torch.testing.assert_close(u, v, rtol=0, atol=1e-4)
    for a, b in zip(state, one[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()))


# ----------------------------------------- tanh and the output-PC site

TANH_CASES = {
    "tanh_warm_langevin_pgrads": dict(activation="tanh", warm_T=6, T=20, mixing=5,
                                      with_pgrads=True, return_scalars=True),
    "tanh_warm_only_warm_pgrads": dict(activation="tanh", warm_T=12, T=0,
                                       with_pgrads=True, warm_pgrads=True,
                                       return_scalars=True),
    "tanh_masked_captured": dict(activation="tanh", warm_T=4, T=15, capture_stride=2,
                                 loss="bernoulli_mask", mask_perc=0.5,
                                 return_scalars=True),
    "tanh_scalar_stride": dict(activation="tanh", warm_T=4, T=15, scalar_stride=4,
                               return_scalars=True),
}


def _output_pc_case(dims, B, device, var=0.5, seed=3):
    """An output-PC model's parameters and latents, x3 at least one unit off
    its prediction: where |x3 - logits| is within the rounding of two
    different sums, Adam's first step on x3 (lr * sign(x3 - logits)) would
    follow the sign of that rounding (at the prediction every element is
    such a case)."""
    gen = torch.Generator().manual_seed(seed)
    model = mt.make_mlp_model(*dims, output_pc=mt.PC(energy_fn=mt.scaled_gaussian_energy(var)))
    params = model.init(gen, device=device)
    latents = model.init_latents(params, torch.zeros(B, dims[0], device=device), gen)
    z = torch.randn(latents[3].shape, generator=gen).to(device)
    return params, latents[:3] + (latents[3] + torch.where(z >= 0, 1.0 + z, z - 1.0),)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(TANH_CASES))
@pytest.mark.parametrize("rows", [18, 10, 4, 2])
def test_tanh_matches_plain_version(cuda_device, case, rows):
    """tanh at every built row count, B = 37 (pad rows), at 20-128-128-784
    and at the mse preset's 30-256-256-784 (whose blocks hold 18 rows only
    without a warm phase)."""
    for dims in ((20, 128, 128, 784), (30, 256, 256, 784)):
        if rows == 18 and dims[1] == 256:
            continue
        params, latents, target = _case(dims, 37, cuda_device)
        kw = dict(TANH_CASES[case], lr=0.03)
        c = chain_mod._chain_args(params, latents, target, 9, **kw)
        plan = chain_mod.device_plan(c, 37, cuda_device, (rows,))
        assert plan.rows == rows
        before = chain_mod.mcpc_chain.launches
        got = chain_mod._kernel(c, params, latents, target, plan=plan)
        torch.cuda.synchronize()
        assert chain_mod.mcpc_chain.launches == before + 1
        want = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
        _assert_same_outputs(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [18, 10, 4, 2])
def test_output_pc_matches_plain_version(cuda_device, rows):
    """The output-PC site at every built row count, B = 37: a warm phase that
    hands its moments out, a continuation from them, then a Langevin phase
    with noise, gradients and captures (``traj3`` too), each held against
    the plain version on the same inputs."""
    dims = (20, 128, 128, 784)
    params, latents = _output_pc_case(dims, 37, cuda_device)
    out = dict(output_var=0.5, loss="none", lr=0.05)

    def run(inputs, **kw):
        kw = dict(out, **kw)
        c = chain_mod._chain_args(params, inputs, None, 9, **kw)
        plan = chain_mod.device_plan(c, 37, cuda_device, (rows,))
        assert plan.rows == rows
        got = chain_mod._kernel(c, params, inputs, None, plan=plan,
                                warm_mu=kw.get("warm_mu"), warm_nu=kw.get("warm_nu"))
        want = chain_mod.mcpc_chain_reference(params, inputs, None, 9, **kw)
        _assert_same_outputs(got, want)
        return got

    warm = run(latents, warm_T=8, T=0, emit_warm_opt_state=True, return_scalars=True)
    _, offs, _ = chain_mod.aligned_layout(dims[:3])
    split = lambda m, m3: tuple(m[:, o : o + d] for o, d in zip(offs, dims[:3])) + (
        m3[:, : dims[3]],)
    m, v, m3, v3 = warm[3]
    assert m3.shape == (37, 896) and not m3[:, dims[3]:].any()
    cont = run(warm[0], warm_T=5, T=0, emit_warm_opt_state=True, warm_count=8,
               warm_mu=split(m, m3), warm_nu=split(v, v3))
    lang = run(cont[0], T=21, mixing=5, with_pgrads=True, capture_stride=4,
               return_scalars=True)
    traj3 = lang[3]
    assert traj3.shape == (6, 37, 896) and not traj3[:, :, dims[3]:].any()
    assert len(lang[0]) == 4 and lang[0][3].shape == (37, 784)


@pytest.mark.cuda
def test_output_pc_at_the_joint_sampler_batch(cuda_device):
    """B = 256 (15 clusters of 18 rows), a warm start and a Langevin phase
    with noise, as the joint sampler runs them, against the plain version."""
    params, latents = _output_pc_case((20, 128, 128, 784), 256, cuda_device, var=1.0)
    kw = dict(output_var=1.0, loss="none", warm_T=10, warm_lr=0.7, T=20, lr=0.1,
              return_scalars=True)
    got = chain_mod.mcpc_chain(params, latents, None, 4, **kw)
    want = chain_mod.mcpc_chain_reference(params, latents, None, 4, **kw)
    _assert_same_outputs(got, want)
    again = chain_mod.mcpc_chain(params, latents, None, 4, **kw)
    for u, w in zip(got[0], again[0]):
        assert torch.equal(u, w)


# bf16 products (bf16_matmul: the bf16 builds' tensor-core products).  The
# kernels' bf16 builds against the plain bf16 version by chip_smoke.py's two
# rules: (i) after one Langevin step
# without noise at least 98% of the latents within 1e-5 and of the gradient
# entries within 2e-6 of their tensor's largest (the rest are where the two
# versions' f32 sums landed on either side of a bf16 rounding boundary), and
# no part further than half the bf16 effect (the plain bf16 version's
# distance from the plain f32 one); (ii) on longer chains every part within
# half the bf16 effect.
BF16_ONE_STEP = dict(T=1, lr=0.1, noise_var=None, with_pgrads=True, mixing=0)
BF16_CHAIN = dict(T=40, warm_T=20, warm_lr=0.1, lr=0.03, with_pgrads=True, mixing=10,
                  return_scalars=True)


def _share_within(pairs, tol_of):
    inside = total = 0
    for a, b in pairs:
        inside += int(((a - b).abs() <= tol_of(b)).sum())
        total += b.numel()
    return inside / total


def _max_abs(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def _grad_rel(ga, gb):
    return max(float((a[k] - b[k]).abs().max() / b[k].abs().max().clamp_min(1e-30))
               for a, b in zip(ga, gb) for k in ("w", "b"))


def _assert_one_step(got, want, f32):
    def grads(o):
        return [(x[k], y[k]) for x, y in zip(o[1], want[1]) for k in ("w", "b")]

    def grad_tol(b):
        return 2e-6 * b.abs().max()

    assert _share_within(zip(got[0], want[0]), lambda b: 1e-5) >= 0.98
    assert _share_within(grads(got), grad_tol) >= 0.98
    # the rule tells a kernel that ignores the flag from one that does not
    assert _share_within(zip(f32[0], want[0]), lambda b: 1e-5) < 0.98
    assert _max_abs(got[0], want[0]) <= 0.5 * _max_abs(f32[0], want[0])
    assert _grad_rel(got[1], want[1]) <= 0.5 * _grad_rel(f32[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["relu", "tanh", "unpacked"])
@pytest.mark.parametrize("B", [37, 256, 1024])
def test_bf16_one_step_matches_plain_version(cuda_device, kind, B):
    params, latents, target = _case(FID, B, cuda_device)
    kw = dict(BF16_ONE_STEP, activation="tanh" if kind == "tanh" else "relu",
              packed=kind != "unpacked")
    count = "launches_bf16" if kind != "unpacked" else "launches_unpacked_bf16"
    before = {n: getattr(chain_mod.mcpc_chain, n) for n in
              ("launches", "launches_unpacked", "launches_bf16", "launches_unpacked_bf16")}
    got = chain_mod.mcpc_chain(params, latents, target, 9, bf16_matmul=True, **kw)
    torch.cuda.synchronize()
    for n, v in before.items():
        assert getattr(chain_mod.mcpc_chain, n) == v + (n == count)
    want = chain_mod.mcpc_chain_reference(params, latents, target, 9, bf16_matmul=True, **kw)
    f32 = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    _assert_one_step(got, want, f32)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [18, 10, 4, 2])
@pytest.mark.parametrize("act", ["relu", "tanh"])
def test_bf16_every_built_row_count_one_step(cuda_device, rows, act):
    """Each instantiation of the bf16 build, with and without the options'
    code (the second call masks its loss), by rule (i)."""
    params, latents, target = _case(FID, 37, cuda_device)
    for extra in ({}, dict(loss="bernoulli_mask", mask_perc=0.5)):
        kw = dict(BF16_ONE_STEP, activation=act, **extra)
        c = chain_mod._chain_args(params, latents, target, 9, bf16_matmul=True, **kw)
        plan = chain_mod.device_plan(c, 37, cuda_device, (rows,))
        assert plan.rows == rows
        got = chain_mod._kernel(c, params, latents, target, plan=plan)
        want = chain_mod.mcpc_chain_reference(params, latents, target, 9, bf16_matmul=True,
                                               **kw)
        f32 = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
        _assert_one_step(got, want, f32)


BF16_CASES = {
    "relu": dict(BF16_CHAIN),
    "tanh": dict(BF16_CHAIN, activation="tanh"),
    "tanh_masked_captured": dict(BF16_CHAIN, activation="tanh", loss="bernoulli_mask",
                                 mask_perc=0.5, capture_stride=4),
    "relu_scalar_slots": dict(BF16_CHAIN, scalar_stride=7),
    "relu_emit_warm_opt_state": dict(BF16_CHAIN, T=0, with_pgrads=False,
                                     emit_warm_opt_state=True),
    "unpacked": dict(T=60, lr=0.01, with_pgrads=True, mixing=20, packed=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BF16_CASES))
def test_bf16_chain_matches_plain_version(cuda_device, case):
    """Rule (ii) on every part of the result, B = 37."""
    kw = BF16_CASES[case]
    params, latents, target = _case(FID, 37, cuda_device)
    got = chain_mod.mcpc_chain(params, latents, target, 9, bf16_matmul=True, **kw)
    want = chain_mod.mcpc_chain_reference(params, latents, target, 9, bf16_matmul=True, **kw)
    f32 = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    assert len(got) == len(want) == len(f32)
    assert _max_abs(got[0], want[0]) <= 0.5 * _max_abs(f32[0], want[0])
    if kw.get("with_pgrads"):
        assert _grad_rel(got[1], want[1]) <= 0.5 * _grad_rel(f32[1], want[1])
    for g, w, f in zip(got[2:], want[2:], f32[2:]):
        if isinstance(w, dict):   # scalars: within half the effect or f32 rounding
            for k in ("loss", "energy"):
                d = float(((g[k] - w[k]) / w[k]).abs().max())
                assert d <= max(0.5 * float(((f[k] - w[k]) / w[k]).abs().max()), 1e-5)
        elif isinstance(w, tuple):   # Adam moments
            assert _max_abs(g, w) <= 0.5 * _max_abs(f, w)
        else:   # captures
            assert _max_abs([g], [w]) <= 0.5 * _max_abs([f], [w])


@pytest.mark.cuda
def test_bf16_output_pc_site_matches_plain_version(cuda_device):
    params, latents = _output_pc_case(FID, 37, cuda_device)
    kw = dict(BF16_CHAIN, output_var=0.5, loss="none", capture_stride=6)
    got = chain_mod.mcpc_chain(params, latents, None, 9, bf16_matmul=True, **kw)
    want = chain_mod.mcpc_chain_reference(params, latents, None, 9, bf16_matmul=True, **kw)
    f32 = chain_mod.mcpc_chain_reference(params, latents, None, 9, **kw)
    assert len(got[0]) == 4
    assert _max_abs(got[0], want[0]) <= 0.5 * _max_abs(f32[0], want[0])
    assert _grad_rel(got[1], want[1]) <= 0.5 * _grad_rel(f32[1], want[1])
    for i in (2, 3):   # traj, traj3
        assert _max_abs([got[i]], [want[i]]) <= 0.5 * _max_abs([f32[i]], [want[i]])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [18, 10, 4, 2])
def test_bf16_every_built_row_count_takes_the_output_pc_site(cuda_device, rows):
    """The output-PC site with a warm Adam phase and gradients, forced onto
    each row count of the bf16 build's options instantiation, by rule (ii)."""
    params, latents = _output_pc_case(FID, 37, cuda_device)
    kw = dict(BF16_CHAIN, output_var=0.5, loss="none")
    c = chain_mod._chain_args(params, latents, None, 9, bf16_matmul=True, **kw)
    plan = chain_mod.device_plan(c, 37, cuda_device, (rows,))
    assert plan.rows == rows
    before = chain_mod.mcpc_chain.launches_bf16
    got = chain_mod._kernel(c, params, latents, None, plan=plan)
    torch.cuda.synchronize()
    assert chain_mod.mcpc_chain.launches_bf16 == before + 1
    want = chain_mod.mcpc_chain_reference(params, latents, None, 9, bf16_matmul=True, **kw)
    f32 = chain_mod.mcpc_chain_reference(params, latents, None, 9, **kw)
    assert len(got[0]) == 4
    assert _max_abs(got[0], want[0]) <= 0.5 * _max_abs(f32[0], want[0])
    assert _grad_rel(got[1], want[1]) <= 0.5 * _grad_rel(f32[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_bf16_chain_in_four_waves_matches_plain_version(cuda_device, packed):
    """B = 1024: 57 clusters of 18 rows, four waves, the last cluster with pad
    rows, by rule (ii)."""
    kw = BF16_CASES["relu"] if packed else BF16_CASES["unpacked"]
    params, latents, target = _case(FID, 1024, cuda_device)
    c = chain_mod._chain_args(params, latents, target, 9, bf16_matmul=True, **kw)
    assert chain_mod.device_plan(c, 1024, cuda_device).clusters == 57
    got = chain_mod.mcpc_chain(params, latents, target, 9, bf16_matmul=True, **kw)
    want = chain_mod.mcpc_chain_reference(params, latents, target, 9, bf16_matmul=True, **kw)
    f32 = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    assert _max_abs(got[0], want[0]) <= 0.5 * _max_abs(f32[0], want[0])
    assert _grad_rel(got[1], want[1]) <= 0.5 * _grad_rel(f32[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["training", "output_pc"])
def test_two_bf16_runs_are_bit_identical(cuda_device, case):
    """The tensor-core products and the rank-order sums leave nothing to the
    blocks' timing: a training chain (warm, gradients, scalars) and the
    output-PC site give the same bits twice."""
    if case == "training":
        params, latents, target = _case(FID, 250, cuda_device)
        kw = dict(T=30, mixing=10, warm_T=10, warm_lr=0.7, lr=0.1, with_pgrads=True,
                  return_scalars=True, bf16_matmul=True)
    else:
        (params, latents), target = _output_pc_case(FID, 37, cuda_device), None
        kw = dict(BF16_CHAIN, output_var=0.5, loss="none", capture_stride=6,
                  bf16_matmul=True)
    a = chain_mod.mcpc_chain(params, latents, target, 5, **kw)
    b = chain_mod.mcpc_chain(params, latents, target, 5, **kw)
    for u, v in zip(a[0], b[0]):
        assert torch.equal(u, v)
    for g, h in zip(a[1], b[1]):
        assert torch.equal(g["w"], h["w"]) and torch.equal(g["b"], h["b"])
    for x, y in zip(a[2:], b[2:]):
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x)
        else:
            assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("name,bf16", [("mcpc_chain", False), ("mcpc_chain", True),
                                       ("mcpc_chain_unpacked", False),
                                       ("mcpc_chain_unpacked", True)])
def test_bf16_libraries_run_their_products_on_the_tensor_cores(cuda_device, name, bf16):
    """Every chain kernel of the bf16 libraries holds tensor-core products
    (HMMA: the forward, backward and Hebbian tiles), all in the BF16 forms;
    the f32 libraries hold none, and no other function of any library does
    (cuobjdump -sass of the built libraries)."""
    from montecarlopredictivecoding_tpu_torch.ops import _build

    lib = _build.build(name, bf16)
    every = _build.sass_counts(lib, "HMMA")
    forms = [_build.sass_counts(lib, op) for op in ("HMMA.16816.F32.BF16", "HMMA.1688.F32.BF16")]
    chains = [f for f in every if "mcpc_chain_kernel" in f]
    assert len(chains) == (16 if name == "mcpc_chain" else 4)
    for f in chains:
        if bf16:
            assert every[f] >= 3, (f, every[f])
            assert every[f] == sum(c[f] for c in forms), (f, every[f])
        else:
            assert every[f] == 0, (f, every[f])
    assert not any(n for f, n in every.items() if "mcpc_chain_kernel" not in f)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [18, 10, 4, 2])
def test_every_built_row_count_takes_tanh_with_the_output_pc_site(cuda_device, rows):
    """tanh and the output-PC site together, a warm Adam phase, then Langevin
    steps with noise, gradients and captures, forced onto each row count of
    the f32 options instantiation, B = 37 (pad rows in the last cluster)."""
    params, latents = _output_pc_case(FID, 37, cuda_device)
    kw = dict(activation="tanh", output_var=0.5, loss="none", lr=0.03, warm_T=6,
              T=15, mixing=5, with_pgrads=True, capture_stride=3, return_scalars=True)
    c = chain_mod._chain_args(params, latents, None, 9, **kw)
    plan = chain_mod.device_plan(c, 37, cuda_device, (rows,))
    assert plan.rows == rows
    before = chain_mod.mcpc_chain.launches
    got = chain_mod._kernel(c, params, latents, None, plan=plan)
    torch.cuda.synchronize()
    assert chain_mod.mcpc_chain.launches == before + 1
    want = chain_mod.mcpc_chain_reference(params, latents, None, 9, **kw)
    assert len(got[0]) == 4
    _assert_same_outputs(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_chain_in_four_waves_matches_plain_version(cuda_device, packed):
    """B = 1024 in f32: 57 clusters of 18 rows, four waves, the last cluster
    with pad rows, with gradients (and, packed, a warm phase)."""
    kw = dict(T=20, lr=0.03, mixing=5, with_pgrads=True)
    if packed:
        kw.update(warm_T=4, return_scalars=True)
    else:
        kw.update(packed=False)
    params, latents, target = _case(FID, 1024, cuda_device)
    c = chain_mod._chain_args(params, latents, target, 9, **kw)
    assert chain_mod.device_plan(c, 1024, cuda_device).clusters == 57
    got = chain_mod.mcpc_chain(params, latents, target, 9, **kw)
    want = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    _assert_same_outputs(got, want)


F32_KINDS = {
    "relu": dict(loss="bernoulli", return_scalars=True),
    "tanh": dict(loss="bernoulli", activation="tanh", return_scalars=True),
    "output_pc": dict(activation="tanh", output_var=0.5, loss="none", capture_stride=3,
                      return_scalars=True),
    "unpacked": dict(loss="bernoulli", packed=False),
}


WIDE = (10, 256, 256, 784)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(F32_KINDS))
@pytest.mark.parametrize("rows,dims", [(18, FID), (10, FID), (10, WIDE), (4, FID), (4, WIDE),
                                       (2, FID), (2, WIDE)])
def test_f32_chains_repeat_bit_for_bit_at_every_built_row_count(cuda_device, rows, dims,
                                                                kind):
    """The f32 build's products (4 columns by half or all of the rows a
    lane, dealt in rounds over the warps) at every built row count, both
    widths, relu, tanh, the output-PC site (tanh) and the unpacked kernel,
    each with gradients: two runs give the same bits, and the chain holds to
    the plain version by this file's tolerances.  B = 37 leaves pad rows in
    the last cluster.  The 256-wide blocks never hold 18 rows (the plan
    gives them 10 at most), and a warm phase runs where the block holds its
    Adam moments too."""
    kw = dict(F32_KINDS[kind], lr=0.03, T=12, mixing=4, with_pgrads=True)
    if kind != "unpacked" and chain_mod.chain_smem_bytes(
            dims, rows, True, 1, kind == "output_pc") <= chain_mod.smem_budget(cuda_device):
        kw["warm_T"] = 4
    if kind == "output_pc":
        params, latents = _output_pc_case(dims, 37, cuda_device)
        target = None
    else:
        params, latents, target = _case(dims, 37, cuda_device)
    c = chain_mod._chain_args(params, latents, target, 9, **kw)
    plan = chain_mod.device_plan(c, 37, cuda_device, (rows,))
    assert plan.rows == rows
    runs = [chain_mod._kernel(c, params, latents, target, plan=plan) for _ in range(2)]
    torch.cuda.synchronize()
    first, second = runs
    for u, v in zip(first[0], second[0]):
        assert torch.equal(u, v)
    for g, h in zip(first[1], second[1]):
        assert torch.equal(g["w"], h["w"]) and torch.equal(g["b"], h["b"])
    for a, b in zip(first[2:], second[2:]):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in ("loss", "energy"))
        elif a is not None:
            assert torch.equal(a, b)
    want = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    _assert_same_outputs(first, want)


# The f32 build hands the partials and act(x) from block to block through
# mbarriers (st.async pushes, each block waiting for the bytes it reads; no
# cluster barrier inside a step).  A hazard the hand-offs leave open (a peer
# overwriting H or P before this block has read it, a push counted in the
# wrong phase) shows as a bit that differs between two runs of one chain, or
# as a chain that leaves the plain version.  So each case runs a long chain
# twice: 500 Adam steps, then 3000 Langevin steps with noise, gradients over
# the last 500.  Over such chains the plain f32 version stays within 1.4e-6
# of float64 in the latents and 2.3e-6 relative in the gradients (on the CPU:
# 37 rows of 20-128-128-784 relu and of the tanh output-PC model, 128 rows
# of 30-256-256-784 tanh), so this file's tolerances hold.
LONG_CHAIN = dict(warm_T=500, warm_lr=0.1, T=3000, lr=0.03, mixing=2500, with_pgrads=True,
                  return_scalars=True)
HANDOFF_CASES = {   # dims, B, the rows forced (None: the plan's), options
    "relu_rows18": (FID, 37, 18, {}),
    "relu_rows10": (FID, 37, 10, {}),
    "relu_rows4": (FID, 37, 4, {}),
    "relu_rows2": (FID, 37, 2, {}),
    "tanh_output_pc": (FID, 37, None, dict(activation="tanh", output_var=0.5, loss="none",
                                          capture_stride=500)),
    # the PC reconstruction model's training plan: 13 clusters of 10 rows,
    # the gradient slice in device memory
    "tanh_30_256_256_784_b128": ((30, 256, 256, 784), 128, None, dict(activation="tanh")),
    # chain (c), the unpacked kernel: Langevin steps only, no scalars
    "unpacked": (FID, 37, None, dict(packed=False, warm_T=0, return_scalars=False)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HANDOFF_CASES))
def test_f32_handoffs_repeat_bit_for_bit_over_long_chains(cuda_device, case):
    dims, B, rows, options = HANDOFF_CASES[case]
    kw = dict(LONG_CHAIN, **options)
    if "output_var" in options:
        params, latents = _output_pc_case(dims, B, cuda_device)
        target = None
    else:
        params, latents, target = _case(dims, B, cuda_device)
    c = chain_mod._chain_args(params, latents, target, 9, **kw)
    plan = chain_mod.device_plan(c, B, cuda_device,
                                 chain_mod.CLUSTER_ROWS if rows is None else (rows,))
    if rows is not None:
        assert plan.rows == rows
    if dims[1] == 256:
        assert (plan.rows, plan.clusters, plan.grads_resident) == (10, 13, False)
    count = "launches" if kw.get("packed", True) else "launches_unpacked"
    before = getattr(chain_mod.mcpc_chain, count)
    runs = [chain_mod._kernel(c, params, latents, target, plan=plan) for _ in range(2)]
    torch.cuda.synchronize()
    assert getattr(chain_mod.mcpc_chain, count) == before + 2
    first, second = runs
    for u, v in zip(first[0], second[0]):
        assert torch.equal(u, v)
    for g, h in zip(first[1], second[1]):
        assert torch.equal(g["w"], h["w"]) and torch.equal(g["b"], h["b"])
    for a, b in zip(first[2:], second[2:]):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in ("loss", "energy"))
        elif a is not None:
            assert torch.equal(a, b)
    want = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    if "capture_stride" in options:
        # The first capture is the warm phase's end state.  There Adam's
        # steps on gradients at rounding size (lr * sign) follow the
        # rounding: the plain f32 version itself sits 8.7e-3 (x) and 1.2e-3
        # (x3) from float64 in a few elements (CPU, this case), and within
        # 1e-5 again from the next capture on.  So the plain version holds
        # the captures, and the loss and energy of each captured step, from
        # the second on; the runs above repeat all of them.
        def later(e):
            if isinstance(e, dict):
                return {k: v[1:] for k, v in e.items()}
            return e[1:] if torch.is_tensor(e) else e
        first, want = (tuple(later(e) for e in out) for out in (first, want))
    _assert_same_outputs(first, want)


# ------------------------------- the unpacked chain on the cluster plan
#
# packed=False runs the cluster kernel with the unpacked noise indexing
# (csrc/mcpc_chain_unpacked.cu): f32 by the tolerances at the top of this
# file, bf16 by rule (i) above, each at the batches whose plans take every
# built row count (2, 2, 4, 10, 18, 18, 18 rows a cluster) and beyond one
# 1024-row tile.
UNPACKED_BATCHES = [1, 19, 37, 100, 250, 256, 1100]
MSE_DIMS = (10, 256, 256, 784)


def _unpacked_call(cuda_device, dims, B, **kw):
    """(kernel result, plain result, plain f32 result or None, plan) of an
    unpacked call with ``kw``; the launch count must rise by one."""
    params, latents, target = _case(dims, B, cuda_device)
    kw = dict(kw, packed=False)
    plan = kw.pop("plan", None)
    bf16 = kw.get("bf16_matmul", False)
    count = "launches_unpacked_bf16" if bf16 else "launches_unpacked"
    c = chain_mod._chain_args(params, latents, target, 9, **kw)
    plan = plan or chain_mod.device_plan(c, B, cuda_device)
    before = getattr(chain_mod.mcpc_chain, count)
    got = chain_mod._kernel(c, params, latents, target, plan=plan)
    torch.cuda.synchronize()
    assert getattr(chain_mod.mcpc_chain, count) == before + 1
    want = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    f32 = (chain_mod.mcpc_chain_reference(params, latents, target, 9,
                                          **dict(kw, bf16_matmul=False)) if bf16 else None)
    return got, want, f32, plan


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B", UNPACKED_BATCHES)
def test_unpacked_cluster_kernel_matches_plain_version(cuda_device, B, bf16):
    if bf16:
        got, want, f32, plan = _unpacked_call(cuda_device, FID, B, bf16_matmul=True,
                                              **BF16_ONE_STEP)
        _assert_one_step(got, want, f32)
    else:
        got, want, _, plan = _unpacked_call(cuda_device, FID, B, T=20, lr=0.03, mixing=5,
                                            with_pgrads=True)
        _assert_same_outputs(got, want)
    assert plan.clusters == -(-B // plan.rows) and plan.grads_resident


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("rows", [18, 10, 4, 2])
def test_unpacked_every_built_row_count_matches_plain_version(cuda_device, rows, bf16):
    """Each of the unpacked library's four kernels, forced by the plan, at
    B = 37 (pad rows in the last cluster) with gradients, and without
    noise and with the Gaussian loss at the odd widths 5-7-9-16."""
    for dims, kw in ((FID, dict(T=12, lr=0.03, mixing=4, with_pgrads=True)),
                     ((5, 7, 9, 16), dict(T=9, lr=0.03, loss="gaussian", with_pgrads=True))):
        params, latents, target = _case(dims, 37, cuda_device)
        if bf16:
            kw = dict(BF16_ONE_STEP, bf16_matmul=True)
        c = chain_mod._chain_args(params, latents, target, 9, packed=False, **kw)
        plan = chain_mod.device_plan(c, 37, cuda_device, (rows,))
        assert plan.rows == rows
        got, want, f32, _ = _unpacked_call(cuda_device, dims, 37, plan=plan, **kw)
        if bf16 and dims == FID:
            _assert_one_step(got, want, f32)
        elif bf16:   # at 5-7-9-16 a step's bf16 effect is near rounding size
            assert _share_within(zip(got[0], want[0]), lambda b: 1e-5) >= 0.98
        else:
            _assert_same_outputs(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B", [37, 256])
def test_unpacked_wide_preset_with_gradients(cuda_device, B, bf16):
    """10-256-256-784: the gradient slice does not fit beside the weights, so
    each thread read-modify-writes its own elements of the partial."""
    kw = dict(T=12, lr=0.03, mixing=4, with_pgrads=True)
    if bf16:
        kw = dict(BF16_ONE_STEP, bf16_matmul=True)
    got, want, f32, plan = _unpacked_call(cuda_device, MSE_DIMS, B, **kw)
    assert not plan.grads_resident
    if bf16:
        _assert_one_step(got, want, f32)
    else:
        _assert_same_outputs(got, want)


def _rms_of(a, b):
    """Root mean square of the differences over every element of two tuples."""
    sq = sum(float(((x.double() - y.double()) ** 2).sum()) for x, y in zip(a, b))
    return (sq / sum(y.numel() for y in b)) ** 0.5


def _relative(ga, gb):
    """Two gradients' tensors, each divided by its largest entry in ``gb``."""
    pairs = [(a[k], b[k]) for a, b in zip(ga, gb) for k in ("w", "b")]
    return ([a / b.abs().max().clamp_min(1e-30) for a, b in pairs],
            [b / b.abs().max().clamp_min(1e-30) for _, b in pairs])


def _double(params, latents, target):
    return (tuple({k: v.double() for k, v in p.items()} for p in params),
            tuple(x.double() for x in latents), target.double())


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B", [37, 256])
def test_packed_wide_preset_warm_start_with_gradients(cuda_device, B, bf16):
    """The mse training chain's route (``train_mcpc(preset="mse")``): the
    packed kernel at 10-256-256-784, 50 Adam steps at lr 0.1, then 60
    Langevin steps with noise and the gradients of the last 40; the gradient
    slice is not resident.  An Adam warm start leaves the chain
    ill-conditioned in f32, so f32 is held to the plain version run in
    float64: the latents at most 1e-4, each gradient tensor at most 2e-5 of
    its largest entry further from it than the plain f32 version
    (``chip_smoke.py``'s phase-1 allowances).  bf16 against the plain bf16
    version by the smoke's two rules: (i) after one Langevin step from the
    same inputs (at least 98% of the latents within 1e-5 and of the
    gradient entries within 2e-6 of their tensor's largest, nothing further
    than half the bf16 effect, the plain f32 version's distance from it),
    and (ii) on the chain, in root mean square: latents and each gradient
    tensor relative to its largest entry within half the effect.  The
    chain's share within (i)'s tolerances and its largest difference are
    printed beside it: after 110 steps the two bf16 chains part on most
    elements, and the largest difference can sit beyond half the effect
    where a sum lands at a bf16 rounding boundary, as the smoke's rule
    says."""
    params, latents, target = _case(MSE_DIMS, B, cuda_device)
    kw = dict(warm_T=50, warm_lr=0.1, T=60, lr=0.03, noise_var=2.0, mixing=20,
              with_pgrads=True, bf16_matmul=bf16)
    c = chain_mod._chain_args(params, latents, target, 9, **kw)
    assert not chain_mod.device_plan(c, B, cuda_device).grads_resident
    count = "launches_bf16" if bf16 else "launches"
    before = getattr(chain_mod.mcpc_chain, count)
    got = chain_mod.mcpc_chain(params, latents, target, 9, **kw)
    torch.cuda.synchronize()
    assert getattr(chain_mod.mcpc_chain, count) == before + 1
    assert not got[1][0]["w"].any()
    if bf16:
        want = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
        f32 = chain_mod.mcpc_chain_reference(params, latents, target, 9,
                                             **dict(kw, bf16_matmul=False))
        pairs = [(x[k], y[k]) for x, y in zip(got[1], want[1]) for k in ("w", "b")]
        seen = {"latents within 1e-5": _share_within(zip(got[0], want[0]), lambda b: 1e-5),
                "gradient entries within 2e-6 of their largest": _share_within(
                    pairs, lambda b: 2e-6 * b.abs().max()),
                "latents RMS": _rms_of(got[0], want[0]),
                "half the effect (RMS)": 0.5 * _rms_of(f32[0], want[0]),
                "gradients RMS": _rms_of(*_relative(got[1], want[1])),
                "half the gradients' effect (RMS)": 0.5 * _rms_of(*_relative(f32[1], want[1])),
                "latents largest": _max_abs(got[0], want[0]),
                "half the effect (largest)": 0.5 * _max_abs(f32[0], want[0]),
                "gradients largest": _grad_rel(got[1], want[1]),
                "half the gradients' effect (largest)": 0.5 * _grad_rel(f32[1], want[1])}
        print(f"B={B} bf16: {seen}")
        assert seen["latents RMS"] <= seen["half the effect (RMS)"], seen
        assert seen["gradients RMS"] <= seen["half the gradients' effect (RMS)"], seen
        one = dict(BF16_ONE_STEP)
        assert not chain_mod.device_plan(chain_mod._chain_args(
            params, latents, target, 9, bf16_matmul=True, **one), B, cuda_device).grads_resident
        _assert_one_step(
            chain_mod.mcpc_chain(params, latents, target, 9, bf16_matmul=True, **one),
            chain_mod.mcpc_chain_reference(params, latents, target, 9, bf16_matmul=True, **one),
            chain_mod.mcpc_chain_reference(params, latents, target, 9, **one))
        return
    ref = chain_mod.mcpc_chain_reference(params, latents, target, 9, **kw)
    ref64 = chain_mod.mcpc_chain_reference(*_double(params, latents, target), 9, **kw)
    assert _max_abs(got[0], ref64[0]) <= _max_abs(ref[0], ref64[0]) + 1e-4
    assert _grad_rel(got[1], ref64[1]) <= _grad_rel(ref[1], ref64[1]) + 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dims", [FID, MSE_DIMS])
def test_two_unpacked_runs_are_bit_identical(cuda_device, dims, bf16):
    params, latents, target = _case(dims, 250, cuda_device)
    kw = dict(T=30, lr=0.03, mixing=10, with_pgrads=True, packed=False, bf16_matmul=bf16)
    a = chain_mod.mcpc_chain(params, latents, target, 5, **kw)
    b = chain_mod.mcpc_chain(params, latents, target, 5, **kw)
    for u, v in zip(a[0], b[0]):
        assert torch.equal(u, v)
    for g, h in zip(a[1], b[1]):
        assert torch.equal(g["w"], h["w"]) and torch.equal(g["b"], h["b"])


@pytest.mark.cuda
@pytest.mark.parametrize("dims", [FID, MSE_DIMS, (5, 7, 9, 16)])
def test_unpacked_plan_agrees_with_its_library(cuda_device, dims):
    lib = chain_mod._library(packed=False)
    for with_pgrads in (False, True):
        params, latents, target = _case(dims, 256, cuda_device)
        c = chain_mod._chain_args(params, latents, target, 0, T=2, lr=0.1, packed=False,
                                  with_pgrads=with_pgrads)
        plan = chain_mod.device_plan(c, 256, cuda_device)
        assert plan == chain_mod.chain_plan(
            dims, 256, warm=False, with_pgrads=with_pgrads,
            budget=chain_mod.smem_budget(cuda_device, packed=False),
            max_clusters=chain_mod.max_active_clusters(cuda_device, packed=False))
        grads = (2 if plan.grads_resident else 1) if with_pgrads else 0
        assert lib.mcpc_chain_unpacked_smem_bytes(*dims, plan.rows, grads) == plan.smem_bytes
        assert chain_mod.max_active_clusters(cuda_device, plan, packed=False) >= 1
        if dims == FID and chain_mod.max_active_clusters(cuda_device, packed=False) == 15:
            assert (plan.rows, plan.clusters) == (18, 15)


@pytest.mark.cuda
def test_unpacked_launch_refuses_a_plan_it_was_not_sized_for(cuda_device):
    import dataclasses
    params, latents, target = _case(FID, 8, cuda_device)
    c = chain_mod._chain_args(params, latents, target, 0, T=2, lr=0.1, packed=False)
    plan = chain_mod.device_plan(c, 8, cuda_device)
    before = chain_mod.mcpc_chain.launches_unpacked
    with pytest.raises(RuntimeError, match="launch failed"):
        chain_mod._kernel(c, params, latents, target,
                          plan=dataclasses.replace(plan, smem_bytes=plan.smem_bytes + 4))
    uneven = ((0, 20),) + ((20, 20),) * 7
    with pytest.raises(RuntimeError, match="launch failed"):
        chain_mod._kernel(c, params, latents, target, plan=dataclasses.replace(
            plan, slices=(uneven,) + plan.slices[1:]))
    assert chain_mod.mcpc_chain.launches_unpacked == before
    chain_mod._kernel(c, params, latents, target, plan=plan)
    assert chain_mod.mcpc_chain.launches_unpacked == before + 1


# ------------------------------------------------- the per-op probe


@pytest.mark.cuda
@pytest.mark.parametrize("name", probe.VARIANTS)
def test_op_probe_matches_plain_version(cuda_device, name):
    """Each variant at B=256 and 64 against its plain version on the card
    (``probe.card_tolerance``): over 64 steps from 0.3, and over 5 and 13
    steps from the signed start (the loop's remainder, and where |x| and
    x < 0 still show); the random ones at noise scale 1, where a wrong draw
    shows, and at the probe's 1e-6."""
    for B in (256, 64):
        for x0, steps in ((None, 64), (probe.signed_start(B, 11, cuda_device), 5),
                          (probe.signed_start(B, 11, cuda_device), 13)):
            for scale in ((1.0, 1e-6) if name in probe.RANDOM_VARIANTS else (1e-6,)):
                before = probe.run_variant.launches
                got = probe.run_variant(name, B, steps, 11, noise_scale=scale, x0=x0)
                torch.cuda.synchronize()
                assert probe.run_variant.launches == before + 1
                want = probe.run_variant_reference(name, B, steps, 11, cuda_device,
                                                   noise_scale=scale, x0=x0)
                assert got.shape == (B, probe.COLS) and bool(torch.isfinite(got).all())
                assert float((got - want).abs().max()) <= probe.card_tolerance(name, want)


@pytest.mark.cuda
def test_op_probe_sincos_2pi_matches_plain_version(cuda_device):
    u = torch.linspace(0.0, 0.999999, probe.SINCOS_POINTS, device=cuda_device)
    before = probe.device_sincos_2pi.launches
    for got, want in zip(probe.device_sincos_2pi(u), sincos_2pi(u)):
        assert float((got - want).abs().max()) <= probe.SINCOS_ATOL
    assert probe.device_sincos_2pi.launches == before + 1
    assert probe.sincos_errors()["device_vs_plain"] <= probe.SINCOS_ATOL


@pytest.mark.cuda
def test_op_probe_refuses_what_it_does_not_take(cuda_device):
    before = probe.run_variant.launches
    with pytest.raises(ValueError, match="unknown variant"):
        probe.run_variant("nope", 8, 4, 0)
    with pytest.raises(ValueError, match="float32"):
        probe.device_sincos_2pi(torch.zeros(4, dtype=torch.float64, device=cuda_device))
    assert probe.run_variant.launches == before
    assert torch.equal(probe.run_variant("baseline", 3, 0, 0),
                       torch.full((3, probe.COLS), probe.X0, device=cuda_device))
