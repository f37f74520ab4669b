"""The packed chain kernel's plan (``ops/mcpc_chain.chain_plan``): how a call
is mapped onto thread-block clusters.  Everything here is host code and runs
on the CPU; the kernel itself is held against its plain version on the card
(``tests/test_torch_kernel_cuda.py``, ``chip_smoke.py``).

The last test emulates the kernel's order of summation in plain PyTorch (the
backward products summed slice by slice, in rank order) and holds it to the
plain version at atol 1e-5: both are f32 and differ only in the order of
sums of a few dozen terms of order 1 (measured: about 1e-6).
"""

import importlib

import pytest
import torch

import montecarlopredictivecoding_tpu_torch as mt

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

torch.set_num_threads(1)

FID, MSE = (20, 128, 128, 784), (10, 256, 256, 784)
# what an H100 gives the kernel: 227 KB a block less its static shared
# memory, and 15 clusters of 8 blocks at once
BUDGET, MAX_CLUSTERS = 232448 - 128, 15


def _plan(dims, B, warm=False, with_pgrads=False, budget=BUDGET, max_clusters=MAX_CLUSTERS):
    return chain_mod.chain_plan(dims, B, warm=warm, with_pgrads=with_pgrads,
                                budget=budget, max_clusters=max_clusters)


@pytest.mark.parametrize("B", [1, 8, 37, 250, 256, 4096])
@pytest.mark.parametrize("dims", [FID, MSE, (4, 8, 8, 16), (10, 128, 128, 784),
                                  (4, 128, 128, 784)])
def test_plan_covers_every_column_once_and_fits(dims, B):
    for warm in (False, True):
        for with_pgrads in (False, True):
            plan = _plan(dims, B, warm, with_pgrads)
            assert plan.cluster_size == chain_mod.CLUSTER_SIZE == 8
            assert plan.rows in chain_mod.CLUSTER_ROWS
            assert plan.clusters == -(-B // plan.rows)
            assert plan.blocks == plan.clusters * 8
            assert len(plan.slices) == 4
            for d, slices in zip(dims, plan.slices):
                assert len(slices) == 8
                assert slices[0][0] == 0 and slices[-1][1] == d
                widths = [hi - lo for lo, hi in slices]
                assert all(w >= 0 for w in widths)
                assert max(widths) - min(widths) <= 1
                # contiguous and in order: each slice starts where the last ended
                assert all(slices[k][1] == slices[k + 1][0] for k in range(7))
            grads = (2 if plan.grads_resident else 1) if with_pgrads else 0
            assert plan.smem_bytes == chain_mod.chain_smem_bytes(
                dims, plan.rows, warm, grads)
            assert plan.smem_bytes <= BUDGET
            assert plan.grads_resident <= with_pgrads


@pytest.mark.parametrize("d,expect", [
    (784, [(98 * k, 98 * (k + 1)) for k in range(8)]),
    (20, [(0, 3), (3, 6), (6, 9), (9, 12), (12, 14), (14, 16), (16, 18), (18, 20)]),
    (10, [(0, 2), (2, 4), (4, 5), (5, 6), (6, 7), (7, 8), (8, 9), (9, 10)]),
    # narrower than the cluster: the last ranks get an empty slice
    (4, [(0, 1), (1, 2), (2, 3), (3, 4), (4, 4), (4, 4), (4, 4), (4, 4)]),
])
def test_column_slices(d, expect):
    assert list(chain_mod.column_slices(d)) == expect


def test_plan_fills_the_card_at_the_main_path_batch():
    # 15 clusters at once: 18 rows make B=256 one wave on 120 SMs; 16 rows
    # would leave a sixteenth cluster to a second wave
    for warm, with_pgrads in ((False, False), (True, True)):
        plan = _plan(FID, 256, warm, with_pgrads)
        assert (plan.rows, plan.clusters) == (18, 15)
        assert plan.grads_resident == with_pgrads
    # in between, the row count that fills one wave
    assert (_plan(FID, 128).rows, _plan(FID, 128).clusters) == (10, 13)
    assert (_plan(FID, 37).rows, _plan(FID, 37).clusters) == (4, 10)
    # a batch of many waves takes the most rows
    assert _plan(FID, 4096).rows == 18
    # the wide preset's gradients do not fit beside its weights
    wide = _plan(MSE, 256, True, True)
    assert not wide.grads_resident and wide.smem_bytes <= BUDGET
    # a small batch takes few rows a cluster, and so more SMs
    assert _plan(FID, 8).rows == 2 and _plan(FID, 8).clusters == 4
    assert _plan(FID, 1).clusters == 1
    text = _plan(FID, 256, True, True).describe(MAX_CLUSTERS)
    assert "18 rows a cluster" in text and "120 SMs at work" in text
    assert "gradient slice resident" in text


# The bf16 build's layout (make_layout<true>), worked out from the kernel's
# header: the bf16 arrays first, then the f32 ones of the f32 layout but
# act(X) and the weight slices.  At FID, 18 rows, warm, gradients resident:
#   bf16 (2 bytes): act(X) (32 + 128 + 128 rows, each layer padded to 16) x
#     24 (18 rows padded to 24, 8 * odd) = 6912; err1 | err2 | S (16 + 16 +
#     112) x 24 = 3456; weight slices 32 x 24 + 128 x 24 + 128 x 120 = 19200
#     -> 29568 x 2 = 59136
#   f32 (4 bytes), pitch 20: X, E, M, V 4 x 35 x 20 = 2800; S 98 x 20 = 1960;
#     P 8 x 35 x 20 = 5600; biases 35 + 98 = 133; owners 276; gradient
#     slices 20 x 24 + 128 x 24 + 128 x 104 = 16864; bias gradients 133
#     -> 27766 x 4 = 111064
#   170200 in all.
# The f32 build's layout (make_layout<false>): the f32 arrays of the bf16
# layout, with act(X) at the row pitch (20 at 18 rows, 12 at 10, 4 at 4) and
# the weight slices at their 8 * odd strides (20 x 24 + 128 x 24 + 128 x
# 104 = 16864 at FID), and before them all the step's two mbarriers, 4
# floats.  At FID, 18 rows:
#   X, E 2 x 35 x 20 = 1400; S 98 x 20 = 1960; P 8 x 35 x 20 = 5600;
#   biases 133; owners 276; act(X) 276 x 20 = 5520; weights 16864 -> 31753
#   floats, 31757 with the barriers, 127028 B; warm: M, V 2 x 35 x 20 =
#   1400; gradients resident: 16864 + 133 -> 50150 floats + 4, 200616 B; an
#   output-PC site adds X3, M3, V3 3 x 98 x 20 = 5880 -> 56030 + 4, 224136 B
#   (no gradients: 39033 + 4, 156148 B).
#   10 rows: 2 x 35 x 12 + 98 x 12 + 8 x 35 x 12 + 133 + 276 + 276 x 12 +
#   16864 = 25961 floats + 4, 103860 B; warm, gradients resident: + 2 x 420
#   + 16864 + 133 -> 43798 + 4, 175208 B.
#   4 rows, warm, bias gradients only: 4 x 35 x 4 + 98 x 4 + 8 x 35 x 4 +
#   133 + 276 + 133 + 276 x 4 + 16864 = 20582 floats + 4, 82344 B.
#   MSE, 10 rows, warm, bias gradients only: X, E, M, V 4 x 66 x 12 = 3168;
#   S 98 x 12 = 1176; P 8 x 66 x 12 = 6336; biases 164; owners 522; bias
#   gradients 164; act(X) 522 x 12 = 6264; weights 10 x 40 + 256 x 40 + 256
#   x 104 = 37264 -> 55058 floats + 4, 220248 B.
#   The tanh mse preset 30-256-256-784, 10 rows, warm: X, E, M, V 4 x 68 x
#   12 = 3264; S 1176; P 8 x 68 x 12 = 6528; biases 166; owners 542; act(X)
#   542 x 12 = 6504; weights 30 x 40 + 256 x 40 + 256 x 104 = 38064 -> 56244
#   floats + 4, 224992 B.
@pytest.mark.parametrize("dims,rows,warm,grads,output_pc,bf16,expect", [
    # as the kernel's own layout function gave them on the card
    (FID, 18, False, 0, False, False, 127028),
    (FID, 18, True, 2, False, False, 200616),
    # worked out above from the kernel's layout function
    (FID, 18, True, 2, True, False, 224136),
    (FID, 18, True, 0, True, False, 156148),
    (FID, 10, False, 0, False, False, 103860),
    (FID, 10, True, 2, False, False, 175208),
    (FID, 4, True, 1, False, False, 82344),
    (MSE, 10, True, 1, False, False, 220248),
    ((30, 256, 256, 784), 10, True, 0, False, False, 224992),
    (FID, 18, False, 0, False, True, 96612),
    (FID, 18, False, 0, True, True, 104452),
    (FID, 18, False, 1, False, True, 97144),
    (FID, 18, False, 1, True, True, 104984),
    (FID, 18, False, 2, False, True, 164600),
    (FID, 18, False, 2, True, True, 172440),
    (FID, 18, True, 0, False, True, 102212),
    (FID, 18, True, 0, True, True, 125732),
    (FID, 18, True, 1, False, True, 102744),
    (FID, 18, True, 1, True, True, 126264),
    (FID, 18, True, 2, False, True, 170200),
    (FID, 18, True, 2, True, True, 193720),
    (FID, 2, False, 0, False, True, 50532),
    (FID, 2, False, 0, True, True, 51316),
    (FID, 2, False, 1, False, True, 51064),
    (FID, 2, False, 1, True, True, 51848),
    (FID, 2, False, 2, False, True, 118520),
    (FID, 2, False, 2, True, True, 119304),
    (FID, 2, True, 0, False, True, 51092),
    (FID, 2, True, 0, True, True, 53444),
    (FID, 2, True, 1, False, True, 51624),
    (FID, 2, True, 1, True, True, 53976),
    (FID, 2, True, 2, False, True, 119080),
    (FID, 2, True, 2, True, True, 121432),
    (MSE, 18, False, 0, False, True, 180376),
    (MSE, 18, False, 0, True, True, 188216),
    (MSE, 18, False, 1, False, True, 181032),
    (MSE, 18, False, 1, True, True, 188872),
    (MSE, 18, False, 2, False, True, 330088),
    (MSE, 18, False, 2, True, True, 337928),
    (MSE, 18, True, 0, False, True, 190936),
    (MSE, 18, True, 0, True, True, 214456),
    (MSE, 18, True, 1, False, True, 191592),
    (MSE, 18, True, 1, True, True, 215112),
    (MSE, 18, True, 2, False, True, 340648),
    (MSE, 18, True, 2, True, True, 364168),
    (MSE, 2, False, 0, False, True, 103272),
    (MSE, 2, False, 0, True, True, 104056),
    (MSE, 2, False, 1, False, True, 103928),
    (MSE, 2, False, 1, True, True, 104712),
    (MSE, 2, False, 2, False, True, 252984),
    (MSE, 2, False, 2, True, True, 253768),
    (MSE, 2, True, 0, False, True, 104328),
    (MSE, 2, True, 0, True, True, 106680),
    (MSE, 2, True, 1, False, True, 104984),
    (MSE, 2, True, 1, True, True, 107336),
    (MSE, 2, True, 2, False, True, 254040),
    (MSE, 2, True, 2, True, True, 256392),
])
def test_shared_memory_formula_is_the_kernels(dims, rows, warm, grads, output_pc, bf16,
                                              expect):
    assert chain_mod.chain_smem_bytes(dims, rows, warm, grads, output_pc, bf16) == expect


def test_bf16_plan_keeps_the_main_path_on_one_wave_with_resident_gradients():
    # the bf16 layout is smaller than the f32 one, so the training chain's
    # plan is the f32 plan: 15 clusters of 18 rows, the gradient slice resident
    plan = chain_mod.chain_plan(FID, 256, warm=True, with_pgrads=True, budget=BUDGET,
                                max_clusters=MAX_CLUSTERS, bf16=True)
    assert (plan.rows, plan.clusters, plan.grads_resident) == (18, 15, True)
    assert plan.smem_bytes == 170200 < _plan(FID, 256, True, True).smem_bytes
    chain = chain_mod.chain_plan(FID, 256, warm=False, with_pgrads=False, budget=BUDGET,
                                 max_clusters=MAX_CLUSTERS, bf16=True)
    assert (chain.rows, chain.clusters, chain.smem_bytes) == (18, 15, 96612)


def test_f32_plan_keeps_the_main_path_on_one_wave_with_resident_gradients():
    # the training chain takes one wave of 15 clusters of 18 rows with the
    # gradient slice in shared memory, and the wide preset's B=1024 10 rows
    # a cluster (7 waves)
    plan = _plan(FID, 256, True, True)
    assert (plan.rows, plan.clusters, plan.grads_resident) == (18, 15, True)
    assert plan.smem_bytes == 200616
    wide = _plan(MSE, 1024, True, True)
    assert (wide.rows, wide.clusters, wide.grads_resident) == (10, 103, False)
    assert wide.smem_bytes == 220248
    # and the tanh one's table-1 batch, 10 rows in 7 waves too
    tanh_wide = _plan((30, 256, 256, 784), 1024, True, False)
    assert (tanh_wide.rows, tanh_wide.clusters) == (10, 103)


@pytest.mark.parametrize("dims,B,warm,with_pgrads,expect", [
    # the training chain: 15 clusters of 18 rows, the gradient slice resident
    (FID, 256, True, True, (18, 15, True)),
    # figure 5b's posterior chain: its warm start, then its Langevin phase
    (FID, 256, True, False, (18, 15, False)),
    (FID, 256, False, False, (18, 15, False)),
    # table 1's MSE column: 10 rows a cluster in waves
    (MSE, 1024, True, False, (10, 103, False)),
    # the PC reconstruction model's training: the plan nearest the budget
    ((30, 256, 256, 784), 128, True, True, (10, 13, False)),
])
def test_step_barriers_leave_the_cells_plans_as_they_were(dims, B, warm, with_pgrads,
                                                          expect):
    """The f32 layout's two mbarriers (the step's hand-offs) cost a block 16
    bytes: every call the benchmark's cells make keeps its rows,
    clusters and resident gradients, and its blocks fit the f32 library's
    budget, the most crowded (30-256-256-784 at 10 rows) with room to spare."""
    plan = _plan(dims, B, warm, with_pgrads)
    assert (plan.rows, plan.clusters, plan.grads_resident) == expect
    grads = (2 if plan.grads_resident else 1) if with_pgrads else 0
    need = chain_mod.chain_smem_bytes(dims, plan.rows, warm, grads)
    assert plan.smem_bytes == need <= BUDGET
    # every option the plan turns down for want of room (more rows, the
    # gradient slice resident) would not fit without the barriers either
    for rows in chain_mod.CLUSTER_ROWS:
        for g in ((2, 1) if with_pgrads else (0,)):
            other = chain_mod.chain_smem_bytes(dims, rows, warm, g)
            assert other <= BUDGET or other - 16 > BUDGET


def test_slice_bounds_are_what_the_kernel_takes():
    # per layer: the first column of each of the 8 slices, then the width
    bounds = _plan((4, 8, 8, 16), 5).slice_bounds()
    assert bounds == [0, 1, 2, 3, 4, 4, 4, 4, 4,
                      0, 1, 2, 3, 4, 5, 6, 7, 8,
                      0, 1, 2, 3, 4, 5, 6, 7, 8,
                      0, 2, 4, 6, 8, 10, 12, 14, 16]
    assert _plan(FID, 256).slice_bounds()[:9] == [0, 3, 6, 9, 12, 14, 16, 18, 20]


@pytest.mark.parametrize("rows", chain_mod.CLUSTER_ROWS)
def test_plan_takes_the_row_counts_it_is_given(rows):
    plan = chain_mod.chain_plan(FID, 37, warm=True, with_pgrads=True, budget=BUDGET,
                                max_clusters=MAX_CLUSTERS, row_counts=(rows,))
    assert (plan.rows, plan.clusters) == (rows, -(-37 // rows))
    assert plan.smem_bytes == chain_mod.chain_smem_bytes(
        FID, rows, True, 2 if plan.grads_resident else 1)


def test_plan_refuses_what_cannot_fit():
    with pytest.raises(ValueError, match="shared memory"):
        _plan((20, 4096, 4096, 784), 256)
    with pytest.raises(ValueError, match="shared memory"):
        _plan(FID, 256, budget=48 * 1024)
    with pytest.raises(ValueError, match="at least 1"):
        _plan(FID, 0)
    # a smaller budget first gives up the resident gradients, then rows
    tight = _plan(FID, 256, True, True, budget=160 * 1024)
    assert not tight.grads_resident or tight.rows < 18
    assert tight.smem_bytes <= 160 * 1024


def _sliced_chain(params, latents, target, seed, plan, *, T, lr):
    """A noisy Langevin chain whose backward products are summed as the
    cluster sums them: each rank's partial over its own out-columns, the
    partials added in rank order."""
    c = chain_mod._chain_args(params, latents, target, seed, T=T, lr=lr)
    d0, d1, d2, _ = c.dims
    b0 = params[0]["b"]
    (w1, b1), (w2, b2), (w3, b3) = ((params[i]["w"], params[i]["b"]) for i in (1, 2, 3))
    X = torch.cat(latents, dim=1)
    idx, seeds = chain_mod._noise_index(c, X.shape[0], X.device)

    def in_rank_order(err, w, slices):
        total = None
        for lo, hi in slices:
            part = err[:, lo:hi] @ w[:, lo:hi].T
            total = part if total is None else total + part
        return total

    for t in range(T):
        if t % 2 == 0:
            z_cos, z_sin = chain_mod.box_muller(
                chain_mod.counter_bits_at(idx, seeds, t),
                chain_mod.counter_bits_at(idx, seeds, t + 1))
        x0, x1, x2 = X.split((d0, d1, d2), dim=1)
        h0, h1, h2 = torch.relu(x0), torch.relu(x1), torch.relu(x2)
        e1 = x1 - (h0 @ w1 + b1)
        e2 = x2 - (h1 @ w2 + b2)
        logits = h2 @ w3 + b3
        S = (0.5 + 0.5 * torch.tanh(0.5 * logits)) - target
        back = torch.cat([
            in_rank_order(e1, w1, plan.slices[1]),
            in_rank_order(e2, w2, plan.slices[2]),
            -in_rank_order(S, w3, plan.slices[3]),
        ], dim=1)
        G = torch.cat([x0 - b0, e1, e2], dim=1) - (X > 0).to(X.dtype) * back
        X = X - c.lr * G + c.noise_std * (z_cos if t % 2 == 0 else z_sin)
    return X.split((d0, d1, d2), dim=1)


@pytest.mark.parametrize("dims,B", [((10, 24, 24, 50), 6), ((4, 8, 8, 16), 5)])
def test_rank_order_sums_stay_within_tolerance_of_the_plain_version(dims, B):
    gen = torch.Generator().manual_seed(7)
    model = mt.make_mlp_model(*dims)
    params = model.init(gen, device="cpu")
    latents = model.init_latents(params, torch.zeros(B, dims[0]), gen)
    target = (torch.rand(B, dims[3], generator=gen) > 0.5).float()
    plan = _plan(dims, B)
    got = _sliced_chain(params, latents, target, 5, plan, T=9, lr=0.03)
    want, _ = chain_mod.mcpc_chain_reference(params, latents, target, 5, T=9, lr=0.03)
    moved = max(float((w - x).abs().max()) for w, x in zip(want, latents))
    assert moved > 0.1  # the chain went somewhere, noise included
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-5)
