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


@pytest.mark.parametrize("dims,rows,warm,grads,expect", [
    # as the kernel's own layout function gave them on the card
    (FID, 18, False, 0, 127012),
    (FID, 18, True, 2, 200600),
])
def test_shared_memory_formula_is_the_kernels(dims, rows, warm, grads, expect):
    assert chain_mod.chain_smem_bytes(dims, rows, warm, grads) == expect


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
