"""The unpacked chain (``packed=False``, the JAX package's ``_make_kernel``) on
the cluster kernel's plan: the host side of it, on the CPU.

The kernel itself (``ops/csrc/mcpc_chain_unpacked.cu`` on
``ops/csrc/mcpc_cluster.cuh``) runs only on the card
(``tests/test_torch_kernel_cuda.py``, ``chip_smoke.py``).  Here:

* ``unpacked_noise_site``, the Python mirror of the kernel's per-element
  noise index, against ``_unpacked_normals`` (the plain version's noise, held
  against ``mcpc_chain_pallas(packed=False, interpret=True)`` in
  ``tests/test_torch_mcpc_chain.py``), bit for bit, walked the way the
  kernel walks it: rank by rank over the plan's slices, from the global
  column;
* the plan an unpacked call takes, and its shared memory against a
  transcription of ``make_layout``;
* the plain version at B=1100 (one tile, the seed unshifted) against the
  interpret kernel.
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
from montecarlopredictivecoding_tpu_torch.utils import latents_from_numpy, params_from_numpy

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

torch.set_num_threads(1)

FID, MSE = (20, 128, 128, 784), (10, 256, 256, 784)
# what an H100 gives the kernel: 227 KB a block less its static shared
# memory, and 15 clusters of 8 blocks at once
BUDGET, MAX_CLUSTERS = 232448 - 128, 15


def _call(dims, B, seed=5, **kw):
    """A validated unpacked call on zero CPU tensors of the right shapes."""
    params = mt.make_mlp_model(*dims).init(torch.Generator().manual_seed(0), device="cpu")
    latents = tuple(torch.zeros(B, d) for d in dims[:3])
    return chain_mod._chain_args(params, latents, None, seed, T=1, lr=0.1,
                                 packed=False, **kw)


def _site_normals(c, rows, t):
    """The normals ``[len(rows), d0 + d1 + d2]`` of step ``t`` as the kernel
    draws them: for each rank of the cluster, each own column of each
    latent, the site of the global column ``lo + j``."""
    plan = chain_mod.chain_plan(c.dims, max(rows) + 1, warm=False, with_pgrads=False,
                                budget=BUDGET, max_clusters=MAX_CLUSTERS)
    starts = np.cumsum((0,) + c.dims[:2])
    n = sum(c.dims[:3])
    offs = np.zeros((len(rows), n), np.int64)
    idx = np.zeros((len(rows), n), np.int64)
    take_sin = np.zeros((len(rows), n), bool)
    seen = np.zeros(n, np.int64)
    for layer in range(3):
        for lo, hi in plan.slices[layer]:   # one rank's slice
            for j in range(hi - lo):
                col = lo + j
                seen[starts[layer] + col] += 1
                for i, row in enumerate(rows):
                    o, e, s = chain_mod.unpacked_noise_site(c.dims, row, layer, col)
                    offs[i, starts[layer] + col] = o
                    idx[i, starts[layer] + col] = e
                    take_sin[i, starts[layer] + col] = s
    assert (seen == 1).all()   # the ranks' slices cover every column once
    idx, offs = torch.from_numpy(idx), torch.from_numpy(offs)
    zc, zs = chain_mod.box_muller(chain_mod.counter_bits_at(idx, c.seed, 6 * t + offs),
                                  chain_mod.counter_bits_at(idx, c.seed, 6 * t + offs + 1))
    return torch.where(torch.from_numpy(take_sin), zs, zc)


@pytest.mark.parametrize("dims,B,rows", [
    ((4, 8, 8, 16), 8, None),
    # odd widths: half = 3, 4, 5, and d0 = 5 over 8 ranks leaves three ranks
    # an empty slice, so the cos | sin split crosses slice boundaries
    ((5, 7, 9, 16), 19, None),
    (FID, 6, None),
    # beyond the JAX packed kernel's 1024-row tile: one tile, no seed shift
    (FID, 1101, (0, 1, 17, 1023, 1024, 1025, 1100)),
])
@pytest.mark.parametrize("seed", [5, -3])
def test_noise_site_is_the_plain_versions_noise_bit_for_bit(dims, B, rows, seed):
    c = _call(dims, B, seed=seed)
    assert c.tile == B
    rows = tuple(range(B)) if rows is None else rows
    for t in (0, 1, 7):
        want = chain_mod._unpacked_normals(c, B, t, "cpu")[list(rows)]
        got = _site_normals(c, rows, t)
        assert torch.equal(got, want)


def test_noise_site_by_hand():
    # d = 5: half = 3; column 3 is the sin of grid column 0, column 4 of 1
    dims = (5, 7, 9, 16)
    assert chain_mod.unpacked_noise_site(dims, 2, 0, 1) == (0, 2 * 3 + 1, False)
    assert chain_mod.unpacked_noise_site(dims, 2, 0, 3) == (0, 2 * 3 + 0, True)
    assert chain_mod.unpacked_noise_site(dims, 2, 0, 4) == (0, 2 * 3 + 1, True)
    # x1 (d = 7, half = 4) reads draws 6t + 2, x2 (d = 9, half = 5) 6t + 4
    assert chain_mod.unpacked_noise_site(dims, 1100, 1, 6) == (2, 1100 * 4 + 2, True)
    assert chain_mod.unpacked_noise_site(dims, 0, 2, 4) == (4, 4, False)


@pytest.mark.parametrize("B", [1, 19, 37, 250, 256, 1024, 1100])
@pytest.mark.parametrize("dims", [FID, MSE, (5, 7, 9, 16)])
def test_unpacked_call_takes_the_cluster_plan(dims, B):
    for with_pgrads in (False, True):
        c = _call(dims, B, with_pgrads=with_pgrads)
        options = chain_mod.plan_options(c)
        assert options == dict(warm=False, with_pgrads=with_pgrads, output_pc=False)
        got = chain_mod.chain_plan(dims, B, budget=BUDGET, max_clusters=MAX_CLUSTERS,
                                   **options)
        want = chain_mod.chain_plan(dims, B, warm=False, with_pgrads=with_pgrads,
                                    budget=BUDGET, max_clusters=MAX_CLUSTERS)
        assert got == want
        assert got.clusters * got.rows >= B > (got.clusters - 1) * got.rows
    plan = chain_mod.chain_plan(dims, B, warm=False, with_pgrads=True, budget=BUDGET,
                                max_clusters=MAX_CLUSTERS)
    if B == 256 and dims == FID:   # one wave on 120 SMs
        assert (plan.rows, plan.clusters) == (18, 15)
    # the gradient slice is resident at 20-128-128-784, not at 10-256-256-784
    assert plan.grads_resident == (dims != MSE)


def _make_layout_floats(dims, R, grads):
    """``make_layout`` of ``csrc/mcpc_cluster.cuh`` with no warm phase and no
    output-PC site (what ``mcpc_chain_unpacked_smem_bytes`` asks for),
    transcribed line by line."""
    cs = 8
    d0, d1, d2, D = dims
    N0, N1, N2, ND = ((d + cs - 1) // cs for d in dims)
    own = N0 + N1 + N2

    def slice_stride(width):
        m = (width + 7) // 8
        return 8 * (m | 1)

    ld1, ld2, ld3 = slice_stride(N1), slice_stride(N2), slice_stride(ND)
    n = d0 + d1 + d2
    rp = (R + 3) // 4 * 4 if R // 2 // 4 > 0 else R
    o = 4                  # MB, the step's two mbarriers
    o += n * rp            # H
    o += own * rp          # X
    o += own * rp          # E
    o += ND * rp           # S
    o += cs * own * rp     # P
    o = (o + 3) // 4 * 4   # the slices start at a whole float4
    o += d0 * ld1 + d1 * ld2 + d2 * ld3   # W1, W2, W3
    if grads == 2:
        o += d0 * ld1 + d1 * ld2 + d2 * ld3   # G1, G2, G3
    o += own + ND          # BI
    o += n                 # OT
    if grads:
        o += own + ND      # GB
    return o


@pytest.mark.parametrize("rows", chain_mod.CLUSTER_ROWS)
@pytest.mark.parametrize("dims", [FID, MSE, (5, 7, 9, 16), (4, 8, 8, 16)])
def test_unpacked_plans_shared_memory_is_make_layouts(dims, rows):
    for grads in (0, 1, 2):
        assert (chain_mod.chain_smem_bytes(dims, rows, False, grads)
                == 4 * _make_layout_floats(dims, rows, grads))
    for with_pgrads in (False, True):
        kw = dict(warm=False, with_pgrads=with_pgrads, budget=BUDGET,
                  max_clusters=MAX_CLUSTERS, row_counts=(rows,))
        if 4 * _make_layout_floats(dims, rows, 1 if with_pgrads else 0) > BUDGET:
            # 18 rows at 10-256-256-784 with gradients: the plan takes fewer
            with pytest.raises(ValueError, match="shared memory"):
                chain_mod.chain_plan(dims, 37, **kw)
            continue
        plan = chain_mod.chain_plan(dims, 37, **kw)
        assert plan.rows == rows
        grads = (2 if plan.grads_resident else 1) if with_pgrads else 0
        assert plan.smem_bytes == 4 * _make_layout_floats(dims, rows, grads) <= BUDGET


def test_unpacked_chain_past_one_tile_matches_interpret_kernel():
    """B = 1100: the JAX kernel runs one tile and never shifts the seed; the
    plain version (which the card's kernel is held against) does the same."""
    dims, B = (4, 8, 8, 16), 1100
    jm = mcpc.make_mlp_model(*dims)
    params_np = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(1)
    latents = tuple(rng.uniform(-10, 10, (B, d)).astype(np.float32) for d in dims[:3])
    target = (rng.random((B, dims[3])) > 0.5).astype(np.float32)
    kw = dict(T=3, lr=0.03, mixing=1, with_pgrads=True, packed=False)
    jout = mcpc_chain_pallas(params_np, tuple(jnp.asarray(x) for x in latents),
                             jnp.asarray(target), jnp.int32(7), interpret=True, **kw)
    tout = chain_mod.mcpc_chain(params_from_numpy(params_np, "cpu"),
                                latents_from_numpy(latents, "cpu"),
                                torch.from_numpy(target), 7, **kw)
    for a, b in zip(tout[0], jout[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    for tg, jg in zip(tout[1], jout[1]):
        for k in ("w", "b"):
            ref = np.asarray(jg[k])
            scale = max(float(np.abs(ref).max()), 1e-30)
            np.testing.assert_allclose(tg[k].numpy(), ref, rtol=0, atol=2e-6 * scale)
