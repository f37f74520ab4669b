"""The plain chain version draws its counter-hash noise in batches: both
draws of a Langevin step pair in one call, and the unpacked chain's three
latents side by side.  Each element takes the same integer and float
operations as when drawn alone, so the normals are the same bits as the
one-draw-a-call form written out here."""

import importlib

import pytest
import torch

import montecarlopredictivecoding_tpu_torch as mt

chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

torch.set_num_threads(1)


def _call(dims, B, seed, **kw):
    g = torch.Generator().manual_seed(2)
    model = mt.make_mlp_model(*dims)
    params = model.init(g, device="cpu")
    latents = model.init_latents(params, torch.zeros(B, dims[0]), g)
    return chain._chain_args(params, latents, None, seed, T=3, lr=0.1, noise_var=2.0,
                             loss="none", **kw)


def _one_latent_at_a_time(c, B, t):
    """Step ``t``'s unpacked normals, each latent's grid drawn by itself."""
    rows = torch.arange(B, dtype=torch.int64)
    parts = []
    for layer, d in enumerate(c.dims[:3]):
        half = (d + 1) // 2
        idx = rows[:, None] * half + torch.arange(half, dtype=torch.int64)[None, :]
        zc, zs = chain.box_muller(chain.counter_bits_at(idx, c.seed, 6 * t + 2 * layer),
                                  chain.counter_bits_at(idx, c.seed, 6 * t + 2 * layer + 1))
        parts.append(torch.cat([zc, zs], dim=1)[:, :d])
    return torch.cat(parts, dim=1)


@pytest.mark.parametrize("dims,B", [((5, 7, 9, 16), 19), ((20, 128, 128, 784), 37),
                                    ((10, 256, 256, 784), 3), ((1, 2, 3, 4), 1)])
@pytest.mark.parametrize("seed", [0, -3, 2**31 - 2])
def test_unpacked_normals_side_by_side_are_each_latents_own(dims, B, seed):
    c = _call(dims, B, seed, packed=False)
    for t in (0, 1, 7, 4999):
        want = _one_latent_at_a_time(c, B, t)
        got = chain._unpacked_normals(c, B, t, "cpu")
        assert got.shape == (B, sum(dims[:3]))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("dims,B,tile", [((20, 128, 128, 784), 37, None),
                                         ((4, 16, 16, 32), 24, 8)])
def test_a_step_pairs_draws_in_one_call_are_two_calls_bits(dims, B, tile):
    kw = {} if tile is None else {"batch_tile": tile}
    c = _call(dims, B, 11, **kw)
    idx, seeds = chain._noise_index(c, B, "cpu")
    pair = torch.arange(2, dtype=torch.int64)[:, None, None]
    for p in (0, 1, 250):
        both = chain.counter_bits_at(idx[None], seeds[None], 2 * p + pair)
        assert torch.equal(both[0], chain.counter_bits_at(idx, seeds, 2 * p))
        assert torch.equal(both[1], chain.counter_bits_at(idx, seeds, 2 * p + 1))
