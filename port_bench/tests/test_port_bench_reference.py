"""The plain reference against the port's plain CPU version at tiny widths.

The reference imports nothing of the port; here both run on the same
inputs.  In float32 the two differ by the order of their sums only, so they
agree to float32 rounding over a few steps."""

import importlib

import pytest
import torch

from port_bench.lib import common
from port_bench.reference import mcpc as ref

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
DIMS = (4, 8, 8, 16)


def setup_module():
    torch.set_num_threads(1)


def inputs(B=8, seed=5):
    g = torch.Generator().manual_seed(seed)
    params = ref.init_params(DIMS, torch.rand(ref.n_params(DIMS), generator=g))
    y = torch.rand(B, DIMS[3], generator=g)
    lat = tuple(-10 + 20 * torch.rand(B, d, generator=g) for d in DIMS[:3])
    return params, y, lat


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, -3])
def test_noise_bits_match(seed):
    idx = torch.arange(64, dtype=torch.int64).reshape(4, 16)
    key = ref.wrap_int32(seed)
    for draw in (0, 1, 17):
        assert torch.equal(ref.counter_bits(idx, torch.tensor(key), draw),
                           chain_mod.counter_bits_at(idx, key, draw))


def test_noise_index_is_the_packed_layout():
    idx, keys = ref.noise_index(DIMS, 8, 11, "cpu")
    # every latent block starts at a multiple of 128; rows step by the padded width
    assert idx[0, :4].tolist() == [0, 1, 2, 3]
    assert idx[0, 4].item() == 128 and idx[0, 12].item() == 256
    assert idx[1, 0].item() == 384
    assert torch.all(keys == 11)


@pytest.mark.parametrize("mask", [False, True])
def test_chain_matches_the_ports_plain_version(mask):
    params, y, lat = inputs()
    lo = 8 if mask else 0
    kw = dict(T=7, lr=0.1, noise_var=2.0, loss="bernoulli_mask" if mask else "bernoulli",
              mask_perc=0.5 if mask else None, mixing=3, with_pgrads=True, warm_T=5,
              warm_lr=0.7, capture_stride=2)
    new, pg, traj = chain_mod.mcpc_chain_reference(params, lat, y, 123, **kw)[:3]
    c = ref.Chain(params, y, dtype=torch.float32, mask_lo=lo)
    X = ref.adam_warm(c, torch.cat(lat, 1), 5, 0.7)[0]
    X, sums, caps = ref.langevin(c, X, 7, 0.1, 2.0, 123, grads_from=3, capture_stride=2)
    torch.testing.assert_close(X, torch.cat(new, 1), rtol=0, atol=2e-5)
    # the port captures in the packed, 128-padded layout
    offs = (0, 128, 256)
    unpacked = torch.cat([traj[:, :, o : o + d] for o, d in zip(offs, DIMS[:3])], -1)
    torch.testing.assert_close(caps, unpacked, rtol=0, atol=2e-5)
    for a, b in zip(ref.pgrads_tree(sums, DIMS), pg):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=1e-4, atol=1e-4)


def test_langevin_from_many_starts_at_once():
    params, y, lat = inputs()
    c = ref.Chain(params, y)
    X0 = torch.cat(lat, 1).double()
    _, _, caps = ref.langevin(c, X0, 12, 0.05, 2.0, 9, capture_stride=4)
    # from captures 0 and 1 (steps 0 and 4), four steps each reach captures 1 and 2
    X, _, _ = ref.langevin(c, caps[:2], 4, 0.05, 2.0, 9, t0=torch.tensor([0, 4]))
    torch.testing.assert_close(X, caps[1:3], rtol=0, atol=1e-12)


def test_param_adam_matches_the_ports_optimizer():
    from montecarlopredictivecoding_tpu_torch.core.optim import OptimizerSpec, apply_updates

    params, _, _ = inputs()
    g = torch.Generator().manual_seed(3)
    grads = [{k: torch.randn(v.shape, generator=g) for k, v in p.items()} for p in params]
    tx = OptimizerSpec("adam", lr=0.01).make()
    state = tx.init(params)
    p_port, p_ref = params, params
    s_ref = ref.adam_init(params)
    for _ in range(3):
        upd, state = tx.update(grads, state, p_port)
        p_port = apply_updates(p_port, upd)
        p_ref, s_ref = ref.adam_params(p_ref, s_ref, grads, 0.01, b1=ref.f32(0.9),
                                       b2=ref.f32(0.999))
    for a, b in zip(p_port, p_ref):
        for k in a:
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=1e-6)


def test_replayed_latents_are_the_models():
    from montecarlopredictivecoding_tpu_torch.core.trainer import GenerativeModel

    gen = GenerativeModel(common.port_model(DIMS), torch.Generator().manual_seed(4),
                          params=inputs()[0], device="cpu")
    drawn = gen.model.init_latents(gen.params, torch.zeros(8, DIMS[0]),
                                   torch.Generator().manual_seed(8))
    replay = common.replay_latents(torch.Generator().manual_seed(8), 8, DIMS)
    assert torch.equal(torch.cat(drawn, 1), replay)


def test_images_are_distinct_and_in_range():
    imgs = common.make_images(64, 784, 3, "cpu")
    assert imgs.shape == (64, 784) and float(imgs.min()) >= 0 and float(imgs.max()) <= 1
    assert len({tuple(r.tolist()) for r in imgs}) == 64
    assert 0.05 < float(imgs.mean()) < 0.4  # ink on a dark ground, as handwriting
    assert torch.equal(imgs, common.make_images(64, 784, 3, "cpu"))
