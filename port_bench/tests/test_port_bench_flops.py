"""The benchmark's operation and bound arithmetic against hand counts."""

import pytest

from port_bench.reference import flops

FID = (20, 128, 128, 784)
MSE = (10, 256, 256, 784)


def test_peaks():
    assert flops.PEAK_F32_ACCURATE == pytest.approx(165e12)
    assert flops.PEAK_F32_FMA == 67e12


@pytest.mark.parametrize("dims, B, steps, sampling, gflop", [
    (FID, 256, 400, 100, 54.972),     # an fid training batch: 250 + 150 steps, 100 sampling
    (MSE, 256, 400, 100, 123.863),    # an mse training batch
    (FID, 256, 11000, 0, 1343.75),    # a figure-5b chain: 1000 + 10,000 steps
    (MSE, 1024, 250, 0, 275.251),     # a scored batch of 1024: 250 masked Adam steps
])
def test_chain_flops(dims, B, steps, sampling, gflop):
    # 4 B (d0 d1 + d1 d2 + d2 D) a step, half as much more a sampling step
    d0, d1, d2, D = dims
    by_hand = 4 * B * (d0 * d1 + d1 * d2 + d2 * D) * (steps + sampling / 2)
    assert flops.chain_flops(dims, B, steps, sampling) == by_hand
    assert flops.chain_flops(dims, B, steps, sampling) / 1e9 == pytest.approx(gflop, abs=1e-3)


def test_bound_is_flops_at_the_f32_accurate_peak():
    seconds, which = flops.chain_bound_s(FID, 256, 400, 100)
    assert which == "flops"
    assert seconds == pytest.approx(54.972e9 / 165e12, rel=1e-4)
    # bytes: parameters, latents in and out, target and gradients, once each
    params = 20 + 20 * 128 + 128 + 128 * 128 + 128 + 128 * 784 + 784
    assert flops.chain_bytes(FID, 256, 100) == 4 * (2 * params + 2 * 256 * 276 + 256 * 784)


def test_a_tiny_call_is_bound_by_bytes():
    assert flops.chain_bound_s((2, 2, 2, 4), 1, 1)[1] == "bytes"
