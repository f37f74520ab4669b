"""Split-TF32 arithmetic in plain PyTorch (``ops/mcpc_chain.tf32_split``
and ``tf32_split_matmul``), which diagnoses a tensor-core route for the f32
chain products (``scripts/chain_c_draws.py``), held on the CPU.

Bounds: rounding to TF32 (11 significant bits, to nearest) leaves ``x - hi``
within 2^-11 |x|, and rounding that again leaves ``|x - hi - lo|`` within
2^-22 |x| (an absolute 2^-137 where ``x - hi`` is subnormal).  A split
product drops ``a_lo b_lo`` and the two splits' rounding: at most 3 * 2^-22
of each term's ``|a||b|``, plus float32's rounding of the sum, so 2^-20 of
``sum |a||b|`` holds it.
"""

import importlib

import numpy as np
import pytest
import torch

chain_mod = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")

LOW13 = 0x1FFF


def _random_f32(n: int, seed: int) -> torch.Tensor:
    """Finite float32 values over the whole exponent range, both signs, with
    random significands, below the largest value that TF32 rounding keeps
    finite."""
    rng = np.random.default_rng(seed)
    exp = rng.integers(-126, 128, n).astype(np.float64)
    x = rng.uniform(1.0, 2.0, n) * np.exp2(exp) * rng.choice([-1.0, 1.0], n)
    return torch.from_numpy(np.clip(x, -3.4e38, 3.4e38).astype(np.float32))


def _subnormals(n: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    bits = rng.integers(1, 1 << 23, n, dtype=np.int64) | (rng.integers(0, 2, n) << 31)
    return torch.from_numpy(bits.astype(np.uint32).view(np.float32).copy())


EXTREMES = torch.tensor([0.0, -0.0, 1.0, -1.0, 1.0 + 2.0**-11, 1.0 + 2.0**-12,
                         1.0 - 2.0**-24, 2.0**-126, -(2.0**-126), 2.0**127, 3.4e38,
                         float(np.float32(1.4e-45))], dtype=torch.float32)


def _cases():
    return torch.cat([_random_f32(20000, 1), _subnormals(2000, 2), EXTREMES])


def test_split_halves_are_tf32():
    hi, lo = chain_mod.tf32_split(_cases())
    for part in (hi, lo):
        assert part.dtype == torch.float32
        assert int((part.view(torch.int32) & LOW13).abs().max()) == 0


def test_split_keeps_f32_accuracy():
    x = _cases()
    hi, lo = chain_mod.tf32_split(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    bound = torch.maximum(2.0**-22 * x.double().abs(), torch.full_like(err, 2.0**-137))
    assert bool((err <= bound).all())
    # hi alone is TF32: within 2^-11 relative and no closer in general
    rel = ((x.double() - hi.double()).abs() / x.double().abs().clamp_min(2.0**-126))
    assert float(rel[:20000].max()) <= 2.0**-11
    assert float(rel[:20000].max()) > 2.0**-13


def test_split_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-12, 1.0 + 3 * 2.0**-12,
                      1.0 + 2.0**-11 + 2.0**-23])
    hi, _ = chain_mod.tf32_split(x)
    want = [1.0 + 2.0**-10, -(1.0 + 2.0**-10), 1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10]
    assert hi.tolist() == want


def test_non_finite_values_pass_through_hi():
    x = torch.tensor([float("inf"), -float("inf"), float("nan")])
    hi, lo = chain_mod.tf32_split(x)
    assert hi[0] == float("inf") and hi[1] == -float("inf") and bool(torch.isnan(hi[2]))
    assert bool(torch.isnan(lo).all())


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
@pytest.mark.parametrize("shape", [(18, 128, 98), (24, 784, 16), (16, 20, 24)])
def test_split_product_holds_f32_accuracy(shape, scale):
    m, k, n = shape
    g = torch.Generator().manual_seed(m * k + n)
    a = scale * torch.randn(m, k, generator=g)
    b = torch.randn(k, n, generator=g) * torch.rand(k, n, generator=g)
    exact = a.double() @ b.double()
    mass = a.double().abs() @ b.double().abs()
    got = chain_mod.tf32_split_matmul(a, b)
    assert got.dtype == torch.float32
    assert bool(((got.double() - exact).abs() <= 2.0**-20 * mass).all())
    # a product of the TF32 halves alone sits far outside that bound: the
    # split is what keeps the f32 accuracy
    hi_a, _ = chain_mod.tf32_split(a)
    hi_b, _ = chain_mod.tf32_split(b)
    plain_tf32 = hi_a.double() @ hi_b.double()
    assert float(((plain_tf32 - exact).abs() / mass).max()) > 2.0**-16
