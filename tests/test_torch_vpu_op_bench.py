"""The port's per-op probe (``benchmarks/vpu_op_bench.py`` of the port)
against the JAX package's ``benchmarks/vpu_op_bench.py`` on the CPU, and
the probe's host side: its entry points' refusals, the marginal fit and the
bound from the operations a step needs.  The kernel against its plain version on the card
is in tests/test_torch_kernel_cuda.py.

Size: B=8 ([8, 384]), T=64 steps from 0.3 (the probe's start), and 5 and
13 steps from a signed start uniform in [-3, 3] (``signed_start``), where
|x| and the x < 0 side of each step run and every element takes its own
path.  The maps contract to their fixed points, so after 64 steps the start
no longer shows in the tile; after 5 or 13 it does.  (Near 0 the sin and
tanh maps stretch by 1.1 a step, so an ulp that two libraries round apart
grows 445-fold over 64 steps from a start near 0: a long hold from the
signed start tests the map's conditioning, not the code.)

Tolerances.  The 11 deterministic variants: atol 1e-6.  Their values are of
order 1 (at most 1.9 from 0.3; from the signed start, exp's first step
reaches 20, where an ulp is 1.9e-6, and the next multiplies that by under
1e-8), every map contracts, and XLA's and PyTorch's log,
sin, tanh and the rest differ by an ulp here and there.  The random
variants run the JAX package's own counter hash (``_mock_bits``,
``_uniforms``, ``_sincos_2pi``; the JAX body draws the TPU's on-core PRNG,
which does not run on the CPU).  Their bits must be equal.  At the probe's
noise scale 1e-6 they are held at atol 1e-6, where a wrong draw would hide;
so they are also held at noise scale 1, where it shows.  There x wanders
to |x| of about 40 (prng to 100), where one f32 ulp is 3.8e-6, and XLA's
log, sin and cos differ from PyTorch's by an ulp in about a tenth of the
elements (measured: the Box-Muller variants end up to 5.7e-6 apart, prng
bit-equal).  So the atol 1e-6 is scaled by the tile's largest |x|: 1e-6 ·
max(1, max|x|).  A draw off by one seed moves the tile by far more
(``test_wrong_draw_is_caught``).
"""

import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopredictivecoding_tpu.ops.pallas_mcpc import _mock_bits, _sincos_2pi, _uniforms
from montecarlopredictivecoding_tpu_torch.benchmarks import vpu_op_bench as probe
from montecarlopredictivecoding_tpu_torch.ops.mcpc_chain import counter_bits

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
B, T, SEED = 8, 64, 7
SHAPE = (B, probe.COLS)
ATOL = 1e-6


@pytest.fixture(scope="module")
def jax_probe():
    """The JAX probe's module, loaded by path.  It imports ``bench``, and
    both set the JAX compilation cache when imported; those settings and
    ``sys.path`` are put back."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("jax_vpu_op_bench",
                                                  REPO / "benchmarks" / "vpu_op_bench.py")
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return module


def start_tile(start):
    """The start as the port's ``x0``: None for 0.3, or the signed tile."""
    return None if start == "0.3" else probe.signed_start(B, SEED)


def jax_run(jax_probe, name, seed, noise_scale, start="0.3", steps=T):
    """``steps`` steps of the JAX probe's variant from 0.3 or the signed
    start.  The random ones take the probe's formulas (lines 58 and 77-86)
    with the package's counter hash in place of the TPU PRNG: draw t, or
    draws 2t and 2t + 1."""
    x0 = start_tile(start)
    x = jnp.full(SHAPE, probe.X0, jnp.float32) if x0 is None else jnp.asarray(x0.numpy())
    if name not in probe.RANDOM_VARIANTS:
        body = jax_probe.make_variant(name)
        for t in range(steps):
            x = body(t, x, SHAPE)
        return np.asarray(x)
    for t in range(steps):
        if name == "prng":
            f = jax.lax.bitcast_convert_type(
                (_mock_bits(SHAPE, seed, t) >> 9) | jnp.uint32(0x3F800000), jnp.float32)
            x = x * 0.9999 + noise_scale * f
            continue
        u1, u2 = _uniforms(SHAPE, mock=(seed, 2 * t))
        r = jnp.sqrt(-2.0 * jnp.log(u1))
        if name == "bm_hw":
            th = (2.0 * np.pi) * u2
            c, s = jnp.cos(th), jnp.sin(th)
        else:
            c, s = _sincos_2pi(u2)
        x = x * 0.9999 + noise_scale * (r * c + r * s)
    return np.asarray(x)


def tolerance(want):
    return ATOL * max(1.0, float(np.abs(want).max()))


STARTS = [("0.3", T), ("signed", 5), ("signed", 13)]


@pytest.mark.parametrize("start,steps", STARTS, ids=["0.3", "signed-5", "signed-13"])
@pytest.mark.parametrize("name", probe.VARIANTS)
def test_plain_matches_jax(jax_probe, name, start, steps):
    """Each variant's plain version against the JAX probe's step, from 0.3
    and from the signed start: the random ones at noise scale 1, so that a
    wrong draw shows."""
    scale = 1.0 if name in probe.RANDOM_VARIANTS else 1e-6
    want = jax_run(jax_probe, name, SEED, scale, start, steps)
    got = probe.run_variant(name, B, steps, SEED, device="cpu", noise_scale=scale,
                            x0=start_tile(start))
    assert got.shape == SHAPE and got.dtype == torch.float32
    tol = tolerance(want) if name in probe.RANDOM_VARIANTS else ATOL
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


@pytest.mark.parametrize("name", probe.RANDOM_VARIANTS)
def test_random_plain_matches_jax_at_probe_noise(jax_probe, name):
    want = jax_run(jax_probe, name, SEED, 1e-6)
    got = probe.run_variant(name, B, T, SEED, device="cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name", probe.RANDOM_VARIANTS)
def test_wrong_draw_is_caught(jax_probe, name):
    """A planted fault: the draws of another seed put the tile far outside
    the tolerance."""
    want = jax_run(jax_probe, name, SEED, 1.0)
    got = probe.run_variant(name, B, T, SEED + 1, device="cpu", noise_scale=1.0).numpy()
    assert np.abs(got - want).max() > 1000 * tolerance(want)


@pytest.mark.parametrize("seed,draw", [(SEED, 0), (SEED, 127), (-3, 2 * T + 1), (2**31 - 1, 5)])
def test_counter_bits_equal_mock_bits(seed, draw):
    want = np.asarray(_mock_bits(SHAPE, seed, draw)).astype(np.int64)
    got = counter_bits(SHAPE, seed, draw, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", probe.VARIANTS)
def test_run_variant_on_cpu_iterates_make_variant(name):
    body = probe.make_variant(name)
    x0 = probe.signed_start(B, SEED)
    for start, x in ((None, torch.full(SHAPE, 0.3)), (x0, x0.clone())):
        for t in range(T):
            x = body(t, x, SEED, 1e-6)
        assert torch.equal(probe.run_variant(name, B, T, SEED, device="cpu", x0=start), x)
    assert torch.equal(x0, probe.signed_start(B, SEED))  # the start is not written


def test_signed_start():
    x = probe.signed_start(B, SEED)
    assert x.shape == SHAPE and x.dtype == torch.float32
    assert -probe.START <= float(x.min()) < -2.5 and 2.5 < float(x.max()) <= probe.START
    assert torch.equal(x, probe.signed_start(B, SEED))
    assert not torch.equal(x, probe.signed_start(B, SEED + 1))


@pytest.mark.parametrize("name", ["exp", "sigmoid", "tanh"])
def test_signed_start_shows_a_dropped_sign(name):
    """A planted fault the 0.3 start hides: exp(-x) for exp(-|x|), tanh(|x|)
    for tanh(x), sigmoid(|x|) for sigmoid(x).  From 0.3 the faulty step
    gives the same tile; from the signed start, after 5 steps, it is far
    outside the tolerance."""
    good = probe.make_variant(name)
    faulty_value = {"exp": lambda x: torch.exp(-x),
                    "sigmoid": lambda x: 1.0 / (1.0 + torch.exp(-x.abs())),
                    "tanh": lambda x: torch.tanh(x.abs())}[name]

    def faulty(t, x, seed, scale):
        return x * 0.1 + faulty_value(x)

    for x0, steps, shows in ((None, T, False), (probe.signed_start(B, SEED), 5, True)):
        x = torch.full(SHAPE, 0.3) if x0 is None else x0.clone()
        y = x.clone()
        for t in range(steps):
            x, y = good(t, x, SEED, 1e-6), faulty(t, y, SEED, 1e-6)
        assert (float((x - y).abs().max()) > 1000 * ATOL) == shows


def test_run_variant_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = probe.run_variant.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.run_variant("baseline", B, T, SEED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.run_variant("bm_poly", B, T, SEED, device="cuda:0")
    assert probe.run_variant.launches == before


def test_bad_arguments_raise():
    with pytest.raises(ValueError, match="x0 must be a float32"):
        probe.run_variant("sin", B, T, SEED, device="cpu", x0=torch.zeros(B, probe.COLS - 1))
    with pytest.raises(ValueError, match="x0 must be a float32"):
        probe.run_variant_reference("sin", B, T, SEED, x0=torch.zeros(SHAPE, dtype=torch.float64))
    for device in ("cpu", "cuda"):
        with pytest.raises(ValueError, match="unknown variant 'nope'"):
            probe.run_variant("nope", B, T, SEED, device=device)
    with pytest.raises(ValueError, match="unknown variant"):
        probe.make_variant("bm")
    with pytest.raises(ValueError, match="takes a CUDA device, not meta"):
        probe.run_variant("sin", B, T, SEED, device="meta")
    with pytest.raises(ValueError, match="takes a CUDA device, not cpu"):
        probe.device_sincos_2pi(torch.zeros(4))
    with pytest.raises(ValueError, match="B must be"):
        probe.run_variant("sin", 0, T, SEED, device="cpu")


def test_marginal_fit_on_a_stub_timer(monkeypatch):
    """(hi - lo) / (t_hi - t_lo) in µs from the least kernel ms at each length."""
    calls = []

    def stub(name, batch, steps, reps):
        calls.append((name, batch, steps, reps))
        return 0.75 + 2.5e-6 * steps  # ms: a launch's cost and 2.5 ns a step

    monkeypatch.setattr(probe, "kernel_ms", stub)
    us = probe.marginal_us_per_step("tanh", 256, 1000, 5000, reps=3)
    assert us == pytest.approx(2.5e-3, rel=1e-9)
    assert calls == [("tanh", 256, 1000, 3), ("tanh", 256, 5000, 3)]
    assert probe.marginal_us_per_step("sin", 8) == pytest.approx(2.5e-3, rel=1e-9)
    assert calls[-2:] == [("sin", 8, probe.T_LO, 5), ("sin", 8, probe.T_HI, 5)]
    with pytest.raises(ValueError, match="t_lo < t_hi"):
        probe.marginal_us_per_step("sin", 8, 10, 10)


def test_main_refuses_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        probe.main(["256"])


def test_step_ops_table():
    """The operations a step needs, by kind, for every variant: the frame's
    two roundings, a draw's 5 integer multiplies, 7 logic operations and 7
    shifts, a library function's one MUFU operation."""
    ops = probe.STEP_OPS
    assert set(ops) == set(probe.VARIANTS)
    assert ops["baseline"] == {"fp32": 2}
    assert ops["prng"] == {"fp32": 3, "imul": 5, "alu": 7, "shift": 7}
    assert ops["tanh"] == {"fp32": 2, "mufu": 1}
    assert ops["sigmoid"] == {"fp32": 4, "mufu": 2}
    assert ops["bm_hw"] == {"fp32": 11, "mufu": 4, "imul": 10, "alu": 14, "shift": 14}
    assert ops["bm_poly"] == {"fp32": 25, "mufu": 2, "imul": 10, "alu": 22, "shift": 14,
                              "conversion": 2}
    kinds = set(probe.PIPE_RATES) - {"issue"} | {"shift"}
    assert all(set(c) <= kinds for c in ops.values())


@pytest.mark.parametrize("name,pipe,per_element", [
    ("baseline", "issue", 2 / 128), ("prng", "issue", 22 / 128), ("log", "mufu", 1 / 16),
    ("sigmoid", "mufu", 2 / 16), ("bm_hw", "issue", 53 / 128), ("bm_poly", "issue", 75 / 128)])
def test_bound_is_the_slowest_pipe(name, pipe, per_element):
    """Clocks an element on the slowest pipe, over the even share of 132
    SMs, at 1980 MHz; the loop's own work is not in it."""
    us, got = probe.bound_us_per_step(name, 256 * probe.COLS, 132, 1980.0)
    assert got == pipe
    assert us == pytest.approx(per_element * 256 * probe.COLS / 132 / 1980.0, rel=1e-12)


def test_bound_counts_the_integer_pipes(monkeypatch):
    """A step of integer work alone: the multiply pipe, the ALU, or the
    issue rate that the shifts share with them, whichever is slowest."""
    elements, sms, mhz = 256 * probe.COLS, 132, 1980.0

    def bound(**ops):
        monkeypatch.setitem(probe.STEP_OPS, "baseline", probe._ops(**ops))
        us, pipe = probe.bound_us_per_step("baseline", elements, sms, mhz)
        return round(us * mhz * sms / elements, 9), pipe

    assert bound(imul=8) == (8 / 64, "imul")
    assert bound(alu=8, shift=1) == (8 / 64, "alu")
    assert bound(imul=4, alu=4, shift=12) == (20 / 128, "issue")
    assert bound(conversion=2, shift=8) == (2 / 16, "conversion")
