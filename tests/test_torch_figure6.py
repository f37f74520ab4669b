"""Figure 6 in the port against the JAX package's, on the CPU: the noise
sweep's training and generation in ``PCTrainer``'s step engine, on the
data batches the JAX function draws (recomputed here from its key) and,
through ``torch_streams``, the latents it samples.

Tolerances: without Langevin noise (variance 0 in both packages) the
learned (mu, W) and the generated variance atol 2e-5 (the engine tests'
bound); with noise, each generated variance within 20% of the JAX run's
and each learned W within 0.05 (three seeds of the port parted by up to
10% and 0.015, measured at this scale).
"""

import jax
import numpy as np
import pytest
import torch

from montecarlopredictivecoding_tpu.experiments import common as jcommon
from montecarlopredictivecoding_tpu.experiments import figure_6 as jfigure_6
from montecarlopredictivecoding_tpu_torch.experiments import common, figure_6
from torch_streams import langevin_off, share_streams

torch.set_num_threads(1)

NOISE = np.array([2.0, 16.0])


def _jax_datas(jctx):
    """The batches ``varying_langevin_noise`` of the JAX package draws."""
    key = jctx.key(6)
    n = jctx.steps(25, minimum=4)
    return [np.asarray(1.0 + np.sqrt(5.0) * jax.random.normal(jax.random.fold_in(key, i),
                                                              (2048, 1)))
            for i in range(n)]


@pytest.mark.parametrize("noise", [False, True])
def test_varying_langevin_noise_matches_jax(noise, monkeypatch, tmp_path):
    """Two noise variances at 1/20 of the published steps: 4 batches of
    2048 for 2 epochs, 20 Langevin steps a batch, then 500 generation
    steps."""
    if not noise:
        langevin_off(monkeypatch, figure_6)
    latents, _ = share_streams(monkeypatch)
    jctx = jcommon.ExperimentContext("models", str(tmp_path / "jax"), scale=0.05)
    _, want_vars, want_weights = jfigure_6.varying_langevin_noise(jctx, NOISE)
    # each variance: 8 training batches and the generation sample latents
    assert len(latents) == 2 * (8 + 1)
    if noise:
        monkeypatch.undo()  # the port draws its own latents and noise
    ctx = common.ExperimentContext("models", str(tmp_path / "port"), scale=0.05, device="cpu")
    got = figure_6.varying_langevin_noise(ctx, NOISE, datas=_jax_datas(jctx))
    assert got["generated"].shape == (2, 2048) and np.isfinite(got["generated"]).all()
    np.testing.assert_array_equal(got["gen_vars"], got["generated"].var(axis=1))
    if noise:
        np.testing.assert_allclose(got["gen_vars"], want_vars, rtol=0.2)
        np.testing.assert_allclose(got["weights"][:, 1], want_weights[:, 1], rtol=0, atol=0.05)
        # the correct noise (2) learns a larger |W| than a mismatched one
        assert abs(got["weights"][0, 1]) > abs(got["weights"][1, 1])
    else:
        assert latents == []  # every JAX draw was replayed
        np.testing.assert_allclose(got["weights"], want_weights, rtol=0, atol=2e-5)
        np.testing.assert_allclose(got["gen_vars"], want_vars, rtol=0, atol=2e-5)


def test_draw_varying_langevin_noise(tmp_path):
    """The density panels for four variances or fewer, the sweep's two
    panels for more."""
    ctx = common.ExperimentContext("models", str(tmp_path), device="cpu")
    rng = np.random.default_rng(0)
    for n in (2, 5):
        noise_vars = np.logspace(-1, 1.5, n)
        generated = rng.normal(size=(n, 100))
        figure_6.draw_varying_langevin_noise(ctx, {
            "noise_vars": noise_vars, "generated": generated, "gen_vars": generated.var(axis=1),
            "weights": rng.normal(size=(n, 2))})
    assert (tmp_path / "6a_1.svg").exists() and not (tmp_path / "6a_2.svg").exists()
    assert (tmp_path / "6b.svg").exists() and (tmp_path / "6c.svg").exists()
