"""Figure 5 in the port against the JAX package's, on the CPU: the synthetic
stimuli and the digitized neuroscience data (equal), the rolling
variability without pandas against the JAX package's pandas one, one seed
model's chains of panel (b) against the JAX per-seed trainer path, panel
(a) in both modes against the JAX function, and panel (b) end to end.

Where both packages draw random numbers the JAX side runs first and its
latents and chain seeds are handed to the port (``torch_streams``); the JAX
trainers run their fused chain in interpret mode, the port's the chain's
plain version.

Tolerances: the data exactly; the rolling statistics rtol 1e-6 (float64
sums in another order than pandas' online update) with NaN in the same
places; the chains atol 1e-5 (the same f32 chain, products summed in
another order); panel (a)'s rolling mean and sem atol 1e-5 (they average
such chains).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.data import synthetic as jsynthetic
from montecarlopredictivecoding_tpu.data import mnist as jmnist
from montecarlopredictivecoding_tpu.experiments import common as jcommon
from montecarlopredictivecoding_tpu.experiments import figure_5 as jfigure_5
from montecarlopredictivecoding_tpu.experiments import neuro_data as jneuro
from montecarlopredictivecoding_tpu_torch.data import grating_dataset, noise_dataset, chunk_dataset
from montecarlopredictivecoding_tpu_torch.data import mnist as tmnist
from montecarlopredictivecoding_tpu_torch.experiments import common, figure_5, neuro_data
from torch_streams import on_the_kernel, share_streams

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [dict(num_samples=7), dict(num_samples=5, size=12, seed=3),
                                dict(num_samples=9, num_orientations=16, wavelength=6.0,
                                     seed=2)])
def test_grating_dataset_equals_jax(kw):
    got = grating_dataset(**kw)
    assert got.dtype == np.float32 and got.shape == (kw["num_samples"], kw.get("size", 28) ** 2)
    np.testing.assert_array_equal(got, jsynthetic.grating_dataset(**kw))


def test_noise_and_chunk_datasets_equal_jax():
    np.testing.assert_array_equal(noise_dataset(6, size=10, seed=4),
                                  jsynthetic.noise_dataset(6, size=10, seed=4))
    x = np.arange(23 * 2).reshape(23, 2)
    got, want = chunk_dataset(x, 5), jsynthetic.chunk_dataset(x, 5)
    assert [len(c) for c in got] == [5, 5, 5, 5, 3]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_neuro_data_equals_jax():
    for name in ("BERKES_KLS", "BERKES_KLS_SEM_COORD", "CHURCHLAND_MEAN_X", "CHURCHLAND_MEAN",
                 "CHURCHLAND_SEM_POS_X", "CHURCHLAND_SEM_POS", "CHURCHLAND_SEM_NEG_X",
                 "CHURCHLAND_SEM_NEG"):
        np.testing.assert_array_equal(getattr(neuro_data, name), getattr(jneuro, name))
    assert neuro_data.BERKES_AGES == jneuro.BERKES_AGES
    for a, b in zip(neuro_data.churchland_2010_curves(), jneuro.churchland_2010_curves()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window", [2, 17, 60])
def test_rolling_variability_matches_pandas(window):
    """Random walks with a drift, a constant column and a column far from
    zero, in chunks that do not divide the columns: the JAX package's
    pandas computation and a direct pandas one."""
    rng = np.random.default_rng(window)
    xs = np.cumsum(rng.normal(size=(150, 41)), axis=0).astype(np.float32)
    xs[:, 3] = 2.5
    xs[:, 7] += 1e3
    mean, sem = figure_5._rolling_variability(xs, window, chunk=16)
    want_mean, want_sem = jfigure_5._rolling_variability(xs, window)
    moving = pd.DataFrame(xs).rolling(window=window).std()
    for got, want in ((mean, want_mean), (sem, want_sem),
                      (mean, moving.mean(axis=1).values)):
        assert got.shape == want.shape == (150,)
        assert np.array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[: window - 1]).all() and np.isfinite(got[window - 1:]).all()
        np.testing.assert_allclose(got[window - 1:], want[window - 1:], rtol=1e-6)
    with pytest.raises(ValueError):
        figure_5._rolling_variability(xs, 1)
    short_mean, _ = figure_5._rolling_variability(xs[:5], 6)
    assert np.isnan(short_mean).all()


@pytest.fixture
def small_synthetic(monkeypatch):
    """A 1000-image synthetic train split (the test split keeps its 10000)."""
    for mod in (tmnist, jmnist):
        orig = mod._synthetic_mnist
        monkeypatch.setattr(
            mod, "_synthetic_mnist",
            lambda n_train, n_test, seed=0, orig=orig: orig(1000, n_test, seed),
        )


def _small_config(monkeypatch, **small):
    base = figure_5._base_config
    monkeypatch.setattr(figure_5, "_base_config", lambda ctx: dict(base(ctx), **small))


def test_digit_chains_match_the_jax_per_seed_path(small_synthetic, monkeypatch, tmp_path):
    """Seed 0 at epoch 5, all four stimuli, B=16, 10 Adam steps and 4 + 12
    Langevin steps: the port's sweep (one warm start and one captured chain
    a stimulus, through the chain) against the JAX package's per-seed
    trainer path ``_sample_latent_chain`` on the same latents and chain
    seeds.  Longer chains on the noise and grating stimuli part: from step
    19 on (of 95) a row whose pre-activation sits at relu's kink goes one
    way in one f32 summation order and the other way in the other, as in
    any two f32 versions of the chain (``scripts/chain_error_growth.py``);
    the spontaneous and natural chains stayed within 1e-5 for 95 steps."""
    _small_config(monkeypatch, batch_size_test=16, T_pc=10, mixing=4, sampling=12)
    for name in ("get_pc_trainer", "get_mcpc_trainer"):
        monkeypatch.setattr(jfigure_5, name, on_the_kernel(getattr(jfigure_5, name)))
    latents, seeds = share_streams(monkeypatch)
    ctx = common.ExperimentContext("models", str(tmp_path), scale=0.01, device="cpu")
    config = figure_5._base_config(ctx)
    stimuli = figure_5.digit_stimuli(config, "cpu")
    neuron_idx = figure_5._neuron_idx(config)
    stride = figure_5._stride(config)
    assert stride == 1 and config["batch_size_test"] == 16 and config["T_pc"] == 10

    jctx = jcommon.ExperimentContext("models", str(tmp_path), scale=0.01)
    jconfig = dict(config, loss_fn=mcpc.bernoulli_fn)
    name = figure_5.epoch_checkpoint(0, 5)
    assert name == "epoch_save/mcpc_aging_0_epoch5"
    want = {}
    for li, target in stimuli:
        jgen = jcommon.load_generative_checkpoint(jctx, name, jconfig)
        want[li] = jfigure_5._sample_latent_chain(
            jctx, jgen, jconfig, None if target is None else jnp.asarray(target.numpy()),
            neuron_idx, stride)
    # the JAX calls drew, per stimulus, the latents and a seed for each of
    # the warm start and the chain: the sweep takes the chain's
    assert len(latents) == 4 and len(seeds) == 8
    handed = iter([([latents[i]], [seeds[2 * i + 1]]) for i in range(4)])
    sweep = figure_5.sweep_warm_langevin_chains

    def sweep_handed(*args, **kwargs):
        lat, chain_seeds = next(handed)
        return sweep(*args, latents=lat, chain_seeds=chain_seeds, **kwargs)

    monkeypatch.setattr(figure_5, "sweep_warm_langevin_chains", sweep_handed)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the checkpoints load: no random init
        warnings.filterwarnings("ignore", "T=", RuntimeWarning)
        got = figure_5.digit_chains(ctx, config, 5, 1, [0], stimuli)
    for li in range(4):
        assert got[li].shape == (1,) + want[li].shape == (1, 12 * 16, 5)
        np.testing.assert_allclose(got[li][0], want[li], rtol=0, atol=1e-5, err_msg=str(li))


def test_sample_latent_chain_matches_jax(small_synthetic, monkeypatch, tmp_path):
    """The per-seed trainer path on the natural stimulus (a warm start and a
    captured chain through two trainers, B=16, 10 + 4 + 12 steps), against
    the JAX package's on the same latents and chain seeds."""
    _small_config(monkeypatch, batch_size_test=16, T_pc=10, mixing=4, sampling=12)
    for name in ("get_pc_trainer", "get_mcpc_trainer"):
        monkeypatch.setattr(jfigure_5, name, on_the_kernel(getattr(jfigure_5, name)))
    latents, seeds = share_streams(monkeypatch)
    ctx = common.ExperimentContext("models", str(tmp_path), device="cpu")
    config = figure_5._base_config(ctx)
    target = figure_5.digit_stimuli(config, "cpu")[1][1]
    idx = figure_5._neuron_idx(config)
    jctx = jcommon.ExperimentContext("models", str(tmp_path))
    jconfig = dict(config, loss_fn=mcpc.bernoulli_fn)
    name = figure_5.epoch_checkpoint(1, 10)
    want = jfigure_5._sample_latent_chain(
        jctx, jcommon.load_generative_checkpoint(jctx, name, jconfig), jconfig,
        jnp.asarray(target.numpy()), idx, 2)
    got = figure_5._sample_latent_chain(
        ctx, common.load_generative_checkpoint(ctx, name, config), config, target, idx, 2)
    assert (latents, seeds) == ([], [])
    assert got.shape == want.shape == (6 * 16, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_similarity_increase_digit_end_to_end(small_synthetic, monkeypatch, tmp_path):
    """Three seed models at two epochs, B=32, 1/200 of the published steps:
    every ``train_on_batch`` through the chain (no engine call), KLs of the
    right shape, finite; panel (b) drawn with its paired tests."""
    _small_config(monkeypatch, batch_size_test=32)
    trainers = []
    orig = mt.PCTrainer.train_on_batch

    def spy(self, *a, **k):
        trainers.append(self)
        return orig(self, *a, **k)

    monkeypatch.setattr(mt.PCTrainer, "train_on_batch", spy)
    ctx = common.ExperimentContext("models", str(tmp_path), scale=0.005, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # T below the stack's minimum
        kls = figure_5.similarity_increase(ctx, epochs=(0, 15), seeds=range(3))
    assert kls.shape == (3, 2, 3) and np.isfinite(kls).all()
    assert len(trainers) == 2 * 4 * 2 * 3  # (warm, chain) x stimuli x epochs x seeds
    assert sum(t.engine_calls for t in trainers) == 0
    assert sum(t.kernel_calls for t in trainers) == len(trainers)
    assert (tmp_path / "5b.svg").exists()
    figure_5.draw_similarity_increase_digit(ctx, kls, (0, 15))
    assert (tmp_path / "5b_digit.svg").exists()


@pytest.mark.parametrize("mode", ["mcpc", "pc"])
def test_variability_stimulus_onset_matches_jax(mode, small_synthetic, monkeypatch, tmp_path):
    """Panel (a) at 1/200 of the published steps (MCPC B=256, PC B=100):
    the port's function against the JAX package's with its trainers on the
    fused chain, on the same latents and chain seeds; every port call
    through the chain."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for name in ("get_pc_trainer", "get_mcpc_trainer"):
        monkeypatch.setattr(jfigure_5, name, on_the_kernel(getattr(jfigure_5, name)))
    latents, seeds = share_streams(monkeypatch)
    jctx = jcommon.ExperimentContext("models", str(tmp_path), scale=0.005)
    fig, ax = plt.subplots()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        want_mean, want_sem = jfigure_5.variability_stimulus_onset_nonlinear(jctx, ax, mode)
    plt.close(fig)
    trainers = []
    orig = mt.PCTrainer.train_on_batch

    def spy(self, *a, **k):
        trainers.append(self)
        return orig(self, *a, **k)

    monkeypatch.setattr(mt.PCTrainer, "train_on_batch", spy)
    ctx = common.ExperimentContext("models", str(tmp_path), scale=0.005, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = figure_5.variability_stimulus_onset_nonlinear(ctx, mode)
    assert (latents, seeds) == ([], [])  # every JAX draw was replayed
    assert len(trainers) == (4 if mode == "mcpc" else 3)
    assert sum(t.engine_calls for t in set(trainers)) == 0
    assert got["mean"].shape == want_mean.shape == got["time"].shape
    for a, b in ((got["mean"], want_mean), (got["sem"], want_sem)):
        assert np.array_equal(np.isnan(a), np.isnan(b)) and np.isfinite(a).sum() > 10
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    fig, axs = plt.subplots(2, 1)
    figure_5.draw_variability(axs[0], got)
    figure_5.churchland_2010(axs[1])
    figure_5.berkes_2011()
    plt.close("all")
