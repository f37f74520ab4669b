"""Figure 2 in the port: the linear probe and the representations it reads
against the JAX package's, then the masked-digit posterior (c, d) end to
end on the CPU at a small scale, alone and against the JAX package's; and
the 1-D posterior (a, b), without noise against the JAX package's and with
it against the closed-form posterior.

Where both packages draw random numbers (the latents at a batch's start, a
chain's noise seed), the ``shared_streams`` fixture runs the JAX side first,
keeps what it drew, and hands the same values to the port's calls in the
same order.  The JAX trainers run their fused chain in interpret mode
(``use_pallas=True``), the port's the chain's plain version.

Tolerances: probe weights atol 1e-5 after three epochs of Adam (the same f32
arithmetic; measured ~1e-7); representations atol 1e-5 (both packages on
their fused chain; measured up to 1e-6); the figure's class posteriors atol
1e-5 (measured 5e-7).
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.data import mnist as jmnist
from montecarlopredictivecoding_tpu.eval import classifier as jclassifier
from montecarlopredictivecoding_tpu.experiments import common as jcommon
from montecarlopredictivecoding_tpu.experiments import figure_2 as jfigure_2
from montecarlopredictivecoding_tpu.models.factory import get_mcpc_trainer as jax_get_mcpc_trainer
from montecarlopredictivecoding_tpu.models.factory import get_pc_trainer as jax_get_pc_trainer
from montecarlopredictivecoding_tpu_torch.data import mnist as tmnist
from montecarlopredictivecoding_tpu_torch.eval import classifier as tclassifier
from montecarlopredictivecoding_tpu_torch.experiments import common, figure_2
from montecarlopredictivecoding_tpu_torch.models import get_mcpc_trainer, get_pc_trainer
from montecarlopredictivecoding_tpu_torch.utils import params_from_numpy
from montecarlopredictivecoding_tpu_torch.utils.plotting import proba_to_coordinate, pyplot
from torch_streams import langevin_off, on_the_kernel, record_results, share_streams

torch.set_num_threads(1)


@pytest.fixture
def shared_streams(monkeypatch):
    """The JAX package's sampled latents and chain seeds, recorded as its
    calls run and handed to the port's calls in the same order."""
    return share_streams(monkeypatch)


def test_train_linear_classifier_matches_jax():
    rng = np.random.default_rng(0)
    reps = rng.normal(size=(300, 20)).astype(np.float32)
    labels = rng.integers(0, 10, 300)
    reps[np.arange(300), labels] += 2.0  # a separable signal
    init = jax.device_get(jclassifier.LinearClassifier(20, key=jax.random.PRNGKey(3)).params)
    jclf, jacc = jclassifier.train_linear_classifier(reps, labels, epochs=3, seed=3)
    tclf, tacc = tclassifier.train_linear_classifier(reps, labels, epochs=3, seed=3,
                                                     params=init, device="cpu")
    for k in ("w", "b"):
        np.testing.assert_allclose(tclf.params[k].numpy(), np.asarray(jclf.params[k]),
                                   rtol=0, atol=1e-5)
    assert tacc == jacc and tacc > 0.5
    assert tclassifier.test_classifier(tclf, reps, labels) == jclassifier.test_classifier(
        jclf, reps, labels)


def test_linear_classifier_init_from_a_generator():
    a = tclassifier.LinearClassifier(20, generator=torch.Generator().manual_seed(1),
                                     device="cpu")
    b = tclassifier.LinearClassifier(20, generator=torch.Generator().manual_seed(1),
                                     device="cpu")
    assert torch.equal(a.params["w"], b.params["w"])
    assert float(a.params["w"].abs().max()) <= 1.0 / 20 ** 0.5


def test_get_representations_map_matches_jax():
    """MAP representations of two batches; the latents start at the
    constant init on both sides, so no random stream is shared."""
    dims = (4, 8, 8, 16)
    jm = mcpc.make_mlp_model(*dims, sample_x_fn=mcpc.sample_x_fn_cte)
    tm = mt.make_mlp_model(*dims, sample_x_fn=mt.sample_x_fn_cte)
    params = jax.device_get(jm.init(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    batches = [((rng.random((8, 16)) > 0.5).astype(np.float32), rng.integers(0, 10, 8))
               for _ in range(2)]
    config = {"input_size": 4, "loss_fn": None, "input_var": None, "T_pc": 12,
              "optimizer_x_fn_pc": "adam", "optimizer_x_kwargs_pc": {"lr": 0.1}}
    jgen = mcpc.GenerativeModel(jm, key=0, params=params)
    jtr = jax_get_pc_trainer(jgen, config, is_mcpc=True)
    jtr.use_pallas = True
    jreps, jlabels = jclassifier.get_representations(
        jgen, dict(config, loss_fn=mcpc.bernoulli_fn), [jtr],
        [(jnp.asarray(d), jnp.asarray(l)) for d, l in batches])
    tgen = mt.GenerativeModel(tm, 0, params=params_from_numpy(params, "cpu"), device="cpu")
    ttr = get_pc_trainer(tgen, config, is_mcpc=True)
    treps, tlabels = tclassifier.get_representations(
        tgen, dict(config, loss_fn=mt.bernoulli_fn), [ttr],
        [(torch.from_numpy(d), torch.from_numpy(l)) for d, l in batches])
    assert treps.shape == (16, 4) and ttr.kernel_calls == 2
    np.testing.assert_allclose(treps, jreps, rtol=0, atol=1e-5)
    assert np.array_equal(tlabels, jlabels)


def test_get_representations_of_the_chain(shared_streams):
    """'full' (thinned post-burn-in samples) and 'expectation' through the
    PC warm start and the MCPC chain, both on the fused chain, against the
    JAX package's on the same parameters, latents and noise seeds."""
    dims = (4, 8, 8, 16)
    params = jax.device_get(mcpc.make_mlp_model(*dims).init(jax.random.PRNGKey(4)))
    config = {"input_size": 4, "input_var": None, "T_pc": 6,
              "optimizer_x_fn_pc": "adam", "optimizer_x_kwargs_pc": {"lr": 0.1},
              "mixing": 4, "sampling": 12, "optimizer_x_kwargs_mcpc": {"lr": 0.03}}
    data = (np.random.default_rng(0).random((8, 16)) > 0.5).astype(np.float32)
    labels = np.arange(8)
    jgen = mcpc.GenerativeModel(mcpc.make_mlp_model(*dims), key=0, params=params)
    jconfig = dict(config, loss_fn=mcpc.bernoulli_fn)
    jtrainers = [on_the_kernel(jax_get_pc_trainer)(jgen, jconfig, is_mcpc=True),
                 on_the_kernel(jax_get_mcpc_trainer)(jgen, jconfig, training=False)]
    gen = mt.GenerativeModel(mt.make_mlp_model(*dims), 0,
                             params=params_from_numpy(params, "cpu"), device="cpu")
    tconfig = dict(config, loss_fn=mt.bernoulli_fn)
    trainers = [get_pc_trainer(gen, tconfig, is_mcpc=True),
                get_mcpc_trainer(gen, tconfig, training=False)]
    for rep_type, n, rows in (("full", 4, 4 * 8), ("expectation", None, 8)):
        jreps, jlabels = jclassifier.get_representations(
            jgen, jconfig, jtrainers, [(jnp.asarray(data), jnp.asarray(labels))],
            rep_type=rep_type, n=n)
        reps, tlabels = tclassifier.get_representations(
            gen, tconfig, trainers, [(torch.from_numpy(data), torch.from_numpy(labels))],
            rep_type=rep_type, n=n)
        assert reps.shape == jreps.shape == (rows, 4), rep_type
        np.testing.assert_allclose(reps, jreps, rtol=0, atol=1e-5, err_msg=rep_type)
        assert np.array_equal(tlabels, jlabels)
    assert shared_streams == ([], [])  # every JAX draw was replayed
    assert [t.engine_calls for t in trainers] == [0, 0]
    assert [t.kernel_calls for t in trainers] == [2, 2]
    with pytest.raises(NotImplementedError):
        tclassifier.get_representations(gen, tconfig, trainers, [], rep_type="mode")


def test_proba_to_coordinate():
    probs = np.eye(10)[[0, 5]]
    (x, y), (cx, cy) = proba_to_coordinate(probs)
    np.testing.assert_allclose(x, [1.0, -1.0], atol=1e-12)
    np.testing.assert_allclose(y, [0.0, 0.0], atol=1e-12)
    assert cx.shape == cy.shape == (10,)


@pytest.fixture
def small_synthetic(monkeypatch):
    """A 1000-image synthetic train split (the test split keeps its 10000)."""
    for mod in (tmnist, jmnist):
        orig = mod._synthetic_mnist
        monkeypatch.setattr(
            mod, "_synthetic_mnist",
            lambda n_train, n_test, seed=0, orig=orig: orig(1000, n_test, seed),
        )


def test_posterior_non_linear_model_end_to_end(small_synthetic, monkeypatch, tmp_path):
    """At 1/500 of the published steps on the CPU: the probe, then the PC
    and MCPC posteriors of the masked 4s, all through the fused chain (no
    engine call); posteriors of the right shapes whose rows sum to 1."""
    trainers = []
    orig = mt.PCTrainer.train_on_batch

    def spy(self, *a, **k):
        trainers.append(self)
        return orig(self, *a, **k)

    monkeypatch.setattr(mt.PCTrainer, "train_on_batch", spy)
    ctx = common.ExperimentContext("models", str(tmp_path / "figs"), scale=0.002,
                                   device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the checkpoint loads: no random init
        preds_pc, preds_mc = figure_2.posterior_non_linear_model(ctx, img_kept=0.5)
    config = figure_2._mnist_config(ctx)
    n = preds_pc.shape[1]
    assert 1 <= n <= 16
    assert preds_pc.shape == (config["T_pc"], n, 10)
    assert preds_mc.shape == (config["sampling"], n, 10)
    for p in (preds_pc, preds_mc):
        assert np.isfinite(p).all()
        np.testing.assert_allclose(p.sum(-1), 1.0, rtol=0, atol=1e-5)
    assert sum(t.engine_calls for t in set(trainers)) == 0
    assert sum(t.kernel_calls for t in set(trainers)) == 3  # probe, PC, MCPC
    figure_2.draw_posteriors(ctx, preds_pc, preds_mc, img_kept=0.5)
    assert (tmp_path / "figs" / "2d.svg").exists()


def test_posterior_non_linear_model_matches_jax(small_synthetic, shared_streams,
                                                monkeypatch, tmp_path):
    """The whole computation against the JAX package's, at 1/500 of the
    published steps and batches of 64: the probe's MAP representations of 2
    batches and its training from the same initial weights, the PC posterior
    of the masked 4s (every Adam step captured) and the MCPC posterior from
    its end, on the same latents and noise seeds."""
    for fig in (figure_2, jfigure_2):
        small = fig._mnist_config
        monkeypatch.setattr(fig, "_mnist_config", lambda ctx, small=small: dict(
            small(ctx), batch_size_train=64, batch_size_val=64, batch_size_test=64))
    for name in ("get_pc_trainer", "get_mcpc_trainer"):
        monkeypatch.setattr(jfigure_2, name, on_the_kernel(getattr(jfigure_2, name)))
    probe_init = jax.device_get(
        jclassifier.LinearClassifier(20, key=jax.random.PRNGKey(0)).params)
    monkeypatch.setattr(figure_2, "train_linear_classifier", functools.partial(
        tclassifier.train_linear_classifier, params=probe_init))

    jctx = jcommon.ExperimentContext("models", str(tmp_path / "jax"), scale=0.002)
    jpc, jmc = jfigure_2.posterior_non_linear_model(jctx, img_kept=0.5)
    ctx = common.ExperimentContext("models", str(tmp_path / "port"), scale=0.002,
                                   device="cpu")
    preds_pc, preds_mc = figure_2.posterior_non_linear_model(ctx, img_kept=0.5)
    assert shared_streams == ([], [])  # 2 probe batches, PC, MCPC: all replayed
    assert preds_pc.shape == jpc.shape and preds_mc.shape == jmc.shape
    assert preds_pc.shape[1] >= 2
    np.testing.assert_allclose(preds_pc, jpc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(preds_mc, jmc, rtol=0, atol=1e-5)


def test_load_generative_checkpoint(tmp_path):
    ctx = common.ExperimentContext("models", str(tmp_path), device="cpu")
    config = figure_2._mnist_config(ctx)
    gen = common.load_generative_checkpoint(ctx, "mcpc_ml_2", config)
    assert gen.params[3]["w"].shape == (128, 784)
    empty = common.ExperimentContext(str(tmp_path), str(tmp_path), device="cpu")
    with pytest.warns(RuntimeWarning, match="random initialization"):
        fresh = common.load_generative_checkpoint(empty, "mcpc_ml_2", config)
    assert not torch.equal(fresh.params[3]["w"], gen.params[3]["w"])
    args = common.standard_parser("x").parse_args(["--full", "--device", "cpu"])
    assert common.context_from_args(args).scale == 1.0
    assert common.context_from_args(args).device == "cpu"


def test_posterior_linear_model_without_noise_matches_jax(monkeypatch, tmp_path):
    """Panels (a, b) at 1/20 of the published steps (100 Adam steps, then
    500 Langevin steps from the constant start) with the noise variance 0 in
    both packages: the MAP and both trajectories against the JAX package's
    step engine, atol 2e-5 (the engine tests' bound)."""
    langevin_off(monkeypatch, figure_2)
    monkeypatch.setattr(jfigure_2, "animate_frames", lambda *a, **k: None)
    jcalls = record_results(monkeypatch)
    jctx = jcommon.ExperimentContext("models", str(tmp_path / "jax"), scale=0.05)
    want = jfigure_2.posterior_linear_model(jctx)
    ctx = common.ExperimentContext("models", str(tmp_path / "port"), scale=0.05, device="cpu")
    got = figure_2.posterior_linear_model(ctx)
    assert len(jcalls) == 2
    assert got["pc_traj"].shape == (100,) and got["mc_traj"].shape == (500,)
    np.testing.assert_allclose(got["pc_traj"], jcalls[0]["representations"][:, 0, 0],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["mc_traj"], jcalls[1]["representations"][:, 0, 0],
                               rtol=0, atol=2e-5)
    for k in ("map", "samples_mean", "samples_var"):
        assert abs(got[k] - want[k]) <= 2e-5, k
    np.testing.assert_array_equal(got["samples"], got["mc_traj"])  # no mixing steps


def test_posterior_linear_model_samples_the_closed_form_posterior(monkeypatch, tmp_path):
    """At the published steps (2000 Adam steps, 10,000 Langevin steps at lr
    0.02, noise variance 2) on the CPU: the MAP within 1e-3 of the mode
    0.44, and the samples' mean and variance within 4 standard errors of
    the closed-form posterior's 0.44 and 0.2, the errors from the means of
    20 batches of 500 successive samples.  The chain's step adds a bias of
    lr * precision / 2 = 5% to the variance (0.2105), well inside them."""
    ctx = common.ExperimentContext("models", str(tmp_path), scale=1.0, device="cpu")
    got = figure_2.posterior_linear_model(ctx)
    samples = got["samples"]
    assert samples.shape == (10000,) and np.isfinite(samples).all()
    assert abs(got["map"] - 0.44) <= 1e-3
    batches = samples.reshape(20, 500)
    for stat, want in ((batches.mean(1), 0.44), (batches.var(1), 0.2)):
        se = stat.std(ddof=1) / np.sqrt(len(stat))
        assert abs(stat.mean() - want) <= 4 * se, (stat.mean(), want, se)
    x = np.linspace(-10, 10, 20001)
    density = figure_2.linear_posterior_density(x)
    assert abs(density.sum() * (x[1] - x[0]) - 1.0) < 1e-6
    assert abs(x[np.argmax(density)] - 0.44) < 1e-3
    frames = []

    def first_frames(render_frame, n_frames, path, fps=50):
        plt = pyplot()
        fig, ax = plt.subplots()
        for i in range(2):
            render_frame(i, ax)
        frames.append((n_frames, path))
        plt.close(fig)

    monkeypatch.setattr(figure_2, "animate_frames", first_frames)
    figure_2.draw_posterior_linear_model(ctx, got)
    assert (tmp_path / "2a.svg").exists() and (tmp_path / "2b.svg").exists()
    assert frames == [(100, ctx.fig_path("2b.gif"))]
