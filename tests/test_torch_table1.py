"""Table 1 (``experiments/table_1.py``), figure 2e and the ``train_mnist``
entry points of this slice, in the port against the JAX package.

The MSE column runs both packages' trainers on the same latents (handed to
both, as neither can draw the other's), the JAX side through the fused chain
in interpret mode as the port's runs its plain version on the CPU.  The FID
and marginal-likelihood columns take the same ancestral samples and DLGM
probabilities on both sides.  The synthetic MNIST set is cut small so that
a column's one batch is small.  Tolerances are stated per test.
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
from montecarlopredictivecoding_tpu.eval import fid as jfid
from montecarlopredictivecoding_tpu.eval import metrics as jmetrics
from montecarlopredictivecoding_tpu.experiments import common as jcommon
from montecarlopredictivecoding_tpu.experiments import table_1 as jt1
from montecarlopredictivecoding_tpu.models import dlgm as jdlgm
from montecarlopredictivecoding_tpu.models import factory as jfactory
from montecarlopredictivecoding_tpu.models import resnet9 as jr
from montecarlopredictivecoding_tpu.utils import checkpoint as jckpt
from montecarlopredictivecoding_tpu_torch.data import mnist as tmnist
from montecarlopredictivecoding_tpu_torch.eval import fid as tfid
from montecarlopredictivecoding_tpu_torch.eval import metrics as tmetrics
from montecarlopredictivecoding_tpu_torch.experiments import common as tcommon
from montecarlopredictivecoding_tpu_torch.experiments import figure_2
from montecarlopredictivecoding_tpu_torch.experiments import table_1 as tt1
from montecarlopredictivecoding_tpu_torch.experiments import train_mnist as ttrain
from montecarlopredictivecoding_tpu_torch.models import dlgm as tdlgm
from montecarlopredictivecoding_tpu_torch.models import resnet9 as tr
from montecarlopredictivecoding_tpu_torch.utils import latents_from_numpy, load_checkpoint

torch.set_num_threads(1)

SCALE = 0.02  # 5 of table 1's 250 Adam MAP steps


def small_mnist(monkeypatch, n_train=8, n_test=6008):
    """Both packages' synthetic MNIST cut to ``n_test`` test images (the
    validation split takes 6000, the test split the rest) and ``n_train``
    training images, made once."""
    for mod in (tmnist, jmnist):
        orig = mod._synthetic_mnist
        monkeypatch.setattr(mod, "_synthetic_mnist", functools.lru_cache(None)(
            lambda n_tr, n_te, seed=0, orig=orig: orig(n_train, n_test, seed)))


def contexts(tmp_path):
    return (jcommon.ExperimentContext("models", str(tmp_path / "j"), scale=SCALE),
            tcommon.ExperimentContext("models", str(tmp_path / "t"), scale=SCALE, device="cpu"))


def test_configs_match_jax(tmp_path):
    """The per-metric configurations are the JAX package's, key for key."""
    jctx, tctx = contexts(tmp_path)

    def plain(cfg):
        return {k: (v.__name__ if callable(v) else v) for k, v in cfg.items()}

    assert plain(tt1._config_mcpc(tctx)) == plain(jt1._config_mcpc(jctx))
    assert plain(tt1._config_mcpc(tctx, 10, 256)) == plain(jt1._config_mcpc(jctx, 10, 256))
    for kw in ({}, dict(input_size=30, hidden=256, activation="tanh", lr=0.7),
               dict(input_size=25, activation="tanh", lr=0.3)):
        assert plain(tt1._config_pc(tctx, **kw)) == plain(jt1._config_pc(jctx, **kw))


def test_get_models_mse_matches_jax(monkeypatch, tmp_path):
    """Seed 1's MSE row on one batch of 8 test images: ``mcpc_mse_1``
    (10-256-256 relu) and ``pc_mse_1`` (30-256-256 tanh) after 5 Adam steps
    at lr 0.7 from the same latents, and ``dlgm_mse_1``.  The rule of
    ``test_torch_pc_eval.py::test_get_mse_rec_matches_jax`` for an Adam
    chain: the MSEs within 1e-6 (both threshold the same logits), the
    latents within 1e-5 of the largest (that test holds latents of about 1
    to atol 1e-5; these reach about 5)."""
    small_mnist(monkeypatch)
    rng = np.random.default_rng(0)
    latents = [tuple(rng.uniform(-2, 2, (8, d)).astype(np.float32) for d in dims)
               for dims in ((10, 256, 256), (30, 256, 256))]
    jl, tl = list(latents), list(latents)
    seen = []

    def jsample(gen, inputs, key=None):
        gen.latents = tuple(jnp.asarray(x) for x in jl.pop(0))
        return gen.latents

    def tsample(gen, inputs, generator=None):
        gen.latents = latents_from_numpy(tl.pop(0), inputs.device)
        seen.append(gen)
        return gen.latents

    monkeypatch.setattr(mcpc.GenerativeModel, "sample_latents", jsample)
    monkeypatch.setattr(mt.GenerativeModel, "sample_latents", tsample)
    real = jfactory.get_pc_trainer

    def pallas_trainer(*a, **k):
        trainer = real(*a, **k)
        trainer.use_pallas = True
        return trainer

    monkeypatch.setattr(jfactory, "get_pc_trainer", pallas_trainer)
    jgens = []
    real_load = jcommon.load_generative_checkpoint
    monkeypatch.setattr(jt1, "load_generative_checkpoint",
                        lambda *a: jgens.append(real_load(*a)) or jgens[-1])
    jctx, tctx = contexts(tmp_path)
    want = jt1.get_models_mse(jctx, seeds=(1,), n_batches=1)
    got = tt1.get_models_mse(tctx, seeds=(1,), n_batches=1)
    assert not jl and not tl
    assert got.shape == want.shape == (1, 3)
    assert np.all(np.abs(got - want) <= 1e-6) and np.all((0 < got) & (got < 1))
    for tgen, jgen in zip(seen, jgens):
        for a, b in zip(tgen.latents, jgen.latents):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5 * np.abs(np.asarray(b)).max())


class _FixedDraws:
    """The same ancestral logits for both packages' ``sample_pc`` in
    ``module`` and the same probability images for both DLGMs'
    ``generate_samples``."""

    def __init__(self, monkeypatch, jmod, tmod, logits, probs):
        self.j, self.t = list(logits), list(logits)
        monkeypatch.setattr(jmod, "sample_pc", lambda n, gen, config, key=None,
                            is_return_hidden=False: jnp.asarray(self.j.pop(0)))
        monkeypatch.setattr(tmod, "sample_pc", lambda n, gen, config, generator=None,
                            is_return_hidden=False: torch.from_numpy(self.t.pop(0)))
        monkeypatch.setattr(jdlgm.DLGM, "generate_samples",
                            lambda self, n, is_return_hidden=False, key=None: jnp.asarray(probs))
        monkeypatch.setattr(tdlgm.DLGM, "generate_samples",
                            lambda self, n, is_return_hidden=False, eps=None, u=None:
                            torch.from_numpy(probs))


def test_get_models_fids_matches_jax(monkeypatch, tmp_path):
    """Seed 1's FID row on the same 200 samples a model, pixel features and
    the repository's cached statistics (read only): rtol 1e-6 (float32
    sigmoids, float64 moments)."""
    rng = np.random.default_rng(1)
    logits = [rng.normal(size=(200, 784)).astype(np.float32) * 3 for _ in range(2)]
    probs = rng.random((200, 28, 28)).astype(np.float32)
    draws = _FixedDraws(monkeypatch, jfid, tfid, logits, probs)
    jctx, tctx = contexts(tmp_path)
    want = jt1.get_models_fids(jctx, seeds=(1,), n_samples=200)
    got = tt1.get_models_fids(tctx, seeds=(1,), n_samples=200)
    assert not draws.j and not draws.t
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_get_models_ml_matches_jax(monkeypatch, tmp_path):
    """Seed 1's marginal-likelihood row on one validation batch of 1024 and
    the same 150 samples a model: rtol 1e-6."""
    small_mnist(monkeypatch)
    rng = np.random.default_rng(2)
    logits = [rng.normal(size=(150, 784)).astype(np.float32) * 3 for _ in range(2)]
    probs = rng.random((150, 28, 28)).astype(np.float32)
    draws = _FixedDraws(monkeypatch, jmetrics, tmetrics, logits, probs)
    jctx, tctx = contexts(tmp_path)
    want = jt1.get_models_ml(jctx, seeds=(1,), n_samples=150, n_batches=1)
    got = tt1.get_models_ml(tctx, seeds=(1,), n_samples=150, n_batches=1)
    assert not draws.j and not draws.t
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_load_dlgm_reads_the_checkpoint_or_warns(tmp_path):
    """``_load_dlgm`` gives the JAX package's parameters bit for bit, and a
    fresh model with a warning where the file is missing."""
    jctx, tctx = contexts(tmp_path)
    got = tt1._load_dlgm(tctx, "dlgm_ml_2", hidden=128, latent=10)
    want = jt1._load_dlgm(jctx, "dlgm_ml_2", hidden=128, latent=10)
    for a, b in zip(jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda t: t.numpy(), (got.gen_params, got.rec_params))),
            jax.tree_util.tree_leaves((want.gen_params, want.rec_params))):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.warns(RuntimeWarning, match="dlgm_fid_9"):
        tt1._load_dlgm(tctx, "dlgm_fid_9")


def test_train_dlgm_cli_writes_what_jax_reads(monkeypatch, tmp_path):
    """``--model dlgm --preset ml`` for 2 batches of 64: the native file
    holds the trained ``(gen, rec)``, which the JAX package loads into its
    DLGM of the same widths, equal bit for bit; the parameters moved."""
    small_mnist(monkeypatch, n_train=200, n_test=100)
    out = tmp_path / "dlgm_ml.msgpack"
    ttrain.main(["--model", "dlgm", "--preset", "ml", "--epochs", "1", "--batches-per-epoch",
                 "2", "--out", str(out), "--device", "cpu", "--seed", "3"])
    j = jdlgm.DLGM(784, 128, 10, factor_recog=1, key=0)
    loaded = jckpt.load_checkpoint(str(out), (j.gen_params, j.rec_params))
    fresh = tdlgm.DLGM(784, 128, 10, factor_recog=1, seed=3, device="cpu")
    mine = load_checkpoint(str(out), (fresh.gen_params, fresh.rec_params), device="cpu")
    for a, b, c in zip(jax.tree_util.tree_leaves(loaded),
                       jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), mine)),
                       jax.tree_util.tree_leaves(jax.tree_util.tree_map(
                           lambda t: t.numpy(), (fresh.gen_params, fresh.rec_params)))):
        np.testing.assert_array_equal(np.asarray(a), b)
        assert a.shape == c.shape
    assert not np.array_equal(np.asarray(loaded[0]["final"]["b"]),
                              fresh.gen_params["final"]["b"].numpy())


def test_train_resnet9_mask_cli_writes_what_jax_reads(monkeypatch, tmp_path):
    """``--model resnet9_mask`` for 2 batches of 128 (bottom halves): flax's
    ``from_bytes`` reads the file into the JAX package's masked ResNet-9,
    whose eval logits on 4 half images equal the port's within 2e-6 of the
    largest; the running statistics moved."""
    from flax import serialization

    small_mnist(monkeypatch, n_train=256, n_test=100)
    out = tmp_path / "r9m.msgpack"
    ttrain.main(["--model", "resnet9_mask", "--epochs", "1", "--batches-per-epoch", "2",
                 "--out", str(out), "--device", "cpu"])
    _, _, target = jr.init_resnet9(jax.random.PRNGKey(0), is_mask=True)
    variables = serialization.from_bytes(
        {"params": target.params, "batch_stats": target.batch_stats}, out.read_bytes())
    model, state = tr.load_resnet9(str(out), is_mask=True, device="cpu")
    assert int(state.batch_stats["conv1.1.num_batches_tracked"]) == 0
    assert not np.allclose(state.batch_stats["conv1.1.running_var"].numpy(), 1.0)
    x = np.random.default_rng(4).random((4, 1, 14, 28), dtype=np.float32)
    want = jr.ResNet9(is_mask=True).apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)),
                                          train=False)
    got = tr.make_eval_fn(model)(state, torch.from_numpy(x))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-6 * np.abs(np.asarray(want)).max()


def test_figure_2e_on_the_cpu(monkeypatch, tmp_path):
    """``comparison_ideal_observer`` at a small scale with the shipped
    ResNet-9: the four KLs finite and non-negative, every ``PCTrainer`` call
    through the chain (no engine call)."""
    small_mnist(monkeypatch, n_train=64, n_test=6024)
    calls = []
    real = mt.PCTrainer.train_on_batch

    def spy(self, *a, **k):
        out = real(self, *a, **k)
        calls.append((self.kernel_calls, self.engine_calls))
        return out

    monkeypatch.setattr(mt.PCTrainer, "train_on_batch", spy)
    ctx = tcommon.ExperimentContext("models", str(tmp_path), scale=0.002, device="cpu")
    _, state = tr.load_resnet9("models/resnet9.msgpack", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)  # the checkpoint is there
        kls = figure_2.comparison_ideal_observer(ctx, resnet_state=state)
    assert set(kls) == {"MCPC", "PC", "MC shuffled", "PC shuffled"}
    assert all(np.isfinite(v) and v >= 0 for v in kls.values())
    assert calls and all(e == 0 for _, e in calls)
