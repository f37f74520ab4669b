"""The PC training entry point, the evaluation metrics, ancestral sampling
and figure 3 (a) of the port against the JAX package, on the same numpy
parameters, latents, batches and samples.

Where the JAX side runs a trainer it runs the fused chain in interpret mode
(``use_pallas=True``), as the port's trainer runs the chain's plain version
on CPU tensors; latents that either package would draw from its own
generator are handed to both instead.  Tolerances are stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu.ops as jops
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.eval import metrics as jmetrics
from montecarlopredictivecoding_tpu.eval import sampling as jsampling
from montecarlopredictivecoding_tpu.experiments import train_mnist as jtrain
from montecarlopredictivecoding_tpu.models import factory as jfactory
from montecarlopredictivecoding_tpu_torch.eval import metrics as tmetrics
from montecarlopredictivecoding_tpu_torch.eval import sampling as tsampling
from montecarlopredictivecoding_tpu_torch.experiments import common, figure_3
from montecarlopredictivecoding_tpu_torch.experiments import train_mnist as ttrain
from montecarlopredictivecoding_tpu_torch.models import get_model
from montecarlopredictivecoding_tpu_torch.utils import (
    latents_from_numpy,
    load_checkpoint,
    params_from_numpy,
)

torch.set_num_threads(1)


class SharedLatents:
    """Hands the same numpy latents to both packages' ``sample_latents``, one
    set a call, in call order (neither can draw the other's)."""

    def __init__(self, monkeypatch, latents_per_call):
        self.j, self.t = list(latents_per_call), list(latents_per_call)

        def jsample(gen, inputs, key=None):
            gen.latents = tuple(jnp.asarray(x) for x in self.j.pop(0))
            return gen.latents

        def tsample(gen, inputs, generator=None):
            gen.latents = latents_from_numpy(self.t.pop(0), inputs.device)
            return gen.latents

        monkeypatch.setattr(mcpc.GenerativeModel, "sample_latents", jsample)
        monkeypatch.setattr(mt.GenerativeModel, "sample_latents", tsample)

    def used_up(self):
        return not self.j and not self.t


def _pallas_pc_trainer(monkeypatch, module):
    """Make ``module.get_pc_trainer`` of the JAX package return trainers that
    take the fused chain (interpret mode) on the CPU."""
    real = jfactory.get_pc_trainer

    def get_pc_trainer(*a, **k):
        trainer = real(*a, **k)
        trainer.use_pallas = True
        return trainer

    monkeypatch.setattr(module, "get_pc_trainer", get_pc_trainer)


def _widths(config):
    return (config["input_size"], config["hidden_size"], config["hidden2_size"])


# ------------------------------------------------------------ PC training


def test_configs_match_jax():
    jc, tc = jtrain.pc_training_config(), ttrain.pc_training_config()
    assert set(jc) == set(tc)
    for k in jc:
        if k != "loss_fn":  # each package's own bernoulli_fn
            assert jc[k] == tc[k], k
    assert tc["loss_fn"].__name__ == jc["loss_fn"].__name__ == "bernoulli_fn"
    for preset in ("fid", "ml", "mse"):
        assert (ttrain.apply_preset(ttrain.pc_training_config(), preset, "pc")
                == {**jtrain.apply_preset(jtrain.pc_training_config(), preset, "pc"),
                    "loss_fn": tc["loss_fn"]})


def test_train_pc_batch_matches_jax(monkeypatch, tmp_path):
    """One ``train_pc`` batch at the ``ml`` preset's full width (25-128-128-784
    tanh), B=8, the full schedule (250 Adam MAP steps at lr 0.1, then Adam on
    the parameters at lr 0.001), on the same parameters, latents and batch.

    Latents after the batch atol 1e-5.  Parameters: Adam's first step is
    about lr * sign(g), so each entry is held to atol 1e-7 where its
    gradient is at least 1e-3 of its tensor's largest (an entry whose
    gradient were rounding noise could flip sign and differ by 2 lr); every
    entry within 2 lr + 1e-7, and gW0 exactly zero (W0 unchanged)."""
    _train_pc_batch_against_jax(monkeypatch, tmp_path, "ml", (25, 128, 128, 784), seed=3)


def test_train_pc_mse_preset_batch_matches_jax(monkeypatch, tmp_path):
    """One ``train_pc(preset="mse")`` batch at that preset's full width
    (30-256-256-784 tanh), B=8, its schedule cut to 40 Adam MAP steps at lr
    0.1 (both packages' ``pc_training_config`` patched alike), then Adam on
    the parameters at lr 0.001, on the same parameters, latents and batch,
    by the rule of the ``ml`` test above: latents atol 1e-5, parameters
    atol 1e-7 where the gradient is clear (at least 1e-3 of its tensor's
    largest) and 2 lr + 1e-7 elsewhere, more than 95% of the entries clear,
    W0 unchanged, and the checkpoint reloads bit for bit."""
    for module in (ttrain, jtrain):
        short = dict(module.pc_training_config(), T_pc=40)
        monkeypatch.setattr(module, "pc_training_config", lambda short=short: dict(short))
    _train_pc_batch_against_jax(monkeypatch, tmp_path, "mse", (30, 256, 256, 784), seed=5)


def _train_pc_batch_against_jax(monkeypatch, tmp_path, preset, dims, seed):
    """One ``train_pc`` batch of ``preset`` (a tanh model of ``dims``) in
    both packages on the same numpy parameters, latents and batch, held by
    the rule of ``test_train_pc_batch_matches_jax``."""
    B = 8
    config = ttrain.apply_preset(ttrain.pc_training_config(), preset, "pc")
    assert (*_widths(config), config["output_size"]) == dims
    rng = np.random.default_rng(seed)
    jm = mcpc.make_mlp_model(*dims, activation="tanh")
    params_np = jax.device_get(jm.init(jax.random.PRNGKey(seed - 1)))
    latents = tuple(rng.uniform(-10, 10, (B, d)).astype(np.float32) for d in _widths(config))
    data = (rng.random((B, 784)) > 0.5).astype(np.float32)
    labels = np.zeros(B, np.int64)

    monkeypatch.setattr(jtrain, "get_mnist_data", lambda cfg, seed=0: (
        [(jnp.asarray(data), jnp.asarray(labels))], None, None))
    monkeypatch.setattr(ttrain, "get_mnist_data", lambda cfg, seed=0, device="cpu": (
        [(torch.from_numpy(data), torch.from_numpy(labels))], None, None))
    real_j, real_t = jtrain.get_model, ttrain.get_model

    def jget(cfg, key=0):
        gen = real_j(cfg, key=key)
        gen.params = jax.tree_util.tree_map(jnp.asarray, params_np)
        return gen

    def tget(cfg, seed=0, device="cpu"):
        gen = real_t(cfg, seed, device=device)
        gen.params = params_from_numpy(params_np, device)
        return gen

    monkeypatch.setattr(jtrain, "get_model", jget)
    monkeypatch.setattr(ttrain, "get_model", tget)
    _pallas_pc_trainer(monkeypatch, jtrain)
    shared = SharedLatents(monkeypatch, [latents])
    grads = []
    real_chain = jops.mcpc_chain_pallas

    def spy(*a, **k):
        out = real_chain(*a, **k)
        grads.append(out[1])
        return out

    monkeypatch.setattr(jops, "mcpc_chain_pallas", spy)
    jgen = jtrain.train_pc(1, str(tmp_path / "j"), preset=preset, log=False)
    tgen = ttrain.train_pc(1, str(tmp_path / "t"), preset=preset, log=False, device="cpu")
    assert shared.used_up() and len(grads) == 1
    for a, b in zip(tgen.latents, jgen.latents):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    lr = config["optimizer_p_kwargs"]["lr"]
    n_clear = n_all = 0
    for i, (tp_, jp_, g) in enumerate(zip(tgen.params, jgen.params, grads[0])):
        for k in ("w", "b"):
            got, want, gk = tp_[k].numpy(), np.asarray(jp_[k]), np.abs(np.asarray(g[k]))
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr + 1e-7)
            clear = gk >= 1e-3 * max(float(gk.max()), 1e-30)
            if i > 0:
                n_clear += int(clear.sum())
                n_all += clear.size
            np.testing.assert_allclose(got[clear], want[clear], rtol=0, atol=1e-7)
    assert np.array_equal(tgen.params[0]["w"].numpy(), params_np[0]["w"])
    assert n_clear > 0.95 * n_all
    loaded = load_checkpoint(str(tmp_path / "t.msgpack"), tgen.params, device="cpu")
    for p, q in zip(loaded, tgen.params):
        assert all(torch.equal(p[k], q[k]) for k in q)


def test_main_trains_pc_on_the_cpu(monkeypatch, tmp_path):
    """``--model pc --preset mse`` (30-256-256-784 tanh) through the command
    line, one batch of a small data set with a short schedule."""
    from montecarlopredictivecoding_tpu_torch.data import mnist as tmnist

    orig = tmnist._synthetic_mnist
    monkeypatch.setattr(tmnist, "_synthetic_mnist",
                        lambda n_train, n_test, seed=0: orig(200, 100, seed))
    short = dict(ttrain.pc_training_config(), T_pc=3)
    monkeypatch.setattr(ttrain, "pc_training_config", lambda: dict(short))
    calls = []
    real = mt.PCTrainer.train_on_batch

    def spy(self, *a, **k):
        out = real(self, *a, **k)
        calls.append((self.kernel_calls, self.engine_calls, self.gen.model.modules[2].name))
        return out

    monkeypatch.setattr(mt.PCTrainer, "train_on_batch", spy)
    out = tmp_path / "cli" / "pc_mse.msgpack"
    ttrain.main(["--model", "pc", "--epochs", "1", "--batches-per-epoch", "1",
                 "--preset", "mse", "--out", str(out), "--device", "cpu"])
    assert calls == [(1, 0, "tanh")]
    like = get_model(dict(short, input_size=30, hidden_size=256, hidden2_size=256,
                          activation_fn="tanh"), 0, device="cpu").params
    loaded = load_checkpoint(str(out), like, device="cpu")
    assert tuple(loaded[1]["w"].shape) == (30, 256)
    init = get_model(dict(short, input_size=30, hidden_size=256, hidden2_size=256), 0,
                     device="cpu").params
    assert torch.equal(loaded[0]["w"], init[0]["w"])  # gW0 is zero
    assert not torch.equal(loaded[3]["b"], init[3]["b"])


# ------------------------------------------------------------ metrics

MSE_DIMS = (6, 10, 12, 16)


def _mse_config(pkg, activation):
    return {"input_size": MSE_DIMS[0], "hidden_size": MSE_DIMS[1],
            "hidden2_size": MSE_DIMS[2], "output_size": MSE_DIMS[3],
            "loss_fn": pkg.bernoulli_fn, "activation_fn": activation, "input_var": None,
            "T_pc": 30, "optimizer_x_fn_pc": "adam", "optimizer_x_kwargs_pc": {"lr": 0.3}}


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_get_mse_rec_matches_jax(monkeypatch, activation):
    """Masked-reconstruction MSE over two batches (B=6, 30 Adam steps at lr
    0.3 with the last half of the pixels clamped), the same parameters,
    latents and batches on both sides: the MSE within 1e-6 (both threshold
    the same logits), the latents after the last batch atol 1e-5."""
    B = 6
    rng = np.random.default_rng(5)
    jm = mcpc.make_mlp_model(*MSE_DIMS, activation=activation)
    params_np = jax.device_get(jm.init(jax.random.PRNGKey(4)))
    batches = [((rng.random((B, MSE_DIMS[3])) > 0.5).astype(np.float32), np.zeros(B, np.int64))
               for _ in range(2)]
    latents = [tuple(rng.uniform(-3, 3, (B, d)).astype(np.float32) for d in MSE_DIMS[:3])
               for _ in range(2)]
    shared = SharedLatents(monkeypatch, latents)
    jcfg, tcfg = _mse_config(mcpc, activation), _mse_config(mt, activation)
    jgen = mcpc.GenerativeModel(jm, key=0, params=params_np)
    tgen = mt.GenerativeModel(mt.make_mlp_model(*MSE_DIMS, activation=activation), 0,
                              params=params_from_numpy(params_np, "cpu"), device="cpu")

    def factory(gen, config):
        trainer = jfactory.get_pc_trainer(gen, config, is_mcpc=True, training=False)
        trainer.use_pallas = True
        return trainer

    jmse = jmetrics.get_mse_rec(jgen, jcfg, [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches],
                                trainer_factory=factory)
    tmse = tmetrics.get_mse_rec(tgen, tcfg, [(torch.from_numpy(x), torch.from_numpy(y))
                                             for x, y in batches])
    assert shared.used_up()
    assert abs(tmse - jmse) <= 1e-6 and 0.0 < tmse < 1.0
    for a, b in zip(tgen.latents, jgen.latents):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)
    decoded = tmetrics.decode_from_deepest_latent(tgen)
    np.testing.assert_allclose(decoded.numpy(),
                               np.asarray(jmetrics.decode_from_deepest_latent(jgen)),
                               rtol=0, atol=1e-5)


def test_get_marginal_likelihood_matches_jax(monkeypatch):
    """The same 300 ancestral logit samples handed to both (torch cannot
    draw ``jax.random``'s), two batches of 7, chunks of 3 rows: the estimate
    within rtol 1e-6 (float32 BCE sums of 16 features, the log-mean-exp in
    numpy as the JAX package takes it)."""
    rng = np.random.default_rng(6)
    logits = (4.0 * rng.normal(size=(300, 16))).astype(np.float32)
    logits[0, 0] = 30.0  # clamped to 20
    batches = [(rng.random((7, 16)) > 0.5).astype(np.float32) for _ in range(2)]
    seen = {}

    def fake(pkg, to):
        def sample_pc(n, gen, config, **kw):
            seen[pkg] = (n, kw.get("is_return_hidden"))
            return to(logits)
        return sample_pc

    monkeypatch.setattr(jmetrics, "sample_pc", fake("jax", jnp.asarray))
    monkeypatch.setattr(tmetrics, "sample_pc", fake("torch", torch.from_numpy))
    jml = jmetrics.get_marginal_likelihood(
        None, {"loss_fn": mcpc.bernoulli_fn}, [(jnp.asarray(b), None) for b in batches],
        n_samples=300, chunk=3)
    tml = tmetrics.get_marginal_likelihood(
        None, {"loss_fn": mt.bernoulli_fn}, [(torch.from_numpy(b), None) for b in batches],
        n_samples=300, chunk=3)
    assert seen == {"jax": (300, True), "torch": (300, True)}
    assert np.isfinite(tml) and tml < 0
    np.testing.assert_allclose(tml, jml, rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tmetrics.get_marginal_likelihood(None, {"loss_fn": mt.fe_fn}, [])


def test_kl_estimators_and_paired_stat_match_jax():
    """The nearest-neighbour KL on the same samples (rtol 1e-5: the same
    float32 distances summed in another order, the logs in float64), the
    discrete KL and both branches of the paired test exactly."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(400, 3)).astype(np.float32)
    y = (0.5 + 1.2 * rng.normal(size=(500, 3))).astype(np.float32)
    for chunk in (128, 2048):
        np.testing.assert_allclose(tmetrics.KLdivergence(x, y, chunk=chunk),
                                   jmetrics.KLdivergence(x, y, chunk=chunk), rtol=1e-5)
    assert tmetrics.KLdivergence(torch.from_numpy(x), y) > 0.1
    p, q = rng.random(10), rng.random(10)
    p[3] = 0.0
    assert tmetrics.kl_divergence_discrete(p, q) == jmetrics.kl_divergence_discrete(p, q)
    before = rng.normal(size=30)
    for after in (before + 0.3 + 0.1 * rng.normal(size=30),       # normal differences
                  before + rng.exponential(size=30) ** 3):        # skewed: Wilcoxon
        for side in ("two-sided", "greater", "less"):
            assert (tmetrics.get_paired_stat(before, after, side)
                    == jmetrics.get_paired_stat(before, after, side))


def test_sample_pc_moments_on_a_linear_model():
    """Ancestral samples of x0 ~ N(0.5, 1), hidden = 2 x0 + 0.3: the logits
    have mean 1.3 and variance 4, Gaussian draws (input_var 0.5) variance
    4.5, Bernoulli draws the mean of sigmoid(hidden); 20000 samples, means
    within 0.06, variances within 4%, as the JAX sampler's."""
    params = ({"w": torch.zeros((1, 1)), "b": torch.tensor([0.5])},
              {"w": torch.tensor([[2.0]]), "b": torch.tensor([0.3])})
    model = mt.PCModel([mt.Linear(1, 1), mt.PC(), mt.Linear(1, 1)])
    gen = mt.GenerativeModel(model, 11, params=params, device="cpu")
    n = 20000
    hidden = tsampling.sample_pc(n, gen, {"input_size": 1}, is_return_hidden=True)
    assert hidden.shape == (n, 1)
    assert abs(float(hidden.mean()) - 1.3) < 0.06 and abs(float(hidden.var()) / 4.0 - 1) < 0.04
    gauss = tsampling.sample_pc(n, gen, {"input_size": 1, "loss_fn": mt.fe_fn, "input_var": 0.5})
    assert abs(float(gauss.mean()) - 1.3) < 0.06 and abs(float(gauss.var()) / 4.5 - 1) < 0.04
    bern = tsampling.sample_pc(n, gen, {"input_size": 1, "loss_fn": mt.bernoulli_fn},
                               generator=torch.Generator().manual_seed(3))
    assert set(np.unique(bern.numpy())) <= {0.0, 1.0}
    want = float(torch.sigmoid(hidden).mean())
    assert abs(float(bern.mean()) - want) < 0.02
    # the JAX sampler, on the same model, has the same moments
    jgen = mcpc.GenerativeModel(mcpc.PCModel([mcpc.Linear(1, 1), mcpc.PC(), mcpc.Linear(1, 1)]),
                                key=0, params=jax.tree_util.tree_map(
                                    lambda t: jnp.asarray(t.numpy()), params))
    jh = np.asarray(jsampling.sample_pc(n, jgen, {"input_size": 1}, key=jax.random.PRNGKey(1),
                                        is_return_hidden=True))
    assert abs(jh.mean() - float(hidden.mean())) < 0.08
    assert abs(jh.var() / float(hidden.var()) - 1) < 0.06


# ------------------------------------------------------------ figure 3


def test_figure3_linear():
    """Panel (a) at the JAX test's scale (38 Adam steps, 1500 Langevin steps,
    in the step engine): the x0 samples' marginal has mean w*mu = 1.0 and
    variance w^2 + var = 5.0, within the JAX test's 0.5 and 2.0."""
    ctx = common.ExperimentContext("models", "unused", scale=0.15, device="cpu")
    res = figure_3.generation_linear_model(ctx)
    assert res["x0"].shape == (1500,)
    assert abs(res["mean"] - 1.0) < 0.5
    assert abs(res["var"] - 5.0) < 2.0


def test_figure3_non_linear_model_runs_the_chain(monkeypatch):
    """Panel (b) at 1/200 of its steps on the CPU: the warm start and the
    captured chain both take the fused chain (no engine call), and the
    frames are probabilities."""
    calls = []
    real = mt.PCTrainer.train_on_batch

    def spy(self, *a, **k):
        out = real(self, *a, **k)
        calls.append((self.T, self.kernel_calls, self.engine_calls))
        return out

    monkeypatch.setattr(mt.PCTrainer, "train_on_batch", spy)
    ctx = common.ExperimentContext("models", "unused", scale=0.005, device="cpu")
    res = figure_3.generation_non_linear_model(ctx)
    assert calls == [(2, 1, 0), (155, 1, 0)]
    ims = res["ims"]
    assert ims.shape == (155, 28, 28) and res["stride"] == 1 and res["start"] == 5
    assert np.isfinite(ims).all() and ims.min() >= 0.0 and ims.max() <= 1.0


def test_figure3_drawing(tmp_path):
    """The drawing functions write the JAX figure's files from small results."""
    ctx = common.ExperimentContext("models", str(tmp_path / "figs"), device="cpu")
    rng = np.random.default_rng(0)
    figure_3.draw_linear_model(ctx, {"x0": rng.normal(1.0, 2.2, 12)})
    figure_3.draw_non_linear_model(ctx, {"ims": rng.random((4, 28, 28)), "start": 1})
    for name in ("3a.svg", "3a.gif", "3b_and_4d.svg", "3b_and_4d.gif"):
        assert (tmp_path / "figs" / name).is_file(), name
