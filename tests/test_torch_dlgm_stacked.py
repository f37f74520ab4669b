"""The port's stacked DLGM (``models/dlgm_stacked.py``) against the JAX
package's on the CPU: the same parameters (the JAX initialisation, as
numpy) and the same draws handed to both.

Tolerances: probabilities and log-densities rtol 1e-5, atol 1e-6 (f32
products summed in another order); the masked-reconstruction MSE to 1e-6
(a threshold at 0.5 of those probabilities); the marginal likelihood rtol
1e-6 (its log-mean-exp in float64); the importance-sampled NLL rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopredictivecoding_tpu.models import cholesky as jchol
from montecarlopredictivecoding_tpu.models import dlgm_stacked as jst
from montecarlopredictivecoding_tpu_torch.models import cholesky as tchol
from montecarlopredictivecoding_tpu_torch.models import dlgm_stacked as tst

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def to_np(tree):
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def to_torch(tree):
    """A JAX tree's arrays as CPU tensors; ints and tuples of ints stay."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_torch(v) for v in tree]
    if isinstance(tree, tuple) and all(isinstance(v, int) for v in tree):
        return tree
    return torch.from_numpy(np.array(tree))


def _pair(latent=(4, 3), hidden=(5, 4), T_hidden=(6, 7), out=16, rec_hidden=(8, 9),
          factor="CholeskyFactor"):
    key = jax.random.PRNGKey(0)
    jgen = jst.init_generative_stacked(key, list(hidden), list(latent), list(T_hidden), out)
    jrec, jfactors = jst.init_recognition_stacked(
        jax.random.PRNGKey(1), list(latent), list(rec_hidden),
        factor_cls=getattr(jchol, factor), input_dim=out)
    tfactors = [getattr(tchol, factor)(d) for d in latent]
    return (jgen, jrec, jfactors), (to_torch(jgen), to_torch(jrec), tfactors)


def test_init_structure_matches_jax():
    g = torch.Generator().manual_seed(0)
    for name, preset in jst.MNIST_PRESETS.items():
        assert tst.MNIST_PRESETS[name] == preset
        jgen = jst.init_generative_stacked(jax.random.PRNGKey(0), **preset)
        tgen = tst.init_generative_stacked(g, **preset, device="cpu")
        assert jax.tree_util.tree_structure(to_np(tgen)) == jax.tree_util.tree_structure(
            to_np(jgen))
        for a, b in zip(jax.tree_util.tree_leaves(to_np(tgen)),
                        jax.tree_util.tree_leaves(to_np(jgen))):
            assert np.shape(a) == np.shape(b)
    assert tst.RECOGNITION_PRESETS == jst.RECOGNITION_PRESETS
    trec, tf = tst.init_recognition_stacked(g, [3, 2], [8, 6], input_dim=10, device="cpu")
    jrec, jf = jst.init_recognition_stacked(jax.random.PRNGKey(0), [3, 2], [8, 6], input_dim=10)
    assert [f.free_parameter_size() for f in tf] == [f.free_parameter_size() for f in jf]
    for a, b in zip(jax.tree_util.tree_leaves(to_np(trec)), jax.tree_util.tree_leaves(to_np(jrec))):
        assert np.shape(a) == np.shape(b)
    w = tgen["final"]["a"]["w"]
    assert float(w.abs().max()) <= 1.0 / w.shape[0] ** 0.5


def test_generative_forward_and_prior_match_jax():
    (jgen, _, _), (tgen, _, _) = _pair()
    rng = np.random.default_rng(0)
    z = [rng.normal(size=(5, d)).astype(np.float32) for d in (4, 3)]
    got = tst.generative_stacked_forward(tgen, [torch.from_numpy(x) for x in z])
    want = jst.generative_stacked_forward(jgen, [jnp.asarray(x) for x in z])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tst.log_prob_prior([torch.from_numpy(x) for x in z]).numpy(),
                               np.asarray(jst.log_prob_prior([jnp.asarray(x) for x in z])), **TOL)
    drawn = tst.sample_prior_stacked(5, tgen["latent_dim_list"], torch.Generator().manual_seed(1),
                                     device="cpu")
    assert [tuple(x.shape) for x in drawn] == [(5, 4), (5, 3)]
    given = tst.sample_prior_stacked(5, (4, 3), eps=z, device="cpu")
    assert all(np.array_equal(a.numpy(), b) for a, b in zip(given, z))


@pytest.mark.parametrize("factor", ["CholeskyFactor", "DiagonalFactor", "RankOneFactor"])
def test_recognition_matches_jax(factor):
    """Means, factors, the given draws' samples and the exact log-density."""
    (_, jrec, jf), (_, trec, tf) = _pair(factor=factor)
    rng = np.random.default_rng(1)
    x = (rng.random((6, 16)) > 0.5).astype(np.float32)
    jmus, jRs = jst.recognition_stacked_forward(jrec, jf, jnp.asarray(x))
    tmus, tRs = tst.recognition_stacked_forward(trec, tf, torch.from_numpy(x))
    for a, b in zip(tmus + tRs, jmus + jRs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    eps = [rng.normal(size=(6, d)).astype(np.float32) for d in (4, 3)]
    z = tst.recognition_sample_stacked(tmus, tRs, eps=eps)
    jz = [mu + jnp.einsum("bij,bj->bi", R, jnp.asarray(e)) for mu, R, e in zip(jmus, jRs, eps)]
    for a, b in zip(z, jz):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tst.recognition_log_prob(z, tmus, tRs).numpy(),
                               np.asarray(jst.recognition_log_prob(jz, jmus, jRs)), **TOL)
    assert tst.stacked_loss is tst.dlgm_loss


def test_metrics_match_jax(monkeypatch):
    """``StackedMetrics`` on shared parameters: generation from given draws,
    the masked-reconstruction MSE, the marginal likelihood of given
    probabilities and the importance-sampled NLL of given particle draws."""
    (jgen, jrec, jf), (tgen, trec, tf) = _pair(out=784, rec_hidden=(12, 10))
    jm = jst.StackedMetrics(jgen, jrec, jf, key=0)
    tm = tst.StackedMetrics(tgen, trec, tf, seed=0)
    rng = np.random.default_rng(2)
    batches = [(rng.random((B, 784)) > 0.6).astype(np.float32) for B in (7, 5)]
    jb = [(jnp.asarray(b), None) for b in batches]
    tb = [(torch.from_numpy(b), None) for b in batches]

    eps = [rng.normal(size=(9, d)).astype(np.float32) for d in (4, 3)]
    probs = tm.generate(9, is_return_hidden=True, eps=eps)
    np.testing.assert_allclose(probs.numpy(), np.asarray(
        jst.generative_stacked_forward(jgen, [jnp.asarray(e) for e in eps])), **TOL)
    u = rng.random((9, 784)).astype(np.float32)
    np.testing.assert_array_equal(tm.generate(9, eps=eps, u=u).numpy(),
                                  (u <= probs.numpy()).astype(np.float32))
    assert tuple(tm.generate(3).shape) == (3, 784)

    assert abs(tm.get_mse_rec(tb) - jm.get_mse_rec(jb)) <= 1e-6

    given = rng.random((40, 784)).astype(np.float32)
    monkeypatch.setattr(jst.StackedMetrics, "generate",
                        lambda self, n, is_return_hidden=False: jnp.asarray(given))
    np.testing.assert_allclose(
        tm.get_marginal_likelihood(tb, n_samples=40, chunk=3, probs=torch.from_numpy(given)),
        jm.get_marginal_likelihood(jb, n_samples=40, chunk=3), rtol=1e-6)

    P = 4
    draws = [[rng.normal(size=(b.shape[0] * P, d)).astype(np.float32) for d in (4, 3)]
             for b in batches]
    calls = iter(draws)

    def sample(key, mus, Rs):  # traced once a batch shape: batch i's draws
        return [mu + jnp.einsum("bij,bj->bi", R, jnp.asarray(x))
                for mu, R, x in zip(mus, Rs, next(calls))]

    monkeypatch.setattr(jst, "recognition_sample_stacked", sample)
    want = jm.importance_nll(jb, particle_size=P)
    got = tm.importance_nll(tb, particle_size=P, eps=draws)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.isfinite(got) and got > 0


def test_get_acc_runs():
    (_, _, _), (tgen, trec, tf) = _pair(out=20)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.random((30, 20)) > 0.5).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, 30))
    best, clf = tst.StackedMetrics(tgen, trec, tf).get_acc([(x, labels)])
    assert 0.0 <= best <= 1.0 and tuple(clf.params["w"].shape) == (4, 10)
