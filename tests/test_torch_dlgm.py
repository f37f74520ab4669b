"""The port's DLGM baseline (``models/cholesky.py``, ``models/dlgm.py``, the
DLGM checkpoint shims and ``experiments/dlgm_evaluate.py``) against the JAX
package, on the same numpy parameters, batches and draws.

``jax.random`` streams cannot be reproduced in torch, so the standard normals
a JAX function would draw from its key are drawn here with numpy and handed
to both: to the port as its ``eps`` argument, to the JAX side by computing
``z = mu + R eps`` with its own functions or by patching its sampler.  No
test needs the original reference code or its checkpoints.  Tolerances are
stated per test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from montecarlopredictivecoding_tpu.models import cholesky as jchol
from montecarlopredictivecoding_tpu.models import dlgm as jdlgm
from montecarlopredictivecoding_tpu.utils import checkpoint as jckpt
from montecarlopredictivecoding_tpu_torch.models import cholesky as tchol
from montecarlopredictivecoding_tpu_torch.models import dlgm as tdlgm
from montecarlopredictivecoding_tpu_torch.utils import checkpoint as tckpt

torch.set_num_threads(1)


def to_np(tree):
    """A tree of jax arrays or tensors as the same tree of numpy arrays."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def to_torch(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), to_np(tree))


def assert_trees_close(a, b, **tol):
    a, b = to_np(a), to_np(b)
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(x, y, **tol)


def small_pair(hidden=24, latent=6, seed=0):
    """A JAX DLGM and a port DLGM with the JAX one's parameters."""
    j = jdlgm.DLGM(784, hidden, latent, factor_recog=1, key=seed)
    t = tdlgm.DLGM(784, hidden, latent, factor_recog=1, seed=seed, device="cpu")
    t.gen_params, t.rec_params = to_torch(j.gen_params), to_torch(j.rec_params)
    t.set_optimizer(1e-3)
    return j, t


def binary_batch(rng, B):
    return (rng.random((B, 784)) > 0.6).astype(np.float32)


# ------------------------------------------------------------ factors

@pytest.mark.parametrize("name", ["CholeskyFactor", "DiagonalFactor", "RankOneFactor"])
@pytest.mark.parametrize("d", [1, 3, 5])
def test_factor_matches_jax(name, d):
    """R from the same free parameters within 2 f32 ulps (rtol 2.4e-7): the
    two libraries' ``exp`` round differently now and then."""
    jf, tf = getattr(jchol, name)(d), getattr(tchol, name)(d)
    assert tf.free_parameter_size() == jf.free_parameter_size()
    free = np.random.default_rng(d).normal(size=(4, jf.free_parameter_size())).astype(np.float32)
    np.testing.assert_allclose(tf.parameterize(torch.from_numpy(free)).numpy(),
                               np.asarray(jf.parameterize(jnp.asarray(free))), rtol=2.4e-7, atol=0)


@pytest.mark.parametrize("d,free", [(1, 1), (3, 6), (5, 15), (5, 5), (5, 10), (4, 7)])
def test_factor_from_free_size_matches_jax(d, free):
    """The same factor, or the same refusal (the ambiguous d=1 and d=3, and
    a width no factor has)."""
    try:
        want = type(jchol.factor_from_free_size(d, free)).__name__
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(" (")[0].split(" —")[0]):
            tchol.factor_from_free_size(d, free)
        return
    assert type(tchol.factor_from_free_size(d, free)).__name__ == want


def test_cholesky_gradient_reaches_free_parameters():
    free = torch.zeros(2, tchol.CholeskyFactor(4).free_parameter_size(), requires_grad=True)
    tchol.CholeskyFactor(4).parameterize(free).sum().backward()
    assert bool((free.grad != 0).all())


# ------------------------------------------------------------ forward, loss

def test_generative_and_recognition_forward_match_jax():
    """Both chains and the simple fc3/fc4 topology on the same parameters
    and latents: rtol 1e-5, atol 1e-6 (f32 products in another order)."""
    rng = np.random.default_rng(1)
    j, t = small_pair()
    z = [rng.normal(size=(5, d)).astype(np.float32) for d in j.latent_dim_list]
    assert_trees_close(tdlgm.generative_forward(t.gen_params, [torch.from_numpy(a) for a in z]),
                       jdlgm.generative_forward(j.gen_params, [jnp.asarray(a) for a in z]),
                       rtol=1e-5, atol=1e-6)
    x = binary_batch(rng, 5)
    assert_trees_close(tdlgm.recognition_forward(t.rec_params, t.factors, torch.from_numpy(x)),
                       jdlgm.recognition_forward(j.rec_params, j.factors, jnp.asarray(x)),
                       rtol=1e-5, atol=1e-6)
    simple = {"fc3": {"w": rng.normal(size=(6, 16)).astype(np.float32),
                      "b": rng.normal(size=16).astype(np.float32)},
              "fc4": {"w": rng.normal(size=(16, 784)).astype(np.float32),
                      "b": rng.normal(size=784).astype(np.float32)}}
    np.testing.assert_allclose(
        tdlgm.generative_forward(to_torch(simple), torch.from_numpy(z[0])).numpy(),
        np.asarray(jdlgm.generative_forward(simple, jnp.asarray(z[0]))), rtol=1e-5, atol=1e-6)


def test_shared_recognition_structure():
    params, factors = tdlgm.init_recognition_shared(torch.Generator().manual_seed(0), 784,
                                                    [4, 8], 16, device="cpu")
    jparams, _ = jdlgm.init_recognition_shared(jax.random.PRNGKey(0), 784, [4, 8], 16)
    assert jax.tree_util.tree_structure(to_np(params)) == jax.tree_util.tree_structure(
        to_np(jparams))
    assert all(a.shape == b.shape for a, b in zip(jax.tree_util.tree_leaves(to_np(params)),
                                                   jax.tree_util.tree_leaves(to_np(jparams))))
    mus, Rs = tdlgm.recognition_forward(params, factors, torch.zeros(3, 784))
    assert [tuple(m.shape) for m in mus] == [(3, 4), (3, 8)]


def test_optimal_hidden_dim_matches_jax():
    for dims, n in (([20, 256, 256], 300_000), ([10, 128, 128], 123_456)):
        for factor in (1, 3):
            assert tdlgm.optimal_hidden_dim_recog(dims, n, 784, factor) == \
                jdlgm.optimal_hidden_dim_recog(dims, n, 784, factor)
    j, t = small_pair()
    assert t.get_nparameters() == j.get_nparameters()


def test_dlgm_loss_matches_jax_with_saturation_and_the_quirk():
    """Probabilities with exact 0s and 1s (the -100 floor on both logs):
    the loss rtol 1e-6; it exceeds the textbook KL by 0.5·(d-1) a datum and
    a level (the reference's -1); its gradient with respect to the
    probabilities is finite."""
    rng = np.random.default_rng(2)
    B, dims = 6, [3, 5]
    recon = rng.random((B, 784)).astype(np.float32)
    recon[0, :10], recon[1, :10] = 0.0, 1.0
    x = binary_batch(rng, B)
    frees = [rng.normal(size=(B, 2 * d)).astype(np.float32) for d in dims]
    mus = [rng.normal(size=(B, d)).astype(np.float32) for d in dims]
    jR = [jchol.RankOneFactor(d).parameterize(jnp.asarray(f)) for d, f in zip(dims, frees)]
    tR = [tchol.RankOneFactor(d).parameterize(torch.from_numpy(f)) for d, f in zip(dims, frees)]
    want = float(jdlgm.dlgm_loss(jnp.asarray(recon), jnp.asarray(x),
                                 [jnp.asarray(m) for m in mus], jR))
    r = torch.from_numpy(recon).requires_grad_(True)
    got = tdlgm.dlgm_loss(r, torch.from_numpy(x), [torch.from_numpy(m) for m in mus], tR)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    got.backward()
    assert bool(torch.isfinite(r.grad).all())
    log_r, log_1mr = tdlgm._bce_logs(torch.from_numpy(recon))
    assert float(log_r[0, 0]) == -100.0 and float(log_1mr[1, 0]) == -100.0
    bce = -float(torch.sum(torch.from_numpy(x) * log_r + (1 - torch.from_numpy(x)) * log_1mr))
    textbook = 0.0
    for m, R, d in zip(mus, tR, dims):
        tr = torch.sum(R * R, dim=(-2, -1))
        ld = torch.log(torch.diagonal(R, dim1=-2, dim2=-1)).sum(-1)
        textbook += float(0.5 * torch.sum(torch.from_numpy(m).pow(2).sum(-1) + tr - 2 * ld - d))
    np.testing.assert_allclose(float(got) - bce - textbook,
                               0.5 * B * sum(d - 1 for d in dims), rtol=1e-4)


# ------------------------------------------------------------ training

def _jax_loss(x, eps, factors):
    def loss_fn(gp, rp):
        mus, Rs = jdlgm.recognition_forward(rp, factors, x)
        z = [mu + jnp.einsum("bij,bj->bi", R, e) for mu, R, e in zip(mus, Rs, eps)]
        return jdlgm.dlgm_loss(jdlgm.generative_forward(gp, z), x, mus, Rs)
    return loss_fn


def test_train_step_matches_jax():
    """One training step on the same batch and draws: the loss rtol 1e-5,
    every gradient tensor within 1e-5 of its largest entry (f32 sums over
    the batch in another order).  Then optax's Adam step: Adam's first step
    is about -lr·sign(g), so parameters are held to atol 1e-7 where the
    gradient is at least 1e-3 of its tensor's largest entry and to 2·lr
    elsewhere."""
    rng = np.random.default_rng(3)
    j, t = small_pair()
    B = 8
    x = binary_batch(rng, B)
    eps = [rng.normal(size=(B, d)).astype(np.float32) for d in j.latent_dim_list]
    jl, jg = jax.value_and_grad(_jax_loss(jnp.asarray(x), [jnp.asarray(e) for e in eps],
                                          j.factors), argnums=(0, 1))(j.gen_params, j.rec_params)
    tl, tg = t.loss_and_grads(torch.from_numpy(x), eps)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    grads_t, grads_j = jax.tree_util.tree_leaves(to_np(tg)), jax.tree_util.tree_leaves(to_np(jg))
    for a, b in zip(grads_t, grads_j):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(np.abs(b).max(), 1e-30))

    before = to_np((t.gen_params, t.rec_params))
    loss = t.train_step(torch.from_numpy(x), eps)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    tx = optax.adam(1e-3)
    updates, _ = tx.update(jg, tx.init((j.gen_params, j.rec_params)), (j.gen_params, j.rec_params))
    want = optax.apply_updates((j.gen_params, j.rec_params), updates)
    got = to_np((t.gen_params, t.rec_params))
    for g, a, b, p0 in zip(grads_j, jax.tree_util.tree_leaves(got),
                           jax.tree_util.tree_leaves(to_np(want)),
                           jax.tree_util.tree_leaves(before)):
        clear = np.abs(g) >= 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(a[clear], b[clear], rtol=0, atol=1e-7)
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-3 + 1e-7)
        assert not np.array_equal(a[clear], p0[clear])


def test_weight_decay_is_optax_chain():
    """``set_optimizer(lr, decay)`` is ``optax.chain(add_decayed_weights,
    adam)``: the same update on the same gradients within 2 f32 ulps of the
    0.01 steps (rtol 2.4e-7)."""
    rng = np.random.default_rng(4)
    j, t = small_pair()
    j.set_optimizer(1e-2, decay=0.1)
    t.set_optimizer(1e-2, decay=0.1)
    params = (j.gen_params, j.rec_params)
    grads = jax.tree_util.tree_map(lambda a: jnp.asarray(rng.normal(size=a.shape), jnp.float32),
                                   params)
    want, _ = j.tx.update(grads, j.opt_state, params)
    got, _ = t.tx.update(to_torch(grads), t.opt_state, (t.gen_params, t.rec_params))
    assert_trees_close(got, want, rtol=2.4e-7, atol=0)


# ------------------------------------------------------------ metrics

def test_get_mse_rec_on_the_checkpoint_matches_jax():
    """``dlgm_mse_1`` on one batch of 64: deterministic on both sides; the
    MSE within 1e-6 (both threshold the same probabilities at 0.5)."""
    rng = np.random.default_rng(5)
    j = jdlgm.DLGM(784, 256, 20, factor_recog=1, key=0)
    j.gen_params, j.rec_params = jckpt.load_checkpoint("models/dlgm_mse_1.msgpack",
                                                       (j.gen_params, j.rec_params))
    t = tdlgm.DLGM(784, 256, 20, factor_recog=1, seed=0, device="cpu")
    t.gen_params, t.rec_params = tckpt.load_checkpoint(
        "models/dlgm_mse_1.msgpack", (t.gen_params, t.rec_params), device="cpu")
    x = binary_batch(rng, 64)
    want = j.get_mse_rec([(jnp.asarray(x), None)])
    got = t.get_mse_rec([(torch.from_numpy(x), None)])
    assert abs(got - want) <= 1e-6 and 0.0 < got < 1.0


def test_get_marginal_likelihood_on_given_probabilities_matches_jax(monkeypatch):
    """The same 120 generated probability images on both sides, two batches
    of 9 in chunks of 4: rtol 1e-6 (f32 BCE sums of 784 features, the
    log-mean-exp in float64)."""
    rng = np.random.default_rng(6)
    j, t = small_pair()
    probs = rng.random((120, 28, 28)).astype(np.float32)
    probs[0, 0, :3] = [0.0, 1.0, 1e-9]
    monkeypatch.setattr(jdlgm.DLGM, "generate_samples",
                        lambda self, n, is_return_hidden=False, key=None: jnp.asarray(probs))
    batches = [binary_batch(rng, 9) for _ in range(2)]
    want = j.get_marginal_likelihood([(jnp.asarray(b), None) for b in batches],
                                     n_samples=120, chunk=4)
    got = t.get_marginal_likelihood([(torch.from_numpy(b), None) for b in batches],
                                    n_samples=120, chunk=4, probs=torch.from_numpy(probs))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_generate_samples_with_given_draws():
    """Prior draws handed in: the probabilities are the generative chain's
    (rtol 1e-5, atol 1e-6) and the Bernoulli samples compare the given
    uniforms with them."""
    rng = np.random.default_rng(7)
    j, t = small_pair()
    eps = [rng.normal(size=(5, d)).astype(np.float32) for d in j.latent_dim_list]
    probs = t.generate_samples(5, is_return_hidden=True, eps=eps)
    assert tuple(probs.shape) == (5, 28, 28)
    np.testing.assert_allclose(
        probs.numpy().reshape(5, -1),
        np.asarray(jdlgm.generative_forward(j.gen_params, [jnp.asarray(e) for e in eps])),
        rtol=1e-5, atol=1e-6)
    u = rng.random((5, 784)).astype(np.float32)
    bern = t.generate_samples(5, eps=eps, u=u)
    np.testing.assert_array_equal(bern.numpy().reshape(5, -1),
                                  (u <= probs.numpy().reshape(5, -1)).astype(np.float32))


def test_evaluate_importance_nll_matches_jax(monkeypatch):
    """The same particles' draws on both sides, two batches of 3 with 4
    particles: rtol 1e-5.  The JAX function is traced once, so its patched
    sampler gives every batch the same draws; the port is given those for
    each batch.  The q-density solves with tril(R) of the dense rank-one R,
    as the reference does."""
    rng = np.random.default_rng(8)
    j, t = small_pair()
    P, B = 4, 3
    batches = [binary_batch(rng, B) for _ in range(2)]
    eps = [rng.normal(size=(B * P, d)).astype(np.float32) for d in j.latent_dim_list]

    def sample(key, mus, Rs):
        return [mu + jnp.einsum("bij,bj->bi", R, jnp.asarray(x)) for mu, R, x in zip(mus, Rs, eps)]

    monkeypatch.setattr(jdlgm, "recognition_sample", sample)
    want = j.evaluate_importance_nll([(jnp.asarray(b), None) for b in batches], particle_size=P)
    got = t.evaluate_importance_nll([(torch.from_numpy(b), None) for b in batches],
                                    particle_size=P, eps=[eps, eps])
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # a dense solve would score other densities
    R = tdlgm.recognition_forward(t.rec_params, t.factors, torch.from_numpy(batches[0]))[1][0]
    assert not torch.allclose(torch.tril(R), R)


def test_test_elbo_matches_jax_loss():
    """``test_elbo`` with given draws: the mean of the training loss over
    the data, rtol 1e-5."""
    rng = np.random.default_rng(9)
    j, t = small_pair()
    x = binary_batch(rng, 4)
    eps = [rng.normal(size=(4, d)).astype(np.float32) for d in j.latent_dim_list]
    want = float(_jax_loss(jnp.asarray(x), [jnp.asarray(e) for e in eps], j.factors)(
        j.gen_params, j.rec_params)) / 4
    np.testing.assert_allclose(t.test_elbo([(torch.from_numpy(x), None)], eps=[eps]), want,
                               rtol=1e-5)


# ------------------------------------------------------------ checkpoints

@pytest.mark.parametrize("name", [f"dlgm_{m}_{s}" for m in ("fid", "ml", "mse")
                                  for s in (1, 2, 3)])
def test_shipped_checkpoints_load_into_the_ports_shapes(name):
    """Every ``models/dlgm_*.msgpack`` into the port's DLGM of its preset's
    widths, equal to what the JAX package loads, bit for bit."""
    hidden, latent = (128, 10) if "_ml_" in name else (256, 20)
    j = jdlgm.DLGM(784, hidden, latent, factor_recog=1, key=0)
    t = tdlgm.DLGM(784, hidden, latent, factor_recog=1, seed=0, device="cpu")
    path = f"models/{name}.msgpack"
    want = jckpt.load_checkpoint(path, (j.gen_params, j.rec_params))
    got = tckpt.load_checkpoint(path, (t.gen_params, t.rec_params), device="cpu")
    assert_trees_close(got, want, rtol=0, atol=0)


def _stacked_state_dict(rng, nested: bool):
    sd = {}
    dims = [4, 8, 8]
    for i in range(2):
        sd[f"generative_model.T_list.{i}.1.weight"] = rng.normal(size=(dims[i + 1], dims[i]))
        sd[f"generative_model.T_list.{i}.1.bias"] = rng.normal(size=dims[i + 1])
    sd["generative_model.final.1.weight"] = rng.normal(size=(784, 8))
    sd["generative_model.final.1.bias"] = rng.normal(size=784)
    if nested:
        sd["generative_model.bias.bias"] = rng.normal(size=4)
    for i, d in enumerate(dims):
        for k, shape in (("fc1", (12, 784)), ("fc21", (d, 12)), ("fc22", (2 * d, 12))):
            sd[f"recognition_model.node_list.{i}.{k}.weight"] = rng.normal(size=shape)
            sd[f"recognition_model.node_list.{i}.{k}.bias"] = rng.normal(size=shape[0])
    sd = {k: torch.tensor(v, dtype=torch.float32) for k, v in sd.items()}
    if nested:
        out = {}
        for k, v in sd.items():
            top, rest = k.split(".", 1)
            out.setdefault(top, {})[rest] = v
        return out
    return sd


def _simple_state_dict(rng):
    shapes = {"generative_model": {"fc3": (16, 6), "fc4": (784, 16)},
              "recognition_model": {"fc1": (16, 784), "fc21": (6, 16), "fc22": (12, 16)}}
    return {top: {f"{k}.{p}": torch.tensor(0.05 * rng.normal(size=s if p == "weight" else s[0]),
                                           dtype=torch.float32)
                  for k, s in mods.items() for p in ("weight", "bias")}
            for top, mods in shapes.items()}


@pytest.mark.parametrize("layout", ["stacked flat", "stacked nested", "simple"])
def test_torch_state_dict_shims_match_jax(layout):
    """The reference's DLGM state dicts into ``(gen, rec)`` exactly as the
    JAX package maps them; the simple topology back out to the reference's
    nested layout, equal to the JAX export and to the input."""
    rng = np.random.default_rng(10)
    if layout == "simple":
        sd = _simple_state_dict(rng)
    else:
        sd = _stacked_state_dict(rng, nested=layout.endswith("nested"))
    got = tckpt.torch_dlgm_state_dict_to_params(sd, device="cpu")
    want = jckpt.torch_dlgm_state_dict_to_params(sd)
    assert_trees_close(got, want, rtol=0, atol=0)
    if layout == "simple":
        back = tckpt.dlgm_params_to_torch_state_dict(*got)
        jback = jckpt.dlgm_params_to_torch_state_dict(*want)
        for top in sd:
            assert set(back[top]) == set(sd[top]) == set(jback[top])
            for k in sd[top]:
                assert torch.equal(back[top][k], sd[top][k])
                assert torch.equal(back[top][k], jback[top][k])
    else:
        with pytest.raises(ValueError, match="simple one-level"):
            tckpt.dlgm_params_to_torch_state_dict(*got)


def test_load_torch_dlgm_and_evaluate_cli(tmp_path, monkeypatch, capsys):
    """A reference-style simple DLGM file through ``dlgm_evaluate --torch``:
    the factor from the cov head's width (12 at latent 6: rank one), and
    the CLI's -ln p(v) is finite; the file loads as the JAX shim loads it."""
    from montecarlopredictivecoding_tpu_torch.data import mnist as tmnist
    from montecarlopredictivecoding_tpu_torch.experiments import dlgm_evaluate

    orig = tmnist._synthetic_mnist
    monkeypatch.setattr(tmnist, "_synthetic_mnist",
                        lambda n_train, n_test, seed=0: orig(10, 40, seed))
    sd = _simple_state_dict(np.random.default_rng(11))
    path = tmp_path / "dlgm_simple.pt"
    torch.save(sd, path)
    assert_trees_close(tckpt.load_torch_dlgm(str(path), device="cpu"),
                       jckpt.torch_dlgm_state_dict_to_params(sd), rtol=0, atol=0)
    nll = dlgm_evaluate.main(["--checkpoint", str(path), "--torch", "--particle-size", "3",
                              "--batch-size", "10", "--n-batches", "2", "--device", "cpu"])
    assert np.isfinite(nll) and "-ln p(v)" in capsys.readouterr().out
