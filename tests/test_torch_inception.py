"""The port's pytorch-fid InceptionV3 graph (``eval/inception.py``) against
the JAX package's, with random weights drawn with numpy and sent to both
(no Inception weights ship with the repository): each primitive, one block
of each kind, the full pool3 graph at batch 1 and the state-dict import.
Tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopredictivecoding_tpu.eval import inception as ji
from montecarlopredictivecoding_tpu_torch.eval import inception as ti

torch.set_num_threads(1)


def random_state_dict(seed=0, spec=None):
    """A torchvision-layout state dict of random numpy arrays: kernels of
    variance 1/fan_in, batch norms off identity."""
    rng = np.random.default_rng(seed)
    sd = {}
    for path, c_in, c_out, k in spec or ji.conv_spec():
        sd[f"{path}.conv.weight"] = (rng.normal(size=(c_out, c_in) + k)
                                     / np.sqrt(c_in * k[0] * k[1])).astype(np.float32)
        sd[f"{path}.bn.weight"] = rng.uniform(0.8, 1.2, c_out).astype(np.float32)
        sd[f"{path}.bn.bias"] = rng.uniform(-0.1, 0.1, c_out).astype(np.float32)
        sd[f"{path}.bn.running_mean"] = rng.uniform(-0.1, 0.1, c_out).astype(np.float32)
        sd[f"{path}.bn.running_var"] = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
    return sd


def leaf(sd, path):
    return {"w": sd[f"{path}.conv.weight"], "bn_w": sd[f"{path}.bn.weight"],
            "bn_b": sd[f"{path}.bn.bias"], "bn_m": sd[f"{path}.bn.running_mean"],
            "bn_v": sd[f"{path}.bn.running_var"]}


def both(tree):
    """The same numpy tree as jax arrays and as tensors."""
    if isinstance(tree, dict):
        pairs = {k: both(v) for k, v in tree.items()}
        return ({k: v[0] for k, v in pairs.items()}, {k: v[1] for k, v in pairs.items()})
    return jnp.asarray(tree), torch.from_numpy(np.array(tree))


def close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


X = np.random.default_rng(1).normal(size=(2, 6, 13, 11)).astype(np.float32)


@pytest.mark.parametrize("stride,padding,k", [(1, (0, 0), (1, 1)), (2, (0, 0), (3, 3)),
                                              (1, (1, 1), (3, 3)), (1, (0, 3), (1, 7)),
                                              (1, (3, 0), (7, 1)), (1, 2, (5, 5))])
def test_conv2d_matches_jax(stride, padding, k):
    """Bias-free convolutions of every stride, padding and kernel shape the
    graph uses: within 1e-6 of the largest output (f32 sums in another
    order)."""
    w = np.random.default_rng(2).normal(size=(4, 6) + k).astype(np.float32)
    close(ti.conv2d(torch.from_numpy(X), torch.from_numpy(w), stride, padding),
          ji.conv2d(jnp.asarray(X), jnp.asarray(w), stride, padding), 1e-6)


def test_batch_norm_and_basic_conv_match_jax():
    """Eval-mode batch norm (eps 1e-3) and conv -> BN -> relu: within 1e-6 of
    the largest output."""
    sd = random_state_dict(3, [("m", 6, 5, (3, 3))])
    jp, tp = both(leaf(sd, "m"))
    close(ti.batch_norm(torch.from_numpy(X[:, :5]), tp), ji.batch_norm(jnp.asarray(X[:, :5]), jp),
          1e-6)
    close(ti.basic_conv(torch.from_numpy(X), tp, padding=(1, 1)),
          ji.basic_conv(jnp.asarray(X), jp, padding=(1, 1)), 1e-6)


@pytest.mark.parametrize("k,stride,padding", [(3, 2, 0), (3, 1, 1)])
def test_max_pool_matches_jax(k, stride, padding):
    """Max pools exactly (-inf padding on both sides)."""
    np.testing.assert_array_equal(ti.max_pool(torch.from_numpy(X), k, stride, padding).numpy(),
                                  np.asarray(ji.max_pool(jnp.asarray(X), k, stride, padding)))


def test_avg_pool_excludes_padding_like_jax():
    """The average over the real elements of each window only: rtol 1e-6."""
    got = ti.avg_pool_excl(torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(ji.avg_pool_excl(jnp.asarray(X))), rtol=1e-6,
                               atol=1e-7)
    ones = ti.avg_pool_excl(torch.ones(1, 1, 4, 4)).numpy()
    np.testing.assert_allclose(ones, 1.0, rtol=1e-7)


@pytest.mark.parametrize("size", [299, 35])
def test_resize_bilinear_matches_jax(size):
    """28 -> 299 (the graph's) and 13x11 -> 35: half-pixel centres, no
    antialias, within 2e-6 of the largest value."""
    x = np.random.default_rng(4).random((1, 3, 28, 28), dtype=np.float32)
    close(ti.resize_bilinear(torch.from_numpy(x), size), ji.resize_bilinear(jnp.asarray(x), size),
          2e-6)
    close(ti.resize_bilinear(torch.from_numpy(X), size), ji.resize_bilinear(jnp.asarray(X), size),
          2e-6)


BLOCKS = {
    "a": (ji._a_spec("blk", 192, 32), 192, lambda m, x, p: m.inception_a(x, p)),
    "b": (ji._b_spec("blk", 288), 288, lambda m, x, p: m.inception_b(x, p)),
    "c": (ji._c_spec("blk", 768, 128), 768, lambda m, x, p: m.inception_c(x, p)),
    "d": (ji._d_spec("blk", 768), 768, lambda m, x, p: m.inception_d(x, p)),
    "e avg": (ji._e_spec("blk", 1280), 1280, lambda m, x, p: m.inception_e(x, p, "avg")),
    "e max": (ji._e_spec("blk", 2048), 2048, lambda m, x, p: m.inception_e(x, p, "max")),
}


@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_matches_jax(kind):
    """One block of each kind (A to E, E with both pools) on a 1x c x 9x9
    input: within 1e-5 of the largest output (several f32 convolutions in
    another order)."""
    spec, c_in, call = BLOCKS[kind]
    sd = random_state_dict(5, spec)
    jp, tp = both({path.split(".", 1)[1]: leaf(sd, path) for path, *_ in spec})
    x = np.random.default_rng(6).random((1, c_in, 9, 9), dtype=np.float32)
    close(call(ti, torch.from_numpy(x), tp), call(ji, jnp.asarray(x), jp), 1e-5)


def test_conv_spec_and_random_params_match_jax():
    """The same 94 convolutions in the same order; random parameters of
    their shapes."""
    assert ti.conv_spec() == ji.conv_spec()
    assert len(ti.conv_spec()) == 94
    params = ti.init_inception_params(torch.Generator().manual_seed(0), device="cpu")
    w = params["Mixed_6e"]["branch7x7dbl_3"]["w"]
    assert tuple(w.shape) == (192, 192, 1, 7)
    assert float(params["Conv2d_1a_3x3"]["bn_v"].min()) == 1.0


def test_full_graph_at_batch_one_matches_jax():
    """The whole pool3 graph, through ``make_inception_features`` on both
    sides (grey to RGB, resize to 299, scale to [-1, 1]) with the same random
    state dict: the 2048 features within 1e-5 of the largest."""
    sd = random_state_dict(7)
    x = np.random.default_rng(8).random((1, 28, 28), dtype=np.float32)
    fn = ti.make_inception_features(weights=sd, device="cpu")
    # the cache tag names the weights (the JAX package's stays "inception")
    assert fn.tag == "inception-" + ti.params_digest(ti.load_torch_state_dict(sd, device="cpu"))
    got = fn(x)
    assert got.shape == (1, 2048) and np.isfinite(got).all()
    close(got, ji.make_inception_features(weights=sd)(x), 1e-5)


def test_state_dict_import(tmp_path):
    """A torch ``state_dict`` of tensors (with ``num_batches_tracked`` and
    the classifier, both ignored) or its ``torch.save`` file imports to
    the same tree the JAX package imports; a missing key and a wrong shape
    raise."""
    sd = random_state_dict(9)
    tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
    tsd["Conv2d_1a_3x3.bn.num_batches_tracked"] = torch.tensor(3)
    tsd["fc.weight"] = torch.zeros(1000, 2048)
    path = tmp_path / "inception.pt"
    torch.save(tsd, path)
    want = ji.load_torch_state_dict(sd)
    for got in (ti.load_torch_state_dict(tsd, device="cpu"),
                ti.load_torch_state_dict(str(path), device="cpu")):
        for p, *_ in ti.conv_spec():
            a, b = got, want
            for k in p.split("."):
                a, b = a[k], b[k]
            for k in b:
                np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    bad = dict(sd)
    del bad["Mixed_7c.branch_pool.bn.running_var"]
    with pytest.raises(KeyError, match="Mixed_7c.branch_pool"):
        ti.load_torch_state_dict(bad, device="cpu")
    bad = dict(sd)
    bad["Conv2d_1a_3x3.conv.weight"] = np.zeros((32, 3, 5, 5), np.float32)
    with pytest.raises(ValueError, match="expected"):
        ti.load_torch_state_dict(bad, device="cpu")


def test_make_inception_features_requires_weights(monkeypatch):
    monkeypatch.delenv(ti.WEIGHTS_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match="MCPC_INCEPTION_WEIGHTS"):
        ti.make_inception_features(device="cpu")
