"""The port's FID (``eval/fid.py``) and the MNIST fingerprint against the JAX
package: the moments and the distance, the reference statistics of the
synthetic split against the repository's caches, ResNet-9 features, the
post-processing of samples and ``get_fid`` on the same samples.  Nothing is
written under ``MNIST_data/``; statistics are built in ``tmp_path``.
Tolerances are stated per test.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.data import mnist as jmnist
from montecarlopredictivecoding_tpu.eval import fid as jfid
from montecarlopredictivecoding_tpu.models import resnet9 as jr
from montecarlopredictivecoding_tpu_torch.data import mnist as tmnist
from montecarlopredictivecoding_tpu_torch.eval import fid as tfid
from montecarlopredictivecoding_tpu_torch.models import resnet9 as tr

torch.set_num_threads(1)

CACHE = os.path.join("MNIST_data", "MNIST")


def test_compute_stats_and_fid_match_jax():
    """float64 on the host on both sides: the same code, so the moments
    agree exactly and the distances within 1e-12 relative."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(300, 12)).astype(np.float32)
    b = (1.3 * rng.normal(size=(250, 12)) + 0.4).astype(np.float32)
    for f in (a, b):
        t, j = tfid.compute_stats(f), jfid.compute_stats(f)
        np.testing.assert_array_equal(t.mu, j.mu)
        np.testing.assert_array_equal(t.sigma, j.sigma)
    ta, tb = tfid.compute_stats(a), tfid.compute_stats(b)
    ja, jb = jfid.compute_stats(a), jfid.compute_stats(b)
    np.testing.assert_allclose(tfid.compute_fid(ta, tb), jfid.compute_fid(ja, jb), rtol=1e-12)
    assert abs(tfid.compute_fid(ta, ta)) < 1e-8
    np.testing.assert_allclose(tfid._trace_sqrt_product(ta.sigma, tb.sigma),
                               jfid._trace_sqrt_product(ja.sigma, jb.sigma), rtol=1e-12)


def test_fid_stats_files_are_shared(tmp_path):
    """A file the port saves loads in the JAX package and back, with the
    ``source`` tag."""
    stats = tfid.compute_stats(np.random.default_rng(1).normal(size=(40, 5)))
    path = str(tmp_path / "sub" / "s.npz")
    stats.save(path, source="synthetic-v1n10000")
    j = jfid.FIDStats.load(path)
    np.testing.assert_array_equal(j.mu, stats.mu)
    with np.load(path) as z:
        assert str(z["source"]) == "synthetic-v1n10000"
    t = tfid.FIDStats.load(path)
    np.testing.assert_array_equal(t.sigma, stats.sigma)


def test_pixel_reference_stats_equal_the_repos_cache(tmp_path):
    """The port's pixel statistics of the synthetic split, built in a fresh
    root, equal the repository's cached ``*_pixel_features_synthetic-v1n10000``
    files to float64 rounding (rtol 1e-12): the same numpy data and float64
    moments.  The cache names and the ``source`` tag are the JAX package's."""
    val, test = tfid.make_mnist_fid_stats(tfid.pixel_features, root=str(tmp_path))
    for name, stats in (("val", val), ("test", test)):
        path = tmp_path / "MNIST" / f"{name}_img_pixel_features_synthetic-v1n10000.npz"
        assert path.is_file()
        with np.load(path) as z:
            assert str(z["source"]) == "synthetic-v1n10000"
        ref = jfid.FIDStats.load(os.path.join(
            CACHE, f"{name}_img_pixel_features_synthetic-v1n10000.npz"))
        np.testing.assert_allclose(stats.mu, ref.mu, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(stats.sigma, ref.sigma, rtol=1e-12, atol=1e-15)
    again = tfid.make_mnist_fid_stats(tfid.pixel_features, root=str(tmp_path))
    np.testing.assert_array_equal(again[1].sigma, test.sigma)


def _write_idx(path, arr):
    import struct

    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, arr.ndim))
        f.write(struct.pack(">" + "I" * arr.ndim, *arr.shape))
        f.write(arr.astype(np.uint8).tobytes())


def test_fingerprint_matches_jax(tmp_path):
    """The synthetic fallback's tag, the refusal without data, and the
    sha256 prefix of real IDX files: letter for letter the JAX package's."""
    assert tmnist.mnist_source_fingerprint(str(tmp_path)) == \
        jmnist.mnist_source_fingerprint(str(tmp_path)) == ("synthetic", "v1n10000")
    assert tmnist.mnist_source_fingerprint(str(tmp_path), n_synthetic_test=77) == \
        jmnist.mnist_source_fingerprint(str(tmp_path), n_synthetic_test=77)
    with pytest.raises(FileNotFoundError, match="synthetic fallback"):
        tmnist.mnist_source_fingerprint(str(tmp_path), allow_synthetic=False)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    rng = np.random.default_rng(2)
    for name, shape in (("train-images-idx3-ubyte", (5, 28, 28)), ("train-labels-idx1-ubyte", (5,)),
                        ("t10k-images-idx3-ubyte", (4, 28, 28)), ("t10k-labels-idx1-ubyte", (4,))):
        _write_idx(raw / name, rng.integers(0, 255, shape))
    got = tmnist.mnist_source_fingerprint(str(tmp_path))
    assert got == jmnist.mnist_source_fingerprint(str(tmp_path))
    assert got[0] == "idx" and len(got[1]) == 12


def test_resnet9_features_match_jax():
    """``make_resnet9_features`` on ``models/resnet9.msgpack``, 20 images in
    batches of 8: within 2e-6 of the largest feature (f32 convolutions in
    another order); the tag names the cache files."""
    from flax import serialization

    with open("models/resnet9.msgpack", "rb") as f:
        raw = serialization.msgpack_restore(f.read())
    jfn = jfid.make_resnet9_features(jr.ResNet9State(raw["params"], raw["batch_stats"], None),
                                     batch_size=8)
    _, state = tr.load_resnet9("models/resnet9.msgpack", device="cpu")
    tfn = tfid.make_resnet9_features(state, batch_size=8)
    assert tfn.tag == jfn.tag == "resnet9"
    imgs = np.random.default_rng(3).random((20, 28, 28), dtype=np.float32)
    got, want = tfn(imgs), jfn(imgs)
    assert got.shape == (20, 256)
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


class _FixedSamples:
    """The same logits for both packages' ``sample_pc`` (neither can draw
    the other's), one array a call in call order."""

    def __init__(self, monkeypatch, arrays):
        self.j, self.t = list(arrays), list(arrays)
        monkeypatch.setattr(jfid, "sample_pc", lambda n, gen, config, key=None,
                            is_return_hidden=False: jnp.asarray(self.j.pop(0)))
        monkeypatch.setattr(tfid, "sample_pc", lambda n, gen, config, generator=None,
                            is_return_hidden=False: torch.from_numpy(self.t.pop(0)))


@pytest.mark.parametrize("loss", ["bernoulli", "gaussian"])
def test_generated_images_match_jax(monkeypatch, loss):
    """The sample post-processing: sigmoid probabilities (Bernoulli, rtol
    1e-6: the JAX package takes scipy's expit) or the threshold at 0
    (Gaussian, exact)."""
    logits = np.random.default_rng(4).normal(size=(6, 784)).astype(np.float32) * 3
    _FixedSamples(monkeypatch, [logits])
    jcfg = {"loss_fn": mcpc.bernoulli_fn if loss == "bernoulli" else mcpc.fe_fn}
    tcfg = {"loss_fn": mt.bernoulli_fn if loss == "bernoulli" else mt.fe_fn}
    want = jfid.generated_images(None, jcfg, 6)
    got = tfid.generated_images(None, tcfg, 6)
    assert got.shape == (6, 28, 28)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_get_fid_on_the_same_samples_matches_jax(monkeypatch):
    """``get_fid`` with the same 300 logit samples, pixel features and the
    repository's cached statistics (read, not written): rtol 1e-6 (float32
    sigmoids, then float64 moments)."""
    rng = np.random.default_rng(5)
    logits = [rng.normal(size=(300, 784)).astype(np.float32) * 4 for _ in range(2)]
    fixed = _FixedSamples(monkeypatch, logits)
    before = sorted(os.listdir(CACHE))
    for is_test, lg in ((True, logits[0]), (False, logits[1])):
        want = jfid.get_fid(None, {"loss_fn": mcpc.bernoulli_fn}, n_samples=300, is_test=is_test)
        got = tfid.get_fid(None, {"loss_fn": mt.bernoulli_fn}, n_samples=300, is_test=is_test)
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert not fixed.j and not fixed.t
    assert sorted(os.listdir(CACHE)) == before


def test_inception_extractor_needs_weights(monkeypatch):
    from montecarlopredictivecoding_tpu_torch.eval import inception as tinc

    monkeypatch.delenv(tinc.WEIGHTS_ENV, raising=False)
    with pytest.raises(FileNotFoundError, match="MCPC_INCEPTION_WEIGHTS"):
        tfid.make_inception_features(device="cpu")
    with pytest.raises(FileNotFoundError, match="not found"):
        tfid.make_inception_features(weights="/nonexistent/inception.pt", device="cpu")
