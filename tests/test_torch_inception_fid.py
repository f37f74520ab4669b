"""Table 1's FID with InceptionV3 features in the port (``eval/fid.py``,
``eval/inception.py``) against the benchmark's plain reference
``port_bench/reference/inception.py`` (plain ``torch`` modules written from
pytorch-fid), on the CPU, with seeded weights whose BatchNorms are not the
identity: the pool3 features; ``get_fid`` with the Inception extractor
against the reference pipeline; the moments and distance on tensors against
the numpy path; the planted faults the benchmark's comparison must catch;
the ``mcpc.fid.*`` spans; the extractor's batch counter; and the cache
tag that names the weights.  No JAX here.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from montecarlopredictivecoding_tpu_torch.core.losses import bernoulli_fn
from montecarlopredictivecoding_tpu_torch.core.model import make_mlp_model
from montecarlopredictivecoding_tpu_torch.core.trainer import GenerativeModel
from montecarlopredictivecoding_tpu_torch.data import mnist
from montecarlopredictivecoding_tpu_torch.eval import fid
from montecarlopredictivecoding_tpu_torch.eval import inception as inc
from montecarlopredictivecoding_tpu_torch.utils import observability as obs
from port_bench.reference import inception as ref

torch.set_num_threads(1)

CPU = torch.device("cpu")
DIMS = (20, 128, 128, 784)
# float32 through 94 convolutions against float64: the worst row's largest
# element gap over its largest element read 3.6e-7 to 4e-7 here; a fault
# below moves it by 1.8e-2 or more
FEATURE_TOL = 1e-5
SPANS = ("mcpc.fid.sample", "mcpc.fid.features", "mcpc.fid.stats", "mcpc.fid.distance")


@pytest.fixture(scope="module")
def weights():
    return ref.random_state_dict(2027)


@pytest.fixture(scope="module")
def reference(weights):
    return ref.build(weights, torch.float64, CPU)


def images(n, seed):
    return np.random.default_rng(seed).random((n, 28, 28), dtype=np.float32)


def worst_row_gap(got, want) -> float:
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float(((got - want).abs().amax(1) / want.abs().amax(1)).max())


def test_pool3_features_match_the_reference(weights, reference):
    """Three images through ``make_inception_features`` (float32, the port's
    functional graph) and the reference modules in float64: within
    ``FEATURE_TOL`` of each row's largest feature.  The BatchNorms are not
    the identity, so a skipped one could not pass."""
    bn = weights["Mixed_6e.branch7x7dbl_3.bn.running_var"]
    assert float((bn - 1.0).abs().max()) > 0.1
    x = images(3, 1)
    fn = inc.make_inception_features(weights=weights, device="cpu")
    got = fn(x)
    assert got.shape == (3, ref.FEATURES) and fn.batches == 1
    assert worst_row_gap(got, ref.pool3_features(reference, torch.from_numpy(x))) <= FEATURE_TOL


def _generator_params(seed):
    g = torch.Generator().manual_seed(seed)
    return make_mlp_model(*DIMS, activation="relu").init(g, torch.float32, "cpu")


def _cache_stats(root, fn, mu, sigma):
    """Statistics under ``fn``'s cache names, so ``get_fid`` reads them
    instead of building them from 10,000 images."""
    source, digest = mnist.mnist_source_fingerprint(str(root))
    for split in ("val", "test"):
        fid.FIDStats(mu, sigma).save(
            str(root / "MNIST" / f"{split}_img_{fn.tag}_{source}-{digest}.npz"),
            source=f"{source}-{digest}")


def test_get_fid_with_inception_matches_the_reference_pipeline(tmp_path, weights):
    """``get_fid`` as table 1 calls it, at 70 samples (batches of 64 and 6),
    against the reference pipeline: the ancestral pass from the normals the
    call's generator draws, the features, float64 moments and the
    distance.  The reference runs in float32 here (float64 takes
    twice the time on this CPU); the two float32 pipelines differ in
    summation order only, 1e-7 to 1e-6 of the FID, and 2e-5 leaves room."""
    params = _generator_params(5)
    gen = GenerativeModel(make_mlp_model(*DIMS, activation="relu"), torch.Generator(),
                          params=params, device="cpu")
    cfg = {"input_size": DIMS[0], "loss_fn": bernoulli_fn}
    g = torch.Generator().manual_seed(11)
    normals = [torch.randn((70, d), generator=g) for d in DIMS[:3]]
    want_images = ref.ancestral_images(params, normals, torch.float32)
    want_features = ref.pool3_features(ref.build(weights, torch.float32, CPU), want_images)
    mu, sigma = ref.moments(want_features)
    # test statistics a distribution apart from the samples'
    test_mu, test_sigma = mu + 0.05 * mu.abs().mean(), 0.5 * sigma + 1e-3 * torch.eye(len(mu))
    fn = inc.make_inception_features(weights=weights, device="cpu")
    _cache_stats(tmp_path, fn, test_mu.numpy(), test_sigma.numpy())
    got = fid.get_fid(gen, cfg, n_samples=70, is_test=True, feature_fn=fn, root=str(tmp_path),
                      generator=torch.Generator().manual_seed(11))
    assert fn.batches == 2
    want = ref.frechet_distance(mu, sigma, test_mu, test_sigma)
    assert want > 1.0
    assert abs(got - want) <= 2e-5 * want
    fn.batches = 0  # resets by assignment
    fn(images(1, 9))
    assert fn.batches == 1


def numpy_fid(a, b, eps=1e-6):
    """The float64 distance in numpy, in the PSD form the JAX package takes."""
    s1 = a.sigma + eps * np.eye(len(a.mu))
    s2 = b.sigma + eps * np.eye(len(b.mu))
    vals1, vecs1 = np.linalg.eigh(s1)
    root1 = (vecs1 * np.sqrt(np.clip(vals1, 0.0, None))) @ vecs1.T
    lam = np.linalg.eigvalsh(root1 @ s2 @ root1)
    diff = a.mu - b.mu
    return float(diff @ diff + np.trace(s1) + np.trace(s2)
                 - 2.0 * np.sqrt(np.clip(lam, 0.0, None)).sum())


def test_tensor_moments_and_distance_match_the_numpy_path():
    """The float64 moments on tensors (here on the CPU; on the card on the
    extractor's device) against the numpy moments that the JAX parity tests
    hold, and the distance (torch in float64, one path) against the numpy
    float64 form: to 1e-12 relative (the same formulas, sums in another
    order), with the statistics as tensors, as numpy, or one of each; a
    numpy array with a device gives tensors there."""
    rng = np.random.default_rng(3)
    a = rng.normal(size=(300, 40)).astype(np.float32)
    b = (1.3 * rng.normal(size=(250, 40)) + 0.4).astype(np.float32)
    na, nb = fid.compute_stats(a), fid.compute_stats(b)
    ta, tb = fid.compute_stats(torch.from_numpy(a)), fid.compute_stats(b, device=CPU)
    for t, n in ((ta, na), (tb, nb)):
        assert isinstance(t.mu, torch.Tensor) and t.sigma.dtype == torch.float64
        np.testing.assert_allclose(t.mu.numpy(), n.mu, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(t.sigma.numpy(), n.sigma, rtol=1e-12, atol=1e-14)
    want = numpy_fid(na, nb)
    for s1, s2 in ((ta, tb), (ta, nb), (na, tb), (na, nb)):
        got = fid.compute_fid(s1, s2)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-12)
    assert abs(fid.compute_fid(ta, ta)) < 1e-8


FAULTS = {
    "avg_pools_count_padding": ("avg_pool_excl", lambda orig: (
        lambda x, k=3, stride=1, padding=1: F.avg_pool2d(x, k, stride, padding,
                                                         count_include_pad=True))),
    "mixed_7c_average_pool": ("inception_e", lambda orig: (
        lambda x, p, pool: orig(x, p, "avg"))),
    "resize_align_corners": ("resize_bilinear", lambda orig: (
        lambda x, size: F.interpolate(x, size=(size, size), mode="bilinear",
                                      align_corners=True))),
    "batch_norm_skipped": ("batch_norm", lambda orig: (lambda x, p: x)),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_planted_faults_fail_the_feature_comparison(monkeypatch, weights, reference, fault):
    """Each fault the benchmark plants on the card, planted in the port's
    graph: the features part from the reference's by far more than
    ``FEATURE_TOL``."""
    attr, make = FAULTS[fault]
    monkeypatch.setattr(inc, attr, make(getattr(inc, attr)))
    x = images(2, 4)
    got = inc.make_inception_features(weights=weights, device="cpu")(x)
    assert worst_row_gap(got, ref.pool3_features(reference, torch.from_numpy(x))) > 100 * FEATURE_TOL


def test_fid_spans_record_under_a_profiler_and_change_no_bit(tmp_path):
    """The four ``mcpc.fid.*`` spans land in a profiler's trace, once a call,
    on the device path of the moments (an extractor with a ``device``; raw
    pixels stand in for InceptionV3, whose 2048-wide ``eigh`` takes seconds
    on this CPU); the FID is bit for bit the same without a profiler."""
    params = _generator_params(6)
    gen = GenerativeModel(make_mlp_model(*DIMS, activation="relu"), torch.Generator(),
                          params=params, device="cpu")
    cfg = {"input_size": DIMS[0], "loss_fn": bernoulli_fn}

    def fn(x):
        return fid.pixel_features(x)

    fn.tag, fn.device = "pixels-on-device", CPU
    rng = np.random.default_rng(7)
    _cache_stats(tmp_path, fn, rng.random(DIMS[3]), 0.1 * np.eye(DIMS[3]))

    def score():
        return fid.get_fid(gen, cfg, n_samples=40, is_test=True, feature_fn=fn,
                           root=str(tmp_path), generator=torch.Generator().manual_seed(3))

    with obs.profile_trace(str(tmp_path / "trace")) as prof:
        traced = score()
    counts = {e.key: e.count for e in prof.key_averages()}
    assert all(counts.get(s) == 1 for s in SPANS), sorted(counts)
    assert score() == traced


def test_cache_tag_names_the_weights(monkeypatch, tmp_path, weights):
    """Two sets of weights give two tags and two pairs of cache files, so
    ``make_mnist_fid_stats`` never reads one's statistics for the other; the
    same weights give the same tag.  (The reference split is cut to 2 + 2
    images here.)"""
    small = mnist._synthetic_mnist(4, 8)
    monkeypatch.setattr(mnist, "load_mnist_arrays",
                        lambda root="MNIST_data", allow_synthetic=True: small)
    monkeypatch.setattr(fid, "VAL_IMAGES", 2)
    monkeypatch.setattr(fid, "TEST_IMAGES", 2)
    other = ref.random_state_dict(2028)
    fa = inc.make_inception_features(weights=weights, device="cpu")
    fb = inc.make_inception_features(weights=other, device="cpu")
    assert fa.tag != fb.tag and fa.tag.startswith("inception-")
    assert inc.make_inception_features(weights=dict(weights), device="cpu").tag == fa.tag
    sa = fid.make_mnist_fid_stats(fa, root=str(tmp_path))
    sb = fid.make_mnist_fid_stats(fb, root=str(tmp_path))
    files = sorted(p.name for p in (tmp_path / "MNIST").iterdir())
    assert len(files) == 4 and sum(fa.tag in f for f in files) == 2
    assert fa.batches == fb.batches == 2
    assert not np.allclose(fid._host(sa[1].mu), fid._host(sb[1].mu))
    again = fid.make_mnist_fid_stats(fb, root=str(tmp_path))
    assert fb.batches == 2
    np.testing.assert_array_equal(again[1].sigma, fid._host(sb[1].sigma))
