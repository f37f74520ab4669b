"""Fréchet distance, in process: samples -> features -> Gaussian moments ->
the closed-form distance.

The JAX package's ``eval/fid.py``.  Features are computed on the device in
batches and come back as numpy.  The moments and the distance are float64:
the moments in numpy on the host for an extractor without a ``device`` (raw
pixels, ResNet-9), in torch on the extractor's ``device`` for one that
names it (InceptionV3, whose 2048 features make the host's ``eigh`` and
products of 2048 x 2048 matrices the slow part of a call); the distance in
torch on the device of the statistics held as tensors, else on the CPU.
The default extractor is raw pixels; ``make_resnet9_features`` takes the
ResNet-9 ideal observer's penultimate layer and ``make_inception_features``
the paper-comparable InceptionV3 pool3 (it needs weights).  The reference
statistics are cached under
``<root>/MNIST/{val,test}_img_<tag>_<source>-<digest>.npz``, the JAX
package's names and layout, so both packages share the pixel and ResNet-9
files (the Inception tag names its weights, ``eval/inception.py``).

``get_fid`` marks its four stages with the program's spans
(``utils/observability.span``): ``mcpc.fid.sample``, ``mcpc.fid.features``,
``mcpc.fid.stats`` and ``mcpc.fid.distance``.
"""

from __future__ import annotations

import dataclasses
import os
import typing as tp

import numpy as np
import torch

from ..core.losses import bernoulli_fn, fe_fn
from ..utils.observability import span
from .sampling import sample_pc

Array = tp.Union[np.ndarray, torch.Tensor]

# the reference's split of the MNIST test set: validation statistics over
# its first 6000 images, test statistics over the 4000 after them
VAL_IMAGES = 6000
TEST_IMAGES = 4000


def _host(a: Array) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class FIDStats:
    """The features' mean and covariance: numpy arrays, or float64 tensors
    on the device that computed them."""

    mu: Array
    sigma: Array

    def save(self, path: str, source: str = ""):
        """``.npz`` with ``mu``, ``sigma`` and ``source``, the data's
        provenance (``"synthetic-v1n10000"``, ``"idx-<sha256 prefix>"``)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, mu=_host(self.mu), sigma=_host(self.sigma), source=np.str_(source))

    @staticmethod
    def load(path: str) -> "FIDStats":
        with np.load(path) as z:
            return FIDStats(mu=z["mu"], sigma=z["sigma"])


def compute_stats(features: Array, device=None) -> FIDStats:
    """Mean and covariance (``N - 1`` in the denominator) of ``[N, d]``
    features in float64: numpy on the host for a numpy array without a
    ``device``; else torch on ``device``, or on the tensor's own device."""
    if device is None and not isinstance(features, torch.Tensor):
        f = np.asarray(features, dtype=np.float64)
        return FIDStats(mu=f.mean(axis=0), sigma=np.atleast_2d(np.cov(f, rowvar=False)))
    f = torch.as_tensor(features, device=device).to(torch.float64)
    mu = f.mean(0)
    c = f - mu
    return FIDStats(mu=mu, sigma=c.T @ c / (f.shape[0] - 1))


def _trace_sqrt_product(s1: Array, s2: Array) -> torch.Tensor:
    """tr(sqrtm(S1 S2)) through the PSD form sqrtm(S1)ᵀ S2 sqrtm(S1), which
    needs no complex branch, in float64 on ``s1``'s device (the CPU for a
    numpy array)."""
    s1 = torch.as_tensor(s1, dtype=torch.float64)
    s2 = torch.as_tensor(s2, dtype=torch.float64, device=s1.device)
    vals1, vecs1 = torch.linalg.eigh(s1)
    root1 = (vecs1 * vals1.clamp(min=0.0).sqrt()) @ vecs1.T
    return torch.linalg.eigvalsh(root1 @ s2 @ root1).clamp(min=0.0).sqrt().sum()


def compute_fid(stats1: FIDStats, stats2: FIDStats, eps: float = 1e-6) -> float:
    """||mu1-mu2||² + tr(S1 + S2 - 2 sqrtm(S1 S2)), with ``eps`` on the
    diagonals, in float64 on the device of the statistics held as tensors,
    else on the CPU (one read-back)."""
    device = next((s.mu.device for s in (stats1, stats2) if isinstance(s.mu, torch.Tensor)),
                  torch.device("cpu"))
    mu1, sigma1, mu2, sigma2 = (torch.as_tensor(a, dtype=torch.float64, device=device)
                                for a in (stats1.mu, stats1.sigma, stats2.mu, stats2.sigma))
    eye = eps * torch.eye(mu1.shape[0], dtype=torch.float64, device=device)
    s1, s2 = sigma1 + eye, sigma2 + eye
    diff = mu1 - mu2
    return float(diff @ diff + torch.trace(s1) + torch.trace(s2)
                 - 2.0 * _trace_sqrt_product(s1, s2))


# an extractor: [N, 28, 28] images -> [N, d] numpy features; one with a
# ``device`` attribute has its moments and distance computed there
FeatureFn = tp.Callable[[np.ndarray], np.ndarray]


def pixel_features(images: np.ndarray) -> np.ndarray:
    """Raw pixels as features."""
    return np.asarray(images).reshape(len(images), -1)


def make_inception_features(weights=None, batch_size: int = 64, device="cuda") -> FeatureFn:
    """InceptionV3 pool3 features (``eval/inception.py``) from a torch state
    dict (``weights=`` or ``$MCPC_INCEPTION_WEIGHTS``); ``FileNotFoundError``
    without one."""
    from .inception import make_inception_features as _make

    return _make(weights=weights, batch_size=batch_size, device=device)


def make_resnet9_features(state, batch_size: int = 500) -> FeatureFn:
    """Features of a trained full-image ResNet-9 (``models/resnet9.py``),
    computed on the device that holds ``state``'s tensors."""
    from ..models.resnet9 import ResNet9, make_feature_fn

    device = next(iter(state.params.values())).device
    feats_fn = make_feature_fn(ResNet9().to(device))

    def fn(images: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(images, np.float32).reshape(-1, 1, 28, 28))
        out = [feats_fn(state, x[s : s + batch_size].to(device)).cpu().numpy()
               for s in range(0, len(x), batch_size)]
        return np.concatenate(out, axis=0)

    fn.tag = "resnet9"
    return fn


def generated_images(gen, config: dict, n_samples: int,
                     generator: tp.Optional[torch.Generator] = None) -> np.ndarray:
    """Ancestral samples as images ``[n, 28, 28]``, post-processed as the
    reference does for FID: the Gaussian model's thresholded at 0, the
    Bernoulli model's as sigmoid probabilities."""
    samples = sample_pc(n_samples, gen, config, generator=generator, is_return_hidden=True)
    images = samples.reshape(-1, 28, 28)
    loss_fn = config.get("loss_fn")
    if loss_fn is fe_fn or loss_fn == "fe_fn":
        images = (images > 0).to(torch.float32)
    elif loss_fn is bernoulli_fn or loss_fn == "bernoulli_fn":
        images = torch.sigmoid(images)
    return images.cpu().numpy()


def make_mnist_fid_stats(
    feature_fn: FeatureFn,
    root: str = "MNIST_data",
    allow_synthetic: bool = True,
) -> tp.Tuple[FIDStats, FIDStats]:
    """The (validation, test) reference statistics, over test[:6000] and
    test[6000:10000] (``VAL_IMAGES``, ``TEST_IMAGES``), built once and
    cached.  The cache's name holds the extractor's tag and the data's
    fingerprint, so pixel, ResNet-9 and each Inception weights' stats never
    collide and real IDX files replace synthetic-derived moments."""
    from ..data.mnist import load_mnist_arrays, mnist_source_fingerprint

    tag = getattr(feature_fn, "tag", getattr(feature_fn, "__name__", "feat"))
    source, digest = mnist_source_fingerprint(root, allow_synthetic)
    fp = f"{source}-{digest}"
    test_path = os.path.join(root, "MNIST", f"test_img_{tag}_{fp}.npz")
    val_path = os.path.join(root, "MNIST", f"val_img_{tag}_{fp}.npz")
    if os.path.isfile(test_path) and os.path.isfile(val_path):
        return FIDStats.load(val_path), FIDStats.load(test_path)

    _, (te_x, _) = load_mnist_arrays(root, allow_synthetic)
    device = getattr(feature_fn, "device", None)
    val_stats = compute_stats(feature_fn(te_x[:VAL_IMAGES]), device)
    test_stats = compute_stats(feature_fn(te_x[VAL_IMAGES : VAL_IMAGES + TEST_IMAGES]), device)
    val_stats.save(val_path, source=fp)
    test_stats.save(test_path, source=fp)
    return val_stats, test_stats


def get_fid(
    gen,
    config: dict,
    n_samples: int = 5000,
    is_test: bool = False,
    feature_fn: tp.Optional[FeatureFn] = None,
    root: str = "MNIST_data",
    generator: tp.Optional[torch.Generator] = None,
) -> float:
    """FID of the generative model's samples against the MNIST reference
    statistics (test split with ``is_test``, else validation).  The moments
    and the distance run on ``feature_fn.device`` where it has one."""
    if feature_fn is None:
        feature_fn = pixel_features
    val_stats, test_stats = make_mnist_fid_stats(feature_fn, root=root)
    with span("mcpc.fid.sample"):
        images = generated_images(gen, config, n_samples, generator=generator)
    with span("mcpc.fid.features"):
        features = feature_fn(images)
    with span("mcpc.fid.stats"):
        gen_stats = compute_stats(features, getattr(feature_fn, "device", None))
    with span("mcpc.fid.distance"):
        return compute_fid(gen_stats, test_stats if is_test else val_stats)
