"""Fréchet distance, in process: samples -> features -> Gaussian moments ->
the closed-form distance.

The JAX package's ``eval/fid.py``.  Features are computed on the device in
batches and come back as numpy; the moments and the distance are float64 on
the host.  The default extractor is raw pixels; ``make_resnet9_features``
takes the ResNet-9 ideal observer's penultimate layer and
``make_inception_features`` the paper-comparable InceptionV3 pool3 (it needs
weights).  The reference statistics are cached under
``<root>/MNIST/{val,test}_img_<tag>_<source>-<digest>.npz``, the JAX package's
names and layout, so both packages share the files.
"""

from __future__ import annotations

import dataclasses
import os
import typing as tp

import numpy as np
import torch

from ..core.losses import bernoulli_fn, fe_fn
from .sampling import sample_pc


@dataclasses.dataclass
class FIDStats:
    mu: np.ndarray
    sigma: np.ndarray

    def save(self, path: str, source: str = ""):
        """``.npz`` with ``mu``, ``sigma`` and ``source``, the data's
        provenance (``"synthetic-v1n10000"``, ``"idx-<sha256 prefix>"``)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(path, mu=self.mu, sigma=self.sigma, source=np.str_(source))

    @staticmethod
    def load(path: str) -> "FIDStats":
        with np.load(path) as z:
            return FIDStats(mu=z["mu"], sigma=z["sigma"])


def compute_stats(features: np.ndarray) -> FIDStats:
    f = np.asarray(features, dtype=np.float64)
    return FIDStats(mu=f.mean(axis=0), sigma=np.atleast_2d(np.cov(f, rowvar=False)))


def _trace_sqrt_product(s1: np.ndarray, s2: np.ndarray) -> float:
    """tr(sqrtm(S1 S2)) through the PSD form sqrtm(S1)ᵀ S2 sqrtm(S1), which
    needs no complex branch."""
    vals1, vecs1 = np.linalg.eigh(s1)
    root1 = (vecs1 * np.sqrt(np.clip(vals1, 0.0, None))) @ vecs1.T
    vals = np.linalg.eigvalsh(root1 @ s2 @ root1)
    return float(np.sqrt(np.clip(vals, 0.0, None)).sum())


def compute_fid(stats1: FIDStats, stats2: FIDStats, eps: float = 1e-6) -> float:
    """||mu1-mu2||² + tr(S1 + S2 - 2 sqrtm(S1 S2)), with ``eps`` on the
    diagonals, in float64."""
    s1 = stats1.sigma + eps * np.eye(len(stats1.mu))
    s2 = stats2.sigma + eps * np.eye(len(stats2.mu))
    diff = stats1.mu - stats2.mu
    return float(
        diff @ diff + np.trace(s1) + np.trace(s2) - 2.0 * _trace_sqrt_product(s1, s2)
    )


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
    test[6000:10000], built once and cached.  The cache's name holds the
    extractor's tag and the data's fingerprint, so pixel and ResNet-9 stats
    never collide and real IDX files replace synthetic-derived moments."""
    from ..data.mnist import load_mnist_arrays, mnist_source_fingerprint

    tag = getattr(feature_fn, "tag", getattr(feature_fn, "__name__", "feat"))
    source, digest = mnist_source_fingerprint(root, allow_synthetic)
    fp = f"{source}-{digest}"
    test_path = os.path.join(root, "MNIST", f"test_img_{tag}_{fp}.npz")
    val_path = os.path.join(root, "MNIST", f"val_img_{tag}_{fp}.npz")
    if os.path.isfile(test_path) and os.path.isfile(val_path):
        return FIDStats.load(val_path), FIDStats.load(test_path)

    _, (te_x, _) = load_mnist_arrays(root, allow_synthetic)
    val_stats = compute_stats(feature_fn(te_x[:6000]))
    test_stats = compute_stats(feature_fn(te_x[6000:10000]))
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
    statistics (test split with ``is_test``, else validation)."""
    if feature_fn is None:
        feature_fn = pixel_features
    val_stats, test_stats = make_mnist_fid_stats(feature_fn, root=root)
    images = generated_images(gen, config, n_samples, generator=generator)
    gen_stats = compute_stats(feature_fn(images))
    return compute_fid(gen_stats, test_stats if is_test else val_stats)
