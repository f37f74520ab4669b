"""MNIST data pipeline.

* Gaussian sensory path (``fe_fn``): images normalized to [-1, 1] and
  flattened;
* Bernoulli path: images binarized at threshold 0.5;
* split: 60k train / first 6000 of the test set as validation / remaining
  4000 as test.

The whole split is held as one host numpy array and each batch is moved to
the device as one dense ``[B, 784]`` tensor; uncompressed IDX files are read
and shuffled batches gathered by the native C++ loader
(``native_loader.py``).

Data source: standard IDX files under ``<root>/MNIST/raw`` (the torchvision
layout; raw or gzipped).  When no files exist, a deterministic procedural
fallback generates MNIST-like digit images (numpy ``RandomState``, so its
arrays are bit-identical to the JAX package's); pass
``allow_synthetic=False`` to require real data.
"""

from __future__ import annotations

import gzip
import os
import struct
import typing as tp

import numpy as np
import torch

from .native_loader import gather_batch, native_available, read_idx_native

_RAW_NAMES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}


def _read_idx(path: str) -> np.ndarray:
    """Read one IDX file (raw or gzipped) into a uint8 array of its shape:
    an uncompressed one through the native reader (``native_loader``) where
    it builds, the rest in Python."""
    if not path.endswith(".gz") and native_available():
        try:
            return read_idx_native(path)
        except ValueError:
            pass  # not a uint8 IDX file the native reader takes: say why below
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0:
            raise ValueError(f"{path}: bad IDX magic")
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(shape)


def _find(root: str, base: str) -> tp.Optional[str]:
    for cand in (
        os.path.join(root, "MNIST", "raw", base),
        os.path.join(root, "MNIST", "raw", base + ".gz"),
        os.path.join(root, base),
        os.path.join(root, base + ".gz"),
    ):
        if os.path.isfile(cand):
            return cand
    return None


# -- procedural fallback -------------------------------------------------------


def _synthetic_digit_templates() -> np.ndarray:
    """10 deterministic 28x28 digit-like strokes (7-segment style) used to
    fabricate an MNIST-like dataset when no real data is on disk."""
    seg = {
        "top": ((4, 6), (8, 20)),
        "mid": ((13, 15), (8, 20)),
        "bot": ((22, 24), (8, 20)),
        "tl": ((5, 14), (7, 9)),
        "tr": ((5, 14), (19, 21)),
        "bl": ((14, 23), (7, 9)),
        "br": ((14, 23), (19, 21)),
    }
    digit_segs = {
        0: ["top", "bot", "tl", "tr", "bl", "br"],
        1: ["tr", "br"],
        2: ["top", "tr", "mid", "bl", "bot"],
        3: ["top", "tr", "mid", "br", "bot"],
        4: ["tl", "tr", "mid", "br"],
        5: ["top", "tl", "mid", "br", "bot"],
        6: ["top", "tl", "mid", "bl", "br", "bot"],
        7: ["top", "tr", "br"],
        8: ["top", "mid", "bot", "tl", "tr", "bl", "br"],
        9: ["top", "mid", "bot", "tl", "tr", "br"],
    }
    out = np.zeros((10, 28, 28), dtype=np.float32)
    for d, names in digit_segs.items():
        img = np.zeros((28, 28), dtype=np.float32)
        for nm in names:
            (r0, r1), (c0, c1) = seg[nm]
            img[r0:r1, c0:c1] = 1.0
        out[d] = img
    return out


def _synthetic_mnist(n_train: int, n_test: int, seed: int = 0):
    """Deterministic MNIST stand-in: jittered, smoothed, noised digit
    templates with intensities roughly matching MNIST statistics."""
    rng = np.random.RandomState(seed)
    templates = _synthetic_digit_templates()

    def make(n, rng):
        labels = rng.randint(0, 10, size=n).astype(np.int64)
        imgs = templates[labels].copy()
        # random shift +-3 px
        sr = rng.randint(-3, 4, size=n)
        sc = rng.randint(-3, 4, size=n)
        for i in range(n):
            imgs[i] = np.roll(np.roll(imgs[i], sr[i], axis=0), sc[i], axis=1)
        # blur: two box-filter passes (vectorised)
        for _ in range(2):
            imgs = (
                imgs
                + np.roll(imgs, 1, 1) + np.roll(imgs, -1, 1)
                + np.roll(imgs, 1, 2) + np.roll(imgs, -1, 2)
            ) / 5.0
        imgs = imgs / imgs.max()
        imgs += 0.08 * rng.randn(*imgs.shape).astype(np.float32)
        imgs = np.clip(imgs, 0.0, 1.0)
        return imgs.astype(np.float32), labels

    train = make(n_train, rng)
    test = make(n_test, np.random.RandomState(seed + 1))
    return train, test


def load_mnist_arrays(
    root: str = "MNIST_data",
    allow_synthetic: bool = True,
    n_synthetic_train: int = 60000,
    n_synthetic_test: int = 10000,
):
    """Return ((train_imgs, train_labels), (test_imgs, test_labels)) as numpy
    arrays, images float32 in [0, 1] of shape [N, 28, 28]."""
    paths = {k: _find(root, v) for k, v in _RAW_NAMES.items()}
    if all(paths.values()):
        tr_x = _read_idx(paths["train_images"]).astype(np.float32) / 255.0
        tr_y = _read_idx(paths["train_labels"]).astype(np.int64)
        te_x = _read_idx(paths["test_images"]).astype(np.float32) / 255.0
        te_y = _read_idx(paths["test_labels"]).astype(np.int64)
        return (tr_x, tr_y), (te_x, te_y)
    if not allow_synthetic:
        raise FileNotFoundError(
            f"MNIST IDX files not found under {root!r} and synthetic fallback "
            "disabled"
        )
    return _synthetic_mnist(n_synthetic_train, n_synthetic_test)


def mnist_source_fingerprint(
    root: str = "MNIST_data",
    allow_synthetic: bool = True,
    n_synthetic_test: int = 10000,
) -> tp.Tuple[str, str]:
    """Identify the test split's content as ``(source, digest)`` without
    loading it, exactly as the JAX package does: real IDX files give
    ``("idx", <first 12 hex digits of the sha256 of the test images and
    labels>)``; the synthetic fallback, a deterministic generator, gives
    ``("synthetic", "v1n<n_synthetic_test>")``.  The FID reference caches
    (``eval/fid.py``) are keyed on it, so both packages share their files
    and real IDX files under ``<root>/MNIST/raw`` invalidate synthetic ones.
    """
    import hashlib

    paths = {k: _find(root, v) for k, v in _RAW_NAMES.items()}
    # the loader's all-files condition, so the fingerprint names what
    # load_mnist_arrays returns
    if all(paths.values()):
        h = hashlib.sha256()
        for k in ("test_images", "test_labels"):
            with open(paths[k], "rb") as f:
                h.update(f.read())
        return "idx", h.hexdigest()[:12]
    if not allow_synthetic:
        raise FileNotFoundError(
            f"MNIST IDX files not found under {root!r} and synthetic fallback "
            "disabled"
        )
    return "synthetic", f"v1n{n_synthetic_test}"


class Batches:
    """Minimal array-backed batch iterator (the DataLoader role).

    Yields ``(images, labels)`` tensors on ``device``; shuffling is host-side
    numpy, so the batch order matches the JAX package's for the same seed.
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: tp.Optional[np.ndarray],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        device="cuda",
    ):
        self.images = images
        self.labels = labels
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        self.device = torch.device(device)

    @property
    def dataset_size(self) -> int:
        return len(self.images)

    def __len__(self) -> int:
        n = self.dataset_size
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        n = self.dataset_size
        idx = np.arange(n)
        if self.shuffle:
            self._rng.shuffle(idx)
        for s in range(0, n, self.batch_size):
            sel = idx[s : s + self.batch_size]
            if self.drop_last and len(sel) < self.batch_size:
                return
            if self.shuffle and self.images.dtype == np.float32:
                rows = gather_batch(self.images, sel)  # the native loader's gather
            else:
                rows = np.ascontiguousarray(self.images[sel])
            imgs = torch.from_numpy(rows).to(self.device)
            if self.labels is None:
                yield imgs, None
            else:
                labels = torch.from_numpy(np.ascontiguousarray(self.labels[sel]))
                yield imgs, labels.to(self.device)


def get_mnist_data(
    config: dict,
    binary: bool = True,
    root: str = "MNIST_data",
    allow_synthetic: bool = True,
    seed: int = 0,
    device="cuda",
) -> tp.Tuple[Batches, Batches, Batches]:
    """Reference-parity loaders.

    ``config['loss_fn']`` selects the path: a Gaussian loss (``fe_fn``)
    normalizes to [-1, 1]; a Bernoulli loss (or the string 'vae') keeps [0, 1]
    and binarizes at 0.5 when ``binary``.  Split: 60k train / test[:6000] val
    / test[6000:10000] test.
    """
    from ..core.losses import fe_fn

    (tr_x, tr_y), (te_x, te_y) = load_mnist_arrays(root, allow_synthetic)
    tr_x = tr_x.reshape(len(tr_x), -1)
    te_x = te_x.reshape(len(te_x), -1)

    loss_fn = config.get("loss_fn")
    gaussian = loss_fn is fe_fn or loss_fn == "fe_fn"
    if gaussian:
        tr_x = (tr_x - 0.5) / 0.5
        te_x = (te_x - 0.5) / 0.5
    elif binary:
        tr_x = (tr_x > 0.5).astype(np.float32)
        te_x = (te_x > 0.5).astype(np.float32)

    val_x, val_y = te_x[:6000], te_y[:6000]
    test_x, test_y = te_x[6000:10000], te_y[6000:10000]

    train = Batches(
        tr_x, tr_y, config["batch_size_train"], shuffle=True, seed=seed,
        device=device,
    )
    val = Batches(val_x, val_y, config["batch_size_val"], shuffle=False,
                  device=device)
    test = Batches(test_x, test_y, config["batch_size_test"], shuffle=False,
                   device=device)
    return train, val, test
