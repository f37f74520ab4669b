"""The port's native IDX loader (``data/native_loader.py`` and its own copy
of ``data/native/idx_loader.cc``) against the JAX package's on the same
files and arrays.  Both build with g++ here (the JAX module imports no JAX).
Every comparison is exact: the same C++ source does the same float32
arithmetic, and a gather copies."""

import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

from montecarlopredictivecoding_tpu.data import mnist as jmnist
from montecarlopredictivecoding_tpu.data import native_loader as jnative
from montecarlopredictivecoding_tpu_torch.data import mnist, native_loader

torch.set_num_threads(1)


def _write_idx(path, arr: np.ndarray):
    arr = arr.astype(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        for d in arr.shape:
            f.write(struct.pack(">I", d))
        f.write(arr.tobytes())


def test_native_library_builds_under_build_and_loads():
    assert native_loader.native_available()
    path = native_loader.library_path()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path.exists() and path.parent == Path(repo) / "build" / "torch_native"
    assert path.name.startswith("libidx_loader-")
    # the port builds its own copy of the source, not the JAX package's file
    assert native_loader.SRC.parent == Path(repo) / "montecarlopredictivecoding_tpu_torch" / \
        "data" / "native"


@pytest.mark.parametrize("shape", [(7, 5, 4), (13,), (3, 28, 28)])
def test_read_idx_matches_jax_and_the_file(tmp_path, shape):
    arr = np.random.RandomState(0).randint(0, 256, size=shape, dtype=np.uint8)
    path = str(tmp_path / "x-idx-ubyte")
    _write_idx(path, arr)
    out = native_loader.read_idx_native(path)
    np.testing.assert_array_equal(out, arr)
    np.testing.assert_array_equal(out, jnative.read_idx_native(path))


def test_read_idx_refuses_a_bad_file(tmp_path):
    path = str(tmp_path / "bad")
    with open(path, "wb") as f:
        f.write(b"\x01\x02\x08\x01" + b"\x00" * 8)
    with pytest.raises(ValueError, match="code -3"):
        native_loader.read_idx_native(path)
    with pytest.raises(ValueError, match="code -1"):
        native_loader.read_idx_native(str(tmp_path / "missing"))


@pytest.mark.parametrize("mode", [native_loader.MODE_SCALE, native_loader.MODE_BINARIZE,
                                  native_loader.MODE_NORMALIZE])
def test_preprocess_modes_match_jax_and_numpy(mode):
    raw = np.random.RandomState(2).randint(0, 256, size=(1 << 15,), dtype=np.uint8)
    out = native_loader.preprocess_images(raw, mode)
    np.testing.assert_array_equal(out, jnative.preprocess_images(raw, mode))
    x = raw.astype(np.float32) / 255.0
    want = {native_loader.MODE_SCALE: x,
            native_loader.MODE_BINARIZE: (x > 0.5).astype(np.float32),
            native_loader.MODE_NORMALIZE: (x - 0.5) / 0.5}[mode]
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_gather_batch_matches_jax_and_numpy():
    rng = np.random.RandomState(3)
    data = rng.randn(100, 17).astype(np.float32)
    idx = rng.randint(0, 100, size=40)
    out = native_loader.gather_batch(data, idx)
    np.testing.assert_array_equal(out, data[idx])
    np.testing.assert_array_equal(out, jnative.gather_batch(data, idx))
    with pytest.raises(IndexError):
        native_loader.gather_batch(data, np.array([0, 100]))


def test_mnist_loader_reads_and_gathers_natively(tmp_path, monkeypatch):
    """``load_mnist_arrays`` reads uncompressed IDX files through the native
    reader and the shuffled training batches come through the native
    gather, equal to the JAX package's loader on the same files."""
    rng = np.random.RandomState(1)
    raw = tmp_path / "MNIST" / "raw"
    os.makedirs(raw)
    arrays = {
        "train-images-idx3-ubyte": rng.randint(0, 256, (50, 28, 28), dtype=np.uint8),
        "train-labels-idx1-ubyte": rng.randint(0, 10, (50,)).astype(np.uint8),
        "t10k-images-idx3-ubyte": rng.randint(0, 256, (20, 28, 28), dtype=np.uint8),
        "t10k-labels-idx1-ubyte": rng.randint(0, 10, (20,)).astype(np.uint8),
    }
    for name, arr in arrays.items():
        _write_idx(str(raw / name), arr)
    calls = {"read": 0, "gather": 0}
    read, gather = mnist.read_idx_native, mnist.gather_batch

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(mnist, "read_idx_native", count("read", read))
    monkeypatch.setattr(mnist, "gather_batch", count("gather", gather))
    (xtr, ytr), (xte, yte) = mnist.load_mnist_arrays(str(tmp_path), allow_synthetic=False)
    (jxtr, jytr), (jxte, jyte) = jmnist.load_mnist_arrays(str(tmp_path), allow_synthetic=False)
    assert calls["read"] == 4
    for a, b in ((xtr, jxtr), (ytr, jytr), (xte, jxte), (yte, jyte)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(xtr, arrays["train-images-idx3-ubyte"].astype(np.float32) / 255.0)

    config = {"batch_size_train": 16, "batch_size_val": 8, "batch_size_test": 8}
    train, _, _ = mnist.get_mnist_data(config, root=str(tmp_path), allow_synthetic=False,
                                       seed=4, device="cpu")
    jtrain, _, _ = jmnist.get_mnist_data(config, root=str(tmp_path), allow_synthetic=False,
                                         seed=4)
    batches = list(train)
    for (x, y), (jx, jy) in zip(batches, jtrain):
        np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    assert calls["gather"] == len(batches) == 4


def test_mnist_reads_gzipped_idx_in_python(tmp_path):
    import gzip

    arr = np.random.RandomState(5).randint(0, 256, (4, 3), dtype=np.uint8)
    path = str(tmp_path / "x-idx2-ubyte")
    _write_idx(path, arr)
    with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
        g.write(f.read())
    np.testing.assert_array_equal(mnist._read_idx(path + ".gz"), arr)
    np.testing.assert_array_equal(mnist._read_idx(path), arr)
