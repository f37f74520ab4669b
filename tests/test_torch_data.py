"""The port's MNIST pipeline against the JAX package's: the synthetic
fallback is numpy ``RandomState``, so arrays and batches are bit-identical."""

import gzip
import struct

import numpy as np
import pytest
import torch

import montecarlopredictivecoding_tpu as mcpc
import montecarlopredictivecoding_tpu_torch as mt
from montecarlopredictivecoding_tpu.data import mnist as jmnist
from montecarlopredictivecoding_tpu_torch.data import Batches, get_mnist_data
from montecarlopredictivecoding_tpu_torch.data import mnist as tmnist

torch.set_num_threads(1)


def test_synthetic_arrays_bit_identical():
    assert np.array_equal(tmnist._synthetic_digit_templates(),
                          jmnist._synthetic_digit_templates())
    (a_tr, a_trl), (a_te, a_tel) = tmnist._synthetic_mnist(300, 120, seed=4)
    (b_tr, b_trl), (b_te, b_tel) = jmnist._synthetic_mnist(300, 120, seed=4)
    for a, b in [(a_tr, b_tr), (a_trl, b_trl), (a_te, b_te), (a_tel, b_tel)]:
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _config(loss_fn, B=64):
    return {"loss_fn": loss_fn, "batch_size_train": B, "batch_size_val": B,
            "batch_size_test": B}


@pytest.mark.parametrize("gaussian", [False, True])
def test_get_mnist_data_batches_bit_identical(gaussian, monkeypatch):
    # a 1000-image synthetic train split keeps this fast; the test split
    # keeps its 10000 images, which the val/test cut needs
    for mod in (tmnist, jmnist):
        orig = mod._synthetic_mnist
        monkeypatch.setattr(
            mod, "_synthetic_mnist",
            lambda n_train, n_test, seed=0, orig=orig: orig(1000, n_test, seed),
        )
    t_loss, j_loss = (mt.fe_fn, mcpc.fe_fn) if gaussian else (mt.bernoulli_fn, mcpc.bernoulli_fn)
    t_splits = get_mnist_data(_config(t_loss), seed=3, device="cpu")
    j_splits = jmnist.get_mnist_data(_config(j_loss), seed=3)
    for t_split, j_split in zip(t_splits, j_splits):
        assert t_split.dataset_size == j_split.dataset_size
        assert len(t_split) == len(j_split)
        for (ti, tl), (ji, jl) in zip(
            [b for _, b in zip(range(2), t_split)],
            [b for _, b in zip(range(2), j_split)],
        ):
            assert ti.dtype == torch.float32 and ti.device.type == "cpu"
            assert np.array_equal(ti.numpy(), np.asarray(ji))
            assert np.array_equal(tl.numpy(), np.asarray(jl))
    imgs = next(iter(t_splits[1]))[0]
    if gaussian:
        assert float(imgs.min()) >= -1.0 and float(imgs.max()) <= 1.0
    else:
        assert set(np.unique(imgs.numpy())) <= {0.0, 1.0}


def test_batches_drop_last_and_labels_none():
    imgs = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    b = Batches(imgs, None, 4, drop_last=True, device="cpu")
    out = list(b)
    assert len(b) == 2 and len(out) == 2 and out[0][1] is None
    assert np.array_equal(out[1][0].numpy(), imgs[4:8])
    assert len(Batches(imgs, None, 4, device="cpu")) == 3


def _write_idx(path, arr, gz=False):
    header = struct.pack(">HBB", 0, 8, arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    opener = gzip.open if gz else open
    with opener(path, "wb") as f:
        f.write(header + arr.astype(np.uint8).tobytes())


def test_read_idx_and_real_files(tmp_path):
    rng = np.random.default_rng(0)
    raw = tmp_path / "MNIST" / "raw"
    raw.mkdir(parents=True)
    arrays = {
        "train-images-idx3-ubyte": rng.integers(0, 256, (12, 28, 28)),
        "train-labels-idx1-ubyte": rng.integers(0, 10, (12,)),
        "t10k-images-idx3-ubyte": rng.integers(0, 256, (7, 28, 28)),
        "t10k-labels-idx1-ubyte": rng.integers(0, 10, (7,)),
    }
    for i, (name, arr) in enumerate(arrays.items()):
        gz = i % 2 == 1
        _write_idx(raw / (name + (".gz" if gz else "")), arr, gz=gz)
    got = tmnist.load_mnist_arrays(str(tmp_path))
    ref = jmnist.load_mnist_arrays(str(tmp_path))
    for (a, al), (b, bl) in zip(got, ref):
        assert np.array_equal(a, b) and np.array_equal(al, bl)
    assert np.array_equal(tmnist._read_idx(str(raw / "train-images-idx3-ubyte")),
                          arrays["train-images-idx3-ubyte"])
    bad = tmp_path / "bad"
    bad.write_bytes(b"\x01\x00\x08\x01\x00\x00\x00\x01\x00")
    with pytest.raises(ValueError):
        tmnist._read_idx(str(bad))
    with pytest.raises(FileNotFoundError):
        tmnist.load_mnist_arrays(str(tmp_path / "none"), allow_synthetic=False)
