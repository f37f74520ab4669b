"""ctypes bindings for the native C++ data-loader runtime.

Compiles ``data/native/idx_loader.cc`` with ``g++`` on first use into
``build/torch_native/`` beside the package (listed in ``.gitignore``), named
by a hash of the source and the flags, so an edited source rebuilds and an
unchanged one is reused; nothing happens at import time.  It exposes:

* :func:`read_idx_native` — IDX file reader;
* :func:`preprocess_images` — threaded uint8 -> float32 with the reference's
  scale / binarize / normalize modes;
* :func:`gather_batch` — threaded shuffled-minibatch row gather.

Where no compiler is present the last two fall back to numpy (host code,
as the JAX package's do); ``native_available()`` says which path is active.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import typing as tp
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "native" / "idx_loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    """Where the library lives: its name carries a hash of the source and
    the flags."""
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libidx_loader-{digest}.so"


def build() -> Path:
    """Compile the library unless it exists; return its path.  Raises
    ``OSError`` without ``g++`` and ``CalledProcessError`` if it fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename, so a process building at the
    # same time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(SRC), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.lru_cache(maxsize=None)
def _load() -> tp.Optional[ctypes.CDLL]:
    """The library, built and loaded once per process; None where it cannot
    be built or loaded."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.idx_read_header.restype = ctypes.c_int
    lib.idx_read_header.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.idx_read_data.restype = ctypes.c_int
    lib.idx_read_data.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
    ]
    lib.preprocess_images.restype = None
    lib.preprocess_images.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int, ctypes.c_float,
    ]
    lib.gather_batch.restype = None
    lib.gather_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
    ]
    return lib


def native_available() -> bool:
    return _load() is not None


def read_idx_native(path: str) -> np.ndarray:
    """Read an uncompressed IDX file of uint8 through the native library
    (``data.mnist`` reads gzipped files, and any file without a compiler,
    in Python)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    shape = (ctypes.c_int64 * 4)()
    ndim = ctypes.c_int()
    offset = ctypes.c_int64()
    rc = lib.idx_read_header(os.fsencode(path), shape, ctypes.byref(ndim),
                             ctypes.byref(offset))
    if rc != 0:
        raise ValueError(f"idx_read_header({path}) failed with code {rc}")
    dims = tuple(int(shape[i]) for i in range(ndim.value))
    size = int(np.prod(dims))
    out = np.empty(size, dtype=np.uint8)
    rc = lib.idx_read_data(
        os.fsencode(path), offset.value,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size,
    )
    if rc != 0:
        raise ValueError(f"idx_read_data({path}) failed with code {rc}")
    return out.reshape(dims)


MODE_SCALE = 0      # x / 255
MODE_BINARIZE = 1   # reference BinaryMNIST (threshold 0.5)
MODE_NORMALIZE = 2  # reference Normalize(0.5, 0.5) -> [-1, 1]


def preprocess_images(
    raw: np.ndarray, mode: int = MODE_SCALE, threshold: float = 0.5
) -> np.ndarray:
    """Threaded uint8 -> float32 preprocessing; numpy fallback when the
    native library is unavailable."""
    if mode not in (MODE_SCALE, MODE_BINARIZE, MODE_NORMALIZE):
        raise ValueError(f"unknown preprocessing mode {mode}")
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    lib = _load()
    if lib is None:
        x = raw.astype(np.float32) / 255.0
        if mode == MODE_BINARIZE:
            return (x > threshold).astype(np.float32)
        if mode == MODE_NORMALIZE:
            return (x - 0.5) / 0.5
        return x
    out = np.empty(raw.shape, dtype=np.float32)
    lib.preprocess_images(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        raw.size, mode, threshold,
    )
    return out


def gather_batch(data: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """``out[i] = data[idx[i]]`` with native threading (numpy fallback).
    Indices must lie in ``[0, len(data))``."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    if idx.ndim != 1:
        raise ValueError("gather_batch takes a 1-D index array")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= len(data)):
        raise IndexError(f"gather_batch: an index lies outside [0, {len(data)})")
    lib = _load()
    if lib is None:
        return data[idx]
    out = np.empty((len(idx),) + data.shape[1:], dtype=np.float32)
    dim = int(np.prod(data.shape[1:])) if data.ndim > 1 else 1
    lib.gather_batch(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(idx), dim,
    )
    return out
