"""Build and load the package's CUDA kernels.

Each kernel source under ``csrc/`` (``mcpc_chain.cu`` and
``mcpc_chain_unpacked.cu``, which both instantiate the cluster kernel of
``mcpc_cluster.cuh``, and ``op_probe.cu``, the per-op probe) has a plain
``extern "C"`` interface and is compiled by ``nvcc`` into its own shared
library, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  A chain source is built twice: once for f32 products and once
with ``-DMCPC_BF16`` for bf16 ones, into a library of its own
(``<name>_bf16``), so each library holds only the instantiations of its
kind and the two compile side by side.  The probe has no bf16 variant and
is built once.  Libraries go
to ``build/torch_kernels/`` beside the package (listed in ``.gitignore``),
named by a hash of the source, the shared headers and the flags, so an
edited source or header rebuilds and an unchanged one is reused.  The first
use in a process builds or finds the library; nothing happens at import
time.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math``, so
``tanhf``/``logf``/``expf``/``sqrtf`` and division stay IEEE.  No
``--split-compile``: it builds the packed kernel 2.6 times faster but the
code it makes runs a chain 26% slower (PERF.md, Findings).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import typing as tp
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.isfile(path):
        raise RuntimeError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "need the CUDA toolkit"
        )
    return path


def flags(bf16: bool = False) -> tp.Tuple[str, ...]:
    """nvcc's flags for the f32 library of a source, or its bf16 one."""
    return NVCC_FLAGS + (("-DMCPC_BF16",) if bf16 else ())


def library_path(name: str, bf16: bool = False) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (with ``bf16``, its
    bf16 library) lives.  The name carries a hash of the source, of every
    header under ``csrc/`` (a source may include any of them) and of the
    flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(flags(bf16)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}{'_bf16' if bf16 else ''}-{digest}.so"


def build(name: str, bf16: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``bf16``, for bf16 products) unless
    its library exists; return the library's path.  nvcc's time and its
    report (registers, shared memory, spills) are kept beside it as
    ``<library>.log``."""
    out = library_path(name, bf16)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename, so a process building at the
    # same time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *flags(bf16), "-o", tmp, str(CSRC / f"{name}.cu")]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - start
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        Path(str(out) + ".log").write_text(
            f"nvcc took {seconds:.1f} s\n" + proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build_all(libraries: tp.Sequence[tp.Tuple[str, bool]]) -> tp.List[Path]:
    """Build several ``(source name, bf16)`` libraries at once, one ``nvcc``
    each, all started together; returns their paths in order."""
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        return list(pool.map(lambda lib: build(*lib), libraries))


@functools.lru_cache(maxsize=None)
def load(name: str, bf16: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu`` (with
    ``bf16``, its bf16 library) once per process.  Both libraries of a
    source export the same C names; ``ctypes`` loads each with its own
    symbols."""
    return ctypes.CDLL(str(build(name, bf16)))
