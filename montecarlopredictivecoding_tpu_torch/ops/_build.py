"""Build and load the package's CUDA kernels.

Each kernel source under ``csrc/`` (``mcpc_chain.cu`` and
``mcpc_chain_unpacked.cu``, which both instantiate the cluster kernel of
``mcpc_cluster.cuh``, ``op_probe.cu``, the per-op probe, and
``inception_conv.cu``, InceptionV3's convolution kernel) has a plain
``extern "C"`` interface and is compiled by ``nvcc`` into its own shared
library, loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  A chain source is built twice: once for f32 products and once
with ``-DMCPC_BF16`` for bf16 ones, into a library of its own
(``<name>_bf16``), so each library holds only the instantiations of its
kind and the two compile side by side.  The probe and the convolution
kernel have no bf16 variant and are built once.  Libraries go
to ``build/torch_kernels/`` beside the package (listed in ``.gitignore``),
named by a hash of the source, the shared headers and the flags, so an
edited source or header rebuilds and an unchanged one is reused.  The first
use in a process builds or finds the library; nothing happens at import
time.

Flags: ``sm_90a`` (Hopper), ``-O3``, and no ``--use_fast_math``, so
``tanhf``/``logf``/``expf``/``sqrtf`` and division stay IEEE.  No
``--split-compile``: it builds the packed kernel 2.6 times faster but the
code it makes runs a chain 26% slower (PERF.md, Findings).

A profiling build, ``warp_clocks=True``, adds ``-DMCPC_WARP_CLOCKS`` (each
warp's clocks in the f32 chain kernel; ``scripts/chain_clocks.py --warps``)
and goes to ``build/torch_kernels_warp_clocks/``, so the libraries the port
runs never carry that code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
import typing as tp
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
WARP_CLOCKS_DIR = BUILD_DIR.parent / "torch_kernels_warp_clocks"
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


def flags(bf16: bool = False, warp_clocks: bool = False) -> tp.Tuple[str, ...]:
    """nvcc's flags for the f32 library of a source, or its bf16 one, and
    for the profiling build with ``warp_clocks``."""
    return (NVCC_FLAGS + (("-DMCPC_BF16",) if bf16 else ())
            + (("-DMCPC_WARP_CLOCKS",) if warp_clocks else ()))


def library_path(name: str, bf16: bool = False, warp_clocks: bool = False) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (with ``bf16``, its
    bf16 library; with ``warp_clocks``, its profiling build) lives.  The
    name carries a hash of the source, of every header under ``csrc/`` (a
    source may include any of them) and of the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(
        src + " ".join(flags(bf16, warp_clocks)).encode()).hexdigest()[:16]
    return ((WARP_CLOCKS_DIR if warp_clocks else BUILD_DIR)
            / f"{name}{'_bf16' if bf16 else ''}-{digest}.so")


def build(name: str, bf16: bool = False, warp_clocks: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` (with ``bf16``, for bf16 products; with
    ``warp_clocks``, the profiling build) unless its library exists; return
    the library's path.  nvcc's time and its report (registers, shared
    memory, spills) are kept beside it as ``<library>.log``."""
    out = library_path(name, bf16, warp_clocks)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name and rename, so a process building at the
    # same time never loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *flags(bf16, warp_clocks), "-o", tmp, str(CSRC / f"{name}.cu")]
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


def build_all(libraries: tp.Sequence[tp.Tuple]) -> tp.List[Path]:
    """Build several ``(source name, bf16[, warp_clocks])`` libraries at
    once, one ``nvcc`` each, all started together; returns their paths in
    order."""
    with ThreadPoolExecutor(max_workers=len(libraries)) as pool:
        return list(pool.map(lambda lib: build(*lib), libraries))


_CHAIN_KERNEL = re.compile(r"mcpc_chain_kernelILi(\d+)ELb(\d)ELi(\d)ELb(\d)ELi(\d)E")
_CONV_KERNEL = re.compile(r"inception_conv_kernelILi(\d+)ELi(\d+)E")


def kernel_name(mangled: str) -> str:
    """A readable name for a mangled function of these libraries: the chain
    kernel's template arguments (rows a cluster, OPT, ACT, BF16, NOISE) and
    the convolution kernel's (columns, warpgroups) spelled out, anything
    else as it is."""
    conv = _CONV_KERNEL.search(mangled)
    if conv is not None:
        bn, wgs = (int(g) for g in conv.groups())
        return f"inception_conv_kernel<{64 * wgs} x {bn}>"
    m = _CHAIN_KERNEL.search(mangled)
    if m is None:
        for code, kind in (("IdE", "double"), ("IfE", "float"), ("I6float4E", "float4")):
            if "sum_partials_kernel" + code in mangled:
                return f"sum_partials_kernel<{kind}>"
        return mangled
    rg, opt, act, bf16, noise = (int(g) for g in m.groups())
    return (f"mcpc_chain_kernel<rows {2 * rg}, {'OPT' if opt else 'plain'}, "
            f"{'tanh' if act else 'relu'}, {'bf16' if bf16 else 'f32'}, "
            f"{'unpacked' if noise else 'packed'}>")


def ptxas_resources(library: Path) -> tp.Dict[str, tp.Tuple[int, int, int]]:
    """ptxas's report of each kernel of a built ``library`` (from the
    ``.log`` that :func:`build` keeps): ``{kernel_name: (registers, spill
    store bytes, spill load bytes)}``."""
    out: tp.Dict[str, tp.Tuple[int, int, int]] = {}
    name, spill = None, (0, 0)
    for line in Path(str(library) + ".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out[name] = (int(m.group(1)),) + spill
            name, spill = None, (0, 0)
    return out


def launch_bound_registers(threads: int) -> int:
    """The registers a thread may hold in a kernel built with
    ``__launch_bounds__(threads, 1)``: the SM's 65,536 over the block, in
    whole groups of 8 (the card allocates a warp's registers 256 at a time),
    at most 255."""
    return min(255, 65536 // threads // 8 * 8)


def resource_faults(resources: tp.Dict[str, tp.Tuple[int, int, int]],
                    threads: int) -> tp.List[str]:
    """What a library's ptxas report (:func:`ptxas_resources`) must not
    show for its chain kernels, run ``threads`` a block: a spill, or more
    registers than the launch bound allows.  One line per fault; none when
    the library is sound."""
    cap = launch_bound_registers(threads)
    faults = []
    for kernel, (regs, stores, loads) in sorted(resources.items()):
        if not kernel.startswith("mcpc_chain_kernel"):
            continue
        if stores or loads:
            faults.append(f"{kernel}: spills ({stores} B stored, {loads} B loaded)")
        if regs > cap:
            faults.append(f"{kernel}: {regs} registers, over the {cap} of "
                          f"{threads} threads a block")
    return faults


@functools.lru_cache(maxsize=None)
def _sass(tool: str, library: str) -> str:
    """``cuobjdump -sass`` of ``library``, once a process however many
    opcodes are counted in it (a library's path holds its sources' hash)."""
    return subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          check=True).stdout


def sass_counts(library: Path, opcode: str) -> tp.Dict[str, int]:
    """How often each function of a built ``library`` holds the SASS
    instruction ``opcode`` (``"HMMA"``: a tensor-core product), read with the
    toolkit's ``cuobjdump -sass``: ``{mangled function name: count}``, every
    function of the library listed."""
    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = _sass(tool, str(library))
    op = re.compile(rf"\b{re.escape(opcode)}[.\s]")
    counts: tp.Dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            name = line[len("Function : "):]
            counts[name] = 0
        elif name is not None and op.search(line):
            counts[name] += 1
    return counts


@functools.lru_cache(maxsize=None)
def load(name: str, bf16: bool = False, warp_clocks: bool = False) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu`` (with
    ``bf16``, its bf16 library; with ``warp_clocks``, its profiling build)
    once per process.  The libraries of a source export the same C names;
    ``ctypes`` loads each with its own symbols."""
    return ctypes.CDLL(str(build(name, bf16, warp_clocks)))
