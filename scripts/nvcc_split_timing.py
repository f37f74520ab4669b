"""Time one ``nvcc`` build of the packed chain kernel
(``ops/csrc/mcpc_chain.cu``) with the package's flags, without
``--split-compile`` (as the package builds it) and with
``--split-compile=0`` (one thread a core), and print each build's seconds and
the registers ptxas reports for the first instantiations.  The second build
is faster, but its code runs the chain slower (PERF.md, Findings), so
the package does not use it.

    python3 scripts/nvcc_split_timing.py

Needs the CUDA toolkit (``nvcc``); builds into a temporary directory.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from montecarlopredictivecoding_tpu_torch.ops import _build  # noqa: E402


def main() -> None:
    base = [f for f in _build.NVCC_FLAGS if not f.startswith("--split-compile")]
    source = str(_build.CSRC / "mcpc_chain.cu")
    with tempfile.TemporaryDirectory() as tmp:
        for extra in ([], ["--split-compile=0"]):
            start = time.perf_counter()
            proc = subprocess.run([_build.nvcc_path(), *base, *extra, "-o",
                                   os.path.join(tmp, "k.so"), source],
                                  capture_output=True, text=True)
            seconds = time.perf_counter() - start
            regs = [line.split("Used ")[1].split(",")[0]
                    for line in (proc.stdout + proc.stderr).splitlines() if "Used" in line]
            print(f"{' '.join(extra) or 'no --split-compile'}: rc {proc.returncode}, "
                  f"{seconds:.1f} s, registers of the first entries {regs[:4]}", flush=True)


if __name__ == "__main__":
    main()
