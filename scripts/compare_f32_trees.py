"""Hold the f32 chain libraries of two checkouts to each other, on one GPU:
the same SASS in every chain kernel, and the same bits out of the same
chains.  With ``--bf16``, the bf16 libraries and chains instead.

    python3 scripts/compare_f32_trees.py PARENT [CHANGE] [--bf16]

``PARENT`` and ``CHANGE`` (default: this checkout) are roots of checkouts.
Each is run in a process of its own (``--worker``), which builds its f32
(or bf16) libraries (``mcpc_chain``, ``mcpc_chain_unpacked``) from its own
sources,
dumps each chain kernel's SASS with the toolkit's ``cuobjdump`` (addresses
and encodings stripped) and runs three chains at B=256, 20-128-128-784:
chain (a) cut to 1000 steps, the training chain with the parameter
gradients, and chain (c) (the unpacked kernel) with gradients, all with
``bf16_matmul`` under ``--bf16``.  Prints one
JSON line: per library the kernels whose SASS differs, and per chain whether
every output tensor is bit-identical; exits 1 if anything differs.  Needs a
CUDA device and nvcc; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile

LIBRARIES = ("mcpc_chain", "mcpc_chain_unpacked")


def sass_by_kernel(cuobjdump: str, library: str) -> dict:
    """``{mangled chain kernel: its SASS instructions}``, addresses and
    encodings stripped."""
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                         check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            name = line[len("Function : "):]
            kernels[name] = []
        elif name is not None and line.startswith("/*") and not line.startswith("/* 0x"):
            text = re.sub(r"^/\*[0-9a-f]+\*/\s*", "", line)
            kernels[name].append(re.sub(r"\s*/\*.*\*/\s*$", "", text))
    return {k: v for k, v in kernels.items() if "mcpc_chain_kernel" in k}


def worker(tree: str, out: str, bf16: bool) -> None:
    """Build, dump and run in ``tree`` (the bf16 libraries and chains with
    ``bf16``); save everything to ``out``."""
    import torch

    sys.path.insert(0, os.path.abspath(tree))
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
    from montecarlopredictivecoding_tpu_torch.models import get_model
    from montecarlopredictivecoding_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = {name: sass_by_kernel(cuobjdump, str(_build.build(name, bf16)))
            for name in LIBRARIES}
    dev = torch.device("cuda")
    config = train_mnist.mcpc_training_config()
    gen = get_model(config, 1234, device=dev)
    B = 256
    data = (torch.rand(B, 784, generator=torch.Generator().manual_seed(5)) > 0.5).float().to(dev)
    latents = gen.model.init_latents(gen.params, torch.zeros(B, 20, device=dev),
                                     torch.Generator().manual_seed(1235))
    chains = {
        "chain_a_T1000": dict(T=1000, lr=0.01, noise_var=2.0, loss="bernoulli",
                              return_scalars=True),
        "train_chain": train_mnist.chain_options(config),
        "chain_c_pgrads": dict(T=1000, lr=0.01, noise_var=2.0, loss="bernoulli",
                               packed=False, with_pgrads=True, mixing=500),
    }
    results = {}
    for name, kw in chains.items():
        res = chain.mcpc_chain(gen.params, latents, data, 7, bf16_matmul=bf16, **kw)
        torch.cuda.synchronize()
        flat = list(res[0])
        if res[1] is not None:
            flat += [g[k] for g in res[1] for k in ("w", "b")]
        if len(res) > 2 and isinstance(res[2], dict):
            flat += [res[2][k] for k in ("loss", "energy")]
        results[name] = [t.cpu() for t in flat]
    torch.save({"sass": sass, "results": results}, out)


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=here)
    ap.add_argument("--bf16", action="store_true",
                    help="hold the bf16 libraries and chains instead of the f32 ones")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:   # parent = the tree, change = the output file
        worker(args.parent, args.change, args.bf16)
        return 0
    import torch

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate((args.parent, args.change)):
            out = os.path.join(tmp, f"{i}.pt")
            subprocess.run([sys.executable, os.path.abspath(__file__), tree, out, "--worker"]
                           + (["--bf16"] if args.bf16 else []), check=True)
            runs.append(torch.load(out))
    a, b = runs
    report = {"build": "bf16" if args.bf16 else "f32", "sass_differs": {}, "kernels": {},
              "bits_equal": {}}
    for lib in LIBRARIES:
        ka, kb = a["sass"][lib], b["sass"][lib]
        report["kernels"][lib] = len(kb)
        report["sass_differs"][lib] = sorted(k for k in set(ka) | set(kb)
                                             if ka.get(k) != kb.get(k))
    for name, ta in a["results"].items():
        tb = b["results"][name]
        report["bits_equal"][name] = len(ta) == len(tb) and all(
            torch.equal(x, y) for x, y in zip(ta, tb))
    print(json.dumps(report))
    same = (not any(report["sass_differs"].values())
            and all(report["bits_equal"].values()))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
