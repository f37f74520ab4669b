"""Hold the f32 chain libraries of two checkouts to each other, on one GPU:
the same SASS in every chain kernel, and the same bits out of the same
chains.  With ``--bf16``, the bf16 libraries and chains instead.

    python3 scripts/compare_f32_trees.py PARENT [CHANGE] [--bf16] [--bits-only]

``PARENT`` and ``CHANGE`` (default: this checkout) are roots of checkouts.
Each is run in a process of its own (``--worker``), which builds its f32
(or bf16) libraries (``mcpc_chain``, ``mcpc_chain_unpacked``) from its own
sources,
dumps each chain kernel's SASS with the toolkit's ``cuobjdump`` (addresses
and encodings stripped) and runs three chains at B=256, 20-128-128-784:
chain (a) cut to 1000 steps, the training chain with the parameter
gradients, and chain (c) (the unpacked kernel) with gradients, all with
``bf16_matmul`` under ``--bf16``.  Prints one
JSON line: per library the kernels whose SASS differs (``sass_differs``) and
whether any does (``sass_same``); per chain whether every latent and
gradient tensor is bit-identical (``bits_equal``), the summing pass's and
the per-op probe's kernels whose SASS differs (``other_sass_differs``: they
never change with the chain), and apart from them the
largest relative difference of its loss and energy sums
(``scalars_rel``: float64 sums over the threads, which a change of the
threads' shares may move in their last bits).  It exits 1 if the bits
differ, if a scalar moves more than ``SCALAR_REL`` relative or, unless
``--bits-only``, if the SASS differs: ``--bits-only`` holds a kernel whose
code changed by design to the parent's bits.  Needs a CUDA device and nvcc;
there is no CPU mode.
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
# phase 1 of chip_smoke.py holds a kernel's loss and energy to the plain
# version at 1e-5 relative; two builds of the same arithmetic are held far
# closer
SCALAR_REL = 1e-6


def sass_by_kernel(cuobjdump: str, library: str, chain: bool = True) -> dict:
    """``{mangled kernel: its SASS instructions}``, addresses and encodings
    stripped: the chain kernels, or with ``chain=False`` every other
    function (the summing pass, the probe)."""
    out = subprocess.run([cuobjdump, "-sass", library], capture_output=True, text=True,
                         check=True).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            # a kernel in an anonymous namespace carries a hash of its
            # source's path in its name: the same kernel in two checkouts
            name = re.sub(r"_GLOBAL__N__[0-9a-f]+_", "_GLOBAL__N__", line[len("Function : "):])
            kernels[name] = []
        elif name is not None and line.startswith("/*") and not line.startswith("/* 0x"):
            text = re.sub(r"^/\*[0-9a-f]+\*/\s*", "", line)
            kernels[name].append(re.sub(r"\s*/\*.*\*/\s*$", "", text))
    return {k: v for k, v in kernels.items() if ("mcpc_chain_kernel" in k) == chain}


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
    # the kernels that keep their code whatever the chain's build: the
    # summing pass of the packed library and the per-op probe (f32 only)
    other = {"mcpc_chain": sass_by_kernel(cuobjdump, str(_build.build("mcpc_chain", bf16)),
                                          chain=False)}
    if not bf16:
        other["op_probe"] = sass_by_kernel(cuobjdump, str(_build.build("op_probe")),
                                           chain=False)
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
        scalars = []
        if len(res) > 2 and isinstance(res[2], dict):
            scalars = [res[2][k] for k in ("loss", "energy")]
        results[name] = ([t.cpu() for t in flat], [t.cpu() for t in scalars])
    torch.save({"sass": sass, "other": other, "results": results}, out)


def main() -> int:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent")
    ap.add_argument("change", nargs="?", default=here)
    ap.add_argument("--bf16", action="store_true",
                    help="hold the bf16 libraries and chains instead of the f32 ones")
    ap.add_argument("--bits-only", action="store_true",
                    help="report the SASS but pass on the bits alone")
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
              "sass_same": True, "bits_equal": {}, "scalars_rel": {}}
    for lib in LIBRARIES:
        ka, kb = a["sass"][lib], b["sass"][lib]
        report["kernels"][lib] = len(kb)
        report["sass_differs"][lib] = sorted(k for k in set(ka) | set(kb)
                                             if ka.get(k) != kb.get(k))
        report["sass_same"] &= not report["sass_differs"][lib]
    # the summing pass and the probe: the same SASS whatever is held
    report["other_sass_differs"] = {
        lib: sorted(k for k in set(a["other"][lib]) | set(b["other"][lib])
                    if a["other"][lib].get(k) != b["other"][lib].get(k))
        for lib in a["other"]}
    for name, (ta, sa) in a["results"].items():
        tb, sb = b["results"][name]
        report["bits_equal"][name] = len(ta) == len(tb) and all(
            torch.equal(x, y) for x, y in zip(ta, tb))
        report["scalars_rel"][name] = max(
            [float(((x.double() - y.double()).abs() / y.double().abs().clamp_min(1e-30)).max())
             for x, y in zip(sa, sb)], default=0.0)
    print(json.dumps(report))
    same = (all(report["bits_equal"].values())
            and not any(report["other_sass_differs"].values())
            and max(report["scalars_rel"].values()) <= SCALAR_REL
            and (args.bits_only or report["sass_same"]))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
