"""Time the packed chain kernel of one checkout, on one GPU, so that two
checkouts can be compared in one call.

    python3 scripts/chain_ab_timing.py [TREE] [--label NAME]

``TREE`` is the root of a checkout (default: this one); its package is
imported and its kernel built from its own sources.  Prints one JSON line:
chain (a) (B=256, T=10000, 20-128-128-784, Bernoulli, noise variance 2; 7
chains), the training chain of ``train_mnist.chain_options`` with and
without the parameter gradients (21 chains each), the whole training
batch, ``train_mnist.one_batch`` with its Adam step (21 batches), chain
(a) with the tanh activation (7 chains; null for a checkout whose kernel has
no tanh), chain (a) and the training chain with bf16 products (7 and 21
chains; null for a checkout without them), and chain (c), the unpacked
kernel (``packed=False``) on chain (a)'s inputs at T=1000, in f32 and with
bf16 products (7 chains each; null for a checkout without them), each as
``[median, min, max]``
ms between CUDA events after one warm-up; then, under ``ptxas``, each chain
kernel's registers and spill bytes (stores, loads) in the checkout's four
chain libraries, from their build logs.  To compare a change with
its parent, unpack the parent into an ignored directory and run both trees
in turns (parent, change, change, parent, ...) in one call: the card's speed
moves between calls.  Needs a CUDA device and nvcc; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import statistics
import sys

import torch


def ms(fn, reps: int):
    """``[median, min, max]`` ms of ``fn`` over ``reps`` calls after one."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return [statistics.median(times), min(times), max(times)]


def ptxas_of(build, here: str) -> dict:
    """``{library: {kernel: [registers, spill stores, spill loads]}}`` of the
    tree's four chain libraries (``build`` is the tree's ``ops/_build``),
    read by this checkout's parser of nvcc's logs."""
    spec = importlib.util.spec_from_file_location(
        "_build_reader", os.path.join(here, "montecarlopredictivecoding_tpu_torch", "ops",
                                      "_build.py"))
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    out = {}
    for name in ("mcpc_chain", "mcpc_chain_unpacked"):
        for bf16 in (False, True):
            lib = build.library_path(name, bf16)
            if os.path.exists(str(lib) + ".log"):
                out[name + ("_bf16" if bf16 else "")] = {
                    k: list(v) for k, v in sorted(reader.ptxas_resources(lib).items())
                    if k.startswith("mcpc_chain_kernel")}
    return out


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree", nargs="?", default=here)
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    chain = importlib.import_module("montecarlopredictivecoding_tpu_torch.ops.mcpc_chain")
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
    from montecarlopredictivecoding_tpu_torch.models import get_model
    from montecarlopredictivecoding_tpu_torch.ops import _build

    dev = torch.device("cuda")
    config = train_mnist.mcpc_training_config()
    gen = get_model(config, 1234, device=dev)
    B = 256
    data = (torch.rand(B, 784, generator=torch.Generator().manual_seed(5)) > 0.5).float().to(dev)
    latents = gen.model.init_latents(gen.params, torch.zeros(B, 20, device=dev),
                                     torch.Generator().manual_seed(1235))
    opts = train_mnist.chain_options(config)
    chain_a = dict(T=10000, lr=0.01, noise_var=2.0, loss="bernoulli", return_scalars=True)
    chain_c = dict(T=1000, lr=0.01, noise_var=2.0, loss="bernoulli", packed=False)

    def timed_if_taken(reps, seed, **kw):
        """ms of the chain with ``kw``, or None where this checkout refuses
        them (an option it does not have yet)."""
        try:
            chain.mcpc_chain(gen.params, latents, data, seed, **kw)
        except (NotImplementedError, TypeError):
            return None
        return ms(lambda: chain.mcpc_chain(gen.params, latents, data, seed, **kw), reps)

    if hasattr(train_mnist, "param_optimizer"):
        state = train_mnist.param_optimizer(config).init(gen.params)
    else:  # an older checkout, whose one_batch takes adam_init's state
        from montecarlopredictivecoding_tpu_torch.core.optim import adam_init
        state = adam_init(gen.params)
    print(json.dumps({
        "tree": args.label or args.tree,
        "chain_a": ms(lambda: chain.mcpc_chain(gen.params, latents, data, 1234, **chain_a), 7),
        "train_chain": ms(lambda: chain.mcpc_chain(gen.params, latents, data, 99, **opts), 21),
        "train_chain_nopg": ms(lambda: chain.mcpc_chain(
            gen.params, latents, data, 99, **dict(opts, with_pgrads=False)), 21),
        "train_batch": ms(lambda: train_mnist.one_batch(
            gen.params, state, latents, 99, data, config=config), 21),
        "chain_a_tanh": timed_if_taken(7, 1234, activation="tanh", **chain_a),
        "chain_a_bf16": timed_if_taken(7, 1234, bf16_matmul=True, **chain_a),
        "train_chain_bf16": timed_if_taken(21, 99, bf16_matmul=True, **opts),
        "chain_c": timed_if_taken(7, 1234, **chain_c),
        "chain_c_bf16": timed_if_taken(7, 1234, bf16_matmul=True, **chain_c),
        "ptxas": ptxas_of(_build, here),
    }))


if __name__ == "__main__":
    main()
