"""Dry runs of the port on tiny shapes: a check that a path runs, not a
measurement.

``entry()``             one MCPC training batch (the fused chain with the
                        Adam warm start and the Hebbian gradients, then
                        the Adam step) on the MNIST MLP's topology;
``dryrun_multichip(n)`` the full MCPC training step sharded over an n-rank
                        (data, model) mesh through the step engine
                        (``parallel.sharding``), and the data-parallel fused
                        chain with an Adam warm start over n ranks
                        (``parallel.fused_dp``).

Usage: ``python3 -m montecarlopredictivecoding_tpu_torch.dryrun [--device
cpu] [--ranks 2]``.
"""

from __future__ import annotations

import argparse
import functools
import multiprocessing
import os
import tempfile
import typing as tp

import torch
import torch.distributed as dist

# tiny shapes, the real topology (4 Linear layers, 3 PC sites)
DIMS = (8, 16, 16, 32)
RANK_TIMEOUT_S = 600


def entry(device="cuda") -> tp.Tuple[tp.Callable, tuple]:
    """``(fn, args)``: ``fn(*args)`` runs one MCPC training batch
    (``train_mnist.one_batch``: 5 Adam steps, 2 + 3 Langevin steps, the Adam
    step on the parameters) on 8-16-16-32 at B=8 and returns ``(params',
    opt_state')``."""
    from .experiments import train_mnist
    from .models.factory import get_model

    config = dict(train_mnist.mcpc_training_config(), input_size=DIMS[0],
                  hidden_size=DIMS[1], hidden2_size=DIMS[2], output_size=DIMS[3],
                  T_pc=5, mixing=2, sampling=3)
    gen = get_model(config, 0, device=device)
    B = 8
    latents = gen.model.init_latents(gen.params, torch.zeros(B, DIMS[0], device=device),
                                     gen.generator)
    data = (torch.rand(B, DIMS[3], generator=gen.generator) > 0.5).float().to(device)
    opt_state = train_mnist.param_optimizer(config).init(gen.params)
    fn = functools.partial(train_mnist.one_batch, config=config)
    return fn, (gen.params, opt_state, latents, 1, data)


@functools.lru_cache(maxsize=None)
def _gather_through_c10d() -> torch.library.Library:
    """Route the functional all-gather of CUDA tensors (the collective
    DTensor takes from a shard to a replica) through the c10d all-gather.
    Under gloo the functional op segfaults on CUDA tensors (torch 2.11 on
    an H100: every other collective DTensor takes, and the c10d all-gather
    itself, work); the ranks of a dry run on one card share it under gloo,
    since NCCL takes one rank a card.  Installed once per process."""
    lib = torch.library.Library("_c10d_functional", "IMPL")

    def all_gather_into_tensor(tensor, group_size, group_name):
        group = dist.distributed_c10d._resolve_process_group(group_name)
        out = tensor.new_empty((tensor.shape[0] * group_size,) + tuple(tensor.shape[1:]))
        dist.all_gather_into_tensor(out, tensor.contiguous(), group=group)
        return out

    lib.impl("all_gather_into_tensor", all_gather_into_tensor, "CUDA")
    return lib


def _dryrun_body(n: int, device) -> str:
    """The dry run on every rank of an initialised group of ``n``."""
    from . import bernoulli_fn, make_mlp_model
    from .core.engine import EngineConfig, EngineState
    from .core.optim import OptimizerSpec
    from .core.schedule import build_plan
    from .parallel import make_dp_fused_chain, make_mesh, place_dp, shard_train_on_batch
    from .parallel.mesh import best_mesh_shape, rank_device

    device = rank_device(device)
    if device.type == "cuda" and dist.get_backend() == "gloo":
        _gather_through_c10d()
    model = make_mlp_model(*DIMS)
    data_ax, model_ax = best_mesh_shape(n, DIMS)
    mesh = make_mesh(data=data_ax, model=model_ax, device=device)
    mixing, sampling = 2, 3
    T = mixing + sampling
    cfg = EngineConfig(
        plan=build_plan(T, update_x_at="all", update_p_at="last",
                        accumulate_p_at=list(range(mixing, T))),
        optimizer_x=OptimizerSpec("sgd", lr=0.01),
        optimizer_p=OptimizerSpec("adam", lr=0.001),
        langevin_var=2.0,
        loss_fn=bernoulli_fn,
    )
    # the same seed on every rank: the same global tensors and noise
    generator = torch.Generator().manual_seed(0)
    params = model.init(generator, device=device)
    batch = 4 * data_ax
    inputs = torch.zeros(batch, DIMS[0], device=device)
    latents = model.init_latents(params, inputs, generator)
    target = (torch.rand(batch, DIMS[-1], generator=generator) > 0.5).float().to(device)
    state = EngineState(params=params, latents=latents, opt_x_state=None,
                        opt_p_state=None, lr_scale=torch.ones((), device=device),
                        generator=generator)
    fn, placed, inputs_p, kwargs_p = shard_train_on_batch(
        model, cfg, mesh, state, inputs, {"_target": target})
    _, results = fn(placed, inputs_p, kwargs_p)
    if tuple(results["overall"].shape) != (T,):
        raise RuntimeError(f"overall is {tuple(results['overall'].shape)}, not ({T},)")
    overall = float(results["overall"].full_tensor()[-1])

    # the data-parallel fused path: a shard's chain (an Adam warm start, the
    # Langevin chain, the Monte-Carlo gradients), one all_reduce
    dp_mesh = make_mesh(data=n, model=1, device=device)
    dp_fn = make_dp_fused_chain(model, dp_mesh, T=T, lr=0.01, noise_var=None,
                                loss="bernoulli", mixing=mixing, with_pgrads=True,
                                warm_T=2, warm_lr=0.1)
    _, pgrads = dp_fn(*place_dp(dp_mesh, params, latents, target), 0)
    if not all(bool(torch.isfinite(g).all()) for p in pgrads for g in p.values()):
        raise RuntimeError("the data-parallel gradients are not finite")
    return (f"dryrun_multichip OK: mesh=({data_ax}x{model_ax}), T={T}, "
            f"overall[-1]={overall:.3f}; dp-fused chain over {n} shards on "
            f"{device.type} OK")


def _rank_main(rank: int, n: int, device: str, init_file: str) -> None:
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=n)
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)  # n ranks share the host's cores
        line = _dryrun_body(n, device)
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Run the dry run over ``n_devices`` ranks.  In a process group of that
    size it runs on this rank; with no group it spawns ``n_devices`` gloo
    ranks, all on ``cuda:0`` or, with ``device="cpu"``, on the CPU, and
    raises if one fails."""
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                             f"{dist.get_world_size()} ranks")
        line = _dryrun_body(n_devices, device)
        if dist.get_rank() == 0:
            print(line, flush=True)
        return
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(r, n_devices, str(device), init_file))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(RANK_TIMEOUT_S)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    codes = [p.exitcode for p in procs]
    if any(code != 0 for code in codes):
        raise RuntimeError(f"dryrun_multichip({n_devices}): rank exit codes {codes}")


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default="cuda")
    p.add_argument("--ranks", type=int, default=2)
    args = p.parse_args(argv)
    fn, fn_args = entry(args.device)
    params, _ = fn(*fn_args)
    print("entry OK:", float(params[3]["b"].sum()))
    dryrun_multichip(args.ranks, args.device)


if __name__ == "__main__":
    main()
