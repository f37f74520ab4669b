"""Rank bodies of the port's data-parallel tests (test_torch_parallel.py).

Each test spawns its ranks as fresh processes that import this module and
the port, never JAX or the tests' conftest.  The ranks meet through a
``file://`` rendezvous in the test's temporary directory, run on the CPU
under gloo, and hand their results back as ``rank<r>.pt`` files there (CPU
tensors, lists and strings).  The parent holds them against the JAX package.
"""

import multiprocessing
import multiprocessing.connection
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist

# the JAX package's tiny training configuration (tests/test_train_mesh.py)
TINY = {
    "T_pc": 5, "mixing": 2, "sampling": 3, "batch_size_train": 64,
    "input_size": 4, "hidden_size": 8, "hidden2_size": 8,
}
# a small synthetic training set: batches of 64, 64 and 33 (33 is odd, so a
# 2-rank mesh skips it)
N_TRAIN = 161
N_TEST = 100
# the data-parallel chain's cases: (name, noise variance, seed); the last
# seed makes rank 1's shard seed wrap past int32
DP_CASES = (("noise_off", None, 0), ("noise_on", 2.0, 5), ("int32_wrap", 2.0, 2**31 - 2))
DP_OPTIONS = dict(T=10, lr=0.02, loss="bernoulli", mixing=4, with_pgrads=True,
                  warm_T=2, warm_lr=0.1)
RANK_TIMEOUT_S = 240


def run_ranks(body, world: int, tmp_dir: str, master_port=None):
    """Spawn ``world`` ranks of ``body(rank, world, tmp_dir)``, join them
    with a timeout, and return each rank's result file's contents.  The
    ranks meet in a gloo group through a ``file://`` rendezvous; with
    ``master_port`` they get torchrun's environment instead (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` localhost, ``MASTER_PORT``) and no
    group, which the body makes itself.  Once a rank fails, the others are
    stopped; the error names each rank's exit code and exception."""
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(body, r, world, tmp_dir, master_port))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        running = list(procs)
        while running and time.monotonic() < deadline:
            multiprocessing.connection.wait([p.sentinel for p in running],
                                            deadline - time.monotonic())
            running = [p for p in running if p.exitcode is None]
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        errors = [_read(os.path.join(tmp_dir, f"rank{r}.err")) for r in range(world)]
        raise RuntimeError(f"rank exit codes {codes}; errors {errors}")
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt")) for r in range(world)]


def _read(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def port_taken(err: RuntimeError) -> bool:
    """Whether ``run_ranks`` failed as a rank found its port taken (another
    process bound it between ``free_port`` and the rank's own bind)."""
    text = str(err)
    return "EADDRINUSE" in text or "address already in use" in text.lower()


def _rank_main(body, rank: int, world: int, tmp_dir: str, master_port=None) -> None:
    torch.set_num_threads(1)
    try:
        if master_port is not None:
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                              MASTER_PORT=str(master_port))
            out = body(rank, world, tmp_dir)
        else:
            join_group(rank, world, tmp_dir, "rendezvous")
            try:
                out = body(rank, world, tmp_dir)
            finally:
                dist.destroy_process_group()
    except BaseException as err:
        with open(os.path.join(tmp_dir, f"rank{rank}.err"), "w") as f:
            f.write(f"{type(err).__name__}: {err}")
        raise
    torch.save(out, os.path.join(tmp_dir, f"rank{rank}.pt"))


def join_group(rank: int, world: int, tmp_dir: str, name: str) -> None:
    """A gloo group of the ranks through the rendezvous file ``name``."""
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp_dir, name),
                            rank=rank, world_size=world)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def small_mnist(root="MNIST_data", allow_synthetic=True):
    """``load_mnist_arrays``'s stand-in: the synthetic set at N_TRAIN."""
    from montecarlopredictivecoding_tpu_torch.data import mnist

    return mnist._synthetic_mnist(N_TRAIN, N_TEST)


def tiny_training(train_mnist):
    """Patch ``train_mnist`` (and the MNIST loader) to the tiny setting."""
    from montecarlopredictivecoding_tpu_torch.data import mnist

    config = train_mnist.mcpc_training_config()
    train_mnist.mcpc_training_config = lambda: {**config, **TINY}
    mnist.load_mnist_arrays = small_mnist


def dp_rank(rank: int, world: int, tmp_dir: str) -> dict:
    """The data-parallel chain on this rank's shard for each case,
    ``place_dp``'s refusal, then ``train_mcpc(mesh=world)``: 2 batches
    without noise, a whole epoch (a skipped batch), a refused mesh size."""
    import contextlib
    import io

    import montecarlopredictivecoding_tpu_torch as mt
    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist
    from montecarlopredictivecoding_tpu_torch.parallel import make_dp_fused_chain, make_mesh, place_dp
    from montecarlopredictivecoding_tpu_torch.utils import latents_from_numpy, params_from_numpy

    arrays = np.load(os.path.join(tmp_dir, "inputs.npz"))
    params = params_from_numpy(
        [{"w": arrays[f"w{i}"], "b": arrays[f"b{i}"]} for i in range(4)], "cpu")
    latents = latents_from_numpy([arrays[f"x{i}"] for i in range(3)], "cpu")
    target = torch.from_numpy(arrays["target"])
    model = mt.make_mlp_model(*(x.shape[1] for x in latents), target.shape[1])
    mesh = make_mesh(data=world, model=1, device="cpu")
    out = {"rank": rank, "data_rank": mesh.get_local_rank("data")}
    for name, noise_var, seed in DP_CASES:
        fn = make_dp_fused_chain(model, mesh, noise_var=noise_var, **DP_OPTIONS)
        p, lat, tgt = place_dp(mesh, params, latents, target)
        new, pgrads = fn(p, lat, tgt, seed)
        out[name] = {"latents": [x.clone() for x in new],
                     "pgrads": [{k: v.clone() for k, v in g.items()} for g in pgrads]}
    try:
        place_dp(mesh, params, tuple(x[:-1] for x in latents), target[:-1])
    except ValueError as e:
        out["place_refusal"] = str(e)

    tiny_training(train_mnist)
    gen = train_mnist.train_mcpc(1, os.path.join(tmp_dir, "dp"), batches_per_epoch=2, log=False,
                                 fused=True, langevin_var=None, mesh=world, device="cpu")
    out["train_params"] = [{k: v.clone() for k, v in p.items()} for p in gen.params]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        train_mnist.train_mcpc(1, os.path.join(tmp_dir, "dp_epoch"), langevin_var=None,
                               mesh=world, device="cpu")
    out["epoch_stdout"] = printed.getvalue()
    try:
        train_mnist.train_mcpc(1, os.path.join(tmp_dir, "never"), mesh=world + 1,
                               device="cpu")
    except ValueError as e:
        out["size_refusal"] = str(e)
    return out


def sharded_rank(rank: int, world: int, tmp_dir: str) -> dict:
    """``shard_train_on_batch`` on a (2, 2) mesh at 8-16-16-32, B=16, Adam on
    the parameters: noise off and on, from the same global state on every
    rank; returns the placements and the whole results (gathered here, for
    the comparison)."""
    import montecarlopredictivecoding_tpu_torch as mt
    from montecarlopredictivecoding_tpu_torch.core.engine import EngineState
    from montecarlopredictivecoding_tpu_torch.parallel import (
        latent_shardings, make_mesh, param_shardings, shard_train_on_batch)
    from montecarlopredictivecoding_tpu_torch.utils import latents_from_numpy, params_from_numpy

    arrays = np.load(os.path.join(tmp_dir, "inputs.npz"))
    params = params_from_numpy(
        [{"w": arrays[f"w{i}"], "b": arrays[f"b{i}"]} for i in range(4)], "cpu")
    latents = latents_from_numpy([arrays[f"x{i}"] for i in range(3)], "cpu")
    target = torch.from_numpy(arrays["target"])
    inputs = torch.zeros(target.shape[0], latents[0].shape[1])
    model = mt.make_mlp_model(*(x.shape[1] for x in latents), target.shape[1])
    mesh = make_mesh(data=2, model=2, device="cpu")
    out = {"params_placements": [{k: [repr(p) for p in v] for k, v in d.items()}
                                 for d in param_shardings(model, mesh)],
           "latent_placements": [[repr(p) for p in v]
                                 for v in latent_shardings(model, mesh, latents)]}
    for langevin_var in (None, 2.0):
        cfg = engine_config(mt, langevin_var)
        state = EngineState(params=params, latents=latents, opt_x_state=None,
                            opt_p_state=None, lr_scale=torch.ones(()),
                            generator=torch.Generator().manual_seed(3))
        fn, placed, inputs_p, kwargs_p = shard_train_on_batch(
            model, cfg, mesh, state, inputs, {"_target": target})
        new, results = fn(placed, inputs_p, kwargs_p)
        out[f"noise_{langevin_var}"] = {
            "overall": results["overall"].full_tensor(),
            "params": [{k: v.full_tensor() for k, v in p.items()} for p in new.params],
            "latents": [x.full_tensor() for x in new.latents],
            "local_latent_shape": list(new.latents[1].to_local().shape),
        }
    return out


def engine_config(mt, langevin_var):
    """The JAX test's engine configuration (tests/test_parallel.py): 2 + 4
    SGD steps at lr 0.01, the gradients of the last 4 summed, Adam at lr
    0.001 on the parameters."""
    from montecarlopredictivecoding_tpu_torch.core.engine import EngineConfig
    from montecarlopredictivecoding_tpu_torch.core.optim import OptimizerSpec
    from montecarlopredictivecoding_tpu_torch.core.schedule import build_plan

    mixing, sampling = 2, 4
    T = mixing + sampling
    return EngineConfig(
        plan=build_plan(T, update_x_at="all", update_p_at="last",
                        accumulate_p_at=list(range(mixing, T))),
        optimizer_x=OptimizerSpec("sgd", lr=0.01),
        optimizer_p=OptimizerSpec("adam", lr=0.001),
        langevin_var=langevin_var,
        loss_fn=mt.bernoulli_fn,
    )


MESH_CLI_ARGS = ["--model", "mcpc", "--device", "cpu", "--epochs", "1", "--batches-per-epoch",
                 "2", "--seed", "3"]


def mesh_cli_rank(rank: int, world: int, tmp_dir: str) -> dict:
    """``train_mnist``'s command line with ``--mesh world`` in the tiny
    setting (it makes its own gloo group from torchrun's environment and
    ends it), each rank with its own ``--out``; then the same ranks meet
    again and run ``train_mcpc(mesh=world)`` on the same data and seed."""
    import contextlib
    import io

    from montecarlopredictivecoding_tpu_torch.experiments import train_mnist

    tiny_training(train_mnist)
    cli_out = os.path.join(tmp_dir, f"cli_rank{rank}.msgpack")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        train_mnist.main(MESH_CLI_ARGS + ["--mesh", str(world), "--out", cli_out])
    out = {"rank": rank, "stdout": printed.getvalue(), "cli_wrote": os.path.exists(cli_out),
           "group_after_cli": dist.is_initialized()}
    join_group(rank, world, tmp_dir, "rendezvous_reference")
    try:
        ref_out = os.path.join(tmp_dir, f"reference_rank{rank}.msgpack")
        gen = train_mnist.train_mcpc(1, ref_out, seed=3, batches_per_epoch=2, log=False,
                                     mesh=world, device="cpu")
    finally:
        dist.destroy_process_group()
    out["reference_params"] = [{k: v.clone() for k, v in p.items()} for p in gen.params]
    out["reference_wrote"] = os.path.exists(ref_out)
    return out
