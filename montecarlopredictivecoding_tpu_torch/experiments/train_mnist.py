"""MNIST training entry points: MCPC and PC through the fused chain kernel.

MCPC, per batch: latents are sampled, one chain call runs the Adam MAP warm
start on the latents (``T_pc`` steps), the Langevin chain (``mixing +
sampling`` steps) and the Hebbian gradient sums over the sampling steps, and
one Adam step updates the parameters with the gradients divided by
``sampling·B``.  On a CUDA device the chain is one launch of the
hand-written kernel plus the pass that sums its blocks' partial gradients.
``train_mcpc(fused=False)`` takes the trainer path instead, as the JAX
package's does: a PC warm start and an MCPC chain, two ``PCTrainer`` calls a
batch, which ``PCTrainer`` sends to the same kernel (two launches a batch).

PC, per batch (``train_pc``): ``PCTrainer`` runs ``T_pc`` Adam MAP steps on
the latents and takes the last step's parameter gradients (one chain launch
with ``warm_pgrads``, and the summing pass), then one Adam step on the
parameters.  The ``ml`` and ``mse`` presets are tanh models.

The DLGM baseline (``train_dlgm``, ``--model dlgm``): Adam at lr 1e-3 on
the summed ELBO loss, B=64; presets fid and mse are hidden 256 / latent 20,
ml hidden 128 / latent 10, recognition width factor 1; the native file
holds ``(gen_params, rec_params)``.  The ResNet-9 ideal observer
(``train_resnet9_entry``, ``--model resnet9|resnet9_mask``): Adam at lr
1e-3, B=128, the masked variant on the bottom halves; the file is flax's
``{"params", "batch_stats"}`` layout, which the JAX package reads.

Usage:
    python3 -m montecarlopredictivecoding_tpu_torch.experiments.train_mnist \\
        --model mcpc --epochs 10 --out models/mcpc_fid_1.msgpack
    python3 -m ...train_mnist --model pc --preset ml --out models/pc_ml_1.msgpack
    python3 -m ...train_mnist --model dlgm --preset ml --out models/dlgm_ml_1.msgpack
    python3 -m ...train_mnist --model resnet9 --epochs 1 --out models/resnet9.msgpack
    python3 -m ...train_mnist --model mcpc --snapshot-epochs 0 5 10 \\
        --out models/epoch_save/mcpc_aging_0
    torchrun --nproc_per_node=N -m \\
        montecarlopredictivecoding_tpu_torch.experiments.train_mnist \\
        --model mcpc --mesh N --out models/mcpc_fid_1.msgpack

``--mesh N`` trains data-parallel over the N ranks torchrun starts (one card
each; NCCL on CUDA, gloo with ``--device cpu``).
"""

from __future__ import annotations

import argparse
import itertools
import time
import typing as tp

import torch
import torch.distributed as dist

from ..core.losses import bernoulli_fn
from ..core.optim import OptimizerSpec, Transform, apply_updates
from ..core.trainer import LangevinStep
from ..data import get_mnist_data
from ..models.factory import get_mcpc_trainer, get_model, get_pc_trainer
from ..ops.mcpc_chain import mcpc_chain
from ..parallel.fused_dp import broadcast_params, make_dp_fused_chain, shard_rows
from ..parallel.mesh import make_mesh, rank_device
from ..utils.checkpoint import save_checkpoint, save_resnet9
from ..utils.observability import span


def _msgpack(out: str) -> str:
    return out if out.endswith(".msgpack") else out + ".msgpack"


def apply_preset(config: dict, preset: str, model: str) -> dict:
    """Per-metric architecture presets matching the reference checkpoints:
    'fid'/'ml' use the standard 20-128-128-784 stack; 'mse' uses the
    reconstruction architectures (MCPC 10-256-256-784 relu, PC
    30-256-256-784 tanh)."""
    if preset == "mse":
        if model == "mcpc":
            config.update(input_size=10, hidden_size=256, hidden2_size=256)
        elif model == "pc":
            config.update(
                input_size=30, hidden_size=256, hidden2_size=256,
                activation_fn="tanh",
            )
    elif preset == "ml":
        if model == "pc":
            config.update(input_size=25, activation_fn="tanh")
    return config


def mcpc_training_config() -> dict:
    return {
        "batch_size_train": 256,
        "batch_size_val": 1024,
        "batch_size_test": 1024,
        "input_size": 20,
        "hidden_size": 128,
        "hidden2_size": 128,
        "output_size": 784,
        "loss_fn": bernoulli_fn,
        "activation_fn": "relu",
        "input_var": None,
        "T_pc": 250,
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.7},
        "mixing": 50,
        "sampling": 100,
        "optimizer_x_kwargs_mcpc": {"lr": 0.1},
        "optimizer_p_fn_mcpc": "adam",
        "optimizer_p_kwargs_mcpc": {"lr": 0.01},
    }


def pc_training_config() -> dict:
    """PC training: ``T_pc`` Adam MAP steps on the latents at lr 0.1, then
    one Adam step on the parameters at lr 0.001, B=128."""
    return {
        "batch_size_train": 128,
        "batch_size_val": 1024,
        "batch_size_test": 1024,
        "input_size": 20,
        "hidden_size": 128,
        "hidden2_size": 128,
        "output_size": 784,
        "loss_fn": bernoulli_fn,
        "activation_fn": "relu",
        "input_var": None,
        "T_pc": 250,
        "optimizer_x_fn_pc": "adam",
        "optimizer_x_kwargs_pc": {"lr": 0.1},
        "optimizer_p_fn": "adam",
        "optimizer_p_kwargs": {"lr": 0.001},
    }


def chain_options(config: dict, langevin_var: tp.Optional[float] = 2.0) -> dict:
    """The keywords of the one chain call a training batch makes."""
    return dict(
        T=config["mixing"] + config["sampling"],
        lr=config["optimizer_x_kwargs_mcpc"]["lr"],
        noise_var=langevin_var, loss="bernoulli",
        mixing=config["mixing"], with_pgrads=True,
        warm_T=config["T_pc"],
        warm_lr=config["optimizer_x_kwargs_pc"]["lr"],
    )


def param_optimizer(config: dict) -> Transform:
    """The parameters' optimizer, ``optax.adam`` at the config's lr:
    ``init(params)`` makes the state :func:`one_batch` takes."""
    return OptimizerSpec("adam", lr=config["optimizer_p_kwargs_mcpc"]["lr"]).make()


def param_step(params, opt_state, pgrads, batch_size: int, *, config: dict):
    """The Monte-Carlo Adam update from the chain's gradient sums over
    ``batch_size`` datapoints: divided by ``sampling·batch_size``, then
    optax's Adam.  Returns ``(params', opt_state')``."""
    scale = config["sampling"] * batch_size
    grads = tuple({k: v / scale for k, v in g.items()} for g in pgrads)
    updates, opt_state = param_optimizer(config).update(grads, opt_state, params)
    return apply_updates(params, updates), opt_state


def one_batch(params, opt_state, latents, seed: int, data, *,
              config: dict, langevin_var: tp.Optional[float] = 2.0):
    """One training batch, pure: the fused warm + chain call with parameter
    gradients from ``latents`` (a tuple ``(x0, x1, x2)``) and the noise seed
    ``seed``, then the Monte-Carlo Adam update.  Returns ``(params',
    opt_state')``."""
    with span("mcpc.one_batch"):
        _, pgrads = mcpc_chain(params, latents, data, seed,
                               **chain_options(config, langevin_var))
        return param_step(params, opt_state, pgrads, data.shape[0], config=config)


def one_batch_dp(params, opt_state, latents, seed: int, data, *,
                 config: dict, dp_chain, mesh):
    """:func:`one_batch` over the mesh: this rank's rows of the global
    ``latents`` and ``data`` run through ``dp_chain``
    (:func:`..parallel.fused_dp.make_dp_fused_chain`), whose gradients come
    back summed over every rank, and every rank takes the same Adam step,
    divided by the global batch.  Returns ``(params', opt_state')``."""
    rows = shard_rows(mesh, data.shape[0])
    _, pgrads = dp_chain(params, tuple(x[rows].contiguous() for x in latents),
                         data[rows].contiguous(), seed)
    return param_step(params, opt_state, pgrads, data.shape[0], config=config)


def train_mcpc(
    epochs: int,
    out: str,
    seed: int = 0,
    snapshot_epochs=(),
    batches_per_epoch=None,
    log: bool = True,
    fused: tp.Optional[bool] = None,
    preset: str = "fid",
    mesh: tp.Optional[int] = None,
    langevin_var: tp.Optional[float] = 2.0,
    device="cuda",
):
    """MCPC MNIST training: per batch a PC warm start, then an MCPC chain
    with the Monte-Carlo-accumulated weight update.

    ``fused`` None or True: all of it in :func:`one_batch`, one chain call
    a batch; each batch's latents and its chain seed are drawn from the
    model's ``torch.Generator``, made from ``seed``.  ``fused=False``: the
    JAX package's trainer path, a PC trainer's warm start
    (``get_pc_trainer(is_mcpc=True)``, ``T_pc`` Adam steps on fresh
    latents) and then an MCPC trainer (``get_mcpc_trainer``) from its
    latents, which takes the Adam step on the parameters; ``PCTrainer``
    sends both to the chain.  The last, smaller batch of an epoch runs like
    any other.  ``langevin_var`` is the Langevin noise variance; ``None``
    makes the chain deterministic.  ``snapshot_epochs`` saves
    ``<out>_epoch<N>.msgpack`` after those epochs (0: before training);
    without it the final parameters go to ``<out>``.  Returns the
    :class:`GenerativeModel`.

    ``mesh=N`` trains data-parallel over the N ranks of the default
    ``torch.distributed`` process group, which the caller initialises (the
    command line does, from torchrun's environment; NCCL on CUDA, gloo on
    the CPU): every rank builds the same model and data from ``seed``, draws
    the same global latents and chain seed, runs its rows of the batch
    through the fused kernel (:func:`one_batch_dp`), and takes the same Adam
    step from the gradients summed over the ranks.  It needs the fused
    path; batches that N does not divide are skipped, counted and reported.
    Only rank 0 prints and writes checkpoints; every rank returns its model.
    """
    if mesh is not None:
        if fused is False:
            raise ValueError("mesh training requires the fused kernel path")
        if not dist.is_initialized() or dist.get_world_size() != mesh:
            raise ValueError(
                f"mesh={mesh} needs an initialised torch.distributed process group of "
                f"{mesh} ranks (torchrun --nproc_per_node={mesh})")
    lead = mesh is None or dist.get_rank() == 0
    device = torch.device(device) if mesh is None else rank_device(device)
    config = apply_preset(mcpc_training_config(), preset, "mcpc")
    train, _, _ = get_mnist_data(config, seed=seed, device=device)
    gen = get_model(config, seed, device=device)
    fused = True if fused is None else bool(fused)
    skipped = 0
    if mesh is not None:
        mesh_obj = make_mesh(data=mesh, model=1, device=device)
        dp_chain = make_dp_fused_chain(gen.model, mesh_obj,
                                       **chain_options(config, langevin_var))
        # replicated: every rank steps from rank 0's parameters
        gen.params = broadcast_params(mesh_obj, gen.params)
    if fused:
        opt_state = param_optimizer(config).init(gen.params)
    else:
        pc_warm = get_pc_trainer(gen, config, is_mcpc=True, training=True)
        mc = get_mcpc_trainer(gen, config, training=True)
        langevin = None if langevin_var is None else LangevinStep(var=langevin_var)

    def snap(tag):
        if lead:
            path = out + (f"_epoch{tag}" if tag is not None else "")
            save_checkpoint(_msgpack(path), gen.params)

    if 0 in snapshot_epochs:
        snap("_init")
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        for i, (data, _) in enumerate(train):
            if batches_per_epoch is not None and i >= batches_per_epoch:
                break
            pseudo = torch.zeros((data.shape[0], config["input_size"]),
                                 device=device)
            if not fused:
                pc_warm.train_on_batch(
                    pseudo, loss_fn=config["loss_fn"], loss_fn_kwargs={"_target": data},
                    is_return_results_every_t=False)
                mc.train_on_batch(
                    pseudo, loss_fn=config["loss_fn"], loss_fn_kwargs={"_target": data},
                    callback_after_t=langevin, is_sample_x_at_batch_start=False,
                    is_return_results_every_t=False)
                continue
            if mesh is not None and data.shape[0] % mesh != 0:
                skipped += 1  # the data axis must divide the batch
                continue
            latents = gen.model.init_latents(gen.params, pseudo, gen.generator)
            chain_seed = int(torch.randint(0, 2**31 - 1, (), generator=gen.generator))
            if mesh is None:
                gen.params, opt_state = one_batch(
                    gen.params, opt_state, latents, chain_seed, data,
                    config=config, langevin_var=langevin_var)
            else:
                gen.params, opt_state = one_batch_dp(
                    gen.params, opt_state, latents, chain_seed, data,
                    config=config, dp_chain=dp_chain, mesh=mesh_obj)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # so the epoch's time is honest
        if log and lead:
            print(f"epoch {epoch}: {time.time() - t0:.1f}s")
        if epoch in snapshot_epochs:
            snap(epoch)
    if skipped and log and lead:
        print(f"mesh={mesh}: skipped {skipped} batch(es) whose size "
              f"didn't divide the data axis")
    if not snapshot_epochs:
        snap(None)
    return gen


def train_pc(epochs: int, out: str, seed: int = 0, batches_per_epoch=None, log=True,
             preset: str = "fid", device="cuda"):
    """PC MNIST training: per batch ``T_pc`` Adam MAP steps on fresh latents,
    then one parameter update from the last step's gradients, through
    ``PCTrainer`` (the fused chain: the kernel on CUDA, its plain version on
    the CPU).  Latents are drawn from the model's generator, made from
    ``seed``.  Saves the final parameters to ``out`` and returns the
    :class:`GenerativeModel`."""
    device = torch.device(device)
    config = apply_preset(pc_training_config(), preset, "pc")
    train, _, _ = get_mnist_data(config, seed=seed, device=device)
    gen = get_model(config, seed, device=device)
    trainer = get_pc_trainer(gen, config, is_mcpc=False, training=True)
    for epoch in range(1, epochs + 1):
        t0 = time.time()
        for i, (data, _) in enumerate(train):
            if batches_per_epoch is not None and i >= batches_per_epoch:
                break
            pseudo = torch.zeros((data.shape[0], config["input_size"]), device=device)
            trainer.train_on_batch(
                pseudo,
                loss_fn=config["loss_fn"],
                loss_fn_kwargs={"_target": data},
                is_return_results_every_t=False,
            )
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # so the epoch's time is honest
        if log:
            print(f"epoch {epoch}: {time.time() - t0:.1f}s")
    save_checkpoint(_msgpack(out), gen.params)
    return gen


def train_dlgm(epochs: int, out: str, seed: int = 0, log=True, preset: str = "fid",
               batches_per_epoch=None, device="cuda"):
    """DLGM MNIST training, B=64: the table-1 configurations (fid and mse:
    hidden 256, latent 20; ml: hidden 128, latent 10; recognition width
    factor 1).  Parameters and draws come from ``seed``.  Saves ``(gen_params,
    rec_params)`` natively to ``out`` and returns the :class:`DLGM`."""
    from ..models.dlgm import DLGM

    config = {"loss_fn": bernoulli_fn, "batch_size_train": 64,
              "batch_size_val": 1024, "batch_size_test": 1024}
    train, _, _ = get_mnist_data(config, seed=seed, device=device)
    if batches_per_epoch is not None:
        train = list(itertools.islice(train, batches_per_epoch))
    hidden, latent = (128, 10) if preset == "ml" else (256, 20)
    dlgm = DLGM(input_dim=784, hidden_dim=hidden, latent_dim=latent, factor_recog=1,
                seed=seed, device=device)
    dlgm.train(train, epochs=epochs, log=log)
    save_checkpoint(_msgpack(out), (dlgm.gen_params, dlgm.rec_params))
    return dlgm


def train_resnet9_entry(epochs: int, out: str, seed: int = 0, is_mask: bool = False,
                        batches_per_epoch=None, log_every: int = 100, device="cuda"):
    """Train the ResNet-9 ideal observer (B=128; ``is_mask``: the half-image
    variant) from ``seed`` and write it in flax's layout to ``out``.
    Returns ``(model, state)``."""
    from ..models.resnet9 import train_resnet9

    config = {"loss_fn": bernoulli_fn, "batch_size_train": 128,
              "batch_size_val": 1024, "batch_size_test": 1024}
    train, _, _ = get_mnist_data(config, seed=seed, device=device)
    if batches_per_epoch is not None:
        train = list(itertools.islice(train, batches_per_epoch))
    model, state = train_resnet9(train, generator=torch.Generator().manual_seed(seed),
                                 epochs=epochs, is_mask=is_mask, log_every=log_every,
                                 device=device)
    save_resnet9(_msgpack(out), {**state.params, **state.batch_stats}, is_mask)
    return model, state


def main(argv: tp.Optional[tp.Sequence[str]] = None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", choices=["mcpc", "pc", "dlgm", "resnet9", "resnet9_mask"],
                   required=True)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--out", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batches-per-epoch", type=int, default=None)
    p.add_argument("--snapshot-epochs", type=int, nargs="*", default=[])
    p.add_argument("--preset", choices=["fid", "ml", "mse"], default="fid",
                   help="architecture preset matching the reference checkpoint families")
    p.add_argument("--mesh", type=int, default=None,
                   help="data-parallel training over the N ranks torchrun starts "
                        "(MCPC only; the fused kernel a shard, one gradient all_reduce)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the kernel) or 'cpu' (the plain version)")
    args = p.parse_args(argv)
    if args.model != "mcpc" and args.mesh is not None:
        p.error("--mesh is only supported for --model mcpc")
    if args.model == "pc":
        train_pc(args.epochs, args.out, seed=args.seed,
                 batches_per_epoch=args.batches_per_epoch, preset=args.preset,
                 device=args.device)
        return
    if args.model == "dlgm":
        train_dlgm(args.epochs, args.out, seed=args.seed, preset=args.preset,
                   batches_per_epoch=args.batches_per_epoch, device=args.device)
        return
    if args.model.startswith("resnet9"):
        train_resnet9_entry(args.epochs, args.out, seed=args.seed,
                            is_mask=args.model == "resnet9_mask",
                            batches_per_epoch=args.batches_per_epoch, device=args.device)
        return
    if args.mesh is not None:
        # torchrun's environment gives the address, the rank and the size
        cuda = torch.device(args.device).type == "cuda"
        dist.init_process_group("nccl" if cuda else "gloo")
    try:
        train_mcpc(
            args.epochs,
            args.out,
            seed=args.seed,
            snapshot_epochs=tuple(args.snapshot_epochs),
            batches_per_epoch=args.batches_per_epoch,
            preset=args.preset,
            mesh=args.mesh,
            device=args.device,
        )
    finally:
        if args.mesh is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
