"""Seed sweeps: the figure-5 workload over many seed models.

Each seed has its own parameters (a checkpoint per seed and epoch), and the
JAX package runs the seeds as a ``jax.vmap`` axis of its step engine.  The
port runs them in turn, each through ``PCTrainer`` and so through the fused
chain (the hand-written kernel on CUDA tensors): a warm start of ``T_pc``
Adam steps, then one captured Langevin chain.  A seed's chain is already a
whole-GPU kernel launch, so nothing is gained by batching seeds on the
host; the JAX package's ``vmap_train_on_batch`` (a vmapped engine) is a JAX
artifact and has no counterpart here.
"""

from __future__ import annotations

import typing as tp

import numpy as np
import torch

from ..core.engine import EngineConfig, EngineState
from ..core.losses import zero_fn
from ..core.model import PCModel
from ..core.optim import OptimizerSpec
from ..core.schedule import build_plan
from ..core.trainer import GenerativeModel, LangevinStep
from ..models.factory import get_mcpc_trainer, get_pc_trainer


def stack_pytrees(trees: tp.Sequence):
    """Stack identically structured trees (tensors, and dicts, tuples and
    lists of them, named tuples included) along a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_pytrees([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        parts = [stack_pytrees(list(leaves)) for leaves in zip(*trees)]
        return type(first)(*parts) if hasattr(first, "_fields") else type(first)(parts)
    return torch.stack([torch.as_tensor(t) for t in trees])


def _like(x, ref: torch.Tensor) -> torch.Tensor:
    """``x`` (a tensor, or an array copied) with ``ref``'s dtype and device."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x))
    return x.to(dtype=ref.dtype, device=ref.device)


def make_seed_states(
    model: PCModel,
    cfg: EngineConfig,
    params_list: tp.Sequence,
    inputs: torch.Tensor,
    generator: torch.Generator,
    latents: tp.Optional[tp.Sequence] = None,
) -> tp.List[EngineState]:
    """One engine state per seed: its parameters, fresh latents
    (``model.init_latents`` from ``generator``, seed after seed, or
    ``latents[i]`` if given), fresh optimizer states of ``cfg`` and a
    generator of its own, seeded from ``generator`` after all latents are
    drawn.  The JAX package stacks these states for its vmap; the port keeps
    them apart, as its seeds run in turn."""
    opt_x = cfg.optimizer_x.make()
    opt_p = cfg.optimizer_p.make() if cfg.optimizer_p is not None else None
    if latents is None:
        latents = [model.init_latents(p, inputs, generator) for p in params_list]
    else:
        latents = [tuple(_like(x, inputs) for x in lat) for lat in latents]
    if len(latents) != len(params_list):
        raise ValueError(f"{len(latents)} latent sets for {len(params_list)} seeds")
    seeds = torch.randint(0, 2**62, (len(params_list),), generator=generator)
    return [
        EngineState(
            params=params,
            latents=lat,
            opt_x_state=opt_x.init({"latents": lat}),
            opt_p_state=opt_p.init(params) if opt_p is not None else None,
            lr_scale=torch.ones(()),
            generator=torch.Generator().manual_seed(int(s)),
        )
        for params, lat, s in zip(params_list, latents, seeds)
    ]


def sweep_warm_langevin_chains(
    model: PCModel,
    params_list: tp.Sequence,
    config: dict,
    target: tp.Optional[torch.Tensor],
    inputs: torch.Tensor,
    generator: torch.Generator,
    stride: int = 1,
    langevin_var: float = 2.0,
    loss_fn=None,
    latents: tp.Optional[tp.Sequence] = None,
    chain_seeds: tp.Optional[tp.Sequence[int]] = None,
) -> tp.Tuple[torch.Tensor, ...]:
    """The figure-5 workload for every seed of ``params_list``: a warm start
    of ``config["T_pc"]`` Adam steps, then a Langevin chain of ``mixing +
    sampling`` SGD steps with noise variance ``langevin_var``, capturing the
    latents every ``stride`` steps (before each captured step's update).
    ``target=None`` runs the unclamped (spontaneous) chain.

    ``latents[i]`` are seed i's initial latents (else drawn from
    ``generator``, see ``make_seed_states``); ``chain_seeds[i]`` is its
    chain's noise seed (else drawn from its own generator).  Returns the
    captures as a tuple, one ``[S, n_cap, B, d]`` tensor a latent."""
    if loss_fn is None:
        loss_fn = config["loss_fn"] if target is not None else zero_fn
    kwargs = {"_target": target} if target is not None else {}
    if config.get("input_var") is not None:
        kwargs["_var"] = config["input_var"]
    if chain_seeds is not None and len(chain_seeds) != len(params_list):
        raise ValueError(f"{len(chain_seeds)} chain seeds for {len(params_list)} seeds")

    cfg_pc = EngineConfig(
        plan=build_plan(config["T_pc"], "all", "never"),
        optimizer_x=OptimizerSpec.from_torch_style(
            config["optimizer_x_fn_pc"], config["optimizer_x_kwargs_pc"]),
        optimizer_p=None,
        loss_fn=loss_fn,
        capture_every_t=False,
    )
    states = make_seed_states(model, cfg_pc, params_list, inputs, generator, latents)
    captures = []
    for i, state in enumerate(states):
        gen = GenerativeModel(model, state.generator, params=state.params,
                              device=inputs.device)
        gen.latents = state.latents
        get_pc_trainer(gen, config, is_mcpc=True, training=False).train_on_batch(
            inputs, loss_fn=loss_fn, loss_fn_kwargs=kwargs,
            is_sample_x_at_batch_start=False, is_return_results_every_t=False)
        res = get_mcpc_trainer(gen, config, training=False).train_on_batch(
            inputs, loss_fn=loss_fn, loss_fn_kwargs=kwargs,
            callback_after_t=LangevinStep(var=langevin_var),
            is_sample_x_at_batch_start=False, is_return_xs=True, capture_stride=stride,
            chain_seed=None if chain_seeds is None else chain_seeds[i])
        captures.append(res["xs"])
    return tuple(torch.stack(parts) for parts in zip(*captures))

