"""Sharding rules for PC stacks over a ``(data, model)`` mesh.

Layout, as the JAX package's: the batch (chains) shards over ``data``; each
Linear's output features, and so each latent's feature dimension, shard over
``model`` where the axis divides them.  The tensors are DTensors
(``torch.distributed.tensor``) with those placements, and the port's step
engine runs on them as it runs on plain tensors: DTensor's sharding
propagation inserts the collectives (the gathers and reductions of the
activations at a feature-sharded layer, the reduction of the parameter
gradients over ``data``), as XLA does from the JAX package's annotations.
Each rank holds only its shards; nothing gathers the state onto one rank.
"""

from __future__ import annotations

import typing as tp

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ..core.engine import EngineConfig, EngineState, build_train_on_batch
from ..core.model import PCModel
from ..core.modules import Linear


def _shardable(dim: int, mesh: DeviceMesh, axis: str) -> bool:
    names = mesh.mesh_dim_names
    size = mesh.size(names.index(axis)) if axis in names else 1
    return size > 1 and dim % size == 0


def _placements(mesh: DeviceMesh, data, model) -> tp.List:
    """Placements in the mesh's dimension order from a ``data`` and a
    ``model`` placement."""
    by_name = {"data": data, "model": model}
    return [by_name[name] for name in mesh.mesh_dim_names]


def param_shardings(model: PCModel, mesh: DeviceMesh) -> tuple:
    """Per-Linear placements: a weight ``[in, out]`` is replicated over
    ``data`` and sharded on its output features over ``model`` (where they
    divide); its bias likewise."""
    out = []
    for i in model.linear_indices:
        lin: Linear = model.modules[i]
        split = _shardable(lin.out_dim, mesh, "model")
        p = {"w": _placements(mesh, Replicate(), Shard(1) if split else Replicate())}
        if lin.use_bias:
            p["b"] = _placements(mesh, Replicate(), Shard(0) if split else Replicate())
        out.append(p)
    return tuple(out)


def latent_shardings(model: PCModel, mesh: DeviceMesh, latents) -> tuple:
    """A latent ``[B, d]`` shards its batch over ``data`` and its features
    over ``model`` where they divide."""
    return tuple(
        _placements(mesh, Shard(0),
                    Shard(1) if _shardable(x.shape[-1], mesh, "model") else Replicate())
        for x in latents)


def shard_train_on_batch(
    model: PCModel,
    cfg: EngineConfig,
    mesh: DeviceMesh,
    state: EngineState,
    inputs,
    loss_kwargs,
) -> tp.Tuple[tp.Callable, EngineState, tp.Any, tp.Any]:
    """Build the engine's train_on_batch for ``mesh`` and place the state.

    Returns ``(fn, placed_state, placed_inputs, placed_loss_kwargs)``;
    ``fn(placed_state, placed_inputs, placed_loss_kwargs)`` returns the new
    state and the results as DTensors.  Every rank passes the same global
    tensors and a generator in the same state (the Langevin noise is drawn
    whole on every rank and each keeps its shard of it, so the noise does
    not depend on the mesh).  The optimizer states are made from the placed
    tensors, so their moments take the tensors' placements; the engine's
    own scalars (the step's zero, the learning-rate scale) count as
    replicated.
    """
    fn = build_train_on_batch(model, cfg)

    def place(t, placements):
        return distribute_tensor(t, mesh, placements)

    p_sh = param_shardings(model, mesh)
    l_sh = latent_shardings(model, mesh, state.latents)
    repl = _placements(mesh, Replicate(), Replicate())
    placed_params = tuple({k: place(v, p_sh[i][k]) for k, v in p.items()}
                          for i, p in enumerate(state.params))
    placed_latents = tuple(place(x, s) for x, s in zip(state.latents, l_sh))
    placed_inputs = place(inputs, _placements(
        mesh, Shard(0),
        Shard(1) if _shardable(inputs.shape[-1], mesh, "model") else Replicate()))
    batch = inputs.shape[0]
    placed_kwargs = {
        k: place(v, _placements(mesh, Shard(0), Replicate())
                 if v.ndim >= 1 and v.shape[0] == batch else repl)
        if isinstance(v, torch.Tensor) else v
        for k, v in loss_kwargs.items()
    }

    xs_tree = {"latents": placed_latents}
    if cfg.optimize_inputs:
        xs_tree["inputs"] = placed_inputs
    opt_x_state = (cfg.optimizer_x.make().init(xs_tree) if state.opt_x_state is None
                   else state.opt_x_state)
    opt_p_state = state.opt_p_state
    if opt_p_state is None and cfg.optimizer_p is not None:
        opt_p_state = cfg.optimizer_p.make().init(placed_params)
    placed_state = EngineState(
        params=placed_params,
        latents=placed_latents,
        opt_x_state=opt_x_state,
        opt_p_state=opt_p_state,
        lr_scale=place(state.lr_scale, repl),
        generator=state.generator,
    )

    def sharded(st: EngineState, inputs: DTensor, loss_kwargs):
        with implicit_replication():
            return fn(st, inputs, loss_kwargs)

    return sharded, placed_state, placed_inputs, placed_kwargs
