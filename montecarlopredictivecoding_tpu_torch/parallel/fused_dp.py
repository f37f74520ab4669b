"""Data-parallel fused MCPC training over a device mesh.

Chains are independent until the batch's weight update, so every rank runs
the fused whole-chain kernel (``ops.mcpc_chain``: the Adam warm start, the
Langevin chain and the Hebbian gradient sums) on its shard of the batch, and
ONE ``all_reduce`` over the mesh's ``data`` group sums the Monte-Carlo
parameter gradients before the optimizer step: the JAX package's
``shard_map`` with one ``psum``.  The collective is a library one (NCCL on
CUDA, gloo on the CPU); the kernel is the port's own.
"""

from __future__ import annotations

import typing as tp

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.model import PCModel
from ..ops.mcpc_chain import mcpc_chain, supports_model

# a shard's noise seed is seed + rank * SHARD_SEED_STRIDE, in int32
SHARD_SEED_STRIDE = 1000003


def shard_seed(seed: int, rank: int) -> int:
    """The noise seed of shard ``rank``, in int32 arithmetic that wraps as
    the JAX package's ``seed + axis_index * int32(1000003)`` does (into
    [-2**31, 2**31); the wrap of each term leaves the sum's the same)."""
    return ((int(seed) + rank * SHARD_SEED_STRIDE + 2**31) % 2**32) - 2**31


def shard_rows(mesh: DeviceMesh, B: int, axis: str = "data") -> slice:
    """This rank's rows ``[r·B/N, (r+1)·B/N)`` of a global batch of ``B``
    over ``axis`` (N ranks); raises unless N divides B, as ``shard_map``."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if B % n != 0:
        raise ValueError(f"batch {B} is not divisible by the {axis!r} axis of {n}")
    r = mesh.get_local_rank(axis)
    return slice(r * (B // n), (r + 1) * (B // n))


def make_dp_fused_chain(
    model: PCModel,
    mesh: DeviceMesh,
    *,
    T: int,
    lr: float,
    noise_var: tp.Optional[float],
    loss: str,
    input_var: float = 1.0,
    mixing: int = 0,
    with_pgrads: bool = True,
    warm_T: int = 0,
    warm_lr: float = 0.1,
    axis: str = "data",
):
    """Build the data-parallel fused chain:

        fn(params, latents, target, seed) -> (latents', pgrads summed over axis)

    ``latents`` and ``target`` are this rank's shard (:func:`place_dp`),
    ``params`` are the same on every rank, and the shard's noise seed is
    :func:`shard_seed`; ``mcpc_chain`` then keys its batch tiles
    ``shard_seed + tile`` with the tile taken from the local batch.  The
    gradients (sums, not yet divided) come back as global sums: the eight
    tensors in one buffer, one ``all_reduce`` over ``mesh``'s ``axis``
    group.  The JAX function's ``interpret``, ``matmul_layout`` and
    ``jit_compile`` have no counterpart: the kernel runs on CUDA tensors,
    the plain version on CPU ones, and nothing is compiled ahead.
    """
    if not supports_model(model, "relu"):
        raise ValueError("the data-parallel chain runs the relu MLP (make_mlp_model)")
    group = mesh.get_group(axis)
    rank = mesh.get_local_rank(axis)
    options = dict(T=T, lr=lr, noise_var=noise_var, loss=loss, input_var=input_var,
                   mixing=mixing, with_pgrads=with_pgrads, warm_T=warm_T,
                   warm_lr=warm_lr)

    def fn(params, latents, target, seed):
        new_latents, pgrads = mcpc_chain(params, latents, target,
                                         shard_seed(seed, rank), **options)[:2]
        if with_pgrads:
            # the only communication: energies are sums over datapoints, so
            # the shards' sums add up to the whole batch's
            pgrads = all_reduce_tree(pgrads, group)
        return new_latents, pgrads

    return fn


def all_reduce_tree(tree, group) -> tuple:
    """Sum a tuple of ``{"w", "b"}`` dicts over ``group``: one flat buffer,
    one ``all_reduce``."""
    leaves = [t for p in tree for t in p.values()]
    flat = torch.cat([t.reshape(-1) for t in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    parts = iter(flat.split([t.numel() for t in leaves]))
    return tuple({k: next(parts).view_as(v) for k, v in p.items()} for p in tree)


def broadcast_params(mesh: DeviceMesh, params, axis: str = "data") -> tuple:
    """``params`` as the ``axis`` group's first rank holds them, on every
    rank of the group (replicated)."""
    group = mesh.get_group(axis)
    src = dist.get_global_rank(group, 0)
    placed = []
    for p in params:
        q = {k: v.clone() for k, v in p.items()}
        for v in q.values():
            dist.broadcast(v, src=src, group=group)
        placed.append(q)
    return tuple(placed)


def place_dp(mesh: DeviceMesh, params, latents, target, axis: str = "data"):
    """This rank's share of a data-parallel call: ``params`` replicated
    (:func:`broadcast_params`), and this rank's rows of the global
    ``latents`` and ``target`` (:func:`shard_rows`)."""
    rows = shard_rows(mesh, latents[0].shape[0], axis)
    return (broadcast_params(mesh, params, axis),
            tuple(x[rows].contiguous() for x in latents), target[rows].contiguous())
