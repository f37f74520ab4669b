"""Device-mesh helpers.

The mesh has two named dimensions, as the JAX package's:

* ``data``: datapoints, i.e. Monte-Carlo chains (pure data parallel; the
  parameter gradients are summed over it once a batch, ``fused_dp.py``);
* ``model``: the feature dimension of the wide layers (tensor parallel,
  ``sharding.py``).

A mesh spans the ranks of the current ``torch.distributed`` process group,
one process a device: rank ``r`` works on ``cuda:LOCAL_RANK`` (torchrun's
variable; without it ``r`` modulo the visible cards), or on the CPU when the
caller asks for ``device="cpu"``.  The caller initialises the group (the
command line does, from torchrun's environment).
"""

from __future__ import annotations

import os
import typing as tp

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (or the rank modulo the
    visible cards), made current, or the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"a mesh runs on cuda or cpu, not {device.type}")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def make_mesh(
    devices: tp.Optional[tp.Sequence[int]] = None,
    data: tp.Optional[int] = None,
    model: int = 1,
    device="cuda",
) -> DeviceMesh:
    """A ``(data, model)`` mesh over the given ranks (default: every rank of
    the process group), on ``device``'s type."""
    if devices is None:
        if not dist.is_initialized():
            raise ValueError("make_mesh needs an initialised torch.distributed process group")
        devices = range(dist.get_world_size())
    devices = list(devices)
    n = len(devices)
    if data is None:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    if not dist.is_initialized():
        raise ValueError("make_mesh needs an initialised torch.distributed process group")
    kind = rank_device(device).type
    ranks = torch.tensor(devices, dtype=torch.int64).reshape(data, model)
    return DeviceMesh(kind, ranks, mesh_dim_names=("data", "model"))


def best_mesh_shape(n: int, feature_dims: tp.Sequence[int]) -> tp.Tuple[int, int]:
    """Pick (data, model) for n devices: the largest model-axis size that
    divides every shardable feature dim (so tensor parallelism applies to the
    whole stack), capped at 4 — beyond that the small MCPC layers (20-128
    wide) fragment and tensor parallelism stops paying for its collectives."""
    best_model = 1
    for m in (2, 4):
        if n % m == 0 and all(d % m == 0 for d in feature_dims):
            best_model = m
    return n // best_model, best_model
