"""Rank mesh construction.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the world's
ranks with named dimensions (``data``, ``seq``, ``model``; or ``stage``
for the pipeline); each dimension has one process group a slice, which
stands in for a named mesh axis of the JAX package. Every rank builds
the same mesh, in the same order (``new_group`` is collective).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from lnasr_tpu_torch.config import MeshConfig
from lnasr_tpu_torch.parallel.distributed import Axis, local_device


def mesh_shape_for(n_devices: int, data: int = -1, seq: int = 1, model: int = 1) -> MeshConfig:
    """Fill in the -1 axis so data*seq*model == n_devices."""
    if data <= 0:
        if n_devices % (seq * model):
            raise ValueError(f"{n_devices} devices not divisible by seq*model={seq * model}")
        data = n_devices // (seq * model)
    elif data * seq * model != n_devices:
        raise ValueError(f"mesh {data}x{seq}x{model} != {n_devices} devices")
    return MeshConfig(data=data, seq=seq, model=model)


def make_mesh(config: Optional[MeshConfig] = None) -> DeviceMesh:
    """A ('data', 'seq', 'model') mesh over every rank of the world joined
    by :func:`~lnasr_tpu_torch.parallel.distributed.initialize` (rank r at
    row-major position r). A world of one is a (1, 1, 1) mesh, so the
    sharded code paths run unchanged on one device."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a world: call parallel.distributed.initialize "
                           "(or run under parallel.distributed.run_ranks) first")
    world = dist.get_world_size()
    if config is None:
        config = mesh_shape_for(world)
    if config.data * config.seq * config.model != world:
        raise ValueError(f"mesh {config.shape} != {world} ranks")
    ranks = torch.arange(world).reshape(config.shape)
    return DeviceMesh(local_device().type, ranks, mesh_dim_names=config.axis_names)


def mesh_axis(mesh: DeviceMesh, name: str) -> Axis:
    """The named axis of ``mesh`` as this rank sees it; a name the mesh
    lacks is an axis of size 1."""
    names = mesh.mesh_dim_names or ()
    if name not in names:
        return Axis(name, None, 1, 0)
    size = mesh.size(names.index(name))
    group = mesh.get_group(name) if size > 1 else None
    return Axis(name, group, size, mesh.get_local_rank(name))


def local_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's rows of a batch sharded over ``axis``; the batch must
    divide by the axis size."""
    if x.shape[0] % axis.size:
        raise ValueError(f"batch {x.shape[0]} must divide the {axis.name} axis ({axis.size})")
    per = x.shape[0] // axis.size
    return x[axis.index * per:(axis.index + 1) * per]

