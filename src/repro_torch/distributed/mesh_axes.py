"""Named axes of a device mesh: sizes, this rank's index and the process
group over one axis or all of them.

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
axes (``data``, ``model``; ``pod`` for two pods), one rank a device
(built by :mod:`repro_torch.launch.mesh`).  These are the counterparts of
``jax.lax.psum`` / ``axis_index`` / ``axis_size`` over named axes inside
the reference's ``shard_map`` bodies.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch.distributed as dist


def data_axes(mesh) -> Tuple[str, ...]:
    """Batch axes of a mesh (everything but ``model``)."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def axes_size(mesh, axes: Sequence[str]) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return math.prod(sizes[a] for a in axes)


def axes_index(mesh, axes: Sequence[str]) -> int:
    """This rank's index along ``axes`` flattened in their order (the
    first axis major), as ``jax.lax.axis_index`` over several axes."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + coord[a]
    return idx


def axes_group(mesh, axes: Sequence[str]):
    """The process group of the ranks that differ only along ``axes``: one
    axis's group, every axis's (the world the mesh spans), or several
    axes' in the mesh's order (a 3-D mesh's batch axes ("pod", "data"):
    the sub-mesh flattened, the first axis major; every rank must ask for
    it, as for any new group)."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if set(axes) == set(mesh.mesh_dim_names) and len(axes) == mesh.ndim:
        if mesh.size() != dist.get_world_size():
            raise ValueError("the mesh does not span the world")
        return dist.group.WORLD
    order = [a for a in mesh.mesh_dim_names if a in axes]
    if tuple(order) != axes:
        raise ValueError(f"axes {axes} out of the mesh's order "
                         f"{mesh.mesh_dim_names}")
    return mesh[axes]._flatten().get_group()


def mesh_groups(mesh) -> Tuple:
    """Every process group a step on ``mesh`` may call a collective over:
    each axis's and the world's (several axes' groups are flattened from
    these and share their backend); none for one device (``mesh`` None)."""
    if mesh is None:
        return ()
    return (*(mesh.get_group(a) for a in mesh.mesh_dim_names),
            dist.group.WORLD)
