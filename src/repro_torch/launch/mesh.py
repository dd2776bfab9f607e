"""Device meshes on ``torch.distributed`` (counterpart of
``src/repro/launch/mesh.py``).

A mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` with named
axes (``data``, ``model``; ``pod`` for two pods), one rank a device.
Each rank runs the same program on its own slice (the reference's
``shard_map`` bodies); collectives go over the process group of one axis,
or of every axis (:mod:`repro_torch.distributed.mesh_axes`).

The mesh lives on ``"cuda"`` under NCCL unless the caller asks for
``device="cpu"``, which runs gloo ranks (the CPU tests).  With no card and
no ``device="cpu"`` they raise: nothing falls back to a CPU mesh.
The process group is the caller's: :func:`init_distributed` starts one
from an explicit address (``tcp://localhost:<port>`` or a ``file://``
store), rank and world size — nothing here reads a cluster's environment.
"""

from __future__ import annotations

import datetime
import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh_axes import data_axes  # noqa: F401

# the reference's production meshes: 16 x 16 = 256 chips a pod, 2 pods =
# 512.  Built only over a ``fake`` world (make_production_mesh).
PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def _device(device: Optional[str]) -> str:
    device = device or "cuda"
    if device not in ("cuda", "cpu"):
        raise ValueError(f"mesh device {device!r}: 'cuda' or 'cpu'")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh needs a CUDA device; pass "
                           "device='cpu' for gloo ranks on the CPU")
    return device


def init_distributed(rank: int, world_size: int, init_method: str,
                     device: Optional[str] = None,
                     timeout_s: float = 120.0) -> None:
    """Start the default process group: NCCL on the card (this rank on
    card ``rank % device_count``), gloo for ``device="cpu"``.  A rank that
    waits longer than ``timeout_s`` in a collective fails."""
    device = _device(device)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        "nccl" if device == "cuda" else "gloo", init_method=init_method,
        rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def production_mesh_shape(*, multi_pod: bool = False
                          ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the reference's production mesh."""
    return PRODUCTION[multi_pod]


def fake_world(world: int) -> None:
    """A ``fake`` process group of ``world`` ranks, this process rank 0:
    collectives return at once and move nothing (the dry-run's
    accounting on ``meta`` tensors)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def make_production_mesh(multi_pod: bool = False):
    """The production mesh (16 x 16, or 2 x 16 x 16) over a ``fake``
    world, for the dry-run's accounting only: nothing runs on a device."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = production_mesh_shape(multi_pod=multi_pod)
    fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def make_test_mesh(n_data: int = 2, n_model: int = 4,
                   device: Optional[str] = None):
    """A (n_data, n_model) mesh over the whole world."""
    from torch.distributed.device_mesh import init_device_mesh

    device = _device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed (or "
                           "torch.distributed.init_process_group) first")
    if dist.get_world_size() != n_data * n_model:
        raise ValueError(f"a ({n_data}, {n_model}) mesh needs "
                         f"{n_data * n_model} ranks; the world has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device, (n_data, n_model),
                            mesh_dim_names=("data", "model"))
