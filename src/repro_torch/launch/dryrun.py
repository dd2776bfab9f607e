"""The multi-device serving runtime of a dry-run cell (counterpart of
``src/repro/launch/dryrun.py``'s ``moe_runtime_for``).

Only the runtime the SPMD path needs is here: the expert tier's mapping,
liveness, local tables and slot capacity for a cell's shape on a mesh.
The dry-run's accounting (compiled FLOPs, bytes and collectives per cell)
follows in a later slice, with the dense tensor-parallel execution it
measures.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core import expert_server
from repro_torch.core import mapping as emap
from repro_torch.core.moe_layer import MoERuntime, default_capacity
from repro_torch.distributed.mesh_axes import data_axes


def moe_runtime_for(cfg: ModelConfig, mesh, shape: InputShape,
                    mode: str) -> Optional[MoERuntime]:
    """One logical server per rank of the ``model`` axis, two replicas a
    expert in the mapping, no redundant slots; the capacity sized for a
    client's tokens: a2a splits the batch over every rank, replicated over
    the data axes only.  The tables live on the mesh's device type."""
    if cfg.moe is None:
        return None
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    S = sizes["model"]
    dp_total = math.prod(sizes[a] for a in data_axes(mesh))
    if mode == "a2a":
        tokens_per_client = shape.global_batch * shape.seq_len // (
            dp_total * S)
    else:
        tokens_per_client = max(shape.global_batch // dp_total, 1)
    device = mesh.device_type
    table = emap.default_mapping(cfg.moe.num_experts, S, max_replicas=2)
    local = expert_server.make_local_table(
        cfg.moe.num_experts, S, np.zeros((S, 0), np.int32))
    return MoERuntime(
        mapping=torch.as_tensor(table, dtype=torch.int64, device=device),
        alive=torch.ones(S, dtype=torch.bool, device=device),
        local_table=torch.as_tensor(local, dtype=torch.int64, device=device),
        num_servers=S,
        capacity=default_capacity(tokens_per_client, cfg.moe.top_k, S,
                                  cfg.moe.capacity_factor))
