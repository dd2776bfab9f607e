"""Monolithic baselines the paper compares against (§2.2, §5) —
counterpart of ``src/repro/core/monolithic.py``.

* ``monolithic_ep`` — DeepEP-style expert parallelism: static expert->rank
  placement inside one collective group, no service indirection, no
  replicas.  Structurally this is EAAS with a primary-only mapping — which
  is the point: the paper's architecture strictly generalises monolithic
  EP, so the overhead of the indirection is measurable, and the baseline
  halts if any rank dies (``alive`` is not consulted: it stays all-true).
* ``tp_moe`` — tensor-parallel MoE: every rank holds a 1/P slice of every
  expert; no token exchange, but the model is replicated per unit, which
  caps the batch (the paper's SGL-TP line).  On one card it is the S = 1
  local layer: one server holding all E experts, one grouped GEMM per
  weight over G = E groups.  The batch cap and the restart stall are the
  serving engine's (``tp_batch_cap``, ``tp_restart_steps``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import expert_server
from repro_torch.core import mapping as emap
from repro_torch.core.moe_layer import (MoERuntime, MoEStats,
                                        default_capacity, eaas_moe_apply,
                                        init_eaas_moe)


def _no_replicas(num_servers: int) -> np.ndarray:
    return np.zeros((num_servers, 0), np.int32)


def monolithic_runtime(cfg: ModelConfig, num_servers: int,
                       tokens_per_client: int, device) -> MoERuntime:
    """Primary-only mapping, liveness pinned alive (a dead rank = a hang)."""
    m = cfg.moe
    table = emap.default_mapping(m.num_experts, num_servers, max_replicas=1)
    local = expert_server.make_local_table(m.num_experts, num_servers,
                                           _no_replicas(num_servers))
    return MoERuntime(
        mapping=torch.as_tensor(table, dtype=torch.int64, device=device),
        alive=torch.ones(num_servers, dtype=torch.bool, device=device),
        local_table=torch.as_tensor(local, dtype=torch.int64, device=device),
        num_servers=num_servers,
        capacity=default_capacity(tokens_per_client, m.top_k, num_servers,
                                  m.capacity_factor))


def init_monolithic_ep(cfg: ModelConfig, num_servers: int, dtype, device,
                       generator, lead=()) -> Dict:
    return init_eaas_moe(cfg, num_servers, _no_replicas(num_servers), dtype,
                         device, generator, lead)


def monolithic_ep_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig,
                        runtime: MoERuntime
                        ) -> Tuple[torch.Tensor, MoEStats]:
    """Identical dataflow to EAAS minus indirection (R = 1, no failover)."""
    return eaas_moe_apply(params, x, cfg.moe, runtime,
                          activation=cfg.activation)


def init_tp_moe(cfg: ModelConfig, dtype, device, generator, lead=()) -> Dict:
    # one logical server holding every expert (weights TP-sharded at launch)
    return init_eaas_moe(cfg, 1, _no_replicas(1), dtype, device, generator,
                         lead)


def tp_moe_apply(params: Dict, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, MoEStats]:
    rt = monolithic_runtime(cfg, 1, x.shape[0], x.device)
    return eaas_moe_apply(params, x, cfg.moe, rt, activation=cfg.activation)
