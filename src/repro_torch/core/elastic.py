"""The expert-server pool (paper §5.3): liveness and replication state that
emits fresh :class:`~repro_torch.core.moe_layer.MoERuntime` tensors after
each change.  Failover is a liveness-mask update; the pool size is fixed
in this slice (elastic resize is not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import expert_server, load_balance
from repro_torch.core.mapping import ExpertServerMap
from repro_torch.core.moe_layer import MoERuntime, default_capacity


@dataclass
class ServerPool:
    """Logical expert-server pool with liveness + replication state."""

    cfg: ModelConfig
    num_servers: int
    tokens_per_client: int
    n_redundant: int = 2
    max_replicas: int = 4
    stats: load_balance.ExpertStats = None
    smap: ExpertServerMap = None
    redundant_table: np.ndarray = None

    def __post_init__(self):
        E = self.cfg.moe.num_experts
        self.stats = load_balance.ExpertStats(E)
        mapping, red = self.plan(np.ones(E))
        # replica-column headroom, as the reference keeps for in-flight
        # migrations (routing-invisible: the extra columns stay -1)
        pad = np.full((E, self.max_replicas), -1, np.int32)
        self.smap = ExpertServerMap(np.concatenate([mapping, pad], axis=1),
                                    self.num_servers)
        self.redundant_table = red

    def server_failed(self, rank: int) -> None:
        self.smap.mark_dead(rank)

    def server_recovered(self, rank: int) -> None:
        self.smap.mark_alive(rank)

    def observe_load(self, expert_load: np.ndarray) -> None:
        self.stats.update(expert_load)

    def plan(self, load: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """EPLB plan from ``load`` (default: the traffic EMA)."""
        if load is None:
            load = (self.stats.ema if self.stats.ema is not None
                    else np.ones(self.cfg.moe.num_experts))
        return load_balance.eplb_plan(load, self.num_servers,
                                      self.n_redundant, self.max_replicas)

    def runtime(self, device) -> MoERuntime:
        table, alive = self.smap.device_arrays(device)
        m = self.cfg.moe
        local = expert_server.make_local_table(
            m.num_experts, self.num_servers, self.redundant_table)
        return MoERuntime(
            mapping=table, alive=alive,
            local_table=torch.as_tensor(local, dtype=torch.int64,
                                        device=device),
            num_servers=self.num_servers,
            capacity=default_capacity(self.tokens_per_client, m.top_k,
                                      self.num_servers, m.capacity_factor))
