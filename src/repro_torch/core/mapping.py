"""Expert->server mapping: the service-discovery table (paper Fig. 6).

Runtime data, not program structure: a (E, R) table of candidate server
ranks per expert plus a (S,) liveness mask.  Failover rewrites the mask.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class ExpertServerMap:
    """Host-side mutable view of the expert->server mapping."""

    def __init__(self, mapping: np.ndarray, num_servers: int):
        assert mapping.ndim == 2
        self.table = np.asarray(mapping, np.int32)          # (E, R)
        self.alive = np.ones((num_servers,), bool)
        self.num_servers = num_servers

    def mark_dead(self, server: int) -> None:
        self.alive[server] = False

    def mark_alive(self, server: int) -> None:
        self.alive[server] = True

    def device_arrays(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.as_tensor(self.table, dtype=torch.int64, device=device),
                torch.as_tensor(self.alive, device=device))


def default_mapping(num_experts: int, num_servers: int,
                    max_replicas: int = 4) -> np.ndarray:
    """Primary-only placement: expert e on server e // (E/S)."""
    table = np.full((num_experts, max_replicas), -1, np.int32)
    per = num_experts // num_servers
    assert per * num_servers == num_experts, (num_experts, num_servers)
    table[:, 0] = np.arange(num_experts) // per
    return table


def lookup(table: torch.Tensor, alive: torch.Tensor,
           expert_ids: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """Pick an alive replica server per (token, k) routing decision,
    spreading uniformly over the alive replicas by ``salt % count``.

    table (E, R); alive (S,) bool; expert_ids, salt (T, k).  An expert with
    no alive replica falls back to server 0 (counted upstream as a miss).
    Returns server ids (T, k) int64.
    """
    cand = table[expert_ids]                                 # (T, k, R)
    ok = (cand >= 0) & alive[cand.clamp(min=0)]
    cnt = ok.sum(dim=-1)
    pick = salt % cnt.clamp(min=1)
    prefix = torch.cumsum(ok.to(torch.int64), dim=-1)        # 1-based rank
    sel = ok & (prefix == (pick + 1)[..., None])
    r = torch.argmax(sel.to(torch.int64), dim=-1)            # first match
    server = torch.gather(cand, -1, r[..., None])[..., 0]
    return torch.where(cnt > 0, server, 0)
