"""Expert->server mapping: the service-discovery table (paper Fig. 6).

Runtime data, not program structure: a (E, R) table of candidate server
ranks per expert plus a (S,) liveness mask.  Failover rewrites the mask;
rebalancing and resizing rewrite the table.
"""

from __future__ import annotations

from typing import Optional, Tuple

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

    def register_replica(self, expert: int, server: int) -> None:
        """A server announced it hosts ``expert`` (paper: registration)."""
        row = self.table[expert]
        free = np.where(row < 0)[0]
        if len(free) == 0:
            raise ValueError(f"replica table full for expert {expert}")
        row[free[0]] = server

    def drop_replica(self, expert: int, server: int) -> None:
        row = self.table[expert]
        row[row == server] = -1

    def alive_replica_count(self) -> np.ndarray:
        ok = (self.table >= 0) & self.alive[np.clip(self.table, 0, None)]
        return ok.sum(axis=1)

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


# quantization of the salt-derived uniform used for weighted replica picks
# (the reference's constant: exact in fp32, resolves ~1000:1 capacities)
_WEIGHT_QUANT = 4096
_KNUTH = 2654435761


def lookup(table: torch.Tensor, alive: torch.Tensor,
           expert_ids: torch.Tensor, salt: torch.Tensor,
           weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pick an alive replica server per (token, k) routing decision.

    table (E, R); alive (S,) bool; expert_ids, salt (T, k).  Without
    ``weights`` tokens spread uniformly over the alive replicas by
    ``salt % count``; with ``weights`` ((S,) fp32 relative capacities) they
    spread proportionally to capacity: the salt's multiplicative (Knuth)
    hash quantizes to a uniform in [0, 1) and picks the replica whose
    cumulative-capacity interval covers it.  An expert with no alive
    replica falls back to server 0 (counted upstream as a miss).  Returns
    server ids (T, k) int64.
    """
    cand = table[expert_ids]                                 # (T, k, R)
    ok = (cand >= 0) & alive[cand.clamp(min=0)]
    cnt = ok.sum(dim=-1)
    if weights is None:
        pick = salt % cnt.clamp(min=1)
        prefix = torch.cumsum(ok.to(torch.int64), dim=-1)    # 1-based rank
        sel = ok & (prefix == (pick + 1)[..., None])
        r = torch.argmax(sel.to(torch.int64), dim=-1)        # first match
    else:
        w = torch.where(ok, weights.float()[cand.clamp(min=0)], 0.0)
        total = w.sum(dim=-1)
        # the reference's uint32 product: int64 keeps the low 32 bits
        # exact even where the product wraps
        h = (((salt.to(torch.int64) & 0xFFFFFFFF) * _KNUTH) & 0xFFFFFFFF) \
            % _WEIGHT_QUANT
        u = (h.float() + 0.5) / _WEIGHT_QUANT * total
        csum = torch.cumsum(w, dim=-1)
        r = torch.argmax((csum > u[..., None]).to(torch.int64),
                         dim=-1)                             # first cover
    server = torch.gather(cand, -1, r[..., None])[..., 0]
    return torch.where(cnt > 0, server, 0)
