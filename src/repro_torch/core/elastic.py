"""Elastic scaling of the expert-service tier (paper §5.3) — the
reference's ``core/elastic.py``.

* :class:`ServerPool` — host-side pool state (liveness, replication,
  router skew, paged-out experts, pool size) that emits fresh
  :class:`~repro_torch.core.moe_layer.MoERuntime` tensors at every step, so
  failover, rebalancing and resizing take effect at the next step.  The
  pool owns placement only; the weight paths are
  :mod:`repro_torch.core.expert_server`'s ``migrate_slots`` and
  ``reshard_server_weights``, applied by the executor.
* :class:`PoolClient` — one attention client's view of a pool shared by a
  cluster: everything delegates to the pool, and its runtime's ``alive``
  tensor also drops the servers this client masked out locally.
* :func:`provision` / :func:`resource_saving` — the traffic -> server-count
  policy of the weak-scaling benchmark (the paper's 37.5 % saving).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

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
    # relative per-server capacity weights ((S,) or None = homogeneous);
    # heterogeneous pools tilt replica placement toward the big servers
    capacities: np.ndarray = None
    stats: load_balance.ExpertStats = None
    smap: ExpertServerMap = None
    redundant_table: np.ndarray = None
    route_bias: np.ndarray = None

    def __post_init__(self):
        E = self.cfg.moe.num_experts
        self.stats = load_balance.ExpertStats(E)
        self.route_bias = np.zeros(E, np.float32)
        # scale-to-zero state: experts paged out of the tier (replica slots
        # evicted; the primary stays addressable as the page-in source)
        # and, for hysteresis, when each one last paged back in
        self.cold: set = set()
        self.page_in_t: dict = {}
        mapping, red = self.plan(np.ones(E))
        self.smap = self._make_smap(mapping)
        self.redundant_table = red

    def _make_smap(self, mapping: np.ndarray) -> ExpertServerMap:
        """The live mapping table with replica-column headroom: an
        in-flight incremental migration registers a new replica before a
        later chunk drops the old one, so an expert can transiently hold
        up to (old + new) replicas — double width absorbs the worst
        case."""
        E = mapping.shape[0]
        pad = np.full((E, self.max_replicas), -1, np.int32)
        return ExpertServerMap(np.concatenate([mapping, pad], axis=1),
                               self.num_servers)

    # ------------------------------------------------------------- events
    def server_failed(self, rank: int) -> None:
        self.smap.mark_dead(rank)

    def server_recovered(self, rank: int) -> None:
        self.smap.mark_alive(rank)

    def observe_load(self, expert_load: np.ndarray) -> None:
        self.stats.update(expert_load)

    def set_route_bias(self, bias: np.ndarray) -> None:
        """Install a router-logit offset (scenario traffic shaping)."""
        bias = np.asarray(bias, np.float32)
        assert bias.shape == self.route_bias.shape, bias.shape
        self.route_bias = bias

    # ---------------------------------------------------------- balancing
    def plan(self, load: Optional[np.ndarray] = None
             ) -> Tuple[np.ndarray, np.ndarray]:
        """EPLB plan for this pool from ``load`` (default: the traffic EMA,
        uniform when nothing has been observed).  Paged-out experts' load
        is masked, so the redundant slots go to resident experts."""
        if load is None:
            load = (self.stats.ema if self.stats.ema is not None
                    else np.ones(self.cfg.moe.num_experts))
        if self.cold:
            load = np.asarray(load, np.float64).copy()
            for e in self.cold:
                if 0 <= e < load.shape[0]:
                    load[e] = 0.0
        return load_balance.eplb_plan(
            load, self.num_servers, self.n_redundant, self.max_replicas,
            capacities=self.capacities)

    @property
    def plan_digest(self) -> str:
        """Digest of the live placement's replica sets (order-free)."""
        return load_balance.plan_digest(self.smap.table, self.num_servers)

    def current_imbalance(self) -> float:
        """max/mean per-alive-server load of the traffic EMA under the live
        placement — the factor the slowest server stretches a decode
        step."""
        if self.stats.ema is None:
            return 1.0
        return load_balance.imbalance(
            self.stats.ema, self.smap.table, self.num_servers,
            alive=self.smap.alive, capacities=self.capacities)

    def client_view(self, client_id: int = 0) -> "PoolClient":
        """A per-client handle on this shared pool (cluster front-end)."""
        return PoolClient(self, client_id)

    def apply_plan(self, mapping: np.ndarray, red: np.ndarray) -> None:
        """Adopt a placement wholesale, preserving liveness (the one-shot
        path; the rebalance controller converges incrementally instead)."""
        alive = self.smap.alive.copy()
        self.smap = self._make_smap(mapping)
        self.smap.alive = alive
        self.redundant_table = red

    def rebalance(self) -> bool:
        """Re-plan replication from the traffic EMA (paper §4.5); a plan
        placement-identical to the live table (same replica sets) changes
        nothing.  Returns whether the placement changed."""
        if self.stats.ema is None:
            return False
        mapping, red = self.plan()
        if load_balance.plan_digest(mapping,
                                    self.num_servers) == self.plan_digest:
            return False
        self.apply_plan(mapping, red)
        return True

    # ------------------------------------------------------- scale-to-zero
    def page_out_experts(self, experts
                         ) -> Tuple[List[int], List[Tuple[int, int, int]]]:
        """Page cold experts out of the tier: every replica slot is evicted
        (dropped from the mapping, to be zeroed in the weights) and the
        expert is marked cold.  The primary stays addressable as the
        page-in source, so a token routed to a cold expert still computes
        exactly; it pays the modelled cold start instead.

        Returns ``(paged, updates)``: the experts paged and the
        ``(server, local_slot, -1)`` weight updates the caller applies
        through its migration path."""
        E = self.cfg.moe.num_experts
        prim = load_balance.primary_owner(E, self.num_servers)
        paged: List[int] = []
        updates: List[Tuple[int, int, int]] = []
        for e in sorted({int(x) for x in experts}):
            if not 0 <= e < E or e in self.cold:
                continue
            for s, j in expert_server.replica_columns(
                    self.redundant_table, e):
                self.redundant_table[s, j] = -1
                updates.append((s, expert_server.redundant_slot(
                    E, self.num_servers, j), -1))
            row = self.smap.table[e]
            row[:] = -1
            row[0] = prim[e]           # primary only: the page-in source
            self.cold.add(e)
            self.page_in_t.pop(e, None)
            paged.append(e)
        return paged, updates

    def page_in_expert(self, e: int, t: float) -> bool:
        """First token routed to a cold expert: it is resident again (the
        autoscaler's hysteresis protects it from paging straight back out)
        and serves from its primary until the next rebalance re-plans its
        replicas.  Returns whether a page-in happened."""
        e = int(e)
        if e not in self.cold:
            return False
        self.cold.discard(e)
        self.page_in_t[e] = float(t)
        return True

    def resident_fraction(self) -> float:
        """Share of experts resident in the tier (1.0 = none paged out)."""
        return 1.0 - len(self.cold) / self.cfg.moe.num_experts

    # ------------------------------------------------------------- elastic
    def feasible_counts(self) -> List[int]:
        """Pool sizes the block-contiguous primary layout supports."""
        E = self.cfg.moe.num_experts
        return [n for n in range(1, E + 1) if E % n == 0]

    def scale_to(self, n: int) -> None:
        """Grow/shrink the logical pool to ``n`` servers (paper §5.3):
        re-plan from the traffic EMA (uniform before any traffic),
        preserve surviving ranks' liveness (new ranks start alive) and
        bring paged-out experts back resident.  The caller reshards the
        weights (``Executor.resize``)."""
        E = self.cfg.moe.num_experts
        if E % n:
            raise ValueError(
                f"cannot scale to {n} servers: {E} experts need E % n == 0 "
                f"(feasible: {self.feasible_counts()})")
        if n == self.num_servers:
            return
        load = self.stats.ema if self.stats.ema is not None else np.ones(E)
        old_alive = self.smap.alive
        self.num_servers = n
        if self.capacities is not None:     # keep surviving ranks' weights
            caps = np.ones(n, np.float64)
            k = min(len(self.capacities), n)
            caps[:k] = np.asarray(self.capacities, np.float64)[:k]
            self.capacities = caps
        self.cold.clear()
        self.page_in_t.clear()
        mapping, red = self.plan(load)
        self.smap = self._make_smap(mapping)
        k = min(len(old_alive), n)
        self.smap.alive[:k] = old_alive[:k]
        self.redundant_table = red

    # ------------------------------------------------------------ runtime
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
                                      self.num_servers, m.capacity_factor),
            # an all-zero bias is the unbiased router: skip its upload and
            # add on the unskewed path
            route_bias=(torch.as_tensor(self.route_bias, device=device)
                        if self.route_bias.any() else None),
            replica_weights=(None if self.capacities is None
                             else torch.as_tensor(self.capacities,
                                                  dtype=torch.float32,
                                                  device=device)))


class PoolClient:
    """One attention client's handle on a shared :class:`ServerPool`.

    The placement, replicas and global liveness are one object every
    client reads, so failures and migrations are seen consistently; a
    client may also mask out servers it observed misbehaving before the
    monitor confirms the failure pool-wide.  Everything but
    :meth:`alive_mask` and :meth:`runtime` delegates to the pool;
    ``runtime`` ANDs the client's mask into the ``alive`` tensor on the
    engine's device."""

    def __init__(self, pool: ServerPool, client_id: int = 0):
        self.pool = pool
        self.client_id = client_id
        self._masked: set = set()      # server ranks this client masked out

    def mask_server(self, rank: int) -> None:
        """Locally stop routing to ``rank`` (this client only)."""
        self._masked.add(int(rank))

    def unmask_server(self, rank: int) -> None:
        self._masked.discard(int(rank))

    @property
    def masked_servers(self) -> Tuple[int, ...]:
        return tuple(sorted(self._masked))

    def alive_mask(self) -> np.ndarray:
        """(S,) shared liveness AND the client's local mask."""
        mask = self.pool.smap.alive.copy()
        for r in self._masked:
            if r < mask.shape[0]:
                mask[r] = False
        return mask

    def runtime(self, device) -> MoERuntime:
        rt = self.pool.runtime(device)
        if not self._masked:
            return rt                  # the shared view verbatim
        return rt._replace(alive=torch.as_tensor(self.alive_mask(),
                                                 device=device))

    def __getattr__(self, name):
        return getattr(self.pool, name)


def provision(request_rate: float, rate_per_server: float,
              granularity: int = 1) -> int:
    """Servers needed for a traffic level, at EAAS (1) vs monolithic
    (group) granularity."""
    need = max(1, math.ceil(request_rate / max(rate_per_server, 1e-9)))
    return int(math.ceil(need / granularity) * granularity)


def resource_saving(request_rate: float, rate_per_server: float,
                    monolithic_group: int) -> float:
    """Fraction of servers EAAS saves vs group-granular scaling (paper:
    37.5 %)."""
    fine = provision(request_rate, rate_per_server, 1)
    coarse = provision(request_rate, rate_per_server, monolithic_group)
    return 1.0 - fine / coarse
