"""Dynamic expert load balancing (paper §4.5) — a numpy copy of the
reference's ``src/repro/core/load_balance.py`` (pure numpy; the port keeps
its own copy rather than import the JAX package).

EAAS widens the load-balancing action space beyond EPLB's reorder+replicate:
(1) non-uniform expert counts per server, (2) scaling service instances of
hot experts up/down, (3) heterogeneous server capacity.  This module
implements the statistics pipeline and an EPLB-style greedy replication
planner producing the (mapping, redundant_table) pair consumed by
core.mapping / core.expert_server.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class ExpertStats:
    """EMA of per-expert token traffic (fed from MoEStats.expert_load)."""

    num_experts: int
    decay: float = 0.9
    ema: Optional[np.ndarray] = None
    updates: int = 0           # observations folded in (rebalance warm-up)

    def update(self, load: np.ndarray) -> None:
        load = np.asarray(load, np.float64)
        if self.ema is None:
            self.ema = load.copy()
        else:
            self.ema = self.decay * self.ema + (1 - self.decay) * load
        self.updates += 1

    def hot_experts(self, top: int) -> np.ndarray:
        assert self.ema is not None
        return np.argsort(-self.ema)[:top]


def primary_owner(num_experts: int, num_servers: int) -> np.ndarray:
    """Block-ish primary placement.  Uniform when S | E; otherwise servers
    host ⌈E/S⌉ or ⌊E/S⌋ experts — EAAS does NOT require equal counts
    (paper §4.5: non-uniform experts per server is a balancing degree of
    freedom monolithic EP lacks)."""
    return (np.arange(num_experts) * num_servers // num_experts).astype(
        np.int32)


def eplb_plan(load: np.ndarray, num_servers: int, n_redundant: int,
              max_replicas: int = 4,
              capacities: Optional[np.ndarray] = None
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy EPLB-style replication plan.

    load: (E,) expected tokens per expert.  Returns
      mapping (E, max_replicas) int32 — candidate servers per expert,
      redundant_table (S, n_redundant) int32 — extra experts per server.

    Primary placement stays block-contiguous (primary_owner) so the weight
    shards never move; hot experts gain replicas on the least-loaded
    servers.  Expected per-server load is balanced under the EAAS client
    policy of spreading tokens uniformly over alive replicas.

    ``capacities`` (S,) models heterogeneous servers (paper §4.5 degree of
    freedom 3): loads are normalized by relative capacity when picking the
    least-loaded replica target, so a 2x server absorbs 2x the traffic
    before it looks "full".  (Clients additionally *spread* tokens over a
    replica set proportionally to capacity — see :func:`server_loads` /
    ``mapping.lookup`` — the planner's internal accounting keeps the
    uniform-share approximation, which is conservative: it under-credits
    big servers, never overloads them.)  All sort orders are stable, so the
    plan is a
    deterministic function of (load, S, n_redundant, max_replicas,
    capacities) — identical EMAs always produce the identical plan.
    """
    load = np.asarray(load, np.float64)
    E = load.shape[0]
    S = num_servers
    cap = (np.ones(S, np.float64) if capacities is None
           else np.asarray(capacities, np.float64))
    assert cap.shape == (S,) and (cap > 0).all(), cap

    mapping = np.full((E, max_replicas), -1, np.int32)
    mapping[:, 0] = primary_owner(E, S)

    red_table = np.full((S, n_redundant), -1, np.int32)
    red_used = np.zeros(S, np.int32)

    # effective load per server given current replica sets
    replicas = {e: [int(mapping[e, 0])] for e in range(E)}
    server_load = np.zeros(S, np.float64)
    for e in range(E):
        server_load[mapping[e, 0]] += load[e]

    total_slots = S * n_redundant
    order = np.argsort(-load, kind="stable")       # hottest first
    for _ in range(total_slots):
        # pick the expert whose replication most reduces the max load
        best_e, best_gain, best_s = -1, 0.0, -1
        for e in order[:max(32, 4 * S)]:
            reps = replicas[int(e)]
            if len(reps) >= max_replicas:
                continue
            share = load[e] / len(reps)
            new_share = load[e] / (len(reps) + 1)
            # candidate server: least capacity-normalized load with a free
            # redundant slot
            cand = -1
            for s in np.argsort(server_load / cap, kind="stable"):
                if red_used[s] < n_redundant and s not in reps:
                    cand = int(s)
                    break
            if cand < 0:
                continue
            gain = share - new_share - 1e-12
            # prioritize by current load pressure of the expert's servers
            pressure = max(server_load[s] / cap[s] for s in reps)
            score = gain * (1 + pressure)
            if score > best_gain:
                best_e, best_gain, best_s = int(e), score, cand
        if best_e < 0:
            break
        reps = replicas[best_e]
        old_share = load[best_e] / len(reps)
        new_share = load[best_e] / (len(reps) + 1)
        for s in reps:
            server_load[s] -= old_share - new_share
        server_load[best_s] += new_share
        red_table[best_s, red_used[best_s]] = best_e
        red_used[best_s] += 1
        mapping[best_e, len(reps)] = best_s
        reps.append(best_s)

    return mapping, red_table


def server_loads(load: np.ndarray, mapping: np.ndarray, num_servers: int,
                 alive: Optional[np.ndarray] = None,
                 capacities: Optional[np.ndarray] = None) -> np.ndarray:
    """(S,) expected per-server load under the client spreading policy
    :func:`repro_torch.core.mapping.lookup` implements with its salt: uniform
    over the alive replicas when ``capacities`` is None, proportional to
    relative capacity otherwise (a 2x server absorbs 2x the replica
    traffic)."""
    load = np.asarray(load, np.float64)
    ok = (np.ones(num_servers, bool) if alive is None
          else np.asarray(alive, bool))
    cap = (None if capacities is None
           else np.asarray(capacities, np.float64))
    out = np.zeros(num_servers, np.float64)
    for e in range(load.shape[0]):
        reps = [int(s) for s in mapping[e] if s >= 0 and ok[s]]
        if not reps:
            continue
        if cap is None:
            for s in reps:
                out[s] += load[e] / len(reps)
        else:
            total = sum(cap[s] for s in reps)
            for s in reps:
                out[s] += load[e] * cap[s] / max(total, 1e-12)
    return out


def lane_loads(load: np.ndarray, mapping: np.ndarray, num_servers: int,
               alive: Optional[np.ndarray] = None,
               capacities: Optional[np.ndarray] = None) -> np.ndarray:
    """(S, E) per-(server, expert) load decomposition under the same client
    spreading policy as :func:`server_loads`: column ``e`` spreads
    ``load[e]`` uniformly over its alive replicas (capacity-proportionally
    when ``capacities`` is given), so each row sums to that server's
    :func:`server_loads` entry.  This is the async tier's per-expert queue
    *lane* decomposition — which expert's lane each server-second of a
    dispatched wave belongs to."""
    load = np.asarray(load, np.float64)
    ok = (np.ones(num_servers, bool) if alive is None
          else np.asarray(alive, bool))
    cap = (None if capacities is None
           else np.asarray(capacities, np.float64))
    out = np.zeros((num_servers, load.shape[0]), np.float64)
    for e in range(load.shape[0]):
        reps = [int(s) for s in mapping[e] if s >= 0 and ok[s]]
        if not reps:
            continue
        if cap is None:
            for s in reps:
                out[s, e] += load[e] / len(reps)
        else:
            total = sum(cap[s] for s in reps)
            for s in reps:
                out[s, e] += load[e] * cap[s] / max(total, 1e-12)
    return out


def imbalance(load: np.ndarray, mapping: np.ndarray, num_servers: int,
              alive: Optional[np.ndarray] = None,
              capacities: Optional[np.ndarray] = None) -> float:
    """max/mean capacity-normalized per-server load over the alive servers
    under the client spreading policy (uniform, or capacity-proportional
    when ``capacities`` is given).  1.0 = perfectly balanced; this is the
    factor by which the slowest server stretches a lockstep expert phase."""
    ok = (np.ones(num_servers, bool) if alive is None
          else np.asarray(alive, bool))
    if not ok.any():
        return 1.0
    eff = server_loads(load, mapping, num_servers, alive,
                       capacities=capacities)
    if capacities is not None:
        eff = eff / np.asarray(capacities, np.float64)
    eff = eff[ok]
    mean = eff.mean()
    return float(eff.max() / max(mean, 1e-12))


def plan_digest(mapping: np.ndarray, num_servers: int) -> str:
    """Short content hash of a placement's *routing-visible* shape: the
    per-expert replica sets (order-free — replica column order only shifts
    the salt spreading, never which servers can serve an expert) plus the
    pool size.  A live :class:`~repro_torch.core.mapping.ExpertServerMap` that
    converged to a plan by incremental drop/register steps digests equal to
    the plan built in one shot — the cheap convergence assertion the
    rebalance controller and its tests use."""
    rows = [sorted(int(s) for s in row if s >= 0)
            for row in np.asarray(mapping)]
    blob = json.dumps([int(num_servers), rows]).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def migration_updates(old_red: np.ndarray, new_red: np.ndarray
                      ) -> Tuple[np.ndarray, List[Tuple[int, int, int, int]]]:
    """Diff two redundant tables into minimal per-slot migrations.

    Returns ``(aligned, updates)`` where ``aligned`` is ``new_red`` with
    each server's row reordered so experts already hosted keep their slot
    (slot order inside a server is routing-invisible — the local table is
    derived), and ``updates`` is ``[(server, red_slot, old_eid, new_eid)]``
    for exactly the slots whose occupant changes.  ``new_eid == -1`` means
    the slot empties (replica dropped without replacement).  Deterministic:
    plain in-order scans, no hashing."""
    old_red = np.asarray(old_red, np.int32)
    new_red = np.asarray(new_red, np.int32)
    assert old_red.shape == new_red.shape, (old_red.shape, new_red.shape)
    S, n = old_red.shape
    aligned = np.full_like(old_red, -1)
    updates: List[Tuple[int, int, int, int]] = []
    for s in range(S):
        remaining = [int(e) for e in new_red[s] if e >= 0]
        row = np.full(n, -1, np.int32)
        for j in range(n):                 # keep experts already in place
            e = int(old_red[s, j])
            if e >= 0 and e in remaining:
                row[j] = e
                remaining.remove(e)
        free = [j for j in range(n) if row[j] < 0]
        for j, e in zip(free, remaining):  # repurpose the rest
            row[j] = e
        for j in range(n):
            if row[j] != old_red[s, j]:
                updates.append((s, j, int(old_red[s, j]), int(row[j])))
        aligned[s] = row
    return aligned, updates
