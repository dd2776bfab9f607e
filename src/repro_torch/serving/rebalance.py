"""Live traffic-adaptive expert rebalancing (paper §4.5, Fig. 10) — the
reference's ``serving/rebalance.py``.

* every decode step (and chunked-prefill step) feeds ``MoEStats
  .expert_load`` into the pool's ``ExpertStats`` EMA (the engine's side);
* the :class:`RebalanceController` periodically re-runs the EPLB planner on
  the EMA and diffs the plan against the live mapping by
  ``load_balance.plan_digest``: placement-identical plans count as no-ops;
* a changed plan becomes a queue of per-slot migrations
  (``load_balance.migration_updates``), applied ``chunk`` expert copies
  per engine step between decode steps.  Each chunk is break-before-make:
  the old replica leaves the mapping, the new expert's weights are copied
  into the slot in place (a ``migrate`` charge on the engine's clock), and
  only then is the new replica registered — traffic never reaches a slot
  whose weights do not match.

The controller drives a narrow host interface — ``pool``, ``clk``,
``clock``, ``metrics``, ``apply_migration(copies)``,
``charge_migration(dt)``, ``last_placement_change`` — which
:class:`~repro_torch.serving.engine.ServingEngine` implements, and
:class:`~repro_torch.serving.cluster.Cluster` too (its chunks write the one
shared weight bank once).  ``charge_migration`` is where the execution
modes differ: a lockstep host advances its clock, an async host occupies
the expert tier's queues instead.  It shares
the engine's ``last_placement_change`` cooldown with the
:class:`~repro_torch.serving.autoscale.Autoscaler`, which holds off while
a migration is in flight; ``engine.scale_to`` aborts a staged migration.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from repro_torch.core import load_balance
from repro_torch.core.expert_server import redundant_slot


def _slot_moves(pool, updates):
    """``(server, local_slot, new_eid)`` weight updates of a migration diff.
    A slot left empty (``-1``) is zeroed, as page-out and a resize leave
    one — the reference leaves its stale copy, which no route reads; the
    clock and ``migrated_experts`` count the copies only, as there."""
    E = pool.cfg.moe.num_experts
    return [(s, redundant_slot(E, pool.num_servers, j), new_e)
            for s, j, _, new_e in updates]


def oneshot_rebalance(host) -> None:
    """Re-plan from the traffic EMA and migrate in ONE step (the scripted
    ``rebalance`` scenario event / manual path).  ``host`` is an engine or
    a cluster — see the module docstring for the interface."""
    pool = host.pool
    mapping, red = pool.plan()
    changed = (load_balance.plan_digest(mapping, pool.num_servers)
               != pool.plan_digest)
    if changed:
        aligned, updates = load_balance.migration_updates(
            pool.redundant_table, red)
        moves = _slot_moves(pool, updates)
        copies = [m for m in moves if m[2] >= 0]
        host.clk.start()
        if moves:
            host.apply_migration(moves)
        dt = host.clk.stop("migrate", tokens=len(copies),
                           servers=pool.num_servers)
        host.charge_migration(dt)
        pool.apply_plan(mapping, aligned)
        host.metrics.rebalances += 1
        host.metrics.migrated_experts += len(copies)
        host.metrics.migration_time += dt
        host.last_placement_change = host.clock
    else:
        host.metrics.rebalance_noops += 1
    host.metrics.events.append(
        {"t": host.clock, "event": "rebalance", "changed": changed})


@dataclass
class RebalanceConfig:
    # engine-clock seconds between plan evaluations
    interval: float = 0.02
    # expert-weight copies applied per engine step (migration granularity)
    chunk: int = 2
    # required relative imbalance improvement before migrating (hysteresis:
    # don't chase noise in the EMA)
    min_gain: float = 0.05
    # seconds after any placement change (commit or scale) before the next
    # evaluation — shared with the autoscaler
    cooldown: float = 0.05
    # decode steps observed before the first evaluation (EMA warm-up)
    min_observations: int = 4
    # read the host's live async-tier queue signals
    # (``host.queue_signals()``): when the tier is measurably backlogged,
    # ``min_gain`` is evaluated against a modelled queue-delay reduction —
    # the max server backlog now vs the balanced backlog the planned
    # placement would leave — instead of the routed-count imbalance alone.
    # Lockstep hosts (no tier) and an idle tier fall back to the count gate
    queue_aware: bool = True


@dataclass
class RebalanceController:
    """Periodic replan + incremental migration for one engine or
    cluster."""

    cfg: RebalanceConfig = field(default_factory=RebalanceConfig)
    # (server, red_slot, old_eid, new_eid) still to apply
    _pending: List[Tuple[int, int, int, int]] = field(default_factory=list)
    _target_digest: Optional[str] = None
    _last_eval: float = float("-inf")

    @property
    def migrating(self) -> bool:
        """A staged migration has chunks left to apply."""
        return bool(self._pending)

    def abort(self) -> None:
        """Drop the rest of a staged migration (pool resize replans
        wholesale; chunks already applied are consistent and stay)."""
        self._pending = []
        self._target_digest = None

    # ---------------------------------------------------------------- loop
    def step(self, engine) -> None:
        """One control iteration, called once per engine step.  Either
        applies the next migration chunk or (at most every ``interval``
        seconds) re-evaluates the plan."""
        pool = engine.pool
        if pool is None:
            return
        if self._pending:
            self._apply_chunk(engine)
            return
        t = engine.clock
        if t - self._last_eval < self.cfg.interval:
            return
        self._last_eval = t
        if pool.stats.updates < self.cfg.min_observations:
            return
        if t - engine.last_placement_change < self.cfg.cooldown:
            return
        self._evaluate(engine)

    def _queue_signals(self, engine):
        """The host's live async-tier queue signals, or None (lockstep
        hosts / queue-awareness off / no measurable backlog)."""
        if not self.cfg.queue_aware:
            return None
        probe = getattr(engine, "queue_signals", None)
        if probe is None:
            return None
        sig = probe()
        if not sig or sig["alive"] <= 0 or sig["max_backlog"] <= 1e-12:
            return None
        return sig

    def _evaluate(self, engine) -> None:
        pool = engine.pool
        mapping, red = pool.plan()
        digest = load_balance.plan_digest(mapping, pool.num_servers)
        if digest == pool.plan_digest:
            engine.metrics.rebalance_noops += 1
            return
        current = pool.current_imbalance()
        planned = load_balance.imbalance(
            pool.stats.ema, mapping, pool.num_servers,
            alive=pool.smap.alive, capacities=pool.capacities)
        sig = self._queue_signals(engine)
        if sig is not None:
            # queue-aware gate: migrate when the modeled queue-delay
            # reduction clears min_gain.  The measured delay is the max
            # server backlog now; the planned placement redistributes the
            # queued seconds with its residual imbalance, leaving
            # ``planned_imbalance × mean backlog`` on its hottest server.
            # Routed EMA still decides WHERE replicas go — the live
            # backlog decides WHETHER moving them is worth the copies.
            cur_delay = sig["max_backlog"]
            planned_delay = planned * (sig["total_backlog"] / sig["alive"])
            if cur_delay - planned_delay < self.cfg.min_gain * cur_delay:
                engine.metrics.rebalance_noops += 1
                return
        elif current - planned < self.cfg.min_gain * current:
            engine.metrics.rebalance_noops += 1
            return
        aligned, updates = load_balance.migration_updates(
            pool.redundant_table, red)
        if not updates:
            engine.metrics.rebalance_noops += 1
            return
        self._pending = updates
        self._target_digest = digest
        event = {"t": engine.clock, "event": "rebalance_plan",
                 "updates": len(updates),
                 "imbalance": round(current, 6),
                 "planned_imbalance": round(planned, 6)}
        if sig is not None:
            event["queue_delay"] = round(sig["max_backlog"], 6)
            event["planned_queue_delay"] = round(
                planned * (sig["total_backlog"] / sig["alive"]), 6)
        engine.metrics.events.append(event)

    # ----------------------------------------------------------- migration
    def _apply_chunk(self, engine) -> None:
        pool = engine.pool
        updates = self._pending[:self.cfg.chunk]
        self._pending = self._pending[self.cfg.chunk:]

        # break: stop routing to the slots being repurposed (their traffic
        # falls back to the primaries + remaining replicas within the step)
        for s, _, old_e, _ in updates:
            if old_e >= 0:
                pool.smap.drop_replica(old_e, s)

        # move: copy the incoming experts' weights into the freed slots
        moves = _slot_moves(pool, updates)
        copies = [m for m in moves if m[2] >= 0]
        engine.clk.start()
        if moves:
            engine.apply_migration(moves)
        dt = engine.clk.stop("migrate", tokens=len(copies),
                             servers=pool.num_servers)
        engine.charge_migration(dt)
        engine.metrics.migration_time += dt
        engine.metrics.migrated_experts += len(copies)

        # make: commit the placement now that the weights landed — the
        # local table is derived from the redundant table at the next
        # runtime() and the mapping registers the fresh replicas, so the
        # very next step routes to them
        for s, j, _, new_e in updates:
            pool.redundant_table[s, j] = new_e
            if new_e >= 0:
                pool.smap.register_replica(new_e, s)
        engine.metrics.events.append(
            {"t": engine.clock, "event": "migrate", "chunk": len(updates)})

        if not self._pending:
            engine.metrics.rebalances += 1
            engine.last_placement_change = engine.clock
            engine.metrics.events.append(
                {"t": engine.clock, "event": "rebalance_commit",
                 "digest": pool.plan_digest,
                 "converged": pool.plan_digest == self._target_digest})
            self._target_digest = None
