"""Per-expert micro-batch queue lanes — the async expert tier's data plane
(the reference's ``serving/event_loop.py``, host code, the same in
behaviour to the bit).

The paper's disaggregation claim is that expert servers are independent
services: attention clients enqueue micro-batches and servers drain them
continuously, so one slow or busy server delays only the work routed to it
instead of barriering the whole step.  This module models that tier on the
host:

* :class:`MicroBatch` — one client wave's routed share on one server (one
  expert lane of it under ``queue_mode="expert"``): ``tokens`` of routed
  load, ``work`` seconds at speed 1, enqueue / start / finish times filled
  in by the queue simulation;
* :class:`ExpertLane` — one expert's FIFO on one server: its own
  ``busy_until`` frontier plus conservation counters;
* :class:`ServerQueue` — one expert server: ``budget`` work-conserving
  service streams draining its lanes, a ``slowdown`` factor (scenario
  ``slow_server``) and a liveness flag;
* :class:`AsyncExpertTier` — the shared tier: lane dispatch, lane-aware
  failure re-dispatch (a dead server's queued micro-batches move into the
  same expert's lane on the survivor with the earliest start: no token is
  lost), recovery and elastic resize that reconcile live lane state,
  migration occupancy, live queue signals for the rebalancer, and
  conservation counters (``enqueued == completed + cancelled +
  in_flight()`` at the tier and per lane).

The tier computes when modelled work finishes; it never touches tensors.
The engine computes values eagerly at dispatch (on the card, through the
same kernels as a lockstep step) and posts the finish times onto its
:class:`~repro_torch.serving.clock.EventTimeline`.  Under a cluster the tier
is shared: every client's micro-batches queue on the same lane frontiers.

``queue_mode="server"`` (or the per-server vector :meth:`AsyncExpertTier
.dispatch`) funnels a server's whole share through the aggregate lane
``expert=-1``.  Each micro-batch carries a ``generation`` bumped when it
moves servers; completion events of an old placement are stale
(:meth:`AsyncExpertTier.is_current`).  A server's ``slowdown`` applies to
micro-batches dispatched from then on; queued work keeps its committed
finish time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

#: lane key for a server's aggregate (non-expert-split) share — the legacy
#: per-server FIFO funnels through this lane
AGGREGATE_LANE = -1


@dataclass
class MicroBatch:
    """One wave's routed share on one expert server (modeled timing).

    ``expert`` keys the queue lane the share drains through:
    a real expert id under ``queue_mode="expert"``, or
    :data:`AGGREGATE_LANE` for a whole-server aggregate share."""

    mb_id: int
    client_id: int
    wave_id: int
    server: int
    tokens: float              # routed load share (diagnostic)
    work: float                # seconds of compute at slowdown 1.0
    enqueue_t: float
    expert: int = AGGREGATE_LANE
    start_t: float = 0.0
    finish_t: float = 0.0
    generation: int = 0        # bumped on failure re-dispatch
    done: bool = False
    cancelled: bool = False


@dataclass
class ExpertLane:
    """One expert's FIFO on one server: frontier + conservation counters.

    Per-lane conservation: ``enqueued == drained + cancelled + moved +
    in_flight()`` — ``moved`` counts departures to another server's lane
    on failure re-dispatch (the arrival increments the target lane's
    ``enqueued``), so summing ``in_flight()`` over every lane equals the
    tier's in-flight count."""

    server: int
    expert: int
    busy_until: float = 0.0
    enqueued: int = 0
    drained: int = 0
    cancelled: int = 0
    moved: int = 0             # re-dispatched away (failure/resize)

    def in_flight(self) -> int:
        return self.enqueued - self.drained - self.cancelled - self.moved


class ServerQueue:
    """One expert server: ``budget`` service streams draining expert lanes.

    ``budget=1`` is the classic single work-conserving FIFO (every lane
    shares one service stream, so service order equals dispatch order and
    timing is bit-identical to the pre-lane tier).  ``budget=B`` models B
    concurrent service streams (the per-server service-rate budget):
    micro-batches of *different* lanes overlap up to B-wide while each
    lane stays FIFO — a hot expert saturates one stream and its cold
    co-located neighbours keep flowing through the others."""

    def __init__(self, rank: int, budget: int = 1, slowdown: float = 1.0,
                 alive: bool = True, free_at: float = 0.0):
        if budget < 1:
            raise ValueError(f"service budget must be >= 1, got {budget}")
        self.rank = rank
        self.budget = budget
        self.slowdown = slowdown   # >1 = straggler (scenario slow_server)
        self.alive = alive
        # per-stream service frontiers (work-conserving: a micro-batch
        # takes the earliest-free stream, ties to the lowest index)
        self.streams: List[float] = [float(free_at)] * budget
        self.lanes: Dict[int, ExpertLane] = {}
        # server-level conservation mirror of the lane counters
        self.enqueued = 0
        self.drained = 0
        self.cancelled = 0
        self.moved = 0

    # ------------------------------------------------------------ frontier
    @property
    def busy_until(self) -> float:
        """Committed-work frontier: when the last service stream frees."""
        return max(self.streams)

    def free_at(self) -> float:
        """When the next service stream frees (earliest start for a
        lane with no backlog)."""
        return min(self.streams)

    def lane(self, expert: int) -> ExpertLane:
        ln = self.lanes.get(expert)
        if ln is None:
            ln = self.lanes[expert] = ExpertLane(self.rank, expert)
        return ln

    def eta(self, expert: int, now: float) -> float:
        """Earliest start a new micro-batch on ``expert``'s lane would
        get — the lane-aware re-dispatch target metric."""
        ln = self.lanes.get(expert)
        lane_t = ln.busy_until if ln is not None else 0.0
        return max(float(now), lane_t, self.free_at())

    def in_flight(self) -> int:
        return self.enqueued - self.drained - self.cancelled - self.moved

    # ------------------------------------------------------------- service
    def schedule(self, mb: MicroBatch, now: float) -> None:
        """Append ``mb`` to its expert's lane: it starts when both the
        lane's previous micro-batch and a service stream free up, and runs
        for ``work * slowdown`` seconds on that stream.

        Stream choice is best-fit: among the streams giving the earliest
        start, take the one freeing *latest* (least idle waste — a
        lane-FIFO-constrained micro-batch must not park the earliest
        stream, which stays open for other lanes), ties to the lowest
        index.  Deterministic, and identical to the single FIFO at
        budget=1."""
        ln = self.lane(mb.expert)
        now = float(now)
        best = 0
        best_start = max(now, ln.busy_until, self.streams[0])
        for j in range(1, self.budget):
            st = max(now, ln.busy_until, self.streams[j])
            if st < best_start or (st == best_start
                                   and self.streams[j] > self.streams[best]):
                best, best_start = j, st
        mb.server = self.rank
        mb.start_t = best_start
        mb.finish_t = mb.start_t + mb.work * self.slowdown
        ln.busy_until = mb.finish_t
        self.streams[best] = mb.finish_t
        ln.enqueued += 1
        self.enqueued += 1

    # ------------------------------------------------------------- control
    def clamp_down(self, now: float) -> None:
        """Pull every frontier back to ``now`` (server death: committed
        future work is void, the queues re-dispatch)."""
        now = float(now)
        self.streams = [min(s, now) for s in self.streams]
        for ln in self.lanes.values():
            ln.busy_until = min(ln.busy_until, now)

    def clamp_up(self, now: float) -> None:
        """Raise every frontier to at least ``now`` (recovery: a rejoined
        server serves from now, never from its stale past)."""
        now = float(now)
        self.streams = [max(s, now) for s in self.streams]
        for ln in self.lanes.values():
            ln.busy_until = max(ln.busy_until, now)

    def occupy(self, now: float, dt: float) -> None:
        """A migration weight-copy busies the whole server (every service
        stream) for ``dt``; in-flight lanes keep their committed times and
        the *next* dispatches queue behind the copy."""
        now, dt = float(now), float(dt)
        self.streams = [max(s, now) + dt for s in self.streams]


class AsyncExpertTier:
    """The shared micro-batch queue tier over ``num_servers`` servers.

    ``queue_mode="expert"`` (default) drains per-expert lanes;
    ``queue_mode="server"`` funnels everything through each server's
    aggregate lane (the pre-lane FIFO).  ``lane_budget`` is each server's
    service-stream count (see :class:`ServerQueue`)."""

    def __init__(self, num_servers: int, queue_mode: str = "expert",
                 lane_budget: int = 1):
        if queue_mode not in ("expert", "server"):
            raise ValueError(f"unknown queue_mode {queue_mode!r}; expected "
                             "'expert' or 'server'")
        if lane_budget < 1:
            raise ValueError(
                f"lane_budget must be >= 1, got {lane_budget}")
        self.queue_mode = queue_mode
        self.lane_budget = int(lane_budget)
        self.queues: List[ServerQueue] = [
            ServerQueue(s, budget=self.lane_budget)
            for s in range(num_servers)]
        # in-flight micro-batches only: retired (done/cancelled) entries
        # are pruned at retirement, so memory stays bounded by in-flight
        # work and the failure/cancel scans are O(in-flight), not
        # O(all-time micro-batches)
        self.mbs: Dict[int, MicroBatch] = {}
        self._next_id = 0
        self.enqueued = 0
        self.completed = 0
        self.cancelled = 0
        self.redispatched = 0
        self.migration_busy = 0.0          # seconds of migrate occupancy

    @property
    def num_servers(self) -> int:
        return len(self.queues)

    def in_flight(self) -> int:
        """Micro-batches dispatched but neither completed nor cancelled —
        the conservation counter (enqueued == completed + cancelled +
        in_flight)."""
        return self.enqueued - self.completed - self.cancelled

    def lanes(self) -> Iterator[ExpertLane]:
        """Every materialized lane on every server (conservation sweeps)."""
        for q in self.queues:
            for e in sorted(q.lanes):
                yield q.lanes[e]

    # ----------------------------------------------------------- dispatch
    def dispatch(self, client_id: int, wave_id: int, work: np.ndarray,
                 now: float, tokens: Optional[np.ndarray] = None
                 ) -> List[MicroBatch]:
        """Enqueue one wave through the legacy per-server vector API:
        ``work[s]`` seconds of expert compute on server ``s`` (zero
        entries skipped), each server's share funneled through its
        aggregate lane.  Returns the micro-batches with committed
        start/finish times."""
        work = np.asarray(work, np.float64)
        entries = []
        for s in range(min(len(work), self.num_servers)):
            w = float(work[s])
            if w <= 0.0:
                continue
            entries.append((s, AGGREGATE_LANE, w,
                            float(tokens[s]) if tokens is not None else w))
        return self.dispatch_lanes(client_id, wave_id, entries, now)

    def dispatch_lanes(self, client_id: int, wave_id: int,
                       entries: Iterable[Tuple], now: float
                       ) -> List[MicroBatch]:
        """Enqueue one wave as explicit ``(server, expert, work[, tokens])``
        lane shares, scheduled in iteration order (the engine emits them
        server-major, expert-ascending — deterministic).  Zero/negative
        work entries are skipped."""
        out: List[MicroBatch] = []
        for entry in entries:
            s, e, w = int(entry[0]), int(entry[1]), float(entry[2])
            tok = float(entry[3]) if len(entry) > 3 else w
            if w <= 0.0 or not 0 <= s < self.num_servers:
                continue
            mb = MicroBatch(
                mb_id=self._next_id, client_id=client_id, wave_id=wave_id,
                server=s, tokens=tok, work=w, enqueue_t=float(now),
                expert=e)
            self._next_id += 1
            self.queues[s].schedule(mb, now)
            self.mbs[mb.mb_id] = mb
            self.enqueued += 1
            out.append(mb)
        return out

    def is_current(self, mb_id: int, generation: int) -> bool:
        """True when a completion event for (mb_id, generation) is still
        valid — not re-dispatched since, not cancelled, not already done
        (retired entries are pruned, so a missing id is simply stale)."""
        mb = self.mbs.get(mb_id)
        return (mb is not None and not mb.cancelled and not mb.done
                and mb.generation == generation)

    def mark_done(self, mb: MicroBatch) -> None:
        mb.done = True
        q = self.queues[mb.server]
        q.drained += 1
        q.lane(mb.expert).drained += 1
        self.completed += 1
        # retire: any duplicate/stale-generation event still in a timeline
        # resolves to "not current" via the missing id
        self.mbs.pop(mb.mb_id, None)

    def _cancel_mb(self, mb: MicroBatch) -> None:
        mb.cancelled = True
        q = self.queues[mb.server]
        q.cancelled += 1
        q.lane(mb.expert).cancelled += 1
        self.cancelled += 1
        self.mbs.pop(mb.mb_id, None)

    # ------------------------------------------------------------- faults
    def _redispatch_from(self, rank: int, now: float,
                         pool: Optional[List[ServerQueue]] = None
                         ) -> List[MicroBatch]:
        """Move every unfinished micro-batch off ``rank`` (already marked
        dead/dropped) onto the alive queues in ``pool`` — lane-aware: each
        victim re-queues in the *same expert's* lane on the server giving
        it the earliest start (ties to the lowest rank).  FIFO order per
        source is preserved by the deterministic ``(start_t, mb_id)``
        victim sort.  With no survivors the work cancels explicitly."""
        pool = self.queues if pool is None else pool
        src = self.queues[rank]
        victims = sorted(
            (mb for mb in self.mbs.values()
             if mb.server == rank and not mb.done and not mb.cancelled),
            key=lambda m: (m.start_t, m.mb_id))
        moved: List[MicroBatch] = []
        for mb in victims:
            survivors = [t for t in pool if t.alive]
            if not survivors:
                # nobody can serve it: the wave will be completed by the
                # engine's degenerate path; count the loss explicitly and
                # retire the entry (engines see the missing id as
                # cancelled when reconciling their waves)
                self._cancel_mb(mb)
                continue
            target = min(survivors,
                         key=lambda t: (t.eta(mb.expert, now), t.rank))
            src.lane(mb.expert).moved += 1
            src.moved += 1
            mb.generation += 1
            target.schedule(mb, now)
            self.redispatched += 1
            moved.append(mb)
        return moved

    def fail_server(self, rank: int, now: float) -> List[MicroBatch]:
        """A server dies mid-drain: every unfinished micro-batch queued on
        it is re-dispatched into the same expert's lane on the surviving
        server with the earliest start (FIFO order preserved; no token
        loss).  Returns the moved micro-batches — the owning engines post
        fresh completion events from the new finish times (old events are
        stale by generation, and the engine cancels them outright)."""
        if rank >= self.num_servers:
            return []
        q = self.queues[rank]
        q.alive = False
        q.clamp_down(now)
        return self._redispatch_from(rank, now)

    def recover_server(self, rank: int, now: float) -> None:
        """A dead server rejoins: it serves from ``now`` — every stale
        stream/lane frontier left from before the failure is raised to
        ``now`` so no new micro-batch is scheduled into the server's dead
        past (the lane-aware reconcile the recovery tests pin)."""
        if rank >= self.num_servers:
            return
        q = self.queues[rank]
        q.alive = True
        q.clamp_up(now)

    def set_slowdown(self, rank: int, factor: float) -> None:
        """Scenario ``slow_server``: future micro-batches on ``rank`` run
        ``factor``× slower in every lane (already-queued work keeps its
        committed finish time).  ``factor=1.0`` restores full speed."""
        if rank >= self.num_servers:
            return
        if factor <= 0:
            raise ValueError(f"slowdown factor must be > 0, got {factor}")
        self.queues[rank].slowdown = float(factor)

    def reset_speeds(self) -> None:
        """Restore every server to full speed (elastic resize replans the
        pool wholesale — fresh pool, fresh speeds)."""
        for q in self.queues:
            q.slowdown = 1.0

    def cancel_client(self, client_id: int) -> int:
        """A client died: its in-flight micro-batches are abandoned (the
        servers finish the dispatched compute and discard the results —
        dispatched work cannot be clawed back, so the occupancy stays)."""
        n = 0
        for mb in list(self.mbs.values()):
            if mb.client_id == client_id and not mb.done \
                    and not mb.cancelled:
                self._cancel_mb(mb)
                n += 1
        return n

    # ----------------------------------------------------------- control
    def occupy_all(self, now: float, dt: float) -> None:
        """A migration chunk busies every alive server for ``dt`` (the
        weight copy lands on the servers, not the clients): in-flight
        micro-batches keep their committed times, the *next* dispatches
        queue behind the copy — migration interleaves with decoding
        instead of stalling the clients."""
        for q in self.queues:
            if q.alive:
                q.occupy(now, dt)
        self.migration_busy += float(dt)

    def resize(self, num_servers: int, now: float) -> List[MicroBatch]:
        """Elastic pool resize, *reconciling* live lane state instead of
        resetting it: surviving servers keep their committed stream/lane
        frontiers (and in-flight micro-batches); dropped ranks re-dispatch
        their unfinished work to the survivors exactly like a failure
        (cancelled outright when nothing survives); new ranks join free
        from ``now``.  Returns the moved micro-batches — the owning
        engines re-post their completion events.  Speed factors are NOT
        reset here; callers replanning the pool wholesale follow up with
        :meth:`reset_speeds` (engines normally quiesce via
        ``_drain_async`` first, so a mid-flight resize only matters under
        direct tier use — which this reconcile keeps conservation-safe)."""
        old_n = self.num_servers
        if num_servers == old_n:
            return []
        moved: List[MicroBatch] = []
        if num_servers < old_n:
            survivors = self.queues[:num_servers]
            dropped = self.queues[num_servers:]
            for q in dropped:
                q.alive = False
                q.clamp_down(now)
            for q in dropped:
                moved.extend(
                    self._redispatch_from(q.rank, now, pool=survivors))
            self.queues = survivors
        else:
            for r in range(old_n, num_servers):
                self.queues.append(ServerQueue(
                    r, budget=self.lane_budget, free_at=float(now)))
        return moved

    def expert_in_flight(self, expert: int) -> int:
        """In-flight micro-batches across every server's lane for
        ``expert`` — the scale-to-zero page-out gate: an expert only pages
        out of the tier once its lanes have fully drained (nonzero means
        the reconcile paths still owe it completions, so eviction waits a
        round)."""
        expert = int(expert)
        n = 0
        for q in self.queues:
            ln = q.lanes.get(expert)
            if ln is not None:
                n += ln.in_flight()
        return n

    # ----------------------------------------------------------- signals
    def queue_signals(self, now: float) -> Dict:
        """Live queueing-delay signals for the queue-aware rebalancer.

        Per alive server, the backlog is how far its committed-work
        frontier runs past ``now`` (seconds until fully idle — the delay a
        new aggregate dispatch would see at worst); per lane, the same for
        the lane frontier.  Dead servers report zero (nothing queues on
        them).  ``max_backlog`` is the measured worst-case queueing delay
        the rebalancer targets; ``total_backlog / alive`` is the balanced
        ideal it models migration against."""
        now = float(now)
        server_backlog: List[float] = []
        lane_backlog: Dict[Tuple[int, int], float] = {}
        lane_depth: Dict[Tuple[int, int], int] = {}
        for q in self.queues:
            if not q.alive:
                server_backlog.append(0.0)
                continue
            server_backlog.append(max(q.busy_until - now, 0.0))
            for e in sorted(q.lanes):
                ln = q.lanes[e]
                b = ln.busy_until - now
                if b > 0.0:
                    lane_backlog[(q.rank, e)] = b
                d = ln.in_flight()
                if d > 0:
                    lane_depth[(q.rank, e)] = d
        alive = sum(1 for q in self.queues if q.alive)
        return {
            "server_backlog": server_backlog,
            "max_backlog": max(server_backlog, default=0.0),
            "total_backlog": float(sum(server_backlog)),
            "alive": alive,
            "lane_backlog": lane_backlog,
            "lane_depth": lane_depth,
        }
