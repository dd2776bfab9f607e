"""Cluster front-end: N attention clients sharing one expert tier (the
reference's ``serving/cluster.py``).

A :class:`Cluster` owns

* ONE shared :class:`~repro_torch.core.elastic.ServerPool` — placement,
  liveness, traffic EMA, redundant replicas — that each client reads
  through its own :class:`~repro_torch.core.elastic.PoolClient` view;
* ONE weight bank: every client's executor holds the same ``params`` dict
  on the card (N private copies of the full-width weights would not fit).
  The port writes migrations and reshards in place, so the cluster writes
  the shared bank exactly once per migration chunk and per resize, through
  one executor; the others keep reading the same tensors;
* under ``exec_mode="async"``, ONE :class:`~repro_torch.serving.event_loop
  .AsyncExpertTier`: every client's micro-batches queue on the same lane
  frontiers;
* N :class:`~repro_torch.serving.engine.ServingEngine` clients, each with
  its own scheduler, executor (KV cache), clock and metrics;
* the placement control plane — the ONE
  :class:`~repro_torch.serving.rebalance.RebalanceController`, ``scale_to``
  and ``page_out_experts`` — and the attention tier's elasticity (drain,
  spawn, ``scale_clients``) with resource accounting;
* a :class:`~repro_torch.serving.frontend.FrontendRouter` with per-client
  admission backpressure over an ingress queue.

Time: each client advances its own clock; :meth:`step` steps the
most-behind alive client with work (ties to the lowest index), so the
interleaving is a function of the request trace, and a seeded trace at
N = 1 and N = 4 computes the same per-request tokens.

Fault model (client side): a client failure strands only its in-flight
requests (``metrics.failed_requests``); the tier and the other clients
keep serving.

Not ported: the reference's deprecated ``repro.serving.Engine`` alias.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional

from collections import deque

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.elastic import ServerPool
from repro_torch.serving.clock import Clock, WallClock
from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                        resolve_device)
from repro_torch.serving.event_loop import AsyncExpertTier
from repro_torch.serving.frontend import (FrontendRouter,
                                          make_frontend_router)
from repro_torch.serving.metrics import ClusterMetrics
from repro_torch.serving.rebalance import (RebalanceConfig,
                                           RebalanceController,
                                           oneshot_rebalance)
from repro_torch.serving.request import Request


@dataclass
class ClusterConfig:
    """Front-end shape + the per-client engine template."""

    clients: int = 1
    frontend_policy: str = "round_robin"
    # per-client admission backpressure: a client whose local queue holds
    # this many requests is closed to new routed work; requests wait in the
    # cluster ingress queue until somebody drains (0 = unbounded)
    max_client_queue: int = 0
    # stretch the expert share of decode steps by the number of clients
    # with live work (virtual clocks; the shared-tier contention charge).
    # Off by default: per-client timelines are then bit-identical to the
    # same engine running standalone.
    charge_contention: bool = False
    # attention-tier autoscaling ceiling: ``scale_clients`` may build NEW
    # engines (join empty at cluster time) up to this many total.  None =
    # the initial ``clients`` count — scale-up then only revives drained
    # clients, never builds an engine mid-run.
    max_clients: Optional[int] = None
    # the per-client engine template (mode must be eaas or monolithic_ep;
    # rebalance_interval > 0 enables the CLUSTER-level controller)
    engine: EngineConfig = field(default_factory=EngineConfig)


class Cluster:
    """N attention clients + one shared expert tier + a front-end router.

    The public entrypoints mirror the single-engine surface —
    ``submit`` / ``step`` / ``run`` / ``metrics`` plus the scenario control
    verbs — so :class:`~repro_torch.serving.scenario.Scenario` timelines
    replay against a cluster unchanged.  ``params`` is the weight bank
    (default: client 0's seeded init); ``device`` as the engine's.
    """

    def __init__(self, cfg: ModelConfig, ccfg: ClusterConfig,
                 seed: int = 0,
                 clock_factory: Optional[Callable[[], Clock]] = None,
                 params=None, device=None):
        if ccfg.clients < 1:
            raise ValueError(f"need at least one client, got {ccfg.clients}")
        ecfg = ccfg.engine
        if ecfg.mode not in ("eaas", "monolithic_ep"):
            raise ValueError(
                f"cluster clients share one expert tier — mode {ecfg.mode!r}"
                " is not disaggregated (use eaas or monolithic_ep)")
        if not cfg.moe:
            raise ValueError("Cluster serves MoE configs (the expert tier "
                             "is the shared resource)")
        self.cfg = cfg
        self.ccfg = ccfg
        clock_factory = clock_factory or WallClock
        # kept for lazily spawned clients (attention-tier scale-up past
        # the initial fleet)
        self._clock_factory = clock_factory
        self._seed = seed
        self.device = resolve_device(device)
        # ---- the ONE expert tier ----------------------------------------
        self.pool = ServerPool(
            cfg, ecfg.num_servers,
            tokens_per_client=(ecfg.pool_tokens_per_client
                               or ecfg.max_batch),
            n_redundant=(ecfg.n_redundant if ecfg.mode == "eaas" else 0),
            capacities=ecfg.server_capacities)
        # ---- the shared async tier (exec_mode="async") ------------------
        # ONE micro-batch queue set for the whole cluster: every client's
        # waves queue on the same per-server busy frontiers, so cross-
        # client expert contention emerges from queueing physically
        # (charge_contention's analytic stretch is not applied on top)
        self._tier: Optional[AsyncExpertTier] = None
        if ecfg.exec_mode == "async":
            self._tier = AsyncExpertTier(ecfg.num_servers,
                                         queue_mode=ecfg.queue_mode,
                                         lane_budget=ecfg.lane_budget)
        # ---- N clients over per-client mapping views --------------------
        # every client holds the one weight bank (``params``, or client 0's
        # seeded init): placement changes write it once for everyone
        self.clients: List[ServingEngine] = []
        for i in range(ccfg.clients):
            eng = ServingEngine(cfg, ecfg, params=params, seed=seed,
                                clock=clock_factory(), device=self.device,
                                pool=self.pool.client_view(i), client_id=i,
                                tier=self._tier)
            params = eng.executor.params
            self.clients.append(eng)
        self.client_alive = [True] * ccfg.clients
        # attention-tier elasticity state, orthogonal to the failure flag:
        # draining = stop admitting, finish in-flight work, then park;
        # parked = deprovisioned (not failed) — excluded from routing,
        # stepping and the cluster time base until a spawn revives it
        self.client_draining = [False] * ccfg.clients
        self.client_parked = [False] * ccfg.clients
        # ---- front-end --------------------------------------------------
        self.router: FrontendRouter = make_frontend_router(
            ccfg.frontend_policy, ccfg.clients,
            block_size=(ecfg.kv_block_size
                        if ecfg.kv_mode == "paged" else None))
        self.ingress: Deque[Request] = deque()
        # ---- control plane ----------------------------------------------
        self.clk = clock_factory()       # charges shared-tier migrations
        self.rebalancer: Optional[RebalanceController] = None
        if ecfg.rebalance_interval > 0 and ecfg.mode == "eaas":
            self.rebalancer = RebalanceController(RebalanceConfig(
                interval=ecfg.rebalance_interval,
                chunk=ecfg.rebalance_chunk,
                min_gain=ecfg.rebalance_min_gain,
                cooldown=ecfg.rebalance_cooldown,
                queue_aware=ecfg.rebalance_queue_aware))
            for eng in self.clients:
                # members surface the pool imbalance gauge the cluster's
                # controller plans from (their own rebalancer stays None)
                eng.track_imbalance = True
        self.last_placement_change = float("-inf")
        self.metrics = ClusterMetrics(
            per_client=[c.metrics for c in self.clients],
            routed=[0] * ccfg.clients)
        self.step_idx = 0
        # provisioned-resource accounting (the elasticity saving metric):
        # integrate active clients + servers x resident-expert fraction
        # over cluster time, change-points traced for windowed integrals
        self._res_t = 0.0
        self._res_units = self._provisioned_units()
        self.metrics.resource_trace.append((0.0, self._res_units))

    # ------------------------------------------------------------- time
    def _in_fleet(self, i: int) -> bool:
        """Alive and not parked — the clients that step, route and gate
        cluster time (a draining client is still in the fleet until its
        in-flight work finishes)."""
        return self.client_alive[i] and not self.client_parked[i]

    @property
    def clock(self) -> float:
        """The cluster time base: the most-behind in-fleet client (that is
        the next client to act).  With no survivors, the latest client
        time.  Parked clients are excluded — their clocks froze when they
        drained out and must not hold cluster time back."""
        alive = [c.clock for i, c in enumerate(self.clients)
                 if self._in_fleet(i)]
        if alive:
            return min(alive)
        return max((c.clock for c in self.clients), default=0.0)

    # ------------------------------------------------- engine-like surface
    @property
    def queue(self) -> List[Request]:
        """Every request not yet in a slot (ingress + client queues) — the
        scenario harness's busy signal."""
        out = list(self.ingress)
        for c in self.clients:
            out.extend(c.queue)
        return out

    @property
    def slots(self) -> List[Optional[Request]]:
        return [s for c in self.clients for s in c.slots]

    def pending_prefill_tokens(self) -> int:
        """Cluster-wide unprefilled backlog (ingress + every client) — the
        autoscaler's prefill-pressure signal."""
        pending = sum(c.pending_prefill_tokens() for c in self.clients)
        pending += sum(len(r.prompt) for r in self.ingress)
        return pending

    def kv_free_fraction(self) -> float:
        """The tightest client's free KV fraction — memory pressure on ANY
        client throttles what the cluster can admit there."""
        fracs = [c.kv_free_fraction()
                 for c, ok in zip(self.clients, self.client_alive) if ok]
        return min(fracs) if fracs else 1.0

    # ------------------------------------------------------------ ingress
    def submit(self, req: Request) -> None:
        if not any(self.client_alive):
            # no client will ever route this: fail fast, keep the
            # completed == total - failed invariant under continued traffic
            self.metrics.ingress_failed += 1
            self.metrics.failed_requests += 1
            return
        self.ingress.append(req)

    def _admissible(self) -> List:
        cap = self.ccfg.max_client_queue
        out = []
        for i, eng in enumerate(self.clients):
            if not self._in_fleet(i) or self.client_draining[i]:
                # draining clients stop admitting: they finish their
                # in-flight work and park (the elastic scale-down path)
                continue
            if cap > 0 and len(eng.queue) >= cap:
                continue
            out.append((i, eng))
        return out

    def _route_ingress(self) -> None:
        """Drain the ingress queue head-of-line through the router until
        nobody is admissible (per-client backpressure holds the rest)."""
        while self.ingress:
            candidates = self._admissible()
            if not candidates:
                return
            req = self.ingress.popleft()
            idx = self.router.pick(req, candidates)
            self.clients[idx].submit(req)
            self.metrics.routed[idx] += 1

    # --------------------------------------------------------------- step
    @staticmethod
    def _has_work(eng: ServingEngine) -> bool:
        return bool(eng.queue) or any(s is not None for s in eng.slots)

    def _next_client(self) -> Optional[int]:
        """The most-behind alive client WITH work (ties to the lowest
        index).  Clients with nothing to do never gate cluster time: they
        are fast-forwarded to the busy frontier instead of burning idle
        sweeps — under a wall clock this also absorbs per-client
        compile-time spikes without starving anyone.  When nobody has
        work, the most-behind client takes an idle step so time still
        advances toward the next scheduled arrival."""
        alive = [i for i in range(len(self.clients)) if self._in_fleet(i)]
        if not alive:
            return None
        busy = [i for i in alive if self._has_work(self.clients[i])]
        if not busy:
            return min(alive, key=lambda i: (self.clients[i].clock, i))
        frontier = min(self.clients[i].clock for i in busy)
        for i in alive:
            if i not in busy and self.clients[i].clock < frontier:
                self.clients[i].clock = frontier
        return min(busy, key=lambda i: (self.clients[i].clock, i))

    def _active_clients(self) -> int:
        """Clients with live work — the shared-tier contention factor."""
        n = sum(1 for i, eng in enumerate(self.clients)
                if self._in_fleet(i) and self._has_work(eng))
        return max(n, 1)

    def step(self) -> None:
        """One cluster iteration: route what the front-end can place, then
        advance the most-behind in-fleet client by one engine step."""
        self.step_idx += 1
        self._route_ingress()
        i = self._next_client()
        if i is None:
            return                       # every client is dead
        eng = self.clients[i]
        eng.expert_contention = (float(self._active_clients())
                                 if self.ccfg.charge_contention else 1.0)
        eng.step()
        if self.rebalancer is not None:
            # ONE controller for the shared tier: migration chunks
            # interleave with whichever client steps next
            self.rebalancer.step(self)
        self._retire_drained()
        self._account_resources()

    def has_work(self) -> bool:
        """Anything outstanding anywhere (ingress, queues, slots) — the
        cheap busy probe (no list materialization, early exit)."""
        return bool(self.ingress) or any(self._has_work(c)
                                         for c in self.clients)

    def run(self, max_steps: int = 10_000,
            on_step: Optional[Callable[["Cluster"], None]] = None
            ) -> ClusterMetrics:
        """Drive until ingress + client queues + slots drain."""
        while self.has_work() and self.step_idx < max_steps:
            if not any(self.client_alive):
                break                    # nobody left to serve the backlog
            if on_step:
                on_step(self)
            self.step()
        self._account_resources()
        self.metrics.wall_time = self.clock
        return self.metrics

    # --------------------------------------------- resource accounting
    def _provisioned_units(self) -> float:
        """Resource units currently provisioned: in-fleet attention
        clients (draining ones still hold their hardware) plus expert
        servers weighted by the resident (non-paged-out) expert fraction.
        The statically provisioned baseline holds this constant; the
        elasticity saving is one minus the ratio of the two integrals."""
        clients = sum(1 for i in range(len(self.clients))
                      if self._in_fleet(i))
        return float(clients
                     + self.pool.num_servers * self.pool.resident_fraction())

    def _account_resources(self) -> None:
        """Integrate provisioned resource-units up to cluster time and
        record a change-point whenever the provisioning level moved (the
        interval since the last accounting is charged at the PREVIOUS
        level — changes take effect from their change-point on)."""
        now = self.clock
        if now > self._res_t:
            self.metrics.resource_seconds += \
                (now - self._res_t) * self._res_units
            self._res_t = now
        units = self._provisioned_units()
        if units != self._res_units:
            self._res_units = units
            self.metrics.resource_trace.append((now, units))

    # --------------------------------------------- shared-tier control
    def _pool_event(self, event: str, **kw) -> None:
        self.metrics.events.append(dict({"t": self.clock, "event": event},
                                        **kw))

    def inject_server_failure(self, rank: int) -> None:
        """An EXPERT server dies: one shared liveness flip that every
        client's next step observes (the consistent-mask property).  In
        monolithic mode every client is one collective group — they all
        stall."""
        self._pool_event("server_fail", rank=rank,
                         mode=self.ccfg.engine.mode)
        if self.ccfg.engine.mode == "eaas":
            if rank < self.pool.num_servers:
                self.pool.server_failed(rank)
            if self._tier is not None:
                # shared tier: re-dispatch the dead server's queue once,
                # then fan each moved micro-batch's fresh completion event
                # to the client that owns it
                moved = self._tier.fail_server(rank, self.clock)
                for mb in moved:
                    self.clients[mb.client_id]._post_redispatch(mb)
                if moved:
                    self._pool_event("redispatch", rank=rank,
                                     count=len(moved))
                for eng in self.clients:
                    eng._reconcile_waves()
        else:
            for eng in self.clients:
                eng.halted_until = (eng.step_idx
                                    + self.ccfg.engine.restart_steps)

    def recover_server(self, rank: int) -> None:
        self._pool_event("server_recover", rank=rank)
        if rank < self.pool.num_servers:
            self.pool.server_recovered(rank)
        if self._tier is not None and rank < self._tier.num_servers:
            self._tier.recover_server(rank, self.clock)

    def set_server_speed(self, rank: int, factor: float) -> None:
        """Mark one expert server as a straggler (scenario
        ``slow_server``): every client's lockstep decode charge sees it;
        under async only that server's shared micro-batch queue slows."""
        if rank >= self.pool.num_servers:
            return
        if factor <= 0:
            raise ValueError(f"server speed factor must be > 0: {factor}")
        for eng in self.clients:
            if rank < len(eng.server_speed):
                eng.server_speed[rank] = float(factor)
        if self._tier is not None and rank < self._tier.num_servers:
            self._tier.set_slowdown(rank, factor)
        self._pool_event("slow_server", rank=rank, factor=float(factor))

    def set_skew(self, bias: np.ndarray) -> None:
        self.pool.set_route_bias(bias)
        bias = np.asarray(bias, np.float64)
        self._pool_event("set_skew",
                         spread=round(float(bias.max() - bias.min()), 6))

    def set_policy(self, policy: str) -> None:
        """Scheduler policy on every client (scenario ``set_policy``)."""
        for eng in self.clients:
            eng.scheduler.set_policy(policy)
        self._pool_event("set_policy", policy=policy)

    @property
    def params(self):
        """The one weight bank every client's executor reads."""
        return self.clients[0].executor.params

    def apply_migration(self, copies) -> None:
        """Apply one migration chunk to the shared bank, once: the copies
        land in place in the tensors every client reads (the reference
        fans the chunk out to each client's immutable copy; in place, a
        second write would be a second migration of the same slots)."""
        self.clients[0].executor.migrate_slots(copies)

    def charge_migration(self, dt: float) -> None:
        """The shared tier is busy copying weights: every alive client's
        next expert phase waits behind it.  (The caller accounts the
        ``migration_time`` metric.)  Under async the copy occupies the
        shared micro-batch queues instead — clients keep running
        attention/prefill and only their next dispatches queue behind the
        copy (migration interleaves with in-flight micro-batches)."""
        if self._tier is not None:
            self._tier.occupy_all(self.clock, dt)
            return
        for i, eng in enumerate(self.clients):
            if self.client_alive[i]:
                eng.clock += dt

    def queue_signals(self) -> Optional[Dict]:
        """Live queue signals of the SHARED async tier at cluster time —
        the cluster-level queue-aware rebalance gate reads this (None
        under lockstep)."""
        if self._tier is None:
            return None
        return self._tier.queue_signals(self.clock)

    def rebalance(self) -> None:
        """One-shot EPLB replan of the shared tier (scenario event)."""
        if self.rebalancer is not None:
            self.rebalancer.abort()
        oneshot_rebalance(self)

    def scale_to(self, n: int) -> None:
        """Elastically resize the shared expert tier: one pool replan, then
        every client's executor re-shards from the recovered global bank."""
        if n == self.pool.num_servers:
            return
        old = self.pool.num_servers
        if self.rebalancer is not None:
            self.rebalancer.abort()
        for eng in self.clients:
            eng._drain_async()           # quiesce in-flight waves first
        self.pool.scale_to(n)
        # reshard the shared bank once (a second in-place reshard of an
        # already resharded bank is wrong); every other executor adopts
        # its PoolClient view of the resized pool
        self.clients[0].executor.resize(self.clients[0].pool)
        for eng in self.clients:
            eng.executor.pool = eng.pool
            eng.server_speed = np.ones(n)
        if self._tier is not None:
            # reconcile the shared tier: work still queued on dropped
            # ranks re-dispatches to survivors, and each moved
            # micro-batch's fresh completion event is fanned to the
            # client that owns it (mirrors inject_server_failure)
            moved = self._tier.resize(n, self.clock)
            for mb in moved:
                self.clients[mb.client_id]._post_redispatch(mb)
            for eng in self.clients:
                eng._reconcile_waves()
            self._tier.reset_speeds()        # match the server_speed reset
        self.last_placement_change = self.clock
        self._pool_event("scale", **{"from": old, "to": n})

    # ------------------------------------------------- client fault model
    def _check_client(self, i: int) -> None:
        if not 0 <= i < len(self.clients):
            raise ValueError(f"no client {i}: this cluster has "
                             f"{len(self.clients)} clients")

    def fail_client(self, i: int) -> None:
        """An ATTENTION client dies.  Only its in-flight requests strand
        (queued + slotted — lost, counted as failed); the expert tier and
        the other clients never notice beyond the routed-traffic shift.
        If the LAST client dies, ingress-held requests strand too — a
        later ``recover_client`` starts from a clean slate, it does not
        resurrect dropped work."""
        self._check_client(i)
        if not self.client_alive[i]:
            return
        self.client_alive[i] = False
        self.client_draining[i] = False  # a dead client drains nothing
        stranded = self.clients[i].abort_inflight()
        if not any(self.client_alive) and self.ingress:
            # nobody left to route to: the front-end sheds its ingress
            # queue rather than silently losing it from the accounting
            self.metrics.ingress_failed += len(self.ingress)
            stranded.extend(self.ingress)
            self.ingress.clear()
        self.metrics.failed_requests += len(stranded)
        self._pool_event("client_fail", client=i, stranded=len(stranded))

    def recover_client(self, i: int) -> None:
        """The client rejoins empty (its KV state died with it) and
        fast-forwards to cluster time — it was not accumulating work while
        dead."""
        self._check_client(i)
        if self.client_alive[i]:
            return
        self.client_alive[i] = True
        now = self._fleet_frontier(default=self.clients[i].clock)
        self.clients[i].clock = max(self.clients[i].clock, now)
        self._pool_event("client_recover", client=i)

    # --------------------------------------------- attention-tier elastic
    def active_client_count(self) -> int:
        """Clients serving AND admitting (not draining) — what the
        autoscaler's client controller steers."""
        return sum(1 for i in range(len(self.clients))
                   if self._in_fleet(i) and not self.client_draining[i])

    def _fleet_frontier(self, default: float = 0.0) -> float:
        """The most-ahead in-fleet client's clock — where departing and
        joining clients fast-forward to (join empty at cluster time)."""
        return max((c.clock for i, c in enumerate(self.clients)
                    if self._in_fleet(i)), default=default)

    def _retire_drained(self) -> None:
        """Park any draining client whose in-flight work has finished —
        async waves complete through the normal event path (never
        cancelled, so a drain loses zero tokens)."""
        for i in range(len(self.clients)):
            if self.client_draining[i] and self._in_fleet(i) \
                    and not self._has_work(self.clients[i]):
                self._park_client(i)

    def _park_client(self, i: int) -> None:
        self.client_draining[i] = False
        self.client_parked[i] = True
        # fast-forward the departing client to the cluster frontier so a
        # later spawn rejoins at cluster time, never in the past
        self.clients[i].clock = max(self.clients[i].clock,
                                    self._fleet_frontier())
        self.metrics.client_drains += 1
        self._pool_event("client_drain", client=i)
        self._account_resources()

    def drain_client(self, i: int) -> bool:
        """Elastically scale the attention tier DOWN by one client: ``i``
        stops admitting immediately, finishes its queued requests and
        in-flight async waves (completion events keep firing — nothing is
        cancelled or stranded, unlike :meth:`fail_client`), then parks
        fast-forwarded to the cluster frontier.  The last active client
        never drains (someone must serve the ingress).  Returns whether
        the drain started."""
        self._check_client(i)
        if not self._in_fleet(i) or self.client_draining[i]:
            return False
        if self.active_client_count() <= 1:
            return False
        self.client_draining[i] = True
        self._pool_event("client_drain_begin", client=i)
        if not self._has_work(self.clients[i]):
            self._park_client(i)         # nothing in flight: park now
        return True

    def spawn_client(self) -> Optional[int]:
        """Elastically scale the attention tier UP by one client: revive
        the lowest-index parked client (it rejoins empty at cluster time),
        or build a fresh engine over the shared params/pool/tier when the
        fleet is still below ``max_clients``.  The front-end ring grows
        deterministically — existing clients keep their indices, the new
        index extends the ring.  Returns the client index, or None at the
        ceiling."""
        for i in range(len(self.clients)):
            if self.client_parked[i] and self.client_alive[i]:
                self.client_parked[i] = False
                self.client_draining[i] = False
                self.clients[i].clock = max(self.clients[i].clock,
                                            self._fleet_frontier())
                self.metrics.client_spawns += 1
                self._pool_event("client_spawn", client=i)
                self._account_resources()
                return i
        limit = self.ccfg.max_clients or self.ccfg.clients
        if len(self.clients) >= limit:
            return None
        i = len(self.clients)
        eng = ServingEngine(self.cfg, self.ccfg.engine, params=self.params,
                            seed=self._seed, clock=self._clock_factory(),
                            device=self.device,
                            pool=self.pool.client_view(i), client_id=i,
                            tier=self._tier)
        if self.rebalancer is not None:
            eng.track_imbalance = True
        eng.clock = self._fleet_frontier()
        # adopt the live straggler state (scenario slow_server events)
        if self.clients:
            eng.server_speed = self.clients[0].server_speed.copy()
        self.clients.append(eng)
        self.client_alive.append(True)
        self.client_draining.append(False)
        self.client_parked.append(False)
        self.metrics.per_client.append(eng.metrics)
        self.metrics.routed.append(0)
        self.router.n_clients = len(self.clients)
        self.metrics.client_spawns += 1
        self._pool_event("client_spawn", client=i, built=True)
        self._account_resources()
        return i

    def scale_clients(self, n: int) -> int:
        """Drive the active client count toward ``n`` (the autoscaler's
        attention-tier output): spawn parked/new clients to grow, drain
        the highest-index active clients to shrink.  Bounded below by one
        active client and above by ``max_clients``.  Any change stamps
        ``last_placement_change`` so client churn, migrations and expert
        page-ins coordinate through one cooldown.  Returns the active
        count after the action."""
        n = max(1, int(n))
        changed = False
        while self.active_client_count() < n:
            if self.spawn_client() is None:
                break
            changed = True
        active = [i for i in range(len(self.clients))
                  if self._in_fleet(i) and not self.client_draining[i]]
        for i in sorted(active, reverse=True)[:max(len(active) - n, 0)]:
            changed |= self.drain_client(i)
        if changed:
            self.last_placement_change = self.clock
        return self.active_client_count()

    def page_out_experts(self, experts) -> List[int]:
        """Scale-to-zero on the SHARED tier: evict cold experts' replica
        slots from the shared bank (the migration weight path, once).
        Experts with in-flight work on the shared tier's lanes are skipped
        this round — eviction waits for the lanes to drain.  Returns the
        experts actually paged out."""
        ready = [e for e in experts
                 if self._tier is None
                 or not self._tier.expert_in_flight(e)]
        paged, updates = self.pool.page_out_experts(ready)
        if updates:
            self.apply_migration(updates)
        if paged:
            self.last_placement_change = self.clock
            self.metrics.expert_page_outs += len(paged)
            self._pool_event("page_out", experts=len(paged))
            self._account_resources()
        return paged

    def set_frontend_policy(self, policy: str) -> None:
        """Swap the request-routing policy mid-run (fresh router state)."""
        self.router = make_frontend_router(
            policy, len(self.clients),
            block_size=(self.ccfg.engine.kv_block_size
                        if self.ccfg.engine.kv_mode == "paged" else None))
        self._pool_event("set_frontend_policy", policy=policy)

    # ----------------------------------------------------------- summary
    def summary(self) -> Dict:
        self.metrics.wall_time = self.clock
        return self.metrics.summary()
