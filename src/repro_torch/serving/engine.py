"""Continuous-batching serving engine — the orchestration layer.

:class:`ServingEngine` wires :class:`~repro_torch.serving.scheduler
.Scheduler` -> :class:`~repro_torch.serving.executor.Executor` -> metrics
around a :class:`~repro_torch.serving.clock.Clock`.  One engine class
serves the three system modes (paper §5 baselines):

* ``mode="eaas"`` — EAAS: replicated experts, liveness-masked mapping; a
  server failure re-routes traffic to replicas within the same step
  (throughput dips only by the lost compute share — paper Fig. 10);
* ``mode="monolithic_ep"`` — DeepEP-style: primary-only mapping; a server
  failure halts the WHOLE engine for ``restart_steps`` (the collective
  group's restart) before resuming;
* ``mode="tp"`` — tensor-parallel MoE (one server holding every expert): a
  failure halts only one unit (a shorter stall, ``tp_restart_steps``), but
  per-unit weight replication caps the batch (``tp_batch_cap``).

A halted step produces no token and advances the engine's clock by the
last decode step's duration.  That is a charge, under ``WallClock`` too:
the engine does not sleep through a restart.

EAAS keeps the control plane over the expert tier:

* failover — a server failure is a liveness-mask update in the
  expert->server mapping, so the next step routes around the dead
  server's experts (to their replicas) without stopping;
* rebalancing — one-shot (``rebalance``) or live
  (``rebalance_interval > 0``: the
  :class:`~repro_torch.serving.rebalance.RebalanceController` migrates
  replica weights a chunk per step, in place);
* elasticity — ``scale_to`` reshards the expert weights for a new pool
  size, ``page_out_experts`` evicts cold experts' replicas (the first
  token routed back pays the clock's cold start); the
  :class:`~repro_torch.serving.autoscale.Autoscaler` drives both;
* traffic shaping (``set_skew``) and stragglers (``set_server_speed``).

Decode runs as one full-batch step (``decode_mode="lockstep"``) or as two
half-batch microbatches (``"pipelined"``, paper §4.2: on the card the
second microbatch runs on its own CUDA stream; ``"serialized"`` is the
ablation, chained on one stream).  The outputs are those of lockstep; the
``VirtualClock`` charges a pipelined step ``max(attention, expert) + eps``
instead of the sum.

The KV cache is either dense (per-slot buffers) or paged
(``kv_mode="paged"``: a shared block pool with prefix caching,
copy-on-write, memory-aware admission and preemption — every paged prefill
runs the chunk path; decode is lockstep only).  Prompts are prefilled
whole or in chunks of ``prefill_chunk`` tokens, interleaved with decode
steps by the scheduler's policy.

Execution modes (``exec_mode``): ``lockstep`` advances one synchronous step
at a time — every step waits for the full expert round trip.  ``async``
(the event-driven expert tier, under a ``VirtualClock`` only) computes each
step's values eagerly, through the same kernels, and posts their
completions on an :class:`~repro_torch.serving.clock.EventTimeline`: a
decode wave's expert share is dispatched as per-server (per-expert-lane)
micro-batches into the :class:`~repro_torch.serving.event_loop
.AsyncExpertTier` and lands when its last micro-batch drains, while the
client runs prefill chunks and up to ``async_depth`` waves in flight.  The
token streams are those of lockstep; only the (virtual) timing moves.

Under a :class:`~repro_torch.serving.cluster.Cluster` the engine is one
attention client of N: the cluster injects the shared pool (a
:class:`~repro_torch.core.elastic.PoolClient` view), the shared tier and
the weights, and owns the placement control plane.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.elastic import ServerPool
from repro_torch.core.load_balance import lane_loads
from repro_torch.core.monitor import Monitor
from repro_torch.models.transformer import build_model
from repro_torch.serving.clock import (Clock, Event, EventTimeline,
                                       VirtualClock, WallClock)
from repro_torch.serving.event_loop import AsyncExpertTier, MicroBatch
from repro_torch.serving.executor import Executor
from repro_torch.serving.kv_pool import BlockPool
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.rebalance import (RebalanceConfig,
                                           RebalanceController,
                                           oneshot_rebalance)
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import sample_batch
from repro_torch.serving.scheduler import (DecodeBatch, PrefillChunk,
                                           Scheduler, SchedulerConfig)

MODES = ("eaas", "monolithic_ep", "tp")


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 256
    mode: str = "eaas"                 # eaas | monolithic_ep | tp
    num_servers: int = 4
    n_redundant: int = 2
    restart_steps: int = 50            # monolithic group restart cost
    tp_restart_steps: int = 12         # one TP unit restart
    tp_batch_cap: Optional[int] = None  # TP: weight replication caps batch
    eos_token: Optional[int] = None
    # max prompt tokens per prefill step (0 = whole prompt in one step)
    prefill_chunk: int = 0
    policy: str = "prefill-priority"   # prefill-priority | fair | fcfs
    # lockstep (one full-batch step) | pipelined (two microbatches, the
    # second on its own stream on the card, §4.2) | serialized (the
    # ablation: the same split chained on one stream)
    decode_mode: str = "lockstep"
    # lockstep (synchronous steps) | async (the event-driven expert tier:
    # decode waves dispatch per-server micro-batches whose completions post
    # back through an event timeline; prefill overlaps in-flight expert
    # phases).  async needs mode="eaas" + MoE, kv_mode="dense",
    # decode_mode="lockstep" and a VirtualClock.
    exec_mode: str = "lockstep"
    # decode waves in flight under async: wave k+K dispatches on wave
    # k+K-1's eagerly sampled tokens before the elder combines land.  1 =
    # wave at a time (lockstep's cadence), 2 = the ping-pong double buffer
    async_depth: int = 2
    # async tier queueing: "expert" drains per-expert lanes (a hot expert
    # queues only in its own lane); "server" funnels each server's share
    # through one aggregate FIFO
    queue_mode: str = "expert"
    # service streams per server (lanes overlap up to this width)
    lane_budget: int = 1
    # the live controller reads the async tier's queue backlog: migrations
    # gate on a modelled queue-delay reduction (no-op under lockstep)
    rebalance_queue_aware: bool = True
    # dispatch-buffer sizing (tokens per client step); default max_batch.
    # A prefill step of P tokens drops tokens unless this is >= P.
    pool_tokens_per_client: Optional[int] = None
    # dense (per-slot (batch, max_seq) buffers) | paged (shared block pool
    # + per-request block tables, prefix caching, memory-aware admission
    # and preemption)
    kv_mode: str = "dense"
    kv_block_size: int = 16
    # pool size in blocks; default lets every slot reach max_seq.  Must
    # hold one maximal request (max_seq / kv_block_size blocks + scratch).
    kv_num_blocks: Optional[int] = None
    kv_prefix_cache: bool = True
    # feed chunked-prefill router traffic into the expert-load EMA (decode
    # steps always feed it)
    prefill_load_feedback: bool = True
    # --- live rebalancing ------------------------------------------------
    # seconds between live replan evaluations (0 = off: placement changes
    # only through rebalance() / scale_to())
    rebalance_interval: float = 0.0
    # expert-weight copies migrated per engine step once a replan is staged
    rebalance_chunk: int = 2
    # relative imbalance improvement required before migrating (hysteresis)
    rebalance_min_gain: float = 0.05
    # post-placement-change quiet period, shared with the autoscaler
    rebalance_cooldown: float = 0.05
    # charge decode steps for hot-expert skew: the virtual step's expert
    # share stretches by the pool's max/mean alive-server load
    charge_imbalance: bool = False
    # relative per-server capacity weights ((num_servers,) or None)
    server_capacities: Optional[np.ndarray] = None


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port serves on the GPU — pass device='cpu' "
            "to run the kernels' plain versions on the CPU")
    return torch.device("cuda")


def _check_async(cfg: ModelConfig, ecfg: EngineConfig, clk: Clock) -> None:
    """The reference's validation of ``exec_mode`` and the async knobs."""
    if ecfg.exec_mode not in ("lockstep", "async"):
        raise ValueError(f"unknown exec_mode {ecfg.exec_mode!r}; expected "
                         "'lockstep' or 'async'")
    if ecfg.exec_mode != "async":
        return
    if ecfg.mode != "eaas" or not cfg.moe:
        raise ValueError("exec_mode='async' models the EAAS expert tier — "
                         "it needs mode='eaas' and an MoE config")
    if ecfg.kv_mode != "dense":
        raise ValueError("exec_mode='async' supports kv_mode='dense' only "
                         "(paged preemption is defined against the "
                         "lockstep step loop)")
    if ecfg.decode_mode != "lockstep":
        raise ValueError("exec_mode='async' overlaps at the wave level — "
                         "decode_mode must stay 'lockstep'")
    if not isinstance(clk, VirtualClock):
        raise ValueError("exec_mode='async' needs a VirtualClock: the event "
                         "timeline is a deterministic modelled-cost "
                         "timeline")
    if (not isinstance(ecfg.async_depth, (int, np.integer))
            or ecfg.async_depth < 1):
        raise ValueError(f"async_depth must be an integer >= 1, got "
                         f"{ecfg.async_depth!r}")
    if ecfg.queue_mode not in ("expert", "server"):
        raise ValueError(f"unknown queue_mode {ecfg.queue_mode!r}; "
                         "expected 'expert' or 'server'")
    if ecfg.lane_budget < 1:
        raise ValueError(f"lane_budget must be >= 1, got "
                         f"{ecfg.lane_budget}")


_CLUSTER_MEMBER = ("this engine is a cluster client over a shared expert "
                   "tier — call Cluster.{}() so the shared weights change "
                   "once, for every client")


class ServingEngine:
    """Scheduler -> executor -> metrics orchestrator: EAAS with failover,
    or one of the paper's monolithic baselines.

    Standalone it is one complete serving system; under a cluster it is
    one attention client: ``pool`` (a per-client view of the shared
    pool), ``tier`` (the shared async tier) and ``params`` (the one weight
    bank) are injected, and the cluster owns placement changes."""

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 params=None, seed: int = 0, clock: Optional[Clock] = None,
                 device=None, pool=None, client_id: int = 0, tier=None):
        if engine_cfg.mode not in MODES:
            raise ValueError(f"unknown mode {engine_cfg.mode!r}; expected "
                             f"one of {MODES}")
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.client_id = client_id
        self.device = resolve_device(device)
        self.clk = clock if clock is not None else WallClock()
        _check_async(cfg, engine_cfg, self.clk)
        eaas = engine_cfg.mode == "eaas"
        S = engine_cfg.num_servers if engine_cfg.mode != "tp" else 1
        # an injected pool makes this engine a cluster member: placement
        # changes are the cluster's (a local one would reshard the shared
        # weights behind the sibling clients)
        self._shared_pool = pool is not None
        self.pool = None
        if self._shared_pool:
            if not cfg.moe:
                raise ValueError("shared expert pool needs an MoE config")
            if engine_cfg.mode == "tp":
                raise ValueError("tp mode replicates expert weights per "
                                 "unit — it has no shared expert tier")
            self.pool = pool
            S = pool.num_servers
        elif cfg.moe:
            self.pool = ServerPool(
                cfg, S,
                tokens_per_client=(engine_cfg.pool_tokens_per_client
                                   or engine_cfg.max_batch),
                n_redundant=engine_cfg.n_redundant if eaas else 0,
                capacities=engine_cfg.server_capacities)
        self.model = build_model(
            cfg, S, self.pool.redundant_table if self.pool else None,
            self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init_params(gen)
        self.monitor = Monitor(heartbeat_timeout=3.0)
        if self.pool:
            self.monitor.subscribe_server_down(self.pool.server_failed)
        self.kv_pool: Optional[BlockPool] = None
        if engine_cfg.kv_mode == "paged":
            bs = engine_cfg.kv_block_size
            if engine_cfg.max_seq % bs:
                raise ValueError(f"max_seq={engine_cfg.max_seq} must be a "
                                 f"multiple of kv_block_size={bs}")
            per_seq = engine_cfg.max_seq // bs
            nb = (engine_cfg.kv_num_blocks
                  if engine_cfg.kv_num_blocks is not None
                  else engine_cfg.max_batch * per_seq + 1)
            if nb - 1 < per_seq:
                raise ValueError(
                    f"kv_num_blocks={nb} cannot hold one maximal request "
                    f"({per_seq} blocks + 1 scratch) — preemption could "
                    "not keep the engine live")
            self.kv_pool = BlockPool(
                nb, bs, enable_prefix_cache=engine_cfg.kv_prefix_cache)
        self.executor = Executor(
            self.model, params, self.pool, max_batch=engine_cfg.max_batch,
            max_seq=engine_cfg.max_seq, device=self.device,
            decode_mode=engine_cfg.decode_mode, kv_mode=engine_cfg.kv_mode,
            kv_block_size=engine_cfg.kv_block_size,
            kv_num_blocks=self.kv_pool.num_blocks if self.kv_pool else 0)
        self.scheduler = Scheduler(SchedulerConfig(
            max_batch=engine_cfg.max_batch,
            prefill_chunk=engine_cfg.prefill_chunk, policy=engine_cfg.policy,
            batch_cap=(engine_cfg.tp_batch_cap
                       if engine_cfg.mode == "tp" else None),
            max_seq=engine_cfg.max_seq), kv_pool=self.kv_pool)
        self.metrics = ServingMetrics()
        self.step_idx = 0
        self.clock = 0.0
        # monolithic / tp restart: steps up to this index are halted, each
        # charged the last decode step's duration
        self.halted_until = -1
        self._last_decode_time = 0.01
        # per-server straggler factors (scenario slow_server): a lockstep
        # decode step is charged the slowest alive server's factor
        self.server_speed = np.ones(self._pool_size())
        # --- async exec state ---------------------------------------------
        self.timeline = EventTimeline()
        self.tier: Optional[AsyncExpertTier] = None
        self._client_free_at = 0.0       # attention client busy until
        # in-flight decode waves in dispatch order (they retire in order:
        # combine is in-order)
        self._waves: Deque[dict] = deque()
        self._wave_counter = 0
        # pending mb_done events by micro-batch id: a superseded event
        # (re-dispatch, reconcile) is cancelled on the timeline outright
        self._mb_events: dict = {}
        # slots whose prefill chunk ran but whose completion has not fired
        self._prefill_inflight: set = set()
        if engine_cfg.exec_mode == "async":
            # a cluster injects the shared tier; standalone owns its own
            self.tier = tier if tier is not None else AsyncExpertTier(
                S, queue_mode=engine_cfg.queue_mode,
                lane_budget=engine_cfg.lane_budget)
        # attention clients sharing the expert tier (set by the cluster
        # before each member step; 1.0 standalone)
        self.expert_contention = 1.0
        # shared placement cooldown (rebalance commits, resizes, page-outs)
        self.last_placement_change = float("-inf")
        self.rebalancer: Optional[RebalanceController] = None
        if (engine_cfg.rebalance_interval > 0 and self.pool is not None
                and not self._shared_pool and eaas):
            self.rebalancer = RebalanceController(RebalanceConfig(
                interval=engine_cfg.rebalance_interval,
                chunk=engine_cfg.rebalance_chunk,
                min_gain=engine_cfg.rebalance_min_gain,
                cooldown=engine_cfg.rebalance_cooldown,
                queue_aware=engine_cfg.rebalance_queue_aware))
        # compute the imbalance gauge each decode step (it walks the
        # mapping in Python): only when a controller reads it (the cluster
        # sets it on its members when its own controller is live)
        self.track_imbalance = self.rebalancer is not None

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def slots(self):
        return self.scheduler.slots

    @property
    def params(self):
        return self.executor.params

    def _alive_frac(self) -> float:
        """Alive share of the expert-server pool (EAAS failover slowdown)."""
        if self.pool is None or self.ecfg.mode != "eaas":
            return 1.0
        return float(self.pool.smap.alive.mean())

    def _pool_size(self) -> int:
        return self.pool.num_servers if self.pool else 1

    def _alive_mask(self) -> np.ndarray:
        """This client's view of server liveness ((S,) bool)."""
        if self.pool is None:
            return np.ones(1, bool)
        if hasattr(self.pool, "alive_mask"):
            return np.asarray(self.pool.alive_mask(), bool)
        return np.asarray(self.pool.smap.alive, bool)

    def _straggle(self) -> float:
        """Slowdown factor of the slowest *alive* expert server — a
        lockstep expert phase finishes with its slowest server."""
        if self.pool is None or self.ecfg.mode != "eaas":
            return 1.0
        alive = self._alive_mask()
        n = min(len(alive), len(self.server_speed))
        sp = self.server_speed[:n][alive[:n]]
        return float(sp.max()) if sp.size else 1.0

    # ------------------------------------------- front-end and autoscaler
    def pending_prefill_tokens(self) -> int:
        """Unprefilled prompt tokens (queued + mid-chunk)."""
        return self.scheduler.pending_prefill_tokens()

    def kv_free_fraction(self) -> float:
        return self.scheduler.kv_free_fraction()

    def queue_signals(self) -> Optional[dict]:
        """The async tier's live queue signals at the engine clock (what
        the queue-aware rebalance gate reads); None under lockstep."""
        if self.tier is None:
            return None
        return self.tier.queue_signals(self.clock)

    def free_kv_tokens(self) -> int:
        """Token capacity this client can still admit into: free pool
        blocks (paged) or free slots x max_seq (dense) — the memory half of
        the least-loaded routing score."""
        if self.kv_pool is not None:
            return self.kv_pool.available() * self.kv_pool.block_size
        free_slots = sum(1 for s in self.slots if s is None)
        return free_slots * self.ecfg.max_seq

    def abort_inflight(self) -> list:
        """Drop every queued and in-flight request (client failure): slots
        and KV blocks are released, nothing is re-queued.  Returns the
        stranded requests.  Under async only this client's micro-batches
        leave the shared tier (the servers finish what was dispatched and
        discard it); sibling clients' queues are untouched."""
        stranded = list(self.scheduler.queue)
        self.scheduler.queue.clear()
        for b, r in enumerate(self.scheduler.slots):
            if r is not None:
                stranded.append(r)
                self.scheduler.release(b)
        self.executor._staging.clear()
        if self.ecfg.exec_mode == "async":
            self.tier.cancel_client(self.client_id)
            self.timeline.clear_pending()
            self._waves.clear()
            self._mb_events.clear()
            self._prefill_inflight.clear()
            self._client_free_at = self.clock
        return stranded

    # ------------------------------------------------------------- control
    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)
        self.metrics.total_requests += 1

    def set_policy(self, policy: str) -> None:
        """Switch the scheduler policy mid-run (scenario ``set_policy``)."""
        self.scheduler.set_policy(policy)
        self.metrics.events.append(
            {"t": self.clock, "event": "set_policy", "policy": policy})

    def inject_server_failure(self, rank: int) -> None:
        """Simulated hardware failure of one expert server (paper §5.4):
        EAAS updates the mapping mask only; monolithic EP halts the engine
        for ``restart_steps``, TP for ``tp_restart_steps`` (the pool is
        left alone: neither mode consults liveness)."""
        self.metrics.events.append(
            {"t": self.clock, "event": "server_fail", "rank": rank,
             "mode": self.ecfg.mode})
        if self.ecfg.mode == "eaas":
            if self.pool and rank < self.pool.num_servers:
                self.pool.server_failed(rank)
            if self.tier is not None:
                # the dead server's queued micro-batches move to survivors:
                # fresh completion events from their new finish times
                moved = self.tier.fail_server(rank, self.clock)
                for mb in moved:
                    self._post_redispatch(mb)
                if moved:
                    self.metrics.events.append(
                        {"t": self.clock, "event": "redispatch",
                         "rank": rank, "count": len(moved)})
                self._reconcile_waves()
        elif self.ecfg.mode == "monolithic_ep":
            self.halted_until = self.step_idx + self.ecfg.restart_steps
        else:
            self.halted_until = self.step_idx + self.ecfg.tp_restart_steps

    def recover_server(self, rank: int) -> None:
        self.metrics.events.append(
            {"t": self.clock, "event": "server_recover", "rank": rank})
        if self.pool and rank < self.pool.num_servers:
            self.pool.server_recovered(rank)
        if self.tier is not None and rank < self.tier.num_servers:
            self.tier.recover_server(rank, self.clock)

    def set_server_speed(self, rank: int, factor: float) -> None:
        """Mark expert server ``rank`` as ``factor``x slower (scenario
        ``slow_server``; 1.0 restores it): every lockstep decode step is
        charged the slowest alive server's factor; the async tier slows
        only that server's micro-batch queue."""
        if self.pool is None or rank >= len(self.server_speed):
            return
        if factor <= 0:
            raise ValueError(f"server speed factor must be > 0: {factor}")
        self.server_speed[rank] = float(factor)
        if self.tier is not None and rank < self.tier.num_servers:
            self.tier.set_slowdown(rank, factor)
        self.metrics.events.append(
            {"t": self.clock, "event": "slow_server", "rank": rank,
             "factor": float(factor)})

    def apply_migration(self, copies) -> None:
        """Apply one expert-weight migration chunk to the executor's
        weights, in place."""
        self.executor.migrate_slots(copies)

    def charge_migration(self, dt: float) -> None:
        """A migration chunk stalls the lockstep engine: advance the
        clock.  Under async the copy occupies the expert tier instead: the
        next dispatches queue behind it while the client keeps running."""
        if self.tier is not None:
            self.tier.occupy_all(self.clock, dt)
            return
        self.clock += dt

    def page_out_experts(self, experts) -> list:
        """Scale-to-zero: page cold experts out of the expert tier (their
        replica slots are zeroed through the migration path; the mapping
        keeps the primary as the page-in source).  The first token later
        routed to one pages it back in at the clock's ``cold_start_base``.
        Returns the experts paged out."""
        if self.pool is None:
            return []
        if self._shared_pool:
            raise RuntimeError(_CLUSTER_MEMBER.format("page_out_experts"))
        # an expert with work in flight on its tier lanes waits a round
        ready = [e for e in experts
                 if self.tier is None or not self.tier.expert_in_flight(e)]
        paged, updates = self.pool.page_out_experts(ready)
        if updates:
            self.apply_migration(updates)
        if paged:
            self.last_placement_change = self.clock
            self.metrics.expert_page_outs += len(paged)
            self.metrics.events.append(
                {"t": self.clock, "event": "page_out",
                 "experts": len(paged)})
        return paged

    def _charge_cold_starts(self, load: np.ndarray) -> float:
        """Page in every cold expert this step's routed load touched;
        return the stall (``cold_start`` on the clock).  Values never
        depend on residency — the primary stayed addressable, so the
        tokens already computed exactly; only time passes here."""
        pool = self.pool
        if not pool.cold:
            return 0.0
        hits = sorted(e for e in pool.cold
                      if e < load.shape[0] and load[e] > 0)
        if not hits:
            return 0.0
        for e in hits:
            pool.page_in_expert(e, self.clock)
        self.clk.start()
        dt = self.clk.stop("cold_start", tokens=len(hits))
        self.metrics.cold_starts += len(hits)
        self.metrics.cold_start_time += dt
        self.metrics.events.append(
            {"t": self.clock, "event": "cold_start", "experts": len(hits),
             "dt": dt})
        return dt

    def rebalance(self) -> None:
        """One-shot EPLB replica re-planning from live traffic (paper
        §4.5): a placement-identical plan is a no-op; a changed one
        migrates the replica weights and the mapping in one step (charged
        as one ``migrate``)."""
        if self.pool is None:
            return
        if self._shared_pool:
            raise RuntimeError(_CLUSTER_MEMBER.format("rebalance"))
        if self.rebalancer is not None:
            self.rebalancer.abort()      # the one-shot replan supersedes it
        oneshot_rebalance(self)

    def set_skew(self, bias: np.ndarray) -> None:
        """Install a router-logit bias (scenario ``set_skew``): runtime
        data, read at the next step."""
        if self.pool is None:
            return
        self.pool.set_route_bias(bias)
        bias = np.asarray(bias, np.float64)
        self.metrics.events.append(
            {"t": self.clock, "event": "set_skew",
             "spread": round(float(bias.max() - bias.min()), 6)})

    def scale_to(self, n: int) -> None:
        """Resize the expert-server pool to ``n`` servers (paper §5.3): the
        pool re-plans (liveness kept), the executor reshards the expert
        weights in place, in-flight requests keep their KV cache."""
        if self.pool is None or n == self.pool.num_servers:
            return
        if self._shared_pool:
            raise RuntimeError(_CLUSTER_MEMBER.format("scale_to"))
        old = self.pool.num_servers
        if self.rebalancer is not None:
            self.rebalancer.abort()      # a resize replans placement anyway
        self._drain_async()              # quiesce in-flight waves first
        self.pool.scale_to(n)
        self.executor.resize(self.pool)
        self.server_speed = np.ones(n)   # fresh pool, fresh speeds
        if self.tier is not None:
            # quiesced, so nothing is in flight; the reconcile holds anyway
            for mb in self.tier.resize(n, self.clock):
                self._post_redispatch(mb)
            self._reconcile_waves()
            self.tier.reset_speeds()     # match the server_speed reset
        self.last_placement_change = self.clock
        self.metrics.events.append(
            {"t": self.clock, "event": "scale", "from": old, "to": n})

    # ---------------------------------------------------------------- step
    def step(self) -> None:
        """Run whatever the scheduler plans next: a prefill chunk, a decode
        step over the ready slots, or idle."""
        self.step_idx += 1
        if self.step_idx <= self.halted_until:
            # monolithic / tp restart: time passes, no tokens are produced
            self.clock += self._last_decode_time
            self.metrics.timeline.append(
                {"t": self.clock, "tokens": 0, "halted": True})
            return
        if self.ecfg.exec_mode == "async":
            self._step_async()
        else:
            plan = self.scheduler.next_plan()
            if isinstance(plan, PrefillChunk):
                self._step_prefill(plan)
            elif isinstance(plan, DecodeBatch):
                self._step_decode(plan)
            else:
                self.clock += self.clk.idle()
        if self.rebalancer is not None:
            # migration chunks interleave with decode steps (paper §4.5)
            self.rebalancer.step(self)
        if self.kv_pool is not None:
            self.metrics.observe_kv(self.kv_pool, self.scheduler.preemptions)

    @staticmethod
    def _sample_on_device(logits: torch.Tensor, reqs, steps) -> torch.Tensor:
        return sample_batch(logits, [r.sampling.temperature for r in reqs],
                            [r.sampling.seed for r in reqs],
                            [r.request_id for r in reqs], steps)

    def _sample(self, logits: torch.Tensor, reqs, steps) -> np.ndarray:
        return self._sample_on_device(logits, reqs, steps).cpu().numpy()

    def _step_prefill(self, plan: PrefillChunk) -> None:
        req, b = plan.request, plan.slot
        self.clk.start()
        expert_load = None
        if self.kv_pool is not None:
            # paged: every prefill runs the chunk path against the pool;
            # pending copy-on-write forks land first, on every layer
            self.executor.copy_blocks(plan.copies)
            logits, expert_load = self.executor.prefill_chunk_paged(
                plan.tokens, plan.start, self.scheduler.block_tables[b])
        elif plan.is_first and plan.is_last:
            logits = self.executor.prefill(b, plan.tokens)
        else:
            logits, expert_load = self.executor.prefill_chunk(
                b, plan.tokens, plan.start, is_first=plan.is_first,
                is_last=plan.is_last)
        load = (expert_load.cpu().numpy()
                if expert_load is not None and self.pool is not None
                else None)
        if load is not None and self.ecfg.prefill_load_feedback:
            self.pool.observe_load(load)
        self.clock += self.clk.stop("prefill", result=logits,
                                    tokens=plan.length,
                                    servers=self._pool_size(),
                                    alive_frac=self._alive_frac())
        if load is not None:
            self.clock += self._charge_cold_starts(load)
        self.scheduler.prefill_advanced(b, plan.length)
        if plan.is_last and not req.output_tokens:
            # a resumed (preempted) request already holds its next input
            # token: its recompute prefill samples nothing, charges no TTFT
            req.output_tokens.append(int(self._sample(logits, [req],
                                                      [0])[0]))
            req.prefill_time = self.clock
            self.metrics.ttfts.append(self.clock - req.arrival_time)
            self.metrics.events.append(
                {"t": self.clock, "event": "prefill", "rid": req.request_id,
                 "ttft": self.clock - req.arrival_time})

    def _step_decode(self, plan: DecodeBatch) -> None:
        sch = self.scheduler
        B = len(sch.slots)
        active = list(plan.slots)
        tokens = np.zeros((B, 1), np.int64)
        for b in active:
            tokens[b, 0] = sch.slots[b].output_tokens[-1]
        self.clk.start()
        if self.kv_pool is not None:
            logits, expert_load = self.executor.decode_paged(
                tokens, sch.block_tables, sch.cache_lengths())
        else:
            logits, expert_load = self.executor.decode(tokens)
        imbalance = 1.0
        if self.pool is not None:
            # this step's traffic first, so the imbalance charged (and
            # surfaced) reflects it
            load = expert_load.cpu().numpy()
            self.pool.observe_load(load)
            if self.ecfg.charge_imbalance or self.track_imbalance:
                imbalance = self.pool.current_imbalance()
                self.metrics.observe_balance(imbalance)
        dt = self.clk.stop("decode", result=logits, tokens=len(active),
                           servers=self._pool_size(),
                           alive_frac=self._alive_frac(),
                           overlap=(self.ecfg.decode_mode == "pipelined"),
                           imbalance=(imbalance if self.ecfg.charge_imbalance
                                      else 1.0),
                           contention=self.expert_contention,
                           straggle=self._straggle())
        self._last_decode_time = dt
        self.clock += dt
        if self.pool is not None:
            self.clock += self._charge_cold_starts(load)
        reqs = [sch.slots[b] for b in active]
        next_tokens = self._sample(logits[active], reqs,
                                   [len(r.output_tokens) for r in reqs])
        for b, r, tok in zip(active, reqs, next_tokens):
            tok = int(tok)
            r.output_tokens.append(tok)
            r.token_times.append(self.clock)
            self.metrics.total_output_tokens += 1
            done = (len(r.output_tokens) >= r.sampling.max_new_tokens or
                    (self.ecfg.eos_token is not None and
                     tok == self.ecfg.eos_token) or
                    len(r.prompt) + len(r.output_tokens) >=
                    self.ecfg.max_seq - 1)
            if done:
                r.finish_time = self.clock
                self.metrics.completed += 1
                self.metrics.itls.extend(r.itl())
                sch.release(b)
        self.metrics.timeline.append(
            {"t": self.clock, "tokens": len(active), "halted": False})

    # --------------------------------------------------------- async steps
    def _step_async(self) -> None:
        """One event-driven iteration.  If the attention client is free,
        plan eagerly: a prefill chunk runs now (overlapping any in-flight
        wave's expert phase), and a decode wave dispatches its expert share
        into the tier while fewer than ``async_depth`` waves are in flight.
        Otherwise advance the clock to the earlier of the next timeline
        event and the client's busy-until, handling the event if it comes
        first."""
        if self.clock >= self._client_free_at:
            plan = self.scheduler.next_plan()
            # a chunk whose predecessor's completion is still pending (an
            # earlier event at the same instant fired first) is not run
            # again: that completion fires next.  The reference runs it
            # twice and fails on the second completion (ROADMAP Queue 3)
            if isinstance(plan, PrefillChunk) \
                    and plan.slot not in self._prefill_inflight:
                self._async_prefill(plan)
                return
            if (isinstance(plan, DecodeBatch)
                    and len(self._waves) < self.ecfg.async_depth
                    and self._async_decode(plan)):
                return
        ev_t = self.timeline.peek_time()
        free_t = (self._client_free_at
                  if self._client_free_at > self.clock else None)
        if ev_t is not None and (free_t is None or ev_t <= free_t):
            ev = self.timeline.pop()
            self.clock = max(self.clock, ev.time)
            self._handle_event(ev)
        elif free_t is not None:
            self.clock = free_t
        else:
            self.clock += self.clk.idle()

    def _async_prefill(self, plan: PrefillChunk) -> None:
        """Run one prefill chunk eagerly; its completion (scheduler
        progress, first-token sampling, TTFT) lands at event time."""
        req, b = plan.request, plan.slot
        self.clk.start()
        expert_load = None
        if plan.is_first and plan.is_last:
            logits = self.executor.prefill(b, plan.tokens)
        else:
            logits, expert_load = self.executor.prefill_chunk(
                b, plan.tokens, plan.start, is_first=plan.is_first,
                is_last=plan.is_last)
        load = None if expert_load is None else expert_load.cpu().numpy()
        if load is not None and self.ecfg.prefill_load_feedback:
            self.pool.observe_load(load)
        dt = self.clk.stop("prefill", result=logits, tokens=plan.length,
                           servers=self._pool_size(),
                           alive_frac=self._alive_frac())
        if load is not None:
            dt += self._charge_cold_starts(load)
        first = None
        if plan.is_last and not req.output_tokens:
            first = int(self._sample(logits, [req], [0])[0])
        t_done = self.clock + dt
        self._client_free_at = t_done
        self._prefill_inflight.add(b)
        self.timeline.post(t_done, "prefill_done", slot=b,
                           rid=req.request_id, length=plan.length,
                           last=plan.is_last, first=first, req=req)

    def _slot_pending(self, b: int) -> list:
        """Tokens sampled for slot ``b`` by in-flight waves, oldest first
        (computed at dispatch, appended at each wave's completion)."""
        return [int(w["tokens"][b]) for w in self._waves
                if b in w["slot_set"]]

    def _slot_exhausted(self, b: int, r: Request) -> bool:
        """Counting in-flight sampled tokens, will slot ``b`` be done when
        its last wave lands?  The lockstep done check, so a slot is never
        dispatched past its final token.  A slot with no wave in flight is
        never exhausted: lockstep decodes a ready slot once more even when
        its prefill-sampled token already meets the done condition."""
        pend = self._slot_pending(b)
        if not pend:
            return False
        count = len(r.output_tokens) + len(pend)
        return (count >= r.sampling.max_new_tokens
                or (self.ecfg.eos_token is not None
                    and pend[-1] == self.ecfg.eos_token)
                or len(r.prompt) + count >= self.ecfg.max_seq - 1)

    def _async_decode(self, plan: DecodeBatch) -> bool:
        """Dispatch one decode wave: values now (``decode_masked`` keeps
        the other slots' rows resumable), the step cost split into the
        client share (the client is busy for it) and the expert share,
        queued as per-server micro-batches.  A slot whose previous token
        is still in flight decodes on its eagerly sampled value.  One
        device-to-host copy carries the sampled tokens and the routed load.
        Returns False when every offered slot is already exhausted."""
        sch = self.scheduler
        B = len(sch.slots)
        active = []
        for b in plan.slots:
            if self._slot_exhausted(b, sch.slots[b]):
                sch.hold(b)      # its in-flight final wave releases it
            else:
                active.append(b)
        if not active:
            return False
        tokens = np.zeros((B, 1), np.int64)
        mask = np.zeros(B, bool)
        reqs, steps = [], []
        for b in active:
            r = sch.slots[b]
            pend = self._slot_pending(b)
            tokens[b, 0] = pend[-1] if pend else r.output_tokens[-1]
            mask[b] = True
            reqs.append(r)
            steps.append(len(r.output_tokens) + len(pend))
        self.clk.start()
        logits, expert_load = self.executor.decode_masked(tokens, mask)
        sampled = self._sample_on_device(logits[active], reqs, steps)
        host = torch.cat([sampled, expert_load.to(sampled.dtype)]
                         ).cpu().numpy()
        next_tokens = np.zeros(B, np.int64)
        next_tokens[active] = host[:len(active)]
        load = host[len(active):]
        self.pool.observe_load(load)
        if self.ecfg.charge_imbalance or self.track_imbalance:
            self.metrics.observe_balance(self.pool.current_imbalance())
        S = self._pool_size()
        af = self._alive_frac()
        client_dt, expert_dt = self.clk.decode_split(
            tokens=len(active), servers=S, alive_frac=af)
        # a wave routed to paged-out experts stalls its own dispatch
        client_dt += self._charge_cold_starts(load)
        t_dispatch = self.clock + client_dt
        self._client_free_at = t_dispatch
        wave_id = self._wave_counter
        self._wave_counter += 1
        entries = self._wave_lane_entries(np.asarray(load, np.float64), S,
                                          expert_dt)
        wave = {"id": wave_id, "slots": active, "slot_set": set(active),
                "tokens": next_tokens, "pending": set()}
        self._waves.append(wave)
        if not entries:
            # no alive server / no routed load: one aggregate completion at
            # the analytic stretched cost
            wave["pending"].add("wave")
            self.timeline.post(t_dispatch + expert_dt / max(af, 1e-3),
                               "wave_done", wave=wave_id)
            return True
        mbs = self.tier.dispatch_lanes(self.client_id, wave_id, entries,
                                       now=t_dispatch)
        for mb in mbs:
            wave["pending"].add(mb.mb_id)
            self._mb_events[mb.mb_id] = self.timeline.post(
                mb.finish_t, "mb_done", mb=mb.mb_id, gen=mb.generation,
                wave=wave_id, server=mb.server, expert=mb.expert)
        if not mbs:
            wave["pending"].add("wave")
            self.timeline.post(t_dispatch, "wave_done", wave=wave_id)
        return True

    def _wave_lane_entries(self, expert_load: np.ndarray, S: int,
                           expert_dt: float) -> list:
        """One wave's expert share as tier entries ``(server, expert,
        work_seconds, tokens)``.  ``expert_dt`` is the balanced per-server
        time: each alive server gets ``expert_dt * S / alive`` (the dead
        servers' work concentrates on the survivors), or, under
        ``charge_imbalance``, a share following this step's routed load.
        ``queue_mode="expert"`` splits a server's share into per-expert
        lane entries (server-major, expert-ascending); a server with no
        routed load keeps one aggregate entry.  ``lane_overhead`` is added
        per lane entry when a server's share splits."""
        alive = self._alive_mask()
        caps = getattr(self.pool, "capacities", None)
        lane_mode = self.ecfg.queue_mode == "expert"
        overhead = float(getattr(self.clk, "lane_overhead", 0.0))
        entries = []
        if self.ecfg.charge_imbalance:
            lanes = lane_loads(expert_load, self.pool.smap.table, S,
                               alive=alive, capacities=caps)
            total = float(lanes.sum())
            if total <= 0.0:
                return []
            scale = expert_dt * S / total
            for s in range(S):
                row = lanes[s]
                row_sum = float(row.sum())
                if row_sum <= 0.0:
                    continue
                if lane_mode:
                    nz = np.nonzero(row)[0]
                    extra = overhead if len(nz) > 1 else 0.0
                    for e in nz:
                        entries.append((s, int(e),
                                        scale * float(row[e]) + extra,
                                        float(row[e])))
                else:
                    entries.append((s, -1, scale * row_sum, row_sum))
            return entries
        n_alive = int(alive.sum())
        if n_alive <= 0:
            return []
        w_server = expert_dt * S / n_alive
        if not lane_mode:
            return [(s, -1, w_server, 1.0) for s in range(S) if alive[s]]
        lanes = lane_loads(expert_load, self.pool.smap.table, S,
                           alive=alive, capacities=caps)
        for s in range(S):
            if not alive[s]:
                continue
            row = lanes[s]
            row_sum = float(row.sum())
            if row_sum <= 0.0:
                # nothing routed here this wave: the uniform share still
                # runs (dispatch / combine sync) as one aggregate entry
                entries.append((s, -1, w_server, 0.0))
                continue
            nz = np.nonzero(row)[0]
            extra = overhead if len(nz) > 1 else 0.0
            for e in nz:
                entries.append((s, int(e),
                                w_server * float(row[e]) / row_sum + extra,
                                float(row[e])))
        return entries

    # -------------------------------------------------------- async events
    def _handle_event(self, ev: Event) -> None:
        if ev.kind == "prefill_done":
            self._on_prefill_done(ev)
        elif ev.kind == "mb_done":
            self._on_mb_done(ev)
        elif ev.kind == "wave_done":
            for w in self._waves:
                if w["id"] == ev.payload["wave"]:
                    w["pending"].discard("wave")
                    break
            self._drain_finished_waves()

    def _on_prefill_done(self, ev: Event) -> None:
        p = ev.payload
        b, req = p["slot"], p["req"]
        self._prefill_inflight.discard(b)
        if self.scheduler.slots[b] is not req:
            return                      # slot aborted / released meanwhile
        self.scheduler.prefill_advanced(b, p["length"])
        if p["last"] and p["first"] is not None:
            req.output_tokens.append(p["first"])
            req.prefill_time = self.clock
            self.metrics.ttfts.append(self.clock - req.arrival_time)
            self.metrics.events.append(
                {"t": self.clock, "event": "prefill",
                 "rid": req.request_id,
                 "ttft": self.clock - req.arrival_time})

    def _on_mb_done(self, ev: Event) -> None:
        p = ev.payload
        if not self.tier.is_current(p["mb"], p["gen"]):
            return                      # re-dispatched or cancelled since
        mb = self.tier.mbs[p["mb"]]
        self.tier.mark_done(mb)
        self._mb_events.pop(mb.mb_id, None)
        # queueing delay behind other work in the micro-batch's lane
        self.metrics.observe_queue_delay(mb.start_t - mb.enqueue_t,
                                         server=mb.server, expert=mb.expert)
        for w in self._waves:
            if w["id"] == mb.wave_id:
                w["pending"].discard(mb.mb_id)
                break
        self._drain_finished_waves()

    def _drain_finished_waves(self) -> None:
        """Retire drained waves in dispatch order: a younger wave whose
        micro-batches all landed waits for its elders."""
        while self._waves and not self._waves[0]["pending"]:
            self._finish_wave(self._waves.popleft())

    def _finish_wave(self, w: dict) -> None:
        """Append the wave's (already sampled) tokens at event time and
        retire finished requests."""
        sch = self.scheduler
        produced = 0
        for b in w["slots"]:
            r = sch.slots[b]
            if r is None:
                continue
            tok = int(w["tokens"][b])
            r.output_tokens.append(tok)
            r.token_times.append(self.clock)
            produced += 1
            self.metrics.total_output_tokens += 1
            done = (len(r.output_tokens) >= r.sampling.max_new_tokens or
                    (self.ecfg.eos_token is not None and
                     tok == self.ecfg.eos_token) or
                    len(r.prompt) + len(r.output_tokens) >=
                    self.ecfg.max_seq - 1)
            if done:
                # _slot_exhausted kept this slot out of every later wave
                r.finish_time = self.clock
                self.metrics.completed += 1
                self.metrics.itls.extend(r.itl())
                sch.release(b)
        self.metrics.timeline.append(
            {"t": self.clock, "tokens": produced, "halted": False})

    def _post_redispatch(self, mb: MicroBatch) -> None:
        """Post the fresh completion event of a re-dispatched micro-batch
        and cancel the superseded one."""
        stale = self._mb_events.pop(mb.mb_id, None)
        if stale is not None:
            self.timeline.cancel(stale)
        self._mb_events[mb.mb_id] = self.timeline.post(
            mb.finish_t, "mb_done", mb=mb.mb_id, gen=mb.generation,
            wave=mb.wave_id, server=mb.server, expert=mb.expert)

    def _reconcile_waves(self) -> None:
        """Drop cancelled micro-batches from the in-flight waves (a failure
        with no survivor cancels outright), cancel their events, retire
        waves left with nothing pending."""
        if self.tier is None:
            return
        for w in self._waves:
            for mb_id in list(w["pending"]):
                if mb_id == "wave":
                    continue
                mb = self.tier.mbs.get(mb_id)
                if mb is None or mb.cancelled:
                    w["pending"].discard(mb_id)
                    stale = self._mb_events.pop(mb_id, None)
                    if stale is not None:
                        self.timeline.cancel(stale)
        self._drain_finished_waves()

    def _drain_async(self) -> None:
        """Run the event timeline dry (the quiesce before a resize)."""
        if self.ecfg.exec_mode != "async":
            return
        while self.timeline.peek_time() is not None:
            ev = self.timeline.pop()
            self.clock = max(self.clock, ev.time)
            self._handle_event(ev)
        self.clock = max(self.clock, self._client_free_at)

    def run(self, max_steps: int = 10_000,
            on_step: Optional[Callable[["ServingEngine"], None]] = None
            ) -> ServingMetrics:
        """Drive until queue + slots drain (or max_steps)."""
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.step_idx < max_steps:
            if on_step:
                on_step(self)
            self.step()
        self.metrics.wall_time = self.clock
        return self.metrics
