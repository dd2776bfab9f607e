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
steps by the scheduler's policy.  ``exec_mode="async"`` (the event-driven
expert tier) is not ported and raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.elastic import ServerPool
from repro_torch.core.monitor import Monitor
from repro_torch.models.transformer import build_model
from repro_torch.serving.clock import Clock, WallClock
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
    exec_mode: str = "lockstep"        # async (the event tier): not ported
    # lockstep (one full-batch step) | pipelined (two microbatches, the
    # second on its own stream on the card, §4.2) | serialized (the
    # ablation: the same split chained on one stream)
    decode_mode: str = "lockstep"
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


class ServingEngine:
    """Scheduler -> executor -> metrics orchestrator: EAAS with failover,
    or one of the paper's monolithic baselines."""

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 params=None, seed: int = 0, clock: Optional[Clock] = None,
                 device=None):
        if engine_cfg.exec_mode != "lockstep":
            raise NotImplementedError(
                f"exec_mode={engine_cfg.exec_mode!r} is not ported (this "
                "engine runs exec_mode='lockstep')")
        if engine_cfg.mode not in MODES:
            raise ValueError(f"unknown mode {engine_cfg.mode!r}; expected "
                             f"one of {MODES}")
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.device = resolve_device(device)
        self.clk = clock if clock is not None else WallClock()
        eaas = engine_cfg.mode == "eaas"
        S = engine_cfg.num_servers if engine_cfg.mode != "tp" else 1
        self.pool = None
        if cfg.moe:
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
        # shared placement cooldown (rebalance commits, resizes, page-outs)
        self.last_placement_change = float("-inf")
        self.rebalancer: Optional[RebalanceController] = None
        if (engine_cfg.rebalance_interval > 0 and self.pool is not None
                and eaas):
            self.rebalancer = RebalanceController(RebalanceConfig(
                interval=engine_cfg.rebalance_interval,
                chunk=engine_cfg.rebalance_chunk,
                min_gain=engine_cfg.rebalance_min_gain,
                cooldown=engine_cfg.rebalance_cooldown))
        # compute the imbalance gauge each decode step (it walks the
        # mapping in Python): only when the controller reads it
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

    def _straggle(self) -> float:
        """Slowdown factor of the slowest *alive* expert server — a
        lockstep expert phase finishes with its slowest server."""
        if self.pool is None or self.ecfg.mode != "eaas":
            return 1.0
        alive = self.pool.smap.alive
        n = min(len(alive), len(self.server_speed))
        sp = self.server_speed[:n][alive[:n]]
        return float(sp.max()) if sp.size else 1.0

    # ----------------------------------------------------- autoscaler signals
    def pending_prefill_tokens(self) -> int:
        return self.scheduler.pending_prefill_tokens()

    def kv_free_fraction(self) -> float:
        return self.scheduler.kv_free_fraction()

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
        elif self.ecfg.mode == "monolithic_ep":
            self.halted_until = self.step_idx + self.ecfg.restart_steps
        else:
            self.halted_until = self.step_idx + self.ecfg.tp_restart_steps

    def recover_server(self, rank: int) -> None:
        self.metrics.events.append(
            {"t": self.clock, "event": "server_recover", "rank": rank})
        if self.pool and rank < self.pool.num_servers:
            self.pool.server_recovered(rank)

    def set_server_speed(self, rank: int, factor: float) -> None:
        """Mark expert server ``rank`` as ``factor``x slower (scenario
        ``slow_server``; 1.0 restores it): every lockstep decode step is
        charged the slowest alive server's factor."""
        if self.pool is None or rank >= len(self.server_speed):
            return
        if factor <= 0:
            raise ValueError(f"server speed factor must be > 0: {factor}")
        self.server_speed[rank] = float(factor)
        self.metrics.events.append(
            {"t": self.clock, "event": "slow_server", "rank": rank,
             "factor": float(factor)})

    def apply_migration(self, copies) -> None:
        """Apply one expert-weight migration chunk to the executor's
        weights, in place."""
        self.executor.migrate_slots(copies)

    def charge_migration(self, dt: float) -> None:
        """A migration chunk stalls the lockstep engine: advance the
        clock."""
        self.clock += dt

    def page_out_experts(self, experts) -> list:
        """Scale-to-zero: page cold experts out of the expert tier (their
        replica slots are zeroed through the migration path; the mapping
        keeps the primary as the page-in source).  The first token later
        routed to one pages it back in at the clock's ``cold_start_base``.
        Returns the experts paged out."""
        if self.pool is None:
            return []
        paged, updates = self.pool.page_out_experts(experts)
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
        old = self.pool.num_servers
        if self.rebalancer is not None:
            self.rebalancer.abort()      # a resize replans placement anyway
        self.pool.scale_to(n)
        self.executor.resize(self.pool)
        self.server_speed = np.ones(n)   # fresh pool, fresh speeds
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

    def _sample(self, logits: torch.Tensor, reqs, steps) -> np.ndarray:
        temps = [r.sampling.temperature for r in reqs]
        return sample_batch(logits, temps, [r.sampling.seed for r in reqs],
                            [r.request_id for r in reqs],
                            steps).cpu().numpy()

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
