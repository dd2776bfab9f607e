"""Throughput / latency meters (counterpart of
``src/repro/serving/metrics.py``): :class:`ServingMetrics` per engine —
with the async tier's per-micro-batch queue delays — and
:class:`ClusterMetrics` over N attention clients.  Payloads and
fingerprints are the reference's, so a seeded virtual-clock run
fingerprints the same in the port and in the reference."""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np


@dataclass
class ServingMetrics:
    total_requests: int = 0
    completed: int = 0
    total_output_tokens: int = 0
    wall_time: float = 0.0
    itls: List[float] = field(default_factory=list)
    # time-to-first-token per request (arrival -> first sampled token);
    # chunked prefill's latency win shows up here and in max-ITL
    ttfts: List[float] = field(default_factory=list)
    events: List[Dict] = field(default_factory=list)
    # per-interval decode throughput (for the fault-tolerance timeline)
    timeline: List[Dict] = field(default_factory=list)
    # --- async expert tier (exec_mode="async" only; else empty) ---------
    # per-micro-batch queueing delay: time waited behind other work in the
    # micro-batch's queue lane before service started — the first-class
    # tail-latency signal the per-step model couldn't observe.  The two
    # parallel lists attribute each delay to its (server, expert-lane);
    # expert -1 is a server's aggregate lane (queue_mode="server")
    queue_delays: List[float] = field(default_factory=list)
    queue_delay_servers: List[int] = field(default_factory=list)
    queue_delay_experts: List[int] = field(default_factory=list)
    # --- paged-KV counters (zero when the engine runs the dense cache) ---
    preemptions: int = 0               # slots evicted to recompute queue
    prefix_hit_blocks: int = 0         # cached blocks adopted at admission
    prefix_lookup_blocks: int = 0      # block hashes probed at admission
    kv_evictions: int = 0              # cached blocks reclaimed by the pool
    kv_cow_forks: int = 0              # copy-on-write block forks
    kv_peak_block_util: float = 0.0    # max live-block share over the run
    # --- scale-to-zero experts (zero unless elasticity pages experts) ----
    cold_starts: int = 0               # page-ins triggered by routed traffic
    cold_start_time: float = 0.0       # seconds stalled on cold starts
    expert_page_outs: int = 0          # experts this engine paged out
    # --- expert-balance gauges (the ExpertStats EMA surfaced per step) ---
    expert_imbalance: float = 1.0      # latest max/mean alive-server load
    peak_expert_imbalance: float = 1.0 # worst imbalance seen over the run
    rebalances: int = 0                # committed live placement re-plans
    rebalance_noops: int = 0           # evaluations whose plan was identical
    migrated_experts: int = 0          # expert-weight copies applied
    migration_time: float = 0.0        # seconds charged to migration chunks

    @property
    def decode_throughput(self) -> float:
        """Output tokens per second."""
        return self.total_output_tokens / max(self.wall_time, 1e-9)

    @property
    def prefix_hit_rate(self) -> float:
        """Cached share of the prompt blocks probed at admission."""
        return self.prefix_hit_blocks / max(self.prefix_lookup_blocks, 1)

    def observe_balance(self, imbalance: float) -> None:
        """Record the pool's current traffic-EMA imbalance after a decode
        step (the statistic the rebalance controller plans from)."""
        self.expert_imbalance = imbalance
        self.peak_expert_imbalance = max(self.peak_expert_imbalance,
                                         imbalance)

    def observe_kv(self, pool, preemptions: int) -> None:
        """Snapshot the block pool after an engine step (idempotent —
        counters are absolute, not deltas)."""
        self.preemptions = preemptions
        self.prefix_hit_blocks = pool.matched_blocks
        self.prefix_lookup_blocks = pool.queried_blocks
        self.kv_evictions = pool.evictions
        self.kv_cow_forks = pool.cow_forks
        self.kv_peak_block_util = max(self.kv_peak_block_util,
                                      pool.utilization())

    def itl_stats(self) -> Dict[str, float]:
        return _latency_stats(self.itls)

    def ttft_stats(self) -> Dict[str, float]:
        return _latency_stats(self.ttfts)

    @property
    def p99_itl(self) -> float:
        """Tail inter-token latency — the straggler-sensitivity headline
        the async-vs-lockstep differential gates pin."""
        return self.itl_stats()["p99"]

    def observe_queue_delay(self, delay: float, server: int = -1,
                            expert: int = -1) -> None:
        """Record one micro-batch's queueing delay attributed to its
        (server, expert-lane)."""
        self.queue_delays.append(float(delay))
        self.queue_delay_servers.append(int(server))
        self.queue_delay_experts.append(int(expert))

    def queue_delay_stats(self, by: str = None) -> Dict:
        """Queue-delay latency stats — aggregate by default, or broken
        down per server (``by="server"``, keys ``"s"``) / per expert lane
        (``by="lane"``, keys ``"s:e"``)."""
        if by is None:
            return _latency_stats(self.queue_delays)
        return {k: _latency_stats(v)
                for k, v in sorted(self._queue_groups(by).items())}

    def _queue_groups(self, by: str) -> Dict[str, List[float]]:
        if by == "server":
            keys = [str(s) for s in self.queue_delay_servers]
        elif by == "lane":
            keys = [f"{s}:{e}" for s, e in zip(self.queue_delay_servers,
                                               self.queue_delay_experts)]
        else:
            raise ValueError(f"unknown queue-delay grouping {by!r}; "
                             "expected 'server' or 'lane'")
        groups: Dict[str, List[float]] = {}
        for k, d in zip(keys, self.queue_delays):
            groups.setdefault(k, []).append(d)
        return groups

    def throughput_curve(self, bin_width: float) -> List[Tuple[float, float]]:
        """Decode throughput per time bin: [(bin midpoint, tok/s), ...].

        This is the paper's Fig. 10 fault curve — the per-interval dip under
        failures — computed from the step timeline."""
        return _throughput_curve(self.timeline, bin_width)

    def fingerprint(self, ndigits: int = 9) -> str:
        """Content hash of the full run timeline (times rounded to
        ``ndigits``).  Two runs of the same seeded scenario under a virtual
        clock must produce identical fingerprints — the determinism
        contract the scenario tests pin down."""
        def clean(obj):
            if isinstance(obj, float):
                return round(obj, ndigits)
            if isinstance(obj, dict):
                return {k: clean(v) for k, v in sorted(obj.items())}
            if isinstance(obj, (list, tuple)):
                return [clean(v) for v in obj]
            if isinstance(obj, (np.integer,)):
                return int(obj)
            if isinstance(obj, (np.floating,)):
                return round(float(obj), ndigits)
            return obj
        payload = clean({
            "requests": self.total_requests,
            "completed": self.completed,
            "tokens": self.total_output_tokens,
            "wall": self.wall_time,
            "itls": list(self.itls),
            "ttfts": list(self.ttfts),
            "events": list(self.events),
            "timeline": list(self.timeline),
            "kv": [self.preemptions, self.prefix_hit_blocks,
                   self.prefix_lookup_blocks, self.kv_evictions,
                   self.kv_cow_forks, self.kv_peak_block_util],
            "balance": [self.rebalances, self.rebalance_noops,
                        self.migrated_experts, self.migration_time,
                        self.expert_imbalance,
                        self.peak_expert_imbalance],
        })
        if self.queue_delays:
            # async-only keys, added conditionally so every lockstep
            # fingerprint (including committed benchmark baselines) is
            # byte-identical to the pre-async scheme; the lane attribution
            # rides along so a delay landing in the wrong lane is a
            # fingerprint drift, not a silent accounting bug
            payload["queue"] = [round(float(q), ndigits)
                                for q in self.queue_delays]
            payload["queue_lanes"] = [list(self.queue_delay_servers),
                                      list(self.queue_delay_experts)]
        if self.cold_starts or self.expert_page_outs:
            # elasticity-only keys, same conditional scheme: a run that
            # never pages an expert fingerprints byte-identically to the
            # pre-elasticity format
            payload["elastic"] = [self.cold_starts,
                                  round(self.cold_start_time, ndigits),
                                  self.expert_page_outs]
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def summary(self) -> Dict:
        out = {
            "requests": self.total_requests,
            "completed": self.completed,
            "output_tokens": self.total_output_tokens,
            "wall_time_s": round(self.wall_time, 3),
            "decode_tok_per_s": round(self.decode_throughput, 2),
            "itl": {k: round(v * 1e3, 3) for k, v in self.itl_stats().items()},
            "ttft": {k: round(v * 1e3, 3)
                     for k, v in self.ttft_stats().items()},
        }
        if self.rebalances or self.migrated_experts or \
                self.peak_expert_imbalance > 1.0:
            out["balance"] = {
                "expert_imbalance": round(self.expert_imbalance, 4),
                "peak_expert_imbalance": round(self.peak_expert_imbalance,
                                               4),
                "rebalances": self.rebalances,
                "rebalance_noops": self.rebalance_noops,
                "migrated_experts": self.migrated_experts,
                "migration_time_s": round(self.migration_time, 4),
            }
        if self.prefix_lookup_blocks or self.kv_peak_block_util:
            out["kv"] = {
                "peak_block_util": round(self.kv_peak_block_util, 4),
                "prefix_hit_rate": round(self.prefix_hit_rate, 4),
                "prefix_hit_blocks": self.prefix_hit_blocks,
                "preemptions": self.preemptions,
                "evictions": self.kv_evictions,
                "cow_forks": self.kv_cow_forks,
            }
        if self.queue_delays:
            out["async"] = {
                "micro_batches": len(self.queue_delays),
                "queue_delay_ms": {
                    k: round(v * 1e3, 3)
                    for k, v in self.queue_delay_stats().items()},
                "queue_delay_p99_ms_by_server": {
                    k: round(v["p99"] * 1e3, 3)
                    for k, v in self.queue_delay_stats(by="server").items()},
            }
        if self.cold_starts or self.expert_page_outs:
            out["elastic"] = {
                "cold_starts": self.cold_starts,
                "cold_start_time_s": round(self.cold_start_time, 4),
                "expert_page_outs": self.expert_page_outs,
            }
        return out


def _latency_stats(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    a = np.asarray(xs)
    return {"mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max())}


def _throughput_curve(timeline: List[Dict],
                      bin_width: float) -> List[Tuple[float, float]]:
    if not timeline:
        return []
    t_end = max(entry["t"] for entry in timeline)
    n_bins = max(1, int(np.ceil(t_end / bin_width)))
    toks = np.zeros(n_bins)
    for entry in timeline:
        b = min(int(entry["t"] / bin_width), n_bins - 1)
        toks[b] += entry["tokens"]
    return [((b + 0.5) * bin_width, float(toks[b] / bin_width))
            for b in range(n_bins)]


@dataclass
class ClusterMetrics:
    """The cluster timeline: N clients' :class:`ServingMetrics` plus
    cluster-level state (front-end routing, client failures, shared
    expert-tier placement changes).

    Every aggregate is derived from the per-client meters on read, so a
    client's own fingerprint stays exactly what it would be standalone —
    the cluster fingerprint wraps the per-client fingerprints plus the
    routing/failure record.
    """

    per_client: List[ServingMetrics] = field(default_factory=list)
    events: List[Dict] = field(default_factory=list)   # cluster-level only
    wall_time: float = 0.0
    failed_requests: int = 0                # stranded by client failures
    # of failed_requests, those shed from the INGRESS queue when the last
    # alive client died (they were never routed, so no client counted
    # them — total_requests adds them back to keep completed == total -
    # failed)
    ingress_failed: int = 0
    routed: List[int] = field(default_factory=list)    # requests per client
    # shared-tier placement counters (the cluster-level RebalanceController
    # writes these — same contract as the ServingMetrics fields)
    rebalances: int = 0
    rebalance_noops: int = 0
    migrated_experts: int = 0
    migration_time: float = 0.0
    # --- full-system elasticity (client churn + provisioned resources) ---
    client_spawns: int = 0              # clients (re)joining the fleet
    client_drains: int = 0              # clients drained out of the fleet
    expert_page_outs: int = 0           # experts paged out of the tier
    # integral of provisioned resource units — active attention clients
    # plus expert servers weighted by the resident expert fraction — over
    # cluster time, with the (t, units) change-point trace behind the
    # windowed integral ``resource_seconds_in`` (the elasticity
    # benchmark's saving-vs-static headline)
    resource_seconds: float = 0.0
    resource_trace: List[Tuple[float, float]] = field(default_factory=list)

    # ------------------------------------------------------- aggregates
    @property
    def total_requests(self) -> int:
        return sum(c.total_requests for c in self.per_client) \
            + self.ingress_failed

    @property
    def completed(self) -> int:
        return sum(c.completed for c in self.per_client)

    @property
    def total_output_tokens(self) -> int:
        return sum(c.total_output_tokens for c in self.per_client)

    @property
    def decode_throughput(self) -> float:
        return self.total_output_tokens / max(self.wall_time, 1e-9)

    @property
    def ttfts(self) -> List[float]:
        return [t for c in self.per_client for t in c.ttfts]

    @property
    def itls(self) -> List[float]:
        return [t for c in self.per_client for t in c.itls]

    @property
    def queue_delays(self) -> List[float]:
        return [q for c in self.per_client for q in c.queue_delays]

    @property
    def queue_delay_servers(self) -> List[int]:
        return [s for c in self.per_client for s in c.queue_delay_servers]

    @property
    def queue_delay_experts(self) -> List[int]:
        return [e for c in self.per_client for e in c.queue_delay_experts]

    @property
    def p99_itl(self) -> float:
        return self.itl_stats()["p99"]

    def queue_delay_stats(self, by: str = None) -> Dict:
        """Cluster-wide queue-delay stats; ``by`` groups per server /
        per lane across every client (the tier is shared, so lane keys
        mean the same thing cluster-wide)."""
        if by is None:
            return _latency_stats(self.queue_delays)
        return {k: _latency_stats(v) for k, v in sorted(
            ServingMetrics._queue_groups(self, by).items())}

    @property
    def preemptions(self) -> int:
        return sum(c.preemptions for c in self.per_client)

    @property
    def prefix_hit_rate(self) -> float:
        hits = sum(c.prefix_hit_blocks for c in self.per_client)
        probes = sum(c.prefix_lookup_blocks for c in self.per_client)
        return hits / max(probes, 1)

    @property
    def peak_expert_imbalance(self) -> float:
        return max([c.peak_expert_imbalance for c in self.per_client],
                   default=1.0)

    @property
    def cold_starts(self) -> int:
        return sum(c.cold_starts for c in self.per_client)

    @property
    def cold_start_time(self) -> float:
        return sum(c.cold_start_time for c in self.per_client)

    def resource_seconds_in(self, t0: float, t1: float) -> float:
        """Provisioned resource-seconds over the window ``[t0, t1]`` by
        step integration of the change-point trace (each segment's units
        hold until the next change; the final segment extends to the run's
        accounting frontier).  The elasticity benchmark uses this to pin
        the off-peak-trough saving vs. a statically provisioned run."""
        tr = self.resource_trace
        if not tr:
            return 0.0
        total = 0.0
        for i, (t, units) in enumerate(tr):
            seg_end = tr[i + 1][0] if i + 1 < len(tr) \
                else max(self.wall_time, t1)
            lo, hi = max(t, t0), min(seg_end, t1)
            if hi > lo:
                total += (hi - lo) * units
        return total

    def merged_timeline(self) -> List[Dict]:
        """All clients' step timelines merged on absolute time (stable:
        ties keep client order) — the cluster throughput record."""
        merged = [dict(entry, client=i)
                  for i, c in enumerate(self.per_client)
                  for entry in c.timeline]
        merged.sort(key=lambda e: e["t"])
        return merged

    def throughput_curve(self, bin_width: float) -> List[Tuple[float, float]]:
        return _throughput_curve(self.merged_timeline(), bin_width)

    def itl_stats(self) -> Dict[str, float]:
        return _latency_stats(self.itls)

    def ttft_stats(self) -> Dict[str, float]:
        return _latency_stats(self.ttfts)

    def fingerprint(self, ndigits: int = 9) -> str:
        """Cluster determinism contract: per-client fingerprints (each one
        already hashes that client's full timeline) plus the routing and
        failure record.  Two runs of one seeded scenario against the same
        cluster shape must match bit-for-bit."""
        payload = {
            "clients": [c.fingerprint(ndigits) for c in self.per_client],
            "events": [{k: (round(v, ndigits) if isinstance(v, float)
                            else v) for k, v in sorted(e.items())}
                       for e in self.events],
            "routed": list(self.routed),
            "failed": self.failed_requests,
            "ingress_failed": self.ingress_failed,
            "wall": round(self.wall_time, ndigits),
            "balance": [self.rebalances, self.rebalance_noops,
                        self.migrated_experts,
                        round(self.migration_time, ndigits)],
        }
        if self.client_spawns or self.client_drains or self.expert_page_outs:
            # elasticity-only key (conditional like the per-client scheme:
            # a run with no client churn and no paging fingerprints
            # byte-identically to the pre-elasticity format)
            payload["elastic"] = [self.client_spawns, self.client_drains,
                                  self.expert_page_outs,
                                  round(self.resource_seconds, ndigits)]
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()

    def summary(self) -> Dict:
        out = {
            "clients": len(self.per_client),
            "requests": self.total_requests,
            "completed": self.completed,
            "failed": self.failed_requests,
            "output_tokens": self.total_output_tokens,
            "wall_time_s": round(self.wall_time, 3),
            "decode_tok_per_s": round(self.decode_throughput, 2),
            "itl": {k: round(v * 1e3, 3)
                    for k, v in self.itl_stats().items()},
            "ttft": {k: round(v * 1e3, 3)
                     for k, v in self.ttft_stats().items()},
            "routed_per_client": list(self.routed),
            "per_client": [
                {"requests": c.total_requests, "completed": c.completed,
                 "output_tokens": c.total_output_tokens}
                for c in self.per_client],
        }
        if self.rebalances or self.migrated_experts:
            out["balance"] = {
                "rebalances": self.rebalances,
                "rebalance_noops": self.rebalance_noops,
                "migrated_experts": self.migrated_experts,
                "migration_time_s": round(self.migration_time, 4),
                "peak_expert_imbalance": round(self.peak_expert_imbalance,
                                               4),
            }
        probes = sum(c.prefix_lookup_blocks for c in self.per_client)
        if probes:
            out["kv"] = {
                "prefix_hit_rate": round(self.prefix_hit_rate, 4),
                "preemptions": self.preemptions,
            }
        if self.client_spawns or self.client_drains or self.expert_page_outs:
            out["elastic"] = {
                "client_spawns": self.client_spawns,
                "client_drains": self.client_drains,
                "expert_page_outs": self.expert_page_outs,
                "cold_starts": self.cold_starts,
                "cold_start_time_s": round(self.cold_start_time, 4),
                "resource_seconds": round(self.resource_seconds, 3),
            }
        return out
