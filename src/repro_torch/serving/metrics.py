"""Throughput / latency meters: the fields the lockstep engine fills
(counterpart of ``src/repro/serving/metrics.py``)."""

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
    # time to first token per request (arrival -> first sampled token)
    ttfts: List[float] = field(default_factory=list)
    events: List[Dict] = field(default_factory=list)
    # per-step decode output (the fault-tolerance timeline)
    timeline: List[Dict] = field(default_factory=list)
    # --- paged-KV counters (zero when the engine runs the dense cache) ---
    preemptions: int = 0               # slots evicted to recompute queue
    prefix_hit_blocks: int = 0         # cached blocks adopted at admission
    prefix_lookup_blocks: int = 0      # block hashes probed at admission
    kv_evictions: int = 0              # cached blocks reclaimed by the pool
    kv_cow_forks: int = 0              # copy-on-write block forks
    kv_peak_block_util: float = 0.0    # max live-block share over the run
    # --- scale-to-zero experts (zero unless experts are paged out) -------
    cold_starts: int = 0               # page-ins triggered by routed traffic
    cold_start_time: float = 0.0       # seconds stalled on cold starts
    expert_page_outs: int = 0          # experts this engine paged out
    # --- expert balance and live placement changes ----------------------
    expert_imbalance: float = 1.0      # latest max/mean alive-server load
    peak_expert_imbalance: float = 1.0  # worst imbalance seen over the run
    rebalances: int = 0                # committed live placement re-plans
    rebalance_noops: int = 0           # evaluations whose plan was identical
    migrated_experts: int = 0          # expert-weight copies applied
    migration_time: float = 0.0        # seconds charged to migration chunks

    @property
    def decode_throughput(self) -> float:
        """Output tokens per second of engine time."""
        return self.total_output_tokens / max(self.wall_time, 1e-9)

    @property
    def prefix_hit_rate(self) -> float:
        """Cached share of the prompt blocks probed at admission."""
        return self.prefix_hit_blocks / max(self.prefix_lookup_blocks, 1)

    def observe_balance(self, imbalance: float) -> None:
        """Record the pool's traffic-EMA imbalance after a decode step."""
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
        """Tail inter-token latency (the latency figure's headline)."""
        return self.itl_stats()["p99"]

    def throughput_curve(self, bin_width: float
                         ) -> List[Tuple[float, float]]:
        """Decode throughput per time bin, [(bin midpoint, tok/s), ...]:
        the paper's Fig. 10 curve, from the step timeline."""
        if not self.timeline:
            return []
        t_end = max(entry["t"] for entry in self.timeline)
        n_bins = max(1, int(np.ceil(t_end / bin_width)))
        toks = np.zeros(n_bins)
        for entry in self.timeline:
            b = min(int(entry["t"] / bin_width), n_bins - 1)
            toks[b] += entry["tokens"]
        return [((b + 0.5) * bin_width, float(toks[b] / bin_width))
                for b in range(n_bins)]

    def fingerprint(self, ndigits: int = 9) -> str:
        """Content hash of the full run timeline (times rounded to
        ``ndigits``), with the reference's payload: two runs of one seeded
        scenario under a virtual clock give equal fingerprints, and so do
        the port and the reference."""
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
        if self.cold_starts or self.expert_page_outs:
            # conditional, as in the reference: a run that never pages an
            # expert fingerprints as before
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
