"""Throughput / latency meters: the fields the lockstep engine fills."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

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

    @property
    def decode_throughput(self) -> float:
        """Output tokens per second of engine time."""
        return self.total_output_tokens / max(self.wall_time, 1e-9)

    def itl_stats(self) -> Dict[str, float]:
        return _latency_stats(self.itls)

    def ttft_stats(self) -> Dict[str, float]:
        return _latency_stats(self.ttfts)

    def summary(self) -> Dict:
        return {
            "requests": self.total_requests,
            "completed": self.completed,
            "output_tokens": self.total_output_tokens,
            "wall_time_s": round(self.wall_time, 3),
            "decode_tok_per_s": round(self.decode_throughput, 2),
            "itl": {k: round(v * 1e3, 3) for k, v in self.itl_stats().items()},
            "ttft": {k: round(v * 1e3, 3)
                     for k, v in self.ttft_stats().items()},
        }


def _latency_stats(xs: List[float]) -> Dict[str, float]:
    if not xs:
        return {"mean": 0.0, "p50": 0.0, "p99": 0.0, "max": 0.0}
    a = np.asarray(xs)
    return {"mean": float(a.mean()),
            "p50": float(np.percentile(a, 50)),
            "p99": float(np.percentile(a, 99)),
            "max": float(a.max())}
