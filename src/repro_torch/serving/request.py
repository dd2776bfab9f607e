"""Request / sampling types for the serving engine (verbatim from the
reference: host-side numpy)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class SamplingParams:
    temperature: float = 0.0          # 0 = greedy
    max_new_tokens: int = 64
    seed: int = 0


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray                # (prompt_len,) int32
    sampling: SamplingParams = field(default_factory=SamplingParams)
    arrival_time: float = 0.0

    # --- engine-filled ---------------------------------------------------
    output_tokens: List[int] = field(default_factory=list)
    prefill_time: Optional[float] = None
    finish_time: Optional[float] = None
    token_times: List[float] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.finish_time is not None

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token (arrival -> first sampled token)."""
        if self.prefill_time is None:
            return None
        return self.prefill_time - self.arrival_time

    def itl(self) -> List[float]:
        """Inter-token latencies (seconds)."""
        ts = ([self.prefill_time] if self.prefill_time is not None else []) \
            + self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]
