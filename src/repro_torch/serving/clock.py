"""Pluggable engine clocks (paper §5 methodology).

The engine brackets every step with ``clock.start()`` / ``clock.stop(...)``
and advances its logical time by what the clock returns:

* :class:`WallClock` — real timing; ``stop`` synchronizes the card first
  (where the reference blocks on the step's output), so the window covers
  the device's work;
* :class:`VirtualClock` — the reference's deterministic analytic cost model
  for lockstep steps (affine in token work, slowed by the lost server
  share under EAAS failover); bit-identical times to the reference.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch


class Clock:
    """Interface: bracket one engine step, return its duration in seconds."""

    def start(self) -> None:
        raise NotImplementedError

    def stop(self, kind: str, *, result=None, tokens: int = 0,
             servers: int = 1, alive_frac: float = 1.0) -> float:
        """kind: "prefill" | "decode"; result: the step's output tensor;
        tokens: token work in the step; servers: expert-server pool size;
        alive_frac: alive share of the pool."""
        raise NotImplementedError

    def idle(self) -> float:
        """Duration charged to a step with nothing to do."""
        raise NotImplementedError


class WallClock(Clock):
    """Real step timing."""

    def __init__(self) -> None:
        self._t0 = 0.0

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, kind: str, *, result=None, tokens: int = 0,
             servers: int = 1, alive_frac: float = 1.0) -> float:
        if result is not None and result.is_cuda:
            torch.cuda.synchronize(result.device)
        return time.perf_counter() - self._t0

    def idle(self) -> float:
        return 1e-4


@dataclass
class VirtualClock(Clock):
    """Deterministic analytic step-cost model (no wall time, no blocking)."""

    prefill_base: float = 4e-3
    prefill_per_token: float = 2e-4
    decode_base: float = 2e-3
    decode_per_token: float = 2e-4

    def start(self) -> None:
        pass

    def stop(self, kind: str, *, result=None, tokens: int = 0,
             servers: int = 1, alive_frac: float = 1.0) -> float:
        work = tokens / max(servers, 1)
        if kind == "prefill":
            dt = self.prefill_base + self.prefill_per_token * work
        else:
            dt = self.decode_base + self.decode_per_token * work
        # EAAS failover: the surviving replicas absorb the dead servers'
        # traffic, so a step slows by the lost compute share
        return dt / max(min(alive_frac, 1.0), 1e-3)

    def idle(self) -> float:
        return self.decode_base
