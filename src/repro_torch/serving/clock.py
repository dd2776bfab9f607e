"""Pluggable engine clocks (paper §5 methodology).

The engine brackets every step with ``clock.start()`` / ``clock.stop(...)``
and advances its logical time by what the clock returns:

* :class:`WallClock` — real timing; ``stop`` synchronizes the card first
  (where the reference blocks on the step's output), so the window covers
  the device's work — for a weight migration or a page-in too, which hand
  it no output;
* :class:`VirtualClock` — the reference's deterministic analytic cost model
  for lockstep steps (affine in token work, slowed by the lost server
  share under EAAS failover, the expert share stretched by skew,
  contention and stragglers; migration and cold-start charges);
  bit-identical times to the reference.
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
             servers: int = 1, alive_frac: float = 1.0,
             overlap: bool = False, imbalance: float = 1.0,
             contention: float = 1.0, straggle: float = 1.0) -> float:
        """kind: "prefill" | "decode" | "migrate" | "cold_start"; result:
        the step's output tensor; tokens: token work in the step (expert
        copies for migrate, experts paged in for cold_start); servers:
        expert-server pool size; alive_frac: alive share of the pool;
        overlap: two pipelined microbatches; imbalance, contention,
        straggle: stretches (>= 1) of a decode step's expert share — the
        hottest server's max/mean load, clients sharing the tier, the
        slowest alive server's slowdown."""
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
             servers: int = 1, alive_frac: float = 1.0,
             overlap: bool = False, imbalance: float = 1.0,
             contention: float = 1.0, straggle: float = 1.0) -> float:
        if result is not None:
            if result.is_cuda:
                torch.cuda.synchronize(result.device)
        elif torch.cuda.is_initialized():
            # migrate / cold_start hand no output: wait for the copies
            torch.cuda.synchronize()
        return time.perf_counter() - self._t0

    def idle(self) -> float:
        return 1e-4


@dataclass
class VirtualClock(Clock):
    """Deterministic analytic step-cost model (no wall time, no blocking);
    the reference's defaults, so virtual timelines stay comparable."""

    prefill_base: float = 4e-3
    prefill_per_token: float = 2e-4
    decode_base: float = 2e-3
    decode_per_token: float = 2e-4
    # EAAS failover: the surviving replicas absorb the dead servers'
    # traffic, so a step slows by the lost compute share
    degrade_with_dead: bool = True
    # the decode per-token term's expert round-trip share (the rest is the
    # attention client's); a pipelined step charges max of the two + eps
    expert_share: float = 0.5
    overlap_eps: float = 1e-5
    # live expert migration: a control round trip plus a per-expert copy
    migrate_base: float = 1e-3
    migrate_per_expert: float = 2e-3
    # scale-to-zero: per expert paged back in on a step's critical path
    # (0.0 keeps elastic timelines bit-identical to static ones)
    cold_start_base: float = 0.0

    def start(self) -> None:
        pass

    def stop(self, kind: str, *, result=None, tokens: int = 0,
             servers: int = 1, alive_frac: float = 1.0,
             overlap: bool = False, imbalance: float = 1.0,
             contention: float = 1.0, straggle: float = 1.0) -> float:
        if kind == "migrate":
            # each copy lands on one server: no pool parallelism, and
            # liveness does not matter
            return self.migrate_base + self.migrate_per_expert * tokens
        if kind == "cold_start":
            return self.cold_start_base * tokens
        work = tokens / max(servers, 1)
        if kind == "prefill":
            dt = self.prefill_base + self.prefill_per_token * work
        else:
            var = self.decode_per_token * work
            if overlap or imbalance > 1.0 or contention > 1.0 \
                    or straggle > 1.0:
                # the lockstep expert phase ends with its hottest / slowest
                # server; the client share runs on its own hardware
                expert = (self.expert_share * var * max(imbalance, 1.0)
                          * max(contention, 1.0) * max(straggle, 1.0))
                client = (1.0 - self.expert_share) * var
                var = (max(expert, client) + self.overlap_eps if overlap
                       else expert + client)
            dt = self.decode_base + var
        if self.degrade_with_dead:
            dt /= max(min(alive_frac, 1.0), 1e-3)
        return dt

    def idle(self) -> float:
        return self.decode_base
