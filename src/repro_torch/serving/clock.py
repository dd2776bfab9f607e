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
  contention and stragglers; migration and cold-start charges), and the
  client/expert split of a decode step the async expert tier queues
  (``decode_split``); bit-identical times to the reference.

:class:`EventTimeline` is the async engine's discrete-event heap: phase
completions posted at absolute engine-clock times and popped in ``(time,
seq)`` order, every fired event logged for :meth:`EventTimeline
.fingerprint`.
"""

from __future__ import annotations

import hashlib
import heapq
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

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
    # async tier, queue_mode="expert": a fixed dispatch overhead added to
    # each expert lane's service time when a wave's share on a server
    # splits into more than one lane (0.0 keeps lane timings equal to the
    # aggregate per-server dispatch at lane_budget=1)
    lane_overhead: float = 0.0
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

    def decode_split(self, *, tokens: int, servers: int = 1,
                     alive_frac: float = 1.0) -> Tuple[float, float]:
        """``(client_dt, expert_dt)`` of one unstretched decode step — the
        async tier's cost primitives: the attention/dispatch/combine share
        the client is busy for, and the expert share at perfect balance.
        Their sum is ``stop("decode", ...)`` with no stretch.  The expert
        share is not divided by ``alive_frac``: the tier concentrates the
        dead servers' micro-batch work on the survivors instead."""
        var = self.decode_per_token * tokens / max(servers, 1)
        client = self.decode_base + (1.0 - self.expert_share) * var
        if self.degrade_with_dead:
            client /= max(min(alive_frac, 1.0), 1e-3)
        return client, self.expert_share * var

    def idle(self) -> float:
        return self.decode_base


@dataclass
class Event:
    """One scheduled completion; ordered by ``(time, seq)``, ``seq`` a
    monotone counter assigned at post time (simultaneous events fire in
    the order they were scheduled)."""

    time: float
    seq: int
    kind: str            # prefill_done | mb_done | wave_done
    payload: Dict = field(default_factory=dict)
    cancelled: bool = False


class EventTimeline:
    """A deterministic event heap: completions posted at absolute
    engine-clock times, popped in nondecreasing ``(time, seq)`` order.
    Every fired event is logged (scalar payload fields only), and
    :meth:`fingerprint` hashes the log."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = 0
        self.log: List[Dict] = []

    def __len__(self) -> int:
        return sum(1 for _, _, ev in self._heap if not ev.cancelled)

    def post(self, time: float, kind: str, **payload) -> Event:
        """Schedule ``kind`` at absolute time ``time``; keep the returned
        event to :meth:`cancel` it."""
        ev = Event(float(time), self._seq, kind, payload)
        self._seq += 1
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def cancel(self, ev: Event) -> None:
        """Invalidate a scheduled event (it is skipped silently)."""
        ev.cancelled = True

    def peek_time(self) -> Optional[float]:
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        return self._heap[0][0] if self._heap else None

    def pop(self) -> Optional[Event]:
        """Next live event in (time, seq) order; logs it as fired."""
        while self._heap:
            _, _, ev = heapq.heappop(self._heap)
            if ev.cancelled:
                continue
            entry = {"t": ev.time, "seq": ev.seq, "kind": ev.kind}
            for k, v in ev.payload.items():
                if isinstance(v, (str, bool, int, float)):
                    entry[k] = v
            self.log.append(entry)
            return ev
        return None

    def clear_pending(self) -> None:
        """Drop every scheduled, unfired event (client failure); the log
        and the seq counter survive."""
        self._heap = []

    def fingerprint(self, ndigits: int = 9) -> str:
        """sha256 of the fired-event log, times rounded to ``ndigits``:
        same seed, same fingerprint — and the reference's on the same
        schedule."""
        def clean(v):
            return round(v, ndigits) if isinstance(v, float) else v
        payload = [{k: clean(v) for k, v in sorted(e.items())}
                   for e in self.log]
        blob = json.dumps(payload, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()
