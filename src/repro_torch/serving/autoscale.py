"""Elastic autoscaling control loop (paper §5.3, Fig. 11) — the
reference's ``serving/autoscale.py``.

The :class:`Autoscaler` watches the arrival rate (a sliding window over
submitted requests) plus queue depth and drives ``engine.scale_to`` toward
the :func:`repro_torch.core.elastic.provision` target at its granularity —
the paper's 37.5 % saving is the gap between granularity 1 and a whole
communication group under a traffic drop.  With ``expert_idle_fraction >
0`` experts whose traffic-EMA share decays below the threshold page out of
the tier (``engine.page_out_experts``); the first token routed back to one
pays the clock's ``cold_start_base``, and ``page_in_protect`` keeps a
freshly paged-in expert resident.  The attention-tier controller
(``rate_per_client``) acts only on a target with ``scale_clients`` — the
cluster, not ported — and stays inert against the engine.

The sub-controllers fire at most ONE action per control step and share
the engine's ``last_placement_change`` cooldown with the rebalance
controller.  Pure host-side policy: deterministic under a virtual clock.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

import numpy as np

from repro_torch.core.elastic import provision


@dataclass
class AutoscalerConfig:
    rate_per_server: float            # request/s one expert server sustains
    min_servers: int = 1
    max_servers: int = 8
    granularity: int = 1              # 1 = EAAS; group size = monolithic EP
    window: float = 0.25              # arrival-rate estimation window (s)
    cooldown: float = 0.2             # min time between scaling actions (s)
    # scale-DOWN deadband (hysteresis): only shrink a tier when the
    # observed rate fits the smaller capacity with this much headroom to
    # spare (rate <= down_headroom * target * rate_per_unit).  Scale-up
    # stays immediate.  Without it, Poisson arrival noise around a
    # capacity boundary flaps the size A-B-A every cooldown.
    down_headroom: float = 0.9
    queue_per_server: float = 0.0     # extra server per this much queue
                                      # backlog (0 disables queue pressure)
    # extra server per this many *unprefilled prompt tokens* (queued +
    # mid-chunk backlog) — with chunked prefill a deep prompt backlog is
    # visible before it converts into queue depth (0 disables)
    prefill_tokens_per_server: float = 0.0
    # scale up while the KV block pool's free fraction sits below this
    # threshold (0 disables).  Memory pressure precedes admission stalls:
    # the pool drains *before* the queue backs up, so this knob fires a
    # step earlier than queue/backlog pressure — the paper's point that
    # attention-tier memory, not expert FLOPs, caps admitted traffic.
    kv_pressure_threshold: float = 0.0
    # --- attention-tier autoscaling (0 disables: servers only) -----------
    rate_per_client: float = 0.0      # request/s one attention client takes
    min_clients: int = 1
    max_clients: int = 8
    # extra client per this many requests parked in the cluster INGRESS
    # queue (per-client backpressure pushed them back there) — the
    # spawn-under-backpressure term (0 disables)
    ingress_per_client: float = 0.0
    # --- scale-to-zero experts (0 disables paging) -----------------------
    # page out an expert whose traffic-EMA *share* sits below this fraction
    # of the uniform share 1/E (e.g. 0.5 = pages experts drawing less than
    # half their fair share); its first routed token pages it back in at
    # the clock's cold_start_base penalty
    expert_idle_fraction: float = 0.0
    # hysteresis: an expert paged in less than this long ago never pages
    # back out — with the EMA bump its own page-in traffic causes, this is
    # what keeps a bursty expert from flapping in and out of the tier
    page_in_protect: float = 0.5
    # never page the resident set below this share of all experts
    min_resident_fraction: float = 0.25


class Autoscaler:
    """Traffic-driven pool resizing: observe arrivals, converge on
    ``provision(rate)`` snapped to a feasible pool size; optionally also
    steer the attention-client count and the resident expert set (see the
    module docstring — one action per step, one shared cooldown)."""

    def __init__(self, cfg: AutoscalerConfig):
        self.cfg = cfg
        # scenario `set_elastic` verb: False freezes every controller
        # (servers, clients, expert paging) without detaching the trace
        self.enabled = True
        self._arrivals: Deque[float] = deque()
        self._last_action = -float("inf")
        # (t, observed rate, desired, actual) decision trace
        self.trace: List[Tuple[float, float, int, int]] = []
        # (t, desired clients, active clients) decision trace
        self.client_trace: List[Tuple[float, int, int]] = []
        # (t, experts paged out) action trace
        self.page_trace: List[Tuple[float, int]] = []

    # ------------------------------------------------------------- signals
    def observe_arrival(self, t: float) -> None:
        self._arrivals.append(t)

    def observed_rate(self, t: float) -> float:
        w = self.cfg.window
        while self._arrivals and self._arrivals[0] < t - w:
            self._arrivals.popleft()
        return len(self._arrivals) / max(w, 1e-9)

    # -------------------------------------------------------------- policy
    def desired_servers(self, t: float, queue_depth: int,
                        prefill_backlog: int = 0,
                        kv_free_fraction: float = 1.0) -> int:
        c = self.cfg
        n = provision(self.observed_rate(t), c.rate_per_server,
                      c.granularity)
        if c.queue_per_server > 0 and queue_depth > 0:
            n += int(queue_depth / c.queue_per_server)
        if c.prefill_tokens_per_server > 0 and prefill_backlog > 0:
            n += int(prefill_backlog / c.prefill_tokens_per_server)
        if (c.kv_pressure_threshold > 0
                and kv_free_fraction < c.kv_pressure_threshold):
            n += 1
        return max(c.min_servers, min(c.max_servers, n))

    def desired_clients(self, t: float, ingress_depth: int = 0) -> int:
        """Attention clients the observed rate needs, plus the ingress
        backpressure term (requests the per-client admission caps pushed
        back into the cluster queue mean the fleet is short)."""
        c = self.cfg
        n = provision(self.observed_rate(t), c.rate_per_client, 1)
        if c.ingress_per_client > 0 and ingress_depth > 0:
            n += int(ingress_depth / c.ingress_per_client)
        return max(c.min_clients, min(c.max_clients, n))

    def _down_ok(self, rate: float, target: int,
                 per_unit: float) -> bool:
        """Scale-down deadband: the smaller tier must absorb the observed
        rate with ``down_headroom`` to spare, else hold the current size
        (see the config comment — this is what keeps arrival noise around
        a capacity boundary from flapping the size)."""
        return rate <= self.cfg.down_headroom * target * per_unit

    def _pageable_experts(self, engine, t: float) -> List[int]:
        """Experts cold enough to page out: traffic-EMA share below
        ``expert_idle_fraction / E``, outside the ``page_in_protect``
        hysteresis window, respecting the ``min_resident_fraction`` floor.
        Coldest first, deterministic tie-break on index."""
        pool = engine.pool
        ema = pool.stats.ema
        if ema is None:
            return []
        total = float(np.sum(ema))
        if total <= 0:
            return []
        E = len(ema)
        share = np.asarray(ema, np.float64) / total
        thresh = self.cfg.expert_idle_fraction / E
        floor = max(1, int(np.ceil(self.cfg.min_resident_fraction * E)))
        budget = (E - len(pool.cold)) - floor
        if budget <= 0:
            return []
        out: List[int] = []
        for e in sorted(range(E), key=lambda e: (share[e], e)):
            if len(out) >= budget:
                break
            if e in pool.cold:
                continue
            if share[e] >= thresh:
                break                    # ascending: nothing colder left
            if t - pool.page_in_t.get(e, -float("inf")) \
                    < self.cfg.page_in_protect:
                continue                 # freshly paged in: protected
            out.append(e)
        return out

    # ---------------------------------------------------------------- loop
    def step(self, engine, t: float) -> Optional[int]:
        """One control iteration; returns the new pool size if the server
        controller scaled (client/paging actions return None — read
        ``client_trace`` / ``page_trace``).  At most one action fires per
        step, and every action re-arms both the local and the shared
        ``last_placement_change`` cooldown."""
        if not self.enabled:
            return None
        if engine.pool is None:
            return None
        if t < self.cfg.window:        # warm-up: the rate estimate is not
            return None                # meaningful before one full window
        # coordinate with live rebalancing: expert-level replication acts
        # first (cheap, no recompile) — hold server-count scaling while a
        # migration is in flight or inside the shared placement cooldown
        reb = getattr(engine, "rebalancer", None)
        if reb is not None and reb.migrating:
            return None
        if (t - getattr(engine, "last_placement_change", float("-inf"))
                < self.cfg.cooldown):
            return None
        # engine-level signal methods so one policy loop drives both a
        # standalone engine and a Cluster (which aggregates over clients)
        backlog = 0
        if self.cfg.prefill_tokens_per_server > 0:
            backlog = engine.pending_prefill_tokens()
        kv_free = 1.0
        if self.cfg.kv_pressure_threshold > 0:
            kv_free = engine.kv_free_fraction()
        want = self.desired_servers(t, len(engine.queue), backlog, kv_free)
        # snap up to the nearest pool size the expert layout supports
        feasible = [n for n in engine.pool.feasible_counts()
                    if n <= self.cfg.max_servers]
        snapped = next((n for n in feasible if n >= want),
                       feasible[-1] if feasible else want)
        have = engine.pool.num_servers
        rate = self.observed_rate(t)
        self.trace.append((t, rate, snapped, have))
        if t - self._last_action < self.cfg.cooldown:
            return None
        if snapped < have and not self._down_ok(rate, snapped,
                                                self.cfg.rate_per_server):
            snapped = have             # deadband: hold until it fits
        if snapped != have:
            engine.scale_to(snapped)
            self._last_action = t
            return snapped
        # ---- attention tier (cluster targets only) ----------------------
        if self.cfg.rate_per_client > 0 \
                and hasattr(engine, "scale_clients"):
            ingress = len(getattr(engine, "ingress", ()))
            want_c = self.desired_clients(t, ingress)
            have_c = engine.active_client_count()
            self.client_trace.append((t, want_c, have_c))
            if want_c < have_c and not self._down_ok(
                    rate, want_c, self.cfg.rate_per_client):
                want_c = have_c
            if want_c != have_c:
                engine.scale_clients(want_c)
                self._last_action = t
                return None
        # ---- scale-to-zero experts --------------------------------------
        if self.cfg.expert_idle_fraction > 0 \
                and hasattr(engine, "page_out_experts"):
            cold = self._pageable_experts(engine, t)
            if cold:
                paged = engine.page_out_experts(cold)
                if paged:
                    self.page_trace.append((t, len(paged)))
                    self._last_action = t
        return None
