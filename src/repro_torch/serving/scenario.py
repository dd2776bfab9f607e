"""Deterministic scenario engine for serving experiments (the reference's
``src/repro/serving/scenario.py`` without the cluster verbs).

A :class:`Scenario` scripts a timeline once, deterministically — traffic
arrives, expert servers fail, recover and straggle, the router skews, the
placement rebalances, the pool resizes (or an autoscaler resizes it) — and
replays it against a :class:`~repro_torch.serving.engine.ServingEngine`,
usually under a :class:`~repro_torch.serving.clock.VirtualClock`, so two
runs with the same seed give bit-identical metrics, and so do the port and
the reference on the same trace.

DSL (chained calls, times are engine-clock seconds)::

    sc = (Scenario(horizon=2.0, seed=0, max_new=16)
          .poisson(rate=40)                 # or .bursty(...) / .diurnal(...)
          .set_rate(t=1.0, rate=10)         # piecewise-constant override
          .shared_prefix(n_prefixes=2, prefix_len=16, suffix_len=6)
          .fail(rank=1, t=0.5)              # expert-server failure
          .recover(rank=1, t=0.9)
          .set_policy(t=1.2, policy="fair")
          .zipf_skew(alpha=1.2, scale=1.0)  # Zipf-skewed expert traffic
          .rebalance(t=1.2)
          .scale_to(n=2, t=1.5))            # or .autoscale(Autoscaler(...))
    result = sc.run(engine)

Arrival processes are inhomogeneous Poisson, sampled by Lewis–Shedler
thinning from a seeded generator — the trace depends only on
(seed, rate schedule, horizon), never on engine state.  The cluster verbs
(``fail_client``, ``recover_client``, ``set_frontend_policy``) raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.request import Request, SamplingParams

RateFn = Callable[[float], float]


# ------------------------------------------------------------ traffic skew

def zipf_bias(num_experts: int, alpha: float, scale: float = 2.0,
              seed: int = 0, rotation: int = 0) -> np.ndarray:
    """Router-logit bias tilting expert traffic toward a Zipf(``alpha``)
    profile over a seeded expert permutation.

    Rank r (0-based) of the permutation gets bias ``scale * log p_r`` with
    ``p_r ∝ (r+1)^-alpha`` (normalized so the hottest expert sits at 0 and
    everything else is negative).  ``scale`` sets how hard the bias
    dominates the natural router logits: ~0.5 nudges, ≥3 concentrates
    traffic onto the top-k hottest experts.  ``rotation`` rolls the
    permutation — the shifting-hot-set trace rotates it every period, the
    regime where frozen placement is always chasing stale traffic.
    ``alpha=0`` is the uniform profile: an all-zero bias, bit-identical to
    unbiased routing.
    """
    ranks = np.arange(1, num_experts + 1, dtype=np.float64) ** (-alpha)
    p = ranks / ranks.sum()
    perm = np.roll(np.random.default_rng(seed).permutation(num_experts),
                   rotation)
    bias = np.empty(num_experts, np.float64)
    bias[perm] = scale * np.log(p)
    return (bias - bias.max()).astype(np.float32)


# --------------------------------------------------------------- rate shapes

def constant_rate(rate: float) -> RateFn:
    return lambda t: rate


def bursty_rate(base: float, peak: float, period: float,
                duty: float = 0.2) -> RateFn:
    """Square-wave bursts: ``peak`` req/s for the first ``duty`` fraction of
    every ``period``, ``base`` otherwise (flash-crowd traffic)."""
    def fn(t: float) -> float:
        return peak if (t % period) < duty * period else base
    return fn


def diurnal_rate(mean: float, amplitude: float = 0.5,
                 period: float = 1.0) -> RateFn:
    """Sinusoidal day/night cycle: mean * (1 + amplitude*sin(2πt/period))."""
    def fn(t: float) -> float:
        return max(0.0, mean * (1.0 + amplitude *
                                np.sin(2.0 * np.pi * t / period)))
    return fn


def sample_arrival_times(rate_fn: RateFn, horizon: float,
                         rng: np.random.Generator,
                         rate_max: Optional[float] = None) -> np.ndarray:
    """Inhomogeneous-Poisson arrival times on [0, horizon) by thinning."""
    if rate_max is None:
        grid = np.linspace(0.0, horizon, 4096, endpoint=False)
        rate_max = max(float(max(rate_fn(t) for t in grid)), 1e-9)
    times = []
    t = 0.0
    while True:
        t += rng.exponential(1.0 / rate_max)
        if t >= horizon:
            break
        if rng.random() < rate_fn(t) / rate_max:
            times.append(t)
    return np.asarray(times)


# ------------------------------------------------------------------- events

@dataclass(frozen=True)
class ScenarioEvent:
    t: float
    # fail | recover | rebalance | scale_to | set_policy | set_skew |
    # slow_server | set_elastic
    kind: str
    value: Optional[object] = None     # rank / pool size / policy / ...


@dataclass
class ScenarioResult:
    metrics: ServingMetrics
    requests: List[Request]
    applied: List[Dict]                      # events in application order
    server_trace: List[Tuple[float, int]]    # (t, pool size) samples

    def summary(self) -> Dict:
        out = self.metrics.summary()
        out["events_applied"] = len(self.applied)
        if self.server_trace:
            out["final_servers"] = self.server_trace[-1][1]
        return out


_CLUSTER_ITEM = "item 2 (the async tier and the cluster)"


def _not_ported(verb: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"Scenario.{verb} is not ported yet (ROADMAP Queue 1 {item})")
    method.__name__ = verb
    return method


class Scenario:
    """A scripted, seeded timeline of traffic, faults, skew and scaling."""

    def __init__(self, horizon: float, seed: int = 0, prompt_len: int = 8,
                 max_new: int = 16, vocab: int = 512):
        self.horizon = float(horizon)
        self.seed = seed
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.vocab = vocab
        self.events: List[ScenarioEvent] = []
        self._base_rate: RateFn = constant_rate(0.0)
        self._rate_overrides: List[Tuple[float, float]] = []  # set_rate pts
        self._autoscaler = None
        self._shared_prefix: Optional[Tuple[int, int, int]] = None

    # ------------------------------------------------------------- traffic
    def poisson(self, rate: float) -> "Scenario":
        self._base_rate = constant_rate(rate)
        return self

    def bursty(self, base: float, peak: float, period: float,
               duty: float = 0.2) -> "Scenario":
        self._base_rate = bursty_rate(base, peak, period, duty)
        return self

    def diurnal(self, mean: float, amplitude: float = 0.5,
                period: float = 1.0) -> "Scenario":
        self._base_rate = diurnal_rate(mean, amplitude, period)
        return self

    def set_rate(self, t: float, rate: float) -> "Scenario":
        """Override the arrival rate from time ``t`` on (rate step)."""
        self._rate_overrides.append((float(t), float(rate)))
        self._rate_overrides.sort()
        return self

    def rate_at(self, t: float) -> float:
        r = self._base_rate(t)
        for t0, rate in self._rate_overrides:
            if t >= t0:
                r = rate
        return r

    def shared_prefix(self, n_prefixes: int, prefix_len: int,
                      suffix_len: int) -> "Scenario":
        """Multi-tenant system-prompt traffic: request ``i`` is one of
        ``n_prefixes`` shared prefixes (drawn once from the scenario seed)
        followed by a unique suffix — the workload where paged KV prefix
        caching pays (``prompt_len`` is ignored).  Align ``prefix_len`` to
        the engine's ``kv_block_size`` for full cache hits."""
        self._shared_prefix = (int(n_prefixes), int(prefix_len),
                               int(suffix_len))
        return self

    # -------------------------------------------------------------- events
    def fail(self, rank: int, t: float) -> "Scenario":
        self.events.append(ScenarioEvent(float(t), "fail", rank))
        return self

    def recover(self, rank: int, t: float) -> "Scenario":
        self.events.append(ScenarioEvent(float(t), "recover", rank))
        return self

    def set_policy(self, t: float, policy: str) -> "Scenario":
        """Switch the engine's scheduling policy mid-run."""
        self.events.append(ScenarioEvent(float(t), "set_policy", policy))
        return self

    def slow_server(self, rank: int, t: float,
                    factor: float = 4.0) -> "Scenario":
        """Expert server ``rank`` becomes a straggler at ``t``: its compute
        runs ``factor``× slower until reset (``factor=1.0``).  A lockstep
        engine waits for its slowest server every decode step."""
        self.events.append(ScenarioEvent(
            float(t), "slow_server", (int(rank), float(factor))))
        return self

    def rebalance(self, t: float) -> "Scenario":
        self.events.append(ScenarioEvent(float(t), "rebalance"))
        return self

    def scale_to(self, n: int, t: float) -> "Scenario":
        self.events.append(ScenarioEvent(float(t), "scale_to", n))
        return self

    # ---------------------------------------------------------- skew events
    def set_skew(self, t: float, alpha: float, scale: float = 2.0,
                 rotation: int = 0) -> "Scenario":
        """From time ``t``, bias the engine's router toward a Zipf(alpha)
        expert profile (:func:`zipf_bias` over this scenario's seed).
        ``alpha=0`` clears the skew.  Applied at t=0 the skew is constant
        over the run, so routing stays a pure function of request content —
        engines with different placements (frozen vs rebalanced) still
        produce bitwise-identical greedy token streams."""
        self.events.append(ScenarioEvent(
            float(t), "set_skew",
            (float(alpha), float(scale), int(rotation))))
        return self

    def zipf_skew(self, alpha: float, scale: float = 2.0) -> "Scenario":
        """Constant Zipf-skewed expert traffic for the whole run (the
        hot-expert regime MegaScale-Infer targets)."""
        return self.set_skew(0.0, alpha, scale)

    def shifting_hot_set(self, alpha: float, period: float,
                         scale: float = 2.0) -> "Scenario":
        """Rotate the Zipf hot set every ``period`` seconds: each shift
        re-rolls which experts are hot, so a frozen placement is always
        provisioned for the *previous* hot set while a live rebalancer
        chases the traffic."""
        t, rotation = 0.0, 0
        while t < self.horizon:
            self.set_skew(t, alpha, scale, rotation=rotation)
            t += float(period)
            rotation += 1
        return self

    def autoscale(self, autoscaler, min_clients: int = None,
                  max_clients: int = None) -> "Scenario":
        """Attach an :class:`~repro_torch.serving.autoscale.Autoscaler`
        policy loop (observed each step; its decisions become
        ``engine.scale_to`` / ``engine.page_out_experts``).  ``min_clients``
        / ``max_clients`` bound its attention-tier controller, which acts
        only on a cluster (not ported)."""
        if min_clients is not None:
            autoscaler.cfg.min_clients = int(min_clients)
        if max_clients is not None:
            autoscaler.cfg.max_clients = int(max_clients)
        self._autoscaler = autoscaler
        return self

    def set_elastic(self, t: float, enabled: bool = True) -> "Scenario":
        """Freeze/unfreeze the attached autoscaler at ``t`` (all three
        controllers: servers, clients, expert paging).  A scenario can
        script a static warm-up phase, then flip elasticity on."""
        self.events.append(ScenarioEvent(float(t), "set_elastic",
                                         bool(enabled)))
        return self

    fail_client = _not_ported("fail_client", _CLUSTER_ITEM)
    recover_client = _not_ported("recover_client", _CLUSTER_ITEM)
    set_frontend_policy = _not_ported("set_frontend_policy", _CLUSTER_ITEM)

    # ------------------------------------------------------------ sampling
    def build_arrivals(self) -> List[Request]:
        """Materialize the request trace — deterministic in ``seed``."""
        rng = np.random.default_rng(self.seed)
        times = sample_arrival_times(self.rate_at, self.horizon, rng)
        prefixes = None
        if self._shared_prefix is not None:
            n_pre, pre_len, _ = self._shared_prefix
            prefixes = [rng.integers(0, self.vocab,
                                     size=pre_len).astype(np.int32)
                        for _ in range(n_pre)]
        reqs = []
        for i, t in enumerate(times):
            if prefixes is not None:
                n_pre, _, suf_len = self._shared_prefix
                prompt = np.concatenate([
                    prefixes[i % n_pre],
                    rng.integers(0, self.vocab,
                                 size=suf_len).astype(np.int32)])
            else:
                prompt = rng.integers(0, self.vocab,
                                      size=self.prompt_len).astype(np.int32)
            reqs.append(Request(i, prompt,
                                SamplingParams(max_new_tokens=self.max_new),
                                arrival_time=float(t)))
        return reqs

    # ----------------------------------------------------------- execution
    def run(self, engine, max_steps: int = 20_000,
            drain: bool = True) -> ScenarioResult:
        """Replay the timeline against ``engine`` (its clock is the time
        base).  With ``drain`` the engine runs on past the horizon until all
        admitted work completes."""
        arrivals = self.build_arrivals()
        pending = sorted(self.events, key=lambda e: e.t)
        applied: List[Dict] = []
        trace: List[Tuple[float, int]] = []
        ai = ei = 0

        def pool_size() -> int:
            return engine.pool.num_servers if engine.pool else 1

        while engine.step_idx < max_steps:
            t = engine.clock
            while ai < len(arrivals) and arrivals[ai].arrival_time <= t:
                engine.submit(arrivals[ai])
                if self._autoscaler is not None:
                    self._autoscaler.observe_arrival(t)
                ai += 1
            while ei < len(pending) and pending[ei].t <= t:
                self._apply(pending[ei], engine)
                applied.append(dataclasses.asdict(pending[ei]))
                ei += 1
            # the policy loop runs only while the scripted timeline is live;
            # drain time would read as a rate collapse and scale to min
            if self._autoscaler is not None and t < self.horizon:
                self._autoscaler.step(engine, t)
            trace.append((t, pool_size()))
            exhausted = ai >= len(arrivals) and ei >= len(pending)
            busy = engine.queue or any(s is not None for s in engine.slots)
            if exhausted and not busy:
                break
            if t >= self.horizon and not drain and not busy:
                break
            engine.step()

        engine.metrics.wall_time = engine.clock
        return ScenarioResult(metrics=engine.metrics, requests=arrivals,
                              applied=applied, server_trace=trace)

    def _apply(self, ev: ScenarioEvent, engine) -> None:
        if ev.kind == "fail":
            engine.inject_server_failure(ev.value)
        elif ev.kind == "recover":
            engine.recover_server(ev.value)
        elif ev.kind == "rebalance":
            engine.rebalance()
        elif ev.kind == "scale_to":
            engine.scale_to(ev.value)
        elif ev.kind == "set_policy":
            engine.set_policy(ev.value)
        elif ev.kind == "slow_server":
            engine.set_server_speed(*ev.value)
        elif ev.kind == "set_elastic":
            if self._autoscaler is None:
                raise ValueError("set_elastic needs an attached autoscaler "
                                 "(call .autoscale(...) first)")
            self._autoscaler.enabled = bool(ev.value)
        elif ev.kind == "set_skew":
            if engine.cfg.moe is None:
                return
            alpha, scale, rotation = ev.value
            engine.set_skew(zipf_bias(engine.cfg.moe.num_experts, alpha,
                                      scale=scale, seed=self.seed,
                                      rotation=rotation))
        else:
            raise ValueError(f"unknown scenario event {ev.kind!r}")
