"""Deterministic scenario engine for serving experiments (a subset of
``src/repro/serving/scenario.py``).

A :class:`Scenario` scripts a timeline once, deterministically — traffic
arrives, expert servers fail and recover, the scheduling policy switches —
and replays it against a :class:`~repro_torch.serving.engine.ServingEngine`,
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
          .set_policy(t=1.2, policy="fair"))
    result = sc.run(engine)

Arrival processes are inhomogeneous Poisson, sampled by Lewis–Shedler
thinning from a seeded generator — the trace depends only on
(seed, rate schedule, horizon), never on engine state.  The reference's
other verbs raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.request import Request, SamplingParams

RateFn = Callable[[float], float]


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
    kind: str                          # fail | recover | set_policy
    value: Optional[object] = None     # rank / policy


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


def _not_ported(verb: str, item: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"Scenario.{verb} is not ported yet (ROADMAP Queue 1 {item})")
    method.__name__ = verb
    return method


class Scenario:
    """A scripted, seeded timeline of traffic, failures and policy
    switches."""

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

    slow_server = _not_ported("slow_server", "item 7 (control plane)")
    rebalance = _not_ported("rebalance", "item 7 (control plane)")
    scale_to = _not_ported("scale_to", "item 7 (control plane)")
    set_skew = _not_ported("set_skew", "item 7 (control plane)")
    zipf_skew = _not_ported("zipf_skew", "item 7 (control plane)")
    shifting_hot_set = _not_ported("shifting_hot_set",
                                   "item 7 (control plane)")
    autoscale = _not_ported("autoscale", "item 7 (control plane)")
    set_elastic = _not_ported("set_elastic", "item 8 (elasticity)")
    fail_client = _not_ported("fail_client", "item 8 (cluster)")
    recover_client = _not_ported("recover_client", "item 8 (cluster)")
    set_frontend_policy = _not_ported("set_frontend_policy",
                                      "item 8 (cluster)")

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
                ai += 1
            while ei < len(pending) and pending[ei].t <= t:
                self._apply(pending[ei], engine)
                applied.append(dataclasses.asdict(pending[ei]))
                ei += 1
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

    @staticmethod
    def _apply(ev: ScenarioEvent, engine) -> None:
        if ev.kind == "fail":
            engine.inject_server_failure(ev.value)
        elif ev.kind == "recover":
            engine.recover_server(ev.value)
        elif ev.kind == "set_policy":
            engine.set_policy(ev.value)
        else:
            raise ValueError(f"unknown scenario event {ev.kind!r}")
