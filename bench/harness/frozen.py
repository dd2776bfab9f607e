"""Frozen copies of the program's sound generators and statistics.

The benchmark keeps its own copies, so that a change to the program cannot
move the yardstick.  ``bench/tests/test_bench_data.py`` pins each to its
source's output on one seed.

* :func:`sample_arrival_times` — ``repro_torch/serving/scenario.py``'s
  Lewis-Shedler thinning sampler, as it stands.
* :func:`percentile` — the arithmetic of
  ``repro_torch/serving/metrics.py``'s ``_latency_stats`` (numpy's
  linear-interpolation percentiles), at any rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

RateFn = Callable[[float], float]


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


def percentile(xs, q: float) -> Optional[float]:
    """The ``q``-th percentile of ``xs`` (None for no samples)."""
    if len(xs) == 0:
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))
