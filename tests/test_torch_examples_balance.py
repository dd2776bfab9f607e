"""The control-plane tours against the JAX scripts of ``examples/``
(loaded from their paths, unedited), float32, on the JAX engines' params:

* ``scenario_expert_balance``: frozen placement and live rebalancing under
  a Zipf skew; every printed line (throughput, imbalance, the plans and
  commits with their virtual times, the speedup), tokens, summaries and
  fingerprints equal, and the live engine's placement (mapping and
  redundant table) the JAX engine's;
* ``scenario_autoscale``: the Fig. 10 fault curve and the Fig. 11
  autoscaling timeline; every printed line (the throughput bars, the
  summary, each scale event, the final pool) equal, and both engines'
  final pool sizes.
"""

import numpy as np
import pytest

from torch_examples_cases import assert_same_runs, one_thread, run_tours

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_thread)


def test_expert_balance_matches_the_jax_tour(monkeypatch):
    r = run_tours(monkeypatch, "scenario_expert_balance",
                  ["ServingEngine"])
    assert_same_runs(r)
    assert r.res["identical"]
    (jf, jl), (tf, tl) = r.jmade["ServingEngine"], r.tmade["ServingEngine"]
    for t, j in ((tf, jf), (tl, jl)):
        np.testing.assert_array_equal(t.pool.smap.table, j.pool.smap.table)
        np.testing.assert_array_equal(t.pool.redundant_table,
                                      j.pool.redundant_table)
    assert tl.metrics.rebalances > 0


def test_autoscale_matches_the_jax_tour(monkeypatch):
    r = run_tours(monkeypatch, "scenario_autoscale",
                  ["ServingEngine"])
    assert_same_runs(r)
    tpool = [e.pool.num_servers for e in r.tmade["ServingEngine"]]
    jpool = [e.pool.num_servers for e in r.jmade["ServingEngine"]]
    assert tpool == jpool and r.res["final"] == jpool[1]
