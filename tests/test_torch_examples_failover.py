"""``repro_torch.examples.scenario_cluster_failover`` against
``examples/scenario_cluster_failover.py`` (loaded from its path,
unedited), float32: the N = 1 and N = 4 clusters, the N = 4 cluster whose
client 0 fails and recovers, and the monolithic engine whose server 1
fails, each on its JAX counterpart's params.  Every printed line (request
counts, tok/s, "bitwise identical: True", the stranded count, both dips),
tokens, summaries and fingerprints (the clusters' routing and failure
record included) equal."""

import pytest

from torch_examples_cases import assert_same_runs, one_thread, run_tours

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_thread)


def test_cluster_failover_matches_the_jax_tour(monkeypatch):
    r = run_tours(monkeypatch, "scenario_cluster_failover",
                  ["Cluster", "ServingEngine"])
    assert_same_runs(r)
    assert r.res["identical"]
    assert [len(c.clients) for c in r.tmade["Cluster"]] == [1, 4, 4]
    fail_t, fail_j = r.tmade["Cluster"][2], r.jmade["Cluster"][2]
    assert fail_t.metrics.failed_requests == \
        fail_j.metrics.failed_requests > 0
