"""``repro_torch.examples.scenario_prefix_cache`` against
``examples/scenario_prefix_cache.py`` (loaded from its path, unedited):
the dense, paged and paged + prefix-cache engines on the JAX engines'
params, float32.  Every printed line (TTFT, tok/s, hit rates, the TTFT
ratio), each variant's greedy tokens, summary and metrics fingerprint
equal; the port's three variants give the same tokens (the tour's own
assert) and the paged engines really page (blocks adopted from the prefix
cache)."""

import pytest

from torch_examples_cases import assert_same_runs, one_thread, run_tours

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_thread)


def test_prefix_cache_matches_the_jax_tour(monkeypatch):
    r = run_tours(monkeypatch, "scenario_prefix_cache",
                  ["ServingEngine"])
    assert_same_runs(r)
    assert len(r.truns) == 3
    engines = r.res["engines"]
    assert engines["dense"].kv_pool is None
    assert engines["paged+prefix"].metrics.prefix_hit_blocks > 0
    assert engines["paged"].metrics.prefix_hit_blocks == 0
