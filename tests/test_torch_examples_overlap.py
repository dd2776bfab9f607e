"""``repro_torch.examples.scenario_overlap_ablation`` against
``examples/scenario_overlap_ablation.py`` (loaded from its path,
unedited): pipelined and serialized decode, each with and without chunked
prefill, on the JAX engines' params, float32.  Every printed line (tok/s,
max ITL, p99 TTFT, the identity verdict, the overlap speedup, the chunking
cut), each variant's greedy tokens, summary and metrics fingerprint
equal."""

import pytest

from torch_examples_cases import assert_same_runs, one_thread, run_tours

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_thread)


def test_overlap_ablation_matches_the_jax_tour(monkeypatch):
    r = run_tours(monkeypatch, "scenario_overlap_ablation",
                  ["ServingEngine"])
    assert_same_runs(r)
    assert len(r.truns) == 4
    assert r.res["identical"]
