"""Shared-system-prompt tour: paged KV + prefix caching vs the dense cache
(counterpart of ``examples/scenario_prefix_cache.py``).

A multi-tenant trace — every request is one of two shared 16-token system
prompts plus a unique 6-token user suffix — replayed on three engines under
the deterministic virtual clock:

* dense         — per-slot (batch, max_seq) cache, chunked prefill;
* paged         — block-pool cache, prefix caching off (pure paging);
* paged+prefix  — block-pool + hash-based prefix caching: admission adopts
  the cached system-prompt blocks, the prefill plan skips straight to the
  uncached suffix, and the clock charges only those tokens.

All three produce token-identical greedy outputs (paging moves *where* K/V
lives, never *what* is computed); paged+prefix wins mean TTFT by skipping
the shared prefix.  On the card the paged engines decode through the paged
flash-decode kernel, the dense one through flash decode.

Run:  PYTHONPATH=src python -m repro_torch.examples.scenario_prefix_cache \\
          [--device cpu]
Same seed ⇒ identical output, every run, on any machine.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.examples import add_device_flag, resolve, tokens
from repro_torch.serving import (EngineConfig, Scenario, ServingEngine,
                                 VirtualClock)

VARIANTS = (
    ("dense", dict()),
    ("paged", dict(kv_mode="paged", kv_block_size=8,
                   kv_prefix_cache=False)),
    ("paged+prefix", dict(kv_mode="paged", kv_block_size=8)),
)


def make_scenario(vocab: int) -> Scenario:
    return (Scenario(horizon=0.2, seed=7, max_new=8, vocab=vocab)
            .shared_prefix(n_prefixes=2, prefix_len=16, suffix_len=6)
            .poisson(rate=150))


def parser() -> argparse.ArgumentParser:
    return add_device_flag(argparse.ArgumentParser(
        prog="python -m repro_torch.examples.scenario_prefix_cache"))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    device = resolve(parser().parse_args(argv).device)
    cfg = get_config("deepseek-r1").reduced()
    results, engines = {}, {}
    for name, kw in VARIANTS:
        ecfg = EngineConfig(mode="eaas", num_servers=4, max_batch=4,
                            max_seq=128, n_redundant=2,
                            pool_tokens_per_client=128,
                            prefill_chunk=8, policy="fair", **kw)
        eng = ServingEngine(cfg, ecfg, clock=VirtualClock(), device=device)
        res = make_scenario(cfg.vocab_size).run(eng)
        m = res.metrics
        assert m.completed == m.total_requests > 0
        results[name], engines[name] = res, eng
        kv = m.summary().get("kv", {})
        print(f"{name:14s} ttft_mean={m.ttft_stats()['mean'] * 1e3:7.2f}ms "
              f"tok/s={m.decode_throughput:8.1f} "
              f"hit_rate={kv.get('prefix_hit_rate', 0.0):.3f}")

    t0 = tokens(results["dense"].requests)
    assert all(tokens(r.requests) == t0 for r in results.values()), \
        "greedy outputs must be token-identical across kv modes"
    dense_ttft = results["dense"].metrics.ttft_stats()["mean"]
    prefix_ttft = results["paged+prefix"].metrics.ttft_stats()["mean"]
    assert prefix_ttft < dense_ttft
    print(f"\nidentical greedy tokens across all variants; prefix caching "
          f"cuts mean TTFT x{dense_ttft / prefix_ttft:.2f}")
    return {"results": results, "engines": engines}


if __name__ == "__main__":
    main()
