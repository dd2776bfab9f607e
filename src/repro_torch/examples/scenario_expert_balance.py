"""Live traffic-adaptive expert rebalancing tour (paper §4.5, Fig. 10;
counterpart of ``examples/scenario_expert_balance.py``).

One seeded Zipf(1.2)-skewed traffic trace replayed twice under the virtual
clock with imbalance-aware step costs:

* frozen placement — the initial uniform-load EPLB plan never moves; the
  two hot experts share one server each and max/mean server load pins at
  ~2x, stretching every decode step;
* live rebalancing — per-step router statistics feed the traffic EMA, the
  controller re-plans, and chunked expert-weight migrations interleave
  with decode steps until the hot experts are replicated pool-wide.

Both runs produce bitwise-identical greedy token streams — placement moves
*where* experts run, never *what* they compute.  On the card a migration
chunk rewrites the weights in place, so the decode graphs stay captured.

Run:  PYTHONPATH=src python -m repro_torch.examples.scenario_expert_balance \\
          [--device cpu]
Same seed ⇒ identical output, every run, on any machine.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.examples import add_device_flag, resolve, tokens
from repro_torch.serving import (EngineConfig, Scenario, ServingEngine,
                                 VirtualClock)

NUM_EXPERTS, NUM_SERVERS, MAX_BATCH = 16, 4, 8


def build_engine(cfg, live_rebalance: bool, params=None,
                 device=None) -> ServingEngine:
    ecfg = EngineConfig(
        mode="eaas", num_servers=NUM_SERVERS, max_batch=MAX_BATCH,
        max_seq=64, n_redundant=2,
        pool_tokens_per_client=MAX_BATCH * NUM_SERVERS,  # drop-free dispatch
        charge_imbalance=True,
        rebalance_interval=0.02 if live_rebalance else 0.0)
    clock = VirtualClock(decode_base=2e-4, decode_per_token=2e-3,
                         expert_share=0.8)
    return ServingEngine(cfg, ecfg, params=params, seed=0, clock=clock,
                         device=device)


def parser() -> argparse.ArgumentParser:
    return add_device_flag(argparse.ArgumentParser(
        prog="python -m repro_torch.examples.scenario_expert_balance"))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    device = resolve(parser().parse_args(argv).device)
    cfg = get_config("deepseek-r1").reduced()
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              num_experts=NUM_EXPERTS))

    def scenario():
        return (Scenario(horizon=0.6, seed=7, prompt_len=8, max_new=24,
                         vocab=cfg.vocab_size)
                .poisson(rate=60)
                .zipf_skew(alpha=1.2, scale=1.0))

    results, engines = {}, {}
    for name, live in (("frozen placement", False), ("live rebalance", True)):
        eng = engines[name] = build_engine(cfg, live, device=device)
        res = scenario().run(eng)
        m = res.metrics
        results[name] = (m, tokens(res.requests))
        print(f"== {name}")
        print(f"   decode throughput: {m.decode_throughput:7.1f} tok/s")
        print(f"   server imbalance (max/mean): {m.expert_imbalance:.3f} "
              f"(peak {m.peak_expert_imbalance:.3f})")
        print(f"   rebalances committed: {m.rebalances}  "
              f"expert weights migrated: {m.migrated_experts}  "
              f"migration time: {m.migration_time * 1e3:.1f}ms")
        for e in m.events:
            if e["event"] == "rebalance_plan":
                print(f"   t={e['t']:.3f}s  plan: {e['updates']} slot moves, "
                      f"imbalance {e['imbalance']:.2f} -> "
                      f"{e['planned_imbalance']:.2f}")
            elif e["event"] == "rebalance_commit":
                print(f"   t={e['t']:.3f}s  commit (converged="
                      f"{e['converged']})")

    (m_f, tok_f), (m_r, tok_r) = results.values()
    print(f"== rebalance speedup: "
          f"x{m_r.decode_throughput / m_f.decode_throughput:.3f}  "
          f"(token streams identical: {tok_f == tok_r})")
    return {"results": results, "engines": engines,
            "identical": tok_f == tok_r}


if __name__ == "__main__":
    main()
