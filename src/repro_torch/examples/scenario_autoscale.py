"""Scenario harness tour: script a traffic + fault + scaling timeline and
replay it deterministically against the serving engine (virtual clock;
counterpart of ``examples/scenario_autoscale.py``).

Recreates the paper's two headline timelines in one run:

* Fig. 10 fault curve — a server dies and recovers mid-traffic; EAAS dips
  by the lost compute share instead of stalling;
* Fig. 11 elasticity — traffic halves and the autoscaler walks the expert
  pool down to the ``provision()`` target, printing the resource saving.

On the card each resize reallocates the expert weights, so the decode
graphs are captured again at the new pool size.

Run:  PYTHONPATH=src python -m repro_torch.examples.scenario_autoscale \\
          [--device cpu]
Same seed ⇒ identical output, every run, on any machine.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.core.elastic import provision
from repro_torch.examples import add_device_flag, resolve
from repro_torch.serving import (Autoscaler, AutoscalerConfig, EngineConfig,
                                 Scenario, ServingEngine, VirtualClock)


def parser() -> argparse.ArgumentParser:
    return add_device_flag(argparse.ArgumentParser(
        prog="python -m repro_torch.examples.scenario_autoscale"))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    device = resolve(parser().parse_args(argv).device)
    cfg = get_config("deepseek-r1").reduced()

    # ---- Fig. 10: fault timeline ---------------------------------------
    print("== fault timeline (EAAS, server 1 dies at t=0.1, back at t=0.2)")
    ecfg = EngineConfig(mode="eaas", num_servers=4, max_batch=4, max_seq=64,
                        n_redundant=2)
    eng = ServingEngine(cfg, ecfg, clock=VirtualClock(), device=device)
    sc = (Scenario(horizon=0.3, seed=0, max_new=8, vocab=cfg.vocab_size)
          .poisson(rate=300)
          .fail(rank=1, t=0.1)
          .recover(rank=1, t=0.2)
          .rebalance(t=0.25))
    fault = sc.run(eng)
    for t, thr in fault.metrics.throughput_curve(bin_width=0.05):
        bar = "#" * int(thr / 25)
        print(f"  t={t:4.2f}s  {thr:7.1f} tok/s  {bar}")
    print(f"  summary: {fault.summary()}")

    # ---- Fig. 11: autoscaling timeline ---------------------------------
    print("== autoscale timeline (traffic 300 -> 80 req/s at t=0.6)")
    ecfg = EngineConfig(mode="eaas", num_servers=8, max_batch=4, max_seq=64,
                        n_redundant=1)
    eng2 = ServingEngine(cfg, ecfg, clock=VirtualClock(), device=device)
    asc = Autoscaler(AutoscalerConfig(rate_per_server=40, min_servers=1,
                                      max_servers=8, window=0.2,
                                      cooldown=0.1))
    sc = (Scenario(horizon=1.2, seed=0, max_new=4, vocab=cfg.vocab_size)
          .poisson(rate=300)
          .set_rate(t=0.6, rate=80)
          .autoscale(asc))
    res = sc.run(eng2)
    for e in res.metrics.events:
        if e["event"] == "scale":
            print(f"  t={e['t']:.3f}s  scale {e['from']} -> {e['to']}")
    target = provision(80, rate_per_server=40, granularity=1)
    final = eng2.pool.num_servers
    print(f"  final pool: {final} servers (provision target {target}); "
          f"saving vs static 8: {100 * (1 - final / 8):.1f}%")
    return {"results": {"fault": fault, "autoscale": res},
            "engines": {"fault": eng, "autoscale": eng2}, "final": final}


if __name__ == "__main__":
    main()
