"""Cluster front-end tour: scale-out identity + client-failure containment
(counterpart of ``examples/scenario_cluster_failover.py``).

One seeded Poisson trace replayed three ways under the virtual clock:

* **N=1** — a single attention client over the 4-server expert tier;
* **N=4** — the same trace through the cluster front-end (round_robin):
  requests run on different clients, yet every per-request greedy token
  stream is BITWISE identical to the N=1 run — the front-end changes
  *where* a request runs, never *what* it computes;
* **N=4 + client failure** — client 0 dies mid-trace: its in-flight
  requests strand (counted as failed, never silently retried) while the
  expert tier keeps serving the other three clients.  The cluster
  throughput dip is the dead client's capacity share — compare the
  monolithic single-engine stall on the same trace, which drops to zero.

Run:  PYTHONPATH=src python -m repro_torch.examples.scenario_cluster_failover \\
          [--device cpu]
Same seed ⇒ identical output, every run, on any machine.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.examples import add_device_flag, resolve, tokens
from repro_torch.serving import (Cluster, ClusterConfig, EngineConfig,
                                 Scenario, ServingEngine, VirtualClock)

NUM_SERVERS, MAX_BATCH = 4, 4
HORIZON, RATE, MAX_NEW = 0.4, 250.0, 16
T_FAIL, T_RECOVER = 0.2, 0.35


def build_cluster(cfg, n: int, params=None, device=None) -> Cluster:
    ecfg = EngineConfig(
        mode="eaas", num_servers=NUM_SERVERS, max_batch=MAX_BATCH,
        max_seq=64, n_redundant=2,
        pool_tokens_per_client=MAX_BATCH * NUM_SERVERS)  # drop-free
    return Cluster(cfg, ClusterConfig(clients=n, engine=ecfg), seed=0,
                   clock_factory=VirtualClock, params=params, device=device)


def trace(cfg, clients: int = 1) -> Scenario:
    return Scenario(horizon=HORIZON, seed=7, prompt_len=8, max_new=MAX_NEW,
                    vocab=cfg.vocab_size, clients=clients).poisson(RATE)


def dip(metrics) -> float:
    curve = metrics.throughput_curve(HORIZON / 10)
    pre = [v for t, v in curve if 0.1 * HORIZON <= t < T_FAIL]
    post = [v for t, v in curve if T_FAIL <= t < HORIZON]
    return 1.0 - min(post) / max(np.mean(pre), 1e-9)


def parser() -> argparse.ArgumentParser:
    return add_device_flag(argparse.ArgumentParser(
        prog="python -m repro_torch.examples.scenario_cluster_failover"))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    device = resolve(parser().parse_args(argv).device)
    cfg = get_config("deepseek-r1").reduced()

    res1 = trace(cfg).run(build_cluster(cfg, 1, device=device))
    res4 = trace(cfg, clients=4).run(build_cluster(cfg, 4, device=device))
    t1, t4 = tokens(res1.requests), tokens(res4.requests)
    print(f"N=1: {res1.metrics.completed} requests, "
          f"{res1.metrics.decode_throughput:.0f} tok/s")
    print(f"N=4: {res4.metrics.completed} requests, "
          f"{res4.metrics.decode_throughput:.0f} tok/s")
    print(f"per-request token streams bitwise identical: {t1 == t4}")

    cl = build_cluster(cfg, 4, device=device)
    res_f = (trace(cfg, clients=4)
             .fail_client(i=0, t=T_FAIL)
             .recover_client(i=0, t=T_RECOVER)).run(cl)
    mono = ServingEngine(
        cfg, EngineConfig(mode="monolithic_ep", num_servers=NUM_SERVERS,
                          max_batch=MAX_BATCH, max_seq=64, restart_steps=50,
                          pool_tokens_per_client=MAX_BATCH * NUM_SERVERS),
        seed=0, clock=VirtualClock(), device=device)
    res_m = trace(cfg).fail(rank=1, t=T_FAIL).run(mono)

    print(f"\nclient 0 dies at t={T_FAIL}: "
          f"{cl.metrics.failed_requests} in-flight requests strand, "
          f"{cl.metrics.completed} complete")
    print(f"cluster throughput dip:    {dip(res_f.metrics):.1%} "
          f"(one of 4 clients lost)")
    print(f"monolithic restart stall:  {dip(res_m.metrics):.1%} "
          f"(the whole engine halts)")
    assert dip(res_f.metrics) < dip(res_m.metrics)
    assert t1 == t4
    return {"results": {"n1": res1, "n4": res4, "fail": res_f,
                        "mono": res_m},
            "tokens": {"n1": t1, "n4": t4, "fail": tokens(res_f.requests),
                       "mono": tokens(res_m.requests)},
            "identical": t1 == t4}


if __name__ == "__main__":
    main()
