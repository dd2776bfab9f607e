"""Physically-disaggregated EAAS demo: the paper's protocol, literally
(counterpart of ``examples/disaggregated_serving.py``).

Two attention clients and three expert servers interact only through
shared buffer slots (state flag / header / payload).  The servers batch
requests from BOTH clients dynamically (paper Fig. 5).  Mid-run we kill a
server WITHOUT telling the clients — the request timeout (paper Fig. 6
②(b)) masks it and re-sends to replicas; the answer is bit-identical.
The servers' ticks run eagerly, as the reference's do: each one batches
whatever its slots hold.

Run:  PYTHONPATH=src python -m repro_torch.examples.disaggregated_serving \\
          [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.examples import add_device_flag, resolve
from repro_torch.serving.disaggregated import build_cluster


def parser() -> argparse.ArgumentParser:
    return add_device_flag(argparse.ArgumentParser(
        prog="python -m repro_torch.examples.disaggregated_serving"))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    device = resolve(parser().parse_args(argv).device)
    cfg = get_config("deepseek-r1").reduced()
    clients, servers, smap, bank = build_cluster(
        cfg, n_clients=2, n_servers=3, n_redundant=3, device=device)
    # make every expert 2-homed so any single failure is survivable
    print(f"cluster: {len(clients)} clients / {len(servers)} servers, "
          f"experts per server: "
          f"{[len(s.expert_ids) for s in servers]}")

    def drive():
        for s in servers:
            s.tick()

    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(16, cfg.d_model)).astype(np.float32) * 0.3
    x1 = rng.normal(size=(12, cfg.d_model)).astype(np.float32) * 0.3

    y0_healthy = clients[0].moe_layer(x0, drive)
    y1_healthy = clients[1].moe_layer(x1, drive)
    print(f"healthy pass: server batches = "
          f"{[s.batches for s in servers]}, "
          f"tokens served = {[s.served_tokens for s in servers]}")

    # --- kill server 1 silently: clients discover it via timeout -------
    servers[1].alive = False
    print("\n*** server 1 killed (no notification) ***")
    y0_failover = clients[0].moe_layer(x0, drive)
    print(f"client0 retries (timeout failovers): {clients[0].retries}")
    err = float((y0_healthy - y0_failover).abs().max())
    print(f"output delta after failover: {err:.2e}")
    assert err < 1e-3, "failover must be transparent"
    assert not smap.alive[1]

    # --- a new server registers and takes traffic back ------------------
    servers[1].alive = True
    smap.mark_alive(1)
    y0_back = clients[0].moe_layer(x0, drive)
    assert float((y0_healthy - y0_back).abs().max()) < 1e-3
    print("server 1 re-registered; traffic restored")
    print("disaggregated_serving OK")
    return {"y0_healthy": y0_healthy, "y1_healthy": y1_healthy,
            "y0_failover": y0_failover, "y0_back": y0_back, "err": err,
            "clients": clients, "servers": servers, "smap": smap}


if __name__ == "__main__":
    main()
