"""Quickstart: the EAAS MoE layer as a composable module (counterpart of
``examples/quickstart.py``).

Builds a reduced Kimi-K2-family MoE layer, routes a batch of tokens through
the full client->server->client pipeline, then demonstrates the two runtime
superpowers of the service architecture — failover and replication — as
pure *data* changes (no recapture).

Each of the two layer programs is compiled as the reference jits it
(``step_graphs.compile_fn``: one CUDA graph on the card, captured at its
first call), with the mapping and the liveness mask in static device
buffers.  The failover call rewrites the mask and replays the graph the
healthy call captured.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import load_balance
from repro_torch.core.expert_server import (build_server_weights,
                                            make_local_table)
from repro_torch.core.moe_layer import (default_runtime, eaas_moe_apply,
                                        init_eaas_moe)
from repro_torch.examples import add_device_flag, resolve
from repro_torch.models.common import resolve_dtype
from repro_torch.serving.step_graphs import compile_fn

S = 4                                    # logical expert servers
T = 64


def init_inputs(cfg: ModelConfig, device) -> tuple:
    """The layer's params over ``S`` servers and the (T, d) batch, seeded
    (0 for the weights, 1 for the batch, as the reference's keys); the
    batch in float32, as the reference's."""
    params = init_eaas_moe(cfg, S, np.zeros((S, 0), np.int32),
                           resolve_dtype(cfg.dtype), device,
                           torch.Generator(device=device).manual_seed(0))
    x = torch.randn((T, cfg.d_model), dtype=torch.float32, device=device,
                    generator=torch.Generator(device=device).manual_seed(1))
    return params, x * 0.3


def replicate(params: Dict, cfg: ModelConfig, red: np.ndarray) -> None:
    """Rebuild the per-server banks so each expert gets its redundant
    homes: one weight at a time, the old one freed before the next is
    built (at full width the 2-homed bank is most of the card)."""
    E = cfg.moe.num_experts
    for k in ("w_gate", "w_up", "w_down"):
        w = params["servers"].pop(k)
        bank = w[:, :E // S].reshape(E, *w.shape[2:])
        del w
        params["servers"][k] = build_server_weights({k: bank}, S, red)[k]
        del bank


def tour(cfg: ModelConfig, device, params: Optional[Dict] = None,
         x: Optional[torch.Tensor] = None,
         out: Optional[Dict] = None) -> Dict:
    """The tour on ``cfg``; ``params`` and ``x`` default to
    :func:`init_inputs`'s (the parity tests pass the reference's).  What
    it computes goes into ``out`` (a new dict by default) before the
    tour's assert, so a caller holds it even where the assert fails; the
    dict is returned.  The float32 batch meets bfloat16 weights as in the
    reference, promoted: float32 products and a float32 output."""
    res = {} if out is None else out
    m = cfg.moe
    print(f"arch={cfg.arch_id}  experts={m.num_experts} top-{m.top_k}")
    if params is None:
        params, x0 = init_inputs(cfg, device)
        x = x0 if x is None else x
    x = x.to(device)
    rt = default_runtime(cfg, S, T, device)

    # --- 1. the layer is a drop-in FFN --------------------------------
    fn = compile_fn(lambda p, xx, mapping, alive: eaas_moe_apply(
        p, xx, m, rt._replace(mapping=mapping, alive=alive),
        activation=cfg.activation), device)
    y, stats = fn(params, x, rt.mapping, rt.alive)
    print(f"output {tuple(y.shape)}  dropped={int(stats.dropped)} "
          f"miss={int(stats.miss)}")
    print("expert load:", stats.expert_load.cpu().numpy())

    # --- 2. failover is a data change (same compiled fn!) --------------
    # first replicate everything so each expert has 2 homes
    mapping, red = load_balance.eplb_plan(
        np.ones(m.num_experts), S, n_redundant=m.num_experts // S,
        max_replicas=2)
    replicate(params, cfg, red)
    # headroom: failover concentrates traffic on survivors, so buffer slots
    # get capacity for the worst case (paper §3.2 capacity-factor sizing)
    rt2 = rt._replace(
        mapping=torch.as_tensor(mapping, dtype=torch.int64, device=device),
        capacity=T * m.top_k,
        local_table=torch.as_tensor(make_local_table(m.num_experts, S, red),
                                    dtype=torch.int64, device=device))
    fn2 = compile_fn(lambda p, xx, mapping, alive: eaas_moe_apply(
        p, xx, m, rt2._replace(mapping=mapping, alive=alive),
        activation=cfg.activation), device)

    y_healthy, _ = fn2(params, x, rt2.mapping, rt2.alive)
    alive_dead = rt2.alive.clone()
    alive_dead[2] = False                        # server 2 dies
    captured = fn2.captures
    y_failover, st = fn2(params, x, rt2.mapping, alive_dead)
    err = float((y_healthy - y_failover).abs().max())
    res.update(y=y, stats=stats, y_healthy=y_healthy, y_failover=y_failover,
               failover_stats=st, err=err, fn=fn, fn2=fn2,
               failover_captures=fn2.captures - captured)
    print(f"server 2 killed: max output delta = {err:.2e} "
          f"(transparent failover), miss={int(st.miss)}")
    assert err < 1e-3

    print("quickstart OK")
    return res


def parser() -> argparse.ArgumentParser:
    return add_device_flag(argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart"))


def main(argv: Optional[Sequence[str]] = None,
         cfg: Optional[ModelConfig] = None,
         out: Optional[Dict] = None) -> Dict:
    """The tour on ``cfg`` (default: reduced Kimi-K2); ``out`` as in
    :func:`tour`."""
    args = parser().parse_args(argv)
    device = resolve(args.device)
    return tour(cfg or get_config("kimi-k2-1t-a32b").reduced(), device,
                out=out)


if __name__ == "__main__":
    main()
