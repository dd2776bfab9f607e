"""Serving launcher: the EAAS cluster front-end, or one engine, on any
architecture of the registry (counterpart of
``src/repro/launch/serve.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-r1 \\
        [--reduced] [--requests 12] [--mode eaas|monolithic_ep|tp] \\
        [--clients 4 --frontend-policy least_loaded] [--fail-at 12:1] \\
        [--servers 4] [--exec-mode async --async-depth 2] [--elastic] \\
        [--device cuda|cpu]

``--clients N`` runs the paper's M:N attention:expert shape through
:class:`~repro_torch.serving.Cluster`; ``--mode tp`` and the families
without an expert tier (dense, zamba2, rwkv6, whisper) serve one engine.
``--exec-mode async`` serves through the event-driven expert tier under
the deterministic :class:`~repro_torch.serving.VirtualClock`.

It serves on the card (``--device cuda``, the default) and exits with an
error when there is none; the full MoE configs (deepseek-r1, kimi-k2,
arctic) are larger than one card's memory and need ``--reduced`` there; ``--device cpu`` runs the kernels' plain
versions and forces ``--reduced``, as the reference forces reduced configs
on a CPU backend.  The reference's launcher cannot serve zamba2, rwkv6 or
whisper (their ``decode_step`` returns no stats); this one can.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.serving import (Cluster, ClusterConfig, EngineConfig,
                                 Request, SamplingParams, ServingEngine,
                                 VirtualClock)
from repro_torch.serving.frontend import FRONTEND_POLICIES


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="deepseek-r1", choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--mode", default="eaas",
                    choices=["eaas", "monolithic_ep", "tp"])
    ap.add_argument("--clients", type=int, default=1,
                    help="attention clients sharing the expert tier")
    ap.add_argument("--frontend-policy", default="round_robin",
                    choices=list(FRONTEND_POLICIES))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--servers", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--fail-at", default=None,
                    help="step:rank — inject an expert-server failure")
    ap.add_argument("--exec-mode", default="lockstep",
                    choices=["lockstep", "async"],
                    help="async = event-driven expert tier with per-expert "
                         "queue lanes (needs --mode eaas and an MoE arch; "
                         "runs under the deterministic VirtualClock)")
    ap.add_argument("--async-depth", type=int, default=2,
                    help="decode waves in flight under --exec-mode async")
    ap.add_argument("--elastic", action="store_true",
                    help="attach the autoscaler: expert-server count (and, "
                         "with --clients > 1, client count and expert "
                         "paging) follows observed traffic")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels on the card (an "
                         "error without one); cpu: their plain versions, "
                         "reduced configs only")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = _parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port serves on the GPU — pass "
                         "--device cpu (reduced configs) to run the kernels' "
                         "plain versions")
    cfg = get_config(args.arch)
    if args.reduced or args.device == "cpu":
        cfg = cfg.reduced()

    ecfg = EngineConfig(mode=args.mode, num_servers=args.servers,
                        max_batch=args.max_batch, max_seq=96,
                        n_redundant=2, exec_mode=args.exec_mode,
                        async_depth=args.async_depth,
                        tp_batch_cap=max(args.max_batch // 2, 1))
    if args.exec_mode == "async" and (args.mode != "eaas" or not cfg.moe):
        raise SystemExit("--exec-mode async models the EAAS expert tier: "
                         "it needs --mode eaas and an MoE arch")
    clock_factory = VirtualClock if args.exec_mode == "async" else None
    if args.mode == "tp" or not cfg.moe:
        if args.clients != 1:
            raise SystemExit("--clients > 1 needs a shared expert tier: "
                             "an MoE arch in eaas/monolithic_ep mode")
        system = ServingEngine(cfg, ecfg, seed=0, device=args.device)
    else:
        system = Cluster(cfg, ClusterConfig(
            clients=args.clients, frontend_policy=args.frontend_policy,
            engine=ecfg, max_clients=args.clients), seed=0,
            clock_factory=clock_factory, device=args.device)
    scaler = None
    if args.elastic:
        from repro_torch.serving.autoscale import Autoscaler, AutoscalerConfig
        scaler = Autoscaler(AutoscalerConfig(
            rate_per_server=12.0, min_servers=1, max_servers=args.servers,
            window=0.1, cooldown=0.1,
            rate_per_client=24.0, min_clients=1, max_clients=args.clients,
            expert_idle_fraction=0.5))
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        if scaler is not None:
            scaler.observe_arrival(system.clock)
        system.submit(Request(
            i, rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
            SamplingParams(max_new_tokens=args.max_new)))

    fail = None
    if args.fail_at:
        step_s, rank_s = args.fail_at.split(":")
        fail = (int(step_s), int(rank_s))

    def on_step(s):
        if scaler is not None:
            scaler.step(s, s.clock)
        if fail and s.step_idx == fail[0]:
            print(f"[t={s.clock:.2f}s] injecting failure of server {fail[1]}")
            s.inject_server_failure(fail[1])

    m = system.run(max_steps=5000, on_step=on_step)
    print(f"\n=== summary ({cfg.arch_id}, {args.device}) ===")
    for k, v in m.summary().items():
        print(f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
