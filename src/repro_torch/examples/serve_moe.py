"""End-to-end serving driver (the paper's deployment kind; counterpart of
``examples/serve_moe.py``): serve a reduced DeepSeek-R1-family MoE through
the cluster front-end — N attention clients sharing one expert tier —
inject a hardware failure mid-run, rebalance hot experts, and print
throughput / inter-token-latency metrics.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_moe [--requests 16]
      ... --clients 4 --frontend-policy least_loaded  # M:N attention:expert
      ... --kv-mode paged [--kv-blocks 13]   # small pools exercise preemption
      ... --clients 4 --fail-client 1        # strand one client's work
      ... --exec-mode async --async-depth 4  # event-driven expert tier
                                             # (the deterministic VirtualClock)
      ... --clients 2 --elastic              # servers, clients and the
                                             # resident expert set follow
                                             # traffic
      ... --device cpu                       # the kernels' plain versions

On the card the clients' decode steps and prefills replay CUDA graphs
(``serving/step_graphs.py``); lockstep runs under the wall clock, so its
times are the card's.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.examples import add_device_flag, resolve
from repro_torch.serving import (Cluster, ClusterConfig, EngineConfig,
                                 Request, SamplingParams, VirtualClock)
from repro_torch.serving.frontend import FRONTEND_POLICIES
from repro_torch.training.data import ShareGPTLike


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_moe")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--mode", default="eaas",
                    choices=["eaas", "monolithic_ep"])
    ap.add_argument("--clients", type=int, default=1,
                    help="attention clients sharing the expert tier")
    ap.add_argument("--frontend-policy", default="round_robin",
                    choices=list(FRONTEND_POLICIES),
                    help="request routing across clients")
    ap.add_argument("--fail-client", type=int, default=None,
                    help="kill this attention client mid-run (its in-flight "
                         "requests strand; everyone else keeps serving)")
    ap.add_argument("--kv-mode", default="dense", choices=["dense", "paged"],
                    help="paged = block-pool KV cache with prefix caching")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="pool size in blocks (default: no memory pressure; "
                         "shrink to exercise admission gating + preemption)")
    ap.add_argument("--exec-mode", default="lockstep",
                    choices=["lockstep", "async"],
                    help="async = event-driven expert tier (per-expert "
                         "queue lanes, depth-K wave pipelining); runs under "
                         "the deterministic VirtualClock — token streams "
                         "are bitwise identical to lockstep")
    ap.add_argument("--async-depth", type=int, default=2,
                    help="decode waves in flight under --exec-mode async "
                         "(1 = lockstep cadence, 2 = ping-pong, K = deeper "
                         "speculative pipelining)")
    ap.add_argument("--elastic", action="store_true",
                    help="attach the full-system autoscaler: expert-server "
                         "count, attention-client count and scale-to-zero "
                         "expert paging all follow observed traffic (the "
                         "batch draining scales the system down under you; "
                         "token streams never change)")
    return add_device_flag(ap)


def build_cluster(cfg: ModelConfig, args: argparse.Namespace, params=None,
                  device=None) -> Cluster:
    """The tour's cluster: 4 servers with 2 redundant slots, as the flags
    say; ``params`` the weight bank (default: the seeded init)."""
    ecfg = EngineConfig(mode=args.mode, num_servers=4, max_batch=4,
                        max_seq=96, n_redundant=2,
                        kv_mode=args.kv_mode, kv_block_size=8,
                        kv_num_blocks=args.kv_blocks,
                        exec_mode=args.exec_mode,
                        async_depth=args.async_depth,
                        # paged prefill runs the chunk path; chunking also
                        # bounds decode gaps while long prompts admit
                        prefill_chunk=(8 if args.kv_mode == "paged" else 0))
    # the async event timeline is defined against the deterministic
    # virtual cost model; lockstep keeps the wall clock (the seed default)
    clock_factory = VirtualClock if args.exec_mode == "async" else None
    return Cluster(cfg, ClusterConfig(clients=args.clients,
                                      frontend_policy=args.frontend_policy,
                                      engine=ecfg,
                                      max_clients=args.clients), seed=0,
                   clock_factory=clock_factory, params=params, device=device)


def main(argv: Optional[Sequence[str]] = None,
         cfg: Optional[ModelConfig] = None) -> Dict:
    """The tour as the flags say, on ``cfg`` (default: reduced
    deepseek-r1)."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.exec_mode == "async" and args.kv_mode != "dense":
        ap.error("--exec-mode async supports --kv-mode dense only")
    device = resolve(args.device)
    cfg = cfg or get_config("deepseek-r1").reduced()
    cluster = build_cluster(cfg, args, device=device)

    scaler = None
    if args.elastic:
        from repro_torch.serving.autoscale import Autoscaler, AutoscalerConfig
        scaler = Autoscaler(AutoscalerConfig(
            rate_per_server=12.0, min_servers=1, max_servers=4,
            window=0.1, cooldown=0.1,
            rate_per_client=24.0, min_clients=1, max_clients=args.clients,
            expert_idle_fraction=0.5))

    # ShareGPT-like workload (bucketed prompt lengths bound prefill captures)
    dist = ShareGPTLike(seed=0)
    plens, rlens = dist.sample(args.requests)
    rng = np.random.default_rng(0)
    requests = []
    for i in range(args.requests):
        plen = int(np.clip(2 ** int(np.log2(max(plens[i] // 64, 1)) + 3), 8, 32))
        if scaler is not None:
            scaler.observe_arrival(cluster.clock)
        requests.append(Request(
            i, rng.integers(0, cfg.vocab_size, size=plen).astype(np.int32),
            SamplingParams(max_new_tokens=int(min(rlens[i] // 32 + 8, 24)))))
        cluster.submit(requests[-1])

    def chaos(c):
        if scaler is not None:
            scaler.step(c, c.clock)
        if c.step_idx == 12:
            print(f"[t={c.clock:.2f}s] *** injecting failure of expert "
                  f"server 1 (mode={args.mode}) ***")
            c.inject_server_failure(1)
        if c.step_idx == 30:
            print(f"[t={c.clock:.2f}s] server 1 recovers + EPLB rebalance")
            c.recover_server(1)
            c.rebalance()
        if args.fail_client is not None and c.step_idx == 40:
            print(f"[t={c.clock:.2f}s] *** attention client "
                  f"{args.fail_client} dies (in-flight work strands) ***")
            c.fail_client(args.fail_client)

    metrics = cluster.run(max_steps=4000, on_step=chaos)
    print("\n=== serving summary ===")
    for k, v in metrics.summary().items():
        print(f"  {k}: {v}")
    halted = sum(1 for c in cluster.clients
                 for t in c.metrics.timeline if t.get("halted"))
    print(f"  halted steps: {halted}")
    for i, eng in enumerate(cluster.clients):
        if eng.kv_pool is not None:
            print(f"  client {i} kv pool: {eng.kv_pool.usable_blocks} blocks"
                  f" x {eng.kv_pool.block_size} tokens, "
                  f"free fraction {eng.kv_pool.free_fraction():.2f}")
    expect = args.requests - metrics.failed_requests
    assert metrics.completed == expect, (metrics.completed, expect)
    return {"cluster": cluster, "metrics": metrics, "requests": requests,
            "halted": halted}


if __name__ == "__main__":
    main()
