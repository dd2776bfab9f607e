"""The guided tours of ``examples/`` (the JAX scripts), as modules of the
port: each runs as ``python -m repro_torch.examples.<name>`` and keeps its
script's name, functions and flags.

  quickstart                  one MoE layer; failover as a change of data
  disaggregated_serving       2 clients / 3 servers over shared buffers
  serve_moe                   the paper's deployment through the cluster
  scenario_prefix_cache       dense vs paged vs paged + prefix caching
  scenario_overlap_ablation   pipelined / serialized decode x chunking
  scenario_expert_balance     frozen placement vs live rebalancing
  scenario_cluster_failover   N = 1 vs N = 4 clients, a client failure
  scenario_autoscale          the Fig. 10 fault and Fig. 11 scaling curves
  train_small                 a small MoE LM trained end to end

Each runs on the card (``--device cuda``, the default) and exits with an
error when there is none; ``--device cpu`` runs the kernels' plain
versions.  On the card every step, prefill and layer call that the
reference jits goes through the port's CUDA graphs (the disaggregated
servers' ticks stay eager, as the reference's do); ``step_graphs.eager()``
runs the same tour eagerly.  ``main(argv)`` returns what the tour
computed (tokens, metrics, the engines), for the tests and the smoke run.
"""

from __future__ import annotations

import argparse

import torch


def add_device_flag(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels on the card (an "
                         "error without one); cpu: their plain versions")
    return ap


def resolve(device: str) -> torch.device:
    """``device`` as a torch device; the card when there is none raises
    (a tour never carries on on the CPU)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the tours run on the GPU — pass "
                         "--device cpu to run the kernels' plain versions")
    return torch.device(device)


def tokens(requests) -> dict:
    """request id -> its greedy output tokens."""
    return {r.request_id: tuple(r.output_tokens) for r in requests}
