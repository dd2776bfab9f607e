"""The stateless expert server (paper §3.3, Fig. 5).

A server aggregates every client slot into one dynamic batch, sorts the
tokens by local expert, runs the grouped GEMM over the active groups only
(group-shrink, ``ops.grouped_gemm``: the CUDA kernel on the card), weights
by the router scores carried in the payload, and writes the results back
into the slot layout.  It holds no sequence state and starts no transfer.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


class ServerWeights(NamedTuple):
    """One server's expert weights: w_gate / w_up (L, d, f), w_down
    (L, f, d) for L = E/S primaries + n_red redundant slots, and
    ``local_table`` (E,) global expert id -> local slot (or -1)."""

    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor
    local_table: torch.Tensor


def _layout_ids(num_experts: int, num_servers: int,
                redundant_table: np.ndarray) -> np.ndarray:
    """(S, L) local slot -> global expert id (-1 = empty slot): slots
    0..E/S-1 are the block-contiguous primaries, the rest mirror
    ``redundant_table``."""
    E, S = num_experts, num_servers
    per = E // S
    assert per * S == E, (E, S)
    primary_ids = np.arange(E, dtype=np.int32).reshape(S, per)
    red = np.asarray(redundant_table, np.int32).reshape(S, -1)
    return np.concatenate([primary_ids, red], axis=1)


def make_local_table(num_experts: int, num_servers: int,
                     redundant_table: np.ndarray) -> np.ndarray:
    """(S, E) global expert id -> local slot (-1 = not hosted)."""
    local_ids = _layout_ids(num_experts, num_servers, redundant_table)
    local_table = np.full((num_servers, num_experts), -1, np.int32)
    for s in range(num_servers):
        for slot, e in enumerate(local_ids[s]):
            if e >= 0 and local_table[s, e] < 0:
                local_table[s, e] = slot
    return local_table


def build_server_weights(bank: Dict, num_servers: int,
                         redundant_table: np.ndarray) -> Dict:
    """Per-server (S, L, ...) arrays from a global (E, d, f) bank.
    Redundant slots are copies — replication costs memory, as in the
    paper.  (Full-width init skips the bank: see :func:`fill_redundant`.)"""
    first = next(iter(bank.values()))
    local_ids = _layout_ids(first.shape[0], num_servers, redundant_table)
    dev = first.device
    gather = torch.as_tensor(np.maximum(local_ids, 0), device=dev)
    keep = torch.as_tensor(local_ids >= 0, device=dev)[..., None, None]
    return {k: torch.where(keep, w[gather], 0) for k, w in bank.items()}


def fill_redundant(server_w: torch.Tensor, num_experts: int,
                   redundant_table: np.ndarray) -> torch.Tensor:
    """Fill the redundant slots of ``(…, S, L, a, b)`` per-server weights
    in place by copying each expert's primary slot (server e // per, slot
    e % per); unused slots are zeroed."""
    S = server_w.shape[-4]
    per = num_experts // S
    red = np.asarray(redundant_table, np.int32).reshape(S, -1)
    for s in range(S):
        for j, e in enumerate(red[s]):
            dst = server_w[..., s, per + j, :, :]
            if e >= 0:
                dst.copy_(server_w[..., e // per, e % per, :, :])
            else:
                dst.zero_()
    return server_w


class ServeStats(NamedTuple):
    miss: torch.Tensor     # tokens whose expert this server doesn't host
    served: torch.Tensor   # valid tokens processed


def serve(tokens: torch.Tensor, expert_ids: torch.Tensor,
          scores: torch.Tensor, counts: torch.Tensor,
          weights: ServerWeights) -> Tuple[torch.Tensor, ServeStats]:
    """Process one aggregated dynamic batch on one server.

    tokens (Clients, C, d); expert_ids / scores (Clients, C); counts
    (Clients,).  Returns (Clients, C, d) score-weighted outputs (zeros on
    invalid slots) and ServeStats.
    """
    Sc, C, d = tokens.shape
    M = Sc * C
    dev = tokens.device
    x = tokens.reshape(M, d)
    eid = expert_ids.reshape(M)
    sc = scores.reshape(M)
    valid = (torch.arange(C, device=dev)[None, :] < counts[:, None]).reshape(M)
    valid &= eid >= 0

    L = weights.w_gate.shape[0]
    slot = torch.where(valid, weights.local_table[eid.clamp(min=0)].long(), L)
    hosted = slot >= 0
    miss = (valid & ~hosted).sum()
    slot = torch.where(hosted, slot, L)                      # L = padding

    # ---- reorganize tokens by local expert (paper Fig. 5) --------------
    order = torch.argsort(slot, stable=True)
    xs = x[order]
    group_sizes = torch.bincount(slot, minlength=L + 1)[:L]

    # ---- grouped GEMM over active groups only (group-shrink) -----------
    h_gate = ops.grouped_gemm(xs, weights.w_gate, group_sizes)
    h_up = ops.grouped_gemm(xs, weights.w_up, group_sizes)
    h = F.silu(h_gate.float()).to(h_up.dtype) * h_up
    y = ops.grouped_gemm(h, weights.w_down, group_sizes)

    # ---- score weighting + masking, back to slot order ------------------
    y = y.float() * sc[order][:, None]
    in_group = torch.arange(M, device=dev) < group_sizes.sum()
    keep = valid[order] & hosted[order] & in_group
    y = torch.where(keep[:, None], y, 0.0)
    out = torch.empty((M, d), dtype=torch.float32, device=dev)
    out[order] = y
    return (out.reshape(Sc, C, d).to(tokens.dtype),
            ServeStats(miss=miss, served=(valid & hosted).sum()))
