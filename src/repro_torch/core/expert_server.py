"""The stateless expert server (paper §3.3, Fig. 5).

A server aggregates every client slot into one dynamic batch, sorts the
tokens by local expert, runs the grouped GEMM over the active groups only
(group-shrink, ``ops.grouped_gemm``: the CUDA kernel on the card), weights
by the router scores carried in the payload, and writes the results back
into the slot layout.  It holds no sequence state and starts no transfer.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.router import count_ids
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init


class ServerWeights(NamedTuple):
    """One server's expert weights: w_gate / w_up (L, d, f), w_down
    (L, f, d) for L = E/S primaries + n_red redundant slots, and
    ``local_table`` (E,) global expert id -> local slot (or -1)."""

    w_gate: torch.Tensor
    w_up: torch.Tensor
    w_down: torch.Tensor
    local_table: torch.Tensor


def init_expert_weights(cfg, dtype, device, generator) -> Dict:
    """The global expert bank (E, d, f) / (E, f, d) of the reference's
    ``init_expert_weights``, drawn with its fan-in init (not its numbers)
    a few experts at a time, so the fp32 scratch stays small."""
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_expert, m.num_experts
    return {name: dense_init((E, a, b), dtype, device, generator)
            for name, (a, b) in (("w_gate", (d, f)), ("w_up", (d, f)),
                                 ("w_down", (f, d)))}


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
    paper.  (Full-width init skips the bank: see :func:`fill_redundant`.)
    Each server's slots are gathered straight into the result, so the
    only memory this takes beyond the bank is the result itself."""
    first = next(iter(bank.values()))
    local_ids = _layout_ids(first.shape[0], num_servers, redundant_table)
    dev = first.device
    gather = torch.as_tensor(np.maximum(local_ids, 0), device=dev)
    empty = torch.as_tensor(local_ids < 0, device=dev)
    out = {}
    for k, w in bank.items():
        o = torch.empty((*local_ids.shape, *w.shape[1:]), dtype=w.dtype,
                        device=dev)
        for s in range(num_servers):
            torch.index_select(w, 0, gather[s], out=o[s])
            o[s][empty[s]] = 0
        out[k] = o
    return out


def _apply_slots(w: torch.Tensor, num_experts: int, updates) -> None:
    """Write ``[(server, local_slot, expert_id)]`` into ``(…, S, L, a, b)``
    per-server weights in place: each update is one copy from the expert's
    primary slot (server ``e // per``, slot ``e % per``; primaries never
    move and are never targets) or, for ``expert_id == -1``, one zero
    fill."""
    S = w.shape[-4]
    per = num_experts // S
    assert per * S == num_experts, (num_experts, S)
    for s, slot, e in updates:
        dst = w[..., s, slot, :, :]
        if e >= 0:
            dst.copy_(w[..., e // per, e % per, :, :])
        else:
            dst.zero_()


def fill_redundant(server_w: torch.Tensor, num_experts: int,
                   redundant_table: np.ndarray) -> torch.Tensor:
    """Fill the redundant slots of ``(…, S, L, a, b)`` per-server weights
    in place by copying each expert's primary slot; unused slots are
    zeroed."""
    S = server_w.shape[-4]
    red = np.asarray(redundant_table, np.int32).reshape(S, -1)
    _apply_slots(server_w, num_experts,
                 [(s, redundant_slot(num_experts, S, j), int(e))
                  for s in range(S) for j, e in enumerate(red[s])])
    return server_w


def extract_bank(server_w: Dict, num_experts: int) -> Dict:
    """The global ``(…, E, a, b)`` expert bank from per-server ``(…, S, L,
    a, b)`` arrays: the primary slots, block-contiguous.  A copy whenever
    redundant slots exist — the serving paths below never build it; the
    tests compare layouts through it."""
    def un_shard(w):
        *lead, S, L, a, b = w.shape
        per = num_experts // S
        assert per * S == num_experts, (num_experts, S)
        return w[..., :per, :, :].reshape(*lead, num_experts, a, b)

    return {k: un_shard(v) for k, v in server_w.items()}


def redundant_slot(num_experts: int, num_servers: int, j: int) -> int:
    """Local slot index of redundant column ``j`` (slots 0..E/S-1 are the
    block-contiguous primaries)."""
    return num_experts // num_servers + j


def replica_columns(redundant_table: np.ndarray,
                    expert: int) -> Tuple[Tuple[int, int], ...]:
    """``(server, column)`` of every replica slot holding ``expert`` in the
    redundant table, row-major (the scale-to-zero page-out scan)."""
    red = np.asarray(redundant_table)
    return tuple((int(s), int(j)) for s, j in np.argwhere(red == expert))


def migrate_slots(server_w: Dict, num_experts: int, updates) -> Dict:
    """Copy expert weights into server slots **in place** — the weight half
    of one incremental rebalance chunk (paper §4.5 live migration).

    updates: ``[(server, local_slot, expert_id)]``; ``expert_id == -1``
    zeroes the slot (replica dropped).  Each update is one ``copy_`` (or
    ``zero_``) of an ``(…, a, b)`` slice from the expert's primary slot, so
    a chunk moves O(chunk) bytes and never rebuilds a stacked tensor.  The
    reference's functional ``.at[].set`` gives the same values; here every
    holder of these tensors sees the change."""
    for w in server_w.values():
        _apply_slots(w, num_experts, updates)
    return server_w


def reshard_server_weights(server_w: Dict, num_experts: int,
                           new_servers: int,
                           redundant_table: np.ndarray) -> Dict:
    """Re-lay the per-server weights out for ``new_servers`` servers and
    the replication plan ``redundant_table`` (elastic scaling's weight
    path, paper §5.3), replacing each entry of ``server_w`` in place.

    One weight tensor at a time: the new ``(…, S', L', a, b)`` tensor's
    primaries are copied straight from the old primary slots (a run of
    experts contiguous in both layouts is one copy), its redundant slots
    from its own primaries (:func:`fill_redundant`); then it replaces the
    old tensor, which is dropped before the next name is built.  The global
    bank is never materialised: while no one else holds the old tensors,
    the peak is one stacked tensor above the resident weights (the larger
    of the sets before and after).  Bitwise the reference's gather."""
    E, S2 = num_experts, new_servers
    per2 = E // S2
    assert per2 * S2 == E, (E, S2)
    red = np.asarray(redundant_table, np.int32).reshape(S2, -1)
    for name in list(server_w):
        old = server_w[name]
        *lead, S, _, a, b = old.shape
        per = E // S
        new = torch.empty((*lead, S2, per2 + red.shape[1], a, b),
                          dtype=old.dtype, device=old.device)
        n = math.gcd(per, per2)          # runs inside a block of both
        for e0 in range(0, E, n):
            new[..., e0 // per2, e0 % per2:e0 % per2 + n, :, :].copy_(
                old[..., e0 // per, e0 % per:e0 % per + n, :, :])
        fill_redundant(new, E, red)
        server_w[name] = new
        del old, new
    return server_w


class ServeStats(NamedTuple):
    miss: torch.Tensor     # tokens whose expert this server doesn't host
    served: torch.Tensor   # valid tokens processed


def serve(tokens: torch.Tensor, expert_ids: torch.Tensor,
          scores: torch.Tensor, counts: torch.Tensor,
          weights: ServerWeights, impl: str = "auto"
          ) -> Tuple[torch.Tensor, ServeStats]:
    """Process one aggregated dynamic batch on one server.

    tokens (Clients, C, d); expert_ids / scores (Clients, C); counts
    (Clients,).  Returns (Clients, C, d) score-weighted outputs (zeros on
    invalid slots) and ServeStats.  ``impl``: the grouped GEMMs' lowering
    (``ops.grouped_gemm``); the dense one caps each local expert at the
    reference's ``ecap`` rows.
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
    group_sizes = count_ids(slot, L)            # the padding group: none

    # ---- grouped GEMM over active groups only (group-shrink) -----------
    # per-expert capacity for the dense lowering: ideal share × the buffer
    # capacity factor (under-provisioned experts drop, exactly like slots)
    ecap = max(8, ((-(-(M * 5) // (4 * L))) + 7) // 8 * 8)

    def gg(a, w):
        return ops.grouped_gemm(a, w, group_sizes, impl=impl,
                                expert_capacity=ecap)
    h_gate = gg(xs, weights.w_gate)
    h_up = gg(xs, weights.w_up)
    h = F.silu(h_gate.float()).to(h_up.dtype) * h_up
    y = gg(h, weights.w_down)

    # ---- score weighting + masking, back to slot order ------------------
    y = y.float() * sc[order][:, None]
    in_group = torch.arange(M, device=dev) < group_sizes.sum()
    keep = valid[order] & hosted[order] & in_group
    y = torch.where(keep[:, None], y, 0.0)
    out = torch.empty((M, d), dtype=torch.float32, device=dev)
    out[order] = y
    return (out.reshape(Sc, C, d).to(tokens.dtype),
            ServeStats(miss=miss, served=(valid & hosted).sum()))
