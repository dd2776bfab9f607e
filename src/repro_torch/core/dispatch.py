"""Client-side token dispatch: pack (token, expert, score) triples into the
per-server buffer slots, and the inverse combine.

Two packing algorithms produce identical buffers: ``sort`` (stable sort by
destination server) and ``onehot`` (cumsum-of-onehot ranking).  At most
``capacity`` tokens per (client, server) slot; overflow is dropped and
counted.  The reference drops out-of-range writes with ``mode="drop"``;
here the writes are masked explicitly.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.types import DispatchBuffers
from repro_torch.kernels import ops


def pack(x: torch.Tensor, expert_ids: torch.Tensor, scores: torch.Tensor,
         server_ids: torch.Tensor, num_servers: int, capacity: int,
         method: str = "onehot") -> DispatchBuffers:
    """x (T, d); expert_ids / scores / server_ids (T, k)."""
    T, d = x.shape
    k = expert_ids.shape[1]
    S, C = num_servers, capacity
    dev = x.device
    flat_server = server_ids.reshape(-1)
    flat_token = torch.arange(T, device=dev).repeat_interleave(k)

    if method == "sort":
        order = torch.argsort(flat_server, stable=True)
        counts = torch.bincount(flat_server, minlength=S)
        starts = torch.cumsum(counts, 0) - counts
        slot_sorted = torch.arange(T * k, device=dev) - starts[
            flat_server[order]]
        slot = torch.empty_like(slot_sorted)
        slot[order] = slot_sorted
    elif method == "onehot":
        onehot = F.one_hot(flat_server, S)                   # (Tk, S)
        ranks = torch.cumsum(onehot, dim=0) - onehot         # exclusive
        slot = torch.gather(ranks, 1, flat_server[:, None])[:, 0]
        counts = onehot.sum(dim=0)
    else:
        raise ValueError(method)

    valid = slot < C
    flat_idx = flat_server * C + slot
    dest = flat_idx[valid]
    hidden = torch.zeros((S * C, d), dtype=x.dtype, device=dev)
    hidden[dest] = x[flat_token[valid]]
    eid = torch.full((S * C,), -1, dtype=torch.int64, device=dev)
    eid[dest] = expert_ids.reshape(-1)[valid]
    sc = torch.zeros((S * C,), dtype=torch.float32, device=dev)
    sc[dest] = scores.reshape(-1)[valid].float()

    return DispatchBuffers(
        hidden=hidden.reshape(S, C, d),
        expert_id=eid.reshape(S, C),
        score=sc.reshape(S, C),
        counts=counts.clamp(max=C),
        combine_slot=torch.where(valid, flat_idx, -1).reshape(T, k),
        dropped=(counts - C).clamp(min=0).sum())


def combine(result_hidden: torch.Tensor, combine_slot: torch.Tensor,
            out_dtype=None) -> torch.Tensor:
    """Sum the k score-weighted expert outputs back per token.

    result_hidden (S, C, d) server responses (already score-weighted);
    combine_slot (T, k) flat indices into S*C (-1 = dropped).  The gather
    runs in PyTorch; the weighted sum is ``ops.combine_weighted`` with
    weight 1 for a kept slot and 0 for a dropped one.
    """
    S, C, d = result_hidden.shape
    T, k = combine_slot.shape
    flat = result_hidden.reshape(S * C, d)
    gathered = flat[combine_slot.clamp(min=0).reshape(-1)].reshape(T, k, d)
    keep = (combine_slot >= 0).to(torch.float32)
    out = ops.combine_weighted(gathered, keep)
    return out.to(out_dtype or result_hidden.dtype)
