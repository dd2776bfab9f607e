"""Client-side token dispatch: pack (token, expert, score) triples into the
per-server buffer slots, and the inverse combine.

Two packing algorithms produce identical buffers: ``sort`` (stable sort by
destination server) and ``onehot`` (cumsum-of-onehot ranking).  At most
``capacity`` tokens per (client, server) slot; overflow is dropped and
counted.  The reference drops out-of-range writes with ``mode="drop"``;
here every entry is written at a fixed shape, the dropped ones onto a
scratch row past the ``S*C`` slots that is cut off after: no boolean mask,
so nothing syncs with the host and the pack runs on ``meta`` tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.router import count_ids
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
    flat_token = torch.arange(T * k, device=dev) // k    # no host size

    if method == "sort":
        order = torch.argsort(flat_server, stable=True)
        counts = count_ids(flat_server, S)
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
    dest = torch.where(valid, flat_idx, S * C)           # S*C: scratch row
    hidden = torch.zeros((S * C + 1, d), dtype=x.dtype, device=dev)
    hidden[dest] = x[flat_token]
    eid = torch.full((S * C + 1,), -1, dtype=torch.int64, device=dev)
    eid[dest] = expert_ids.reshape(-1)
    sc = torch.zeros((S * C + 1,), dtype=torch.float32, device=dev)
    sc[dest] = scores.reshape(-1).float()

    return DispatchBuffers(
        hidden=hidden[:S * C].reshape(S, C, d),
        expert_id=eid[:S * C].reshape(S, C),
        score=sc[:S * C].reshape(S, C),
        counts=counts.clamp(max=C),
        combine_slot=torch.where(valid, flat_idx, -1).reshape(T, k),
        dropped=(counts - C).clamp(min=0).sum())


def combine(responses, combine_slot: torch.Tensor, out_dtype=None,
            addend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum the k score-weighted expert outputs back per token.

    responses: the servers' (already score-weighted) results, one (S, C, d)
    tensor or S (C, d) buffers, read in place; combine_slot (T, k) flat
    indices into S*C (-1 = dropped); ``addend`` (T, d), added after the
    cast to the responses' dtype.  One ``ops.combine_slots`` call: gather,
    drop mask, fp32 sum and the add in one kernel on the card.
    """
    out = ops.combine_slots(responses, combine_slot, addend=addend)
    return out if out_dtype is None else out.to(out_dtype)
