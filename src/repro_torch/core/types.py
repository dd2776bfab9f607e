"""EAAS core datatypes: router output and the shared-communication-buffer
layout (paper §3.2).

A buffer slot for one (client, server) pair holds a header (valid-token
count) and a payload (activations, global expert id, router score per
token); the port's local mode keeps the S slots as leading-dim tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RouterOutput(NamedTuple):
    expert_ids: torch.Tensor   # (T, k) int64 global expert ids
    scores: torch.Tensor       # (T, k) fp32 combination weights
    full_probs: torch.Tensor   # (T, E) fp32
    aux_loss: torch.Tensor     # () fp32 load-balancing loss
    z_loss: torch.Tensor       # () fp32 router z-loss


class DispatchBuffers(NamedTuple):
    """Client -> server request buffers, one slot per destination server."""

    hidden: torch.Tensor       # (S, C, d) activations
    expert_id: torch.Tensor    # (S, C) int64 global expert id (-1 = empty)
    score: torch.Tensor        # (S, C) fp32
    counts: torch.Tensor       # (S,) int64 header: valid tokens per slot
    combine_slot: torch.Tensor  # (T, k) flat index into S*C, or -1
    dropped: torch.Tensor      # () tokens over capacity
