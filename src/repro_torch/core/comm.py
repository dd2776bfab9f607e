"""Buffer transfer between attention clients and expert servers.

Only ``mode="local"`` is ported: one device holds the client and every
logical server, so the transfer is the identity (the reference's ``a2a``
and ``replicated`` modes map to ``torch.distributed`` in a later slice).
Transfers stay client-side calls, keeping the paper's asymmetry: server
code is a pure function from received slots to result slots.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.types import DispatchBuffers


def _check_local(mode: str) -> None:
    if mode != "local":
        raise NotImplementedError(f"comm mode {mode!r} is not ported")


def send_to_servers(buffers: DispatchBuffers, mode: str = "local"):
    """Returns (hidden, expert_id, score, counts) as the servers see them."""
    _check_local(mode)
    return buffers.hidden, buffers.expert_id, buffers.score, buffers.counts


def return_to_clients(result_hidden: Sequence[torch.Tensor],
                      mode: str = "local") -> Sequence[torch.Tensor]:
    """The servers' (C, d) result buffers, one per server, as the client
    reads them (in place: no stacked copy)."""
    _check_local(mode)
    return result_hidden
