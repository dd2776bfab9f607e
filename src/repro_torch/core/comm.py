"""Buffer transfer between attention clients and expert servers (the
counterpart of ``src/repro/core/comm.py``, the TPU adaptation of the
paper's one-sided RDMA library) on ``torch.distributed``.

Each (client, server) buffer slot of
:class:`~repro_torch.core.types.DispatchBuffers` rides one collective over
the process group of the mesh's server (``model``) axis:

* ``mode="a2a"``        — tokens are sharded over the server axis too
  (prefill): one ``all_to_all_single`` each way moves every slot to its
  owner and back; dim 0 of what a server receives is the source client,
  as ``jax.lax.all_to_all(..., tiled=True)`` gives it;
* ``mode="replicated"`` — decode: the activations are already replicated
  over the server axis, so no request moves at all; each server reads its
  own slot locally, and the combine is one ``all_reduce`` SUM of the
  per-token partial outputs (:func:`finalize_combine`);
* ``mode="local"``      — one process holds the client and every logical
  server (``group=None``): the identity transfer.

The paper's asymmetry holds: transfers are client-side calls only; server
code (``expert_server.serve``) is a pure function from its received slots
to its result slots.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.types import DispatchBuffers
from repro_torch.distributed import tensor_parallel as tpl

MODES = ("local", "a2a", "replicated")


def _check(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown comm mode {mode!r}; expected {MODES}")


def _a2a_raw(t: torch.Tensor, group) -> torch.Tensor:
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """The transfer is a permutation of blocks: its backward is the same
    ``all_to_all`` in reverse (block j of the gradient back to rank j)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _a2a_raw(t, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a_raw(g, ctx.group), None


def _a2a(t: torch.Tensor, group) -> torch.Tensor:
    """Block i of dim 0 to rank i of ``group``; block j of the result came
    from rank j.  Differentiable (integer buffers need no gradient)."""
    if torch.is_grad_enabled() and t.requires_grad:
        return _AllToAll.apply(t, group)
    return _a2a_raw(t, group)


def send_to_servers(buffers: DispatchBuffers, mode: str = "local",
                    group=None):
    """Client half of the request transfer.  Returns (hidden, expert_id,
    score, counts) as the local server sees them: a2a / local: hidden
    (S, C, d), dim 0 the source client (local: the server); replicated:
    (1, C, d), this server's own slot."""
    _check(mode)
    parts = (buffers.hidden, buffers.expert_id, buffers.score,
             buffers.counts)
    if mode == "local" or group is None:
        return parts
    if mode == "a2a":
        return tuple(_a2a(t, group) for t in parts)
    rank = dist.get_rank(group)
    return tuple(t[rank:rank + 1] for t in parts)


def return_to_clients(result_hidden, mode: str = "local", group=None):
    """Server -> client response transfer.  local: the servers' (C, d)
    result buffers, one per server, read in place (no stacked copy); a2a:
    (S, C, d), dim 0 the responding server; replicated: this server's own
    (1, C, d) slot — the client combines it with the other servers' slots
    dropped and sums the partials (:func:`finalize_combine`)."""
    _check(mode)
    if mode == "local" or group is None:
        return result_hidden
    if mode == "a2a":
        return _a2a(result_hidden, group)
    return result_hidden


def own_slots(combine_slot: torch.Tensor, capacity: int,
              group) -> torch.Tensor:
    """replicated mode: ``combine_slot``'s flat ``s*C + c`` indices
    re-addressed to this server's slot alone, every other server's entry
    dropped (-1), so the combine reads only the local response."""
    rank = dist.get_rank(group)
    mine = torch.div(combine_slot, capacity, rounding_mode="floor") == rank
    return torch.where(mine & (combine_slot >= 0),
                       combine_slot - rank * capacity, -1)


def finalize_combine(y_partial: torch.Tensor, mode: str = "local",
                     group=None) -> torch.Tensor:
    """Cross-server reduction of the combined output (replicated only).
    Its backward is the identity: the summed output is replicated over
    the servers, each of which already holds its whole gradient."""
    _check(mode)
    if mode == "replicated" and group is not None:
        return tpl.reduce_from(y_partial, group)
    return y_partial


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' row blocks of ``group`` concatenated in rank order (the
    a2a island's output back to every server of a data block).  Its
    backward takes this rank's rows of the gradient: what follows is
    replicated over ``group``, so every rank holds the whole gradient
    already, and a reduce-scatter would count it once per rank."""
    return tpl.gather(x, 0, group)
