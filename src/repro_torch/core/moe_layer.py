"""EaasMoELayer — the paper's contribution.

router -> mapping lookup (replica choice, liveness) -> pack into
per-server buffer slots -> each of the S logical servers serves its slot
-> combine, plus the client's dense tier: the shared experts and, for
Arctic, the dense FFN residual that runs beside the experts
(``moe.dense_residual``).  Three execution modes, as in the reference:

* ``group=None`` — one process: the S servers are a loop (the
  reference's ``jax.vmap`` over servers);
* ``mode="a2a"`` — one rank of a mesh is one server and one client,
  ``group`` the server axis's process group: tokens sharded over it, one
  ``all_to_all`` each way (prefill);
* ``mode="replicated"`` — the activations replicated over the server
  axis: no request moves, each server serves its own slot, one
  ``all_reduce`` combines (decode).

On a mesh ``params["servers"]`` holds this rank's shard (leading dim 1)
and ``runtime.local_table`` its row (1, E).

Differentiable end to end (training): the router's sorted top-k values and
normalisation, the aux loss's ``probs.mean``, the index writes of
``dispatch.pack`` and ``expert_server.serve``, the grouped GEMM and the
combine (their autograd Functions, ``kernels/autograd.py``).  Each
server's weights are a :func:`~repro_torch.kernels.autograd.stacked_view`:
its dw goes straight into the stacked leaf's gradient.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import comm, dispatch, expert_server
from repro_torch.core import mapping as emap
from repro_torch.core import router
from repro_torch.core.expert_server import ServerWeights
from repro_torch.kernels.autograd import stacked_view
from repro_torch.models.common import dense_init_
from repro_torch.models.mlp import init_mlp, mlp


class MoERuntime(NamedTuple):
    """Runtime state of the expert-service tier: data, not structure —
    replacing these tensors re-routes traffic (failover)."""

    mapping: torch.Tensor      # (E, R) int64 candidate server per replica
    alive: torch.Tensor        # (S,) bool server liveness
    local_table: torch.Tensor  # (S, E) int64 global eid -> local slot
    num_servers: int
    capacity: int              # tokens per (client, server) slot
    dispatch_method: str = "onehot"   # "onehot" | "sort"
    # the grouped GEMMs' lowering (``ops.grouped_gemm``'s impl): "auto" the
    # kernel (the reference's xla_ragged / pallas), "dense" the capacity
    # lowering its dry-run runs (xla_dense)
    gemm_impl: str = "auto"
    # (E,) fp32 router-logit offset (scenario traffic shaping); None =
    # unbiased
    route_bias: Optional[torch.Tensor] = None
    # (S,) fp32 relative server capacities: replica picks spread tokens in
    # proportion (heterogeneous pools); None = uniform spreading
    replica_weights: Optional[torch.Tensor] = None


class MoEStats(NamedTuple):
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    dropped: torch.Tensor      # tokens over slot capacity
    miss: torch.Tensor         # tokens sent to a server not hosting them
    expert_load: torch.Tensor  # (E,) token counts (feeds the balancer)


def default_capacity(tokens_per_client: int, top_k: int, num_servers: int,
                     capacity_factor: float) -> int:
    """Paper §3.2 buffer sizing: fixed slots with capacity-factor headroom."""
    ideal = tokens_per_client * top_k / num_servers
    return max(8, int(math.ceil(ideal * capacity_factor / 8.0) * 8))


def default_runtime(cfg: ModelConfig, num_servers: int,
                    tokens_per_client: int, device, max_replicas: int = 4,
                    redundant_table=None) -> MoERuntime:
    m = cfg.moe
    table = emap.default_mapping(m.num_experts, num_servers, max_replicas)
    if redundant_table is None:
        redundant_table = np.zeros((num_servers, 0), np.int32)
    local = expert_server.make_local_table(m.num_experts, num_servers,
                                           redundant_table)
    return MoERuntime(
        mapping=torch.as_tensor(table, dtype=torch.int64, device=device),
        alive=torch.ones(num_servers, dtype=torch.bool, device=device),
        local_table=torch.as_tensor(local, dtype=torch.int64, device=device),
        num_servers=num_servers,
        capacity=default_capacity(tokens_per_client, m.top_k, num_servers,
                                  m.capacity_factor))


def init_eaas_moe(cfg: ModelConfig, num_servers: int, redundant_table,
                  dtype, device, generator, lead=()) -> Dict:
    """Router + per-server expert weights (+ shared experts), stacked over
    ``lead`` layers, and Arctic's dense residual FFN (d_model -> d_ff).
    Each server's primaries are drawn straight into the (S, L, d, f)
    layout and the redundant slots copied from them, so no global
    (E, d, f) bank is ever materialized."""
    m = cfg.moe
    d, f, E, S = cfg.d_model, m.d_expert, m.num_experts, num_servers
    red = np.asarray(redundant_table, np.int32).reshape(S, -1)
    L = E // S + red.shape[1]
    servers = {}
    for name, (a, b) in (("w_gate", (d, f)), ("w_up", (d, f)),
                         ("w_down", (f, d))):
        w = torch.empty((*lead, S, L, a, b), dtype=dtype, device=device)
        dense_init_(w[..., :E // S, :, :], generator)
        servers[name] = expert_server.fill_redundant(w, E, red)
    params = {
        "router": router.init_router(d, E, device, generator, lead),
        "servers": servers,
    }
    if m.num_shared_experts:
        params["shared"] = init_mlp(d, f * m.num_shared_experts,
                                    cfg.activation, dtype, device, generator,
                                    lead)
    if m.dense_residual:
        params["residual"] = init_mlp(d, cfg.d_ff, cfg.activation, dtype,
                                      device, generator, lead)
    return params


def client_extras(params: Dict, x: torch.Tensor, activation: str,
                  group=None) -> Optional[torch.Tensor]:
    """Shared experts + dense residual — the client-side dense FFN tier,
    summed in the reference's order (zeros + shared + residual, in x's
    dtype); None when the layer has neither.  ``group``: tensor-parallel
    over the ``model`` axis (``mlp``)."""
    extra = None
    for name in ("shared", "residual"):
        if name in params:
            y = mlp(params[name], x, activation, group)
            extra = y if extra is None else extra + y
    return extra


def eaas_moe_apply(params: Dict, x: torch.Tensor, cfg_moe: MoEConfig,
                   runtime: MoERuntime, *, activation: str = "swiglu",
                   mode: str = "local", group=None
                   ) -> Tuple[torch.Tensor, MoEStats]:
    """Apply the EAAS MoE layer to x (T, d) -> (T, d).  With ``group``
    (the server axis's process group), this rank's server and its tokens
    (the token salt of the replica choice is the rank-local index, as in
    the reference); the stats are this rank's."""
    T, d = x.shape
    S, C = runtime.num_servers, runtime.capacity
    dev = x.device

    # ---- client: route + resolve service instances ----------------------
    r = router.route(params["router"], x, cfg_moe, bias=runtime.route_bias)
    k = r.expert_ids.shape[1]
    salt = (torch.arange(T, device=dev)[:, None]
            + torch.arange(k, device=dev)[None, :])
    server_ids = emap.lookup(runtime.mapping, runtime.alive, r.expert_ids,
                             salt, weights=runtime.replica_weights)

    # ---- client: pack buffer slots (paper §3.2) --------------------------
    buffers = dispatch.pack(x, r.expert_ids, r.scores, server_ids, S, C,
                            method=runtime.dispatch_method)

    if group is not None:
        return _apply_on_mesh(params, x, r, buffers, cfg_moe, runtime,
                              activation, mode, group)

    # ---- transfer + stateless servers ------------------------------------
    hid, eid, sc, cnt = comm.send_to_servers(buffers, mode)
    sw = params["servers"]
    outs, miss = [], 0
    for s in range(S):
        w = ServerWeights(*(stacked_view(sw[n], s)
                            for n in ("w_gate", "w_up", "w_down")),
                          runtime.local_table[s])
        out, st = expert_server.serve(hid[s][None], eid[s][None],
                                      sc[s][None], cnt[s][None], w,
                                      impl=runtime.gemm_impl)
        outs.append(out[0])
        miss = miss + st.miss
    result = comm.return_to_clients(outs, mode)

    # ---- client: combine + the dense tier, one kernel on the card --------
    y = dispatch.combine(result, buffers.combine_slot, out_dtype=x.dtype,
                         addend=client_extras(params, x, activation))

    stats = MoEStats(aux_loss=r.aux_loss, z_loss=r.z_loss,
                     dropped=buffers.dropped, miss=miss,
                     expert_load=router.expert_load(r.expert_ids,
                                                    cfg_moe.num_experts))
    return y, stats


def _apply_on_mesh(params: Dict, x: torch.Tensor, r, buffers, cfg_moe,
                   runtime: MoERuntime, activation: str, mode: str, group
                   ) -> Tuple[torch.Tensor, MoEStats]:
    """The SPMD branch: this rank is one server holding its shard
    (leading dim 1); ``serve`` takes the (S_src, C, d) block it received
    (a2a) or its own slot (replicated).  The combine casts to x's dtype
    before the cross-server sum, and the client extras are added after it
    (fused into the combine, replicated mode would add them S times)."""
    sw = params["servers"]
    if sw["w_gate"].shape[0] != 1 or runtime.local_table.shape[0] != 1:
        raise ValueError("on a mesh the MoE layer takes this rank's server "
                         "shard (leading dim 1) and local_table row")
    w = ServerWeights(*(stacked_view(sw[n], 0)
                        for n in ("w_gate", "w_up", "w_down")),
                      runtime.local_table[0])
    hid, eid, sc, cnt = comm.send_to_servers(buffers, mode, group)
    out, st = expert_server.serve(hid, eid, sc, cnt, w,
                                  impl=runtime.gemm_impl)
    result = comm.return_to_clients(out, mode, group)
    slots = buffers.combine_slot
    if mode == "replicated":             # result: this server's (1, C, d)
        slots = comm.own_slots(slots, runtime.capacity, group)
    y = dispatch.combine(result, slots, out_dtype=x.dtype)
    y = comm.finalize_combine(y, mode, group)
    extra = client_extras(params, x, activation)
    if extra is not None:
        y = y + extra
    stats = MoEStats(aux_loss=r.aux_loss, z_loss=r.z_loss,
                     dropped=buffers.dropped, miss=st.miss,
                     expert_load=router.expert_load(r.expert_ids,
                                                    cfg_moe.num_experts))
    return y, stats
