"""EaasMoELayer — the paper's contribution, local (single-device) mode.

router -> mapping lookup (replica choice, liveness) -> pack into
per-server buffer slots -> each of the S logical servers serves its slot
(a loop: the reference's ``jax.vmap`` over servers) -> combine, plus the
shared experts on the client.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core import comm, dispatch, expert_server
from repro_torch.core import mapping as emap
from repro_torch.core import router
from repro_torch.core.expert_server import ServerWeights
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
    ``lead`` layers.  Each server's primaries are drawn straight into the
    (S, L, d, f) layout and the redundant slots copied from them, so no
    global (E, d, f) bank is ever materialized."""
    m = cfg.moe
    if m.dense_residual:
        raise NotImplementedError("dense-residual MoE is not ported")
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
    return params


def eaas_moe_apply(params: Dict, x: torch.Tensor, cfg_moe: MoEConfig,
                   runtime: MoERuntime, *, activation: str = "swiglu",
                   mode: str = "local") -> Tuple[torch.Tensor, MoEStats]:
    """Apply the EAAS MoE layer to x (T, d) -> (T, d)."""
    T, d = x.shape
    S, C = runtime.num_servers, runtime.capacity
    dev = x.device

    # ---- client: route + resolve service instances ----------------------
    r = router.route(params["router"], x, cfg_moe)
    k = r.expert_ids.shape[1]
    salt = (torch.arange(T, device=dev)[:, None]
            + torch.arange(k, device=dev)[None, :])
    server_ids = emap.lookup(runtime.mapping, runtime.alive, r.expert_ids,
                             salt)

    # ---- client: pack buffer slots (paper §3.2) --------------------------
    buffers = dispatch.pack(x, r.expert_ids, r.scores, server_ids, S, C,
                            method=runtime.dispatch_method)

    # ---- transfer + stateless servers ------------------------------------
    hid, eid, sc, cnt = comm.send_to_servers(buffers, mode)
    sw = params["servers"]
    outs, miss = [], 0
    for s in range(S):
        w = ServerWeights(sw["w_gate"][s], sw["w_up"][s], sw["w_down"][s],
                          runtime.local_table[s])
        out, st = expert_server.serve(hid[s][None], eid[s][None],
                                      sc[s][None], cnt[s][None], w)
        outs.append(out[0])
        miss = miss + st.miss
    result = comm.return_to_clients(torch.stack(outs), mode)

    # ---- client: combine (+ shared experts) ------------------------------
    y = dispatch.combine(result, buffers.combine_slot, out_dtype=x.dtype)
    if "shared" in params:
        y = y + mlp(params["shared"], x, activation)

    stats = MoEStats(aux_loss=r.aux_loss, z_loss=r.z_loss,
                     dropped=buffers.dropped, miss=miss,
                     expert_load=router.expert_load(r.expert_ids,
                                                    cfg_moe.num_experts))
    return y, stats
