"""Physically-disaggregated serving: the paper's client/server protocol,
literally (§3.2–§3.4, Fig. 5–7) — the reference's
``serving/disaggregated.py``.

Attention clients and expert servers are independent actors that interact
ONLY through :class:`~repro_torch.core.monitor.SharedBuffer` slots (state
flag + header + payload) — the model of one-sided RDMA.  The server never
initiates communication: it polls its buffer slots, aggregates every ready
request into one dynamic batch, reorganizes tokens by expert, runs the
grouped expert computation (``ops.grouped_gemm``: the CUDA kernel on the
card), writes results back and flips the flags.

Failure handling is the paper's dual path: the monitor's heartbeat timeout
(path ①) or the client's own request timeout (path ②(b)) — whichever
fires first masks the server out of the client's mapping and the request is
re-sent to a replica.

Deterministic cooperative scheduling (``tick()``) keeps runs replayable.
The protocol — routing, replica choice, slots, timeouts, retries — is the
reference's host logic, so retries, batches and served tokens are its
exactly; the payloads and the expert compute live on the device.

The server feeds its float32 payload to the grouped GEMM against the
weights as they are, as the reference feeds ``lax.ragged_dot``: bf16
weights meet float32 rows in a float32 product (on the card the kernel's
widening route).

A repair: a row of an expert the server does not host (a failed
server's expert with no live replica falls back to server 0) is sorted
last, past the hosted groups, and gets 0.  The reference sorts it first
and so shifts every hosted row onto the wrong expert (ROADMAP Queue 3,
``tests/test_torch_disaggregated.py::test_unhosted_*``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import mapping as emap
from repro_torch.core.expert_server import init_expert_weights
from repro_torch.core.load_balance import eplb_plan, primary_owner
from repro_torch.core.monitor import SharedBuffer
from repro_torch.core.router import init_router, route
from repro_torch.core.types import STATE_EMPTY, STATE_SERVER_DONE
from repro_torch.kernels import ops
from repro_torch.models.common import resolve_dtype


class ExpertServerProc:
    """A stateless expert service instance (paper §3.3)."""

    def __init__(self, rank: int, cfg: ModelConfig, bank: Dict,
                 expert_ids: List[int], capacity: int, d_model: int,
                 min_batch: int = 1, slow_factor: int = 1):
        self.rank = rank
        self.cfg = cfg
        self.expert_ids = list(expert_ids)
        self.device = bank["w_gate"].device
        # global expert id -> local group (-1 = not hosted), on the device
        local = np.full(cfg.moe.num_experts, -1, np.int64)
        for i, e in enumerate(self.expert_ids):
            if local[e] < 0:
                local[e] = i
        self.local_table = torch.as_tensor(local, device=self.device)
        idx = torch.as_tensor(self.expert_ids, device=self.device)
        self.w_gate = bank["w_gate"][idx]
        self.w_up = bank["w_up"][idx]
        self.w_down = bank["w_down"][idx]
        self.buffers: Dict[str, SharedBuffer] = {}
        self.capacity = capacity
        self.d_model = d_model
        self.min_batch = min_batch
        # straggler knob: serve only every Nth tick (1 = full speed); the
        # cooperative-tick analogue of AsyncExpertTier.set_slowdown
        self.slow_factor = max(1, int(slow_factor))
        self.alive = True
        self.served_tokens = 0
        self.batches = 0
        self._ticks = 0

    # registration: a client attaches a buffer (paper §4.4 connection setup)
    def attach_client(self, client_id: str) -> SharedBuffer:
        buf = SharedBuffer(self.capacity, self.d_model, device=self.device)
        self.buffers[client_id] = buf
        return buf

    def release_client(self, client_id: str) -> None:
        if client_id in self.buffers:
            self.buffers[client_id].release()

    def tick(self) -> None:
        """Poll flags; aggregate ready slots into ONE dynamic batch.  A
        straggling server (``slow_factor`` > 1) skips all but every Nth
        tick — requests sit in its buffers until the clients' timeout
        path re-routes them to replicas."""
        if not self.alive:
            return
        self._ticks += 1
        if self._ticks % self.slow_factor:
            return
        ready = [b for b in self.buffers.values() if b.poll()]
        if len(ready) < self.min_batch:
            return
        reqs = [b.take_request() for b in ready]
        x = torch.cat([h for _, h, _, _ in reqs])                 # (M, d)
        eids = torch.cat([e for _, _, e, _ in reqs]).long()
        scores = torch.cat([s for _, _, _, s in reqs])
        out = self.compute(x, eids, scores)
        off = 0
        for b in ready:
            b.write_result(out[off:off + b.count])
            off += b.count
        self.served_tokens += int(x.shape[0])
        self.batches += 1

    @torch.inference_mode()
    def compute(self, x: torch.Tensor, eids: torch.Tensor,
                scores: torch.Tensor) -> torch.Tensor:
        """One dynamic batch: reorganize by local expert (a stable sort,
        unhosted rows last as group L, the padding group, as
        ``core/expert_server.py::serve`` sorts them), three grouped GEMMs
        over the L hosted groups, SiLU·up, un-sort, score weighting,
        unhosted rows zeroed -> (M, d) fp32 (module docstring)."""
        L = len(self.expert_ids)
        slot = self.local_table[eids]
        slot = torch.where(slot >= 0, slot, L)
        order = torch.argsort(slot, stable=True)
        sizes = torch.bincount(slot, minlength=L + 1)[:L]
        xs = x[order]
        h1 = ops.grouped_gemm(xs, self.w_gate, sizes)
        h2 = ops.grouped_gemm(xs, self.w_up, sizes)
        h = F.silu(h1.float()).to(h2.dtype) * h2
        y = ops.grouped_gemm(h, self.w_down, sizes)
        out = torch.empty((x.shape[0], self.d_model), dtype=torch.float32,
                          device=x.device)
        out[order] = y.float()
        out *= scores[:, None]                                    # score-weight
        return torch.where((slot < L)[:, None], out, 0.0)         # not hosted


@dataclass
class _Pending:
    server: int
    buf: SharedBuffer
    rows: np.ndarray          # (n,) flat indices into (T*k)
    sent_tick: int


class AttentionClientProc:
    """The MoE-layer client side: route -> write slots -> poll -> combine."""

    def __init__(self, client_id: str, cfg: ModelConfig,
                 router_w: torch.Tensor, smap: emap.ExpertServerMap,
                 servers: List[ExpertServerProc], timeout_ticks: int = 3):
        self.client_id = client_id
        self.cfg = cfg
        self.router_w = router_w
        self.device = router_w.device
        self.smap = smap
        self.servers = servers
        self.timeout = timeout_ticks
        self.buffers = {s.rank: s.attach_client(client_id) for s in servers}
        self.tick_now = 0
        self.retries = 0

    def _route(self, x: torch.Tensor):
        return route({"w_router": self.router_w}, x, self.cfg.moe)

    @torch.inference_mode()
    def moe_layer(self, x, drive) -> torch.Tensor:
        """One full MoE layer through the disaggregated tier: x (T, d), a
        tensor or a host array -> (T, d) fp32 on the client's device.

        ``drive()`` advances servers one tick (the cooperative scheduler).
        Event loop: route unsent rows to alive servers whose slot is free
        (one outstanding request per (client, server) slot — the paper's
        fixed buffer); poll pendings; a response timeout masks the server
        out of the mapping and its rows are re-routed (paper Fig. 6 ②(b)).
        """
        x = torch.as_tensor(x, device=self.device)
        T, d = x.shape
        k = self.cfg.moe.top_k
        r = self._route(x)
        eids_dev = r.expert_ids.reshape(-1)
        scores = r.scores.reshape(-1)
        eids = eids_dev.cpu().numpy()             # the host's routing copy
        out = torch.zeros((T, d), dtype=torch.float32, device=self.device)

        unsent = np.arange(T * k)
        pending: List[_Pending] = []
        guard = 0
        while (len(unsent) or pending) and guard < 200:
            guard += 1
            # ---- send phase -------------------------------------------
            if len(unsent):
                table, alive = self.smap.device_arrays("cpu")
                sel = emap.lookup(
                    table, alive, torch.as_tensor(eids[unsent])[:, None],
                    torch.as_tensor(unsent % 1024)[:, None])[:, 0].numpy()
                still_unsent = []
                busy = {p.server for p in pending}
                for s in sorted(set(sel.tolist())):
                    rows = unsent[sel == s]
                    buf = self.buffers[s]
                    if s in busy:
                        still_unsent.extend(rows)      # slot occupied: wait
                        continue
                    if buf.state == STATE_SERVER_DONE:   # stale result: drain
                        buf.try_read_result()
                    if buf.state != STATE_EMPTY:       # stuck slot -> dead
                        self.smap.mark_dead(s)
                        self.retries += 1
                        still_unsent.extend(rows)
                        continue
                    idx = torch.as_tensor(rows, device=self.device)
                    buf.write_request(0, x[idx // k], eids_dev[idx],
                                      scores[idx])
                    pending.append(_Pending(s, buf, rows, self.tick_now))
                unsent = np.asarray(still_unsent, dtype=np.int64)
            # ---- poll phase -------------------------------------------
            drive()
            self.tick_now += 1
            still = []
            for p in pending:
                res = p.buf.try_read_result()
                if res is not None:
                    _accumulate(out, p.rows // k, res)
                elif self.tick_now - p.sent_tick > self.timeout:
                    # paper Fig.6 ②(b): timeout -> mask server, re-route
                    self.smap.mark_dead(p.server)
                    self.retries += 1
                    unsent = np.concatenate([unsent, p.rows])
                else:
                    still.append(p)
            pending = still
        assert not (len(unsent) or pending), "requests stuck: no live replica"
        return out


def _accumulate(out: torch.Tensor, tokens: np.ndarray,
                res: torch.Tensor) -> None:
    """``out[tokens[i]] += res[i]`` in row order, as the reference's loop:
    a token's second row of one response is added after its first, in
    passes of distinct tokens (no atomics, so the card's sums are the
    host's)."""
    first = {}
    rank = np.empty(len(tokens), np.int64)
    for i, t in enumerate(tokens.tolist()):
        rank[i] = first.get(t, 0)
        first[t] = rank[i] + 1
    for j in range(int(rank.max()) + 1 if len(rank) else 0):
        sel = np.flatnonzero(rank == j)
        idx = torch.as_tensor(sel, device=out.device)
        tok = torch.as_tensor(tokens[sel], device=out.device)
        out[tok] += res[idx]


def build_cluster(cfg: ModelConfig, n_clients: int, n_servers: int,
                  n_redundant: int = 2, capacity: int = 512, seed: int = 0,
                  *, device=None, generator: Optional[torch.Generator] = None,
                  bank: Optional[Dict] = None,
                  router_w: Optional[torch.Tensor] = None):
    """Wire up a disaggregated cluster over one weight bank on ``device``.

    ``bank`` (the global (E, d, f) expert weights) and ``router_w`` are
    drawn from ``generator`` (seeded with ``seed`` if None) unless given —
    the parity tests pass the reference's through ``repro_torch.bridge``.
    Each server stacks its hosted experts out of the bank.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the kernels' plain versions on the CPU")
        device = "cuda"
    device = torch.device(device)
    m = cfg.moe
    gen = generator
    if gen is None and (bank is None or router_w is None):
        gen = torch.Generator(device=device).manual_seed(seed)
    if bank is None:
        bank = init_expert_weights(cfg, resolve_dtype(cfg.dtype), device,
                                   gen)
    mapping, red = eplb_plan(np.ones(m.num_experts), n_servers, n_redundant)
    smap = emap.ExpertServerMap(mapping, n_servers)
    owner = primary_owner(m.num_experts, n_servers)
    servers = []
    for s in range(n_servers):
        hosted = [int(e) for e in np.where(owner == s)[0]] + \
            [int(e) for e in red[s] if e >= 0]
        servers.append(ExpertServerProc(s, cfg, bank, hosted, capacity,
                                        cfg.d_model))
    if router_w is None:
        router_w = init_router(cfg.d_model, m.num_experts, device,
                               gen)["w_router"]
    router_w = router_w.to(device)
    clients = [AttentionClientProc(f"client{i}", cfg, router_w, smap,
                                   servers) for i in range(n_clients)]
    return clients, servers, smap, bank
