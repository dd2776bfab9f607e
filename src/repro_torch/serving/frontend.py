"""Front-end request routing over N attention clients (paper §3.1) — the
reference's ``serving/frontend.py``.

EAAS disaggregates attention clients from the expert tier, so "the system"
is M stateless-ish clients fanning into one shared pool of expert servers —
and *request* routing across clients becomes its own policy surface,
orthogonal to the *expert* routing the MoE layer does per token.  A
:class:`FrontendRouter` picks the client for each arriving request; the
:class:`~repro_torch.serving.cluster.Cluster` filters the candidate set first
(alive + under the admission backpressure limit) and holds requests in its
ingress queue when nobody is admissible.

Policies (all deterministic — pure functions of the request stream and the
observable client state, so seeded cluster runs fingerprint-identically):

* ``round_robin``      — cycle over the client ring, skipping inadmissible
  clients; the fairness baseline.
* ``least_loaded``     — score each candidate by its unprefilled prompt
  backlog minus its free KV capacity (both in tokens): the client with the
  most headroom wins, ties to the lowest index.  This is the signal pair
  the autoscaler also watches — queue pressure *and* attention-tier
  memory.
* ``session_affinity`` — hash the prompt's leading block to a home client,
  so shared-prefix traffic (multi-tenant system prompts) lands on the
  client whose BlockPool already caches the prefix; falls forward around
  the ring when the home client is inadmissible.
"""

from __future__ import annotations

import hashlib
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.request import Request

FRONTEND_POLICIES = ("round_robin", "least_loaded", "session_affinity")


class FrontendRouter:
    """Policy interface: pick one client index out of the admissible set.

    ``candidates`` is the cluster-filtered list of ``(index, engine)``
    pairs (alive, under backpressure), always non-empty, in index order.
    ``n_clients`` is the full ring size — affinity hashing must stay a
    function of the ring, not of the momentary admissible subset, or a
    transient backpressure blip would permanently re-home a prefix.
    """

    name = "base"

    def __init__(self, n_clients: int):
        self.n_clients = n_clients

    def pick(self, req: Request, candidates: Sequence[Tuple[int, object]]
             ) -> int:
        raise NotImplementedError


class RoundRobin(FrontendRouter):
    name = "round_robin"

    def __init__(self, n_clients: int):
        super().__init__(n_clients)
        self._next = 0

    def pick(self, req, candidates):
        admissible = {i for i, _ in candidates}
        for j in range(self.n_clients):
            idx = (self._next + j) % self.n_clients
            if idx in admissible:
                self._next = (idx + 1) % self.n_clients
                return idx
        raise AssertionError("pick() called with no admissible client")


class LeastLoaded(FrontendRouter):
    name = "least_loaded"

    def pick(self, req, candidates):
        def score(item):
            idx, eng = item
            # both terms are token-denominated: outstanding prefill work
            # the client still owes vs. KV capacity it can still admit into
            return (eng.pending_prefill_tokens() - eng.free_kv_tokens(),
                    idx)
        return min(candidates, key=score)[0]


class SessionAffinity(FrontendRouter):
    name = "session_affinity"

    def __init__(self, n_clients: int, block_size: int = 16):
        super().__init__(n_clients)
        self.block_size = max(int(block_size), 1)

    def home(self, prompt: np.ndarray) -> int:
        """The prompt's home client: hash of its leading block (the same
        unit the BlockPool prefix cache keys on, so requests that would
        share cached blocks share a home)."""
        head = np.asarray(prompt[:self.block_size], np.int32)
        h = hashlib.sha256(head.tobytes()).digest()
        return int.from_bytes(h[:8], "big") % self.n_clients

    def pick(self, req, candidates):
        admissible = {i for i, _ in candidates}
        home = self.home(req.prompt)
        for j in range(self.n_clients):
            idx = (home + j) % self.n_clients
            if idx in admissible:
                return idx
        raise AssertionError("pick() called with no admissible client")


def make_frontend_router(policy: str, n_clients: int,
                         block_size: Optional[int] = None) -> FrontendRouter:
    if policy == "round_robin":
        return RoundRobin(n_clients)
    if policy == "least_loaded":
        return LeastLoaded(n_clients)
    if policy == "session_affinity":
        return SessionAffinity(n_clients, block_size=block_size or 16)
    raise ValueError(f"unknown frontend policy {policy!r}; expected one of "
                     f"{FRONTEND_POLICIES}")
