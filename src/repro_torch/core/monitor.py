"""Control plane: the heartbeat monitor (paper §3.4, Fig. 6) and the
paper's shared buffer (§3.2) — the reference's ``core/monitor.py``.

The monitor is pure host-side logic with injected time (deterministic, no
wall clock).  Every worker heartbeats it; on a missed heartbeat it notifies
the subscribers: servers release the dead client's buffer slot (state ->
OFFLINE), clients mask the dead server out of their expert->server mapping
(``ServerPool.server_failed``).  Recovery is a new registration — no group
rebuild.

:class:`SharedBuffer` is one (client, server) slot of the disaggregated
tier (``serving/disaggregated.py``): its state flag and header are host
ints, as in the reference; its payload is tensors on an explicit device —
on the card, device memory, which is where the paper's one-sided RDMA
writes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Set, Tuple

import torch

from repro_torch.core.types import (STATE_CLIENT_WRITE_DONE, STATE_EMPTY,
                                    STATE_OFFLINE, STATE_SERVER_DONE)


@dataclass
class WorkerInfo:
    worker_id: str
    kind: str                      # "client" | "server"
    last_heartbeat: float = 0.0
    alive: bool = True
    # servers: which experts this worker hosts (global ids)
    experts: Tuple[int, ...] = ()
    server_rank: int = -1


@dataclass
class Event:
    t: float
    kind: str
    detail: str


class Monitor:
    """Central health tracker (ZooKeeper-style, paper §4.4)."""

    def __init__(self, heartbeat_timeout: float = 3.0):
        self.timeout = heartbeat_timeout
        self.workers: Dict[str, WorkerInfo] = {}
        self.events: List[Event] = []
        self._on_server_down: List[Callable[[int], None]] = []
        self._on_client_down: List[Callable[[str], None]] = []
        self._on_server_up: List[Callable[[WorkerInfo], None]] = []

    # ------------------------------------------------------------ wiring
    def subscribe_server_down(self, fn: Callable[[int], None]) -> None:
        self._on_server_down.append(fn)

    def subscribe_client_down(self, fn: Callable[[str], None]) -> None:
        self._on_client_down.append(fn)

    def subscribe_server_up(self, fn: Callable[[WorkerInfo], None]) -> None:
        self._on_server_up.append(fn)

    # ---------------------------------------------------------- protocol
    def register(self, worker_id: str, kind: str, t: float,
                 experts: Tuple[int, ...] = (), server_rank: int = -1) -> None:
        info = WorkerInfo(worker_id, kind, t, True, tuple(experts),
                          server_rank)
        is_new = worker_id not in self.workers or not self.workers[worker_id].alive
        self.workers[worker_id] = info
        self.events.append(Event(t, "register", worker_id))
        if kind == "server" and is_new:
            for fn in self._on_server_up:
                fn(info)

    def heartbeat(self, worker_id: str, t: float) -> None:
        w = self.workers.get(worker_id)
        if w is not None and w.alive:
            w.last_heartbeat = t

    def tick(self, t: float) -> List[str]:
        """Detect timeouts; notify subscribers.  Returns newly-dead ids."""
        dead = []
        for w in self.workers.values():
            if w.alive and t - w.last_heartbeat > self.timeout:
                w.alive = False
                dead.append(w.worker_id)
                self.events.append(Event(t, "dead", w.worker_id))
                if w.kind == "server":
                    for fn in self._on_server_down:
                        fn(w.server_rank)
                else:
                    for fn in self._on_client_down:
                        fn(w.worker_id)
        return dead

    def alive_servers(self) -> Set[int]:
        return {w.server_rank for w in self.workers.values()
                if w.kind == "server" and w.alive}


class SharedBuffer:
    """The literal paper §3.2 buffer for one (client, server) pair.

    One-sided semantics: only the client calls ``write_request`` /
    ``try_read_result``; only the server calls ``poll`` / ``take_request``
    / ``write_result``.  ``state``, ``layer_id`` and ``count`` are host
    ints; the payload lives on ``device`` (float32 by default, as the
    reference's); a request or result is copied in, cast to the slot's
    dtype.
    """

    def __init__(self, capacity: int, d_model: int, dtype=torch.float32,
                 device="cpu"):
        self.state = STATE_EMPTY
        self.layer_id = -1
        self.count = 0
        self.hidden = torch.zeros((capacity, d_model), dtype=dtype,
                                  device=device)
        self.expert_id = torch.full((capacity,), -1, dtype=torch.int32,
                                    device=device)
        self.score = torch.zeros((capacity,), dtype=torch.float32,
                                 device=device)
        self.result = torch.zeros((capacity, d_model), dtype=dtype,
                                  device=device)

    # client side (one-sided writes / reads)
    def write_request(self, layer_id: int, hidden, expert_id, score) -> None:
        assert self.state == STATE_EMPTY, f"slot busy (state={self.state})"
        n = len(hidden)
        self.layer_id = layer_id
        self.count = n
        self.hidden[:n].copy_(torch.as_tensor(hidden))
        self.expert_id[:n].copy_(torch.as_tensor(expert_id))
        self.score[:n].copy_(torch.as_tensor(score))
        self.state = STATE_CLIENT_WRITE_DONE        # flag write is the fence

    def try_read_result(self):
        if self.state != STATE_SERVER_DONE:
            return None
        out = self.result[:self.count].clone()
        self.state = STATE_EMPTY
        return out

    # server side (never initiates communication — just polls its memory)
    def poll(self) -> bool:
        return self.state == STATE_CLIENT_WRITE_DONE

    def take_request(self):
        assert self.poll()
        return (self.layer_id, self.hidden[:self.count],
                self.expert_id[:self.count], self.score[:self.count])

    def write_result(self, result) -> None:
        self.result[:self.count].copy_(torch.as_tensor(result))
        self.state = STATE_SERVER_DONE

    def release(self) -> None:
        """Monitor told the server this client is gone (paper Fig. 6 ①)."""
        self.state = STATE_OFFLINE
