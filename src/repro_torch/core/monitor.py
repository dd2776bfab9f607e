"""Control plane: the heartbeat monitor (paper §3.4, Fig. 6) — the
reference's ``core/monitor.py::Monitor``.

Pure host-side logic with injected time (deterministic, no wall clock).
Every worker heartbeats the monitor; on a missed heartbeat it notifies the
subscribers: clients mask the dead server out of their expert->server
mapping (``ServerPool.server_failed``).  Recovery is a new registration —
no group rebuild.  The paper's shared buffer (``SharedBuffer``) belongs to
the disaggregated engine and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Set, Tuple


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
