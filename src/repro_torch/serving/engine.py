"""Continuous-batching serving engine — the orchestration layer.

:class:`ServingEngine` wires :class:`~repro_torch.serving.scheduler
.Scheduler` -> :class:`~repro_torch.serving.executor.Executor` -> metrics
around a :class:`~repro_torch.serving.clock.Clock`, and keeps the EAAS
failover control: a server failure is a liveness-mask update in the
expert->server mapping, so the next step routes around the dead server's
experts (to their replicas) without stopping.

This slice runs ``mode="eaas"`` with ``exec_mode="lockstep"``,
``decode_mode="lockstep"`` and ``kv_mode="dense"``; other values raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.elastic import ServerPool
from repro_torch.models.transformer import build_model
from repro_torch.serving.clock import Clock, WallClock
from repro_torch.serving.executor import Executor
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.request import Request
from repro_torch.serving.sampling import sample_batch
from repro_torch.serving.scheduler import (DecodeBatch, PrefillChunk,
                                           Scheduler, SchedulerConfig)

_SUPPORTED = {"mode": "eaas", "exec_mode": "lockstep",
              "decode_mode": "lockstep", "kv_mode": "dense"}


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 256
    mode: str = "eaas"
    num_servers: int = 4
    n_redundant: int = 2
    eos_token: Optional[int] = None
    exec_mode: str = "lockstep"
    decode_mode: str = "lockstep"
    kv_mode: str = "dense"
    # dispatch-buffer sizing (tokens per client step); default max_batch.
    # A whole-prompt prefill of P tokens drops tokens unless this is >= P.
    pool_tokens_per_client: Optional[int] = None


def resolve_device(device=None) -> torch.device:
    """The card unless the caller names a device; no silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port serves on the GPU — pass device='cpu' "
            "to run the kernels' plain versions on the CPU")
    return torch.device("cuda")


class ServingEngine:
    """Scheduler -> executor -> metrics orchestrator with EAAS failover."""

    def __init__(self, cfg: ModelConfig, engine_cfg: EngineConfig,
                 params=None, seed: int = 0, clock: Optional[Clock] = None,
                 device=None):
        for name, value in _SUPPORTED.items():
            if getattr(engine_cfg, name) != value:
                raise NotImplementedError(
                    f"{name}={getattr(engine_cfg, name)!r} is not ported "
                    f"(this engine runs {name}={value!r})")
        self.cfg = cfg
        self.ecfg = engine_cfg
        self.device = resolve_device(device)
        self.clk = clock if clock is not None else WallClock()
        S = engine_cfg.num_servers
        self.pool = None
        if cfg.moe:
            self.pool = ServerPool(
                cfg, S,
                tokens_per_client=(engine_cfg.pool_tokens_per_client
                                   or engine_cfg.max_batch),
                n_redundant=engine_cfg.n_redundant)
        self.model = build_model(
            cfg, S, self.pool.redundant_table if self.pool else None,
            self.device)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = self.model.init_params(gen)
        self.executor = Executor(self.model, params, self.pool,
                                 max_batch=engine_cfg.max_batch,
                                 max_seq=engine_cfg.max_seq,
                                 device=self.device)
        self.scheduler = Scheduler(SchedulerConfig(
            max_batch=engine_cfg.max_batch))
        self.metrics = ServingMetrics()
        self.step_idx = 0
        self.clock = 0.0

    @property
    def queue(self):
        return self.scheduler.queue

    @property
    def slots(self):
        return self.scheduler.slots

    @property
    def params(self):
        return self.executor.params

    def _alive_frac(self) -> float:
        """Alive share of the expert-server pool (EAAS failover slowdown)."""
        return float(self.pool.smap.alive.mean()) if self.pool else 1.0

    def _pool_size(self) -> int:
        return self.pool.num_servers if self.pool else 1

    # ------------------------------------------------------------- control
    def submit(self, req: Request) -> None:
        self.scheduler.submit(req)
        self.metrics.total_requests += 1

    def inject_server_failure(self, rank: int) -> None:
        """Simulated hardware failure of one expert server (paper §5.4):
        a mapping-mask update only."""
        self.metrics.events.append(
            {"t": self.clock, "event": "server_fail", "rank": rank,
             "mode": self.ecfg.mode})
        if self.pool and rank < self.pool.num_servers:
            self.pool.server_failed(rank)

    def recover_server(self, rank: int) -> None:
        self.metrics.events.append(
            {"t": self.clock, "event": "server_recover", "rank": rank})
        if self.pool and rank < self.pool.num_servers:
            self.pool.server_recovered(rank)

    # ---------------------------------------------------------------- step
    def step(self) -> None:
        """Run whatever the scheduler plans next: a prefill, a decode step
        over the ready slots, or idle."""
        self.step_idx += 1
        plan = self.scheduler.next_plan()
        if isinstance(plan, PrefillChunk):
            self._step_prefill(plan)
        elif isinstance(plan, DecodeBatch):
            self._step_decode(plan)
        else:
            self.clock += self.clk.idle()

    def _sample(self, logits: torch.Tensor, reqs, steps) -> np.ndarray:
        temps = [r.sampling.temperature for r in reqs]
        return sample_batch(logits, temps, [r.sampling.seed for r in reqs],
                            [r.request_id for r in reqs],
                            steps).cpu().numpy()

    def _step_prefill(self, plan: PrefillChunk) -> None:
        req, b = plan.request, plan.slot
        self.clk.start()
        logits = self.executor.prefill(b, plan.tokens)
        self.clock += self.clk.stop("prefill", result=logits,
                                    tokens=plan.length,
                                    servers=self._pool_size(),
                                    alive_frac=self._alive_frac())
        self.scheduler.prefill_advanced(b, plan.length)
        req.output_tokens.append(int(self._sample(logits, [req], [0])[0]))
        req.prefill_time = self.clock
        self.metrics.ttfts.append(self.clock - req.arrival_time)
        self.metrics.events.append(
            {"t": self.clock, "event": "prefill", "rid": req.request_id,
             "ttft": self.clock - req.arrival_time})

    def _step_decode(self, plan: DecodeBatch) -> None:
        sch = self.scheduler
        B = len(sch.slots)
        active = list(plan.slots)
        tokens = np.zeros((B, 1), np.int64)
        for b in active:
            tokens[b, 0] = sch.slots[b].output_tokens[-1]
        self.clk.start()
        logits, expert_load = self.executor.decode(tokens)
        if self.pool is not None:
            self.pool.observe_load(expert_load.cpu().numpy())
        dt = self.clk.stop("decode", result=logits, tokens=len(active),
                           servers=self._pool_size(),
                           alive_frac=self._alive_frac())
        self.clock += dt
        reqs = [sch.slots[b] for b in active]
        next_tokens = self._sample(logits[active], reqs,
                                   [len(r.output_tokens) for r in reqs])
        for b, r, tok in zip(active, reqs, next_tokens):
            tok = int(tok)
            r.output_tokens.append(tok)
            r.token_times.append(self.clock)
            self.metrics.total_output_tokens += 1
            done = (len(r.output_tokens) >= r.sampling.max_new_tokens or
                    (self.ecfg.eos_token is not None and
                     tok == self.ecfg.eos_token) or
                    len(r.prompt) + len(r.output_tokens) >=
                    self.ecfg.max_seq - 1)
            if done:
                r.finish_time = self.clock
                self.metrics.completed += 1
                self.metrics.itls.extend(r.itl())
                sch.release(b)
        self.metrics.timeline.append(
            {"t": self.clock, "tokens": len(active), "halted": False})

    def run(self, max_steps: int = 10_000,
            on_step: Optional[Callable[["ServingEngine"], None]] = None
            ) -> ServingMetrics:
        """Drive until queue + slots drain (or max_steps)."""
        while (self.queue or any(s is not None for s in self.slots)) \
                and self.step_idx < max_steps:
            if on_step:
                on_step(self)
            self.step()
        self.metrics.wall_time = self.clock
        return self.metrics
