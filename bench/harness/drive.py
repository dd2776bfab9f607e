"""The open loop around ``repro_torch``'s serving engine.

The harness submits each request when it is due (``ServingEngine.submit``)
and calls ``step()`` while there is work, timing every step and every
token by its own ``time.perf_counter()``: under ``WallClock`` a step
synchronizes the card before it returns, so a token is out when ``step``
returns.  The engine's clock and ``ServingMetrics`` are not read.  What the
engine records per step is: whether it decoded (its timeline grows by one
entry, with the live slots), and which request's prefill advanced
(``scheduler.cache_length``), with how many prompt tokens
(``scheduler.pending_prefill_tokens``).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List

from harness import flops


@dataclass
class Step:
    kind: str                  # "prefill" | "decode" | "idle"
    t0: float
    t1: float
    live: int = 0              # decode: live slots
    tokens: int = 0            # prompt tokens prefilled, or rows decoded
    flops: float = 0.0
    traced: bool = False


@dataclass
class Track:
    due: float                 # perf_counter time it was due
    prompt_len: int
    times: List[float] = field(default_factory=list)
    done: bool = False


class Driver:
    """Drives one engine and records what it did, by the harness's clock."""

    def __init__(self, engine, m: dict):
        self.engine = engine
        self.sch = engine.scheduler
        self.m = m
        self.steps: List[Step] = []
        self.tracks: Dict[int, Track] = {}
        self.reqs: Dict[int, object] = {}
        self.tracer = None

    def _span(self, name: str):
        if self.tracer is not None and self.tracer.active:
            from torch.profiler import record_function
            return record_function(name)
        return contextlib.nullcontext()

    def submit(self, req, due: float) -> None:
        with self._span("submit"):
            self.engine.submit(req)
        self.tracks[req.request_id] = Track(due, len(req.prompt))
        self.reqs[req.request_id] = req

    def clear(self) -> None:
        """Forget every request and step recorded so far."""
        self.tracks.clear()
        self.reqs.clear()
        self.steps.clear()

    def has_work(self) -> bool:
        return bool(self.sch.queue) or any(
            r is not None for r in self.sch.slots)

    def step(self) -> Step:
        sch, eng = self.sch, self.engine
        # each live request's cached tokens and output tokens
        before = {r.request_id: (sch.cache_length(b), len(r.output_tokens))
                  for b, r in enumerate(sch.slots) if r is not None}
        n_tl = len(eng.metrics.timeline)
        pend = sch.pending_prefill_tokens()
        traced = self.tracer is not None and self.tracer.active
        with self._span("engine.step"):
            t0 = time.perf_counter()
            eng.step()
            t1 = time.perf_counter()
        st = Step("idle", t0, t1, traced=traced)
        seen = set(before)
        seen.update(r.request_id for r in sch.slots if r is not None)
        if len(eng.metrics.timeline) > n_tl:
            st.kind = "decode"
            st.live = int(eng.metrics.timeline[-1]["tokens"])
            st.tokens = st.live
            for rid, (_, n0) in before.items():
                if len(self.reqs[rid].output_tokens) > n0:
                    st.flops += flops.token_flops(
                        self.m, self.tracks[rid].prompt_len + n0, True)
        else:
            done = pend - sch.pending_prefill_tokens()
            if done > 0:
                st.kind = "prefill"
                st.tokens = done
                for b, r in enumerate(sch.slots):
                    if r is None:
                        continue
                    start = before.get(r.request_id, (0, 0))[0]
                    if sch.cache_length(b) != start or (
                            r.request_id not in before and r.output_tokens):
                        st.flops = flops.chunk_flops(
                            self.m, start, done,
                            head=bool(r.output_tokens))
                        break
        if traced:
            self.tracer.step_kinds.append(st.kind)
        for rid in seen:
            r, tk = self.reqs[rid], self.tracks[rid]
            new = len(r.output_tokens) - len(tk.times)
            tk.times.extend([t1] * new)
            if r.finish_time is not None:
                tk.done = True
        self.steps.append(st)
        return st

    def serve(self, items, t_sched0: float, t_end: float, make_request,
              on_tick=None) -> int:
        """Serve ``items`` (due at ``t_sched0 + item.due``) until
        ``t_end``; returns how many were submitted.  ``on_tick(now)`` runs
        between steps (the tracer's start and stop)."""
        i = 0
        n = len(items)
        while True:
            now = time.perf_counter()
            if on_tick is not None:
                on_tick(now)
            if now >= t_end:
                return i
            while i < n and t_sched0 + items[i].due <= now:
                it = items[i]
                self.submit(make_request(it), t_sched0 + it.due)
                i += 1
            if self.has_work():
                self.step()
            else:
                nxt = t_sched0 + items[i].due if i < n else t_end
                with self._span("wait"):
                    time.sleep(max(0.0, min(nxt, t_end) - time.perf_counter()))

    def drain(self) -> None:
        """Step until every submitted request is done (the warm-up)."""
        while self.has_work():
            self.step()


# ------------------------------------------------------------- the metrics

def output_tokens(tracks, ws: float, we: float) -> int:
    return sum(sum(1 for t in tk.times if ws <= t <= we)
               for tk in tracks.values())


def ttfts(tracks, ws: float, we: float) -> List[float]:
    """Seconds from due to first token of every request due inside the
    window; one with no first token by the window's end counts its wait
    so far."""
    out = []
    for tk in tracks.values():
        if ws <= tk.due < we:
            first = tk.times[0] if tk.times else None
            out.append((first if first is not None and first <= we
                        else we) - tk.due)
    return out


def itls(tracks, ws: float, we: float) -> List[float]:
    """Every gap between consecutive tokens of a request that ends inside
    the window, and the open gap, up to the window's end, of every
    request still decoding there."""
    out = []
    for tk in tracks.values():
        ts = [t for t in tk.times if t <= we]
        out.extend(b - a for a, b in zip(ts, ts[1:]) if b >= ws)
        finished_in = tk.done and len(ts) == len(tk.times)
        if ts and not finished_in:
            out.append(we - ts[-1])
    return out


def prefill_ms_per_ktok(steps) -> float | None:
    """Milliseconds of the prefill steps among ``steps`` per 1,000 prompt
    tokens they prefilled (None for none)."""
    pre = [s for s in steps if s.kind == "prefill"]
    tokens = sum(s.tokens for s in pre)
    if not tokens:
        return None
    return 1000.0 * 1000.0 * sum(s.t1 - s.t0 for s in pre) / tokens


def window_steps(steps, ws: float, we: float) -> List[Step]:
    return [s for s in steps if s.t0 >= ws and s.t1 <= we]
