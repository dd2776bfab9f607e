"""The device trace of a steady stretch of the window (``--trace 1``).

``torch.profiler`` (CUPTI) records the device's kernels and copies and the
harness's own host spans (``submit``, ``engine.step``, ``wait``), kept in
memory: no trace file is written.  From them: the device's busy seconds
(the union of its activity), kernel time by name, and the idle gaps
labelled by the host span that covers them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

HOST_SPANS = ("submit", "engine.step", "wait")


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


class Tracer:
    """Start and stop the profiler around a stretch; :meth:`result` reads
    what it recorded."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.t0 = self.t1 = None
        self.step_kinds: List[str] = []

    @property
    def active(self) -> bool:
        return self.prof is not None and self.t1 is None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def prime(self) -> None:
        """Start and stop the profiler once during set-up: its first start
        initialises the tracing library, which takes seconds."""
        p = self._profile()
        p.start()
        torch.ones(1, device="cuda" if self.cuda else "cpu").add_(1)
        p.stop()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()

    def result(self) -> Dict:
        """Kernels and copies (name, start ns, duration ns), the busy
        seconds, the traced span in seconds, and the host spans (label,
        start ns, end ns), each ``engine.step`` labelled by the kind of
        step it was.  A span's image on the device's timeline (a user
        annotation) is neither device work nor a host span."""
        events = self.prof.profiler.kineto_results.events()
        dev, host = [], []
        kinds = iter(self.step_kinds)
        cuda, cpu = (torch.autograd.DeviceType.CUDA,
                     torch.autograd.DeviceType.CPU)
        for ev in events:
            dt = ev.device_type()
            if dt == cuda and not _annotation(ev):
                d = _ns(ev, "duration")
                if d > 0:
                    dev.append((ev.name(), _ns(ev, "start"), d))
            elif dt == cpu and ev.name() in HOST_SPANS:
                host.append([ev.name(), _ns(ev, "start"),
                             _ns(ev, "start") + _ns(ev, "duration")])
        host.sort(key=lambda h: h[1])
        for h in host:
            if h[0] == "engine.step":
                h[0] = "engine.step:" + next(kinds, "unknown")
        dev.sort(key=lambda k: k[1])
        segs = _union(dev)
        busy = sum(b - a for a, b in segs) / 1e9
        return {"kernels": dev, "busy_s": busy,
                "span_s": self.t1 - self.t0, "segments": segs,
                "host": host}


def _annotation(ev) -> bool:
    """A ``record_function`` span's image on a device stream."""
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else ev.name() in HOST_SPANS


def _union(dev) -> List[Tuple[int, int]]:
    segs: List[List[int]] = []
    for _, s, d in dev:
        e = s + d
        if segs and s <= segs[-1][1]:
            segs[-1][1] = max(segs[-1][1], e)
        else:
            segs.append([s, e])
    return [(a, b) for a, b in segs]


def breakdown(tr: Dict, top: int = 10) -> Dict:
    """The device operations that took most time, and the longest idle
    gaps, each labelled by the host span it fell in."""
    by: Dict[str, int] = {}
    for name, _, d in tr["kernels"]:
        by[name] = by.get(name, 0) + d
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    segs, host = tr["segments"], tr["host"]
    gaps = []
    for (_, e), (s, _) in zip(segs, segs[1:]):
        gaps.append((s - e, e, s))
    gaps.sort(reverse=True)
    out = []
    for g, a, b in gaps[:top]:
        out.append([_label(host, a, b), g / 1e9])
    return {"device_ops": [[n[:160], d / 1e9] for n, d in ops],
            "idle_gaps": out}


def _label(host, a: int, b: int) -> str:
    """The host span that overlaps [a, b) the most ('none' if none)."""
    best, label = 0, "none"
    for name, s, e in host:
        if s >= b:
            break
        o = min(b, e) - max(a, s)
        if o > best:
            best, label = o, name
    return label


def kernel_seconds(tr: Optional[Dict], names) -> Optional[float]:
    """Device seconds of the kernels whose name contains one of
    ``names``; None without a trace or where none ran."""
    if tr is None:
        return None
    tot = sum(d for n, _, d in tr["kernels"] if any(k in n for k in names))
    return tot / 1e9 if tot > 0 else None
