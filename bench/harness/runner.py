"""One run of one cell: set-up, warm-up, the measured window, the check.

``run()`` is the whole of ``bench/run.py`` after its command line: it finds
the cell's configuration, traffic mix, limits and metric readers by the
names in ``BENCHMARK.json``, makes the weights from the seed, builds the port's
``ServingEngine`` over them, warms up every prefill shape of this run's
schedule and the decode graph, serves the mix's warm span, measures for
``seconds``, and checks samples of the served requests against the plain
reference.  It returns the result line's object.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from harness import check, drive, traffic, weights
from harness.trace import Tracer, breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    """Top-level names in ``sys.modules`` that the run may not load,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({n.split(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def load_cell(root: Path, workload: str):
    """(BENCHMARK.json, the cell, its configuration file, its mix) by
    name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    return bench, cell, config, mix


def port_config(config: dict):
    """The port's ``ModelConfig``: its registered architecture with the
    configuration's sizes."""
    from repro_torch.configs import get_config
    base, m = get_config(config["port_arch"]), config["model"]
    moe = dataclasses.replace(
        base.moe, num_experts=m["num_experts"], top_k=m["top_k"],
        d_expert=m["d_expert"], num_shared_experts=m["num_shared_experts"],
        dense_residual=m["dense_residual"],
        first_k_dense=m["num_dense_layers"],
        router_score_fn=m["router_score_fn"],
        normalize_topk=m["normalize_topk"])
    return dataclasses.replace(
        base, num_layers=m["num_layers"], d_model=m["d_model"],
        num_heads=m["num_heads"], num_kv_heads=m["num_kv_heads"],
        d_ff=m["d_ff"], vocab_size=m["vocab_size"], d_head=m["d_head"],
        rope_theta=m["rope_theta"], rms_norm_eps=m["rms_norm_eps"],
        dtype="bfloat16", moe=moe)


def readers(root: Path, names, kind: str = "layer_metrics"):
    """Each metric's reader, ``bench/<kind>/<name>.py``: ``layer_metrics``
    (per-layer) or ``end_to_end``."""
    out = {}
    for n in names:
        path = root / "bench" / kind / f"{n}.py"
        spec = importlib.util.spec_from_file_location(
            f"{kind}_" + n.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[n] = mod
    return out


def log(msg: str, t0: float = None) -> None:
    """A set-up milestone on standard error, seconds since ``t0``."""
    at = "" if t0 is None else f" at {time.perf_counter() - t0:.3f} s"
    print(f"[bench] {msg}{at}", file=sys.stderr, flush=True)


class Cell:
    """A built cell: weights, engine, driver and schedule."""

    def __init__(self, config: dict, mix: dict, seconds: float, seed: int,
                 device):
        from repro_torch.serving.clock import WallClock
        from repro_torch.serving.engine import EngineConfig, ServingEngine
        self.config, self.mix, self.m = config, mix, config["model"]
        self.device = torch.device(device)
        dep = config["deployment"]
        self.params = weights.make(self.m, dep["num_servers"],
                                   dep["n_redundant"], seed, self.device)
        ecfg = EngineConfig(mode="eaas", num_servers=dep["num_servers"],
                            n_redundant=dep["n_redundant"], **mix["engine"])
        self.engine = ServingEngine(port_config(config), ecfg,
                                    params=self.params, clock=WallClock(),
                                    device=self.device)
        weights.fill_redundant(self.params, self.m,
                               self.engine.pool.redundant_table)
        self.driver = drive.Driver(self.engine, self.m)
        self.seconds, self.seed = seconds, seed
        self.items = traffic.schedule(mix, seconds, seed,
                                      self.m["vocab_size"])

    def request(self, it):
        from repro_torch.serving.request import Request, SamplingParams
        return Request(it.rid, it.prompt, SamplingParams(
            temperature=it.temperature, max_new_tokens=it.max_new,
            seed=self.seed & 0x7FFFFFFF))

    def warm_shapes(self) -> int:
        """Run every prefill shape of the schedule and the decode graph
        twice, the requests the engine's own with one output token past
        the first: greedy, then at the mix's temperature.  The first pass
        is each shape's first sight, which runs eagerly; the second
        captures its graph.  Between them the allocator's cache goes back
        to the device, so that the captures' pool does not sit beside the
        eager passes' freed blocks."""
        chunk = int(self.mix["engine"].get("prefill_chunk", 0))
        shapes = traffic.prefill_shapes([len(i.prompt) for i in self.items],
                                        chunk)
        rng = np.random.default_rng([self.seed, 7])
        temp = float(self.mix.get("temperature", 0.0))
        rid = 1 << 30
        for t in (0.0, temp):
            for n in traffic.warm_lengths(shapes, chunk):
                it = traffic.Item(rid, 0.0, rng.integers(
                    0, self.m["vocab_size"], n).astype(np.int32), 2, t)
                self.driver.submit(self.request(it), 0.0)
                rid += 1
            self.driver.drain()
            if self.device.type == "cuda":
                torch.cuda.empty_cache()
        # the schedule's own metrics start after the warm-up
        self.driver.clear()
        return len(shapes)

    def reset(self) -> None:
        """Drop every queued and live request and the driver's records
        (the tools serve many schedules on one built cell)."""
        self.engine.abort_inflight()
        self.driver.clear()

    def reseed(self, seed: int) -> None:
        """Redraw the weights from ``seed`` in place (the graphs keep
        their addresses) and serve that seed's requests next."""
        dep = self.config["deployment"]
        weights.make(self.m, dep["num_servers"], dep["n_redundant"], seed,
                     self.device, into=self.params)
        weights.fill_redundant(self.params, self.m,
                               self.engine.pool.redundant_table)
        self.seed = seed

    def serve(self, items, warm_s: float, seconds: float, on_tick=None):
        """Serve ``items`` from now: the warm span, then the window;
        returns the window's (start, end)."""
        t0 = time.perf_counter()
        ws = t0 + warm_s
        self.driver.serve(items, t0, ws + seconds, self.request,
                          on_tick=on_tick)
        return ws, ws + seconds

    def free_engine(self) -> None:
        """Drop the engine (caches, graphs, their pools); the weights stay
        for the reference."""
        self.driver.engine = self.driver.sch = None
        self.engine = None
        gc.collect()
        torch.cuda.empty_cache() if self.device.type == "cuda" else None


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, device=None, plant: Optional[Callable] = None,
        config_override: Optional[dict] = None,
        mix_override: Optional[dict] = None):
    """One run -> (the result line's object, notes for standard error);
    ``plant(cell)`` breaks the timed path underneath (the fault tests),
    ``config_override`` and ``mix_override`` replace the cell's
    configuration and traffic mix (the CPU tests' small sizes)."""
    bench, wl, config, mix = load_cell(root, workload)
    limits = check.load_limits(root, workload)
    if config_override is not None:
        config = config_override
    if mix_override is not None:
        mix = mix_override
    device = torch.device(device or "cuda")
    # the metrics this run reports: with --trace 1 the cell's per-layer
    # ones, else its end-to-end ones
    kind = "layer_metrics" if trace else "end_to_end"
    metrics = [m for m in bench["per_layer" if trace else "end_to_end"]
               if workload in m.get("workloads", [workload])]
    reader = readers(root, [m["name"] for m in metrics], kind)

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log("program imported", t_process)
    cell = Cell(config, mix, seconds, seed, device)
    log(f"weights made and engine built ({len(cell.items)} requests "
        "scheduled)", t_process)
    if plant is not None:
        plant(cell)
    n_shapes = cell.warm_shapes()
    log(f"{n_shapes} prefill shapes and the decode graph warmed up",
        t_process)
    d = cell.driver
    tracer = Tracer(device) if trace else None
    if tracer is not None:
        tracer.prime()
    trace_s = min(2.0, seconds / 3.0)
    t_sched0 = time.perf_counter()
    ws = t_sched0 + float(mix["warm_s"])
    we = ws + seconds

    captures0 = None

    def tick(now):
        nonlocal captures0
        if captures0 is None and now >= ws:
            captures0 = sum(cell.engine.executor.graphs.captures.values())
        if tracer is not None:
            if tracer.prof is None and now >= we - trace_s:
                d.tracer = tracer
                tracer.start()
            elif tracer.active and now >= we:
                tracer.stop()

    d.serve(cell.items, t_sched0, we, cell.request, on_tick=tick)
    if tracer is not None and tracer.active:
        tracer.stop()
    t_closed = time.perf_counter()
    log("window closed", t_process)
    captures = sum(cell.engine.executor.graphs.captures.values()) \
        - (captures0 or 0)
    setup_s = ws - t_process
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    dropped = int(cell.engine.executor.dropped)
    miss = int(cell.engine.executor.miss)
    attempted = sum(1 for tk in d.tracks.values()
                    if tk.due < we and not (tk.done and tk.times
                                            and tk.times[-1] < ws))

    # ---- the metrics: what each reader takes from the run --------------
    tr = tracer.result() if tracer is not None else None
    view = {"tracks": d.tracks, "ws": ws, "we": we, "seconds": seconds,
            "setup_s": setup_s, "mix": mix, "model": cell.m,
            "max_batch": int(mix["engine"]["max_batch"]),
            "steps": drive.window_steps(d.steps, ws, we),
            "traced_steps": [s for s in d.steps if s.traced],
            "trace": tr, "peak_bytes": peak}
    values = {n: r.read(view) for n, r in reader.items()}

    # ---- the check, once the window has closed ---------------------------
    gs, ss = check.draw_samples(d, ws, we, limits, seed)
    greedy, sampled = check.served(d, gs), check.served(d, ss)
    temps = check.temperatures(d, ss)
    cell.free_engine()
    gaps, draws = check.readings(cell.params, cell.m, greedy, sampled,
                                 temps, device, config)
    correct, failed, compared = check.judge(gaps, draws, dropped, miss,
                                            limits)

    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")

    res = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed)}
    res["metrics"] = {m["name"]: {"value": values[m["name"]],
                                  "unit": m["unit"]}
                      for m in metrics if values[m["name"]] is not None}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["span_s"]
    res["device"] = dev
    if tr is not None:
        res["breakdown"] = breakdown(tr)
    res["compared"] = compared
    notes = {"shapes_warmed": n_shapes, "captures_in_window": captures,
             "check_s": time.perf_counter() - t_closed,
             "sample": [int(r) for r in gs + ss],
             "summary": check.summary(gaps, draws)}
    return res, notes

