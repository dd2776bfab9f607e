#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. card: name and power limit (nvidia-smi), torch and CUDA versions;
2. build: compile ``src/repro_torch/csrc/*.cu`` with nvcc (sm_90a);
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main path's full-width deepseek-r1 shapes (bf16) and one small
   float32 case, with the tolerances of tests/test_kernels.py; timed with
   CUDA events (median of 20 samples of 5 back-to-back calls, after
   warm-up) beside the plain version, a library yardstick and the card's
   bound (each input byte read once, each output byte written once);
4. reference: a reduced deepseek-r1 decoder in float32 on the card (CUDA
   kernels) against the same weights on the CPU (plain versions): prefill
   logits plus 8 teacher-forced decode steps;
5. serve: the port's ServingEngine at the full published width of
   deepseek-r1 (depth cut to 1 dense + 2 MoE blocks), 8 requests of 32
   greedy tokens, expert server 1 failing at step 10 and recovering at step
   20; every kernel's launch count over this run must be > 0.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12                                 # H100 SXM HBM3, B/s
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}    # dense, per second
TOL = {"grouped_gemm": {"float32": 1e-5, "bfloat16": 2e-2},
       "flash_decode": {"float32": 1e-5, "bfloat16": 3e-2},
       "combine_weighted": {"float32": 1e-5, "bfloat16": 2e-2}}
SOURCES = {"grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                            "src/repro/kernels/grouped_gemm.py:43"),
           "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                            "src/repro/kernels/decode_attention.py:74"),
           "combine_weighted": ("src/repro_torch/csrc/combine.cu",
                                "src/repro/kernels/combine.py:23")}


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, reps: int = 20, inner: int = 5,
            warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``inner`` back-to-back
    calls (so the host enqueues ahead and its launch gaps do not count),
    divided by ``inner``; the median of ``reps`` such samples."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_case(torch, name, label, dtype, kernel, plain, library, nbytes,
             ops):
    """Check kernel vs plain on one input; time kernel, plain, library."""
    got, want = kernel(), plain()
    torch.cuda.synchronize()
    tol = TOL[name][dtype]
    err = (got.float() - want.float()).abs().max().item()
    ok = torch.allclose(got.float(), want.float(), rtol=tol, atol=tol)
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}[{label}]: non-finite output")
    if not ok:
        raise AssertionError(f"{name}[{label}]: max |err| {err} exceeds "
                             f"rtol=atol={tol}")
    b_ms, b_by = bound_ms(nbytes, ops, dtype)
    case = {"case": label, "dtype": dtype, "max_abs_err": err, "tol": tol,
            "ms": time_ms(torch, kernel), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library),
            "bound_ms": b_ms, "bound_by": b_by}
    log(f"kernels: {name}[{label}] {json.dumps(case)}")
    return case


def kernels_phase(torch, cfg) -> dict:
    from repro_torch.kernels import grouped_gemm as kgg
    from repro_torch.kernels import ops

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16
    cases = {k: [] for k in SOURCES}
    m = cfg.moe

    # ---- grouped GEMM: one server's M = C rows over L = 64 + 2 slots ----
    d, f = cfg.d_model, m.d_expert
    L, M = m.num_experts // 4 + 2, 1280

    def gg_case(label, live_rows, K, N, dtype):
        G = L if K * N > 1 << 20 else 6
        probs = torch.full((G,), 1.0 / G)
        sizes = torch.bincount(torch.multinomial(
            probs, live_rows, replacement=True,
            generator=torch.Generator().manual_seed(1)), minlength=G)
        sizes_d = sizes.to(dev)
        Mr = M if G == L else 96
        x = torch.randn(Mr, K, generator=gen, device=dev).to(dtype)
        w = (torch.randn(G, K, N, generator=gen, device=dev)
             / K ** 0.5).to(dtype)
        offs = [0] + torch.cumsum(sizes, 0).tolist()

        def library():
            out = torch.zeros(Mr, N, dtype=dtype, device=dev)
            for g in range(G):
                if offs[g + 1] > offs[g]:
                    out[offs[g]:offs[g + 1]] = x[offs[g]:offs[g + 1]] @ w[g]
            return out
        es = x.element_size()
        live_g = int((sizes > 0).sum())
        nbytes = (live_rows * K + live_g * K * N + Mr * N) * es
        cases["grouped_gemm"].append(run_case(
            torch, "grouped_gemm", label, str(dtype)[6:],
            lambda: ops.grouped_gemm(x, w, sizes_d, impl="cuda"),
            lambda: kgg.grouped_gemm_torch(x, w, sizes_d), library,
            nbytes, 2.0 * live_rows * K * N))

    gg_case("decode gate/up, 16 live rows", 16, d, f, bf)
    gg_case("decode down, 16 live rows", 16, f, d, bf)
    gg_case("prefill gate/up, 1024 live rows", 1024, d, f, bf)
    gg_case("prefill down, 1024 live rows", 1024, f, d, bf)
    gg_case("float32 small, 64 live rows", 64, 64, 48, torch.float32)
    empty = ops.grouped_gemm(
        torch.randn(32, 16, device=dev), torch.randn(4, 16, 16, device=dev),
        torch.zeros(4, dtype=torch.int64, device=dev), impl="cuda")
    if empty.abs().max().item() != 0.0:
        raise AssertionError("grouped_gemm: empty groups must give zeros")

    # ---- flash decode: B=8 slots, 128 heads over 8 KV heads, hd=64 ------
    def fd_case(label, B, H, KV, hd, S, lengths, dtype):
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        valid = lens.clamp(max=S).long()
        mask = (torch.arange(S, device=dev)[None, :] < valid[:, None])
        attn_mask = mask[:, None, None, :]                   # (B,1,1,S)

        def library():
            import torch.nn.functional as F
            o = F.scaled_dot_product_attention(
                q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=attn_mask, enable_gqa=True)
            return o[:, :, 0, :]
        es = q.element_size()
        n_valid = int(valid.sum())
        nbytes = (2 * B * H * hd + 2 * n_valid * KV * hd) * es + 4 * B
        cases["flash_decode"].append(run_case(
            torch, "flash_decode", label, str(dtype)[6:],
            lambda: ops.flash_decode(q, k, v, lens, impl="cuda"),
            lambda: ops.flash_decode(q, k, v, lens, impl="torch"), library,
            nbytes, 4.0 * n_valid * H * hd))

    rng_lens = torch.randint(64, 545, (8,), generator=torch.Generator()
                             .manual_seed(2)).tolist()
    fd_case("decode, 8 slots, lengths 64-544 of 1024", 8, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, 1024, rng_lens, bf)
    fd_case("float32 small, lengths past S", 3, 8, 2, 32, 64, [70, 1, 33],
            torch.float32)

    # ---- combine: T tokens x top-8 partials x d_model -------------------
    def cb_case(label, T, k, dd, dtype):
        x = torch.randn(T, k, dd, generator=gen, device=dev).to(dtype)
        w = (torch.rand(T, k, generator=gen, device=dev) > 0.1).float()
        es = x.element_size()
        cases["combine_weighted"].append(run_case(
            torch, "combine_weighted", label, str(dtype)[6:],
            lambda: ops.combine_weighted(x, w, impl="cuda"),
            lambda: ops.combine_weighted(x, w, impl="torch"),
            lambda: torch.einsum("tkd,tk->td", x, w.to(dtype)),
            (T * k * dd + T * dd) * es + T * k * 4, 2.0 * T * k * dd))

    cb_case("decode, 8 tokens", 8, m.top_k, d, bf)
    cb_case("prefill, 512 tokens", 512, m.top_k, d, bf)
    cb_case("float32 small", 64, 2, 128, torch.float32)
    return cases


def reference_phase(torch, get_config) -> None:
    """Reduced deepseek-r1, float32: CUDA kernels on the card vs the plain
    versions on the CPU, same weights."""
    from repro_torch.core.elastic import ServerPool
    from repro_torch.models.transformer import build_model

    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    pool = ServerPool(cfg, 4, tokens_per_client=32, n_redundant=2)
    outs = {}
    params_cpu = None
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, 4, pool.redundant_table, dev)
        if params_cpu is None:
            params_cpu = model.init_params(torch.Generator().manual_seed(0))
        params = _tree_to(params_cpu, dev)
        rt = pool.runtime(dev)
        g = torch.Generator().manual_seed(3)
        prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
        steps = torch.randint(0, cfg.vocab_size, (8, 2, 1), generator=g)
        logits, cache, _ = model.prefill(params, prompt.to(dev), rt,
                                         max_slots=64)
        seq = [logits]
        for t in range(8):
            lg, cache, _ = model.decode_step(params, steps[t].to(dev),
                                             cache, rt)
            seq.append(lg)
        outs[dev] = torch.stack(seq).cpu()
    err = (outs["cuda"] - outs["cpu"]).abs().max().item()
    log(f"reference: reduced deepseek-r1 float32, prefill + 8 decode steps, "
        f"card vs CPU max |logit err| {err:.3e} (tol 1e-4)")
    if not err <= 1e-4:
        raise AssertionError(f"reference phase: card and CPU disagree ({err})")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def serve_phase(torch, get_config) -> dict:
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                     ServingEngine, WallClock)
    from repro_torch.serving.metrics import ServingMetrics

    base = get_config("deepseek-r1")
    cfg = base.replace(num_layers=3,
                       moe=dataclasses.replace(base.moe, first_k_dense=1))
    ecfg = EngineConfig(max_batch=8, max_seq=1024, num_servers=4,
                        n_redundant=2, pool_tokens_per_client=512)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, ecfg, seed=0, clock=WallClock())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    log(f"serve: deepseek-r1 d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} d_head={cfg.head_dim} vocab={cfg.vocab_size} "
        f"experts={cfg.moe.num_experts} top-{cfg.moe.top_k} "
        f"d_expert={cfg.moe.d_expert} layers={cfg.num_layers} "
        f"(1 dense + 2 MoE) {cfg.dtype}: {n_params / 1e9:.2f}B params, "
        f"init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")

    rng = np.random.default_rng(0)
    # warm-up request (cuBLAS handles, allocator) before the measured run
    eng.submit(Request(-1, rng.integers(0, cfg.vocab_size, 64, np.int32),
                       SamplingParams(max_new_tokens=2)))
    eng.run()
    eng.metrics, eng.clock, eng.step_idx = ServingMetrics(), 0.0, 0
    eng.executor.dropped.zero_()
    eng.executor.miss.zero_()

    lengths = rng.integers(64, 513, 8)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(n), np.int32),
                    SamplingParams(max_new_tokens=32))
            for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)

    def on_step(e):
        if e.step_idx == 10:
            e.inject_server_failure(1)
        if e.step_idx == 20:
            e.recover_server(1)

    ops.reset_launches()
    metrics = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    if metrics.completed != len(reqs):
        raise AssertionError(f"serve: {metrics.completed}/{len(reqs)} done")
    for r in reqs:
        if len(r.output_tokens) != 32 or not all(
                0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"serve: request {r.request_id} produced "
                                 f"{r.output_tokens}")
    # re-prefilling a prompt must reproduce its first greedy token, from
    # finite logits of the expected shape
    logits = eng.executor.prefill(0, reqs[0].prompt)
    if logits.shape != (1, cfg.padded_vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"serve: bad logits {tuple(logits.shape)}")
    if int(logits.argmax()) != reqs[0].output_tokens[0]:
        raise AssertionError("serve: re-prefill changed the first token")
    fails = [e for e in metrics.events if e["event"].startswith("server_")]
    if len(fails) != 2:
        raise AssertionError(f"serve: failure events {fails}")
    zero = [k for k, n in launches.items() if n <= 0]
    if zero:
        raise AssertionError(f"serve: kernels never launched: {zero}")

    s = metrics.summary()
    last_prefill = max(e["t"] for e in metrics.events
                       if e["event"] == "prefill")
    dec = [x for x in metrics.timeline if x["t"] > last_prefill]
    dec_tok = sum(x["tokens"] for x in dec)
    dec_s = dec[-1]["t"] - last_prefill if dec else 0.0
    log(f"serve: completed {metrics.completed}/{len(reqs)} requests, "
        f"prompt lengths {lengths.tolist()}, "
        f"{metrics.total_output_tokens} output tokens in "
        f"{metrics.wall_time:.3f}s ({s['decode_tok_per_s']} tok/s overall, "
        f"{dec_tok / max(dec_s, 1e-9):.1f} tok/s over the decode-only "
        f"steps)")
    log(f"serve: TTFT p50 {s['ttft']['p50']} ms p99 {s['ttft']['p99']} ms; "
        f"ITL p50 {s['itl']['p50']} ms p99 {s['itl']['p99']} ms")
    log(f"serve: dropped {int(eng.executor.dropped)} miss "
        f"{int(eng.executor.miss)}; server 1 failed at step 10, recovered "
        f"at step 20")
    log(f"serve: launches {json.dumps(launches)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_decode(torch, eng, cfg, rng)
    return launches


def profile_decode(torch, eng, cfg, rng, steps: int = 8) -> None:
    """Where a full-batch decode step's time goes: torch.profiler over
    ``steps`` lockstep decode steps of 8 fresh requests (after the measured
    run, so its overhead touches no reported latency)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request, SamplingParams

    for i in range(8):
        eng.submit(Request(100 + i, rng.integers(0, cfg.vocab_size, 128)
                           .astype("int32"),
                           SamplingParams(max_new_tokens=steps + 2)))
    for _ in range(8):
        eng.step()                                   # the 8 prefills
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    eng.run()
    # device-side rows only: a CPU op's row repeats its kernels' time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in rows) / 1e3 / steps
    if busy_ms <= 0:
        log("profile: the profiler saw no device time (not measured)")
        return
    log(f"profile: decode step (8 slots, full batch) wall {wall_ms:.2f} ms "
        f"under the profiler, device busy {busy_ms:.2f} ms, idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        log(f"profile: {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
            f"{e.count / steps:6.1f} calls/step  {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    build.load_library()
    info = build.build_info
    log(f"build: {len(info['sources'])} sources "
        f"{[Path(p).name for p in info['sources']]} in {info['seconds']:.1f}s "
        f"-> {info['path']}")
    for line in info.get("log", "").splitlines():
        if "registers" in line or line.startswith("=="):
            log(f"build: {line.strip()}")

    cfg = get_config("deepseek-r1")
    cases = kernels_phase(torch, cfg)
    reference_phase(torch, get_config)
    launches = serve_phase(torch, get_config)

    summary = []
    for name, cs in cases.items():
        head = cs[0]                      # the decode shape: most launches
        src, replaces = SOURCES[name]
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "card": smi, "cases": cs})
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
