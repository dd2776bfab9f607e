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
   bound (each input byte read once, each output byte written once); the
   kernel and the library call also replayed from a CUDA graph of the 5
   calls ("device_ms": device time without the host's launch gaps); the
   redesigned kernels run twice and must agree bitwise; edge cases (split
   boundaries, block size 12, kimi-k2's head width 112 and an odd 33,
   empty and ragged groups, G > 66) are checked
   against the plain versions; the combine's slot entry (the servers'
   response buffers read in place, drops skipped, the shared experts'
   output added) must be bitwise the plain sequential loop and the direct
   entry over the gathered view, at decode and prefill shapes and edges
   (T = 0, an all-dropped token, k = 1, S = 1 and 16, the scalar path),
   and is timed beside the stage it replaced and an empty kernel (the
   launch floor);
4. reference: a reduced deepseek-r1 decoder in float32 on the card (CUDA
   kernels) against the same weights on the CPU (plain versions): prefill
   logits plus 8 teacher-forced decode steps, over the dense cache and
   again (chunked prefill into a paged cache) over the block pool; then a
   reduced paged engine and a dense chunked-prefill engine on the card
   under VirtualClock must give identical greedy tokens;
5. serve: the port's ServingEngine at the full published width of
   deepseek-r1 (depth cut to 1 dense + 2 MoE blocks), 8 requests of 32
   greedy tokens, expert server 1 failing at step 10 and recovering at step
   20; the dense path's kernels must each launch in this run; prints the
   greedy tokens' digest;
6. serve, paged: the same model with a 129-block KV pool, chunked prefill
   (256) under the fair policy, 16 requests over two shared 256-token
   system prompts; it must show prefix hits, a copy-on-write fork and
   preemption, and the paged kernel must launch in this run;
7. profile: torch.profiler over 8 full-batch decode steps of each engine,
   with the device operations (kernels, copies) launched per step; then 8
   more with the combine stage as it ran before the slot entry, and the
   device rows that moved;
8. decode modes: the dense serve's 8 requests with no failure, on its
   weights, in lockstep, pipelined (the second half-batch microbatch on
   its own CUDA stream) and serialized EAAS decode; the two split modes
   must give equal token digests and first-step logits; each mode's
   tokens against lockstep's, its decode step wall, device busy and
   launches (profiled as in 7);
9. cluster (lockstep, WallClock), on the dense serve's weights (one bank
   for every client; these three phases run before the baselines free
   them): 16 requests of 64-512 prompt tokens and 32 greedy tokens through
   a 1-client cluster, then 4 round-robin clients, the router steered off
   expert server 1 (its 64 primaries and 2 replicas, so its failure moves
   no token), server 1 down at cluster steps 30-60, client 2 failing after
   its second decode step and recovering 40 steps later: client 2's
   requests strand (failed_requests), every other request's tokens equal
   the 1-client run's, the 4-client run peaks below 1.1x the 1-client
   run's memory; step wall p50/p99, tok/s, routed counts, launches per
   client decode step (profiled);
10. cluster, async (VirtualClock): the same requests through 4 lockstep
   and 4 async clients (one shared tier, depth 2, per-expert lanes),
   server 3 slowed 3x, server 1 failing with micro-batches queued on it:
   equal token digests, micro-batches re-dispatched; virtual (modelled)
   tok/s, ITL and queue delays, and the phase's wall on the card;
11. cluster, paged: the paged serve's 16 shared-prefix requests through 4
   paged clients under session affinity, then round robin: affinity's
   prefix hit rate at least round robin's;
12. baselines: the dense serve's traffic and failure in monolithic EP (4
   servers x 64 slots, no replicas) and TP (one server of all 256
   experts, tp_batch_cap 4), each on its own seeded weights, one engine at
   a time: all 8 requests complete, exactly restart_steps (50) /
   tp_restart_steps (12) halted steps, miss 0, every dense-path kernel
   launched; TTFT / ITL, decode tok/s over the non-halted steps and the
   halt's charge on the engine clock (the engine does not sleep through
   it); the kernels phase also checks the grouped GEMM at G = 64 and at
   G = 256 over C = 5120 rows, and flash decode at B = 4;
13. control plane: the earlier engines freed, the same full-width model
   serves 8 requests (prompts 64-512, 32 greedy tokens) under a Zipf(1.2)
   router skew twice on one set of weights — frozen, then elastic: the
   live rebalance controller, a page-out of 16 experts (the 15 coldest and
   the hottest, so a cold start follows), a one-shot rebalance and
   scale_to 8 -> 2 -> 4 after the last prefill, all in place.  The token
   digests must match, nothing may be dropped or missed, the grouped GEMM,
   flash decode and the combine's slot entry must launch at every pool
   size, replicas must equal their primaries and freed slots be zero, and
   each resize must peak within the larger resident set plus one stacked
   weight tensor (+5 %); each migration chunk, resize and page-out is
   printed with its device time, bytes and bound (the kernels phase also
   checks the grouped GEMM at G = 34 and 130 and the slot entry over 8 and
   2 server buffers, the shapes of pool sizes 8 and 2).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
rest of the repository beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
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
       "paged_flash_decode": {"float32": 1e-5, "bfloat16": 3e-2},
       "combine_weighted": {"float32": 1e-5, "bfloat16": 2e-2},
       "combine_slots": {"float32": 1e-5, "bfloat16": 2e-2}}
SOURCES = {"grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                            "src/repro/kernels/grouped_gemm.py:43"),
           "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                            "src/repro/kernels/decode_attention.py:74"),
           "paged_flash_decode": (
               "src/repro_torch/csrc/paged_flash_decode.cu",
               "src/repro/kernels/decode_attention.py:124"),
           "combine_weighted": ("src/repro_torch/csrc/combine.cu",
                                "src/repro/kernels/combine.py:23"),
           "combine_slots": ("src/repro_torch/csrc/combine.cu",
                             "src/repro/kernels/combine.py:23")}


def log(*a):
    print(*a, flush=True)


def time_ms(torch, fn, reps: int = 20, inner: int = 5, warmup: int = 3,
            graph: bool = False) -> float:
    """Time of one call: CUDA events around ``inner`` back-to-back calls,
    divided by ``inner``; the median of ``reps`` such samples.  Eager, the
    host enqueues ahead, but a call whose wrapper costs the host more than
    the device reads the host's time.  With ``graph``, the ``inner`` calls
    are captured once into a CUDA graph and replayed: device time alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    run = lambda: [fn() for _ in range(inner)]      # noqa: E731
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            run()
        g.replay()
        run = g.replay
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_case(torch, name, label, dtype, got, want) -> float:
    """Kernel output vs plain output within the stated tolerance."""
    torch.cuda.synchronize()
    tol = TOL[name][dtype]
    err = ((got.float() - want.float()).abs().max().item() if got.numel()
           else 0.0)
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}[{label}]: non-finite output")
    if not torch.allclose(got.float(), want.float(), rtol=tol, atol=tol):
        raise AssertionError(f"{name}[{label}]: max |err| {err} exceeds "
                             f"rtol=atol={tol}")
    return err


def run_case(torch, name, label, dtype, kernel, plain, library, nbytes,
             ops, twice: bool = False, plain_reps: int = 20):
    """Check kernel vs plain on one input (and, with ``twice``, run-to-run
    bitwise); time kernel, plain (``plain_reps`` single calls when it is
    slow), library."""
    got = kernel()
    err = check_case(torch, name, label, dtype, got, plain())
    if twice and not torch.equal(got, kernel()):
        raise AssertionError(f"{name}[{label}]: two runs differ")
    b_ms, b_by = bound_ms(nbytes, ops, dtype)
    plain_ms = (time_ms(torch, plain) if plain_reps == 20 else
                time_ms(torch, plain, reps=plain_reps, inner=1, warmup=1))
    case = {"case": label, "dtype": dtype, "max_abs_err": err,
            "tol": TOL[name][dtype],
            "ms": time_ms(torch, kernel), "plain_ms": plain_ms,
            "library_ms": time_ms(torch, library),
            "device_ms": time_ms(torch, kernel, graph=True),
            "library_device_ms": time_ms(torch, library, graph=True),
            "bound_ms": b_ms, "bound_by": b_by}
    log(f"kernels: {name}[{label}] {json.dumps(case)}")
    return case



def kernels_phase(torch, cfg):
    """Returns (cases by kernel, the launch floor)."""
    import torch.nn.functional as F

    from repro_torch.kernels import combine as kcb
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

    def gg_case(label, live_rows, K, N, dtype, G=None, Mr=None,
                plain_reps=20):
        big = K * N > 1 << 20
        G = G or (L if big else 6)
        probs = torch.full((G,), 1.0 / G)
        sizes = torch.bincount(torch.multinomial(
            probs, live_rows, replacement=True,
            generator=torch.Generator().manual_seed(1)), minlength=G)
        sizes_d = sizes.to(dev)
        Mr = Mr or (M if big else 96)
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
            nbytes, 2.0 * live_rows * K * N, twice=live_rows == 16,
            plain_reps=plain_reps))

    gg_case("decode gate/up, 16 live rows", 16, d, f, bf)
    gg_case("decode down, 16 live rows", 16, f, d, bf)
    gg_case("prefill gate/up, 1024 live rows", 1024, d, f, bf)
    gg_case("prefill down, 1024 live rows", 1024, f, d, bf)
    gg_case("float32 small, 64 live rows", 64, 64, 48, torch.float32)
    # the control-plane phase's pool sizes (pool_tokens_per_client 1664):
    # S = 8 servers of 32 + 2 slots over C = 2080 rows, S = 2 of 128 + 2
    # over C = 8320; decode's 64 picks spread over fewer or more servers
    for S_, G_, C_, live_ in ((8, 34, 2080, 16), (2, 130, 8320, 40)):
        for what, K_, N_ in (("gate/up", d, f), ("down", f, d)):
            gg_case(f"control plane, S = {S_}: decode {what}, G = {G_}, "
                    f"{live_} live rows of {C_}", live_, K_, N_, bf, G=G_,
                    Mr=C_, plain_reps=3)
    # the baselines at the dense serve's pool_tokens_per_client 512:
    # monolithic EP, 4 servers of 64 slots (no replicas) over C = 1280 rows;
    # TP, one server of all 256 experts over C = 5120 rows (decode: 64
    # picks; prefill: one 512-token prompt, 4096 picks)
    for what, K_, N_ in (("gate/up", d, f), ("down", f, d)):
        gg_case(f"monolithic_ep: decode {what}, G = 64, 16 live rows of "
                f"1280", 16, K_, N_, bf, G=64)
    for phase, live_ in (("decode", 64), ("prefill", 4096)):
        for what, K_, N_ in (("gate/up", d, f), ("down", f, d)):
            gg_case(f"tp: {phase} {what}, G = 256, {live_} live rows of "
                    f"5120", live_, K_, N_, bf, G=256, Mr=5120, plain_reps=3)

    # edges of the in-kernel scan: (M, K, N, sizes); rows past the live
    # ones must come back zero from an uninitialised output
    edges = {"all groups empty": (32, 16, 16, [0] * 4),
             "sizes [0,0,3,5,5,5]": (32, 128, 96, [0, 0, 3, 5, 5, 5]),
             "all rows in one group": (200, 64, 128, [0, 0, 200, 0]),
             "sum < M, G = 130 > 66": (1280, 256, 72, "1000 over 130"),
             "M = 100, K = 72": (100, 72, 136, "100 over 5")}
    sz_gen = torch.Generator().manual_seed(6)
    for dtype in (bf, torch.float32):
        for label, (Me, Ke, Ne, sz) in edges.items():
            if isinstance(sz, str):
                live, G = (int(t) for t in sz.split(" over "))
                sz = torch.bincount(torch.randint(0, G, (live,),
                                                  generator=sz_gen),
                                    minlength=G)
            sz = torch.as_tensor(sz).to(dev)
            x = torch.randn(Me, Ke, generator=gen, device=dev).to(dtype)
            w = (torch.randn(len(sz), Ke, Ne, generator=gen, device=dev)
                 / Ke ** 0.5).to(dtype)
            torch.empty(Me * Ne * 4, device=dev).fill_(float("nan"))
            got = ops.grouped_gemm(x, w, sz, impl="cuda")
            err = check_case(torch, "grouped_gemm", label, str(dtype)[6:],
                             got, kgg.grouped_gemm_torch(x, w, sz))
            live = int(sz.sum())
            if not torch.equal(got[live:], torch.zeros_like(got[live:])):
                raise AssertionError(f"grouped_gemm[{label}]: tail rows "
                                     "not zero")
            log(f"kernels: grouped_gemm edge [{label}, {str(dtype)[6:]}] "
                f"max |err| {err:.3g}, zero tail")

    # ---- flash decode: B=8 slots, 128 heads over 8 KV heads, hd=64 ------
    def sdpa(q, k, v, lens):
        S = k.shape[1]
        valid = lens.clamp(max=S).long()
        mask = (torch.arange(S, device=dev)[None, :] < valid[:, None])
        o = F.scaled_dot_product_attention(
            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask[:, None, None, :], enable_gqa=True)
        return o[:, :, 0, :]

    def fd_case(label, B, H, KV, hd, S, lengths, dtype):
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        valid = lens.clamp(max=S).long()

        def library():
            return sdpa(q, k, v, lens)
        es = q.element_size()
        n_valid = int(valid.sum())
        nbytes = (2 * B * H * hd + 2 * n_valid * KV * hd) * es + 4 * B
        cases["flash_decode"].append(run_case(
            torch, "flash_decode", label, str(dtype)[6:],
            lambda: ops.flash_decode(q, k, v, lens, impl="cuda"),
            lambda: ops.flash_decode(q, k, v, lens, impl="torch"), library,
            nbytes, 4.0 * n_valid * H * hd, twice=True))

    rng_lens = torch.randint(64, 545, (8,), generator=torch.Generator()
                             .manual_seed(2)).tolist()
    # lengths at split edges: 1, one chunk, one past it, past S, S
    edge_lens = [1, 64, 65, 1030, 128, 129, 513, 1024]
    fd_case("decode, 8 slots, lengths 64-544 of 1024", 8, cfg.num_heads,
            cfg.num_kv_heads, cfg.head_dim, 1024, rng_lens, bf)
    fd_case("decode, 8 slots, split-edge lengths 1-1030 of 1024", 8,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 1024, edge_lens,
            bf)
    # one microbatch of the pipelined / serialized decode: half the slots
    fd_case("decode, 4 slots (one microbatch), lengths 64-544 of 1024", 4,
            cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 1024,
            rng_lens[:4], bf)
    fd_case("float32 small, lengths past S", 3, 8, 2, 32, 64, [70, 1, 33],
            torch.float32)
    fd_case("float32, split-edge lengths", 8, 16, 2, 64, 320,
            [1, 64, 65, 400, 128, 129, 257, 320], torch.float32)
    # kimi-k2's heads: 64 over 8 KV heads, hd = 112 (7 x the mma's 16)
    fd_case("kimi-k2 width, 8 slots, G 8, hd 112, lengths 64-544 of 1024",
            8, 64, 8, 112, 1024, rng_lens, bf)
    # hd off the 16-byte grid: rows staged element by element
    fd_case("hd 33, split-edge lengths", 4, 12, 2, 33, 200,
            [1, 65, 200, 129], bf)
    fd_case("float32, hd 33, split-edge lengths", 4, 12, 2, 33, 200,
            [1, 65, 200, 129], torch.float32)

    # ---- paged flash decode: the same decode shape over a block pool ----
    def pfd_case(label, B, H, KV, hd, bs, mb, lengths, dtype):
        nb = B * mb + 1
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
        kp = torch.randn(nb, bs, KV, hd, generator=gen, device=dev).to(dtype)
        vp = torch.randn(nb, bs, KV, hd, generator=gen, device=dev).to(dtype)
        perm = torch.randperm(nb - 1, generator=torch.Generator()
                              .manual_seed(4)) + 1
        tables = perm.reshape(B, mb).to(torch.int32).to(dev)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)

        def gathered():
            idx = tables.long()
            return (kp[idx].reshape(B, mb * bs, KV, hd),
                    vp[idx].reshape(B, mb * bs, KV, hd))

        def library():                 # two calls: gather, then SDPA
            return sdpa(q, *gathered(), lens)
        got = ops.paged_flash_decode(q, kp, vp, tables, lens, impl="cuda")
        dense = ops.flash_decode(q, *gathered(), lens, impl="cuda")
        if not torch.equal(got, dense):
            raise AssertionError(f"paged_flash_decode[{label}]: not bitwise "
                                 "equal to flash_decode over the view")
        es = q.element_size()
        n_valid = int(lens.clamp(max=mb * bs).sum())
        nbytes = ((2 * B * H * hd + 2 * n_valid * KV * hd) * es
                  + 4 * B * mb + 4 * B)
        case = run_case(
            torch, "paged_flash_decode", label, str(dtype)[6:],
            lambda: ops.paged_flash_decode(q, kp, vp, tables, lens,
                                           impl="cuda"),
            lambda: ops.paged_flash_decode(q, kp, vp, tables, lens,
                                           impl="torch"), library,
            nbytes, 4.0 * n_valid * H * hd, twice=True)
        case["library"] = "gather + scaled_dot_product_attention (2 calls)"
        cases["paged_flash_decode"].append(case)

    pfd_case("decode, 8 slots, bs 16, lengths 64-544 of 1024", 8,
             cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 16, 64, rng_lens,
             bf)
    pfd_case("decode, 8 slots, bs 12, split-edge lengths", 8, cfg.num_heads,
             cfg.num_kv_heads, cfg.head_dim, 12, 86, edge_lens, bf)
    pfd_case("float32 small, bs 8, lengths up to the view", 3, 8, 2, 32, 8, 4,
             [32, 1, 17], torch.float32)
    pfd_case("float32, bs 12, split-edge lengths", 8, 16, 2, 64, 12, 27,
             [1, 64, 65, 400, 128, 129, 257, 324], torch.float32)
    pfd_case("kimi-k2 width, 8 slots, bs 16, G 8, hd 112", 8, 64, 8, 112,
             16, 64, rng_lens, bf)

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

    # ---- combine over the servers' response buffers: 4 x C = 1280 rows --
    slot_gen = torch.Generator().manual_seed(8)

    def cs_inputs(T, k, S, C, dd, dtype, addend=True, layout="list",
                  offset=0, all_dropped=False):
        """S response buffers (C, d) read in place (a list, or one (S, C, d)
        tensor), slots over distinct rows with ~10 % dropped (and, with
        ``all_dropped``, every slot of token 0), an addend (T, d)."""
        flat = torch.randn(S * C * dd + offset, generator=gen,
                           device=dev).to(dtype)[offset:]
        stacked = flat.view(S, C, dd)
        resp = list(stacked.unbind(0)) if layout == "list" else stacked
        slots = torch.randperm(S * C, generator=slot_gen)[:T * k]
        slots = slots.reshape(T, k)
        slots[torch.rand(T, k, generator=slot_gen) < 0.1] = -1
        if all_dropped and T:
            slots[0] = -1
        add = (torch.randn(T, dd, generator=gen, device=dev).to(dtype)
               if addend else None)
        return resp, stacked, slots.to(dev), add

    def cs_bitwise(label, resp, stacked, slots, add) -> None:
        """torch.equal to the plain sequential fp32 loop and to the direct
        entry over the gathered view with 0/1 weights (+ the addend)."""
        got = ops.combine_slots(resp, slots, addend=add, impl="cuda")
        if not torch.equal(got, ops.combine_slots(resp, slots, addend=add,
                                                  impl="torch")):
            raise AssertionError(f"combine_slots[{label}]: not bitwise the "
                                 "sequential fp32 loop")
        T, k = slots.shape
        dd = stacked.shape[-1]
        view = stacked.reshape(-1, dd)[slots.clamp(min=0)].reshape(T, k, dd)
        direct = ops.combine_weighted(view, (slots >= 0).float(),
                                      impl="cuda")
        if not torch.equal(got, direct if add is None else direct + add):
            raise AssertionError(f"combine_slots[{label}]: not bitwise the "
                                 "direct entry over the gathered view")

    def cs_case(label, T, dtype, addend, k=m.top_k, S=4, C=1280, dd=d):
        resp, stacked, slots, add = cs_inputs(T, k, S, C, dd, dtype, addend)
        cs_bitwise(label, resp, stacked, slots, add)
        flat = stacked.reshape(-1, dd)
        idx, keep = slots.clamp(min=0), (slots >= 0).to(dtype)
        library_name = "embedding_bag(sum, per_sample_weights)"
        try:
            F.embedding_bag(idx, flat, per_sample_weights=keep, mode="sum")
        except RuntimeError:
            library_name = "gather + einsum (embedding_bag refused the dtype)"

        def library():
            if library_name.startswith("embedding_bag"):
                return F.embedding_bag(idx, flat, per_sample_weights=keep,
                                       mode="sum")
            return torch.einsum("tkd,tk->td", flat[idx], keep)
        es = flat.element_size()
        live = int((slots >= 0).sum())
        extra = 0 if add is None else T * dd
        case = run_case(
            torch, "combine_slots", label, str(dtype)[6:],
            lambda: ops.combine_slots(resp, slots, addend=add, impl="cuda"),
            lambda: ops.combine_slots(resp, slots, addend=add, impl="torch"),
            library, (live * dd + T * dd + extra) * es + 8 * T * k,
            float(live * dd + extra), twice=True)
        old = lambda: old_combine_stage(torch, resp, slots, None, add)  # noqa
        case.update(library=library_name + ", addend not added",
                    live_rows=live,
                    old_stage_ms=time_ms(torch, old),
                    old_stage_device_ms=time_ms(torch, old, graph=True))
        log(f"kernels: combine_slots[{label}] old stage (stack + gather + "
            f"mask + combine_weighted + add) {case['old_stage_ms']:.4f} ms, "
            f"device {case['old_stage_device_ms']:.4f} ms")
        cases["combine_slots"].append(case)

    cs_case("decode, 8 tokens, 4 x 1280 rows, addend", 8, bf, True)
    cs_case("decode, 8 tokens, 4 x 1280 rows", 8, bf, False)
    cs_case("prefill, 512 tokens, 4 x 1280 rows, addend", 512, bf, True)
    cs_case("prefill, 512 tokens, 4 x 1280 rows", 512, bf, False)
    cs_case("float32 small, 64 tokens, 4 x 64 rows, addend", 64,
            torch.float32, True, k=2, C=64, dd=128)
    # the control-plane phase's pool sizes
    cs_case("control plane, decode, 8 tokens, 8 x 2080 rows, addend", 8,
            bf, True, S=8, C=2080)
    cs_case("control plane, decode, 8 tokens, 2 x 8320 rows, addend", 8,
            bf, True, S=2, C=8320)
    # tp: the one server's buffer of all 256 experts
    cs_case("tp, decode, 8 tokens, 1 x 5120 rows, addend", 8, bf, True,
            S=1, C=5120)
    cs_case("tp, prefill, 512 tokens, 1 x 5120 rows, addend", 512, bf, True,
            S=1, C=5120)

    # edges: (T, k, S, C, d, layout, offset); token 0 has every slot dropped
    edges = {"T = 0": (0, 8, 4, 64, 256, "list", 0),
             "k = 1": (16, 1, 4, 64, 256, "list", 0),
             "S = 1": (16, 8, 1, 256, 256, "list", 0),
             "S = 1, one tensor": (16, 8, 1, 256, 256, "tensor", 0),
             "S = 16 as a list": (32, 8, 16, 64, 512, "list", 0),
             "S = 4, one tensor": (32, 8, 4, 128, 512, "tensor", 0),
             "d = 7164 (scalar path)": (8, 8, 4, 64, 7164, "list", 0),
             "offset base (scalar path)": (8, 8, 4, 64, 7168, "list", 1)}
    for dtype in (bf, torch.float32):
        for label, (T, k, S, C, dd, layout, offset) in edges.items():
            resp, stacked, slots, add = cs_inputs(
                T, k, S, C, dd, dtype, True, layout, offset, True)
            got = ops.combine_slots(resp, slots, addend=add, impl="cuda")
            err = check_case(torch, "combine_slots", label, str(dtype)[6:],
                             got, ops.combine_slots(resp, slots, addend=add,
                                                    impl="torch"))
            cs_bitwise(label, resp, stacked, slots, add)
            if not torch.equal(got, ops.combine_slots(resp, slots,
                                                      addend=add,
                                                      impl="cuda")):
                raise AssertionError(f"combine_slots[{label}]: two runs "
                                     "differ")
            if got.shape != (T, dd) or (T and not torch.equal(got[0],
                                                              add[0])):
                raise AssertionError(f"combine_slots[{label}]: shape "
                                     f"{tuple(got.shape)} or the all-dropped "
                                     "token is not the addend")
            log(f"kernels: combine_slots edge [{label}, {str(dtype)[6:]}] "
                f"max |err| {err:.3g}, bitwise the loop, the direct entry "
                "and a second run")

    # the card's launch floor: an empty kernel, timed the same way
    floor = {"ms": time_ms(torch, lambda: kcb.empty_cuda(dev)),
             "device_ms": time_ms(torch, lambda: kcb.empty_cuda(dev),
                                  graph=True)}
    log(f"kernels: launch floor (empty kernel) {json.dumps(floor)}")
    return cases, floor


def old_combine_stage(torch, responses, combine_slot, out_dtype, addend):
    """The combine stage as it ran before the slot entry: stack the
    servers' buffers, gather the (T, k, d) view, mask, the direct kernel,
    then the shared experts' add."""
    from repro_torch.kernels import ops

    result = torch.stack(list(responses))
    S, C, d = result.shape
    T, k = combine_slot.shape
    flat = result.reshape(S * C, d)
    gathered = flat[combine_slot.clamp(min=0).reshape(-1)].reshape(T, k, d)
    keep = (combine_slot >= 0).to(torch.float32)
    y = ops.combine_weighted(gathered, keep).to(out_dtype or result.dtype)
    return y if addend is None else y + addend


def reference_phase(torch, get_config) -> None:
    """Reduced deepseek-r1, float32: CUDA kernels on the card vs the plain
    versions on the CPU, same weights — over the dense cache, then chunked
    prefill (chunk 8) into a paged cache; then paged vs dense chunked
    engines on the card."""
    from repro_torch.core.elastic import ServerPool
    from repro_torch.models import kv_cache as kvc
    from repro_torch.models.transformer import build_model

    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    pool = ServerPool(cfg, 4, tokens_per_client=32, n_redundant=2)
    outs = {"dense": {}, "paged": {}}
    params_cpu = None
    # two sequences over a 17-block pool of 8 slots, tables a permutation
    bs, mb = 8, 8
    tables = (torch.randperm(2 * mb, generator=torch.Generator()
                             .manual_seed(5)) + 1).reshape(2, mb)
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
        outs["dense"][dev] = torch.stack(seq).cpu()

        pools = model.init_paged_cache(2 * mb + 1, bs, 2, mb * bs)
        tab = tables.to(torch.int32).to(dev)

        def view(rows, lengths):
            n = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
            return {k: kvc.PagedKVCache(c.k, c.v, rows, n)
                    for k, c in pools.items()}
        seq = []
        for b in range(2):
            for start in range(0, 24, 8):
                lg, _, _ = model.prefill_chunk(
                    params, prompt[b:b + 1, start:start + 8].to(dev),
                    view(tab[b:b + 1], [start]), start, rt)
            seq.append(lg)
        seq = [torch.cat(seq)]
        for t in range(8):
            lg, _, _ = model.decode_step(params, steps[t].to(dev),
                                         view(tab, [24 + t] * 2), rt)
            seq.append(lg)
        outs["paged"][dev] = torch.stack(seq).cpu()
    for kind, what in (("dense", "prefill"),
                       ("paged", "chunked prefill (chunk 8)")):
        err = (outs[kind]["cuda"] - outs[kind]["cpu"]).abs().max().item()
        log(f"reference: reduced deepseek-r1 float32, {kind} cache, {what} "
            f"+ 8 decode steps, card vs CPU max |logit err| {err:.3e} "
            f"(tol 1e-4)")
        if not err <= 1e-4:
            raise AssertionError(f"reference phase ({kind}): card and CPU "
                                 f"disagree ({err})")
    engines_phase(torch, cfg)


def engines_phase(torch, cfg) -> None:
    """A reduced paged engine and a dense chunked-prefill engine on the
    card, same weights and chunk, under VirtualClock on a shared-prefix
    trace: identical greedy tokens."""
    from repro_torch.serving import (EngineConfig, Scenario, ServingEngine,
                                     VirtualClock)

    base = dict(mode="eaas", num_servers=4, max_batch=4, max_seq=128,
                n_redundant=2, pool_tokens_per_client=128, prefill_chunk=8,
                policy="fair")
    runs, params = {}, None
    for kind in ("dense", "paged"):
        kw = dict(base, kv_mode=kind, kv_block_size=8)
        eng = ServingEngine(cfg, EngineConfig(**kw), params=params, seed=0,
                            clock=VirtualClock(), device="cuda")
        params = eng.params
        res = (Scenario(horizon=0.15, seed=7, max_new=5,
                        vocab=cfg.vocab_size)
               .shared_prefix(n_prefixes=2, prefix_len=16, suffix_len=6)
               .poisson(rate=100)).run(eng)
        runs[kind] = res
    toks = {k: [tuple(r.output_tokens) for r in res.requests]
            for k, res in runs.items()}
    m = runs["paged"].metrics
    log(f"reference: reduced engines on the card, {len(toks['paged'])} "
        f"shared-prefix requests, chunk 8: paged == dense greedy tokens "
        f"{toks['paged'] == toks['dense']}, prefix hit rate "
        f"{m.prefix_hit_rate:.3f}")
    if toks["paged"] != toks["dense"] or not m.prefix_hit_blocks or \
            m.completed != m.total_requests:
        raise AssertionError("reference phase: paged and dense engines "
                             "disagree on the card")


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


DENSE_PATH = ("grouped_gemm", "flash_decode", "combine_slots")
PAGED_PATH = ("grouped_gemm", "paged_flash_decode", "combine_slots")


def _dense_requests(np, cfg, rng):
    """The dense serve's traffic: a 64-token warm-up request, then 8
    requests of 64-512 prompt tokens and 32 greedy tokens."""
    from repro_torch.serving import Request, SamplingParams

    warm = Request(-1, rng.integers(0, cfg.vocab_size, 64, np.int32),
                   SamplingParams(max_new_tokens=2))
    lengths = rng.integers(64, 513, 8)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(n), np.int32),
                    SamplingParams(max_new_tokens=32))
            for i, n in enumerate(lengths)]
    return warm, lengths, reqs


def _serve(torch, eng, warm, reqs, fail: bool, on_start=None):
    """Serve ``warm`` (cuBLAS handles, allocator), then ``reqs`` from a
    fresh clock, metrics and counters — expert server 1 down at steps 10-20
    when ``fail``.  Returns (metrics, launches over the run, [(wall s,
    tokens)] of each decode step that ran)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.metrics import ServingMetrics

    eng.submit(warm)
    eng.run()
    eng.metrics, eng.clock, eng.step_idx = ServingMetrics(), 0.0, 0
    eng.executor.dropped.zero_()
    eng.executor.miss.zero_()
    if on_start is not None:
        on_start(eng)
    for r in reqs:
        eng.submit(r)
    steps = []
    decode = eng._step_decode

    def timed(plan):
        t0 = time.perf_counter()
        decode(plan)                 # WallClock.stop synchronizes inside
        steps.append((time.perf_counter() - t0, len(plan.slots)))

    def on_step(e):
        if fail and e.step_idx == 10:
            e.inject_server_failure(1)
        if fail and e.step_idx == 20:
            e.recover_server(1)

    eng._step_decode = timed
    ops.reset_launches()
    metrics = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    del eng._step_decode             # the class's method again
    return metrics, launches, steps


def _digest(reqs) -> str:
    toks = [list(map(int, r.output_tokens)) for r in reqs]
    return hashlib.sha1(json.dumps(toks).encode()).hexdigest()[:12]


def _halts(metrics):
    """(halted steps, engine-clock seconds they were charged)."""
    n, charged, prev = 0, 0.0, 0.0
    for x in metrics.timeline:
        if x["halted"]:
            n += 1
            charged += x["t"] - prev
        prev = x["t"]
    return n, charged


def serve_phase(torch, get_config):
    """Dense-KV serve at full width through a server failure; returns
    (launches over the run, engine, model config, rng)."""
    import numpy as np

    from repro_torch.serving import EngineConfig, ServingEngine, WallClock

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
    warm, lengths, reqs = _dense_requests(np, cfg, rng)
    metrics, launches, steps = _serve(torch, eng, warm, reqs, fail=True)

    _check_completed("serve", metrics, reqs, cfg)
    # re-prefilling a prompt must reproduce its first greedy token, from
    # finite logits of the expected shape
    logits = eng.executor.prefill(0, reqs[0].prompt)
    if logits.shape != (1, cfg.padded_vocab) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"serve: bad logits {tuple(logits.shape)}")
    if int(logits.argmax()) != reqs[0].output_tokens[0]:
        raise AssertionError("serve: re-prefill changed the first token")
    fails = [e for e in metrics.events if e["event"].startswith("server_")]
    if len(fails) != 2 or _halts(metrics)[0] != 0:
        raise AssertionError(f"serve: failure events {fails}, halted "
                             f"steps {_halts(metrics)[0]} (EAAS: 0)")
    zero = [k for k in DENSE_PATH if launches[k] <= 0]
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
        f"steps, {_step_rate(steps):.1f} tok/s over the decode steps' own "
        f"wall); halted steps 0")
    log(f"serve: TTFT p50 {s['ttft']['p50']} ms p99 {s['ttft']['p99']} ms; "
        f"ITL p50 {s['itl']['p50']} ms p99 {s['itl']['p99']} ms")
    log(f"serve: dropped {int(eng.executor.dropped)} miss "
        f"{int(eng.executor.miss)}; server 1 failed at step 10, recovered "
        f"at step 20; tokens sha1 {_digest(reqs)} (as "
        "repro_torch.tools.serve_variants digests them)")
    log(f"serve: launches {json.dumps(launches)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_decode(torch, eng, cfg, rng, "dense")
    return launches, eng, cfg, rng


def _step_rate(steps) -> float:
    """Tokens per second over the decode steps' own wall time."""
    return sum(n for _, n in steps) / max(sum(t for t, _ in steps), 1e-9)


def _check_completed(label, metrics, reqs, cfg) -> None:
    """Every request completed with 32 in-vocabulary tokens."""
    if metrics.completed != len(reqs):
        raise AssertionError(f"{label}: {metrics.completed}/{len(reqs)} "
                             "done")
    for r in reqs:
        if len(r.output_tokens) != 32 or not all(
                0 <= t < cfg.vocab_size for t in r.output_tokens):
            raise AssertionError(f"{label}: request {r.request_id} "
                                 f"produced {r.output_tokens}")


def paged_serve_phase(torch, cfg, params, rng):
    """Paged-KV serve at full width: 16 requests of 32 greedy tokens at
    t=0 over two shared 256-token system prompts (alternating) with unique
    suffixes of 64-256 tokens; the last two are a bare shared prefix, so
    their admission forks the cached tail block.  The 129-block pool holds
    one maximal request plus slack, so admission gates and preempts.
    Returns the launches over the run and the 16 prompts."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                     ServingEngine, WallClock)

    ecfg = EngineConfig(max_batch=8, max_seq=1024, num_servers=4,
                        n_redundant=2, pool_tokens_per_client=512,
                        kv_mode="paged", kv_block_size=16, kv_num_blocks=129,
                        prefill_chunk=256, policy="fair")
    # warm-up on a throwaway engine: the pool's counters are absolute, so
    # the measured engine starts fresh
    warm = ServingEngine(cfg, ecfg, params=params, clock=WallClock())
    warm.submit(Request(-1, rng.integers(0, cfg.vocab_size, 300, np.int32),
                        SamplingParams(max_new_tokens=2)))
    warm.run()
    del warm
    eng = ServingEngine(cfg, ecfg, params=params, clock=WallClock())
    prefixes = [rng.integers(0, cfg.vocab_size, 256, np.int32)
                for _ in range(2)]
    suffixes = [0 if i >= 14 else int(rng.integers(64, 257))
                for i in range(16)]
    reqs = [Request(i, np.concatenate([
                prefixes[i % 2],
                rng.integers(0, cfg.vocab_size, n)]).astype(np.int32),
                SamplingParams(max_new_tokens=32))
            for i, n in enumerate(suffixes)]
    for r in reqs:
        eng.submit(r)

    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    metrics = eng.run()
    torch.cuda.synchronize()
    launches = ops.launch_counts()

    _check_completed("serve-paged", metrics, reqs, cfg)
    if int(eng.executor.dropped) != 0:
        raise AssertionError(f"serve-paged: {int(eng.executor.dropped)} "
                             "tokens dropped")
    if not (metrics.prefix_hit_blocks > 0 and metrics.kv_cow_forks >= 1
            and metrics.preemptions > 0):
        raise AssertionError(f"serve-paged: kv {metrics.summary()['kv']} "
                             "lacks prefix hits, a COW fork or preemption")
    zero = [k for k in PAGED_PATH if launches[k] <= 0]
    if zero:
        raise AssertionError(f"serve-paged: kernels never launched: {zero}")

    s = metrics.summary()
    log(f"serve-paged: completed {metrics.completed}/{len(reqs)} requests, "
        f"prompt lengths {[len(r.prompt) for r in reqs]}, "
        f"{metrics.total_output_tokens} output tokens in "
        f"{metrics.wall_time:.3f}s ({s['decode_tok_per_s']} tok/s), "
        f"{len(metrics.timeline)} decode steps")
    log(f"serve-paged: TTFT p50 {s['ttft']['p50']} ms p99 "
        f"{s['ttft']['p99']} ms; ITL p50 {s['itl']['p50']} ms p99 "
        f"{s['itl']['p99']} ms")
    log(f"serve-paged: kv {json.dumps(s['kv'])}; dropped "
        f"{int(eng.executor.dropped)} miss {int(eng.executor.miss)}")
    log(f"serve-paged: launches {json.dumps(launches)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_decode(torch, eng, cfg, rng, "paged")
    return launches, [r.prompt for r in reqs]


def _mode_profile(torch, eng, cfg, rng, label: str, slots: int,
                  steps: int = 8) -> None:
    """``slots`` fresh 128-token requests, then ``steps`` decode steps
    timed alone and ``steps`` under the profiler (``_step_profile``): wall,
    device busy (summed over streams) and launches per step."""
    from repro_torch.serving import Request, SamplingParams

    for i in range(slots):
        eng.submit(Request(200 + i, rng.integers(0, cfg.vocab_size, 128)
                           .astype("int32"),
                           SamplingParams(max_new_tokens=2 * steps + 8)))
    for _ in range(slots + 4):
        if len(eng.scheduler.decode_ready()) == slots:
            break
        eng.step()
    if len(eng.scheduler.decode_ready()) != slots:
        raise AssertionError(f"modes ({label}): the batch never filled")
    p = _step_profile(torch, eng, steps)
    eng.run()
    if p is None:
        log(f"modes ({label}): the profiler saw no device time (not "
            "measured)")
        return None
    log(f"modes ({label}): decode step ({slots} live slots of "
        f"{eng.ecfg.max_batch}) wall {p['plain_ms']:.2f} ms, "
        f"{p['wall_ms']:.2f} ms under the profiler, device busy "
        f"{p['busy_ms']:.3f} ms (kernel time summed over streams; "
        f"{p['union_ms']:.3f} ms with any kernel running, so "
        f"{p['busy_ms'] - p['union_ms']:.3f} ms ran concurrently), idle "
        f"share {max(0.0, 1 - p['busy_ms'] / p['plain_ms']):.3f} of the "
        f"plain wall; {p['launches']:.1f} kernel launches and "
        f"{p['copies']:.1f} copies per step")
    top = sorted(p["rows"].items(), key=lambda kv: -kv[1][0])
    log(f"modes ({label}): top device rows (ms/step, calls/step) "
        + "; ".join(f"{k[:48]} {t:.3f} {n:.1f}" for k, (t, n) in top[:6]))
    return p


def decode_modes_phase(torch, cfg, params, smi) -> dict:
    """The dense serve's traffic with no failure, on the dense serve's
    weights, in lockstep, pipelined (microbatch B on a second stream) and
    serialized EAAS decode: the two split modes must give equal token
    digests (the same split shapes on one card); against lockstep, the
    share of equal tokens and the first decode step's logits.  Returns the
    launches of each run."""
    import numpy as np

    from repro_torch.serving import EngineConfig, ServingEngine, WallClock

    out, digests, first, tokens = {}, {}, {}, {}
    for mode in ("lockstep", "pipelined", "serialized"):
        eng = ServingEngine(cfg, EngineConfig(
            max_batch=8, max_seq=1024, num_servers=4, n_redundant=2,
            pool_tokens_per_client=512, decode_mode=mode), params=params,
            clock=WallClock())
        rng = np.random.default_rng(0)
        warm, _, reqs = _dense_requests(np, cfg, rng)

        def on_start(e, mode=mode):
            dec = e.executor.decode

            def capture(toks):
                logits, load = dec(toks)
                if mode not in first:
                    first[mode] = logits.float().clone()
                return logits, load
            e.executor.decode = capture

        metrics, launches, steps = _serve(torch, eng, warm, reqs,
                                          fail=False, on_start=on_start)
        del eng.executor.decode
        _check_completed(f"modes ({mode})", metrics, reqs, cfg)
        zero = [k for k in DENSE_PATH if launches[k] <= 0]
        if zero:
            raise AssertionError(f"modes ({mode}): kernels never launched: "
                                 f"{zero}")
        s = metrics.summary()
        digests[mode] = _digest(reqs)
        tokens[mode] = [t for r in reqs for t in r.output_tokens]
        log(f"modes ({mode}): completed {metrics.completed}/8, tokens sha1 "
            f"{digests[mode]}, dropped {int(eng.executor.dropped)} miss "
            f"{int(eng.executor.miss)}; {_step_rate(steps):.1f} tok/s over "
            f"the decode steps' wall ({len(steps)} steps, median "
            f"{statistics.median(t for t, _ in steps) * 1e3:.2f} ms); TTFT "
            f"p50 {s['ttft']['p50']} p99 {s['ttft']['p99']} ms, ITL p50 "
            f"{s['itl']['p50']} p99 {s['itl']['p99']} ms; launches "
            f"{json.dumps(launches)} ({smi})")
        _mode_profile(torch, eng, cfg, rng, mode, 8)
        out[mode] = launches
        del eng
        gc.collect()
    for mode in ("pipelined", "serialized"):
        same = sum(a == b for a, b in zip(tokens[mode], tokens["lockstep"]))
        err = (first[mode] - first["lockstep"]).abs().max().item()
        log(f"modes ({mode} vs lockstep): {same}/{len(tokens[mode])} tokens "
            f"equal, first decode step's max |logit diff| {err:.4g} (bf16; "
            f"max |logit| {first['lockstep'].abs().max().item():.4g})")
    if digests["pipelined"] != digests["serialized"]:
        raise AssertionError(f"modes: pipelined and serialized tokens "
                             f"differ {digests}")
    if not torch.equal(first["pipelined"], first["serialized"]):
        raise AssertionError("modes: pipelined and serialized first-step "
                             "logits differ")
    return out


# the cluster phases: 4 attention clients over one expert tier, on the
# dense serve's weights
CLUSTER = dict(max_batch=8, max_seq=1024, num_servers=4, n_redundant=2,
               pool_tokens_per_client=512)
DEAD = 1                       # the expert server that fails


def _off_server(np, pool, rank: int):
    """Router bias steering every token off server ``rank``: its 64
    primary experts and the 2 it holds replicas of.  At full width only 8
    of 256 experts have a replica, so a failed server's tokens are missed
    (the dense serve's miss) and a run's tokens then depend on when the
    failure lands; with no traffic on the server its failure moves only
    queued work, and a token stream is the same at any client count and in
    either execution mode — the reference's failover contract, which its
    reduced configuration (every expert replicated) holds by
    construction."""
    E = pool.cfg.moe.num_experts
    per = E // pool.num_servers
    off = set(range(rank * per, (rank + 1) * per))
    off |= {int(e) for e in pool.redundant_table[rank] if e >= 0}
    bias = np.zeros(E, np.float32)
    bias[sorted(off)] = -30.0
    return bias, len(off)


def _cluster_requests(np, cfg):
    """The cluster phases' traffic, drawn like the dense serve's: 16
    requests of 64-512 prompt tokens and 32 greedy tokens."""
    from repro_torch.serving import Request, SamplingParams

    rng = np.random.default_rng(0)
    lengths = rng.integers(64, 513, 16)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), np.int32)
               for n in lengths]
    return lengths, lambda: [Request(i, p, SamplingParams(max_new_tokens=32))
                             for i, p in enumerate(prompts)]


def _cluster(cfg, params, n, clock_factory, off=None, **kw):
    """A cluster on ``params``; ``off``: a server to steer traffic off."""
    import numpy as np

    from repro_torch.serving import Cluster, ClusterConfig, EngineConfig

    ekw = dict(CLUSTER, **{k: v for k, v in kw.items()
                           if k != "frontend_policy"})
    cl = Cluster(cfg, ClusterConfig(
        clients=n, frontend_policy=kw.get("frontend_policy", "round_robin"),
        engine=EngineConfig(**ekw)), clock_factory=clock_factory,
        params=params)
    if off is not None:
        cl.set_skew(_off_server(np, cl.pool, off)[0])
    return cl


def _time_decodes(cl):
    """Wrap every client's decode step: [(wall s, tokens)] over all of
    them (WallClock.stop synchronizes the card inside the step)."""
    steps = []
    for eng in cl.clients:
        def timed(plan, step=eng._step_decode):
            t0 = time.perf_counter()
            step(plan)
            steps.append((time.perf_counter() - t0, len(plan.slots)))
        eng._step_decode = timed
    return steps


def _pct(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def cluster_phase(torch, cfg, params, smi) -> dict:
    """Lockstep cluster under WallClock: the 16 requests through a 1-client
    cluster (server 1 down at cluster steps 30-60), then a 4-client
    round-robin cluster with the same server failure and client 2 failing
    after its second decode step (recovering 40 steps later).  Client 2's
    requests strand; every other request's tokens must equal the 1-client
    run's; the 4 clients hold one weight bank (peak memory < 1.1x the
    1-client run's).  Returns the 4-client run's launches."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import WallClock

    lengths, make = _cluster_requests(np, cfg)
    fail_at = {}

    def on_step(c):
        nxt = c.step_idx + 1
        if nxt == 30:
            c.inject_server_failure(DEAD)
        elif nxt == 60:
            c.recover_server(DEAD)
        if len(c.clients) > 2:
            two = c.clients[2]
            decoded = sum(1 for x in two.metrics.timeline if x["tokens"])
            if "client" not in fail_at and decoded >= 2:
                fail_at["client"] = nxt
                c.fail_client(2)
            elif fail_at.get("client") and nxt == fail_at["client"] + 40:
                c.recover_client(2)

    runs = {}
    for n in (1, 4):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        cl = _cluster(cfg, params, n, WallClock, off=DEAD)
        reqs = make()
        for r in reqs:
            cl.submit(r)
        steps = _time_decodes(cl)
        ops.reset_launches()
        m = cl.run(on_step=on_step)
        torch.cuda.synchronize()
        runs[n] = dict(cl=cl, reqs=reqs, m=m, steps=steps,
                       launches=ops.launch_counts(),
                       wall=time.perf_counter() - t0,
                       peak=torch.cuda.max_memory_allocated())
    one, four = runs[1], runs[4]
    m = four["m"]
    done = [r.request_id for r in four["reqs"] if r.finish_time is not None]
    want = _digest([one["reqs"][i] for i in done])
    got = _digest([four["reqs"][i] for i in done])
    for n, r in runs.items():
        walls = [w for w, _ in r["steps"]]
        tok = sum(k for _, k in r["steps"])
        log(f"cluster ({n} client{'s' if n > 1 else ''}, lockstep, "
            f"WallClock): completed {r['m'].completed}/16, failed "
            f"{r['m'].failed_requests}, routed {r['m'].routed}; "
            f"{r['m'].total_output_tokens} tokens; {len(walls)} client "
            f"decode steps, wall p50 {_pct(walls, 50) * 1e3:.2f} ms p99 "
            f"{_pct(walls, 99) * 1e3:.2f} ms; "
            f"{tok / max(sum(walls), 1e-9):.1f} tok/s over the decode "
            f"steps' wall (the clients take turns on "
            f"one card), {r['m'].total_output_tokens / r['wall']:.1f} tok/s "
            f"over the phase's elapsed {r['wall']:.2f} s, "
            f"{r['m'].decode_throughput:.1f} tok/s on the cluster clock "
            f"(each client's own clock: clients as parallel hardware); "
            f"TTFT p50 {r['m'].ttft_stats()['p50'] * 1e3:.1f} ms, ITL p50 "
            f"{r['m'].itl_stats()['p50'] * 1e3:.2f} p99 "
            f"{r['m'].itl_stats()['p99'] * 1e3:.2f} ms; peak memory "
            f"{r['peak'] / 2**30:.2f} GiB; launches "
            f"{json.dumps(r['launches'])} ({smi})")
    n_off = _off_server(np, four["cl"].pool, DEAD)[1]
    log(f"cluster: prompt lengths {lengths.tolist()}; router bias -30 on "
        f"the {n_off} experts server {DEAD} holds (its failure moves no "
        f"token)")
    log(f"cluster: client 2 failed at cluster step {fail_at.get('client')}"
        f" stranding {m.failed_requests}; tokens sha1 of the {len(done)} "
        f"survivors {got}, the 1-client run's same requests {want}; "
        f"1-client tokens sha1 {_digest(one['reqs'])}; peak memory 4 "
        f"clients / 1 client {four['peak'] / one['peak']:.4f}")
    bad = []
    if one["m"].completed != 16 or one["m"].failed_requests:
        bad.append("the 1-client run did not complete 16/16")
    if not m.failed_requests or m.completed != 16 - m.failed_requests \
            or len(done) != m.completed:
        bad.append(f"completed {m.completed}, failed {m.failed_requests}")
    if got != want:
        bad.append("survivors' tokens differ from the 1-client run's")
    if four["peak"] >= 1.1 * one["peak"]:
        bad.append("four clients peaked above 1.1x one client")
    zero = [k for k in DENSE_PATH if four["launches"][k] <= 0]
    if zero:
        bad.append(f"kernels never launched: {zero}")
    if bad:
        raise AssertionError(f"cluster: {bad}")
    _cluster_profile(torch, four["cl"], cfg)
    del four["cl"], one["cl"]
    return four["launches"]


def _cluster_profile(torch, cl, cfg, steps: int = 8) -> None:
    """8 fresh 128-token requests (2 a client), then ``steps`` cluster
    steps — each one client's decode — timed alone and under the profiler
    (``_step_profile``): launches per client decode step."""
    import numpy as np

    from repro_torch.serving import Request, SamplingParams

    rng = np.random.default_rng(9)
    for i in range(8):
        cl.submit(Request(300 + i, rng.integers(0, cfg.vocab_size, 128)
                          .astype("int32"),
                          SamplingParams(max_new_tokens=4 * steps + 8)))
    for _ in range(64):
        if not cl.ingress and all(
                not c.queue and not c.scheduler._progress
                for c in cl.clients):
            break
        cl.step()
    p = _step_profile(torch, cl, steps)
    cl.run()
    if p is None:
        log("cluster: the profiler saw no device time (not measured)")
        return
    log(f"cluster: client decode step (2 live slots of 8) wall "
        f"{p['plain_ms']:.2f} ms, device busy {p['busy_ms']:.3f} ms, idle "
        f"share {max(0.0, 1 - p['busy_ms'] / p['plain_ms']):.3f}; "
        f"{p['launches']:.1f} kernel launches and {p['copies']:.1f} copies "
        f"per client decode step")


def async_cluster_phase(torch, cfg, params, smi) -> dict:
    """The 16 requests through 4 clients under VirtualClock, lockstep and
    then async (one shared tier, depth 2, per-expert lanes): server 3
    slowed 3x at cluster step 25, server 1 failing at the first step after
    60 with micro-batches queued on it (the async run's step, reused by
    lockstep) and recovering 40 steps later.  The async digest must equal
    lockstep's; micro-batches must re-dispatch.  Times are the
    VirtualClock's model, not the card's.  Returns the async run's
    launches."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import VirtualClock

    _, make = _cluster_requests(np, cfg)
    events = {}
    runs = {}
    for mode in ("async", "lockstep"):
        def on_step(c, mode=mode):
            nxt = c.step_idx + 1
            if nxt == 25:
                c.set_server_speed(3, 3.0)
            if mode == "async" and "fail" not in events and nxt > 60 \
                    and c._tier.queues[DEAD].in_flight() > 0:
                events["fail"] = nxt
                events["queued"] = c._tier.queues[DEAD].in_flight()
            if nxt == events.get("fail"):
                c.inject_server_failure(DEAD)
            elif nxt == events.get("fail", -99) + 40:
                c.recover_server(DEAD)
        cl = _cluster(cfg, params, 4, VirtualClock, off=DEAD,
                      exec_mode=mode, async_depth=2, queue_mode="expert")
        reqs = make()
        for r in reqs:
            cl.submit(r)
        ops.reset_launches()
        t0 = time.perf_counter()
        m = cl.run(on_step=on_step)
        torch.cuda.synchronize()
        runs[mode] = dict(cl=cl, reqs=reqs, m=m, wall=time.perf_counter() - t0,
                          launches=ops.launch_counts())
    a, lk = runs["async"], runs["lockstep"]
    tier = a["cl"]._tier
    qd = a["m"].queue_delay_stats()
    for mode, r in runs.items():
        s = r["m"]
        log(f"cluster-async ({mode}, VirtualClock): completed "
            f"{s.completed}/16, tokens sha1 {_digest(r['reqs'])}; virtual "
            f"(the VirtualClock's model, not the card) "
            f"{s.decode_throughput:.1f} tok/s, ITL p50 "
            f"{s.itl_stats()['p50'] * 1e3:.3f} p99 "
            f"{s.p99_itl * 1e3:.3f} ms, TTFT p50 "
            f"{s.ttft_stats()['p50'] * 1e3:.3f} ms; the phase's wall on the "
            f"card {r['wall']:.2f} s; launches {json.dumps(r['launches'])} "
            f"({smi})")
    log(f"cluster-async: server {DEAD} failed at cluster step "
        f"{events.get('fail')} with {events.get('queued')} micro-batches "
        f"queued on it; re-dispatched {tier.redispatched}, enqueued "
        f"{tier.enqueued}, completed {tier.completed}, cancelled "
        f"{tier.cancelled}; queue delay (virtual) p50 {qd['p50'] * 1e3:.4f} "
        f"p99 {qd['p99'] * 1e3:.4f} ms over {len(a['m'].queue_delays)} "
        f"micro-batches; migration none")
    bad = []
    if _digest(a["reqs"]) != _digest(lk["reqs"]):
        bad.append("async tokens differ from lockstep's")
    if a["m"].completed != 16 or lk["m"].completed != 16:
        bad.append("not 16/16 completed")
    if tier.redispatched <= 0 or tier.in_flight() != 0:
        bad.append(f"re-dispatched {tier.redispatched}, in flight "
                   f"{tier.in_flight()}")
    zero = [k for k in DENSE_PATH if a["launches"][k] <= 0]
    if zero:
        bad.append(f"kernels never launched: {zero}")
    if bad:
        raise AssertionError(f"cluster-async: {bad}")
    _wave_profile(torch, a["cl"], cfg)
    return a["launches"]


def _wave_profile(torch, cl, cfg, steps: int = 24) -> None:
    """Kernel launches per async decode wave: 8 fresh requests (2 a
    client) on the async cluster, then ``steps`` cluster steps under
    torch.profiler once every client decodes; a step either dispatches a
    wave (``decode_masked``) or handles an event, which launches
    nothing."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request, SamplingParams

    rng = np.random.default_rng(10)
    for i in range(8):
        cl.submit(Request(400 + i, rng.integers(0, cfg.vocab_size, 128)
                          .astype("int32"),
                          SamplingParams(max_new_tokens=48)))
    for _ in range(200):
        if not cl.ingress and all(not c.queue and not c.scheduler._progress
                                  for c in cl.clients):
            break
        cl.step()
    waves = [0]
    for eng in cl.clients:
        def counted(tokens, mask, f=eng.executor.decode_masked):
            waves[0] += 1
            return f(tokens, mask)
        eng.executor.decode_masked = counted
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            cl.step()
        torch.cuda.synchronize()
    for eng in cl.clients:
        del eng.executor.decode_masked
    cl.run()
    rows = [(e.key, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    copies = sum(n for k, n in rows if k.startswith(("Memcpy", "Memset")))
    kernels = sum(n for _, n in rows) - copies
    if not rows or not waves[0]:
        log("cluster-async: the profiler saw no device time or no wave "
            "(not measured)")
        return
    log(f"cluster-async: {waves[0]} waves in {steps} cluster steps: "
        f"{kernels / waves[0]:.1f} kernel launches and "
        f"{copies / waves[0]:.1f} copies per wave")


def paged_cluster_phase(torch, cfg, params, prompts, smi) -> dict:
    """The paged serve's 16 shared-prefix requests through 4 paged
    lockstep clients (the paged serve's engine settings), routed by
    session affinity, then round robin: affinity's prefix hit rate must be
    at least round robin's.  Returns the affinity run's launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving import Request, SamplingParams, WallClock

    rates, first = {}, None
    for policy in ("session_affinity", "round_robin"):
        cl = _cluster(cfg, params, 4, WallClock, kv_mode="paged",
                      kv_block_size=16, kv_num_blocks=129, prefill_chunk=256,
                      policy="fair", frontend_policy=policy)
        reqs = [Request(i, p, SamplingParams(max_new_tokens=32))
                for i, p in enumerate(prompts)]
        for r in reqs:
            cl.submit(r)
        ops.reset_launches()
        t0 = time.perf_counter()
        m = cl.run()
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        hits = sum(c.prefix_hit_blocks for c in m.per_client)
        probes = sum(c.prefix_lookup_blocks for c in m.per_client)
        rates[policy] = m.prefix_hit_rate
        log(f"cluster-paged ({policy}): completed {m.completed}/16, routed "
            f"{m.routed}, prefix hit rate {m.prefix_hit_rate:.4f} ({hits} "
            f"of {probes} blocks), preemptions {m.preemptions}, tokens sha1 "
            f"{_digest(reqs)}, {time.perf_counter() - t0:.2f} s; launches "
            f"{json.dumps(launches)} ({smi})")
        zero = [k for k in PAGED_PATH if launches[k] <= 0]
        if m.completed != 16 or zero:
            raise AssertionError(f"cluster-paged ({policy}): completed "
                                 f"{m.completed}, never launched {zero}")
        first = first or launches
        del cl
    if rates["session_affinity"] < rates["round_robin"]:
        raise AssertionError(f"cluster-paged: affinity's hit rate below "
                             f"round robin's {rates}")
    return first


# the baselines' restart stalls at EngineConfig's defaults
RESTART = {"monolithic_ep": 50, "tp": 12}


def baselines_phase(torch, cfg, smi) -> dict:
    """The dense serve's traffic and failure (server 1 down at steps 10-20)
    in monolithic EP (4 servers x 64 slots, no replicas) and TP (one server
    of all 256 experts, tp_batch_cap = max_batch // 2), each on its own
    seeded weights, one engine at a time.  All 8 requests must complete,
    the halted steps equal the mode's restart steps, miss 0 (neither mode
    consults liveness), every dense-path kernel launched.  Returns the
    launches of each run."""
    import numpy as np

    from repro_torch.serving import EngineConfig, ServingEngine, WallClock

    out = {}
    for mode in ("monolithic_ep", "tp"):
        eng = ServingEngine(cfg, EngineConfig(
            mode=mode, max_batch=8, max_seq=1024, num_servers=4,
            n_redundant=2, pool_tokens_per_client=512, tp_batch_cap=4),
            seed=0, clock=WallClock())
        torch.cuda.synchronize()
        G = eng.params["blocks"]["moe"]["servers"]["w_gate"].shape[2]
        rng = np.random.default_rng(0)
        warm, _, reqs = _dense_requests(np, cfg, rng)
        metrics, launches, steps = _serve(torch, eng, warm, reqs, fail=True)
        _check_completed(f"baselines ({mode})", metrics, reqs, cfg)
        halted, charged = _halts(metrics)
        drop, miss = int(eng.executor.dropped), int(eng.executor.miss)
        s = metrics.summary()
        gib = torch.cuda.memory_allocated() / 2**30
        log(f"baselines ({mode}): {eng.pool.num_servers} server(s) x {G} "
            f"slots (the grouped GEMM's G), {gib:.1f} GiB; completed "
            f"{metrics.completed}/8, tokens sha1 {_digest(reqs)}; halted "
            f"steps {halted} (restart {RESTART[mode]}), charged {charged * 1e3:.2f} ms on the engine "
            f"clock (a charge: the engine does not sleep through a "
            f"restart); dropped {drop} miss {miss}; {_step_rate(steps):.1f} "
            f"tok/s over the {len(steps)} non-halted decode steps' wall "
            f"(median {statistics.median(t for t, _ in steps) * 1e3:.2f} "
            f"ms); TTFT p50 {s['ttft']['p50']} p99 {s['ttft']['p99']} ms, "
            f"ITL p50 {s['itl']['p50']} p99 {s['itl']['p99']} ms (halts "
            f"included); launches {json.dumps(launches)} ({smi})")
        _mode_profile(torch, eng, cfg, rng, mode,
                      4 if mode == "tp" else 8)
        bad = []
        if halted != RESTART[mode]:
            bad.append(f"halted {halted} steps, not {RESTART[mode]}")
        if miss:
            bad.append(f"miss {miss}")
        zero = [k for k in DENSE_PATH if launches[k] <= 0]
        if zero:
            bad.append(f"kernels never launched: {zero}")
        if bad:
            raise AssertionError(f"baselines ({mode}): {bad}")
        out[mode] = launches
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


CONTROL_PATH = ("grouped_gemm", "flash_decode", "combine_slots")
# the live controller and the scripted events, by engine step: 8 prefills
# take steps 1-8, the 31 decode steps 9-39
PAGE_OUT_STEP, REBALANCE_STEP = 20, 21
SCALE_STEPS = {23: 8, 27: 2, 31: 4}


def _weights_consistent(torch, eng) -> None:
    """Every redundant slot holds its expert's primary bit for bit; every
    empty slot is zero."""
    pool = eng.pool
    per = pool.cfg.moe.num_experts // pool.num_servers
    for name, w in eng.params["blocks"]["moe"]["servers"].items():
        for s, row in enumerate(pool.redundant_table):
            for j, e in enumerate(row):
                slot = w[:, s, per + j]
                ok = (torch.equal(slot, w[:, e // per, e % per]) if e >= 0
                      else not bool(slot.any()))
                if not ok:
                    raise AssertionError(
                        f"control plane: {name} server {s} slot {per + j} "
                        f"(expert {e}) is not its primary / zero")


def _slot_bytes(cfg) -> int:
    """Bytes of one expert slot over both MoE layers and the three
    weights (w_gate, w_up, w_down), bf16."""
    return 2 * 3 * cfg.d_model * cfg.moe.d_expert * 2


def control_plane_phase(torch, cfg, smi) -> dict:
    """Full-width deepseek-r1 (1 dense + 2 MoE blocks), dense KV,
    WallClock, 4 servers x (64 + 2) slots, a Zipf(1.2) router skew from
    step 0: the same 8 requests served frozen, then elastic — the live
    RebalanceController, a page-out of 16 experts with a cold start, a
    one-shot rebalance and scale_to 8 -> 2 -> 4, all in place on one set of
    weights.  Tokens must be identical, nothing dropped or missed, the
    replicas bitwise their primaries.  Returns the elastic run's
    launches."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                     ServingEngine, VirtualClock, WallClock,
                                     zipf_bias)

    E = cfg.moe.num_experts
    # capacity at S = 4 (prefill): ceil(1664 * 8 / 4 * 1.25 / 8) * 8 = 4160
    # >= 512 tokens x top-8, so no routing can drop a prompt token; the
    # resizes come after the last prefill (decode: 64 picks a step)
    base = dict(max_batch=8, max_seq=1024, num_servers=4, n_redundant=2,
                pool_tokens_per_client=1664)
    bias = zipf_bias(E, 1.2, scale=1.0, seed=15)
    rng = np.random.default_rng(15)
    lengths = rng.integers(64, 513, 8)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), np.int32)
               for n in lengths]
    slot_b = _slot_bytes(cfg)
    vclock = VirtualClock()
    log(f"control plane: {smi}; deepseek-r1 full width, 2 MoE blocks, "
        f"4 servers x ({E // 4} + 2) slots, pool_tokens_per_client "
        f"{base['pool_tokens_per_client']}, zipf_bias(256, 1.2, scale=1.0, "
        f"seed=15), prompt lengths {lengths.tolist()}")

    def serve(eng, on_step=None):
        eng.set_skew(bias)
        reqs = [Request(i, p, SamplingParams(max_new_tokens=32))
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        ops.reset_launches()
        metrics = eng.run(on_step=on_step)
        torch.cuda.synchronize()
        return reqs, metrics, ops.launch_counts()

    def digest(reqs):
        toks = [list(map(int, r.output_tokens)) for r in reqs]
        return hashlib.sha1(json.dumps(toks).encode()).hexdigest()[:12]

    def decode_timer(eng, record):
        """Wrap the engine's decode step: wall seconds by pool size
        (WallClock.stop synchronizes the card inside it)."""
        step = eng._step_decode

        def timed(plan):
            t0 = time.perf_counter()
            step(plan)
            record.setdefault(eng.pool.num_servers, []).append(
                time.perf_counter() - t0)
        eng._step_decode = timed

    # ---- frozen: no control events, no live controller ------------------
    frozen = ServingEngine(cfg, EngineConfig(**base), seed=0,
                           clock=WallClock())
    frozen_steps = {}
    decode_timer(frozen, frozen_steps)
    f_reqs, f_m, f_launch = serve(frozen)
    _check_completed("control plane (frozen)", f_m, f_reqs, cfg)
    f_drop, f_miss = int(frozen.executor.dropped), int(frozen.executor.miss)
    params = frozen.params
    del frozen                  # (its decode timer holds a cycle: collect)
    gc.collect()
    torch.cuda.synchronize()
    resident0 = torch.cuda.memory_allocated()

    # ---- elastic: the same weights, the control plane at work ------------
    eng = ServingEngine(cfg, EngineConfig(
        **base, rebalance_interval=1e-3, rebalance_chunk=2,
        rebalance_min_gain=0.0), params=params, clock=WallClock())
    del params
    steps = {}
    decode_timer(eng, steps)
    chunks, scales, page = [], [], {}
    source = {"now": "live controller"}
    migrate = eng.apply_migration

    def timed_migration(copies):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        migrate(copies)
        ev[1].record()
        ev[1].synchronize()
        n_copy = sum(1 for _, _, e in copies if e >= 0)
        chunks.append({"source": source["now"], "copies": n_copy,
                       "zeroed": len(copies) - n_copy,
                       "device_ms": ev[0].elapsed_time(ev[1]),
                       "bytes": (2 * n_copy + len(copies) - n_copy)
                       * slot_b})
    eng.apply_migration = timed_migration

    resize = eng.scale_to

    def timed_scale(n):
        old = eng.pool.num_servers
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        alloc0 = torch.cuda.memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        resize(n)
        ev[1].record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        alloc1 = torch.cuda.memory_stats()
        # the caching allocator's own work in the window: fresh device
        # allocations, releases and out-of-memory retries
        allocator = {k: alloc1.get(k, 0) - alloc0.get(k, 0) for k in (
            "num_device_alloc", "num_device_free", "num_alloc_retries")}
        peak = torch.cuda.max_memory_allocated()
        after = torch.cuda.memory_allocated()
        red = eng.pool.redundant_table
        L2 = E // n + red.shape[1]
        # one stacked weight tensor (a third of a slot's bytes), the larger
        # of the old and the new: growing, the resident set grows name by
        # name, and the last name is built on top of the others' new ones
        one = max(n * L2, old * (E // old + red.shape[1])) * slot_b // 3
        read_slots = E + int((red >= 0).sum())
        nbytes = (read_slots + n * L2) * slot_b
        scales.append({"from": old, "to": n,
                       "device_ms": ev[0].elapsed_time(ev[1]),
                       "wall_ms": wall * 1e3, "bytes": nbytes,
                       "bound_ms": nbytes / PEAK_BYTES * 1e3,
                       "resident_gib": resident / 2**30,
                       "after_gib": after / 2**30,
                       "peak_gib": peak / 2**30,
                       "one_tensor_gib": one / 2**30,
                       "reserved_gib": torch.cuda.memory_reserved() / 2**30,
                       "allocator": allocator})
        limit = max(resident, after) + 1.05 * one
        if peak > limit:
            raise AssertionError(
                f"control plane: scale_to({n}) peaked at {peak / 2**30:.2f} "
                f"GiB, above the larger resident set ({resident / 2**30:.2f} "
                f"/ {after / 2**30:.2f} GiB) + one stacked tensor "
                f"{one / 2**30:.2f} GiB + 5 %")

    eng.scale_to = timed_scale
    # launches by pool size: serve() zeroes the counts before the run
    seen = {"launch": dict.fromkeys(ops.launch_counts(), 0), "size": 4}
    by_size = {}

    def tally():
        now = ops.launch_counts()
        acc = by_size.setdefault(seen["size"], dict.fromkeys(now, 0))
        for k in now:
            acc[k] += now[k] - seen["launch"][k]
        seen["launch"], seen["size"] = now, eng.pool.num_servers

    def on_step(e):
        nxt = e.step_idx + 1                  # the step about to run
        if nxt == PAGE_OUT_STEP:
            ema = e.pool.stats.ema
            order = np.argsort(ema, kind="stable")
            victims = [int(x) for x in order[:15]] + [int(order[-1])]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            source["now"] = "page-out"
            paged = e.page_out_experts(victims)
            torch.cuda.synchronize()
            zero = [c for c in chunks if c["source"] == "page-out"]
            page.update(experts=len(paged), hottest=int(order[-1]),
                        wall_ms=(time.perf_counter() - t0) * 1e3,
                        zeroed_slots=sum(c["zeroed"] for c in zero),
                        device_ms=sum(c["device_ms"] for c in zero))
            source["now"] = "live controller"
        elif nxt == REBALANCE_STEP:
            before = e.metrics.rebalances
            source["now"] = "one-shot rebalance"
            e.rebalance()
            source["now"] = "live controller"
            if e.metrics.rebalances != before + 1:
                raise AssertionError("control plane: the one-shot "
                                     "rebalance changed no placement")
            _weights_consistent(torch, e)
        elif nxt in SCALE_STEPS:
            live = sum(r is not None for r in e.slots)
            if e.queue or len(e.scheduler.decode_ready()) != live:
                raise AssertionError("control plane: a resize before the "
                                     "last prefill")
            tally()
            e.scale_to(SCALE_STEPS[nxt])
            seen["size"] = e.pool.num_servers

    e_reqs, e_m, e_launch = serve(eng, on_step)
    tally()
    _check_completed("control plane (elastic)", e_m, e_reqs, cfg)
    e_drop, e_miss = int(eng.executor.dropped), int(eng.executor.miss)
    d_f, d_e = digest(f_reqs), digest(e_reqs)
    trace = [4] + [x["to"] for x in scales]
    log(f"control plane: frozen tokens sha1 {d_f}, elastic tokens sha1 "
        f"{d_e}; dropped {f_drop} / {e_drop}, miss {f_miss} / {e_miss}; "
        f"pool trace {' -> '.join(map(str, trace))}")
    m = e_m
    log(f"control plane: rebalances {m.rebalances} (noops "
        f"{m.rebalance_noops}), migrated experts {m.migrated_experts}, "
        f"migration time {m.migration_time * 1e3:.3f} ms on the clock, "
        f"expert page-outs {m.expert_page_outs}, cold starts "
        f"{m.cold_starts}; launches by pool size {json.dumps(by_size)}")
    for c in chunks:
        if c["source"] == "page-out":
            continue
        c["bound_ms"] = c["bytes"] / PEAK_BYTES * 1e3
        c["bound_share"] = c["bound_ms"] / max(c["device_ms"], 1e-9)
        c["virtual_ms"] = vclock.stop("migrate", tokens=c["copies"]) * 1e3
        log(f"control plane: migration chunk {json.dumps(c)} ({smi})")
    for sc in scales:
        sc["bound_share"] = sc["bound_ms"] / max(sc["device_ms"], 1e-9)
        log(f"control plane: scale_to {json.dumps(sc)} ({smi}; the "
            f"reference's VirtualClock charges a resize nothing)")
    log(f"control plane: page-out {json.dumps(page)} ({smi}; "
        f"VirtualClock: no charge, cold start {vclock.cold_start_base} s "
        "per expert)")
    def med(rec):
        return {n: statistics.median(v) * 1e3 for n, v in sorted(rec.items())}
    log(f"control plane: decode step wall ms (median) by pool size, "
        f"elastic {json.dumps(med(steps))}, frozen "
        f"{json.dumps(med(frozen_steps))} ({smi})")
    log(f"control plane: memory resident after the frozen run "
        f"{resident0 / 2**30:.2f} GiB")

    _weights_consistent(torch, eng)
    bad = []
    if d_f != d_e:
        bad.append("elastic tokens differ from frozen")
    if (f_drop, f_miss, e_drop, e_miss) != (0, 0, 0, 0):
        bad.append("a token was dropped or missed")
    if m.rebalances < 2 or m.migrated_experts <= 0:
        bad.append("fewer than 2 rebalances or no migrated expert")
    if m.expert_page_outs <= 0 or m.cold_starts <= 0:
        bad.append("no page-out or no cold start")
    if trace != [4, 8, 2, 4]:
        bad.append(f"pool trace {trace}")
    for n in (4, 8, 2):
        if any(by_size.get(n, {}).get(k, 0) <= 0 for k in CONTROL_PATH):
            bad.append(f"a kernel never launched at S = {n}")
    if not any(c["copies"] for c in chunks):
        bad.append("no migration chunk copied weights")
    if bad:
        raise AssertionError(f"control plane: {bad}")
    del eng
    return e_launch


def _step_profile(torch, eng, steps: int):
    """``steps`` decode steps timed on the host clock, then ``steps`` more
    under torch.profiler (so its overhead touches no reported latency):
    wall ms, device busy ms, launches and copies per step, and the device
    rows as {name: (ms per step, calls per step)}; None if the profiler
    saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    # device-side rows only: a CPU op's row repeats its kernels' time
    rows = {e.key: (e.self_device_time_total / 1e3 / steps, e.count / steps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0}
    busy_ms = sum(t for t, _ in rows.values())
    if busy_ms <= 0:
        return None
    copies = sum(n for key, (_, n) in rows.items()
                 if key.startswith(("Memcpy", "Memset")))
    # the time the device ran anything at all: the union of its operations'
    # intervals (below the sum when two streams' kernels ran at once)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"plain_ms": plain_ms, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "union_ms": union / 1e3 / steps,
            "launches": sum(n for _, n in rows.values()) - copies,
            "copies": copies, "rows": rows}


@contextlib.contextmanager
def _old_combine(torch):
    """Route the MoE layer's combine through the stage it ran before the
    slot entry (``old_combine_stage``)."""
    from repro_torch.core import dispatch

    fused = dispatch.combine
    dispatch.combine = (
        lambda responses, slot, out_dtype=None, addend=None:
        old_combine_stage(torch, responses, slot, out_dtype, addend))
    try:
        yield
    finally:
        dispatch.combine = fused


def profile_decode(torch, eng, cfg, rng, label: str,
                   steps: int = 8) -> None:
    """Where a full-batch decode step's time goes: 8 fresh requests, then
    ``steps`` decode steps timed alone and ``steps`` under the profiler
    (``_step_profile``), with the combine stage as it runs now and, for the
    same count of steps, as it ran before the slot entry; the device rows
    whose calls per step differ between the two hold the stage's kernels
    (beside other calls of the same kernels: the difference is the
    stage's)."""
    from repro_torch.serving import Request, SamplingParams

    for i in range(8):
        eng.submit(Request(100 + i, rng.integers(0, cfg.vocab_size, 128)
                           .astype("int32"),
                           SamplingParams(max_new_tokens=4 * steps + 40)))
    # the 8 prefills (interleaved with decode steps under the fair policy)
    for _ in range(32):
        if len(eng.scheduler.decode_ready()) == 8:
            break
        eng.step()
    if len(eng.scheduler.decode_ready()) != 8:
        raise AssertionError(f"profile ({label}): the batch never filled")
    now = _step_profile(torch, eng, steps)
    with _old_combine(torch):
        before = _step_profile(torch, eng, steps)
    eng.run()
    if now is None or before is None:
        log(f"profile ({label}): the profiler saw no device time "
            "(not measured)")
        return
    for stage, p in (("slot entry", now), ("old combine stage", before)):
        log(f"profile ({label}, {stage}): decode step (8 slots, full batch) "
            f"wall {p['plain_ms']:.2f} ms ({8e3 / p['plain_ms']:.1f} tok/s), "
            f"{p['wall_ms']:.2f} ms under the profiler, device busy "
            f"{p['busy_ms']:.3f} ms, idle share "
            f"{max(0.0, 1 - p['busy_ms'] / p['wall_ms']):.3f} under the "
            f"profiler ({max(0.0, 1 - p['busy_ms'] / p['plain_ms']):.3f} of "
            f"the plain wall); {p['launches']:.1f} kernel launches and "
            f"{p['copies']:.1f} copies per step")
    top = sorted(now["rows"].items(), key=lambda kv: -kv[1][0])
    for key, (ms, n) in top[:12]:
        log(f"profile ({label}): {ms:8.3f} ms/step {n:6.1f} calls/step  "
            f"{key[:90]}")
    # the combine stage's rows: those whose calls per step moved
    moved = [0.0, 0.0]
    for key in sorted(set(now["rows"]) | set(before["rows"])):
        t1, n1 = now["rows"].get(key, (0.0, 0.0))
        t0, n0 = before["rows"].get(key, (0.0, 0.0))
        if n1 != n0:
            moved[0] += t0
            moved[1] += t1
            log(f"profile ({label}, combine stage): old {t0:8.4f} ms/step "
                f"{n0:6.1f} calls -> slot entry {t1:8.4f} ms/step {n1:6.1f} "
                f"calls  {key[:80]}")
    log(f"profile ({label}, combine stage): rows that moved, old "
        f"{moved[0]:.4f} ms/step -> slot entry {moved[1]:.4f} ms/step "
        f"(difference {moved[0] - moved[1]:.4f} ms/step, "
        f"{before['launches'] - now['launches']:.1f} launches)")


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
    entry = ""
    for line in info.get("log", "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1][-72:]      # the mangled name's tail
        elif "registers" in line:
            log(f"build: {entry}: {line.split(':', 1)[-1].strip()}")
        elif line.startswith("=="):
            log(f"build: {line.strip()}")

    cfg = get_config("deepseek-r1")
    cases, floor = kernels_phase(torch, cfg)
    reference_phase(torch, get_config)
    launches, eng, serve_cfg, rng = serve_phase(torch, get_config)
    paged_launches, paged_prompts = paged_serve_phase(torch, serve_cfg,
                                                      eng.params, rng)
    mode_launches = decode_modes_phase(torch, serve_cfg, eng.params, smi)
    # the cluster phases share the dense serve's weights (one bank on the
    # card for every client); they run before the baselines free them
    cluster_launches = cluster_phase(torch, serve_cfg, eng.params, smi)
    async_launches = async_cluster_phase(torch, serve_cfg, eng.params, smi)
    cpaged_launches = paged_cluster_phase(torch, serve_cfg, eng.params,
                                          paged_prompts, smi)
    # the baselines have their own layouts, and the control plane owns its
    # weights (it reshards them in place): one full-width model at a time
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    mode_launches.update(baselines_phase(torch, serve_cfg, smi))
    control_launches = control_plane_phase(torch, serve_cfg, smi)

    def entry(name):
        cs = cases[name]
        head = cs[0]                      # the decode shape: most launches
        src, replaces = SOURCES[name]
        # each kernel's count from the run of the path that carries it
        main = paged_launches if name not in DENSE_PATH else launches
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": main[name],
            "launches_by_phase": {"serve": launches[name],
                                  "serve-paged": paged_launches[name],
                                  **{f"modes ({m})": n[name]
                                     for m, n in mode_launches.items()},
                                  "control-plane": control_launches[name],
                                  "cluster": cluster_launches[name],
                                  "cluster-async": async_launches[name],
                                  "cluster-paged": cpaged_launches[name]},
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "card": smi, "cases": cs}

    # kernel 4 is one CUDA body with two entries: the slot entry carries
    # the serving path, the direct entry (the Pallas kernel's signature)
    # is listed under it
    summary = [entry(n) for n in ("grouped_gemm", "flash_decode",
                                  "paged_flash_decode", "combine_slots")]
    summary[-1].update(launch_floor=floor,
                       entries=[entry("combine_weighted")])
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
