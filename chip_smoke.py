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
   2 server buffers, the shapes of pool sizes 8 and 2);
14. reference, the other families: reduced arctic-480b, gemma3-4b (10
   layers: a group of 5 local + 1 global and 4 remainder locals; the
   80-token prompt wraps the 64-slot rings), qwen2-vl-2b (text ids and an
   image grid's M-RoPE ids), minitron-8b (squared ReLU), phi3-medium-14b,
   zamba2-2.7b, rwkv6-7b and whisper-base (seeded frames) in float32, card
   (CUDA kernels) against the same weights on the CPU: prefill logits plus
   8 teacher-forced decode steps within 1e-4 (zamba2 5e-4: its reduced
   model moves its logits by more than 5e-5 under a 1e-7 change of its
   inputs);
15. disaggregated: the paper's protocol-literal tier at full deepseek-r1
   width, one MoE layer, 2 clients x 8 expert servers (32 primaries + 8
   replicas each) polling their shared-buffer slots: one dynamic batch per
   server holds both clients' rows, the grouped GEMM launches (its
   widening route: the float32 payload against bf16 weights); server 0
   killed silently, then a straggler (slow_factor 50), then re-registered:
   retries > 0 and outputs within 1e-3 of the healthy pass; per server its
   batches, rows, tick wall and the three GEMMs' device time beside their
   bytes bound;
16. arctic: arctic-480b at full width (128 experts top-2 softmax, d_expert
   4864, the dense residual FFN; depth cut 35 -> 2 MoE layers, ~59 GB)
   through the lockstep EAAS engine, the dense serve's traffic and server
   failure: 8/8 complete; the grouped GEMM (G = 34), flash decode and the
   combine's slot entry launch; TTFT / ITL, tok/s, launches per decode
   step, peak memory, the token digest;
17. gemma3: gemma3-4b at full width and full depth (34 layers, window
   1024, d_head 256, vocab 262144) through the dense engine (no expert
   tier), whole-prompt prefill of 8 prompts of 1100-1800 tokens (every
   ring wraps), 32 greedy tokens: 8/8 complete and flash decode launches
   at hd 256 on the rings and on the global caches (the kernels phase
   checks hd 256, the paged kernel at hd 256 and a softcap of 50).

18. zamba2: zamba2-2.7b at full width and full depth (54 Mamba2 layers in
   9 groups of 6, each followed by the one shared attention + SwiGLU
   block of 32 heads over 32 KV heads, hd 80; d_inner 5120, 80 SSM heads,
   d_state 64) through the dense engine (max_seq 2048): 8 prompts of
   256-1024 tokens (one prime, 1021: the chunked SSD one token at a time;
   one of 512), 32 greedy tokens: 8/8 complete, flash decode at (2048
   slots, hd 80) nine calls a decode step; each prompt's prefill wall with
   its chunk Q;
19. rwkv6: rwkv6-7b at full width and full depth (32 layers, d_model 4096,
   64 heads of 64, d_ff 14336) through the dense engine (max_seq 1024): 8
   prompts of 64-512 tokens, 32 greedy tokens: 8/8 complete; no TPU
   kernel lies on this path (every count must be 0); the prefill wall per
   prompt token (the wkv recurrence loops over tokens);
20. whisper: whisper-base at full width and depth (6 + 6 layers, 1500
   frames): the model over seeded frames, CUDA kernels against plain
   flash decode on the card (prefill of 8 x 32 tokens + 8 decode steps,
   logits within 3e-2); then the dense engine (max_seq 448, no frames: it
   encodes zeros, as the reference's does), 8 prompts of 16-64 tokens, 32
   greedy tokens: 8/8 complete, flash decode at (448, 64) and (1500, 64),
   12 calls a decode step (the kernels phase checks hd 80 and G = 1 at
   these shapes).  Phases 16-20 each report TTFT / ITL, tok/s, launches
   per decode step, device busy and idle share, peak memory and the token
   digest;
21. training reference: reduced deepseek-r1 and granite in float32, the
   card (the kernels and the grouped GEMM's backward kernels) against the
   CPU (plain versions) on the same weights and batch: the loss (1e-5),
   every gradient leaf (1e-4), one AdamW step (eps 1e-3), one with int8
   compression (1 in 1000 entries may quantise a step apart: within
   2 * lr) and one Adafactor step, params within 1e-5; then a reduced
   bf16 run saved, restored and resumed on the card;
22. training at full width: deepseek-r1 at its published widths, depth
   cut to 1 dense + 1 MoE block (13.47 B params, bf16), 2 expert servers
   of 128 experts, 8 Adafactor steps (lr 1e-4) on one repeated batch of
   8 x 256 synthetic tokens through the compiled step (a CUDA graph):
   finite losses that fall, the grouped GEMM, its dx / dw kernels and the
   combine's slot entry launched every step; step wall p50, train
   tokens/s, device busy and idle share (profiled), launches per step,
   graph pool, peak memory (the forward / backward / optimizer split is
   phase 30's eager arm's);
23. the train launcher, ``python -m repro_torch.launch.train --arch
   granite-3-2b`` (full width and depth, 2.5 B params, AdamW), 10 steps,
   its step a CUDA graph.
   The kernels phase (3) also holds the backward kernels
   (``grouped_gemm_dx`` / ``_dw``) against their plain versions at the
   full-width training shapes (bf16, 2e-2; dw also accumulating, the
   training path's mode) and a float32 case (1e-5), with edges (empty
   groups, one group holding every row, rows past the sum, a group of 300
   rows, sizes off the 16-row grid, G = 130 and 1024, accumulation),
   timed beside the per-group torch.matmul; after phase 22 again on the
   group sizes that run routed in its first step.  It also holds
   ``flash_decode_partial`` (the open softmax (acc, m, l) of a cache
   shard, on flash decode's body) against its plain version at the
   full-width decode shape (bf16, 1e-3) and in float32 (1e-5), with edges
   (one split, an empty shard, lengths past the width), each run twice
   bitwise, timed beside its bytes bound (no library call returns it);
24. spmd: the multi-device expert tier on torch.distributed, on a 1 x 1
   NCCL mesh (one card: NCCL refuses two ranks on one device).
   deepseek-r1 at full width, depth 1 dense + 2 MoE, one rank the one
   server of all 256 experts: 8 x 512 prompt tokens prefilled in a2a, 32
   greedy decode steps in replicated mode over a 1024-slot cache
   slot-sharded over the model axis, against the one-device path on the
   same weights (prefill + 8 teacher-forced steps' logits within 3e-2,
   both token digests and the count of equal tokens); the grouped GEMM,
   the combine's slot entry and flash_decode_partial must launch; the
   collectives a decode step makes (profiled), the step wall, peak
   memory.  Then reduced deepseek-r1 in float32 (greedy tokens equal the
   one-device path's), one rwkv6-7b layer at full width through its
   tensor-parallel block (within 2e-2 of the one-device block), and 4
   gloo ranks on the card (gloo takes CUDA tensors; NCCL refuses two
   ranks on one device) running reduced deepseek-r1 on a (2, 2) mesh
   against the one-process run (1e-5).  The prefill and the decode steps
   are the dry-run cells' compiled steps (``dryrun.compile_prefill`` /
   ``compile_serve``): CUDA graphs with their c10d calls on the NCCL
   mesh, eager on the gloo ranks (which print why);
25. mesh: the dry-run's cells on torch.distributed (``mesh_phase``): the
   full-width train cells of deepseek-r1, gemma3-4b (depth cut to 12 of
   its 34 layers for the script's time limit; its one-device step also
   run without the attention's q-block checkpoints, bitwise, peak and
   step wall printed) and whisper-base and the decode cells of four
   families on a 1 x 1 NCCL mesh against the one-device path, their
   steps compiled as the reference jits them (CUDA graphs), 4 gloo ranks
   on reduced cells (eager, and say why), and the per-rank accounting
   on ``meta``.  The cells lower the expert GEMMs ``dense``, as the
   reference's ``build_cell`` does (``torch.bmm`` over each expert's
   ``ecap`` rows: the grouped GEMM kernels launch 0 times there), the
   one-device arm with the cell's runtime, so the same lowering and cap;
   the 4 gloo ranks against their one-process run take the kernel
   explicitly (every row computed, no drops on either side);
26. remat: one rwkv6-7b time-mix layer at its published widths (d_model
   4096, 64 heads of 64, bf16), forward and backward over 2 x 4096
   tokens, the wkv recurrence checkpointed a chunk of 64 tokens at a time
   (the port's path) and as one per-token graph (the oracle, kept here):
   output and every gradient bitwise equal (``bonus_u``'s within 1e-6
   relative), the checkpointed peak below a quarter of the per-token
   graph's; both peaks and walls printed;
27. graphs: every executor's decode variants run as CUDA graphs, captured
   once per key and replayed (``serving/step_graphs.py``; phases 5-26 run
   so too, holding their digests and launch counts), here against
   ``step_graphs.eager()`` on the same full-width deepseek-r1 weights,
   each scenario graphs then eager: the dense serve's traffic through
   server 1's failure in each of the three decode modes, the paged serve,
   the 4-client async cluster, and 2 clients on their own weights through
   a failure, a client's masked server, a page-out, new skew values, a
   rebalance's migration and ``scale_to(2)``.  Tokens and kernel
   launches equal; one capture per decode variant and executor (the last
   scenario one more after ``scale_to``), none eager; each arm's decode
   step wall p50, the
   profiled window's device busy, idle share, host calls that enqueue
   work a step, and peak memory (allocated and reserved: a graph's pool
   is reserved, a replay allocates nothing);
28. prefill: the decoder family's prefill variants (whole prefill, dense
   and paged prefill chunks, copy-on-write copies) run as CUDA graphs,
   one per shape, with the chunk's start, the slot, the block-table row
   and the copy pairs as data (phases 5-27 run so too); here against
   ``step_graphs.eager()`` on one set of full-width deepseek-r1 weights,
   each scenario an unreported eager pass (so that neither measured arm
   meets a shape's cuBLAS setup first), then graphs, then eager: the
   dense engine with 256-token chunks and 16 prompts of 256-768 tokens
   (full chunks repeat), the paged serve's shared-prefix traffic (prefix
   hits move ``start``), and the dense serve's eight whole prompts of
   new lengths.  Tokens, kernel launches, dropped and miss equal; one
   capture per (variant, shape) seen twice or more and none for a shape
   seen once, a replay at every later sight, none eager; each arm's
   TTFT p50 / p99, a repeated 256-token chunk's wall p50 and, profiled
   over two 1024-token prompts' chunks, its device busy, idle share and
   host calls that enqueue work; peak memory allocated and reserved, and
   the reserved memory each capture added to the graph pool;
29. family-prefill: every family's prefill compiled as the reference
   compiles it (phases 19-22 run so too, holding their digests):
   gemma3-4b's and whisper-base's whole prompts one CUDA graph per prompt
   length, zamba2-2.7b's SSD carry and rwkv6-7b's wkv recurrence a scan
   body of 64 steps and one of a step, captured once and replayed inside
   the eager prefill; at full widths and depth through the dense engine,
   each family an unreported eager pass, then graphs, then
   ``step_graphs.eager()``, on one set of weights: gemma3 prompts of 600,
   1300 (past the 1024-token window) and 2048 (the q-block path) tokens
   twice each, whisper of 24 and 48 three times, zamba2 of 1021 (prime:
   Q = 1) and 512 (Q = 64) twice, rwkv6 of 64-509.  Tokens, launches,
   dropped and miss equal; gemma3 and whisper capture once per length
   seen twice or more, never on a first sight or per slot; zamba2 and
   rwkv6 capture exactly 2 scan bodies over the family, whatever the
   layers and prompts; one full-width layer's scan bitwise ``eager()`` at
   L = 1, 63, 64, 65 and 1021.  Each arm's TTFT p50 / p99, prefill wall
   by prompt length (ms a token), a prompt profiled back to back (device
   busy, idle share, host calls that enqueue work), and the memory each
   capture added;
30. train-graphs: the train step compiled as the reference jits it
   (``train_loop.compile_train_step``: the whole step one CUDA graph,
   captured at the second step and replayed, the step counter, learning
   rate and optimizer state as data written in place; phases 22-23 run
   so and are this phase's graphed arms), against
   ``step_graphs.eager()`` from the same seed: phase 22's deepseek-r1
   workload and phase 23's granite-3-2b launcher.  Losses, grad norms,
   kernel launches per step and a digest of the params, optimizer state
   and step counter equal; one capture and steps - 2 replays, none
   eager; deepseek-r1's four training-path kernels launched at every
   step.  Each arm's step wall p50, a profiled step's device busy, idle
   share and host calls that enqueue work, the graph pool, the peak
   memory; the eager arm's forward / backward / optimizer split.
31. examples: the README's entry points, the nine tours of
   ``repro_torch.examples`` (the ``examples/`` scripts' counterparts),
   each run through its ``main`` twice, with CUDA graphs and under
   ``step_graphs.eager()``: quickstart at Kimi-K2's full widths (d_model
   7168, top-8, T = 64) with 32 experts, the most the reference's
   planner makes 2-homed (its candidate window), and again with all 384
   (cut only where the reckoned peak of the 2-homed rebuild does not fit
   the free memory), where the failover misses and the tour's assert
   fails in both arms alike, as the JAX tour's does (only that assert,
   after a failover that missed, and both arms' outputs compared);
   serve_moe at
   deepseek-r1's (1 dense + 2 MoE blocks, 4 servers + 2 redundant
   slots; 16 requests, 4 clients, least_loaded, client 1 failing at step
   40, a paged pool of 14 blocks a client, which preempts) in this
   process; the other seven at their own reduced configs in a pool of
   spawned processes meanwhile.  Each tour's own asserts hold
   (quickstart's err < 1e-3 with a failover call that replays and
   captures nothing, disaggregated's transparency,
   cluster_failover's bitwise identity, prefix_cache's, overlap's and
   expert_balance's identical tokens); the arms' printed lines (the VirtualClock's), tokens,
   outputs and fingerprints are bitwise equal.  serve_moe runs once as
   a user runs it, under the wall clock (counts and times reported: its
   cluster steps the client whose clock is most behind, so which rows
   share a step, and the greedy tokens with them, follow the card's
   timing), and its two held arms interleave the clients by the
   VirtualClock.  Each tour's wall, captures, replays and launches.
32. mesh-graphs: the reference's jitted mesh steps as CUDA graphs
   (``dryrun.build_cell``'s train, prefill and serve steps over NCCL,
   their c10d calls inside the graph) against ``step_graphs.eager()``
   on the same weights, for every 1 x 1 NCCL cell of phases 24-25
   (which run both arms; their graphed arms are those phases' runs):
   phase 24's full-width deepseek-r1 (8 x 512 prompt tokens in a2a, then
   32 decode steps in replicated mode), the train cells of deepseek-r1
   (1 + 1 layers), gemma3-4b (``TRAIN_CELL_DEPTH``) and whisper-base,
   and the decode cells of gemma3-4b, zamba2-2.7b, rwkv6-7b and
   whisper-base.  Logits and tokens, or losses, grad norms and the
   params' digest, bitwise equal; one capture and a replay at every
   later call under the key, none eager; equal launches over the decode
   steps.  Each arm's decision, captures, replays, the c10d calls the
   graph holds, wall p50 over the replays, a profiled call's device
   busy, idle share, host calls that enqueue work and c10d host calls,
   the graph pool and peak memory, beside the predicted graphed wall.
   The 4 gloo ranks of phases 24-25 stay eager and print why.
33. parity: the results that were the reference's only in part.  The
   sampler (``csrc/sample.cu``, JAX's threefry Gumbel-max) against its
   plain version on full-width deepseek-r1 logits (129,280 columns; B = 8
   and 64 of mixed temperatures, greedy rows included, and 8 all
   greedy, which the engines send to ``torch.argmax`` instead): tokens
   equal, each sampled row's top-two margin printed; the probe kernel's
   bits and uniforms bitwise the plain ones, Gumbel noise's max |err|;
   the operations bound from the sampler's SASS (its column loop's
   instructions by pipe); the grouped GEMM's
   widening route (float32 rows, bfloat16 weights) against its plain
   version at the disaggregated server's shapes (G = 40, a batch of 28
   rows) and quickstart's (Kimi-K2 widths, 8 experts a server); then the
   dense serve's model and traffic at temperature 0.8 (seeds 7-14),
   served twice on one set of weights: equal tokens, the kernel's
   tokens equal to the plain sampler's on the same logits at every
   step, and tokens that differ from greedy's argmax.  The sampler's
   launches on the ``kernels`` line are this serve's first run's; the
   widening route's, phase 15's.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  ``--only families|disaggregated|
arctic|gemma3|zamba2|rwkv6|whisper`` builds the kernels and runs that one
phase (14-20) alone, printing no summary; ``--only train`` runs the
backward kernels' checks and phases 21-23; ``--only spmd`` the partial
kernel's checks and phase 24; ``--only mesh`` the partial kernel's checks
and phase 25; ``--only remat`` phase 26 and gemma3-4b's train cell;
``--only graphs`` phase 27; ``--only prefill`` phase 28;
``--only family-prefill`` phase 29; ``--only train-graphs`` phase 30
(both arms of both workloads); ``--only examples`` phase 31;
``--only examples-solo`` phase 31 with a pool of one process, started
after serve_moe's arms, so each reduced tour's arm runs alone;
``--only mesh-graphs`` phase 32: phases 24-25's 1 x 1 NCCL cells, each
graphed and under ``eager()`` (no gloo ranks, no accounting);
``--only mesh-train`` phase 25's deepseek-r1 train cell alone, both
lowerings against their one-device arms (no eager arm);
``--only parity`` phase 33 on weights of its own.
Without a CUDA device, or without the rest of the repository beside it,
the script exits 1 and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PEAK_BYTES = 3.35e12                                 # H100 SXM HBM3, B/s
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}    # dense, per second
TOL = {"grouped_gemm": {"float32": 1e-5, "bfloat16": 2e-2},
       "grouped_gemm_dx": {"float32": 1e-5, "bfloat16": 2e-2},
       "grouped_gemm_dw": {"float32": 1e-5, "bfloat16": 2e-2},
       "flash_decode": {"float32": 1e-5, "bfloat16": 3e-2},
       "flash_decode_partial": {"float32": 1e-5, "bfloat16": 1e-3},
       "paged_flash_decode": {"float32": 1e-5, "bfloat16": 3e-2},
       "combine_weighted": {"float32": 1e-5, "bfloat16": 2e-2},
       "combine_slots": {"float32": 1e-5, "bfloat16": 2e-2},
       "grouped_gemm_f32_bf16": {"float32": 1e-5},
       "sample": {"float32": 0.0}}
RAGGED_VJP = ("no TPU kernel: the VJP of lax.ragged_dot, the reference "
              "trainer's grouped GEMM (src/repro/kernels/ops.py:95)")
SOURCES = {"grouped_gemm": ("src/repro_torch/csrc/grouped_gemm.cu",
                            "src/repro/kernels/grouped_gemm.py:43"),
           "grouped_gemm_dx": ("src/repro_torch/csrc/grouped_gemm_bwd.cu",
                               RAGGED_VJP),
           "grouped_gemm_dw": ("src/repro_torch/csrc/grouped_gemm_bwd.cu",
                               RAGGED_VJP),
           "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                            "src/repro/kernels/decode_attention.py:74"),
           "flash_decode_partial": (
               "src/repro_torch/csrc/flash_decode.cu",
               "src/repro/models/attention.py:244 (decode_attention_partial"
               ": jnp, no Pallas kernel; on flash_decode_pallas's body, "
               "src/repro/kernels/decode_attention.py:74)"),
           "paged_flash_decode": (
               "src/repro_torch/csrc/paged_flash_decode.cu",
               "src/repro/kernels/decode_attention.py:124"),
           "combine_weighted": ("src/repro_torch/csrc/combine.cu",
                                "src/repro/kernels/combine.py:23"),
           "combine_slots": ("src/repro_torch/csrc/combine.cu",
                             "src/repro/kernels/combine.py:23"),
           "grouped_gemm_f32_bf16": (
               "src/repro_torch/csrc/grouped_gemm.cu",
               "src/repro/kernels/ops.py:94 (xla_ragged: lax.ragged_dot of "
               "float32 rows and bfloat16 weights, promoted to a float32 "
               "product; no Pallas kernel)"),
           "sample": ("src/repro_torch/csrc/sample.cu",
                      "src/repro/serving/sampling.py:17 (sample_batch: "
                      "jitted jnp threefry Gumbel-max; no Pallas kernel)")}
# a warm-up request's id: sampling keys fold the id in as a uint32 (the
# reference raises for -1); 2**32 - 1 keeps -1's residue mod 2**k
WARM_ID = 2 ** 32 - 1


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


def bound_ms(nbytes: float, ops: float, dtype: str, ops_ms=None):
    """The larger of the bytes' and the operations' times; ``ops_ms``, where
    given, is the operations' time (counted by pipe, not at one rate)."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3 if ops_ms is None else ops_ms
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
             ops, twice: bool = False, plain_reps: int = 20, check=None,
             ops_ms=None):
    """Check kernel vs plain on one input (and, with ``twice``, run-to-run
    bitwise); time kernel, plain (``plain_reps`` single calls when it is
    slow), library.  ``check``, for a kernel that alters its input (dw's
    accumulate), makes its own comparison and returns the max |err|;
    ``kernel`` and ``plain`` are then only timed."""
    if check is not None:
        err = check()
    else:
        got = kernel()
        err = check_case(torch, name, label, dtype, got, plain())
        if twice and not torch.equal(got, kernel()):
            raise AssertionError(f"{name}[{label}]: two runs differ")
    b_ms, b_by = bound_ms(nbytes, ops, dtype, ops_ms)
    plain_ms = (time_ms(torch, plain) if plain_reps == 20 else
                time_ms(torch, plain, reps=plain_reps, inner=1, warmup=1))
    case = {"case": label, "dtype": dtype, "max_abs_err": err,
            "tol": TOL[name][dtype],
            "ms": time_ms(torch, kernel), "plain_ms": plain_ms,
            "library_ms": library and time_ms(torch, library),
            "device_ms": time_ms(torch, kernel, graph=True),
            "library_device_ms": library and time_ms(torch, library,
                                                     graph=True),
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

    def gg_case(label, live_rows, K, N, dtype, G=None, Mr=None):
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
            plain_reps=3))

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
                    Mr=C_)
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
                    f"5120", live_, K_, N_, bf, G=256, Mr=5120)
    # arctic-480b's expert servers (4 x 32 primaries + 2 replicas, d_expert
    # 4864): a decode's 16 picks over C = 640 rows, a 512-token prefill's
    # 1024 picks spread over 4 servers
    for phase, live_ in (("decode", 4), ("prefill", 256)):
        for what, K_, N_ in (("gate/up", d, 4864), ("down", 4864, d)):
            gg_case(f"arctic-480b: {phase} {what}, G = 34, {live_} live "
                    f"rows of 640", live_, K_, N_, bf, G=34, Mr=640)
    # the disaggregated tier's server shape: 32 primaries + 8 replicas,
    # one dynamic batch of both clients' rows (28 x 8 picks over 8
    # servers), in bf16 rows (the server takes its float32 payload: the
    # widening route, phase 33)
    for what, K_, N_ in (("gate/up", d, f), ("down", f, d)):
        gg_case(f"disaggregated server: {what}, G = 40, a batch of 28 rows",
                28, K_, N_, bf, G=40, Mr=28)

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

    def fd_case(label, B, H, KV, hd, S, lengths, dtype, softcap=0.0):
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
        # SDPA has no softcap: no one-call yardstick for that case
        cases["flash_decode"].append(run_case(
            torch, "flash_decode", label, str(dtype)[6:],
            lambda: ops.flash_decode(q, k, v, lens, softcap=softcap,
                                     impl="cuda"),
            lambda: ops.flash_decode(q, k, v, lens, softcap=softcap,
                                     impl="torch"),
            None if softcap else library, nbytes, 4.0 * n_valid * H * hd,
            twice=True))

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
    # gemma3-4b: 8 heads over 4 KV heads, hd = 256 (two warps a chunk);
    # prompts of 1100-1800 tokens: a local layer's 1024-slot ring is full
    # (wrapped), a global layer at max_seq 2048 holds the whole prefix
    g3_lens = torch.randint(1100, 1833, (8,), generator=torch.Generator()
                            .manual_seed(9)).tolist()
    fd_case("gemma3-4b local ring, 8 slots, G 2, hd 256, 1024 slots "
            "wrapped (lengths 1100-1832)", 8, 8, 4, 256, 1024, g3_lens, bf)
    fd_case("gemma3-4b global, 8 slots, G 2, hd 256, lengths 1100-1832 of "
            "2048", 8, 8, 4, 256, 2048, g3_lens, bf)
    fd_case("float32, hd 256, split-edge lengths", 4, 8, 4, 256, 200,
            [1, 65, 200, 129], torch.float32)
    fd_case("hd 160 (staged 160), G 24, split-edge lengths", 4, 24, 1, 160,
            200, [1, 65, 200, 129], bf)
    # no config of the repository sets attn_logit_softcap: a synthetic cap
    fd_case("softcap 50, gemma3-4b global shape", 8, 8, 4, 256, 2048,
            g3_lens, bf, softcap=50.0)
    fd_case("float32, softcap 5, hd 64", 4, 16, 2, 64, 320,
            [1, 64, 200, 320], torch.float32, softcap=5.0)
    # G = 1 (one of the mma tile's 16 rows): zamba2-2.7b's shared block (32
    # heads over 32 KV heads, hd 80, max_seq 2048, prompts 256-1024 + 32),
    # whisper-base's decoder self-attention (8 heads, hd 64, 448 slots)
    # and its cross-attention over the 1500 encoder positions, all valid
    z2_lens = torch.randint(256, 1057, (8,), generator=torch.Generator()
                            .manual_seed(19)).tolist()
    wh_lens = torch.randint(16, 97, (8,), generator=torch.Generator()
                            .manual_seed(19)).tolist()
    fd_case("zamba2-2.7b shared block, 8 slots, G 1, hd 80, lengths "
            "256-1056 of 2048", 8, 32, 32, 80, 2048, z2_lens, bf)
    fd_case("whisper-base self-attention, 8 slots, G 1, hd 64, lengths "
            "16-96 of 448", 8, 8, 8, 64, 448, wh_lens, bf)
    fd_case("whisper-base cross-attention, 8 slots, G 1, hd 64, 1500 of "
            "1500", 8, 8, 8, 64, 1500, [1500] * 8, bf)
    fd_case("float32, G 1, hd 80, split-edge lengths", 4, 8, 8, 80, 200,
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
    pfd_case("gemma3-4b width, 8 slots, bs 16, G 2, hd 256", 8, 8, 4, 256,
             16, 128, g3_lens, bf)
    pfd_case("float32, bs 12, hd 256", 4, 8, 4, 256, 12, 20,
             [1, 65, 240, 129], torch.float32)

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


def _bwd_inputs(torch, gen, M, K, N, sizes, dtype, scale=1.0):
    dev = "cuda"
    x = (torch.randn(M, K, generator=gen, device=dev) * scale).to(dtype)
    dy = (torch.randn(M, N, generator=gen, device=dev) * scale).to(dtype)
    w = (torch.randn(len(sizes), K, N, generator=gen, device=dev)
         / K ** 0.5).to(dtype)
    return x, dy, w, torch.as_tensor(sizes, device=dev)


def bwd_case(torch, cases, gen, label, M, K, N, sizes, dtype,
             plain_reps=20, accumulate=False):
    """dx and dw on one input, checked and timed (run_case), beside the
    per-group torch.matmul over host offsets; with ``accumulate`` also dw
    added into a (G, K, N) buffer, the training path's mode, whose bound
    counts that buffer's live groups read and written."""
    from repro_torch.kernels import grouped_gemm as kgg

    dev = "cuda"
    x, dy, w, sz = _bwd_inputs(torch, gen, M, K, N, sizes, dtype)
    offs = [0] + torch.cumsum(sz.cpu(), 0).tolist()
    G = len(sizes)
    live = offs[-1]
    spans = [(g, offs[g], offs[g + 1]) for g in range(G)
             if offs[g + 1] > offs[g]]
    live_g = len(spans)
    es = x.element_size()

    def lib_dx():
        out = torch.zeros(M, K, dtype=dtype, device=dev)
        for g, a, b in spans:
            out[a:b] = dy[a:b] @ w[g].T
        return out

    def lib_dw():
        out = torch.zeros(G, K, N, dtype=dtype, device=dev)
        for g, a, b in spans:
            out[g] = x[a:b].T @ dy[a:b]
        return out
    flops = 2.0 * live * K * N
    dt = str(dtype)[6:]
    cases["grouped_gemm_dx"].append(run_case(
        torch, "grouped_gemm_dx", label, dt,
        lambda: kgg.grouped_gemm_dx_cuda(dy, w, sz),
        lambda: kgg.grouped_gemm_dx_torch(dy, w, sz), lib_dx,
        (live * N + live_g * K * N + M * K) * es, flops,
        twice=True, plain_reps=plain_reps))
    cases["grouped_gemm_dw"].append(run_case(
        torch, "grouped_gemm_dw", label, dt,
        lambda: kgg.grouped_gemm_dw_cuda(x, dy, sz),
        lambda: kgg.grouped_gemm_dw_torch(x, dy, sz), lib_dw,
        (live * K + live * N + G * K * N) * es, flops,
        twice=True, plain_reps=plain_reps))
    if not accumulate:
        return
    # a gradient buffer's magnitudes; `buf` takes the timed calls' sums
    base = (torch.randn(G, K, N, generator=gen, device=dev) * 4).to(dtype)
    buf = base.clone()
    lab = label + ", accumulate"

    def check_acc():
        got = kgg.grouped_gemm_dw_cuda(x, dy, sz, out=base.clone())
        err = check_case(torch, "grouped_gemm_dw", lab, dt, got,
                         kgg.grouped_gemm_dw_torch(x, dy, sz,
                                                   out=base.clone()))
        if not torch.equal(got, kgg.grouped_gemm_dw_cuda(
                x, dy, sz, out=base.clone())):
            raise AssertionError(f"grouped_gemm_dw[{lab}]: two runs "
                                 "differ")
        empty = sz == 0
        if not torch.equal(got[empty], base[empty]):
            raise AssertionError(f"grouped_gemm_dw[{lab}]: an empty "
                                 "group was touched")
        return err

    def lib_acc():
        for g, a, b in spans:
            buf[g].addmm_(x[a:b].T, dy[a:b])
        return buf
    cases["grouped_gemm_dw"].append(run_case(
        torch, "grouped_gemm_dw", lab, dt,
        lambda: kgg.grouped_gemm_dw_cuda(x, dy, sz, out=buf),
        lambda: kgg.grouped_gemm_dw_torch(x, dy, sz, out=buf), lib_acc,
        (live * K + live * N + 2 * live_g * K * N) * es, flops,
        plain_reps=plain_reps, check=check_acc))


def backward_kernels_phase(torch, cfg, cases) -> None:
    """The grouped GEMM's backward kernels against their plain versions:
    one server of the full-width training run (bf16, G = 128, C = 10240
    rows of which ~8192 live, gate/up and down shapes, dw also in the
    accumulate mode that training runs), a float32 case, and the edges
    (empty groups, one group holding every row, rows past the sum, a
    group of 300 rows and sizes off the 16-row grid, G = 130 and G = 1024,
    accumulation); timed as the other kernels, beside the per-group
    torch.matmul over host offsets.  The run's own routed sizes are held
    in ``captured_sizes_case`` after the training phase."""
    from repro_torch.kernels import grouped_gemm as kgg

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    m = cfg.moe

    # the full-width training run's server: 2048 tokens x top-8 over S = 2
    # servers of 128 experts, capacity 10240
    G, C = m.num_experts // 2, 10240
    sizes = torch.bincount(torch.randint(
        0, G, (8192,), generator=torch.Generator().manual_seed(2)),
        minlength=G).tolist()
    d, f = cfg.d_model, m.d_expert
    for label, K, N in (("gate/up", d, f), ("down", f, d)):
        bwd_case(torch, cases, gen, f"training {label}, G = {G}, 8192 live "
                 f"rows of {C}", C, K, N, sizes, bf, plain_reps=1,
                 accumulate=True)
        torch.cuda.empty_cache()
    bwd_case(torch, cases, gen, "float32 small, 200 live rows of 256", 256,
             64, 96, [30, 0, 50, 20, 0, 60, 40, 0], torch.float32)

    edges = {"empty groups, rows past the sum": (96, 64, 48, [0, 20, 0, 30]),
             "one group holds every row": (200, 64, 128, [0, 0, 200, 0]),
             "G = 1": (64, 32, 80, [64]),
             "G = 130 > 66, 1000 of 1280 rows": (1280, 256, 72, "130"),
             "M = 100, K = 72, N = 136": (100, 72, 136, [10, 0, 45, 40]),
             "a group of 300 rows, sizes off the 16-row grid":
                 (640, 192, 136, [300, 13, 0, 77, 5, 129]),
             "G = 1024, 1800 of 2048 rows": (2048, 64, 64, "1024")}
    sz_gen = torch.Generator().manual_seed(6)
    for dtype in (bf, torch.float32):
        dt = str(dtype)[6:]
        for label, (M, K, N, sizes) in edges.items():
            if sizes in ("130", "1024"):
                G, live = (130, 1000) if sizes == "130" else (1024, 1800)
                sizes = torch.bincount(torch.randint(
                    0, G, (live,), generator=sz_gen), minlength=G).tolist()
            # a 300-row fp32 sum of unit products reaches ~50, where the
            # summation order alone moves a value by ~1e-5: x and dy at 1/4
            # keep its sums as small as the other edges'
            scale = 0.25 if max(sizes) > 256 else 1.0
            x, dy, w, sz = _bwd_inputs(torch, gen, M, K, N, sizes, dtype,
                                       scale)
            torch.empty(M * max(K, N) * 4, device=dev).fill_(float("nan"))
            dx = kgg.grouped_gemm_dx_cuda(dy, w, sz)
            e1 = check_case(torch, "grouped_gemm_dx", label, dt, dx,
                            kgg.grouped_gemm_dx_torch(dy, w, sz))
            live = int(sz.sum())
            if not torch.equal(dx[live:], torch.zeros_like(dx[live:])):
                raise AssertionError(f"grouped_gemm_dx[{label}]: rows past "
                                     "the sum not zero")
            dw = kgg.grouped_gemm_dw_cuda(x, dy, sz)
            e2 = check_case(torch, "grouped_gemm_dw", label, dt, dw,
                            kgg.grouped_gemm_dw_torch(x, dy, sz))
            empty = sz == 0
            if not torch.equal(dw[empty], torch.zeros_like(dw[empty])):
                raise AssertionError(f"grouped_gemm_dw[{label}]: an empty "
                                     "group's dw is not zero")
            base = torch.randn(dw.shape, generator=gen, device=dev).to(dtype)
            acc = kgg.grouped_gemm_dw_cuda(x, dy, sz, out=base.clone())
            e3 = check_case(torch, "grouped_gemm_dw", label + ", accumulate",
                            dt, acc, kgg.grouped_gemm_dw_torch(
                                x, dy, sz, out=base.clone()))
            if not torch.equal(acc[empty], base[empty]):
                raise AssertionError(f"grouped_gemm_dw[{label}]: accumulate "
                                     "touched an empty group")
            log(f"kernels: grouped_gemm_dx / _dw edge [{label}, {dt}] max "
                f"|err| {e1:.3g} / {e2:.3g} (accumulate {e3:.3g}), zero "
                "tail rows and empty groups")


def captured_sizes_case(torch, cfg, cases, routed) -> None:
    """The backward kernels at the training shapes on the group sizes that
    the full-width training run routed to one server in its first step
    (``routed``), beside the uniform draw of backward_kernels_phase:
    checked, run twice bitwise, timed, dw also accumulating."""
    m = cfg.moe
    C, G = 10240, len(routed)
    gen = torch.Generator(device="cuda").manual_seed(8)
    live, empty = sum(routed), sum(1 for n in routed if n == 0)
    log(f"kernels: the training run's routed sizes (one server, step 0): "
        f"{live} live rows of {C}, groups of {min(routed)}-{max(routed)} "
        f"rows, {empty} empty of {G}")
    for label, K, N in (("gate/up", cfg.d_model, m.d_expert),
                        ("down", m.d_expert, cfg.d_model)):
        bwd_case(torch, cases, gen, f"training {label}, routed sizes, "
                 f"{live} live rows of {C}", C, K, N, routed, torch.bfloat16,
                 plain_reps=1, accumulate=True)
        torch.cuda.empty_cache()


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
    from repro_torch.models.transformer import ParallelCtx, build_model

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
        ctx = ParallelCtx(moe_runtime=pool.runtime(dev))
        g = torch.Generator().manual_seed(3)
        prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=g)
        steps = torch.randint(0, cfg.vocab_size, (8, 2, 1), generator=g)
        logits, cache, _ = model.prefill(params, prompt.to(dev), ctx,
                                         max_slots=64)
        seq = [logits]
        for t in range(8):
            lg, cache, _ = model.decode_step(params, steps[t].to(dev),
                                             cache, ctx)
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
                    view(tab[b:b + 1], [start]), start, ctx)
            seq.append(lg)
        seq = [torch.cat(seq)]
        for t in range(8):
            lg, _, _ = model.decode_step(params, steps[t].to(dev),
                                         view(tab, [24 + t] * 2), ctx)
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

    warm = Request(WARM_ID, rng.integers(0, cfg.vocab_size, 64, np.int32),
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


def _serve_config(get_config):
    """The dense serve's model: deepseek-r1 at its published widths, 1
    dense + 2 MoE layers."""
    base = get_config("deepseek-r1")
    return base.replace(num_layers=3,
                        moe=dataclasses.replace(base.moe, first_k_dense=1))


def serve_phase(torch, get_config):
    """Dense-KV serve at full width through a server failure; returns
    (launches over the run, engine, model config, rng)."""
    import numpy as np

    from repro_torch.serving import EngineConfig, ServingEngine, WallClock

    cfg = _serve_config(get_config)
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
    warm.submit(Request(WARM_ID, rng.integers(0, cfg.vocab_size, 300, np.int32),
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


def _filled_profile(torch, eng, cfg, rng, label: str, slots: int,
                    steps: int, fill: int = 4):
    """``slots`` fresh 128-token requests, then ``_step_profile`` over
    ``steps`` decode steps; the engine runs them out after.  ``fill``:
    the steps beyond ``slots`` the prefills may take (and the tokens the
    first request may decode meanwhile)."""
    from repro_torch.serving import Request, SamplingParams

    for i in range(slots):
        eng.submit(Request(200 + i, rng.integers(0, cfg.vocab_size, 128)
                           .astype("int32"),
                           SamplingParams(max_new_tokens=2 * steps + 4
                                          + fill)))
    for _ in range(slots + fill):
        if len(eng.scheduler.decode_ready()) == slots:
            break
        eng.step()
    if len(eng.scheduler.decode_ready()) != slots:
        raise AssertionError(f"{label}: the batch never filled")
    p = _step_profile(torch, eng, steps)
    eng.run()
    return p


def _mode_profile(torch, eng, cfg, rng, label: str, slots: int,
                  steps: int = 8) -> None:
    """``slots`` fresh 128-token requests, then ``steps`` decode steps
    timed alone and ``steps`` under the profiler (``_step_profile``): wall,
    device busy (summed over streams) and launches per step."""
    p = _filled_profile(torch, eng, cfg, rng, f"modes ({label})", slots,
                        steps)
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


# phase 33: the sampler's operations bound, from its SASS.  The table's
# float32 rate (67 TFLOP/s: an FMA of 2 operations on each of 128 lanes of
# 132 SMs) sets the clock.  Per SM and clock Hopper issues 128 thread
# instructions (4 schedulers of a warp each), 128 float32 ones, 64
# integer ones (add, logic, funnel shift, multiply-add, compare, select,
# move) and 16 special-function or conversion ones (the CUDA C++
# Programming Guide's throughput table, compute capability 9.0).
SM_COUNT = 132
SM_CLOCK = PEAK_OPS["float32"] / (2 * 128 * SM_COUNT)
PIPE_RATE = {"slots": 128, "fp32": 128, "int": 64, "mufu": 16, "conv": 16}
FP32_SASS = {"FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FCHK"}
CONV_SASS = {"I2F", "F2I", "F2F", "I2I", "FRND"}
# memory, control and warp-level instructions: they take only slots
SLOTS_ONLY = ("LD", "ST", "ATOM", "RED", "BRA", "BRX", "JMP", "EXIT", "RET",
              "CALL", "BSSY", "BSYNC", "BAR", "WARPSYNC", "NOP", "S2R",
              "CS2R", "S2UR", "SHFL", "YIELD", "BMOV", "MEMBAR", "DEPBAR",
              "ERRBAR", "VOTE", "MATCH", "BPT", "KILL", "U")
PARITY_PATH = ("sample", "grouped_gemm", "flash_decode", "combine_slots")


def _sass_loop(obj: Path, kernel: str) -> dict:
    """The largest loop of ``kernel`` (its mangled name holds
    ``<len>kernel``) in the object ``obj``, from ``cuobjdump -sass``:
    its instructions by class, and its clocks per iteration on one SM
    (the busiest class over its rate).  A loop closes with a predicated
    branch back; an unpredicated one back is the exit of a divergent
    shuffle's slow path, not a loop."""
    from repro_torch.kernels import build

    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(obj)],
                          capture_output=True, text=True, check=True).stdout
    name = re.compile(rf"Function : \S*\d{kernel}\w*")
    insts, labels, pending, inside = [], {}, [], False
    for line in text.splitlines():
        if "Function :" in line:
            inside = bool(name.search(line))
            continue
        if not inside:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            labels.update((lab, addr) for lab in pending)
            pending = []
            guarded = re.match(r"@!?U?P\w+\s+", m.group(2))
            insts.append((addr, m.group(2)[guarded.end():] if guarded
                          else m.group(2), bool(guarded)))
    loops = []
    for addr, inst, guarded in insts:
        m = guarded and inst.startswith("BRA") and re.search(
            r"(\.L_x_\d+|0x[0-9a-f]+)", inst)
        if m:
            tgt = m.group(1)
            to = labels.get(tgt) if tgt[0] == "." else int(tgt, 16)
            if to is not None and to <= addr:
                loops.append([i for a, i, _ in insts if to <= a <= addr])
    if not loops:
        raise AssertionError(f"sass: no loop in {kernel} of {obj}")
    body = max(loops, key=len)
    count = dict.fromkeys(PIPE_RATE, 0)
    for inst in body:
        op = inst.split()[0].split(".")[0]
        count["slots"] += 1
        if op in FP32_SASS:
            count["fp32"] += 1
        elif op == "MUFU":
            count["mufu"] += 1
        elif op in CONV_SASS:
            count["conv"] += 1
        elif not op.startswith(SLOTS_ONLY):
            count["int"] += 1
    clocks = max(n / PIPE_RATE[k] for k, n in count.items())
    return {"instructions": count, "clocks": clocks,
            "by": max(count, key=lambda k: count[k] / PIPE_RATE[k])}


def _sample_case(torch, cases, label, B, V, temps, gen, sass):
    """One sampler case: tokens of the kernel against the plain version on
    the same inputs, and the probe kernel's bits, uniforms and noise;
    timed.  ``sass``: the sampled loop's clocks per column (one column an
    iteration) on one SM."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import sampling as ksm

    dev = "cuda"
    logits = torch.randn(B, V, generator=gen, device=dev) * 4
    temps = torch.as_tensor(temps, dtype=torch.float32, device=dev)
    keys = torch.randint(0, 2 ** 32, (B, 2), generator=gen, device=dev)
    steps = torch.randint(0, 4096, (B,), generator=gen, device=dev)
    tok = ksm.sample_cuda(logits, temps, keys, steps)
    bits, u, g = ksm.probe_cuda(keys, steps, V)
    want_bits = ksm.random_bits(keys, steps, V)
    want_u = ksm.uniform(want_bits)
    want_g = ksm.gumbel(want_bits)
    plain = ksm.sample_torch(logits, temps, keys, steps)
    torch.cuda.synchronize()
    if not (torch.equal(bits, want_bits) and torch.equal(u, want_u)):
        raise AssertionError(f"sample[{label}]: bits or uniforms differ")
    if not torch.equal(tok, plain):
        raise AssertionError(f"sample[{label}]: tokens {tok.tolist()} vs "
                             f"plain {plain.tolist()}")
    hot = temps > 0
    safe_t = torch.where(hot, temps, 1.0)
    top = torch.topk(want_g + logits / safe_t[:, None], 2, dim=-1).values
    margins = (top[:, 0] - top[:, 1])[hot]
    n_hot = int(hot.sum())
    greedy = not n_hot
    # a greedy column: one compare on the integer pipes
    ops_ms = (n_hot * V * sass["clocks"] + (B - n_hot) * V
              / PIPE_RATE["int"]) / (SM_COUNT * SM_CLOCK) * 1e3
    case = run_case(
        torch, "sample", label, "float32",
        lambda: ops.sample(logits, temps, keys, steps, impl="cuda"),
        lambda: ksm.sample_torch(logits, temps, keys, steps),
        (lambda: torch.argmax(logits, dim=-1)) if greedy else None,
        B * V * 4 + B * (4 + 16 + 8 + 8), 0.0, twice=True, plain_reps=3,
        ops_ms=ops_ms)
    case.update(gumbel_max_abs_err=(g - want_g).abs().max().item(),
                bits_equal=True, uniforms_equal=True,
                sampled_rows=n_hot,
                min_top_two_margin=(margins.min().item() if n_hot
                                    else None))
    log(f"kernels: sample[{label}] bits and uniforms bitwise, tokens "
        f"equal; Gumbel noise max |err| {case['gumbel_max_abs_err']:.3g}; "
        f"top-two margins of the sampled rows "
        f"{[float(f'{m:.4g}') for m in margins.tolist()][:8]}")
    cases["sample"].append(case)


def parity_kernels(torch, cases) -> None:
    """Phase 33's kernels: the sampler at deepseek-r1's vocabulary (B = 8,
    64, 8 greedy, 1 and 256 rows) and the grouped GEMM's widening route at
    the disaggregated server's decode and prefill shapes and quickstart's,
    each against its plain version; the widening route also beside the
    per-group matmuls a user would write, and the prefill payload also
    with 64 rows in every group (one row tile a group: its weights loaded
    once a column tile)."""
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import default_capacity
    from repro_torch.kernels import grouped_gemm as kgg
    from repro_torch.kernels import ops

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(33)
    V = get_config("deepseek-r1").padded_vocab
    from repro_torch.kernels import build
    build.load_library()
    sass = _sass_loop(Path(build.build_info["path"]).with_name("sample.o"),
                      "sample_kernel")
    log(f"kernels: sample's column loop (SASS, one sampled column an "
        f"iteration): {json.dumps(sass['instructions'])} instructions, "
        f"{sass['clocks']:.4g} clocks on one SM, bound by the "
        f"{sass['by']} rate")
    mixed = [0.8, 0.0, 1.0, 0.5, -1.0, 0.8, 2.0, 0.1]
    _sample_case(torch, cases, "B = 8, mixed temperatures", 8, V, mixed, gen,
                 sass)
    _sample_case(torch, cases, "B = 64, mixed temperatures", 64, V,
                 mixed * 8, gen, sass)
    _sample_case(torch, cases, "B = 8, all greedy (engines: torch.argmax)",
                 8, V, [0.0] * 8, gen, sass)
    _sample_case(torch, cases, "B = 1, sampled", 1, V, mixed[:1], gen, sass)
    _sample_case(torch, cases, "B = 256, mixed temperatures", 256, V,
                 mixed * 32, gen, sass)

    def widening(label, M, live, G, K, N, even=False):
        sizes = (torch.full((G,), live // G) if even else torch.bincount(
            torch.multinomial(torch.full((G,), 1.0 / G), live,
                              replacement=True,
                              generator=torch.Generator().manual_seed(3)),
            minlength=G))
        live_g = int((sizes > 0).sum())
        ends = torch.cumsum(sizes, 0).tolist()
        spans = [(g, e - n, e) for g, (n, e) in
                 enumerate(zip(sizes.tolist(), ends)) if n]
        sizes = sizes.to(dev)
        x = torch.randn(M, K, generator=gen, device=dev)
        w = (torch.randn(G, K, N, generator=gen, device=dev)
             / K ** 0.5).to(torch.bfloat16)
        case = run_case(
            torch, "grouped_gemm_f32_bf16", label, "float32",
            lambda: ops.grouped_gemm(x, w, sizes, impl="cuda"),
            lambda: kgg.grouped_gemm_torch(x, w, sizes), None,
            live * K * 4 + live_g * K * N * 2 + M * N * 4,
            2.0 * live * K * N, twice=True, plain_reps=3,
            # the products run as three exact bf16 planes on the tensor
            # cores: three bf16 products at the bf16 rate
            ops_ms=3 * 2.0 * live * K * N / PEAK_OPS["bfloat16"] * 1e3)
        # no one PyTorch call computes it: what a user would write instead,
        # the weights widened once (not timed), one matmul a live group
        wf = w.float()
        y = torch.zeros(M, N, device=dev)

        def per_group():
            for g, r0, r1 in spans:
                torch.matmul(x[r0:r1], wf[g], out=y[r0:r1])
        case.update(several_calls_ms=time_ms(torch, per_group),
                    several_calls_device_ms=time_ms(torch, per_group,
                                                    graph=True),
                    several_calls=f"{len(spans)} calls: w.float() once, "
                    "then torch.matmul a live group")
        log(f"kernels: grouped_gemm_f32_bf16[{label}] per-group "
            f"torch.matmul on w.float(): {case['several_calls_ms']:.4f} ms "
            f"({case['several_calls_device_ms']:.4f} device) over "
            f"{len(spans)} calls")
        del wf, y
        cases["grouped_gemm_f32_bf16"].append(case)

    ds = get_config("deepseek-r1")
    d, f = ds.d_model, ds.moe.d_expert
    for what, K, N in (("gate/up", d, f), ("down", f, d)):
        widening(f"disaggregated server: {what}, G = 40, a batch of 28 "
                 f"rows", 28, 28, 40, K, N)
    km = get_config("kimi-k2-1t-a32b")
    C = default_capacity(64, km.moe.top_k, 4, km.moe.capacity_factor)
    for what, K, N in (("gate/up", km.d_model, km.moe.d_expert),
                       ("down", km.moe.d_expert, km.d_model)):
        widening(f"quickstart (kimi-k2 widths): {what}, G = 8, 128 live "
                 f"rows of {C}", C, 128, 8, K, N)
    widening(f"disaggregated prefill payload: gate/up, G = 40, 2560 rows "
             f"(64 a group)", 2560, 2560, 40, d, f)
    widening(f"disaggregated prefill payload: gate/up, G = 40, 2560 rows "
             f"(64 in every group)", 2560, 2560, 40, d, f, even=True)


def _sampled_requests(np, cfg, rng):
    """The dense serve's traffic (a greedy warm-up, 8 prompts of 64-512
    tokens, 32 tokens each) at temperature 0.8, seeds 7-14."""
    from repro_torch.serving import Request, SamplingParams

    warm, lengths, reqs = _dense_requests(np, cfg, rng)
    return warm, [Request(r.request_id, r.prompt, SamplingParams(
        max_new_tokens=32, temperature=0.8, seed=7 + r.request_id))
        for r in reqs]


def parity_serve(torch, cfg, params, smi) -> dict:
    """The dense serve's model and weights at temperature 0.8, served
    twice (a fresh engine each time): equal tokens; at every sampling
    call the kernel's tokens equal the plain sampler's on the same
    logits; some tokens differ from the argmax.  Returns the first run's
    launches."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import EngineConfig, ServingEngine, WallClock

    real = ops.sample
    seen = {"calls": 0, "rows": 0, "sampled": 0, "not_argmax": 0,
            "mismatch": 0, "margin": float("inf")}

    def checked(logits, temps, keys, steps, impl="auto"):
        got = real(logits, temps, keys, steps, impl=impl)
        want = real(logits, temps, keys, steps, impl="torch")
        hot = temps > 0
        seen["calls"] += 1
        seen["rows"] += int(temps.numel())
        seen["sampled"] += int(hot.sum())
        seen["mismatch"] += int((got != want).sum())
        seen["not_argmax"] += int((got != logits.argmax(-1))[hot].sum())
        if bool(hot.any()):
            from repro_torch.kernels import sampling as ksm
            noisy = (ksm.gumbel(ksm.random_bits(keys, steps,
                                                logits.shape[1]))
                     + logits / torch.where(hot, temps, 1.0)[:, None])
            top = torch.topk(noisy[hot], 2, dim=-1).values
            seen["margin"] = min(seen["margin"],
                                 (top[:, 0] - top[:, 1]).min().item())
        return got

    runs = []
    ops.sample = checked
    try:
        for _ in range(2):
            eng = ServingEngine(cfg, EngineConfig(
                max_batch=8, max_seq=1024, num_servers=4, n_redundant=2,
                pool_tokens_per_client=512), params=params,
                clock=WallClock())
            warm, reqs = _sampled_requests(np, cfg,
                                           np.random.default_rng(0))
            t0 = time.perf_counter()
            metrics, launches, steps = _serve(torch, eng, warm, reqs,
                                              fail=False)
            runs.append((time.perf_counter() - t0, metrics, launches,
                         _digest(reqs), reqs))
            _check_completed("parity", metrics, reqs, cfg)
            del eng
            gc.collect()
    finally:
        ops.sample = real
    (wall, metrics, launches, digest, reqs), again = runs[0], runs[1]
    zero = [k for k in PARITY_PATH if launches[k] <= 0]
    if zero:
        raise AssertionError(f"parity: kernels never launched: {zero}")
    if seen["mismatch"]:
        raise AssertionError(f"parity: the sampler's tokens differ from the "
                             f"plain version's {seen}")
    if digest != again[3]:
        raise AssertionError(f"parity: the two temperature runs differ "
                             f"({digest} vs {again[3]})")
    if not seen["not_argmax"]:
        raise AssertionError("parity: every sampled token was the argmax")
    log(f"parity: deepseek-r1 (1 dense + 2 MoE, full width) serving 8 "
        f"requests at temperature 0.8 twice: tokens sha1 {digest} both "
        f"runs; {seen['calls']} sampling calls over {seen['rows']} rows "
        f"({seen['sampled']} sampled, {seen['not_argmax']} of them not the "
        f"argmax), kernel == plain sampler at every call, smallest "
        f"top-two margin {seen['margin']:.4g}; wall {wall:.2f} s / "
        f"{again[0]:.2f} s (the plain checks included); launches "
        f"{json.dumps(launches)} ({smi})")
    return launches


def parity_phase(torch, get_config, smi, cases, serve=None) -> dict:
    """Phase 33: the parity kernels' checks, then the temperature serve
    on ``serve`` = (model config, params) (the dense serve's; by default
    its own, built from the same config and seed).  Returns the serve's
    launches."""
    t0 = time.perf_counter()
    parity_kernels(torch, cases)
    if serve is None:
        from repro_torch.serving import EngineConfig, ServingEngine

        cfg = _serve_config(get_config)
        serve = (cfg, ServingEngine(cfg, EngineConfig(
            max_batch=8, max_seq=1024, num_servers=4, n_redundant=2,
            pool_tokens_per_client=512), seed=0, device="cuda").params)
    launches = parity_serve(torch, *serve, smi)
    log(f"time: parity: {time.perf_counter() - t0:.1f} s")
    return launches


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


# the CUDA runtime and driver calls that put work on a stream: what the host
# issues a step (a graph's replay is one launch)
HOST_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
              "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
              "cuGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
              "cudaMemcpy2DAsync", "cuMemcpyAsync", "cuMemsetD8Async",
              "cuMemsetD32Async")


def _step_profile(torch, eng, steps: int):
    """``steps`` decode steps timed on the host clock, then ``steps`` more
    under torch.profiler (so its overhead touches no reported latency):
    wall ms, device busy ms, launches and copies per step, the device rows
    as {name: (ms per step, calls per step)}, and the host's calls that
    put work on a stream per step (``HOST_CALLS``); None if the profiler
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
    host = {e.key: e.count / steps for e in prof.key_averages()
            if e.device_type != DeviceType.CUDA and e.key in HOST_CALLS}
    c10d = sum(e.count for e in prof.key_averages()
               if e.device_type != DeviceType.CUDA
               and e.key.startswith("c10d::")) / steps
    return {"plain_ms": plain_ms, "wall_ms": wall_ms, "busy_ms": busy_ms,
            "c10d_calls": c10d,
            "union_ms": union / 1e3 / steps,
            "launches": sum(n for _, n in rows.values()) - copies,
            "copies": copies, "rows": rows,
            "host_calls": host, "host_launches": sum(host.values())}


@contextlib.contextmanager
def _old_combine(torch, eng):
    """Route the MoE layer's combine through the stage it ran before the
    slot entry (``old_combine_stage``).  A captured decode graph replays
    the code it was captured from, so ``eng``'s graphs are dropped on the
    way in and out: its next decode steps run the warm-up, then capture
    the route in force."""
    from repro_torch.core import dispatch

    fused = dispatch.combine
    dispatch.combine = (
        lambda responses, slot, out_dtype=None, addend=None:
        old_combine_stage(torch, responses, slot, out_dtype, addend))
    eng.executor.graphs.reset()
    try:
        yield
    finally:
        dispatch.combine = fused
        eng.executor.graphs.reset()


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
                           SamplingParams(max_new_tokens=4 * steps + 44)))
    # the 8 prefills (interleaved with decode steps under the fair policy)
    for _ in range(32):
        if len(eng.scheduler.decode_ready()) == 8:
            break
        eng.step()
    if len(eng.scheduler.decode_ready()) != 8:
        raise AssertionError(f"profile ({label}): the batch never filled")
    now = _step_profile(torch, eng, steps)
    with _old_combine(torch, eng):
        for _ in range(2):          # the warm-up step and the capture
            eng.step()
        before = _step_profile(torch, eng, steps)
    for _ in range(2):
        eng.step()
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


# ---- slice 8: the disaggregated tier, Arctic, gemma3 ----------------------

def _free(torch) -> None:
    """Drop the previous phase's tensors before the next full-width one."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def family_reference_phase(torch, get_config) -> None:
    """The other families' reduced configs in float32: the card (CUDA
    kernels) against the same weights on the CPU (plain versions),
    prefill logits plus 8 teacher-forced decode steps — Arctic's dense
    residual, gemma3 at 10 layers (one group of 5 local + 1 global, 4
    remainder locals; an 80-token prompt wraps the 64-slot rings),
    qwen2-vl with text ids and with an image grid, minitron's squared ReLU,
    phi3, zamba2 (2 groups of 6 Mamba2 layers and the shared block; a
    23-token prompt: the chunked SSD at Q = 23), rwkv6 and whisper with
    seeded frames."""
    from repro_torch.core.elastic import ServerPool
    from repro_torch.models.transformer import ParallelCtx, build_model
    from repro_torch.models.vlm import image_mrope_positions
    from repro_torch.models.whisper import frame_embeddings

    cases = (("arctic-480b", {}, 24, None), ("gemma3-4b",
             {"num_layers": 10}, 80, None),
             ("qwen2-vl-2b", {}, 24, None), ("qwen2-vl-2b", {}, 24, (4, 3, 4)),
             ("minitron-8b", {}, 24, None), ("phi3-medium-14b", {}, 24, None),
             ("zamba2-2.7b", {}, 23, None), ("rwkv6-7b", {}, 24, None),
             ("whisper-base", {}, 24, "frames"))
    for arch, kw, plen, grid in cases:
        cfg = get_config(arch).reduced().replace(dtype="float32", **kw)
        S = 2 if cfg.moe else 1
        pool = (ServerPool(cfg, S, tokens_per_client=48, n_redundant=1)
                if cfg.moe else None)
        g = torch.Generator().manual_seed(3)
        prompt = torch.randint(0, cfg.vocab_size, (2, plen), generator=g)
        steps = torch.randint(0, cfg.vocab_size, (8, 2, 1), generator=g)
        outs, params_cpu = {}, None
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, S, pool.redundant_table if pool
                                else None, dev)
            if params_cpu is None:
                params_cpu = model.init_params(
                    torch.Generator().manual_seed(0))
            params = _tree_to(params_cpu, dev)
            ctx = ParallelCtx(moe_runtime=pool.runtime(dev) if pool
                              else None)
            batch = None
            if grid == "frames":
                batch = {"frames": frame_embeddings(
                    cfg, 2, torch.Generator().manual_seed(4)).to(dev)}
            elif grid is not None:
                t0, gh, gw = grid
                batch = {"mrope_positions": image_mrope_positions(
                    t0, gh, gw, plen - t0 - gh * gw, device=dev)}
            logits, cache, _ = model.prefill(params, prompt.to(dev), ctx,
                                             max_slots=96, batch=batch)
            seq = [logits]
            for t in range(8):
                lg, cache, _ = model.decode_step(params, steps[t].to(dev),
                                                 cache, ctx)
                seq.append(lg)
            outs[dev] = torch.stack(seq).cpu()
        err = (outs["cuda"] - outs["cpu"]).abs().max().item()
        extra = {None: "", "frames": "seeded frames"}.get(grid, "image grid")
        what = f"{arch} {kw or ''} {extra}".strip()
        # the reduced zamba2 amplifies any rounding: a 1e-7 relative change
        # of its embeddings moves its logits by more than 5e-5
        # (tests/test_torch_ssm_families.py::
        # test_reduced_zamba2_amplifies_rounding)
        tol = 5e-4 if arch == "zamba2-2.7b" else 1e-4
        log(f"reference: reduced {what} float32, prefill ({plen} tokens) + "
            f"8 decode steps, card vs CPU max |logit err| {err:.3e} "
            f"(tol {tol:g})")
        if not err <= tol or not torch.isfinite(outs["cuda"]).all():
            raise AssertionError(f"reference phase ({what}): card and CPU "
                                 f"disagree ({err})")


def disaggregated_phase(torch, get_config, smi) -> dict:
    """The paper's protocol-literal tier at full deepseek-r1 width, one MoE
    layer: 2 attention clients, 8 expert servers (32 primaries + 8
    replicas each, capacity 512) over one bank, polling their buffer slots.
    Both clients' requests are in the slots before the first tick (one
    dynamic batch per server holds both); then server 0 killed silently
    (the timeout path re-routes to replicas), server 0 a straggler
    (slow_factor 50), and re-registration: retries > 0 and outputs within
    1e-3 of the healthy pass.  Server 0 carries the faults: under the
    uniform plan eplb_plan replicates experts 0-31 only (ties toward the
    low index), so only server 0 has no single-homed expert.  Returns the
    healthy pass's launches."""
    from repro_torch.kernels import ops
    from repro_torch.serving.disaggregated import build_cluster

    cfg = get_config("deepseek-r1")
    m = cfg.moe
    _free(torch)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    clients, servers, smap, bank = build_cluster(
        cfg, 2, 8, n_redundant=8, capacity=512, device="cuda", generator=gen)
    torch.cuda.synchronize()
    single = [sum(1 for e in s.expert_ids if (smap.table[e] >= 0).sum() == 1)
              for s in servers]
    log(f"disaggregated: deepseek-r1 d_model={cfg.d_model} experts="
        f"{m.num_experts} top-{m.top_k} d_expert={m.d_expert} {cfg.dtype}, "
        f"2 clients x 8 servers, hosted {[len(s.expert_ids) for s in servers]}"
        f", single-homed {single}, capacity 512; built in "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    if single[0] != 0:
        raise AssertionError("disaggregated: server 0 has single-homed "
                             "experts; its failure would strand rows")
    x0 = torch.randn(16, cfg.d_model, generator=gen, device="cuda")
    x1 = torch.randn(12, cfg.d_model, generator=gen, device="cuda")

    def drive():
        for s in servers:
            s.tick()

    # per-server tick wall and the three GEMMs' device time
    gemm_events, ticks, current = [], {}, [None]
    real_gemm = ops.grouped_gemm

    def timed_gemm(x, w, sizes, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = real_gemm(x, w, sizes, **kw)
        b.record()
        gemm_events.append((current[0], a, b, x, w, sizes))
        return out

    def timed_compute(s, fn):
        def compute(x, eids, scores):
            torch.cuda.synchronize()
            t = time.perf_counter()
            current[0] = s.rank
            out = fn(x, eids, scores)
            torch.cuda.synchronize()
            ticks.setdefault(s.rank, []).append(
                ((time.perf_counter() - t) * 1e3, x.shape[0]))
            return out
        return compute

    def healthy():
        y1 = []

        def drive0():                   # client 1 sends, then servers tick
            if not y1:
                y1.append(clients[1].moe_layer(x1, drive))
            else:
                drive()
        y0 = clients[0].moe_layer(x0, drive0)
        return y0, y1[0]

    healthy()                           # warm-up: cuBLAS, allocator
    for s in servers:
        s.compute = timed_compute(s, s.compute)
    before = [(s.batches, s.served_tokens) for s in servers]
    ops.grouped_gemm = timed_gemm
    ops.reset_launches()
    try:
        y0, y1 = healthy()
        torch.cuda.synchronize()
    finally:
        ops.grouped_gemm = real_gemm
    launches = ops.launch_counts()
    if launches["grouped_gemm_f32_bf16"] <= 0:
        raise AssertionError("disaggregated: the grouped GEMM's widening "
                             "route (float32 payload, bf16 weights) never "
                             "launched")
    batches = [s.batches - b for s, (b, _) in zip(servers, before)]
    rows = [s.served_tokens - n for s, (_, n) in zip(servers, before)]
    if sum(rows) != (16 + 12) * m.top_k or max(batches) != 1:
        raise AssertionError(f"disaggregated: rows {rows} batches {batches}"
                             " (both clients' rows in one batch each)")
    for rank in range(8):
        ev = [e for e in gemm_events if e[0] == rank]
        dev_ms = sum(a.elapsed_time(b) for _, a, b, *_ in ev)
        nbytes = 0
        for _, _, _, x, w, sizes in ev:
            live_g = int((sizes > 0).sum())
            nbytes += ((x.shape[0] * w.shape[1] + x.shape[0] * w.shape[2])
                       * x.element_size()
                       + live_g * w.shape[1] * w.shape[2] * w.element_size())
        wall = sum(t for t, _ in ticks.get(rank, []))
        log(f"disaggregated: server {rank}: batches {batches[rank]}, rows "
            f"{rows[rank]}, tick wall {wall:.3f} ms, 3 grouped GEMMs "
            f"{dev_ms:.4f} ms device against a bytes bound of "
            f"{nbytes / PEAK_BYTES * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB: the "
            f"touched groups' weights read once) ({smi})")
    outs = {"healthy": (y0, y1)}
    # server 0 killed silently: the timeout path re-routes to replicas
    servers[0].alive = False
    r0 = clients[0].retries
    outs["server 0 killed"] = (clients[0].moe_layer(x0, drive), None)
    retries = {"server 0 killed": clients[0].retries - r0}
    servers[0].alive = True
    smap.mark_alive(0)
    servers[0].slow_factor = 50
    r1 = clients[1].retries
    outs["server 0 straggler"] = (None, clients[1].moe_layer(x1, drive))
    retries["server 0 straggler"] = clients[1].retries - r1
    servers[0].slow_factor = 1
    smap.mark_alive(0)
    r1 = clients[1].retries
    outs["re-registered"] = (clients[0].moe_layer(x0, drive),
                             clients[1].moe_layer(x1, drive))
    retries["re-registered"] = clients[1].retries - r1
    for what, (a, b) in outs.items():
        errs = [(got - want).abs().max().item()
                for got, want in ((a, y0), (b, y1)) if got is not None]
        ok = all(torch.isfinite(t).all() for t in (a, b) if t is not None)
        log(f"disaggregated: {what}: retries {retries.get(what, 0)}, max "
            f"|y - healthy| {max(errs):.3e} (tol 1e-3), finite {ok}")
        if not ok or max(errs) > 1e-3:
            raise AssertionError(f"disaggregated ({what}): output moved")
    if not (retries["server 0 killed"] > 0
            and retries["server 0 straggler"] > 0):
        raise AssertionError(f"disaggregated: the timeout path never fired "
                             f"{retries}")
    log(f"disaggregated: launches (healthy pass) {json.dumps(launches)}; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def _family_step_profile(torch, eng, cfg, rng, label: str) -> None:
    """8 fresh 128-token requests, then 4 full-batch decode steps timed
    alone and 4 under the profiler: wall, device busy, idle share and the
    kernel launches per step."""
    from repro_torch.serving import Request, SamplingParams

    for i in range(8):
        eng.submit(Request(100 + i, rng.integers(0, cfg.vocab_size, 128)
                           .astype("int32"),
                           SamplingParams(max_new_tokens=24)))
    for _ in range(16):
        if len(eng.scheduler.decode_ready()) == 8:
            break
        eng.step()
    p = _step_profile(torch, eng, 4)
    if p is None:
        log(f"{label}: the profiler saw no device time (not measured)")
        return
    log(f"{label}: decode step (8 slots, full batch) wall "
        f"{p['plain_ms']:.2f} ms ({8e3 / p['plain_ms']:.1f} tok/s), device "
        f"busy {p['busy_ms']:.3f} ms, idle share "
        f"{max(0.0, 1 - p['busy_ms'] / p['plain_ms']):.3f} of the plain "
        f"wall; {p['launches']:.1f} kernel launches and {p['copies']:.1f} "
        f"copies per step")
    top = sorted(p["rows"].items(), key=lambda kv: -kv[1][0])
    for key, (ms, n) in top[:6]:
        log(f"{label}: {ms:8.3f} ms/step {n:6.1f} calls/step  {key[:90]}")


def _family_serve_report(torch, label, eng, metrics, reqs, launches,
                         steps) -> None:
    s = metrics.summary()
    log(f"{label}: completed {metrics.completed}/{len(reqs)} requests, "
        f"{metrics.total_output_tokens} output tokens in "
        f"{metrics.wall_time:.3f}s, {_step_rate(steps):.1f} tok/s over the "
        f"decode steps' own wall; TTFT p50 {s['ttft']['p50']} ms p99 "
        f"{s['ttft']['p99']} ms; ITL p50 {s['itl']['p50']} ms p99 "
        f"{s['itl']['p99']} ms")
    log(f"{label}: dropped {int(eng.executor.dropped)} miss "
        f"{int(eng.executor.miss)}; tokens sha1 {_digest(reqs)}; launches "
        f"{json.dumps(launches)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def arctic_phase(torch, get_config, smi) -> dict:
    """arctic-480b at its full published widths — d_model 7168, 56 heads
    over 8 KV heads (d_head 128), 128 experts top-2 softmax (normalised),
    d_expert 4864, the dense residual FFN (d_ff 4864) beside them, vocab
    32000, bf16 — with the depth cut from 35 to 2 MoE layers so the
    weights fit one card.  The dense serve's traffic through the lockstep
    EAAS engine (dense KV, 4 servers x (32 + 2) slots), server 1 down at
    steps 10-20: 8/8 complete (misses are expected: 8 replicas of 128
    experts), and the grouped GEMM (G = 34), flash decode and the
    combine's slot entry each launch."""
    import numpy as np

    from repro_torch.serving import EngineConfig, ServingEngine, WallClock

    _free(torch)
    cfg = get_config("arctic-480b").replace(num_layers=2)
    # C = 640 rows a server: a 512-token prompt's 1024 picks over 4
    # servers, with the headroom 128 experts under a random router need
    ecfg = EngineConfig(max_batch=8, max_seq=1024, num_servers=4,
                        n_redundant=2, pool_tokens_per_client=1024)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, ecfg, seed=0, clock=WallClock())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    G = eng.params["blocks"]["moe"]["servers"]["w_gate"].shape[2]
    log(f"arctic: arctic-480b d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} d_head={cfg.head_dim} vocab={cfg.vocab_size} "
        f"experts={cfg.moe.num_experts} top-{cfg.moe.top_k} "
        f"{cfg.moe.router_score_fn} d_expert={cfg.moe.d_expert} residual "
        f"d_ff={cfg.d_ff} {cfg.dtype}; reduced: depth 35 -> 2 MoE layers; "
        f"{n_params / 1e9:.2f}B params, G = {G} slots a server, init "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    rng = np.random.default_rng(0)
    warm, lengths, reqs = _dense_requests(np, cfg, rng)
    metrics, launches, steps = _serve(torch, eng, warm, reqs, fail=True)
    _check_completed("arctic", metrics, reqs, cfg)
    zero = [k for k in DENSE_PATH if launches[k] <= 0]
    if zero or G != 34:
        raise AssertionError(f"arctic: kernels never launched {zero}, "
                             f"G = {G}")
    _family_serve_report(torch, "arctic", eng, metrics, reqs, launches,
                         steps)
    _family_step_profile(torch, eng, cfg, rng, "arctic")
    del eng
    return launches


@contextlib.contextmanager
def _decode_shapes():
    """Count ``ops.flash_decode``'s CUDA calls by (cache slots, hd)."""
    import collections

    from repro_torch.kernels import ops

    from repro_torch.serving.step_graphs import StepGraphs

    shapes = collections.Counter()
    real, real_run = ops.flash_decode_cuda, StepGraphs.run

    def seen(q, k, v, lengths_, softcap=0.0):
        shapes[(k.shape[1], q.shape[-1])] += 1
        return real(q, k, v, lengths_, softcap)

    def run(self, name, key, fn, shape=()):
        # a replay passes no wrapper: the calls its capture counted are
        # kept on the graph and counted again at each later replay
        before = shapes.copy()
        n, c = self.replays.get(name, 0), self.captures.get(name, 0)
        out = real_run(self, name, key, fn, shape)
        if self.captures.get(name, 0) > c:
            self._variants[name][shape].shapes = shapes - before
        elif self.replays.get(name, 0) > n:
            shapes.update(self._variants[name][shape].shapes)
        return out
    ops.flash_decode_cuda = seen
    StepGraphs.run = run
    try:
        yield shapes
    finally:
        ops.flash_decode_cuda = real
        StepGraphs.run = real_run


def gemma3_phase(torch, get_config, smi) -> dict:
    """gemma3-4b at its full published widths and full depth — 34 layers
    (5 groups of 5 sliding-window + 1 global, then 4 sliding-window),
    window 1024, d_model 2560, 8 heads over 4 KV heads, d_head 256, vocab
    262144 tied, bf16 — through the dense engine (no expert tier),
    lockstep, whole-prompt prefill, max_seq 2048.  8 requests of 1100-1800
    prompt tokens (every local ring wraps), 32 greedy tokens: 8/8 complete
    and flash decode launches at hd 256 on the 1024-slot rings and on the
    2048-slot global caches."""
    import numpy as np

    from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                     ServingEngine, WallClock)

    _free(torch)
    cfg = get_config("gemma3-4b")
    ecfg = EngineConfig(max_batch=8, max_seq=2048)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, ecfg, seed=0, clock=WallClock())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    log(f"gemma3: gemma3-4b d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} d_head={cfg.head_dim} vocab={cfg.vocab_size} "
        f"layers={cfg.num_layers} (pattern {cfg.local_global_pattern}:1, "
        f"window {cfg.sliding_window}) {cfg.activation} {cfg.dtype}: "
        f"{n_params / 1e9:.2f}B params, init "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB; expert tier "
        f"{eng.pool}")
    rng = np.random.default_rng(1)
    warm = Request(WARM_ID, rng.integers(0, cfg.vocab_size, 64, np.int32),
                   SamplingParams(max_new_tokens=2))
    lengths = rng.integers(1100, 1801, 8)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(n), np.int32),
                    SamplingParams(max_new_tokens=32))
            for i, n in enumerate(lengths)]
    # which cache widths and head widths reach the kernel
    with _decode_shapes() as shapes:
        metrics, launches, steps = _serve(torch, eng, warm, reqs, fail=False)
    _check_completed("gemma3", metrics, reqs, cfg)
    ring = shapes[(cfg.sliding_window, cfg.head_dim)]
    glob = shapes[(ecfg.max_seq, cfg.head_dim)]
    log(f"gemma3: prompt lengths {lengths.tolist()}; flash decode calls by "
        f"(cache slots, hd): {dict(shapes)}")
    if launches["flash_decode"] <= 0 or not ring or not glob:
        raise AssertionError(f"gemma3: flash decode did not launch on ring "
                             f"and global layers at hd 256: {dict(shapes)}")
    _family_serve_report(torch, "gemma3", eng, metrics, reqs, launches,
                         steps)
    _family_step_profile(torch, eng, cfg, rng, "gemma3")
    del eng
    return launches


# ---- the hybrid, recurrent and encoder-decoder families -------------------

def _family_engine(torch, label, cfg, ecfg, note=""):
    """A dense engine at full width on the card (seeded weights), its
    parameter count and resident bytes logged."""
    from repro_torch.serving import ServingEngine, WallClock

    _free(torch)
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, ecfg, seed=0, clock=WallClock())
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(eng.params))
    log(f"{label}: {cfg.arch_id} d_model={cfg.d_model} layers="
        f"{cfg.num_layers} heads={cfg.num_heads}/{cfg.num_kv_heads} "
        f"d_head={cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"{cfg.activation} {cfg.dtype}{note}: {n_params / 1e9:.3f}B params, "
        f"init {time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident (weights "
        f"and the engine's cache for {ecfg.max_batch} x {ecfg.max_seq})")
    return eng


def _family_serve(torch, eng, cfg, lengths, rng, shapes):
    """Serve a warm-up, then 8 requests of ``lengths`` prompt tokens and 32
    greedy tokens; each prompt's prefill timed alone (synchronized).
    Returns (metrics, launches, decode steps, requests, [(prompt tokens,
    prefill ms)])."""
    import numpy as np

    from repro_torch.serving import Request, SamplingParams

    warm = Request(WARM_ID, rng.integers(0, cfg.vocab_size, 16, np.int32),
                   SamplingParams(max_new_tokens=2))
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(n), np.int32),
                    SamplingParams(max_new_tokens=32))
            for i, n in enumerate(lengths)]
    walls = []
    real = eng.executor.prefill

    def timed(slot, prompt):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(slot, prompt)
        torch.cuda.synchronize()
        walls.append((len(prompt), (time.perf_counter() - t0) * 1e3))
        return out

    def on_start(e):
        e.executor.prefill = timed
        shapes.clear()
    try:
        metrics, launches, steps = _serve(torch, eng, warm, reqs,
                                          fail=False, on_start=on_start)
    finally:
        eng.executor.__dict__.pop("prefill", None)
    return metrics, launches, steps, reqs, walls


def zamba2_phase(torch, get_config, smi) -> dict:
    """zamba2-2.7b at its full published widths and depth — 54 Mamba2
    layers in 9 groups of 6, each group followed by the one shared
    attention + SwiGLU block (32 heads over 32 KV heads of 80, d_ff
    10240); d_model 2560, d_inner 5120, 80 SSM heads of 64, d_state 64,
    conv 4, vocab 32000, bf16 — through the dense engine (max_batch 8,
    max_seq 2048, whole-prompt prefill).  8 requests of 256-1024 prompt
    tokens (one prime: the chunked SSD at Q = 1, a per-token scan; one a
    multiple of 64) and 32 greedy tokens: 8/8 complete, flash decode at
    (2048 slots, hd 80), nine calls a decode step."""
    import numpy as np

    from repro_torch.models.mamba import chunk_size, dims
    from repro_torch.serving import EngineConfig

    cfg = get_config("zamba2-2.7b")
    d_inner, H, P, N = dims(cfg)
    eng = _family_engine(
        torch, "zamba2", cfg, EngineConfig(max_batch=8, max_seq=2048),
        f" (SSM d_inner={d_inner} heads={H}x{P} d_state={N} conv="
        f"{cfg.ssm.d_conv}; shared block every {cfg.shared_block_every})")
    rng = np.random.default_rng(2)
    lengths = rng.integers(256, 1025, 8)
    lengths[:2] = (1021, 512)         # a prime (Q = 1) and 8 x 64
    with _decode_shapes() as shapes:
        metrics, launches, steps, reqs, walls = _family_serve(
            torch, eng, cfg, lengths, rng, shapes)
    _check_completed("zamba2", metrics, reqs, cfg)
    for n, ms in walls:
        q = chunk_size(n, 64)
        log(f"zamba2: prefill of {n} tokens (SSD chunk Q = {q}, {n // q} "
            f"chunks a layer): {ms:.1f} ms wall, {ms / n:.3f} ms a token "
            f"({smi})")
    n_dec, groups = len(steps), cfg.num_layers // cfg.shared_block_every
    calls = shapes[(2048, cfg.head_dim)]
    log(f"zamba2: flash decode calls by (cache slots, hd): {dict(shapes)} "
        f"over {n_dec} decode steps ({calls / max(n_dec, 1):.2f} a step)")
    if (launches["flash_decode"] <= 0 or len(shapes) != 1
            or calls != groups * n_dec):
        raise AssertionError(f"zamba2: flash decode did not run {groups} "
                             f"calls a step at (2048, {cfg.head_dim}): "
                             f"{dict(shapes)}")
    _family_serve_report(torch, "zamba2", eng, metrics, reqs, launches,
                         steps)
    _family_step_profile(torch, eng, cfg, rng, "zamba2")
    del eng
    return launches


def rwkv6_phase(torch, get_config, smi) -> dict:
    """rwkv6-7b at its full published widths and depth — 32 layers,
    d_model 4096, 64 heads of 64, d_ff 14336 squared-ReLU, vocab 65536,
    bf16 — through the dense engine (max_batch 8, max_seq 1024).  8
    requests of 64-512 prompt tokens and 32 greedy tokens: 8/8 complete.
    No TPU kernel lies on this path (the reference computes the time-mix
    and channel-mix in jnp): every kernel's count must be 0, and the phase
    reports the prefill wall per prompt token (the wkv recurrence loops
    over tokens)."""
    import numpy as np

    from repro_torch.serving import EngineConfig

    cfg = get_config("rwkv6-7b")
    eng = _family_engine(torch, "rwkv6", cfg,
                         EngineConfig(max_batch=8, max_seq=1024))
    rng = np.random.default_rng(3)
    lengths = rng.integers(64, 513, 8)
    with _decode_shapes() as shapes:
        metrics, launches, steps, reqs, walls = _family_serve(
            torch, eng, cfg, lengths, rng, shapes)
    _check_completed("rwkv6", metrics, reqs, cfg)
    for n, ms in walls:
        log(f"rwkv6: prefill of {n} tokens: {ms:.1f} ms wall, "
            f"{ms / n:.3f} ms a token ({smi})")
    log(f"rwkv6: no TPU kernel on this path (the reference's time-mix and "
        f"channel-mix are jnp, not Pallas; greedy traffic samples with "
        f"torch.argmax): launches {json.dumps(launches)}")
    if any(launches.values()) or shapes:
        raise AssertionError(f"rwkv6: a kernel launched on a path that has "
                             f"none: {launches}")
    _family_serve_report(torch, "rwkv6", eng, metrics, reqs, launches, steps)
    _family_step_profile(torch, eng, cfg, rng, "rwkv6")
    del eng
    return launches


def _whisper_model_check(torch, cfg) -> None:
    """whisper-base at full width, the model alone: prefill of 8 prompts
    of 32 tokens over seeded frames, then 8 teacher-forced decode steps,
    with the CUDA kernels and again with flash decode's plain version on
    the card: the logits within the bf16 tolerance."""
    from repro_torch.kernels import decode_attention, ops
    from repro_torch.models.transformer import build_model
    from repro_torch.models.whisper import frame_embeddings

    model = build_model(cfg, 1, None, "cuda")
    params = model.init_params(torch.Generator("cuda").manual_seed(1))
    g = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size, (8, 32), generator=g).cuda()
    steps = torch.randint(0, cfg.vocab_size, (8, 8, 1), generator=g).cuda()
    frames = frame_embeddings(cfg, 8, torch.Generator("cuda").manual_seed(6),
                              "cuda")

    def run():
        logits, cache, _ = model.prefill(params, prompt, None, max_slots=448,
                                         batch={"frames": frames})
        seq = [logits]
        for t in range(8):
            lg, cache, _ = model.decode_step(params, steps[t], cache, None)
            seq.append(lg)
        return torch.stack(seq)

    ops.reset_launches()
    with _decode_shapes() as shapes:
        got = run()
    n = ops.launch_counts()["flash_decode"]
    real = ops.flash_decode
    ops.flash_decode = lambda q, k, v, lengths, softcap=0.0, impl="auto": \
        decode_attention.flash_decode_torch(q, k, v, lengths, softcap)
    try:
        want = run()
    finally:
        ops.flash_decode = real
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = TOL["flash_decode"]["bfloat16"]
    log(f"whisper: model, 8 prompts of 32 tokens over seeded frames + 8 "
        f"decode steps, CUDA kernels vs plain flash decode on the card: max "
        f"|logit err| {err:.3e} (tol {tol}), flash decode calls {n} by "
        f"(cache slots, hd) {dict(shapes)}")
    each = cfg.num_layers * 8
    if not (err <= tol and torch.isfinite(got).all()
            and shapes[(448, cfg.head_dim)] == each
            and shapes[(cfg.encoder_seq_len, cfg.head_dim)] == each):
        raise AssertionError(f"whisper: model check failed ({err}, "
                             f"{dict(shapes)})")


def whisper_phase(torch, get_config, smi) -> dict:
    """whisper-base at its full published widths and depth — 6 encoder and
    6 decoder layers, d_model 512, 8 heads of 64, 1500 frames, d_ff 2048
    GeLU, vocab 51865 tied, bf16 — the model alone against the plain
    decode attention, then through the dense engine (max_batch 8, max_seq
    448, Whisper's decoder context): 8 requests of 16-64 prompt tokens and
    32 greedy tokens (the engine passes no frames: it encodes zeros, as
    the reference does): 8/8 complete, flash decode at (448, 64) (self)
    and (1500, 64) (cross), 12 calls a decode step."""
    import numpy as np

    from repro_torch.serving import EngineConfig

    cfg = get_config("whisper-base")
    _free(torch)
    _whisper_model_check(torch, cfg)
    eng = _family_engine(
        torch, "whisper", cfg, EngineConfig(max_batch=8, max_seq=448),
        f" (encoder {cfg.num_encoder_layers} layers over "
        f"{cfg.encoder_seq_len} frames)")
    rng = np.random.default_rng(4)
    lengths = rng.integers(16, 65, 8)
    with _decode_shapes() as shapes:
        metrics, launches, steps, reqs, walls = _family_serve(
            torch, eng, cfg, lengths, rng, shapes)
    _check_completed("whisper", metrics, reqs, cfg)
    for n, ms in walls:
        log(f"whisper: prefill of {n} tokens (encoder over "
            f"{cfg.encoder_seq_len} frames, cross K/V cached): {ms:.1f} ms "
            f"wall ({smi})")
    n_dec = len(steps)
    log(f"whisper: flash decode calls by (cache slots, hd): {dict(shapes)} "
        f"over {n_dec} decode steps "
        f"({sum(shapes.values()) / max(n_dec, 1):.2f} a step)")
    self_kv, cross = (448, cfg.head_dim), (cfg.encoder_seq_len,
                                           cfg.head_dim)
    if (set(shapes) != {self_kv, cross}
            or shapes[self_kv] != cfg.num_layers * n_dec
            or shapes[cross] != cfg.num_layers * n_dec):
        raise AssertionError(f"whisper: flash decode did not run "
                             f"{cfg.num_layers} + {cfg.num_layers} calls a "
                             f"step: {dict(shapes)}")
    _family_serve_report(torch, "whisper", eng, metrics, reqs, launches,
                         steps)
    _family_step_profile(torch, eng, cfg, rng, "whisper")
    del eng
    return launches


TRAIN_PATH = ("grouped_gemm", "grouped_gemm_dx", "grouped_gemm_dw",
              "combine_slots")


def _close_trees(torch, label, got, exp, tol, flips=0.0, bound=None):
    """Every leaf of ``got`` (card) within ``tol`` of ``exp`` (CPU); with
    ``flips``, that share of a leaf's entries (at least 2) may differ by up
    to ``bound`` (int8 rounding flips under compression).  Returns the max
    |err|."""
    from repro_torch.training import tree

    worst = 0.0
    for path, a in tree.items(got):
        b = tree.get(exp, path)
        diff = (a.detach().float().cpu() - b.detach().float()).abs()
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
        off = diff > tol
        if int(off.sum()) > max(2, flips * off.numel()) or (off.any() and (
                bound is None or float(diff[off].max()) > bound)):
            raise AssertionError(f"{label}: {path} differs by "
                                 f"{float(diff.max())} ({int(off.sum())} "
                                 f"entries above {tol})")
    return worst


def train_reference_phase(torch, get_config) -> None:
    """Reduced deepseek-r1 and granite in float32: the card (the kernels
    and their backward kernels) against the CPU (plain versions) on the
    same weights and batch — the loss, every gradient leaf, an AdamW step,
    an AdamW step with int8 compression and an Adafactor step, each from
    the same state; then save -> restore -> resume on the card."""
    import tempfile

    import numpy as np

    from repro_torch.core.moe_layer import default_runtime
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import TrainCtx, build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import optimizer as topt
    from repro_torch.training import tree
    from repro_torch.training.data import synthetic_lm_batches
    from repro_torch.training.train_loop import (TrainState,
                                                 init_train_state,
                                                 make_train_step)

    for arch in ("deepseek-r1", "granite-3-2b"):
        cfg = get_config(arch).reduced().replace(dtype="float32")
        S = 2 if cfg.moe else 1
        batch = next(synthetic_lm_batches(cfg, 4, 32, seed=0))
        params0 = None
        models = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, S, np.zeros((S, 0), np.int32), dev)
            if params0 is None:
                params0 = model.init_params(torch.Generator().manual_seed(0))
            rt = default_runtime(cfg, S, 128, dev) if cfg.moe else None
            models[dev] = (model, TrainCtx(moe_runtime=rt, remat=True,
                                           ce_chunk=16))

        def fresh(dev):
            return tree.map_params(
                lambda p: p.detach().clone().to(dev).requires_grad_(),
                params0)

        # the loss and every gradient leaf
        out = {}
        for dev, (model, ctx) in models.items():
            params = fresh(dev)
            ops.reset_launches()
            loss, _ = model.loss_fn(params, {k: v.to(dev) for k, v in
                                             batch.items()}, ctx)
            loss.backward()
            out[dev] = (loss.item(), {k: p.grad for k, p in
                                      tree.items(params)})
            n = ops.launch_counts()
            if dev == "cuda" and cfg.moe and any(n[k] <= 0
                                                 for k in TRAIN_PATH):
                raise AssertionError(f"train reference ({arch}): kernels "
                                     f"not launched: {n}")
        lerr = abs(out["cuda"][0] - out["cpu"][0])
        gerr = _close_trees(torch, f"train reference ({arch}) gradients",
                            out["cuda"][1], out["cpu"][1], 1e-4)
        if not lerr <= 1e-5:
            raise AssertionError(f"train reference ({arch}): loss differs "
                                 f"by {lerr}")
        # one step of each optimizer from the same state
        lr = {"adamw": 3e-3, "adamw + int8": 3e-3, "adafactor": 3e-2}
        errs = {}
        for name, comp in (("adamw", False), ("adamw + int8", True),
                           ("adafactor", False)):
            res = {}
            for dev, (model, ctx) in models.items():
                opt = (topt.adafactor(lr=lr[name]) if name == "adafactor"
                       else topt.adamw(lr=lr[name], eps=1e-3))
                st = init_train_state(model, opt, None, compression=comp,
                                      params=fresh(dev))
                st, met = make_train_step(model, opt, ctx, compression=comp)(
                    st, {k: v.to(dev) for k, v in batch.items()})
                res[dev] = (st, met)
            (sc, mc), (sp, mp) = res["cuda"], res["cpu"]
            for k in ("loss", "grad_norm"):
                if abs(float(mc[k]) - float(mp[k])) > 1e-5 * max(
                        1.0, abs(float(mp[k]))):
                    raise AssertionError(f"train reference ({arch}, {name}):"
                                         f" {k} {float(mc[k])} vs "
                                         f"{float(mp[k])}")
            # AdamW at eps 1e-3 (its update Lipschitz in the gradient);
            # under int8 compression an entry on a rounding boundary may
            # quantise one step apart: 1 in 1000 within 2 * lr
            errs[name] = _close_trees(
                torch, f"train reference ({arch}, {name}) params",
                sc.params, sp.params, 1e-5, flips=1e-3 if comp else 0.0,
                bound=2 * lr[name])
        log(f"train reference: reduced {arch} float32, card vs CPU: loss "
            f"|err| {lerr:.2e}, max |grad err| {gerr:.2e} (tol 1e-4), one "
            f"step each, max |param err| "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))

    # save -> restore -> resume on the card (reduced deepseek-r1, bf16)
    cfg = get_config("deepseek-r1").reduced()
    model = build_model(cfg, 2, np.zeros((2, 0), np.int32), "cuda")
    ctx = TrainCtx(moe_runtime=default_runtime(cfg, 2, 128, "cuda"),
                   remat=False, ce_chunk=32)
    opt = topt.adafactor(lr=1e-2)
    data = synthetic_lm_batches(cfg, 4, 32, seed=1, device="cuda")
    batches = [next(data) for _ in range(4)]
    step = make_train_step(model, opt, ctx)
    st = init_train_state(model, opt,
                          torch.Generator(device="cuda").manual_seed(0))
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        for b in batches[:2]:
            st, _ = step(st, b)
        ckpt.save_checkpoint(tmp, 2, st)
        for b in batches[2:]:
            st, m1 = step(st, b)
        like = init_train_state(model, opt,
                                torch.Generator(device="cuda").manual_seed(9))
        st2, at = ckpt.restore_checkpoint(tmp, like)
    if at != 2 or not isinstance(st2, TrainState) or int(st2.step) != 2:
        raise AssertionError("train reference: restore lost the step")
    for b in batches[2:]:
        st2, m2 = step(st2, b)
    same = all(torch.equal(a, b) for a, b in zip(tree.leaves(st.params),
                                                 tree.leaves(st2.params)))
    err = _close_trees(torch, "train reference: resume", st2.params,
                       tree.map_params(lambda p: p.cpu(), st.params), 1e-6)
    log(f"train reference: reduced deepseek-r1 bf16 on the card, 2 steps, "
        f"save, 2 steps; restored and resumed: loss {float(m2['loss']):.6f}"
        f" vs {float(m1['loss']):.6f}, params bitwise equal {same} (max "
        f"|err| {err:.2e})")
    if float(m1["loss"]) != float(m2["loss"]) and not same:
        raise AssertionError("train reference: resume diverged")


def _timed(torch, fn, acc: list):
    """``fn`` whose device time to completion is appended to ``acc``."""
    def run(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc.append((time.perf_counter() - t0) * 1e3)
        return out
    return run


TRAIN_STEPS = {"deepseek-r1": 8, "granite-3-2b": 10}


def _state_digest(torch, state) -> str:
    """The params', the optimizer state's, the residual's and the step's
    exact bits (``_param_digest``)."""
    return _param_digest(torch, {"params": state.params,
                                 "opt": state.opt_state,
                                 "ef": state.ef_residual or {},
                                 "step": state.step.reshape(1)})


def _record_step(arm: dict, met, wall_ms: float, launches: dict) -> None:
    """One step's loss, grad norm, wall and kernel launches."""
    arm["wall_ms"].append(wall_ms)
    arm["losses"].append(float(met["loss"]))
    arm["grad_norms"].append(float(met["grad_norm"]))
    arm["per_step"].append(launches)


def _close_arm(torch, arm: dict, state, met, step, batch) -> None:
    """After the last step: the state's digest, the step's captures /
    replays / graph pool, peak memory, then one more step profiled (after
    the digest: it moves the state on)."""
    import types

    arm.update(digest=_state_digest(torch, state),
               step_counter=int(state.step), captures=step.captures,
               replays=step.replays, pool_gib=step.pool_bytes / 2**30,
               dropped=int(met.get("dropped", 0)),
               miss=int(met.get("miss", 0)), **_memory(torch))
    arm["prof"] = _step_profile(torch, types.SimpleNamespace(
        step=lambda: step(state, batch)), 1)


def _new_arm() -> dict:
    return {"wall_ms": [], "losses": [], "grad_norms": [], "per_step": []}


def _dsr1_train_arm(torch, get_config, graphs: bool) -> dict:
    """Phase 22's workload, one arm: deepseek-r1 at its full published
    widths, depth cut to 1 dense + 1 MoE block (13.47 B params, bf16),
    S = 2 expert servers of 128 experts (no replicas), no remat, CE in
    256-position chunks, 8 Adafactor steps (lr 1e-4) on one repeated
    batch of 8 x 256 synthetic tokens, from seed 0, through
    ``compile_train_step`` as CUDA graphs or under ``eager()``.  The
    eager arm also times the forward and the optimizer inside the step
    (their host syncs cannot sit inside a capture).  Also returns the
    group sizes of the first step's first dw launch (one server's: every
    expert GEMM of a server shares them; step 0 is eager in both arms)."""
    import numpy as np

    from repro_torch.core.moe_layer import default_runtime
    from repro_torch.kernels import autograd as kag
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import TrainCtx, build_model
    from repro_torch.training import optimizer as topt
    from repro_torch.training import tree
    from repro_torch.training.data import synthetic_lm_batches
    from repro_torch.training.train_loop import (compile_train_step,
                                                 init_train_state,
                                                 make_train_step)

    _free(torch)
    base = get_config("deepseek-r1")
    cfg = base.replace(num_layers=2,
                       moe=dataclasses.replace(base.moe, first_k_dense=1))
    S, B, L = 2, 8, 256
    arm = _new_arm()
    with _arm(graphs):
        t0 = time.perf_counter()
        model = build_model(cfg, S, np.zeros((S, 0), np.int32), "cuda")
        rt = default_runtime(cfg, S, B * L, "cuda")
        opt = topt.adafactor(lr=1e-4)
        fwd, opt_ms = [], []
        if not graphs:
            model = model._replace(loss_fn=_timed(torch, model.loss_fn, fwd))
            opt = opt._replace(apply_=_timed(torch, opt.apply_, opt_ms))
        state = init_train_state(
            model, opt, torch.Generator(device="cuda").manual_seed(0))
        torch.cuda.synchronize()
        arm.update(cfg=cfg, S=S, B=B, L=L, capacity=rt.capacity,
                   n_params=sum(p.numel() for p in tree.leaves(state.params)),
                   init_s=time.perf_counter() - t0,
                   resident_gib=torch.cuda.memory_allocated() / 2**30)
        step = compile_train_step(make_train_step(
            model, opt, TrainCtx(moe_runtime=rt, remat=False, ce_chunk=256)),
            "cuda")
        batch = next(synthetic_lm_batches(cfg, B, L, seed=0, device="cuda"))
        torch.cuda.reset_peak_memory_stats()
        routed, dw_cuda = [], kag.grouped_gemm_dw_cuda

        def seen(x, dy, sizes, out=None):
            routed.append(sizes.clone())    # no sync: read after the step
            return dw_cuda(x, dy, sizes, out=out)

        for i in range(TRAIN_STEPS["deepseek-r1"]):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            kag.grouped_gemm_dw_cuda = seen if i == 0 else dw_cuda
            try:
                state, met = step(state, batch)
            finally:
                kag.grouped_gemm_dw_cuda = dw_cuda
            torch.cuda.synchronize()
            after = ops.launch_counts()
            _record_step(arm, met, (time.perf_counter() - t1) * 1e3,
                         {k: after[k] - before[k] for k in after})
        _close_arm(torch, arm, state, met, step, batch)
        arm.update(routed=routed[0].tolist(), fwd_ms=fwd, opt_ms=opt_ms)
    del state, model, step
    _free(torch)
    return arm


def _launcher_train_arm(torch, graphs: bool) -> dict:
    """Phase 23's workload, one arm: the normal entry point, ``python -m
    repro_torch.launch.train --arch granite-3-2b`` (its default arch) at
    full width and depth (40 layers, 2.5 B params, bf16, AdamW under a
    cosine schedule with 10 warm-up steps), 10 steps of the synthetic
    stream, no checkpoint directory; its compiled step as CUDA graphs (the
    default) or under ``eager()``, each step observed through
    ``launch.train.run``'s hook (a step's wall runs from the previous
    observation, so step 0's holds the set-up)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    _free(torch)
    ops.reset_launches()
    arm = _new_arm()
    n = TRAIN_STEPS["granite-3-2b"]
    marks = {"launches": ops.launch_counts()}

    def observe(i, state, met, step, batch):
        torch.cuda.synchronize()
        after = ops.launch_counts()
        _record_step(arm, met, (time.perf_counter() - marks["t"]) * 1e3,
                     {k: after[k] - marks["launches"][k] for k in after})
        if i == n - 1:
            _close_arm(torch, arm, state, met, step, batch)
        marks.update(t=time.perf_counter(), launches=ops.launch_counts())

    with _arm(graphs):
        marks["t"] = t0 = time.perf_counter()
        hist = launch_train.run(launch_train.parser().parse_args(
            ["--arch", "granite-3-2b", "--steps", str(n)]), observe=observe)
    torch.cuda.synchronize()
    arm.update(hist=hist, run_s=time.perf_counter() - t0,
               launches=ops.launch_counts())
    _free(torch)
    return arm


def _train_arm_line(label, name, r, smi) -> str:
    p = r["prof"]
    prof = ("the profiler saw no device time (not measured)" if p is None
            else f"profiled step {p['plain_ms']:.1f} ms, device busy "
                 f"{p['busy_ms']:.1f} ms (union {p['union_ms']:.1f} ms), "
                 f"idle share "
                 f"{max(0.0, 1 - p['union_ms'] / p['plain_ms']):.4f}, host "
                 f"calls that enqueue work {p['host_launches']:.1f} a step "
                 f"{json.dumps(p.get('host_calls', {}))}, device kernels "
                 f"{p['launches']:.0f} and copies {p['copies']:.0f} a step")
    return (f"{label} ({name}): step wall p50 "
            f"{statistics.median(r['wall_ms'][2:]):.1f} ms over steps "
            f"2-{len(r['wall_ms']) - 1} (step 1, the graphs arm's capture, "
            f"{r['wall_ms'][1]:.1f} ms); {prof}; captures "
            f"{r['captures']}, replays {r['replays']}, graph pool "
            f"{r['pool_gib']:.2f} GiB; peak memory {r['peak_gib']:.2f} GiB "
            f"allocated, {r['reserved_gib']:.2f} GiB reserved; digest "
            f"{r['digest']} ({smi})")


def train_phase(torch, get_config, smi):
    """Phase 22: phase 22's deepseek-r1 workload (``_dsr1_train_arm``)
    through its compiled step, as CUDA graphs: finite losses that fall,
    the four training-path kernels launched every step; the step wall
    p50, tokens/s, device busy and idle share (profiled), launches per
    step and peak memory.  Returns the 8 steps' launches, the group
    sizes of its first step's first dw launch, and the arm (phase 30's
    graphed arm)."""
    import numpy as np

    r = _dsr1_train_arm(torch, get_config, graphs=True)
    cfg, losses = r["cfg"], r["losses"]
    log(f"train: deepseek-r1 d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} vocab={cfg.vocab_size} experts="
        f"{cfg.moe.num_experts} top-{cfg.moe.top_k} d_expert="
        f"{cfg.moe.d_expert} layers={cfg.num_layers} (1 dense + 1 MoE) "
        f"{cfg.dtype}: {r['n_params'] / 1e9:.2f}B params, init "
        f"{r['init_s']:.1f}s, {r['resident_gib']:.1f} GiB; S = {r['S']}, "
        f"capacity {r['capacity']}, batch {r['B']} x {r['L']}, Adafactor "
        f"lr 1e-4, the step compiled (a CUDA graph)")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses} do not fall")
    missing = [(i, k) for i, n in enumerate(r["per_step"])
               for k in TRAIN_PATH if n[k] <= 0]
    if missing:
        raise AssertionError(f"train: kernels not launched in a step: "
                             f"{missing}")
    launches = {k: sum(n[k] for n in r["per_step"]) for k in r["per_step"][0]}
    p50 = statistics.median(r["wall_ms"][2:])
    rises = sum(b > a for a, b in zip(losses, losses[1:]))
    log(f"train: losses {[round(x, 4) for x in losses]} (one repeated "
        f"batch; {rises} of 7 steps rose), grad_norm last "
        f"{r['grad_norms'][-1]:.3f}, dropped {r['dropped']}, miss "
        f"{r['miss']}; {r['B'] * r['L'] * 1e3 / p50:.1f} train tokens/s; "
        f"launches per step {json.dumps(r['per_step'][-1])}")
    log(_train_arm_line("train", "graphs", r, smi))
    p = r["prof"]
    if p is not None:
        top = sorted(p["rows"].items(), key=lambda kv: -kv[1][0])
        for key, (ms, n) in top[:8]:
            log(f"train: {ms:9.3f} ms/step {n:6.1f} calls/step  {key[:90]}")
    return launches, r["routed"], r


def train_phases(torch, get_config, smi, cases):
    """Phases 21-23: the backward kernels' edges were checked in the
    kernels phase; here the training reference, the full-width run, the
    backward kernels on the sizes that run routed, and the launcher.
    Returns (the full-width run's launches, the launcher's, the graphed
    arms of both for phase 30)."""
    train_reference_phase(torch, get_config)
    launches, routed, dsr1 = train_phase(torch, get_config, smi)
    captured_sizes_case(torch, get_config("deepseek-r1"), cases, routed)
    launcher = train_launcher_phase(torch, smi)
    return launches, launcher["launches"], {"deepseek-r1": dsr1,
                                            "granite-3-2b": launcher}


def train_launcher_phase(torch, smi) -> dict:
    """Phase 23: the launcher's workload (``_launcher_train_arm``), its
    step a CUDA graph (the launcher's default on the card): finite
    losses; the arm (phase 30's graphed arm)."""
    import numpy as np

    r = _launcher_train_arm(torch, graphs=True)
    hist = r["hist"]
    if not hist or not all(np.isfinite(h["loss"]) for h in hist):
        raise AssertionError(f"train launcher: {hist}")
    log(f"train launcher: granite-3-2b full width and depth, 10 steps of "
        f"8 x 64 tokens (AdamW, cosine warm-up 10): logged {hist}; "
        f"{r['run_s']:.1f}s with init; launches "
        f"{json.dumps(r['launches'])} (a dense model: no TPU kernel "
        "on its path)")
    log(_train_arm_line("train launcher", "graphs", r, smi))
    return r


# ---- phase 30: the train step as one CUDA graph ---------------------------

def _train_graph_checks(label, g, e) -> list:
    """What phase 30 requires of one workload's arms."""
    n = len(g["losses"])
    bad = []
    for k in ("losses", "grad_norms", "digest", "step_counter", "per_step",
              "dropped", "miss"):
        if g[k] != e[k]:
            bad.append(f"{label}: {k} differ: graphs {g[k]} vs eager {e[k]}")
    if (g["captures"], g["replays"]) != (1, n - 2):
        bad.append(f"{label}: graphs captured {g['captures']} and replayed "
                   f"{g['replays']} times over {n} steps (want 1, {n - 2})")
    if (e["captures"], e["replays"]) != (0, 0):
        bad.append(f"{label}: eager() captured {e['captures']}")
    if g["step_counter"] != n:
        bad.append(f"{label}: the step counter reads {g['step_counter']}")
    if len({json.dumps(c, sort_keys=True) for c in g["per_step"]}) != 1:
        bad.append(f"{label}: launches differ by step {g['per_step']}")
    for arm, r in (("graphs", g), ("eager", e)):
        logged = [(h["loss"], h["grad_norm"]) for h in r.get("hist", [])]
        if any(x not in zip(r["losses"], r["grad_norms"]) for x in logged):
            bad.append(f"{label} ({arm}): the launcher logged {logged}, "
                       f"not its steps' metrics")
    return bad


def train_graphs_phase(torch, get_config, smi, graphed=None) -> dict:
    """Phase 30: the train step compiled as the reference jits it, one
    CUDA graph captured at the second step and replayed, against
    ``step_graphs.eager()`` from the same seed: phase 22's deepseek-r1
    workload (full width, depth 2, Adafactor, 8 steps) and phase 23's
    granite-3-2b launcher (full width and depth, AdamW, cosine warm-up
    10, 10 steps).  ``graphed``: phases 22-23's arms (run here when
    None).  Losses, grad norms, launches per step and a digest of the
    params, optimizer state and step counter equal; one capture and
    steps - 2 replays, none eager; deepseek-r1's four training-path
    kernels launched every step.  Each arm's step wall p50, the profiled
    step's device busy, idle share and host calls that enqueue work, the
    graph pool and the peak memory.  Returns the eager arms' launches."""
    if graphed is None:
        graphed = {"deepseek-r1": _dsr1_train_arm(torch, get_config, True),
                   "granite-3-2b": _launcher_train_arm(torch, True)}
    eager = {"deepseek-r1": _dsr1_train_arm(torch, get_config, False),
             "granite-3-2b": _launcher_train_arm(torch, False)}
    bad, out = [], {}
    for label, g in graphed.items():
        e = eager[label]
        bad += _train_graph_checks(label, g, e)
        log(_train_arm_line(f"train-graphs: {label}", "graphs", g, smi))
        log(_train_arm_line(f"train-graphs: {label}", "eager", e, smi))
        same = (g["losses"], g["grad_norms"]) == (e["losses"],
                                                   e["grad_norms"])
        log(f"train-graphs: {label}: losses {g['losses']} grad norms "
            f"{g['grad_norms']} (graphs), the eager arm's equal: {same}; "
            f"launches a step {json.dumps(g['per_step'][-1])}")
        out[label] = {k: sum(n[k] for n in e["per_step"])
                      for k in e["per_step"][0]}
    d = eager["deepseek-r1"]
    if d["fwd_ms"]:
        p50 = statistics.median(d["wall_ms"][1:])
        f50, o50 = (statistics.median(d["fwd_ms"][1:]),
                    statistics.median(d["opt_ms"][1:]))
        log(f"train-graphs: deepseek-r1 (eager): forward {f50:.1f} ms, "
            f"backward (with the gradient collection and clip) "
            f"{p50 - f50 - o50:.1f} ms, optimizer {o50:.1f} ms of a "
            f"{p50:.1f} ms step (steps 1-7, each part synchronised) ({smi})")
    missing = [(i, k) for i, n in enumerate(graphed["deepseek-r1"]
                                            ["per_step"])
               for k in TRAIN_PATH if n[k] <= 0]
    if missing:
        bad.append(f"deepseek-r1: kernels not launched in a graphed step: "
                   f"{missing}")
    if bad:
        raise AssertionError("train-graphs: " + "; ".join(bad))
    return out


def train_alone(torch, get_config, smi) -> None:
    """``--only train``: the backward kernels' checks, then phases 21-23."""
    cases = {"grouped_gemm_dx": [], "grouped_gemm_dw": []}
    backward_kernels_phase(torch, get_config("deepseek-r1"), cases)
    train_phases(torch, get_config, smi, cases)


# ---- slice 12: the multi-device expert tier ------------------------------

SPMD_PATH = ("grouped_gemm", "flash_decode_partial", "combine_slots")


def partial_kernel_phase(torch, cfg, cases) -> None:
    """``flash_decode_partial`` against its plain version: the open
    softmax (acc, m, l) at the full-width deepseek-r1 decode shape (8
    rows, 128 heads over 8 KV heads, hd 64, 1024 slots; bf16 at 1e-3:
    both read the same bf16 inputs and sum in fp32, so only the order of
    the sums differs) with the SPMD phase's lengths and the dense serve's,
    one float32 case (1e-5), edges (one split: the chunk's partial is
    written, not the output; an empty shard: acc = l = 0, m = -1e30;
    lengths past the width); each run twice, bitwise.  Timed beside its bound (the K / V
    bytes of the valid prefix); no PyTorch call returns (acc, m, l), so
    the library column is none."""
    from repro_torch.kernels import ops

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(22)

    def fdp_case(label, B, H, KV, hd, S, lengths, dtype, timed=True):
        q = torch.randn(B, H, hd, generator=gen, device=dev).to(dtype)
        k = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        v = torch.randn(B, S, KV, hd, generator=gen, device=dev).to(dtype)
        lens = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        dt = str(dtype)[6:]

        def kernel():
            return ops.flash_decode_partial(q, k, v, lens, impl="cuda")

        def plain():
            return ops.flash_decode_partial(q, k, v, lens, impl="torch")

        got, want = kernel(), plain()
        errs = [check_case(torch, "flash_decode_partial", f"{label}: {n}",
                           dt, g, w)
                for n, g, w in zip(("acc", "m", "l"), got, want)]
        if not all(torch.equal(a, b) for a, b in zip(got, kernel())):
            raise AssertionError(f"flash_decode_partial[{label}]: two runs "
                                 "differ")
        dead = lens <= 0
        if dead.any() and not (bool((got[0][dead] == 0).all())
                               and bool((got[2][dead] == 0).all())
                               and bool((got[1][dead] == -1e30).all())):
            raise AssertionError(f"flash_decode_partial[{label}]: an empty "
                                 "shard is not (0, -1e30, 0)")
        if not timed:
            log(f"kernels: flash_decode_partial edge [{label}, {dt}] max "
                f"|err| {max(errs):.3g}, bitwise twice")
            return
        n_valid = int(lens.clamp(0, S).sum())
        es = q.element_size()
        nbytes = ((B * H * hd + 2 * n_valid * KV * hd) * es
                  + (B * H * hd + 2 * B * H) * 4 + 4 * B)
        case = run_case(torch, "flash_decode_partial", label, dt, kernel,
                        plain, None, nbytes, 4.0 * n_valid * H * hd,
                        check=lambda: max(errs))
        case["library"] = "none: no PyTorch call returns (acc, m, l)"
        cases["flash_decode_partial"].append(case)

    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    fdp_case("SPMD decode, 8 rows, lengths 513-544 of 1024", 8, H, KV, hd,
             1024, list(range(513, 545, 4)), torch.bfloat16)
    rng_lens = torch.randint(64, 545, (8,), generator=torch.Generator()
                             .manual_seed(2)).tolist()
    fdp_case("decode, 8 rows, lengths 64-544 of 1024", 8, H, KV, hd, 1024,
             rng_lens, torch.bfloat16)
    fdp_case("float32, split-edge lengths", 8, 16, 2, 64, 320,
             [1, 64, 65, 400, 128, 129, 257, 320], torch.float32)
    # the four families' slot-sharded caches (phase 25's decode cells):
    # gemma3-4b's globals (8 heads over 4 KV heads, G 2, hd 256),
    # zamba2-2.7b's shared block (G 1, hd 80; also float32) and
    # whisper-base's self cache (G 1, hd 64), 8 prompts of 1100-1800
    # tokens in a 2048-slot shard (whisper: 448 slots, 20-400 tokens)
    fam_lens = torch.randint(1100, 1801, (8,), generator=torch.Generator()
                             .manual_seed(14)).tolist()
    fdp_case("gemma3-4b globals, G 2, hd 256, 2048-slot shard", 8, 8, 4,
             256, 2048, fam_lens, torch.bfloat16)
    fdp_case("zamba2-2.7b shared block, G 1, hd 80, 2048-slot shard", 8, 32,
             32, 80, 2048, fam_lens, torch.bfloat16)
    fdp_case("zamba2-2.7b shared block, G 1, hd 80, float32", 8, 32, 32, 80,
             2048, fam_lens, torch.float32)
    fdp_case("whisper-base self cache, G 1, hd 64, 448 slots", 8, 8, 8, 64,
             448, [20, 64, 65, 128, 200, 300, 399, 400], torch.bfloat16)
    for dtype in (torch.bfloat16, torch.float32):
        fdp_case("one split (S = 64)", 4, 16, 2, 64, 64, [1, 33, 64, 70],
                 dtype, timed=False)
        fdp_case("an empty shard and lengths past the width", 4, H, KV, hd,
                 256, [0, 300, 65, 0], dtype, timed=False)
        fdp_case("hd 33, G 6", 4, 12, 2, 33, 200, [0, 65, 200, 129], dtype,
                 timed=False)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spmd_ctx(tr, mesh, rt, mode):
    """The dry-run cells' serving contexts: prefill in a2a, decode in
    replicated, the cache slot-sharded over the model axis."""
    return tr.ParallelCtx(mesh=mesh, moe_runtime=rt, moe_mode=mode,
                          seq_shard_cache=True, seq_shard_axes=("model",))


def _cell_steps(model, pre, dec, slots: int, compiled: bool = True):
    """(prefill, serve): the dry-run's prefill cell over ``pre`` into
    ``slots`` slots and its serve step over ``dec`` (returning the step's
    logits too), compiled as the reference jits them
    (``dryrun.compile_prefill`` / ``compile_serve``: CUDA graphs over an
    NCCL mesh, eager over gloo, each with its ``decision``) or plain."""
    from repro_torch.launch import dryrun

    pf = dryrun.prefill_step_of(model, pre, slots)
    sv = dryrun.serve_step_of(model, dec, logits=True)
    if not compiled:
        return pf, sv
    return (dryrun.compile_prefill(pf, model, pre, "cuda"),
            dryrun.compile_serve(sv, dec, "cuda"))


def _decode_loop(torch, serve, params, logits, cache, steps: int,
                 forced=None, walls=None):
    """``steps`` calls of ``serve(params, token, cache) -> (next token,
    cache, logits)`` after a prefill's ``logits``: greedy, or fed
    ``forced`` (steps, B) tokens; each call's wall (synchronised) into
    ``walls``.  Returns (the logits of every step, the tokens fed)."""
    seq, fed = [logits], []
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    for i in range(steps):
        if forced is not None:
            tok = forced[i][:, None].to(torch.int32)
        fed.append(tok.long())
        if walls is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        tok, cache, logits = serve(params, tok, cache)
        if walls is not None:
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        seq.append(logits.clone())          # a replay's logits are static
    return torch.stack(seq), torch.cat(fed, dim=1), (cache, tok)


def _greedy(torch, steps_fns, params, prompt, steps: int, forced=None,
            walls=None):
    """Prefill ``prompt``, then ``steps`` decode steps (``_decode_loop``:
    the logits, the tokens fed, the last cache and token) through
    ``steps_fns`` (``_cell_steps``)."""
    prefill, serve = steps_fns
    logits, cache = prefill(params, prompt)
    return _decode_loop(torch, serve, params, logits, cache, steps, forced,
                        walls)


def _spmd_profile(torch, step, steps: int = 2) -> dict:
    """``steps`` calls of ``step`` under torch.profiler: the collectives'
    host calls and device ms per step beside the step's device busy ms
    (and the union of its device intervals), the host's calls that put
    work on a stream (``HOST_CALLS``) and the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    rows = prof.key_averages()
    dev = [e for e in rows if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0]
    nccl_dev = [e for e in dev if "nccl" in e.key.lower()]
    host = [e for e in rows if e.device_type == DeviceType.CPU
            and e.key.startswith("c10d::")]
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and e.time_range.end > e.time_range.start)
    union, end = 0.0, float("-inf")
    for a, b in spans:
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    return {"wall_ms": wall, "union_ms": union / 1e3 / steps,
            "host_launches": sum(e.count for e in rows
                                 if e.key in HOST_CALLS) / steps,
            "host": {e.key: (e.self_cpu_time_total / 1e3 / steps,
                             e.count / steps)
                     for e in rows if e.device_type == DeviceType.CPU},
            "launches": sum(e.count for e in dev) / steps,
            "busy_ms": sum(e.self_device_time_total for e in dev) / 1e3
            / steps,
            "nccl_calls": sum(e.count for e in host) / steps,
            "nccl_calls_by_op": {e.key: e.count / steps for e in host},
            "nccl_device_ms": sum(e.self_device_time_total
                                  for e in nccl_dev) / 1e3 / steps,
            "nccl_kernels": sum(e.count for e in nccl_dev) / steps}


def _mesh_arm(step, **kw) -> dict:
    """A compiled step's record for phase 32, read right after its calls:
    its decision and reason, captures, replays, the c10d calls its graph
    holds and its graph pool."""
    d = step.decision
    return dict(kw, graphed=d.graphed, reason=d.reason,
                captures=step.captures, replays=step.replays,
                collectives=step.collectives,
                pool_gib=step.pool_bytes / 2**30)


def _profile_calls(torch, fn, n: int = 2):
    """``_step_profile`` of ``n`` calls of ``fn``."""
    import types

    return _step_profile(torch, types.SimpleNamespace(step=fn), n)


def spmd_full_width(torch, get_config, smi, mesh, arms) -> dict:
    """(b) deepseek-r1 at its full published widths, depth 1 dense + 2
    MoE, on the 1 x 1 NCCL mesh: one rank is the one expert server of all
    256 experts (2 x 22.5 GB of bf16 banks).  8 x 512 prompt tokens
    prefilled in a2a, 32 greedy decode steps in replicated mode over a
    1024-slot cache slot-sharded over the model axis (the partial kernel
    and one combine per layer), through the dry-run cells' compiled steps
    (``_cell_steps``: the prefill one CUDA graph for its shape, the serve
    step captured at its second call and replayed, with their c10d
    calls) — against the one-device path on the same weights and
    runtimes: prefill logits and 8 teacher-forced decode steps within
    3e-2, both greedy digests with the count of equal tokens.  The
    grouped GEMM, the combine's slot entry and flash_decode_partial must
    launch in the SPMD run.  The same run under ``eager()`` on the same
    weights is phase 32's eager arm (``arms["spmd deepseek-r1"]``).
    Returns the graphed run's launches."""
    import numpy as np

    from repro_torch.configs import InputShape
    from repro_torch.distributed.sharding_rules import shard_params
    from repro_torch.kernels import build, ops
    from repro_torch.launch.dryrun import moe_runtime_for
    from repro_torch.models import transformer as tr

    _free(torch)
    base = get_config("deepseek-r1")
    cfg = base.replace(num_layers=3,
                       moe=dataclasses.replace(base.moe, first_k_dense=1))
    B, P, steps, slots = 8, 512, 32, 1024
    t0 = time.perf_counter()
    model = tr.build_model(cfg, 1, np.zeros((1, 0), np.int32), "cuda")
    full = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    params = shard_params(full, mesh)        # views: 1 x 1 copies nothing
    torch.cuda.synchronize()
    # the serving tier's lowering: the grouped GEMM kernel (the dry-run's
    # cells lower dense: phase 25)
    rt_pre = moe_runtime_for(cfg, mesh, InputShape("prefill", P, B,
                                                   "prefill"), "a2a",
                             gemm_impl="auto")
    rt_dec = moe_runtime_for(cfg, mesh, InputShape("decode", slots, B,
                                                   "decode"), "replicated",
                             gemm_impl="auto")
    n_params = sum(t.numel() for t in _leaves(full))
    log(f"spmd: deepseek-r1 d_model={cfg.d_model} heads={cfg.num_heads}/"
        f"{cfg.num_kv_heads} experts={cfg.moe.num_experts} top-"
        f"{cfg.moe.top_k} layers={cfg.num_layers} (1 dense + 2 MoE) "
        f"{cfg.dtype}: {n_params / 1e9:.2f}B params on a 1 x 1 NCCL mesh "
        f"(one server of all {cfg.moe.num_experts} experts), init "
        f"{time.perf_counter() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB; capacity a2a "
        f"{rt_pre.capacity}, replicated {rt_dec.capacity} ({smi})")
    pre, dec = (_spmd_ctx(tr, mesh, rt_pre, "a2a"),
                _spmd_ctx(tr, mesh, rt_dec, "replicated"))
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=torch
                           .Generator().manual_seed(12)).cuda()
    runs = {}
    for name in ("graphs", "eager"):
        _free(torch)
        ops.reset_launches()
        fns, walls = _cell_steps(model, pre, dec, slots), []
        t0 = time.perf_counter()
        with torch.no_grad(), (contextlib.nullcontext() if name == "graphs"
                               else build.eager()):
            seq, toks, last = _greedy(torch, fns, params, prompt, steps,
                                      walls=walls)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            runs[name] = dict(
                seq=seq, toks=toks, wall=wall, launches=launches,
                serve=fns[1], last=last,
                arm=_mesh_arm(fns[1], walls=walls, prefill=_mesh_arm(fns[0]),
                              **_memory(torch)))
        del fns
    spmd, toks, launches = (runs["graphs"][k] for k in ("seq", "toks",
                                                        "launches"))
    wall, peak = runs["graphs"]["wall"], runs["graphs"]["arm"]["peak_gib"]
    zero = [k for k in SPMD_PATH if launches[k] <= 0]
    if zero:
        raise AssertionError(f"spmd: kernels never launched: {zero}")
    if spmd.shape != (steps + 1, B, cfg.padded_vocab) or \
            not torch.isfinite(spmd).all():
        raise AssertionError(f"spmd: bad logits {tuple(spmd.shape)}")
    e = runs["eager"]
    arms["spmd deepseek-r1 (8 x 512 a2a prefill, 32 decode steps)"] = {
        "kind": "decode", "graphs": runs["graphs"]["arm"],
        "eager": e["arm"], "calls": steps,
        "equal": {"logits": torch.equal(spmd, e["seq"]),
                  "tokens": torch.equal(toks, e["toks"])}}
    # the one-device path on the same weights and runtimes (plain steps)
    local = (tr.ParallelCtx(moe_runtime=rt_pre),
             tr.ParallelCtx(moe_runtime=rt_dec))
    plain = _cell_steps(model, *local, slots, compiled=False)
    with torch.no_grad():
        ref, _, _ = _greedy(torch, plain, full, prompt, 8, forced=toks.T)
        own, ltoks, lone = _greedy(torch, plain, full, prompt, steps)
    errs = (spmd[:9] - ref).abs().amax(dim=(1, 2)).tolist()
    err = max(errs)
    same = int((toks == ltoks).sum())
    digest = lambda t: hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()  # noqa: E731
    log(f"spmd: prefill ({B} x {P} tokens, a2a) + 8 teacher-forced decode "
        f"steps (replicated, slot-sharded cache) vs the one-device path: "
        f"max |logit err| {err:.3e} (tol 3e-2; by step "
        f"{[float(f'{e:.3g}') for e in errs]}), bitwise equal "
        f"{torch.equal(spmd[:9], ref)}; greedy tokens sha1 spmd "
        f"{digest(toks)}, one-device {digest(ltoks)}, {same}/{toks.numel()} "
        f"equal")
    if not err <= 3e-2:
        raise AssertionError(f"spmd: SPMD and one-device logits differ "
                             f"({err})")
    log(f"spmd: prefill + {steps} decode steps {wall:.2f}s wall, compiled "
        f"(prefill {runs['graphs']['arm']['prefill']['reason']}; serve "
        f"{runs['graphs']['arm']['reason']}) (card {smi}); peak memory "
        f"{peak:.2f} GiB; launches {json.dumps(launches)}")
    # where a decode step's time goes, what its collectives cost: the
    # graphed and the eager SPMD step, each on its arm's cache, and the
    # one-device step beside them (rounds alternated)
    steps_of = {"spmd": (runs["graphs"]["serve"], params, *runs["graphs"]
                         ["last"], contextlib.nullcontext),
                "spmd eager": (runs["eager"]["serve"], params,
                               *runs["eager"]["last"], build.eager),
                "one-device": (plain[1], full, *lone,
                               contextlib.nullcontext)}
    call = {name: (lambda sv=sv, p=p, c=c, t=t, m=m: _in(m, sv, p, t, c))
            for name, (sv, p, c, t, m) in steps_of.items()}
    walls = {name: [] for name in call}
    for name in ("spmd", "spmd eager", "one-device", "one-device",
                 "spmd eager", "spmd"):
        with torch.no_grad():
            for _ in range(2):
                call[name]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                call[name]()
            torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) * 1e3 / 8)
    with torch.no_grad():
        prof = {name: _spmd_profile(torch, call[name]) for name in call}
    for name in ("graphs", "eager"):
        runs[name]["arm"]["prof"] = _with_c10d(prof["spmd" if name == "graphs"
                                                    else "spmd eager"])
    p, q = prof["spmd"], prof["one-device"]
    rounds = {n: f"{statistics.mean(w):.2f} ms (rounds "
                 f"{[round(x, 2) for x in w]})" for n, w in walls.items()}
    log(f"spmd: decode step (8 rows) wall: graphed {rounds['spmd']}, eager "
        f"{rounds['spmd eager']}, one-device (eager) {rounds['one-device']};"
        f" under the profiler {p['wall_ms']:.2f} / "
        f"{prof['spmd eager']['wall_ms']:.2f} / {q['wall_ms']:.2f} ms, "
        f"device busy {p['busy_ms']:.3f} / "
        f"{prof['spmd eager']['busy_ms']:.3f} / {q['busy_ms']:.3f} ms; c10d "
        f"host calls a step {p['nccl_calls']:.0f} graphed (its graph holds "
        f"{runs['graphs']['arm']['collectives']}), "
        f"{prof['spmd eager']['nccl_calls']:.0f} eager "
        f"{json.dumps(prof['spmd eager']['nccl_calls_by_op'])}, "
        f"{p['nccl_kernels']:.0f} NCCL device kernels, "
        f"{p['nccl_device_ms']:.4f} device ms a step (world of 1: what one "
        f"card cannot show is the transfer time) ({smi})")
    # where the eager SPMD step's extra host time goes: the host rows
    # (self CPU ms a step under the profiler, and a call) that grew most
    # over the one-device step's
    p = prof["spmd eager"]
    log(f"spmd: device operations a step {p['launches']:.0f} (eager) vs "
        f"{q['launches']:.0f} one-device")
    grew = sorted(((ms - q["host"].get(k, (0.0, 0.0))[0], k, ms, n)
                   for k, (ms, n) in p["host"].items()), reverse=True)
    for d, k, ms, n in grew[:10]:
        n0 = q["host"].get(k, (0.0, 0.0))[1]
        log(f"spmd: host +{d:.3f} ms/step ({ms:.3f} ms, {n:.1f} calls vs "
            f"{n0:.1f} one-device, {1e3 * ms / max(n, 1):.1f} us a call)  "
            f"{k[:80]}")
    del full, params, model, steps_of, call, runs, plain
    _free(torch)
    return launches


def _in(mode, fn, *args):
    """``fn(*args)`` inside the context ``mode()`` (``build.eager`` or a
    null context)."""
    with mode():
        return fn(*args)


def _with_c10d(p: dict) -> dict:
    """``_spmd_profile``'s step record in ``_step_profile``'s names, for
    phase 32's lines."""
    return {"plain_ms": p["wall_ms"], "busy_ms": p["busy_ms"],
            "union_ms": p["union_ms"], "host_launches": p["host_launches"],
            "c10d_calls": p["nccl_calls"]}


def spmd_reduced(torch, get_config, smi, mesh) -> None:
    """(c) reduced deepseek-r1 in float32 on the 1 x 1 mesh: 2 prompts of
    24 tokens, 16 greedy steps; the SPMD path's tokens equal the
    one-device path's exactly."""
    import numpy as np

    from repro_torch.configs import InputShape
    from repro_torch.distributed.sharding_rules import shard_params
    from repro_torch.launch.dryrun import moe_runtime_for
    from repro_torch.models import transformer as tr

    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    model = tr.build_model(cfg, 1, np.zeros((1, 0), np.int32), "cuda")
    full = _tree_to(tr.build_model(cfg, 1, np.zeros((1, 0), np.int32),
                                   "cpu").init_params(
        torch.Generator().manual_seed(0)), "cuda")
    params = shard_params(full, mesh)
    rt_pre = moe_runtime_for(cfg, mesh, InputShape("p", 24, 2, "prefill"),
                             "a2a", gemm_impl="auto")
    rt_dec = moe_runtime_for(cfg, mesh, InputShape("d", 64, 2, "decode"),
                             "replicated", gemm_impl="auto")
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch
                           .Generator().manual_seed(3)).cuda()
    fns = _cell_steps(model, _spmd_ctx(tr, mesh, rt_pre, "a2a"),
                      _spmd_ctx(tr, mesh, rt_dec, "replicated"), 64)
    with torch.no_grad():
        spmd, toks, _ = _greedy(torch, fns, params, prompt, 16)
        local, ltoks, _ = _greedy(torch, _cell_steps(
            model, tr.ParallelCtx(moe_runtime=rt_pre),
            tr.ParallelCtx(moe_runtime=rt_dec), 64, compiled=False), full,
            prompt, 16)
    err = (spmd - local).abs().max().item()
    log(f"spmd: reduced deepseek-r1 float32, 1 x 1 mesh, 16 greedy steps "
        f"through the compiled cells ({fns[1].decision.reason}; captures "
        f"prefill {fns[0].captures}, serve {fns[1].captures}, replays "
        f"{fns[1].replays}): tokens equal the one-device path's "
        f"{torch.equal(toks, ltoks)}, max |logit err| {err:.3e} ({smi})")
    if not torch.equal(toks, ltoks):
        raise AssertionError("spmd (reduced): greedy tokens differ")


def spmd_rwkv(torch, get_config, smi, mesh) -> None:
    """(d) one rwkv6-7b layer at its full published widths (d_model 4096,
    64 heads of 64, d_ff 14336, bf16) on the 1 x 1 mesh: the
    tensor-parallel block over 8 x 128 tokens from a seeded state equals
    the one-device block within 2e-2."""
    from repro_torch.distributed.mesh_axes import axes_group
    from repro_torch.distributed.sharding_rules import shard_params
    from repro_torch.models import rwkv as rwk

    cfg = get_config("rwkv6-7b")
    g = torch.Generator(device="cuda").manual_seed(7)
    dt = torch.bfloat16
    layer = {"tmix": rwk.init_rwkv_tmix(cfg, dt, "cuda", g),
             "cmix": rwk.init_rwkv_cmix(cfg, dt, "cuda", g)}
    sh = shard_params(layer, mesh)
    x = torch.randn(8, 128, cfg.d_model, generator=g, device="cuda").to(dt)
    st = rwk.init_rwkv_state(cfg, 8, "cuda")
    st = st._replace(wkv=0.1 * torch.randn(st.wkv.shape, generator=g,
                                           device="cuda"))
    norms = (torch.ones(cfg.d_model, device="cuda"),) * 2
    group = axes_group(mesh, ("model",))
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, new = rwk.rwkv_block_spmd(sh["tmix"], sh["cmix"], cfg, x, st,
                                     norms, group)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        y0, new0 = rwk.rwkv_block_forward(layer["tmix"], layer["cmix"], cfg,
                                          x, st, norms)
    errs = [(a.float() - b.float()).abs().max().item()
            for a, b in ((y, y0), (new.wkv, new0.wkv))]
    log(f"spmd: rwkv6-7b layer at full width on the 1 x 1 mesh, 8 x 128 "
        f"tokens: island vs one-device block max |err| output {errs[0]:.3e}"
        f", wkv state {errs[1]:.3e} (tol 2e-2); island {wall:.1f} ms wall "
        f"({smi})")
    if not (all(e <= 2e-2 for e in errs) and torch.isfinite(y).all()):
        raise AssertionError(f"spmd (rwkv6): island and block differ {errs}")


def _spmd_rank(rank: int, world: int, init: str, forced, q) -> None:
    """(e) one of 4 gloo ranks on the one card, mesh (2, 2): reduced
    float32 deepseek-r1 prefilled in a2a and decoded in replicated mode
    over a slot-sharded cache, teacher-forced with ``forced``; puts this
    rank's logits (or the error) on ``q``."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs import InputShape, get_config
    from repro_torch.distributed.sharding_rules import shard_params
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh as meshlib
    from repro_torch.launch.dryrun import moe_runtime_for
    from repro_torch.models import transformer as tr

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world)
        mesh = meshlib.make_test_mesh(2, 2, device="cuda")
        cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
        model = tr.build_model(cfg, 2, np.zeros((2, 0), np.int32), "cuda")
        full = _tree_to(tr.build_model(cfg, 2, np.zeros((2, 0), np.int32),
                                       "cpu").init_params(
            torch.Generator().manual_seed(0)), "cuda")
        params = shard_params(full, mesh)
        prompt = _spmd_prompt(torch, cfg)
        d = mesh.get_coordinate()[0]
        pre = _spmd_ctx(tr, mesh, moe_runtime_for(
            cfg, mesh, InputShape("p", 16, 2, "prefill"), "a2a",
            gemm_impl="auto"), "a2a")
        dec = _spmd_ctx(tr, mesh, moe_runtime_for(
            cfg, mesh, InputShape("d", 32, 2, "decode"), "replicated",
            gemm_impl="auto"), "replicated")
        ops.reset_launches()
        fns = _cell_steps(model, pre, dec, 32)
        with torch.no_grad():
            out, _, _ = _greedy(torch, fns, params,
                                prompt[d:d + 1].cuda(), 4,
                                forced=torch.as_tensor(forced)[:, d:d + 1]
                                .cuda())
        torch.cuda.synchronize()
        q.put((rank, out.cpu().numpy(), ops.launch_counts(),
               fns[1].decision.reason))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        import traceback
        q.put((rank, f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
               None, None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spmd_prompt(torch, cfg):
    return torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(4))


def _run_ranks(target, world: int, args, timeout: float = 240.0) -> list:
    """Start ``world`` spawned processes of ``target(rank, world, init,
    *args, q)``, collect one result from each, and stop every one."""
    import multiprocessing as mp
    import queue

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"tcp://127.0.0.1:{_free_port()}"
    procs = [ctx.Process(target=target, args=(r, world, init, *args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = [], time.time() + timeout
    try:
        while len(results) < world:
            try:
                results.append(q.get(timeout=max(1.0, deadline
                                                 - time.time())))
            except queue.Empty:
                break
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if len(results) < world:
        raise AssertionError(f"{target.__name__}: {len(results)} of {world} "
                             f"ranks answered within {timeout:.0f}s")
    return sorted(results, key=lambda r: r[0])


def spmd_multirank(torch, get_config, smi) -> None:
    """(e) Several ranks on the one card: 4 gloo processes (NCCL refuses
    two ranks on one device; gloo takes CUDA tensors) on a (2, 2) mesh run
    reduced float32 deepseek-r1 against the one-process one-device run on
    the same weights, logits within 1e-5.  A rank that fails, or a gloo
    that refuses CUDA tensors, fails the phase."""
    import numpy as np

    from repro_torch.core.moe_layer import default_runtime
    from repro_torch.models import transformer as tr

    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    model = tr.build_model(cfg, 2, np.zeros((2, 0), np.int32), "cuda")
    full = _tree_to(tr.build_model(cfg, 2, np.zeros((2, 0), np.int32),
                                   "cpu").init_params(
        torch.Generator().manual_seed(0)), "cuda")
    rt_pre = default_runtime(cfg, 2, 32, "cuda")._replace(capacity=64)
    rt_dec = default_runtime(cfg, 2, 2, "cuda")._replace(capacity=8)
    prompt = _spmd_prompt(torch, cfg).cuda()
    with torch.no_grad():
        ref, toks, _ = _greedy(torch, _cell_steps(
            model, tr.ParallelCtx(moe_runtime=rt_pre),
            tr.ParallelCtx(moe_runtime=rt_dec), 32, compiled=False), full,
            prompt, 4)
    ranks = _run_ranks(_spmd_rank, 4, (toks.T.cpu().numpy(),), timeout=300)
    bad = [r[1] for r in ranks if r[2] is None]
    if bad:
        raise AssertionError(f"spmd (4 ranks): a rank failed:\n{bad[0]}")
    log(f"spmd: the 4 gloo ranks' compiled cells run eagerly: "
        f"{sorted({r[3] for r in ranks})}")
    errs = []
    for rank, out, launches, _ in ranks:
        d = rank // 2
        errs.append(float(np.abs(out[:, 0] - ref[:, d].cpu().numpy()).max()))
        zero = [k for k in SPMD_PATH if launches[k] <= 0]
        if zero:
            raise AssertionError(f"spmd (4 ranks): rank {rank} never "
                                 f"launched {zero}")
    log(f"spmd: 4 gloo ranks on one card, mesh (2, 2), reduced deepseek-r1 "
        f"float32, prefill (a2a) + 4 teacher-forced decode steps "
        f"(replicated, slot-sharded over model) vs the one-process "
        f"one-device run: max |logit err| per rank {errs} (tol 1e-5) "
        f"({smi})")
    if not max(errs) <= 1e-5:
        raise AssertionError(f"spmd (4 ranks): logits differ {errs}")


def _nccl_world(torch, fn, *args):
    """``fn(mesh, *args)`` on a 1 x 1 NCCL mesh of a world of 1 started
    here and torn down after."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as meshlib

    meshlib.init_distributed(0, 1, f"tcp://127.0.0.1:{_free_port()}",
                             timeout_s=600)
    try:
        return fn(meshlib.make_test_mesh(1, 1), *args)
    finally:
        dist.destroy_process_group()


def spmd_phase(torch, get_config, smi, arms) -> dict:
    """Phase 24: the multi-device expert tier on torch.distributed — (b)
    deepseek-r1 at full width (both of phase 32's arms into ``arms``),
    (c) reduced float32 tokens, (d) rwkv6-7b's tensor-parallel layer,
    each on a 1 x 1 NCCL mesh (one card: NCCL refuses two ranks on one
    device), the cells' steps compiled (CUDA graphs); then (e) 4 gloo
    ranks on the card (eager: gloo's collectives cannot be captured).
    Returns (b)'s launches."""
    def one_rank(mesh):
        launches = spmd_full_width(torch, get_config, smi, mesh, arms)
        spmd_reduced(torch, get_config, smi, mesh)
        spmd_rwkv(torch, get_config, smi, mesh)
        return launches
    launches = _nccl_world(torch, one_rank)
    _free(torch)
    spmd_multirank(torch, get_config, smi)
    return launches


def spmd_alone(torch, get_config, smi) -> None:
    """``--only spmd``: the partial kernel's checks, then phase 24."""
    cases = {"flash_decode_partial": []}
    partial_kernel_phase(torch, get_config("deepseek-r1"), cases)
    spmd_phase(torch, get_config, smi, {})


# ------------------------------------------------- phase 25: the mesh cells

MESH_PATH = TRAIN_PATH
# a dry-run cell's MoE kernels: its expert GEMMs are lowered dense
CELL_PATH = ("combine_slots",)
DIGEST_CHUNK = 1 << 26


def _param_digest(torch, params) -> str:
    """sha1 over every leaf's exact bits, folded on the card: per leaf the
    wrapping int64 sum of its bit patterns times position weights, in
    chunks (order-free, so the same on any reduction order)."""
    from repro_torch.training import tree

    h = hashlib.sha1()
    for path, leaf in tree.items(params):
        flat = leaf.detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2
                         else torch.int32)
        acc = torch.zeros((), dtype=torch.int64, device=flat.device)
        for i in range(0, bits.numel(), DIGEST_CHUNK):
            c = bits[i:i + DIGEST_CHUNK].long()
            w = (torch.arange(i, i + c.numel(), device=c.device)
                 * 2654435761) % 2147483647
            acc += (c * w).sum()
        h.update(f"{'/'.join(path)}:{int(acc)};".encode())
    return h.hexdigest()[:16]


def _train_run(torch, label, step, state, batch, steps: int, smi):
    """``steps`` steps of ``step`` from ``state`` on ``batch``: the first
    step's loss, grad norm and updated params' digest, every step's loss
    and grad norm, the last params' digest, the later steps' wall p50,
    one profiled step's idle share, peak memory; for a compiled step
    (the cells') its record for phase 32 (``_mesh_arm``, before the
    profiled steps)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses, norms = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        if i == 0:
            first = {"loss": float(met["loss"]),
                     "grad_norm": float(met["grad_norm"]),
                     "dropped": int(met.get("dropped", 0)),
                     "digest": _param_digest(torch, state.params)}
    peak = torch.cuda.max_memory_allocated() / 2**30
    last = _param_digest(torch, state.params)
    arm = (_mesh_arm(step, walls=walls, **_memory(torch))
           if hasattr(step, "decision") else None)
    prof = _profile_calls(torch, lambda: step(state, batch), 1)
    if arm is not None:
        arm["prof"] = prof
    idle = (None if prof is None
            else max(0.0, 1 - prof["union_ms"] / prof["plain_ms"]))
    top = (None if prof is None else
           sorted(prof["rows"].items(), key=lambda kv: -kv[1][0])[:8])
    out = dict(first, wall_ms=statistics.median(walls[1:] or walls),
               first_ms=walls[0], peak_gib=peak, idle=idle, top=top,
               losses=losses, grad_norms=norms, last_digest=last, arm=arm)
    log(f"mesh: {label}: step 1 loss {first['loss']!r} grad_norm "
        f"{first['grad_norm']!r} dropped {first['dropped']} params digest "
        f"{first['digest']}; step wall p50 {out['wall_ms']:.1f} ms over "
        f"steps 2-{steps} (step 1 {walls[0]:.1f} ms), "
        f"{batch['tokens'].numel() * 1e3 / out['wall_ms']:.1f} train "
        f"tokens/s, peak memory {peak:.2f} GiB, idle share "
        + ("not measured" if idle is None else f"{idle:.3f}")
        + f" ({smi})")
    return out


def _eager_train_arm(torch, label, build_cell, batch, steps: int, smi):
    """Phase 32's eager arm of a train cell: ``build_cell()`` again under
    ``eager()`` (a fresh compiled step), its state from seed 0 as the
    graphed arm's, ``steps`` steps on ``batch``."""
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun

    _free(torch)
    with build.eager():
        cell = build_cell()
        state = dryrun.init_state(cell, cell.shard(cell.model.init_params(
            torch.Generator(device="cuda").manual_seed(0))))
        out = _train_run(torch, f"{label} under eager()", cell.step, state,
                         batch, steps, smi)
    del state, cell
    _free(torch)
    return out


def _train_arms(got: dict, eager: dict) -> dict:
    """Phase 32's record of a train cell: both arms and what must be
    bitwise equal."""
    return {"kind": "train", "graphs": got["arm"], "eager": eager["arm"],
            "calls": len(got["losses"]),
            "equal": {k: got[k] == eager[k] for k in
                      ("losses", "grad_norms", "last_digest")}}


def mesh_full_width(torch, get_config, smi, arms) -> dict:
    """(a) deepseek-r1 at its published widths, depth 1 dense + 1 MoE
    (13.47 B params, bf16), one expert server of all 256 experts, the
    training phase's batch of 8 x 256 synthetic tokens:
    ``dryrun.build_cell``'s train step on a 1 x 1 NCCL mesh — phase
    ``train`` (``train_phase_for(13.47e9, 1)``: ZeRO-3, the
    sequence-parallel residual, remat, CE chunks of 512), Adafactor lr
    1e-3 — then the one-device ``make_train_step`` on
    weights rebuilt from the same seed (two states do not fit), same
    runtime, remat and chunks.  Two lowerings of the expert GEMMs, each
    held to its own one-device arm: the cell as built (``dense``, each
    expert capped at ``ecap`` rows, ``torch.bmm``, as the reference's
    cells lower them: the combine's kernel launches, no grouped GEMM
    kernel), then the same cell on the grouped GEMM kernels (``auto``:
    every row computed; the forward and both backward kernels launch
    inside the captured step).  Loss, grad norm and the updated params'
    digest must be equal (else within 2e-2, reported).  The cell's step
    is compiled (one CUDA graph with its collectives, captured at the
    second step); the dense cell's steps under ``eager()`` from the same
    seed are phase 32's eager arm (``arms``).  Returns the graphed steps'
    launches, both lowerings summed."""
    from repro_torch.training.data import synthetic_lm_batches

    _free(torch)
    base = get_config("deepseek-r1")
    cfg = base.replace(num_layers=2,
                       moe=dataclasses.replace(base.moe, first_k_dense=1))
    B, L, steps = 8, 256, 3
    batch = next(synthetic_lm_batches(cfg, B, L, seed=0, device="cuda"))
    dense = _ds_train_cell(torch, cfg, batch, steps, smi, "dense", arms)
    kernel = _ds_train_cell(torch, cfg, batch, steps, smi, "auto", None)
    return {k: dense[k] + kernel[k] for k in dense}


def _ds_train_cell(torch, cfg, batch, steps, smi, lowering, arms) -> dict:
    """One lowering of (a)'s cell against its one-device arm; the graphed
    steps' launches."""
    import numpy as np

    from repro_torch.configs import InputShape
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.transformer import ParallelCtx, build_model
    from repro_torch.training.optimizer import adafactor
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    import torch.distributed as dist

    B, L = batch["tokens"].shape
    keep = dryrun.moe_runtime_for
    meshlib.init_distributed(0, 1, f"tcp://127.0.0.1:{_free_port()}",
                             timeout_s=600)
    try:
        dryrun.moe_runtime_for = (lambda *a, **k: keep(*a, **k)._replace(
            gemm_impl=lowering))
        mesh = meshlib.make_test_mesh(1, 1)
        t0 = time.perf_counter()

        def make():
            return dryrun.build_cell(
                "deepseek-r1", InputShape("train_8x256", L, B, "train"),
                mesh, cfg=cfg)
        cell = make()
        ctx = cell.ctx
        if cell.phase != "train" or not (ctx.sp_residual and ctx.remat):
            raise AssertionError(f"mesh: phase {cell.phase}, ctx {ctx}")
        state = dryrun.init_state(cell, cell.shard(cell.model.init_params(
            torch.Generator(device="cuda").manual_seed(0))))
        log(f"mesh: deepseek-r1 {cfg.num_params() / 1e9:.2f}B params, "
            f"phase {cell.phase} (sp_residual, remat, ce_chunk "
            f"{ctx.ce_chunk}), capacity {ctx.moe_runtime.capacity}, expert "
            f"GEMMs {lowering}, built in {time.perf_counter() - t0:.1f}s")
        ops.reset_launches()
        got = _train_run(torch, f"build_cell train step (1 x 1 NCCL mesh, "
                         f"{lowering})", cell.step, state, batch, steps,
                         smi)
        launches = ops.launch_counts()
        rt = ctx.moe_runtime
        del state, cell
        if arms is not None:
            arms["deepseek-r1 train cell (1 + 1 layers, 8 x 256)"] = \
                _train_arms(got, _eager_train_arm(
                    torch, "deepseek-r1 train cell", make, batch, steps,
                    smi))
    finally:
        dryrun.moe_runtime_for = keep
        dist.destroy_process_group()
    _free(torch)
    want = CELL_PATH if lowering == "dense" else MESH_PATH
    zero = [k for k in want if launches[k] <= 0]
    other = {k: launches[k] for k in MESH_PATH if k not in want
             and launches[k]}
    if zero or other or rt.gemm_impl != lowering:
        raise AssertionError(f"mesh: the {lowering} cell's step launched "
                             f"{launches} (lowering {rt.gemm_impl}; want "
                             f"{want} and no other of {MESH_PATH})")
    model = build_model(cfg, 1, np.zeros((1, 0), np.int32), "cuda")
    opt = adafactor(lr=1e-3)
    state = init_train_state(model, opt,
                             torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, opt, ParallelCtx(moe_runtime=rt,
                                                   remat=True, ce_chunk=512))
    ref = _train_run(torch, "one-device make_train_step", step, state,
                     batch, steps, smi)
    keys = ("loss", "grad_norm", "digest")
    same = all(got[k] == ref[k] for k in keys)
    if not same:       # does the one-device step repeat itself bitwise?
        state = None
        _free(torch)
        again = _train_run(torch, "one-device make_train_step, again",
                           step, init_train_state(
                               model, opt, torch.Generator(
                                   device="cuda").manual_seed(0)),
                           batch, 1, smi)
        equal = all(again[k] == ref[k] for k in keys)
        log(f"mesh: the one-device step repeated from the same seed: "
            f"{'bitwise equal' if equal else 'differs'} (grad_norm "
            f"{again['grad_norm']!r} vs {ref['grad_norm']!r})")
    del state, model, step
    _free(torch)
    err = max(abs(got[k] - ref[k]) for k in ("loss", "grad_norm"))
    log(f"mesh: {lowering} cell vs one-device: loss, grad_norm and params digest "
        f"{'bitwise equal' if same else f'differ (max |err| {err:.3e})'}; "
        f"step wall {got['wall_ms']:.1f} vs {ref['wall_ms']:.1f} ms, peak "
        f"{got['peak_gib']:.2f} vs {ref['peak_gib']:.2f} GiB; launches "
        f"{json.dumps({k: launches[k] for k in MESH_PATH})} over {steps} "
        f"steps ({smi})")
    if not same and not err <= 2e-2:
        raise AssertionError(f"mesh: cell {got} vs one-device {ref}")
    return launches


# the train cells that also run their one-device step without the
# attention's q-block checkpoints
UNCHECKPOINTED = ("gemma3-4b",)
# train cells whose depth is cut (layers), for the script's time limit:
# gemma3-4b's 12 of 34 keep two of its global layers (5 local : 1 global)
TRAIN_CELL_DEPTH = {"gemma3-4b": 12}


def _unchecked_core(torch, attention):
    """``attention._chunked_core`` without its q-block checkpoints: every
    block's fp32 scores and probabilities saved for the backward."""
    def core(cfg, q, k, v, positions, *, is_local=False, causal=True,
             q_blocks):
        bq = q.shape[1] // q_blocks
        outs = [attention._dense_core(
            cfg, q[:, i * bq:(i + 1) * bq], k, v,
            positions[:, i * bq:(i + 1) * bq], positions,
            is_local=is_local, causal=causal) for i in range(q_blocks)]
        return torch.cat(outs, dim=1)
    return core


def _family_train_cell(torch, get_config, smi, arch, B, L, arms) -> dict:
    """(a) ``arch``'s train cell at its published widths and depth (cut
    where ``TRAIN_CELL_DEPTH`` says) on a 1 x 1 NCCL mesh (its production phase ``train_tp``, remat, CE chunks
    of 512, Adafactor lr 1e-3; whisper's frames from numpy) against the
    one-device ``make_train_step`` on weights rebuilt from the same seed:
    loss, grad norm and the updated params' digest must be bitwise equal
    (else, where the one-device step does not repeat itself bitwise,
    within 2e-2, as deepseek-r1's cell).  The cell's step is compiled;
    the same steps under ``eager()`` are phase 32's eager arm."""
    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.models.transformer import ParallelCtx, build_model
    from repro_torch.training.data import synthetic_lm_batches
    from repro_torch.training.optimizer import adafactor
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)
    import torch.distributed as dist

    _free(torch)
    cfg = get_config(arch)
    if arch in TRAIN_CELL_DEPTH:
        cfg = cfg.replace(num_layers=TRAIN_CELL_DEPTH[arch])
    steps = 3
    batch = next(synthetic_lm_batches(cfg, B, L, seed=0, device="cuda"))
    meshlib.init_distributed(0, 1, f"tcp://127.0.0.1:{_free_port()}",
                             timeout_s=600)
    # the production cell's phase (``train_phase_for`` at 16 model ranks:
    # under 17 B params), which one rank's budget alone would not pick
    phase = dryrun.train_phase_for(cfg.num_params(), 16)
    keep = dryrun.train_phase_for
    try:
        mesh = meshlib.make_test_mesh(1, 1)

        def make():
            dryrun.train_phase_for = lambda *a, **k: phase
            try:
                return dryrun.build_cell(arch, InputShape(
                    f"train_{B}x{L}", L, B, "train"), mesh, cfg=cfg)
            finally:
                dryrun.train_phase_for = keep
        cell = make()
        if cell.phase != "train_tp":
            raise AssertionError(f"mesh: {arch} phase {cell.phase}")
        state = dryrun.init_state(cell, cell.shard(cell.model.init_params(
            torch.Generator(device="cuda").manual_seed(0))))
        log(f"mesh: {arch} {cfg.num_params() / 1e9:.3f}B params, "
            f"{cfg.num_layers} layers, train cell on {B} x {L} tokens"
            + (f" + {cfg.encoder_seq_len} numpy frames a row"
               if cfg.is_encoder_decoder else "")
            + f", phase {cell.phase}")
        got = _train_run(torch, f"{arch} build_cell train step (1 x 1 "
                         "NCCL mesh)", cell.step, state, batch, steps, smi)
        del state, cell
        arms[f"{arch} train cell ({cfg.num_layers} layers, {B} x {L})"] = \
            _train_arms(got, _eager_train_arm(
                torch, f"{arch} train cell", make, batch, steps, smi))
    finally:
        dryrun.train_phase_for = keep
        dist.destroy_process_group()
    _free(torch)
    model = build_model(cfg, 1, None, "cuda")
    opt = adafactor(lr=1e-3)
    state = init_train_state(model, opt,
                             torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, opt, ParallelCtx(remat=True, ce_chunk=512))
    ref = _train_run(torch, f"{arch} one-device make_train_step", step,
                     state, batch, steps, smi)
    keys = ("loss", "grad_norm", "digest")
    same = all(got[k] == ref[k] for k in keys)
    repeats = True
    if not same:       # does the one-device step repeat itself bitwise?
        state = None
        _free(torch)
        again = _train_run(torch, f"{arch} one-device step, again", step,
                           init_train_state(model, opt, torch.Generator(
                               device="cuda").manual_seed(0)), batch, 1, smi)
        repeats = all(again[k] == ref[k] for k in keys)
    plain = None
    if arch in UNCHECKPOINTED:     # the same step, the q-blocks unchecked
        from repro_torch.models import attention
        state = None
        _free(torch)
        attention_core = attention._chunked_core
        attention._chunked_core = _unchecked_core(torch, attention)
        try:
            plain = _train_run(torch, f"{arch} one-device step without the "
                               "attention's q-block checkpoints", step,
                               init_train_state(model, opt, torch.Generator(
                                   device="cuda").manual_seed(0)), batch,
                               steps, smi)
        finally:
            attention._chunked_core = attention_core
    del state, model, step
    _free(torch)
    err = max(abs(got[k] - ref[k]) for k in ("loss", "grad_norm"))
    verdict = ("bitwise equal" if same else
               f"DIFFER (max |err| {err:.3e}); the one-device step repeats "
               f"itself bitwise: {repeats}")
    log(f"mesh: {arch} train cell vs one-device: loss, grad_norm and params "
        f"digest {verdict}"
        f"; step wall {got['wall_ms']:.1f} vs {ref['wall_ms']:.1f} ms, peak "
        f"{got['peak_gib']:.2f} vs {ref['peak_gib']:.2f} GiB, idle share "
        f"{got['idle']} vs {ref['idle']} ({smi})")
    if plain is not None:
        plain_same = all(plain[k] == ref[k] for k in keys)
        log(f"mesh: {arch} train cell with the attention's q-block "
            f"checkpoints: peak {got['peak_gib']:.2f} GiB, step wall "
            f"{got['wall_ms']:.1f} ms (one-device {ref['peak_gib']:.2f} GiB, "
            f"{ref['wall_ms']:.1f} ms); the one-device step without them in "
            f"this run {plain['peak_gib']:.2f} GiB, {plain['wall_ms']:.1f} ms"
            f", loss, grad_norm and params digest "
            f"{'bitwise equal' if plain_same else 'DIFFER'} ({smi})")
        if not plain_same:
            raise AssertionError(f"mesh: {arch} with and without the q-block"
                                 f" checkpoints: {ref} vs {plain}")
    if got["top"]:
        log(f"mesh: {arch} train cell, the profiled step's device rows "
            "(ms a step, calls): " + "; ".join(
                f"{k[:60]} {ms:.1f} ({n:.0f})" for k, (ms, n) in got["top"]))
    if not same and (repeats or not err <= 2e-2):
        raise AssertionError(f"mesh: {arch} cell {got} vs one-device {ref}")
    return got


# (arch, prompt tokens (lo, hi): each row's length drawn in between,
# slots, logits tolerance, tokens must be equal)
FAMILY_DECODE = (("gemma3-4b", (1100, 1800), 2048, 3e-2, False),
                 ("zamba2-2.7b", (1100, 1800), 2048, 3e-2, False),
                 ("rwkv6-7b", (64, 64), 128, 2e-2, True),
                 ("whisper-base", (64, 64), 448, 3e-2, False))
FAMILY_STEPS = 16
FAMILY_KERNELS = ("flash_decode", "flash_decode_partial")


def _ragged_prefill(torch, model, params, prompts, ctx, slots: int):
    """Prompts of different lengths each prefilled alone into its own
    cache of ``slots`` slots, the caches joined along their batch dims
    (found by role, ``sharding_rules.cache_placements``): (the last
    logits, the batch's cache)."""
    from repro_torch.distributed import sharding_rules as tsr
    from repro_torch.training import tree

    outs = [model.prefill(params, p[None], ctx, max_slots=slots)
            for p in prompts]
    cache = outs[0][1]
    if len(outs) > 1:
        rows = [dict(tree.paths(o[1])) for o in outs]
        cache = tree.map_paths(lambda path, _, spec: torch.cat(
            [r[path] for r in rows], dim=spec.index("data")), cache,
            tsr.cache_placements(cache, 2, ("data",), (), -1))
    return torch.cat([o[0] for o in outs]), cache


def _ragged_greedy(torch, model, params, prompts, ctx, steps: int,
                   slots: int, forced=None):
    """``_ragged_prefill``, then ``steps`` plain batched decode steps
    (``_decode_loop``).  Returns (the logits of every step, the tokens
    fed)."""
    from repro_torch.launch import dryrun

    logits, cache = _ragged_prefill(torch, model, params, prompts, ctx,
                                    slots)
    return _decode_loop(torch, dryrun.serve_step_of(model, ctx, logits=True),
                        params, logits, cache, steps, forced)[:2]


def _decode_arm(torch, serve, params, logits, cache, steps: int) -> tuple:
    """One of phase 32's arms of a decode cell: ``steps`` greedy calls of
    the compiled ``serve`` from a prefill's ``logits`` and ``cache``,
    each call's wall, the calls' launches, then two more calls profiled.
    Returns (the logits of every step, the tokens fed, the arm's record)."""
    from repro_torch.kernels import ops

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before, walls = ops.launch_counts(), []
    seq, toks, (cache, tok) = _decode_loop(torch, serve, params, logits,
                                           cache, steps, walls=walls)
    after = ops.launch_counts()
    arm = _mesh_arm(serve, walls=walls, **_memory(torch),
                    launches={k: after[k] - before[k] for k in after})
    arm["prof"] = _profile_calls(torch, lambda: serve(params, tok, cache))
    return seq, toks, arm


def _family_decode_cell(torch, get_config, smi, arch, P, slots, tol,
                        equal_tokens, arms) -> dict:
    """(a) ``arch``'s decode cell at its published widths and depth on a
    1 x 1 NCCL mesh (phase ``decode``: the linear caches slot-sharded,
    gemma3's rings whole, rwkv6 through its island on a group of one):
    8 prompts of ``P = (lo, hi)`` tokens (each row's length drawn in
    between) prefilled into ``slots`` slots, then FAMILY_STEPS greedy
    steps through the cell's serve step compiled (``dryrun.compile_serve``
    of its step with the logits returned: a CUDA graph with its c10d
    calls), against the one-device path on the same weights: the logits
    of 8 teacher-forced steps within ``tol``, both greedy digests (equal
    tokens where ``equal_tokens``).  The same steps under ``eager()`` from
    the same prefilled cache are phase 32's eager arm (``arms``).
    Returns the cell's flash-decode launches."""
    from repro_torch.configs import InputShape
    from repro_torch.kernels import build, ops
    from repro_torch.launch import dryrun
    from repro_torch.training import tree

    _free(torch)
    cfg = get_config(arch)
    B = 8
    g = torch.Generator().manual_seed(25)
    lens = torch.randint(P[0], P[1] + 1, (B,), generator=g).tolist()
    prompt = [torch.randint(0, cfg.vocab_size, (n,), generator=g).cuda()
              for n in lens]

    def graphed_and_eager(mesh):
        cell = dryrun.build_cell(arch, InputShape("decode", slots, B,
                                                  "decode"), mesh, cfg=cfg)
        model, ctx = cell.model, cell.ctx
        full = model.init_params(torch.Generator(device="cuda")
                                 .manual_seed(0))
        params = cell.shard(full)              # views on a 1 x 1 mesh
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        step = dryrun.serve_step_of(model, ctx, logits=True)
        with torch.no_grad():
            logits, cache = _ragged_prefill(torch, model, params, prompt,
                                            ctx, slots)
            start = tree.map_paths(lambda _, t: t.clone(), cache)
            seq, toks, g_arm = _decode_arm(
                torch, dryrun.compile_serve(step, ctx, "cuda"), params,
                logits, cache, FAMILY_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated() / 2**30
            with build.eager():
                e_seq, e_toks, e_arm = _decode_arm(
                    torch, dryrun.compile_serve(step, ctx, "cuda"), params,
                    logits, start, FAMILY_STEPS)
        arms[f"{arch} decode cell ({cfg.num_layers} layers, {B} rows, "
             f"{slots} slots)"] = {
            "kind": "decode", "graphs": g_arm, "eager": e_arm,
            "calls": FAMILY_STEPS,
            "equal": {"logits": torch.equal(seq, e_seq),
                      "tokens": torch.equal(toks, e_toks)}}
        return model, full, seq, toks, wall, launches, peak
    model, full, seq, toks, wall, launches, peak = _nccl_world(
        torch, graphed_and_eager)
    if seq.shape != (FAMILY_STEPS + 1, B, cfg.padded_vocab) or \
            not torch.isfinite(seq).all():
        raise AssertionError(f"mesh: {arch} bad logits {tuple(seq.shape)}")
    with torch.no_grad():
        ref, _ = _ragged_greedy(torch, model, full, prompt, None, 8, slots,
                                forced=toks.T)
        _, ltoks = _ragged_greedy(torch, model, full, prompt, None,
                                  FAMILY_STEPS, slots)
    errs = (seq[:9] - ref).abs().amax(dim=(1, 2)).tolist()
    err = max(errs)
    same = int((toks == ltoks).sum())
    digest = lambda t: hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()  # noqa: E731
    fd = {k: launches[k] for k in FAMILY_KERNELS}
    log(f"mesh: {arch} decode cell (1 x 1 NCCL mesh, {cfg.num_layers} "
        f"layers, {B} prompts of {min(lens)}-{max(lens)} tokens, {slots} "
        f"slots, "
        f"{FAMILY_STEPS} greedy steps, compiled): prefill + decode "
        f"{wall:.2f}s wall, "
        f"peak {peak:.2f} GiB; vs the one-device path: max |logit err| "
        f"{err:.3e} (tol {tol}; by step {[float(f'{e:.3g}') for e in errs]})"
        f", bitwise equal {torch.equal(seq[:9], ref)}; greedy tokens sha1 "
        f"cell {digest(toks)}, one-device {digest(ltoks)}, {same}/"
        f"{toks.numel()} equal; launches {json.dumps(fd)} ({smi})")
    del full, model
    _free(torch)
    if not err <= tol:
        raise AssertionError(f"mesh: {arch} decode cell logits differ {err}")
    if equal_tokens and same != toks.numel():
        raise AssertionError(f"mesh: {arch} decode cell tokens differ")
    return fd


def mesh_families_full(torch, get_config, smi, arms) -> dict:
    """(a) the four families' cells at full width and depth on a 1 x 1
    NCCL mesh, compiled (phase 32's arms into ``arms``): gemma3-4b's and
    whisper-base's train cells bitwise the one-device step, and the
    decode cells of all four.  The partial flash
    decode (SP decode over gemma3's globals, zamba2's shared block,
    whisper's self cache) and flash decode (gemma3's rings, whisper's
    cross attention) must launch where the cell runs them.  Returns the
    launches by family."""
    t0 = time.perf_counter()
    _family_train_cell(torch, get_config, smi, "gemma3-4b", 8, 2048, arms)
    _family_train_cell(torch, get_config, smi, "whisper-base", 8, 256, arms)
    times = {"train cells": time.perf_counter() - t0}
    out = {}
    for arch, P, slots, tol, eq in FAMILY_DECODE:
        t0 = time.perf_counter()
        out[arch] = _family_decode_cell(torch, get_config, smi, arch, P,
                                        slots, tol, eq, arms)
        times[arch] = time.perf_counter() - t0
    log(f"time: mesh: the families' cells (s) "
        f"{json.dumps({k: round(v, 1) for k, v in times.items()})}")
    need = {"gemma3-4b": FAMILY_KERNELS,
            "zamba2-2.7b": ("flash_decode_partial",),
            "whisper-base": FAMILY_KERNELS}
    zero = [(a, k) for a, ks in need.items() for k in ks if out[a][k] <= 0]
    if zero:
        raise AssertionError(f"mesh: the family cells never launched {zero}")
    if any(out["rwkv6-7b"].values()):
        raise AssertionError("mesh: rwkv6 launched an attention kernel")
    return out


class _MeshShape:
    """A (data, model) mesh's names and sizes, all ``moe_runtime_for``
    reads of one."""

    mesh_dim_names = ("data", "model")

    def __init__(self, n_data, n_model):
        self.shape = (n_data, n_model)

    def get_coordinate(self):
        return self.coord


MESH_CELLS = (("train", "train"), ("train", "train_tp"),
              ("prefill", "serve"), ("decode", "decode"))
MESH_B, MESH_S, MESH_LEN = 8, 32, 20
# the four families' reduced cells (4 gloo ranks): train in train_tp, as
# their dry-run cells; 48 slots (whisper's encoder holds 32 frames), a
# 16-slot gemma3 ring (one global group: 8 layers), whisper's 2 heads
# (gathered over the model axis)
FAMILY_CELLS = (("train", "train_tp"), ("prefill", "serve"),
                ("decode", "decode"))
FAMILY_OVERRIDES = {"gemma3-4b": {"num_layers": 8, "sliding_window": 16},
                    "zamba2-2.7b": {}, "rwkv6-7b": {},
                    "whisper-base": {"num_heads": 2, "num_kv_heads": 2}}
FAMILY_S = 48


def _cells_of(arch):
    """(the cells, their sequence and slots) of an arch in (b)."""
    if arch in FAMILY_OVERRIDES:
        return FAMILY_CELLS, FAMILY_S
    return MESH_CELLS, MESH_S


def _mesh_cfg(get_config, arch):
    """The reduced float32 config of (b).  On a mesh the Switch aux loss is
    the mean of each client's loss (the reference's), which one process
    with one client cannot form; the comparison sets its coefficient to 0
    on both sides (the CPU tests hold it against the reference's mesh)."""
    cfg = get_config(arch).reduced().replace(
        dtype="float32", **FAMILY_OVERRIDES.get(arch, {}))
    if cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, router_aux_loss_coef=0.0))
    return cfg


def _mesh_inputs(torch, cfg, kind, S=MESH_S):
    """A cell's inputs, whole: tokens (+ labels, + whisper's frames) from a
    seed; the decode cell's cache holds MESH_LEN random tokens."""
    g = torch.Generator().manual_seed(7)
    tok = torch.randint(0, cfg.vocab_size, (MESH_B, 1 if kind == "decode"
                                            else S), generator=g)
    out = {"tokens": tok}
    if kind == "train":
        out["labels"] = torch.randint(0, cfg.vocab_size, (MESH_B, S),
                                      generator=g)
        if cfg.is_encoder_decoder:
            out["frames"] = 0.1 * torch.randn(
                (MESH_B, cfg.encoder_seq_len, cfg.d_model), generator=g)
    return out


def _mesh_cache(torch, model, cfg, S=MESH_S):
    """A whole cache of MESH_B rows and S slots, random: each linear K/V
    written up to MESH_LEN (a ring and the encoder's K/V everywhere),
    lengths MESH_LEN, recurrent states random."""
    from repro_torch.training import tree

    g = torch.Generator().manual_seed(8)

    def fill(path, leaf):
        if path[-1] == "length":
            return torch.full_like(leaf, MESH_LEN)
        out = torch.randn(leaf.shape, generator=g).to(leaf)
        if path[-1] in ("k", "v") and leaf.shape[-3] == S:
            out[..., MESH_LEN:, :, :] = 0
        return out
    return tree.map_paths(fill, model.init_cache(MESH_B, S))


def _no_drop_runtime(dryrun, patch: bool):
    """``moe_runtime_for`` with each client's capacity holding all its
    routed tokens and the expert GEMMs on the kernel, which computes every
    row (no drops, no expert capped: the one-process run then computes the
    same function with one client, where the dense lowering's cap, sized
    from a server's rows, would drop other rows)."""
    keep = dryrun.moe_runtime_for

    def every_token(cfg, mesh, shape, mode, device=None):
        rt = keep(cfg, mesh, shape, mode, device)
        if rt is None:
            return rt
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        per = (shape.global_batch * shape.seq_len if mode == "a2a"
               else shape.global_batch) // sizes["data"]
        if mode == "a2a":
            per //= sizes["model"]
        return rt._replace(capacity=max(per, 1) * cfg.moe.top_k,
                           gemm_impl="auto")
    if patch:
        dryrun.moe_runtime_for = every_token
    return keep, every_token


MESH_ARCHS = ("deepseek-r1", "qwen2-vl-2b", *FAMILY_OVERRIDES)


def _mesh_rank(rank: int, world: int, init: str, q) -> None:
    """(b) one of 4 gloo ranks on the one card, mesh (2, 2): for reduced
    float32 deepseek-r1 and qwen2-vl-2b, ``dryrun.build_cell``'s train
    step in phases train and train_tp, its prefill (serve) and serve step
    (decode); for gemma3, zamba2, rwkv6 and whisper their train
    (train_tp), prefill and serve cells; puts this rank's outputs (or the
    error) on ``q``."""
    sys.path.insert(0, str(ROOT / "src"))
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.configs import InputShape, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as meshlib
    from repro_torch.training import tree

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=120))  # a rank that fails
        # fails its peers' collectives too, not after gloo's 30 minutes
        mesh = meshlib.make_test_mesh(2, 2, device="cuda")
        _no_drop_runtime(dryrun, True)
        out, launches, reasons = {}, {}, {}
        keep_phase = dryrun.train_phase_for
        for arch in MESH_ARCHS:
            cfg = _mesh_cfg(get_config, arch)
            cells, S = _cells_of(arch)
            for kind, phase in cells:
                key = f"{arch}/{phase}"
                if arch not in FAMILY_OVERRIDES:
                    dryrun.train_phase_for = lambda *a, **k: phase  # noqa
                cell = dryrun.build_cell(arch, InputShape(
                    kind, S, MESH_B, kind), mesh, cfg=cfg)
                dryrun.train_phase_for = keep_phase
                if cell.phase != phase:
                    raise AssertionError(f"{key}: phase {cell.phase}")
                full = cell.model.init_params(
                    torch.Generator(device="cuda").manual_seed(0))
                params = tree.map_params(lambda p: p.clone(),
                                         cell.shard(full))
                del full
                inp = {k: cell.rows(k, v).cuda() for k, v in
                       _mesh_inputs(torch, cfg, kind, S).items()}
                ops.reset_launches()
                if kind == "train":
                    st, met = cell.step(dryrun.init_state(cell, params), inp)
                    out[key] = {"loss": float(met["loss"]),
                                "grad_norm": float(met["grad_norm"]),
                                "params": {"/".join(p): v.detach().cpu()
                                           .numpy() for p, v in
                                           tree.items(st.params)}}
                elif kind == "prefill":
                    with torch.no_grad():
                        logits, cache = cell.step(params, inp["tokens"])
                    out[key] = {"logits": logits.cpu().numpy(),
                                "k": _numpy_leaves(tree, cache)}
                else:
                    cache = tree.map_paths(
                        lambda _, t: t.clone().cuda(),
                        cell.cache_shard(_mesh_cache(torch, cell.model, cfg,
                                                     S)))
                    with torch.no_grad():
                        logits = cell.model.decode_step(
                            params, inp["tokens"],
                            tree.map_paths(lambda _, t: t.clone(), cache),
                            cell.ctx)[0]
                        nxt, cache = cell.step(params, inp["tokens"],
                                               cache)
                    out[key] = {"logits": logits.cpu().numpy(),
                                "next": nxt.cpu().numpy(),
                                "k": _numpy_leaves(tree, cache)}
                torch.cuda.synchronize()
                launches[key] = ops.launch_counts()
                reasons[key] = cell.step.decision.reason
        q.put((rank, out, launches, mesh.get_coordinate(), reasons))
    except Exception as e:  # noqa: BLE001 - reported to the parent
        import traceback
        q.put((rank, f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
               None, None, None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _numpy_leaves(tree, cache) -> dict:
    """{path: array} of a cache's leaves (``tree.paths``)."""
    return {"/".join(p): c.cpu().numpy() for p, c in tree.paths(cache)}


def _mesh_one_process(torch, arch, cfg, kind, phase) -> dict:
    """The same cell's function in one process on one device: the whole
    model, one client holding every token (no drops), the mesh's 2
    servers' layout, mapping and local tables."""
    import numpy as np

    from repro_torch.configs import InputShape
    from repro_torch.launch import dryrun
    from repro_torch.models.transformer import ParallelCtx, build_model
    from repro_torch.training import tree
    from repro_torch.training.optimizer import adafactor
    from repro_torch.training.train_loop import (init_train_state,
                                                 make_train_step)

    n = 2 if cfg.moe else 1
    _, S = _cells_of(arch)
    model = build_model(cfg, n, np.zeros((n, 0), np.int32), "cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    shape = InputShape(kind, S, MESH_B, kind)
    mode = "replicated" if kind == "decode" else "a2a"
    rt = dryrun.moe_runtime_for(cfg, _MeshShape(1, 2), shape, mode,
                                device="cuda")
    if rt is not None:                     # every row, as _no_drop_runtime
        rows = MESH_B if kind == "decode" else MESH_B * S
        rt = rt._replace(capacity=rows * cfg.moe.top_k, gemm_impl="auto")
    ctx = ParallelCtx(moe_runtime=rt, remat=True, ce_chunk=512)
    inp = {k: v.cuda() for k, v in _mesh_inputs(torch, cfg, kind,
                                                 S).items()}
    if kind == "train":
        opt = adafactor(lr=1e-3)
        st, met = make_train_step(model, opt, ctx)(
            init_train_state(model, opt, None, params=params), inp)
        return {"loss": float(met["loss"]),
                "grad_norm": float(met["grad_norm"]),
                "params": tree.map_params(lambda p: p.detach().cpu().numpy(),
                                          st.params)}
    with torch.no_grad():
        if kind == "prefill":
            logits, cache, _ = model.prefill(params, inp["tokens"], ctx,
                                             max_slots=S)
            return {"logits": logits.cpu().numpy(), "cache": cache,
                    "k": _numpy_leaves(tree, cache)}
        logits, cache, _ = model.decode_step(
            params, inp["tokens"], tree.map_paths(
                lambda _, t: t.cuda(), _mesh_cache(torch, model, cfg, S)),
            ctx)
    return {"logits": logits.cpu().numpy(), "cache": cache,
            "next": logits.argmax(-1, keepdim=True).int().cpu().numpy(),
            "k": _numpy_leaves(tree, cache)}


def mesh_multirank(torch, get_config, smi) -> None:
    """(b) 4 gloo ranks on the card, (2, 2): every cell of reduced
    float32 deepseek-r1 (its aux loss off, ``_mesh_cfg``) and qwen2-vl-2b,
    and the train / prefill / decode cells of reduced float32 gemma3,
    zamba2, rwkv6 and whisper, against the one-process run, 1e-5: train
    (loss, grad norm, every updated shard), prefill (logits and cache
    rows), decode (logits and next token rows, the cache shard).
    deepseek-r1's and qwen2-vl-2b's errors are absolute; the four
    families' loss and grad norm are held relatively (rwkv6's grad norm
    runs to ~1e3), their logits and caches normwise (max |err| over the
    largest magnitude, at least 1: recurrent states are sums over the
    sequence), and zamba2 at 5e-4, its recorded amplification (the CPU
    tests)."""
    import numpy as np

    from repro_torch.distributed import sharding_rules as tsr
    from repro_torch.training import tree

    t0 = time.perf_counter()
    ranks = _run_ranks(_mesh_rank, 4, (), timeout=600)
    log(f"time: mesh: the 4 gloo ranks answered in "
        f"{time.perf_counter() - t0:.1f} s")
    bad = [r[1] for r in ranks if r[2] is None]
    if bad:
        raise AssertionError(f"mesh (4 ranks): a rank failed:\n{bad[0]}")
    log(f"mesh: the 4 gloo ranks' compiled cells run eagerly: "
        f"{sorted({v for r in ranks for v in r[4].values()})}")
    b, errs, tols = MESH_B // 2, {}, {}
    mesh = _MeshShape(2, 2)

    def err_of(got, want, normwise: bool) -> float:
        """max |got - want|, over max(1, max |want|) where ``normwise``."""
        err = float(np.abs(got - want).max())
        return err / max(1.0, float(np.abs(want).max())) if normwise else err

    for arch in MESH_ARCHS:
        cfg = _mesh_cfg(get_config, arch)
        cells, S = _cells_of(arch)
        rel = arch in FAMILY_OVERRIDES
        for kind, phase in cells:
            key = f"{arch}/{phase}"
            ref = _mesh_one_process(torch, arch, cfg, kind, phase)
            specs = None
            if kind != "train":
                placed = tsr.cache_placements(
                    ref["cache"], MESH_B, ("data",),
                    ("model",) if kind == "decode" else (), S)
                specs = {"/".join(p): v for p, v in tree.paths(placed)}
            err = 0.0
            for rank, out, launches, (d, m), _ in ranks:
                got = out[key]
                mesh.coord = [d, m]
                if kind == "train":
                    err = max(err, *(err_of(got[k], ref[k], rel)
                                     for k in ("loss", "grad_norm")))
                    want = tsr.shard_params(ref["params"], mesh, phase,
                                            dense=True)
                    for path, v in got["params"].items():
                        node = want
                        for part in path.split("/"):
                            node = node[part]
                        err = max(err, float(np.abs(v - node).max()))
                    if cfg.moe and any(launches[key][k] <= 0
                                       for k in MESH_PATH):
                        raise AssertionError(f"mesh: {key} rank {rank} "
                                             f"launches {launches[key]}")
                    continue
                rows = slice(d * b, (d + 1) * b)
                err = max(err, err_of(got["logits"], ref["logits"][rows],
                                      rel))
                sizes = {"data": 2, "model": 2}
                for n, k in got["k"].items():
                    want = tsr.shard_leaf(ref["k"][n], specs[n], sizes,
                                          {"data": d, "model": m})
                    err = max(err, err_of(k, want, rel))
                if kind == "decode" and not np.array_equal(
                        got["next"], ref["next"][rows]):
                    raise AssertionError(f"mesh: {key} next tokens")
            errs[key] = err
            tols[key] = 5e-4 if arch == "zamba2-2.7b" else 1e-5
    log(f"mesh: 4 gloo ranks on one card, mesh (2, 2), reduced float32 "
        f"cells vs the one-process run: max |err| "
        f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
        f"(tol 1e-5, zamba2 5e-4) ({smi})")
    over = {k: v for k, v in errs.items() if not v <= tols[k]}
    if over:
        raise AssertionError(f"mesh (4 ranks): cells differ {over}")


def _accounting_start():
    """(c) the dry-run's accounting of deepseek-r1 train_4k on pod16x16,
    on meta under the fake backend, in its own process (its fake world
    must not meet this process's groups); runs beside the card work."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "deepseek-r1", "--shape", "train_4k", "--no-save", "--json"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _accounting_report(proc) -> None:
    try:
        text, _ = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    rows = [json.loads(x) for x in text.splitlines() if x.startswith("{")]
    if proc.returncode != 0 or not rows or rows[0]["status"] != "ok":
        raise AssertionError(f"mesh: the dry-run accounting failed:\n"
                             f"{text[-3000:]}")
    r = rows[0]
    mem = r["memory"]
    log(f"mesh: dry-run accounting (meta, fake backend, no card) of "
        f"deepseek-r1 train_4k on {r['mesh']} ({r['num_devices']} ranks, "
        f"phase {r['phase']}, counted in {r['count_s']}s): per rank "
        f"{r['flops_per_device']:.4e} FLOPs, argument bytes "
        f"{json.dumps(mem['argument_bytes'])}, peak "
        f"{mem['peak_bytes_per_device'] / 2**30:.2f} GiB (fits 80 GiB: "
        f"{mem['fits_h100_80gib']}), collective bytes "
        f"{json.dumps(r['collective_bytes_per_device'])}, counts "
        f"{json.dumps(r['collective_counts'])}")


def mesh_phase(torch, get_config, smi, arms):
    """Phase 25: the dry-run's cells on torch.distributed — (a) the
    full-width deepseek-r1 train cell on a 1 x 1 NCCL mesh against the
    one-device step, then the full-width cells of gemma3-4b, zamba2-2.7b,
    rwkv6-7b and whisper-base (``mesh_families_full``), their steps
    compiled (phase 32's arms into ``arms``), (b) 4 gloo ranks on the
    card running reduced cells against the one-process run (eagerly:
    gloo's collectives cannot be captured), (c) the dry-run's per-rank
    accounting (beside them, in its own process).  Returns (a)'s
    launches: deepseek-r1's, and the families' flash-decode launches by
    family."""
    acct = _accounting_start()
    try:
        t0 = time.perf_counter()
        launches = mesh_full_width(torch, get_config, smi, arms)
        t1 = time.perf_counter()
        families = mesh_families_full(torch, get_config, smi, arms)
        t2 = time.perf_counter()
        mesh_multirank(torch, get_config, smi)
        t3 = time.perf_counter()
        _accounting_report(acct)
        log(f"time: mesh: deepseek-r1's cell {t1 - t0:.1f} s, the "
            f"families' cells {t2 - t1:.1f} s, 4 gloo ranks {t3 - t2:.1f} "
            f"s, then waited {time.perf_counter() - t3:.1f} s for the "
            "accounting")
    finally:
        if acct.poll() is None:
            acct.kill()
    return launches, families


def mesh_alone(torch, get_config, smi) -> None:
    """``--only mesh``: the partial kernel's checks (the families' shapes
    among them), then phase 25."""
    cases = {"flash_decode_partial": []}
    partial_kernel_phase(torch, get_config("deepseek-r1"), cases)
    mesh_phase(torch, get_config, smi, {})


# ---------------------------------------- phase 32: the mesh steps graphed

# the graphed step's wall (ms) predicted before the first chip run of the
# phase (PERF.md §6, PR 31), by the start of a cell's label
MESH_PREDICTED = {"spmd deepseek-r1": (5.5, 8.0),
                  "gemma3-4b decode": (7.5, 12.0),
                  "zamba2-2.7b decode": (11.5, 16.0),
                  "rwkv6-7b decode": (33.0, 40.0),
                  "whisper-base decode": (1.1, 3.0),
                  "deepseek-r1 train": (1050.0, 1250.0),
                  "gemma3-4b train": (1100.0, 1500.0),
                  "whisper-base train": (10.0, 60.0)}


def _mesh_graph_checks(label: str, r: dict) -> list:
    """What phase 32 requires of one cell's arms: bitwise equal outputs;
    the graphed arm graphed, captured once and replayed at every call
    after the capture; the eager arm eager under ``eager()``, with no
    capture; equal kernel launches over the decode steps."""
    g, e, n = r["graphs"], r["eager"], r["calls"]
    bad = [f"{label}: {k} differ between the arms"
           for k, same in r["equal"].items() if not same]
    if not g["graphed"]:
        bad.append(f"{label}: not graphed ({g['reason']})")
    if (g["captures"], g["replays"]) != (1, n - 2):
        bad.append(f"{label}: graphs captured {g['captures']} and replayed "
                   f"{g['replays']} times over {n} calls (want 1, {n - 2})")
    if "prefill" in g and g["prefill"]["captures"] != 1:
        bad.append(f"{label}: the prefill captured "
                   f"{g['prefill']['captures']} times")
    for arm in (e, e.get("prefill")):
        if arm is not None and (arm["graphed"] or arm["captures"]
                                or "under eager()" not in arm["reason"]):
            bad.append(f"{label}: the eager arm {arm['reason']}, captured "
                       f"{arm['captures']}")
    if "launches" in g and g["launches"] != e["launches"]:
        bad.append(f"{label}: launches differ: {g['launches']} vs "
                   f"{e['launches']}")
    return bad


def _mesh_arm_line(label: str, name: str, a: dict, smi: str) -> str:
    p = a.get("prof")
    replays = a["walls"][2:] or a["walls"]
    prof = ("the profiler saw no device time (not measured)" if p is None
            else f"profiled call {p['plain_ms']:.3f} ms, device busy "
                 f"{p['busy_ms']:.3f} ms (union {p['union_ms']:.3f}), idle "
                 f"share {max(0.0, 1 - p['union_ms'] / p['plain_ms']):.4f}, "
                 f"host calls that enqueue work {p['host_launches']:.1f} a "
                 f"call, c10d host calls {p['c10d_calls']:.1f} a call")
    return (f"mesh-graphs: {label} ({name}): {a['reason']}; captures "
            f"{a['captures']}, replays {a['replays']}, c10d calls inside the "
            f"graph {a['collectives']}; wall p50 "
            f"{statistics.median(replays):.3f} ms over calls 3-"
            f"{len(a['walls'])} (call 1 {a['walls'][0]:.3f} ms, call 2 "
            f"{a['walls'][1]:.3f} ms"
            + (": the eager call and the capture" if a["graphed"] else "")
            + f"); {prof}; graph pool {a['pool_gib']:.3f} GiB; peak "
            f"{a['peak_gib']:.2f} GiB allocated, {a['reserved_gib']:.2f} GiB "
            f"reserved ({smi})")


def mesh_graphs_phase(torch, smi, arms: dict) -> dict:
    """Phase 32: the reference's jitted mesh steps as CUDA graphs
    (``dryrun.build_cell``'s train, prefill and serve steps over NCCL,
    with their c10d calls in the graph) against ``eager()`` on the same
    weights, for every 1 x 1 NCCL cell of phases 24-25 (``arms``, filled
    there): the SPMD deepseek-r1 prefill and 32 decode steps, the three
    train cells and the four families' decode cells.  Each cell's arms
    bitwise equal (logits and tokens; losses, grad norms and the params'
    digest), one capture and a replay at every later call under the
    key, none eager; per arm the wall p50 over the replays, a profiled
    call's device busy, idle share, host calls that enqueue work and
    c10d calls, the c10d calls the graph holds, the graph pool and the
    peak memory, beside the predicted graphed wall.  Returns the graphed
    arms' launches by cell (the decode cells')."""
    bad, out = [], {}
    for label, r in arms.items():
        bad += _mesh_graph_checks(label, r)
        g, e = r["graphs"], r["eager"]
        for name, a in (("graphs", g), ("eager", e)):
            log(_mesh_arm_line(label, name, a, smi))
        gw = statistics.median(g["walls"][2:] or g["walls"])
        ew = statistics.median(e["walls"][2:] or e["walls"])
        lo, hi = next((v for k, v in MESH_PREDICTED.items()
                       if label.startswith(k)), (None, None))
        log(f"mesh-graphs: {label}: bitwise equal "
            f"{json.dumps(r['equal'])}; wall p50 graphs {gw:.3f} ms vs eager "
            f"{ew:.3f} ms ({ew / gw:.2f}x); predicted graphs "
            + ("none" if lo is None else
               f"{lo}-{hi} ms: {'inside' if lo <= gw <= hi else 'OUTSIDE'}")
            + f" ({smi})")
        if "launches" in g:
            out[label] = g["launches"]
    if bad:
        raise AssertionError("mesh-graphs: " + "; ".join(bad))
    return out


def mesh_graphs_alone(torch, get_config, smi) -> None:
    """``--only mesh-graphs``: phase 24's full-width deepseek-r1 and phase
    25's full-width cells on their 1 x 1 NCCL meshes, each graphed and
    under ``eager()`` (with their checks against the one-device path),
    then phase 32's report; no gloo ranks, no accounting."""
    arms = {}
    _nccl_world(torch, lambda mesh: spmd_full_width(torch, get_config, smi,
                                                    mesh, arms))
    _free(torch)
    mesh_full_width(torch, get_config, smi, arms)
    mesh_families_full(torch, get_config, smi, arms)
    mesh_graphs_phase(torch, smi, arms)


def _tmix_per_token(torch, rwk, params, cfg, x, state):
    """``rwkv.tmix_forward`` without its chunk checkpoints: one per-token
    loop over the whole sequence, every token's three (B, H, D, D) states
    saved for the backward (the oracle of phase 26)."""
    _, D = rwk.dims(cfg)
    H = params["w_r"].shape[1] // D
    shifted = torch.cat([state.shift_tmix.to(x.dtype)[:, None], x[:, :-1]],
                        dim=1)
    r, k, v, g, w = rwk._projections(params, x, shifted, H, D)
    S, u = state.wkv, params["bonus_u"]
    ys = []
    for t in range(x.shape[1]):
        S, y = rwk._wkv_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    y = torch.stack(ys, dim=1)
    return rwk._group_norm_out(params, y, g, x.dtype), S, x[:, -1]


def remat_phase(torch, get_config, smi) -> None:
    """Phase 26: one rwkv6-7b time-mix layer at its published widths, the
    wkv recurrence under its chunk checkpoints against the per-token
    graph, forward and backward over B = 2, L = 4096."""
    from repro_torch.models import rwkv as rwk

    _free(torch)
    cfg = get_config("rwkv6-7b")
    B, L = 2, 4096
    g = torch.Generator(device="cuda").manual_seed(26)
    base = rwk.init_rwkv_tmix(cfg, torch.bfloat16, "cuda", g)
    base["bonus_u"] = 0.5 * torch.randn(base["bonus_u"].shape, generator=g,
                                        device="cuda")
    x0 = torch.randn(B, L, cfg.d_model, generator=g, device="cuda",
                     dtype=torch.bfloat16)
    st0 = rwk.init_rwkv_state(cfg, B, "cuda")
    st0 = st0._replace(wkv=0.1 * torch.randn(st0.wkv.shape, generator=g,
                                             device="cuda"))
    mix = torch.linspace(-1, 1, cfg.d_model, device="cuda")
    variants = (("chunk-checkpointed", lambda *a: rwk.tmix_forward(
        *a, chunk=64)), ("per-token graph", lambda *a: _tmix_per_token(
            torch, rwk, *a)))
    for _, fn in variants:                   # warm-up: 2 x 256 tokens
        p = {k: v.clone().requires_grad_(True) for k, v in base.items()}
        y, S, _ = fn(p, cfg, x0[:, :256].clone().requires_grad_(True), st0)
        ((y.float() * mix).sum() + S.square().sum()).backward()
    runs = {}
    for label, fn in variants:
        p = {k: v.clone().requires_grad_(True) for k, v in base.items()}
        x = x0.clone().requires_grad_(True)
        st = st0._replace(wkv=st0.wkv.clone().requires_grad_(True))
        _free(torch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, S, _ = fn(p, cfg, x, st)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ((y.float() * mix).sum() + S.square().sum()).backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated() / 2**30
        runs[label] = {"out": (y.detach(), S.detach()),
                       "grads": {"x": x.grad, "wkv": st.wkv.grad,
                                 **{k: v.grad for k, v in p.items()}},
                       "peak": peak, "fwd": (t1 - t0) * 1e3,
                       "bwd": (t2 - t1) * 1e3}
        del p, x, st, y, S
        H, D = base["bonus_u"].shape
        log(f"remat: rwkv6-7b time-mix layer (d_model {cfg.d_model}, {H} "
            f"heads of {D}, bf16), {B} x {L} tokens, {label}: forward "
            f"{runs[label]['fwd']:.1f} ms, backward "
            f"{runs[label]['bwd']:.1f} ms (wall), peak {peak:.2f} GiB "
            f"({smi})")
    got, ref = runs["chunk-checkpointed"], runs["per-token graph"]
    out_same = all(torch.equal(a, b) for a, b in zip(got["out"], ref["out"]))
    diffs, same = {}, []
    for k, e in ref["grads"].items():
        a = got["grads"][k]
        diffs[k] = (a.float() - e.float()).abs().max().item()
        if torch.equal(a, e):
            same.append(k)
    u_rel = diffs["bonus_u"] / max(ref["grads"]["bonus_u"].abs().max().item(),
                                   1e-30)
    worst = max(diffs, key=diffs.get)
    log(f"remat: chunk-checkpointed vs per-token graph: outputs "
        f"{'bitwise equal' if out_same else 'DIFFER'}; gradients bitwise "
        f"equal for {len(same)} of {len(diffs)} leaves; largest gradient "
        f"difference {diffs[worst]:.3e} ({worst}), bonus_u relative "
        f"{u_rel:.3e} (tol 1e-6); peak {got['peak']:.2f} vs "
        f"{ref['peak']:.2f} GiB ({got['peak'] / ref['peak']:.3f}), wall "
        f"{got['fwd'] + got['bwd']:.1f} vs {ref['fwd'] + ref['bwd']:.1f} ms "
        f"({smi})")
    finite = all(torch.isfinite(t).all() for t in got["grads"].values())
    bad = [k for k in diffs if k not in same and k != "bonus_u"]
    if not (out_same and not bad and u_rel <= 1e-6 and finite):
        raise AssertionError(f"remat: checkpointed and per-token differ: "
                             f"{diffs}")
    if not got["peak"] < ref["peak"] / 4:
        raise AssertionError(f"remat: checkpointed peak {got['peak']:.2f} "
                             f"GiB not below a quarter of {ref['peak']:.2f}")
    del runs, got, ref
    _free(torch)


def remat_alone(torch, get_config, smi) -> None:
    """``--only remat``: phase 26, then gemma3-4b's train cell of phase
    25 (its attention's q-block checkpoints)."""
    remat_phase(torch, get_config, smi)
    _family_train_cell(torch, get_config, smi, "gemma3-4b", 8, 2048)


# ---- slice 16: the decode variants as CUDA graphs -------------------------

GRAPH_PROFILE_STEPS = 4
# the dense serve's digest held since PR 14 (phase 5: the same weights,
# traffic and failure in lockstep)
HELD = {"lockstep": "c25b7025481d"}


PREFILL_VARIANTS = ("prefill", "prefill_chunk", "prefill_chunk_paged",
                    "copy_blocks")


def _decode_captures(caps: dict) -> dict:
    """The decode variants' captures (the prefill variants are captured
    once per shape: phase 28 holds them)."""
    return {k: n for k, n in caps.items() if k not in PREFILL_VARIANTS}


def _arm(graphs: bool):
    """One arm's context: CUDA graphs (the default) or
    ``step_graphs.eager()``, the reference's ``jax.disable_jit()``."""
    from repro_torch.serving import step_graphs
    return contextlib.nullcontext() if graphs else step_graphs.eager()


def _memory(torch) -> dict:
    return {"peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "reserved_gib": torch.cuda.max_memory_reserved() / 2**30}


def _paged_traffic(np, cfg, rng):
    """Phase 6's shape of traffic: a warm-up, then 16 requests over two
    shared 256-token prefixes (the last two bare: a COW fork)."""
    from repro_torch.serving import Request, SamplingParams

    warm = Request(WARM_ID, rng.integers(0, cfg.vocab_size, 300, np.int32),
                   SamplingParams(max_new_tokens=2))
    prefixes = [rng.integers(0, cfg.vocab_size, 256, np.int32)
                for _ in range(2)]
    suffixes = [0 if i >= 14 else int(rng.integers(64, 257))
                for i in range(16)]
    return warm, [Request(i, np.concatenate([
        prefixes[i % 2], rng.integers(0, cfg.vocab_size, n)]).astype(
            np.int32), SamplingParams(max_new_tokens=32))
        for i, n in enumerate(suffixes)]


def _graph_engine_arm(torch, cfg, params, ecfg, label, graphs, fail,
                      traffic) -> dict:
    """One engine on ``params``: its traffic served (``_serve``: a
    warm-up, then the measured run, server 1 down at steps 10-20 when
    ``fail``), then a profiled window of full-batch decode steps."""
    import numpy as np

    from repro_torch.serving import ServingEngine, WallClock

    _free(torch)
    with _arm(graphs):
        eng = ServingEngine(cfg, ecfg, params=params, clock=WallClock())
        rng = np.random.default_rng(0)
        warm, reqs = traffic(np, cfg, rng)
        metrics, launches, steps = _serve(torch, eng, warm, reqs, fail=fail)
        _check_completed(label, metrics, reqs, cfg)
        prof = _filled_profile(torch, eng, cfg, rng, label, 8,
                               GRAPH_PROFILE_STEPS, fill=24)
        g = eng.executor.graphs
        out = dict(digest=_digest(reqs), launches=launches,
                   wall_ms=[t * 1e3 for t, _ in steps], prof=prof,
                   captures=[dict(g.captures)],
                   replays=sum(g.replays.values()),
                   miss=int(eng.executor.miss), **_memory(torch))
    del eng
    return out


def _graph_cluster_arm(torch, cfg, params, graphs) -> dict:
    """Phase 10's 4 async clients (one shared tier, depth 2, VirtualClock)
    on ``params``: the 16 requests, server 3 slowed 3x at cluster step
    25, server 1 down at steps 60-100; each wave timed (its sampled
    tokens come to the host inside it), then 24 profiled cluster steps
    over 8 fresh requests."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops
    from repro_torch.serving import Request, SamplingParams, VirtualClock

    _free(torch)
    with _arm(graphs):
        cl = _cluster(cfg, params, 4, VirtualClock, off=DEAD,
                      exec_mode="async", async_depth=2, queue_mode="expert")
        _, make = _cluster_requests(np, cfg)
        reqs = make()
        for r in reqs:
            cl.submit(r)
        walls, waves = [], [0]
        for eng in cl.clients:
            def timed(plan, f=eng._async_decode):
                t0 = time.perf_counter()
                out = f(plan)
                walls.append((time.perf_counter() - t0) * 1e3)
                return out
            eng._async_decode = timed

        def on_step(c):
            nxt = c.step_idx + 1
            if nxt == 25:
                c.set_server_speed(3, 3.0)
            elif nxt == 60:
                c.inject_server_failure(DEAD)
            elif nxt == 100:
                c.recover_server(DEAD)
        ops.reset_launches()
        m = cl.run(on_step=on_step)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if m.completed != 16:
            raise AssertionError(f"graphs (cluster): {m.completed}/16")
        rng = np.random.default_rng(10)
        for i in range(8):
            cl.submit(Request(400 + i, rng.integers(0, cfg.vocab_size, 128)
                              .astype("int32"),
                              SamplingParams(max_new_tokens=32)))
        for _ in range(200):
            if not cl.ingress and all(not c.queue
                                      and not c.scheduler._progress
                                      for c in cl.clients):
                break
            cl.step()
        for eng in cl.clients:
            def counted(plan, f=eng._async_decode):
                waves[0] += 1
                return f(plan)
            eng._async_decode = counted
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(24):
                cl.step()
            torch.cuda.synchronize()
            window = (time.perf_counter() - t0) * 1e3
        cl.run()
        rows = [(e.key, e.count, e.self_device_time_total)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        host = sum(e.count for e in prof.key_averages()
                   if e.device_type != DeviceType.CUDA
                   and e.key in HOST_CALLS)
        n = max(waves[0], 1)
        busy = sum(t for _, _, t in rows) / 1e3
        out = dict(digest=_digest(reqs), launches=launches, wall_ms=walls,
                   captures=[dict(c.executor.graphs.captures)
                             for c in cl.clients],
                   replays=sum(sum(c.executor.graphs.replays.values())
                               for c in cl.clients),
                   prof=None if not rows else {
                       "plain_ms": window / n, "busy_ms": busy / n,
                       "host_launches": host / n,
                       "launches": sum(k for key, k, _ in rows
                                       if not key.startswith(
                                           ("Memcpy", "Memset"))) / n,
                       "waves": waves[0]},
                   miss=int(sum(int(c.executor.miss) for c in cl.clients)),
                   **_memory(torch))
    del cl
    return out


def _graph_control_arm(torch, cfg, graphs) -> dict:
    """2 lockstep clients on their own seeded weights under a Zipf(1.2)
    router skew, the 16 requests (VirtualClock: which client steps next
    must not hang on the host's speed, or the events below would land at
    other points of each client's run): server 1 down at cluster step
    24 and up at 28, client 0 masking server 2 at 32-36, a page-out of 4
    replicated experts at 40, new skew values at 44, a one-shot
    rebalance's migration at 48, ``scale_to(2)`` at 52; then a profiled
    window on client 0 (2 servers)."""
    import numpy as np

    from repro_torch.kernels import ops
    from repro_torch.serving import (Cluster, ClusterConfig, EngineConfig,
                                     VirtualClock, zipf_bias)

    _free(torch)
    with _arm(graphs):
        cl = Cluster(cfg, ClusterConfig(clients=2, engine=EngineConfig(
            **CLUSTER)), seed=0, clock_factory=VirtualClock)
        E = cfg.moe.num_experts
        cl.set_skew(zipf_bias(E, 1.2, scale=1.0))
        _, make = _cluster_requests(np, cfg)
        reqs = make()
        for r in reqs:
            cl.submit(r)
        steps = _time_decodes(cl)
        seen = {}

        def on_step(c):
            nxt = c.step_idx + 1
            if nxt == 24:
                c.inject_server_failure(DEAD)
            elif nxt == 28:
                c.recover_server(DEAD)
            elif nxt == 32:
                c.clients[0].pool.mask_server(2)
            elif nxt == 36:
                c.clients[0].pool.unmask_server(2)
            elif nxt == 40:
                red = c.pool.redundant_table
                seen["paged"] = c.page_out_experts(
                    sorted({int(e) for e in red[red >= 0]})[:4])
            elif nxt == 44:
                c.set_skew(zipf_bias(E, 1.2, scale=2.0))
            elif nxt == 48:
                c.rebalance()
                seen["migrated"] = c.metrics.migrated_experts
            elif nxt == 52:
                seen["before"] = [dict(e.executor.graphs.captures)
                                  for e in c.clients]
                c.scale_to(2)
        ops.reset_launches()
        m = cl.run(on_step=on_step)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if m.completed != 16 or "before" not in seen:
            raise AssertionError(f"graphs (control): {m.completed}/16, "
                                 f"events {seen}")
        prof = _filled_profile(torch, cl.clients[0], cfg,
                               np.random.default_rng(5), "graphs (control)",
                               8, GRAPH_PROFILE_STEPS)
        out = dict(digest=_digest(reqs), launches=launches,
                   wall_ms=[t * 1e3 for t, _ in steps], prof=prof,
                   captures=[dict(e.executor.graphs.captures)
                             for e in cl.clients],
                   before=seen["before"], paged=seen.get("paged"),
                   migrated=seen.get("migrated"),
                   replays=sum(sum(e.executor.graphs.replays.values())
                               for e in cl.clients),
                   miss=int(sum(int(e.executor.miss) for e in cl.clients)),
                   **_memory(torch))
    del cl
    return out


def _graph_report(label, arm, r, smi) -> None:
    p = r["prof"]
    prof = "the profiler saw no device time (not measured)" if p is None \
        else (f"{p['plain_ms']:.2f} ms a step in the profiled window, "
              f"device busy {p['busy_ms']:.3f} ms, idle share "
              f"{max(0.0, 1 - p['busy_ms'] / p['plain_ms']):.3f}, host "
              f"calls that enqueue work {p['host_launches']:.1f} a step "
              f"{json.dumps(p.get('host_calls', {}))}, device kernels "
              f"{p['launches']:.1f} a step")
    log(f"graphs ({label}, {arm}): tokens sha1 {r['digest']}; decode step "
        f"wall p50 {_pct(r['wall_ms'], 50):.3f} ms p99 "
        f"{_pct(r['wall_ms'], 99):.3f} ms over {len(r['wall_ms'])} steps; "
        f"{prof}; captures {r['captures']}, replays {r['replays']}; miss "
        f"{r['miss']}; peak memory {r['peak_gib']:.2f} GiB allocated, "
        f"{r['reserved_gib']:.2f} GiB reserved; launches "
        f"{json.dumps(r['launches'])} ({smi})")


def graphs_phase(torch, get_config, smi) -> dict:
    """Phase 27: the decode variants as CUDA graphs against
    ``step_graphs.eager()`` at full width, each scenario graphs then eager
    in this call: the dense serve (its traffic through server 1's
    failure) in each of the three decode modes, the paged serve, the
    4-client async cluster, and two clients through failure, masking,
    page-out, skew changes, a rebalance and ``scale_to``.  Tokens and
    kernel launches must be equal; a graph arm captures each decode
    variant once per executor (the last scenario once more after
    ``scale_to``; the prefill variants once per shape, phase 28), an
    eager arm never.  Returns the graph arms'
    launches by scenario."""
    from repro_torch.serving import EngineConfig, ServingEngine, WallClock

    base = get_config("deepseek-r1")
    cfg = base.replace(num_layers=3,
                       moe=dataclasses.replace(base.moe, first_k_dense=1))
    _free(torch)
    params = ServingEngine(cfg, EngineConfig(**CLUSTER), seed=0,
                           clock=WallClock()).params
    def dense(np, cfg, rng):
        warm, _, reqs = _dense_requests(np, cfg, rng)
        return warm, reqs
    scenarios = [(mode, "decode", dict(CLUSTER, decode_mode=mode), True,
                  dense) for mode in ("lockstep", "pipelined",
                                      "serialized")]
    scenarios.append(("paged serve", "decode_paged", dict(
        CLUSTER, kv_mode="paged", kv_block_size=16, kv_num_blocks=129,
        prefill_chunk=256, policy="fair"), False, _paged_traffic))
    runs, bad, took = {}, [], {}
    for label, variant, ekw, fail, traffic in scenarios:
        t0 = time.perf_counter()
        for graphs in (True, False):
            runs[label, graphs] = _graph_engine_arm(
                torch, cfg, params, EngineConfig(**ekw), label, graphs, fail,
                traffic)
        took[label] = time.perf_counter() - t0
        caps = runs[label, True]["captures"]
        if [_decode_captures(c) for c in caps] != [{variant: 1}]:
            bad.append(f"{label}: captures {caps}")
    t0 = time.perf_counter()
    for graphs in (True, False):
        runs["cluster", graphs] = _graph_cluster_arm(torch, cfg, params,
                                                     graphs)
    took["cluster"] = time.perf_counter() - t0
    if [_decode_captures(c) for c in runs["cluster", True]["captures"]] \
            != [{"decode_masked": 1}] * 4:
        bad.append(f"cluster: captures {runs['cluster', True]['captures']}")
    del params
    t0 = time.perf_counter()
    for graphs in (True, False):
        runs["control", graphs] = _graph_control_arm(torch, cfg, graphs)
    took["control"] = time.perf_counter() - t0
    ctl = runs["control", True]
    if [_decode_captures(c) for c in ctl["before"]] != [{"decode": 1}] * 2 \
            or [_decode_captures(c) for c in ctl["captures"]] \
            != [{"decode": 2}] * 2:
        bad.append(f"control: captures {ctl['before']} -> "
                   f"{ctl['captures']}")
    if not ctl["paged"] or not ctl["migrated"]:
        bad.append(f"control: paged {ctl['paged']}, migrated "
                   f"{ctl['migrated']}")
    labels = [s[0] for s in scenarios] + ["cluster", "control"]
    for label in labels:
        g, e = runs[label, True], runs[label, False]
        for arm, r in (("graphs", g), ("eager", e)):
            _graph_report(label, arm, r, smi)
        held = HELD.get(label)
        log(f"graphs ({label}): tokens equal {g['digest'] == e['digest']}"
            + (f", held digest {held} {g['digest'] == held}" if held else "")
            + f"; launches equal {g['launches'] == e['launches']}; decode "
            f"step wall p50 {_pct(g['wall_ms'], 50):.3f} ms against "
            f"{_pct(e['wall_ms'], 50):.3f} eager; peak "
            f"{g['peak_gib']:.2f} / {e['peak_gib']:.2f} GiB allocated, "
            f"{g['reserved_gib']:.2f} / {e['reserved_gib']:.2f} reserved; "
            f"both arms {took[label]:.1f} s")
        if g["digest"] != e["digest"] or g["launches"] != e["launches"]:
            bad.append(f"{label}: graphs and eager differ")
        if any(c for c in e["captures"]) or e["replays"] or not g["replays"]:
            bad.append(f"{label}: eager captured or graphs never replayed")
        zero = [k for k in ("grouped_gemm", "combine_slots")
                if g["launches"][k] <= 0]
        if zero:
            bad.append(f"{label}: never launched {zero}")
    c = runs["cluster", True], runs["cluster", False]
    log(f"graphs (cluster): graph pools a client "
        f"{(c[0]['reserved_gib'] - c[1]['reserved_gib']) / 4:.3f} GiB "
        f"reserved ({c[0]['reserved_gib']:.2f} against "
        f"{c[1]['reserved_gib']:.2f} GiB for 4 clients), "
        f"{(c[0]['peak_gib'] - c[1]['peak_gib']) / 4:.3f} GiB allocated")
    if bad:
        raise AssertionError(f"graphs: {bad}")
    return {label: runs[label, True]["launches"] for label in labels}


# ---- phase 28: the prefill variants as CUDA graphs, one per shape --------

PREFILL_CHUNK = 256


def _chunked_traffic(np, cfg, rng):
    """A 300-token warm-up, then 16 prompts of 256-768 tokens and 32
    greedy tokens: with 256-token chunks, full chunks repeat."""
    from repro_torch.serving import Request, SamplingParams

    warm = Request(WARM_ID, rng.integers(0, cfg.vocab_size, 300, np.int32),
                   SamplingParams(max_new_tokens=2))
    return warm, [Request(i, rng.integers(0, cfg.vocab_size,
                                          int(rng.integers(256, 769)),
                                          np.int32),
                          SamplingParams(max_new_tokens=32))
                  for i in range(16)]


def _new_lengths_traffic(np, cfg, rng):
    """The dense serve's traffic: 8 whole prompts of new lengths."""
    warm, _, reqs = _dense_requests(np, cfg, rng)
    return warm, reqs


def _watch_prefill(torch, eng) -> dict:
    """Count each prefill variant's calls by shape, time each call alone
    (synchronized), and record the reserved and allocated memory each
    capture adds."""
    import collections

    ex, g = eng.executor, eng.executor.graphs
    seen = {"calls": collections.Counter(), "ms": collections.defaultdict(
        list), "pool": []}

    def watch(name, size):
        real = getattr(ex, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            shape = (name, size(*a))
            if shape[1]:                     # no copy pairs: nothing ran
                seen["calls"][shape] += 1
                seen["ms"][shape].append((time.perf_counter() - t0) * 1e3)
            return out
        setattr(ex, name, timed)
    watch("prefill", lambda slot, prompt: len(prompt))
    watch("prefill_chunk", lambda slot, chunk, *a: len(chunk))
    watch("prefill_chunk_paged", lambda chunk, *a: len(chunk))
    watch("copy_blocks", lambda pairs: len(pairs))
    capture = g._capture

    def counted(v, fn):
        r, a = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
        capture(v, fn)
        seen["pool"].append(((torch.cuda.memory_reserved() - r) / 2**30,
                             (torch.cuda.memory_allocated() - a) / 2**30))
    g._capture = counted
    return seen


def _chunk_profile(torch, ex, cfg, rng, prompts: int = 2) -> dict:
    """A repeated 256-token chunk: ``prompts`` 1024-token prompts in 4
    chunks each into slot 0, each chunk timed alone (synchronized); then
    as many under torch.profiler, back to back: device busy, host calls
    that enqueue work (``HOST_CALLS``) and the window, per chunk."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run(timed):
        walls = []
        for _ in range(prompts):
            p = rng.integers(0, cfg.vocab_size, 4 * PREFILL_CHUNK)
            for lo in range(0, 4 * PREFILL_CHUNK, PREFILL_CHUNK):
                if timed:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                ex.prefill_chunk(0, p[lo:lo + PREFILL_CHUNK], lo,
                                 is_first=lo == 0,
                                 is_last=lo == 3 * PREFILL_CHUNK)
                if timed:
                    torch.cuda.synchronize()
                    walls.append((time.perf_counter() - t0) * 1e3)
        return walls
    walls = run(True)
    n = 4 * prompts
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(False)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3 / n
    avg = prof.key_averages()
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA) / 1e3 / n
    host = {e.key: e.count / n for e in avg
            if e.device_type != DeviceType.CUDA and e.key in HOST_CALLS}
    return {"wall_ms": walls, "window_ms": window, "busy_ms": busy,
            "host_calls": host, "host_launches": sum(host.values())}


def _prefill_arm(torch, cfg, params, ecfg, label, graphs, traffic,
                 profile_chunks) -> dict:
    """One engine on ``params``: its traffic served (``_serve``, no
    failure) with every prefill call counted by shape and timed; then,
    with ``profile_chunks``, the repeated chunk profiled."""
    import numpy as np

    from repro_torch.serving import ServingEngine, WallClock

    _free(torch)
    with _arm(graphs):
        eng = ServingEngine(cfg, ecfg, params=params, clock=WallClock())
        rng = np.random.default_rng(0)
        warm, reqs = traffic(np, cfg, rng)
        seen = _watch_prefill(torch, eng)
        metrics, launches, _ = _serve(torch, eng, warm, reqs, fail=False)
        _check_completed(label, metrics, reqs, cfg)
        g = eng.executor.graphs
        out = dict(digest=_digest(reqs), launches=launches,
                   ttft=metrics.summary()["ttft"],
                   dropped=int(eng.executor.dropped),
                   miss=int(eng.executor.miss), calls=dict(seen["calls"]),
                   ms=dict(seen["ms"]), pool=list(seen["pool"]),
                   per_shape={k: list(v) for k, v in g.per_shape.items()},
                   keys={k: [s for _, s in v] for k, v in g.keys.items()},
                   captures=dict(g.captures), replays=dict(g.replays),
                   kv=metrics.summary().get("kv"))
        if profile_chunks:
            for name in PREFILL_VARIANTS:      # the class's methods again
                eng.executor.__dict__.pop(name, None)
            out["chunk"] = _chunk_profile(torch, eng.executor, cfg, rng)
        out.update(_memory(torch))
    del eng
    return out


def _prefill_checks(label, g, e) -> list:
    """What phase 28 requires of one scenario's arms."""
    bad = []
    for k in ("digest", "launches", "dropped", "miss"):
        if g[k] != e[k]:
            bad.append(f"{label}: {k} differ ({g[k]} / {e[k]})")
    if g["calls"] != e["calls"]:
        bad.append(f"{label}: prefill calls differ")
    if any(e["captures"].values()) or any(e["replays"].values()):
        bad.append(f"{label}: the eager arm captured or replayed")
    for (name, size), n in g["calls"].items():
        want = [1, n - 1] if n >= 2 else None
        got = g["per_shape"].get((name, (size,)))
        if got != want:
            bad.append(f"{label}: {name} at {size}, seen {n} times: "
                       f"[captures, replays] {got}, expected {want}")
    for name in PREFILL_VARIANTS:
        sizes = [s for (v, s) in g["calls"] if v == name]
        if sorted(g["keys"].get(name, [])) != sorted((s,) for s in sizes):
            bad.append(f"{label}: {name} keys {g['keys'].get(name)} for "
                       f"shapes {sizes}")
    return bad


def _prefill_report(label, arm, r, smi) -> None:
    shapes = {f"{name}:{size}": (n, _pct(r["ms"][name, size], 50))
              for (name, size), n in sorted(r["calls"].items())}
    repeated = {k: f"{n} calls, p50 {ms:.3f} ms" for k, (n, ms)
                in shapes.items() if n >= 3}
    once = [ms for (name, size), n in r["calls"].items() if n == 1
            for ms in r["ms"][name, size]]
    log(f"prefill ({label}, {arm}): tokens sha1 {r['digest']}; TTFT p50 "
        f"{r['ttft']['p50']} ms p99 {r['ttft']['p99']} ms; {len(shapes)} "
        f"shapes, repeated: {json.dumps(repeated)}; {len(once)} calls of "
        f"a shape seen once, {sum(once):.3f} ms in all; captures "
        f"{r['captures']}, replays {r['replays']}; dropped {r['dropped']} "
        f"miss {r['miss']}; peak memory {r['peak_gib']:.2f} GiB allocated, "
        f"{r['reserved_gib']:.2f} GiB reserved; launches "
        f"{json.dumps(r['launches'])} ({smi})")
    c = r.get("chunk")
    if c is not None:
        log(f"prefill ({label}, {arm}): a repeated {PREFILL_CHUNK}-token "
            f"chunk (slot 0, 1024-token prompts, 4 chunks each): wall p50 "
            f"{_pct(c['wall_ms'], 50):.3f} ms over {len(c['wall_ms'])} "
            f"(synchronized); profiled back to back {c['window_ms']:.3f} "
            f"ms a chunk, device busy {c['busy_ms']:.3f} ms, idle share "
            f"{max(0.0, 1 - c['busy_ms'] / c['window_ms']):.3f}, host "
            f"calls that enqueue work {c['host_launches']:.1f} a chunk "
            f"{json.dumps(c['host_calls'])} ({smi})")
    if r["pool"]:
        res = [round(x, 4) for x, _ in r["pool"]]
        log(f"prefill ({label}, {arm}): graph pool: {len(res)} captures "
            f"added {sum(res):.3f} GiB reserved (per capture, in order "
            f"{res}), {sum(a for _, a in r['pool']):.3f} GiB allocated "
            f"({smi})")


def prefill_phase(torch, get_config, smi) -> dict:
    """Phase 28: the decoder family's prefill variants as CUDA graphs, one
    per shape, against ``step_graphs.eager()`` at full width on one set of
    weights, each scenario an unreported eager pass, then graphs, then
    eager: 16 chunked prompts (dense, 256-token chunks), the paged serve's
    shared-prefix traffic, the dense serve's eight whole prompts of new
    lengths.  Returns the graph arms' launches by scenario."""
    from repro_torch.serving import EngineConfig, ServingEngine, WallClock

    base = get_config("deepseek-r1")
    cfg = base.replace(num_layers=3,
                       moe=dataclasses.replace(base.moe, first_k_dense=1))
    _free(torch)
    params = ServingEngine(cfg, EngineConfig(**CLUSTER), seed=0,
                           clock=WallClock()).params
    scenarios = [
        ("chunked", dict(CLUSTER, prefill_chunk=PREFILL_CHUNK),
         _chunked_traffic, True),
        ("paged", dict(CLUSTER, kv_mode="paged", kv_block_size=16,
                       kv_num_blocks=129, prefill_chunk=PREFILL_CHUNK,
                       policy="fair"), _paged_traffic, False),
        ("new lengths", dict(CLUSTER), _new_lengths_traffic, False)]
    runs, bad = {}, []
    for label, ekw, traffic, prof in scenarios:
        t0 = time.perf_counter()
        # an unreported eager pass first: whichever arm meets a new shape
        # first pays cuBLAS's setup for it (a prompt's first sight took
        # ~1.5x as long in the first arm of the same traffic)
        _prefill_arm(torch, cfg, params, EngineConfig(**ekw), label, False,
                     traffic, False)
        for graphs in (True, False):
            runs[label, graphs] = _prefill_arm(
                torch, cfg, params, EngineConfig(**ekw), label, graphs,
                traffic, prof)
        took = time.perf_counter() - t0
        g, e = runs[label, True], runs[label, False]
        for arm, r in (("graphs", g), ("eager", e)):
            _prefill_report(label, arm, r, smi)
        bad += _prefill_checks(label, g, e)
        log(f"prefill ({label}): tokens equal {g['digest'] == e['digest']}, "
            f"launches equal {g['launches'] == e['launches']}; TTFT p50 "
            f"{g['ttft']['p50']} against {e['ttft']['p50']} ms eager, p99 "
            f"{g['ttft']['p99']} against {e['ttft']['p99']}; peak "
            f"{g['peak_gib']:.2f} / {e['peak_gib']:.2f} GiB allocated, "
            f"{g['reserved_gib']:.2f} / {e['reserved_gib']:.2f} reserved; "
            f"three arms {took:.1f} s ({smi})")
        zero = [k for k in ("grouped_gemm", "combine_slots")
                if g["launches"][k] <= 0]
        if zero:
            bad.append(f"{label}: never launched {zero}")
    g = runs["chunked", True]
    if g["chunk"]["host_launches"] >= runs["chunked", False]["chunk"][
            "host_launches"]:
        bad.append("chunked: graphs enqueue no fewer host calls a chunk")
    if not runs["paged", True]["kv"]["prefix_hit_blocks"]:
        bad.append("paged: no prefix hit")
    del params
    if bad:
        raise AssertionError(f"prefill: {bad}")
    return {label: runs[label, True]["launches"] for label, *_ in scenarios}


# ---- phase 29: every family's prefill compiled ---------------------------

# label, arch, engine config, prompt lengths (repeated lengths: a first
# sight, a capture, then replays for the per-shape families; one length
# seen once), the length profiled, the scan the family replays
FAMILY_PREFILL = (
    # above the 1024-token window (the rings keep its tail) and at 2048, a
    # multiple of the 16 q blocks (the q-block attention path)
    ("gemma3", "gemma3-4b", dict(max_batch=4, max_seq=2560),
     (600, 1300, 2048) * 3 + (777,), 1300, None),
    ("whisper", "whisper-base", dict(max_batch=4, max_seq=448),
     (24, 48) * 4 + (37,), 48, None),
    # 1021 is prime: the SSD chunk falls to Q = 1 (1021 chunks a layer,
    # 15 x 64 + 61 steps of the scan); 512 runs Q = 64 (8 chunks).  The
    # profiled lengths keep an eager prompt's ~10^4 launches (each held by
    # the profiler, seconds to tally) few: 131 is prime (2 x 64 + 3
    # steps), 130 is 2 x 64 + 2
    ("zamba2", "zamba2-2.7b", dict(max_batch=4, max_seq=2048),
     (1021, 512, 1021, 512), 131, "ssd_carry"),
    # 509 is prime, 200 and 320 no multiple of 64, 64 a single body
    ("rwkv6", "rwkv6-7b", dict(max_batch=4, max_seq=1024),
     (64, 509, 200, 320, 509, 200), 130, "wkv"),
)
SCAN_LENGTHS = (1, 63, 64, 65, 1021)


def _prompt_profile(torch, ex, cfg, rng, n: int, reps: int = 2) -> dict:
    """``reps`` whole prompts of ``n`` tokens into slot 0, back to back
    under torch.profiler: the window, device busy and host calls that
    enqueue work (``HOST_CALLS``), per prompt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts = [rng.integers(0, cfg.vocab_size, n) for _ in range(reps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            ex.prefill(0, p)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3 / reps
    avg = prof.key_averages()
    busy = sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA) / 1e3 / reps
    host = {e.key: e.count / reps for e in avg
            if e.device_type != DeviceType.CUDA and e.key in HOST_CALLS}
    return {"n": n, "window_ms": window, "busy_ms": busy,
            "host_calls": host, "host_launches": sum(host.values())}


def _family_prefill_arm(torch, cfg, params, ecfg, label, graphs, lengths,
                        profiled, reps, measured=True) -> dict:
    """One engine on ``params``: a warm-up, then one request per length
    of ``lengths`` (32 greedy tokens each), every prefill call counted by
    length and timed alone (``_watch_prefill``, which also records the
    memory each step-graph capture adds); then ``reps`` prompts of
    ``profiled`` tokens profiled (not ``measured``: one, unprofiled).
    The scans' captures, replays and pool growth are read from
    ``common.SCAN_STATS`` (reset by the caller, once a family)."""
    import numpy as np

    from repro_torch.models import common
    from repro_torch.serving import (Request, SamplingParams, ServingEngine,
                                     WallClock)

    _free(torch)
    with _arm(graphs):
        eng = ServingEngine(cfg, ecfg, params=params, clock=WallClock())
        rng = np.random.default_rng(0)
        warm = Request(WARM_ID, rng.integers(0, cfg.vocab_size, 16, np.int32),
                       SamplingParams(max_new_tokens=2))
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, n, np.int32),
                        SamplingParams(max_new_tokens=32))
                for i, n in enumerate(lengths)]
        seen = _watch_prefill(torch, eng)
        metrics, launches, _ = _serve(torch, eng, warm, reqs, fail=False)
        _check_completed(label, metrics, reqs, cfg)
        g = eng.executor.graphs
        out = dict(digest=_digest(reqs), launches=launches,
                   ttft=metrics.summary()["ttft"],
                   dropped=int(eng.executor.dropped),
                   miss=int(eng.executor.miss), calls=dict(seen["calls"]),
                   ms=dict(seen["ms"]), pool=list(seen["pool"]),
                   per_shape={k: list(v) for k, v in g.per_shape.items()},
                   keys={k: [s for _, s in v] for k, v in g.keys.items()},
                   captures=dict(g.captures), replays=dict(g.replays))
        eng.executor.__dict__.pop("prefill", None)   # the class's method
        if measured:
            out["prof"] = _prompt_profile(torch, eng.executor, cfg, rng,
                                          profiled, reps)
        else:
            eng.executor.prefill(0, rng.integers(0, cfg.vocab_size,
                                                 profiled))
        out["scans"] = {k: dict(v, pool_bytes=list(v["pool_bytes"]))
                        for k, v in common.SCAN_STATS.items()}
        out.update(_memory(torch))
    del eng
    return out


def _family_prefill_checks(label, g, e, scan) -> list:
    """What phase 29 requires of one family's arms."""
    bad = []
    for k in ("digest", "launches", "dropped", "miss", "calls"):
        if g[k] != e[k]:
            bad.append(f"{label}: {k} differ ({g[k]} / {e[k]})")
    if e["captures"] or e["replays"] or e["scans"] != g["scans"]:
        bad.append(f"{label}: the eager arm captured or replayed")
    if scan is None:
        for (name, size), n in g["calls"].items():
            want = [1, n - 1] if n >= 2 else None
            if g["per_shape"].get((name, (size,))) != want:
                bad.append(f"{label}: prefill at {size}, seen {n} times: "
                           f"{g['per_shape'].get((name, (size,)))}, "
                           f"expected {want}")
        if sorted(g["keys"].get("prefill", [])) != sorted(
                (s,) for _, s in g["calls"]):
            bad.append(f"{label}: prefill keys {g['keys'].get('prefill')}")
        if g["scans"]:
            bad.append(f"{label}: scans replayed {g['scans']}")
    else:
        if any(name == "prefill" for name, _ in g["per_shape"]) \
                or "prefill" in g["keys"]:
            bad.append(f"{label}: the recurrent prefill became a step "
                       f"graph {g['keys']}")
        if list(g["scans"]) != [scan] or g["scans"][scan]["captures"] != 2:
            bad.append(f"{label}: scan captures {g['scans']} (expected 2 "
                       f"of {scan})")
    return bad


def _family_prefill_report(label, arm, r, smi) -> None:
    by_len = {}
    for (_, n), ms in sorted(r["ms"].items(), key=lambda kv: kv[0][1]):
        # in order: a per-shape family's first sight, capture, replays
        by_len[n] = (f"{[round(x, 1) for x in ms]} ms, p50 "
                     f"{_pct(ms, 50) / n:.3f} ms/token")
    p = r["prof"]
    log(f"family-prefill ({label}, {arm}): tokens sha1 {r['digest']}; TTFT "
        f"p50 {r['ttft']['p50']} ms p99 {r['ttft']['p99']} ms; prefill by "
        f"prompt length (synchronized) {json.dumps(by_len)}; step-graph "
        f"captures {r['captures']}, replays {r['replays']}; scans "
        f"{json.dumps(r['scans'])}; dropped {r['dropped']} miss {r['miss']}"
        f"; peak {r['peak_gib']:.2f} GiB allocated, {r['reserved_gib']:.2f} "
        f"reserved ({smi})")
    log(f"family-prefill ({label}, {arm}): {p['n']}-token prompts back to "
        f"back, profiled: {p['window_ms']:.3f} ms a prompt, device busy "
        f"{p['busy_ms']:.3f} ms, idle share "
        f"{max(0.0, 1 - p['busy_ms'] / p['window_ms']):.3f}, host calls that "
        f"enqueue work {p['host_launches']:.1f} a prompt "
        f"{json.dumps(p['host_calls'])} ({smi})")
    if r["pool"]:
        res = [round(x, 4) for x, _ in r["pool"]]
        log(f"family-prefill ({label}, {arm}): prefill graph pool: "
            f"{len(res)} captures added {sum(res):.3f} GiB reserved (in "
            f"order {res}), {sum(a for _, a in r['pool']):.3f} GiB "
            f"allocated ({smi})")


def _scan_checks(torch, label, cfg, smi) -> list:
    """One layer's recurrence at the family's published widths (B = 1, as
    the engine prefills): rwkv6's ``tmix_forward`` (bf16 activations,
    fp32 state) or zamba2's ``_ssd_chunked`` (fp32), its scan replayed
    against the same call under ``eager()`` at every length of
    ``SCAN_LENGTHS``, bitwise; each timed alone (synchronized) in both."""
    from repro_torch.models import mamba, rwkv
    from repro_torch.serving import step_graphs

    g = torch.Generator(device="cuda").manual_seed(29)
    bad, times = [], {}
    if label == "rwkv6":
        tp = rwkv.init_rwkv_tmix(cfg, torch.bfloat16, "cuda", g)
        tp["bonus_u"].normal_(generator=g)
        st = rwkv.init_rwkv_state(cfg, 1, "cuda")
        st.wkv.normal_(generator=g).mul_(0.2)
    for L in SCAN_LENGTHS:
        if label == "rwkv6":
            x = (torch.randn(1, L, cfg.d_model, generator=g, device="cuda")
                 * 0.5).bfloat16()

            def call():
                return rwkv.tmix_forward(tp, cfg, x, st)
        else:
            _, H, P, N = mamba.dims(cfg)
            args = (torch.randn(1, L, H, P, generator=g, device="cuda")
                    * 0.3,
                    -torch.rand(1, L, H, generator=g, device="cuda") * 0.3,
                    torch.randn(1, L, N, generator=g, device="cuda") * 0.5,
                    torch.randn(1, L, N, generator=g, device="cuda") * 0.5,
                    torch.randn(1, H, P, N, generator=g, device="cuda")
                    * 0.3)

            def call():
                return mamba._ssd_chunked(*args, chunk=64)
        arms = {}
        for arm in ("graphs", "eager"):
            with torch.inference_mode(), _arm(arm == "graphs"):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                arms[arm] = call()
                torch.cuda.synchronize()
                times.setdefault(arm, {})[L] = round(
                    (time.perf_counter() - t0) * 1e3, 3)
        if not all(torch.equal(a, b) for a, b in zip(arms["graphs"],
                                                     arms["eager"])):
            bad.append(f"{label}: the scan at L = {L} differs from eager")
    what = "tmix_forward" if label == "rwkv6" else "_ssd_chunked"
    log(f"family-prefill ({label}): {what} at full width, scan replayed vs "
        f"eager() bitwise at L = {list(SCAN_LENGTHS)}: {not bad}; ms by L "
        f"(synchronized) graphs {json.dumps(times['graphs'])}, eager "
        f"{json.dumps(times['eager'])} ({smi})")
    return bad


def family_prefill_phase(torch, get_config, smi) -> dict:
    """Phase 29: every family's prefill compiled as the reference compiles
    it, against ``step_graphs.eager()``: gemma3-4b, whisper-base,
    zamba2-2.7b and rwkv6-7b at their full published widths and depth
    through the dense engine, on one set of weights a family (seed 0, as
    phases 19-22 draw them: drawing takes ~0.1 s, holding them through
    phases 23-28 would take their memory), each family an unreported eager
    pass, then graphs, then eager.  gemma3's and whisper's prefill is one
    CUDA graph per prompt length; zamba2's and rwkv6's runs eagerly
    around their scan's two bodies, captured once and replayed
    (``models/common.py::compiled_scan``).  Tokens, launches, dropped and
    miss equal; one step-graph capture per length seen twice or more
    (gemma3, whisper), exactly 2 scan captures for the whole family
    (zamba2, rwkv6, the direct checks included); then one layer's scan at
    full width bitwise ``eager()`` at ``SCAN_LENGTHS``.  Returns the graph
    arms' launches by family."""
    from repro_torch.models import common
    from repro_torch.serving import EngineConfig, ServingEngine, WallClock

    runs, bad = {}, []
    for label, arch, ekw, lengths, profiled, scan in FAMILY_PREFILL:
        t0 = time.perf_counter()
        # an eager recurrent prompt is ~10^4 launches: one under the
        # profiler
        reps = 2 if scan is None else 1
        cfg = get_config(arch)
        _free(torch)
        params = ServingEngine(cfg, EngineConfig(**ekw), seed=0,
                               clock=WallClock()).params
        common.reset_scans()
        # an unreported eager pass first: whichever arm meets a prompt
        # length first pays cuBLAS's setup for it
        _family_prefill_arm(torch, cfg, params, EngineConfig(**ekw), label,
                            False, lengths, profiled, reps, measured=False)
        took = []
        for graphs in (True, False):
            t1 = time.perf_counter()
            runs[label, graphs] = _family_prefill_arm(
                torch, cfg, params, EngineConfig(**ekw), label, graphs,
                lengths, profiled, reps)
            took.append(round(time.perf_counter() - t1, 1))
        g, e = runs[label, True], runs[label, False]
        for arm, r in (("graphs", g), ("eager", e)):
            _family_prefill_report(label, arm, r, smi)
        bad += _family_prefill_checks(label, g, e, scan)
        if scan is not None:
            bad += _scan_checks(torch, label, cfg, smi)
            stats = common.SCAN_STATS.get(scan, {})
            if stats.get("captures") != 2:
                bad.append(f"{label}: {stats} scan captures in the phase "
                           f"(expected 2)")
            pool = [round(b / 2**20, 2) for b in stats.get("pool_bytes", [])]
            log(f"family-prefill ({label}): scan {scan}: "
                f"{stats.get('captures')} captures, {stats.get('replays')} "
                f"replays over the phase; reserved MiB each capture added "
                f"{pool} ({smi})")
        gp, ep = g["prof"], e["prof"]
        log(f"family-prefill ({label}): tokens equal "
            f"{g['digest'] == e['digest']}, launches equal "
            f"{g['launches'] == e['launches']}; TTFT p50 {g['ttft']['p50']} "
            f"against {e['ttft']['p50']} ms eager, p99 {g['ttft']['p99']} "
            f"against {e['ttft']['p99']}; a {gp['n']}-token prompt "
            f"{gp['window_ms']:.3f} / {ep['window_ms']:.3f} ms, busy "
            f"{gp['busy_ms']:.3f} / {ep['busy_ms']:.3f}, host calls "
            f"{gp['host_launches']:.1f} / {ep['host_launches']:.1f}; three "
            f"arms and checks {time.perf_counter() - t0:.1f} s (graphs / "
            f"eager arm {took[0]} / {took[1]} s) ({smi})")
        del params
        common.reset_scans()
    if bad:
        raise AssertionError(f"family-prefill: {bad}")
    return {label: runs[label, True]["launches"]
            for label, *_ in FAMILY_PREFILL}


# ---------------------------------------------------------------- examples

# the tours run in the pool of spawned processes, longest first
POOL_TOURS = ("scenario_cluster_failover", "scenario_overlap_ablation",
              "scenario_autoscale", "scenario_prefix_cache",
              "scenario_expert_balance", "train_small",
              "disaggregated_serving")
TOUR_WORKERS = 6
SERVE_MOE_ARGV = ["--requests", "16", "--clients", "4",
                  "--frontend-policy", "least_loaded", "--fail-client", "1",
                  "--kv-mode", "paged", "--kv-blocks", "14"]


def _watch_tour(mod) -> dict:
    """Wrap the tour module's engine, cluster, scenario and train-step
    builders so that what the tour makes can be read after it ran."""
    made = {"engines": [], "runs": [], "steps": []}

    def wrap(name, keep):
        if not hasattr(mod, name):
            return
        real = getattr(mod, name)

        def make(*a, **kw):
            obj = real(*a, **kw)
            keep(obj)
            return obj
        setattr(mod, name, make)

    wrap("ServingEngine", made["engines"].append)
    wrap("Cluster", made["engines"].append)
    wrap("compile_train_step", made["steps"].append)
    wrap("compile_fn", made["steps"].append)
    if hasattr(mod, "Scenario"):
        real_run = mod.Scenario.run

        class Watched(mod.Scenario):
            def run(self, *a, **kw):
                res = real_run(self, *a, **kw)
                made["runs"].append(res)
                return res
        mod.Scenario = Watched
    return made


def _graph_counts(made: dict) -> tuple:
    """(captures, replays) over every graph the tour made: each engine's
    (a cluster's clients') step graphs, the train step, quickstart's two
    programs."""
    caps = reps = 0
    for obj in made["engines"]:
        for eng in getattr(obj, "clients", [obj]):
            g = eng.executor.graphs
            caps += sum(g.captures.values())
            reps += sum(g.replays.values())
    for c in made["steps"]:
        caps += c.captures
        reps += c.replays
    return caps, reps


def _tour_digest(made: dict, res: dict) -> str:
    """sha1 of what the tour computed: every scenario run's and
    request's greedy tokens, the layer outputs' bytes, the losses and
    grad norms (exact floats)."""
    h = hashlib.sha1()
    for run in made["runs"]:
        h.update(repr(sorted((r.request_id, tuple(r.output_tokens))
                             for r in run.requests)).encode())
    if "requests" in res:
        h.update(repr([tuple(r.output_tokens)
                       for r in res["requests"]]).encode())
    for k in ("y", "y_healthy", "y_failover", "y0_healthy", "y1_healthy",
              "y0_failover", "y0_back"):
        if k in res:
            h.update(res[k].detach().float().cpu().numpy().tobytes())
    if "history" in res:
        h.update(repr(res["history"]).encode())
    return h.hexdigest()[:16]


def _run_tour(torch, name: str, graphs: bool, argv=(), cfg=None,
              ckpt_dir=None, expect_fail=False, virtual=False) -> dict:
    """Run tour ``name``'s ``main`` on the card in one arm; its printed
    lines, digest, fingerprints, graph counts, launches, wall and peak
    memory.  The tour's own asserts raise, unless ``expect_fail``
    (quickstart only): then the ``AssertionError`` of quickstart's own
    ``assert err < 1e-3`` is caught, and only that one, and ``failed``
    says whether it came; the lines up to it are kept, and what the tour
    computed before it (``main``'s ``out``).  ``virtual``: the tour's
    clusters run under the VirtualClock (serve_moe's lockstep one would
    take the wall clock)."""
    import importlib
    import io
    import traceback

    from repro_torch.kernels import build

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    mod = importlib.reload(mod)           # a fresh module: its names wrap
    if virtual:
        from repro_torch.serving import VirtualClock
        cluster = mod.Cluster
        mod.Cluster = lambda *a, **kw: cluster(
            *a, **dict(kw, clock_factory=VirtualClock))
    made = _watch_tour(mod)
    if ckpt_dir is not None:
        mod.CKPT_DIR = ckpt_dir
    kw = {} if cfg is None else {"cfg": cfg}
    if expect_fail:
        kw["out"] = {}
    _free(torch)
    build.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    failed = False
    with _arm(graphs), contextlib.redirect_stdout(out):
        try:
            res = mod.main(["--device", "cuda", *argv], **kw)
        except AssertionError as err:
            where = traceback.extract_tb(err.__traceback__)[-1]
            if not (expect_fail and where.name == "tour"
                    and where.filename.endswith(QUICKSTART_SRC)
                    and where.line == "assert err < 1e-3"):
                raise
            res, failed = kw["out"], True
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in build.LAUNCHES.items() if n}
    caps, reps = _graph_counts(made)
    fps = [o.metrics.fingerprint() for o in made["engines"]]
    fps += [run.metrics.fingerprint() for run in made["runs"]]
    r = dict(lines=out.getvalue().rstrip("\n").split("\n"),
             digest=_tour_digest(made, res),
             fingerprints=[hashlib.sha1(f.encode()).hexdigest()[:16]
                           for f in fps],
             captures=caps, replays=reps, launches=launches,
             wall_s=round(wall, 2),
             peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2),
             failed=failed)
    for k in ("err", "failover_captures", "identical", "halted", "final"):
        if k in res:
            r[k] = res[k]
    if name == "quickstart":
        fn2 = made["steps"][1]
        r["fn2"] = (fn2.captures, fn2.replays)
        r["counts"] = dict(fn2.counts)
    if name == "serve_moe":
        m = res["metrics"]
        r.update(completed=m.completed, stranded=m.failed_requests,
                 preemptions=sum(c.metrics.preemptions
                                 for c in res["cluster"].clients))
    del res
    for v in made.values():      # the wrapped names outlive the run
        v.clear()
    return r


def _tour_job(name: str, graphs: bool) -> dict:
    """A pool process's job: one arm of one reduced tour (its checkpoints,
    train_small's, under the ignored build directory)."""
    import shutil

    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    build.load_library()
    ckpt = ROOT / "build" / f"ckpt_{name}_{'graphs' if graphs else 'eager'}"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        return _run_tour(torch, name, graphs, ckpt_dir=str(ckpt))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


QUICKSTART_SRC = str(Path("repro_torch", "examples", "quickstart.py"))
# the reference's planner replicates only the hottest max(32, 4 S)
# experts (``core/load_balance.py::eplb_plan``'s candidate window):
# quickstart's "every expert 2-homed" holds up to 32 experts of 4 servers
QUICKSTART_HOMED = 32


def _quickstart_cfg(torch, get_config) -> tuple:
    """Kimi-K2 at its full widths with the largest expert count whose
    2-homed rebuild fits the free memory: the reckoning, and the cut."""
    cfg = get_config("kimi-k2-1t-a32b")
    m = cfg.moe
    per = 3 * cfg.d_model * m.d_expert * 2      # one expert's weights, bf16
    _free(torch)
    free = torch.cuda.mem_get_info()[0]

    def need(E):
        """The rebuild's peak (``quickstart.replicate``, a weight at a
        time): the last weight's 1-homed bank beside all three 2-homed
        ones, 7 thirds of ``E * per``; 1.5 GiB for the rest (the
        activations at T = 64 and the graph pools are tens of MiB)."""
        return 7 * E * per // 3 + 3 * 2**29

    E = m.num_experts
    while need(E) > free:
        E -= 32                        # 8 experts a server of S = 4
    log(f"examples (quickstart): {cfg.arch_id} d_model {cfg.d_model} "
        f"d_expert {m.d_expert} top-{m.top_k}; 2-homed bank of "
        f"{m.num_experts} experts {2 * m.num_experts * per / 2**30:.1f} GiB, "
        f"rebuild peak {need(m.num_experts) / 2**30:.1f} GiB with 1.5 GiB "
        f"of headroom, free {free / 2**30:.1f} GiB (allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f}) -> "
        + (f"all {E} experts" if E == m.num_experts else
           f"CUT to {E} experts (2-homed bank "
           f"{2 * E * per / 2**30:.1f} GiB)"))
    return cfg.replace(moe=dataclasses.replace(m, num_experts=E)), E


def _quickstart_runs(torch, get_config, runs: dict) -> int:
    """quickstart at Kimi-K2's full widths, both arms: at
    ``QUICKSTART_HOMED`` experts (every expert 2-homed: the tour's asserts
    hold), then at all 384 (cut only where memory says): the planner
    leaves most experts one home, server 2's die with it and the failover
    misses, so the tour's assert fails, in both arms alike, as the
    reference's would.  Returns the expert count of the second."""
    full = get_config("kimi-k2-1t-a32b")
    homed = full.replace(moe=dataclasses.replace(
        full.moe, num_experts=QUICKSTART_HOMED))
    for graphs in (True, False):
        runs["quickstart", graphs] = _run_tour(torch, "quickstart", graphs,
                                               cfg=homed)
    qcfg, E = _quickstart_cfg(torch, get_config)
    while ("quickstart@all", False) not in runs:
        try:
            for graphs in (True, False):
                runs["quickstart@all", graphs] = _run_tour(
                    torch, "quickstart", graphs, cfg=qcfg, expect_fail=True)
        except torch.OutOfMemoryError as err:
            if E <= 2 * QUICKSTART_HOMED:
                raise
            runs.pop(("quickstart@all", True), None)
            E -= 32
            qcfg = qcfg.replace(moe=dataclasses.replace(qcfg.moe,
                                                        num_experts=E))
            log(f"examples (quickstart): out of memory "
                f"({str(err).splitlines()[0][:120]}); CUT to {E} experts")
    return E


def _tour_checks(label: str, g: dict, e: dict) -> list:
    """What must hold between a tour's two arms, and its own checks."""
    name = label.split("@")[0]
    bad = []
    held = ("lines", "digest", "fingerprints", "launches")
    if name == "quickstart":
        # a program's first call runs it eagerly once before its capture:
        # the graph arm launches 5 calls' kernels to the eager arm's 3
        held = ("lines", "digest")
    if name == "serve_moe":
        for arm in (g, e):
            if arm["completed"] + arm["stranded"] != 16 or \
                    arm["preemptions"] == 0:
                bad.append(f"{name}: {arm['completed']} completed + "
                           f"{arm['stranded']} stranded of 16, "
                           f"{arm['preemptions']} preemptions")
    for k in held:
        if g[k] != e[k]:
            bad.append(f"{label}: {k} differ between graphs and eager: "
                       f"{g[k]} / {e[k]}")
    if e["captures"] or e["replays"]:
        bad.append(f"{label}: the eager arm captured {e['captures']}")
    if label == "quickstart@all":
        # only the tour's own assert, after a failover that missed
        for arm in (g, e):
            last = arm["lines"][-1]
            miss = re.search(r"miss=(\d+)$", last)
            if not (arm["failed"] and last.startswith("server 2 killed")
                    and miss and int(miss.group(1)) > 0
                    and arm["err"] >= 1e-3):
                bad.append(f"{label}: expected the failover to miss and "
                           f"the tour's assert to fail: {last!r}")
    elif g["failed"] or e["failed"]:
        bad.append(f"{label}: the tour's assert failed")
    if name == "quickstart":
        if g["fn2"] != (1, 1) or g.get("failover_captures") not in (0,
                                                                    None):
            bad.append(f"{label}: fn2 captures / replays {g['fn2']}, "
                       f"failover captures {g.get('failover_captures')}")
        if label == "quickstart" and not g["err"] < 1e-3:
            bad.append(f"quickstart: err {g['err']}")
    if name in ("scenario_cluster_failover", "scenario_overlap_ablation",
                "scenario_expert_balance"):
        for arm in (g, e):
            if not arm["identical"]:
                bad.append(f"{name}: the tour's token streams differ")
    # quickstart's and the disaggregated servers' float32 rows meet bf16
    # weights: the grouped GEMM's widening route
    route = ("grouped_gemm_f32_bf16"
             if name in ("quickstart", "disaggregated_serving")
             else "grouped_gemm")
    if name != "train_small" and not g["launches"].get(route):
        bad.append(f"{label}: the grouped GEMM ({route}) never launched")
    if name == "train_small" and not (g["launches"].get("grouped_gemm_dx")
                                      and g["launches"].get(
                                          "grouped_gemm_dw")):
        bad.append(f"train_small: dx / dw launched {g['launches']}")
    return bad


def _tour_report(name: str, g: dict, e: dict, smi: str) -> None:
    log(f"examples ({name}): graphs {g['wall_s']} s, {g['captures']} "
        f"captures, {g['replays']} replays, launches {g['launches']}, "
        f"peak {g['peak_gib']} GiB; eager() {e['wall_s']} s, launches "
        f"{e['launches']}; lines, digest {g['digest']} and fingerprints "
        f"equal: {g['lines'] == e['lines']} / {g['digest'] == e['digest']} "
        f"/ {g['fingerprints'] == e['fingerprints']} ({smi})")
    for ln in g["lines"][-3:]:
        log(f"examples ({name}):   | {ln[:160]}")


def examples_phase(torch, get_config, smi, workers=TOUR_WORKERS) -> dict:
    """Phase 31: the nine tours, graphs against ``eager()``.  quickstart's
    full-width arms first, alone on the card (their rebuild takes most of
    its memory); then the pool's seven reduced tours (14 arms) run while
    this process serves serve_moe's two arms at full width.  With
    ``workers`` 1 the pool starts after serve_moe's arms: each arm runs
    alone, and its wall is the tour's own, not the contended pool's.
    Returns each tour's graph-arm launches."""
    import multiprocessing as mp

    t0 = time.perf_counter()
    runs, bad = {}, []
    E = _quickstart_runs(torch, get_config, runs)
    t_quick = time.perf_counter() - t0
    ctx = mp.get_context("spawn")
    pool = ctx.Pool(workers)
    jobs = {}

    def submit():
        jobs.update({(name, graphs): pool.apply_async(_tour_job,
                                                      (name, graphs))
                     for name in POOL_TOURS for graphs in (True, False)})
    try:
        if workers > 1:
            submit()
        base = get_config("deepseek-r1")
        cfg = base.replace(num_layers=3,
                           moe=dataclasses.replace(base.moe,
                                                   first_k_dense=1))
        # as a user runs it (the wall clock), then both arms with the
        # cluster's clients interleaved by the VirtualClock: under the
        # wall clock the cluster steps the client whose clock is most
        # behind, so which rows share a step follows the card's timing,
        # and the greedy tokens with it (two wall-clock arms diverged
        # after a few tokens)
        wall = _run_tour(torch, "serve_moe", True, SERVE_MOE_ARGV, cfg=cfg)
        for graphs in (True, False):
            runs["serve_moe", graphs] = _run_tour(
                torch, "serve_moe", graphs, SERVE_MOE_ARGV, cfg=cfg,
                virtual=True)
        t_serve = time.perf_counter() - t0
        if workers == 1:
            submit()
        for key, job in jobs.items():
            runs[key] = job.get(timeout=max(30.0, 600 * (1 + (workers == 1))
                                            - (time.perf_counter() - t0)))
        t_pool = time.perf_counter() - t0
    finally:
        pool.terminate()
        pool.join()
    labels = ("quickstart", "quickstart@all", "serve_moe") + POOL_TOURS
    for label in labels:
        g, e = runs[label, True], runs[label, False]
        _tour_report(label, g, e, smi)
        bad += _tour_checks(label, g, e)
    log(f"examples (serve_moe, wall clock): {wall['wall_s']} s, "
        f"{wall['completed']} completed, {wall['stranded']} stranded, "
        f"{wall['preemptions']} preemptions, {wall['captures']} captures, "
        f"{wall['replays']} replays, launches {wall['launches']}, peak "
        f"{wall['peak_gib']} GiB ({smi})")
    for ln in wall["lines"]:
        log(f"examples (serve_moe, wall clock):   | {ln[:160]}")
    if wall["completed"] + wall["stranded"] != 16:
        bad.append(f"serve_moe (wall clock): {wall['completed']} + "
                   f"{wall['stranded']} of 16")
    q, qa = runs["quickstart", True], runs["quickstart@all", True]
    sm = runs["serve_moe", True]
    log(f"examples: quickstart at {QUICKSTART_HOMED} experts: fn2 captures "
        f"/ replays {q['fn2']} (the failover call captured "
        f"{q['failover_captures']}), a replay's launches {q['counts']}, err "
        f"{q['err']:.2e}; at {E} experts: fn2 {qa['fn2']}, the tour's "
        f"assert failed in both arms: {qa['failed']} "
        f"({qa['lines'][-1][:90]}), peak {qa['peak_gib']} / "
        f"{runs['quickstart@all', False]['peak_gib']} GiB (graphs / eager); "
        f"serve_moe: {sm['completed']} completed, {sm['stranded']} "
        f"stranded, {sm['preemptions']} preemptions (eager arm "
        f"{runs['serve_moe', False]['completed']} / "
        f"{runs['serve_moe', False]['stranded']} / "
        f"{runs['serve_moe', False]['preemptions']}), peak {sm['peak_gib']} / "
        f"{runs['serve_moe', False]['peak_gib']} GiB; overlap tokens "
        f"identical across variants: "
        f"{runs['scenario_overlap_ablation', True]['identical']}; "
        f"quickstart's four arms {t_quick:.1f} s, serve_moe's arms done at "
        f"{t_serve:.1f} s, the pool ({workers} processes, "
        f"{len(POOL_TOURS)} tours x 2 arms) at {t_pool:.1f} s; phase "
        f"{time.perf_counter() - t0:.1f} s ({smi})")
    if bad:
        raise AssertionError(f"examples: {bad}")
    return {label: runs[label, True]["launches"] for label in labels}

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
    alone = {"families": lambda: family_reference_phase(torch, get_config),
             "disaggregated": lambda: disaggregated_phase(torch, get_config,
                                                          smi),
             "arctic": lambda: arctic_phase(torch, get_config, smi),
             "gemma3": lambda: gemma3_phase(torch, get_config, smi),
             "zamba2": lambda: zamba2_phase(torch, get_config, smi),
             "rwkv6": lambda: rwkv6_phase(torch, get_config, smi),
             "whisper": lambda: whisper_phase(torch, get_config, smi),
             "train": lambda: train_alone(torch, get_config, smi),
             "spmd": lambda: spmd_alone(torch, get_config, smi),
             "mesh": lambda: mesh_alone(torch, get_config, smi),
             "remat": lambda: remat_alone(torch, get_config, smi),
             "graphs": lambda: graphs_phase(torch, get_config, smi),
             "prefill": lambda: prefill_phase(torch, get_config, smi),
             "family-prefill": lambda: family_prefill_phase(
                 torch, get_config, smi),
             "train-graphs": lambda: train_graphs_phase(torch, get_config,
                                                        smi),
             "examples": lambda: examples_phase(torch, get_config, smi),
             "examples-solo": lambda: examples_phase(torch, get_config, smi,
                                                     workers=1),
             "mesh-graphs": lambda: mesh_graphs_alone(torch, get_config,
                                                      smi),
             "mesh-train": lambda: mesh_full_width(torch, get_config, smi,
                                                   {}),
             "parity": lambda: parity_phase(torch, get_config, smi,
                                            {k: [] for k in SOURCES})}
    if len(sys.argv) == 3 and sys.argv[1] == "--only" \
            and sys.argv[2] in alone:
        alone[sys.argv[2]]()             # one model's phase, no summary
        log(f"chip_smoke: phase {sys.argv[2]} passed")
        return 0
    if len(sys.argv) > 1:
        print(f"usage: chip_smoke.py [--only {{{','.join(alone)}}}]",
              file=sys.stderr)
        return 2
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

    clock = {"start": time.perf_counter()}
    clock["t"] = clock["start"]

    def mark(phase):
        """The seconds a phase took, and the script's so far."""
        now = time.perf_counter()
        log(f"time: {phase} {now - clock['t']:.1f} s (script "
            f"{now - clock['start']:.1f} s)")
        clock["t"] = now

    cfg = get_config("deepseek-r1")
    cases, floor = kernels_phase(torch, cfg)
    mark("kernels_phase")
    partial_kernel_phase(torch, cfg, cases)
    mark("partial_kernel_phase")
    backward_kernels_phase(torch, cfg, cases)
    mark("backward_kernels_phase")
    reference_phase(torch, get_config)
    mark("reference_phase")
    launches, eng, serve_cfg, rng = serve_phase(torch, get_config)
    mark("serve_phase")
    paged_launches, paged_prompts = paged_serve_phase(torch, serve_cfg,
                                                      eng.params, rng)
    mark("paged_serve_phase")
    mode_launches = decode_modes_phase(torch, serve_cfg, eng.params, smi)
    mark("decode_modes_phase")
    # phase 33 on the dense serve's weights, while they are on the card
    parity_launches = parity_phase(torch, get_config, smi, cases,
                                   serve=(serve_cfg, eng.params))
    mark("parity_phase (33)")
    # the cluster phases share the dense serve's weights (one bank on the
    # card for every client); they run before the baselines free them
    cluster_launches = cluster_phase(torch, serve_cfg, eng.params, smi)
    mark("cluster_phase")
    async_launches = async_cluster_phase(torch, serve_cfg, eng.params, smi)
    mark("async_cluster_phase")
    cpaged_launches = paged_cluster_phase(torch, serve_cfg, eng.params,
                                          paged_prompts, smi)
    mark("paged_cluster_phase")
    # the baselines have their own layouts, and the control plane owns its
    # weights (it reshards them in place): one full-width model at a time
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    mode_launches.update(baselines_phase(torch, serve_cfg, smi))
    mark("baselines_phase")
    control_launches = control_plane_phase(torch, serve_cfg, smi)
    mark("control_plane_phase")
    family_reference_phase(torch, get_config)
    mark("family_reference_phase")
    disagg_launches = disaggregated_phase(torch, get_config, smi)
    mark("disaggregated_phase")
    arctic_launches = arctic_phase(torch, get_config, smi)
    mark("arctic_phase")
    gemma3_launches = gemma3_phase(torch, get_config, smi)
    mark("gemma3_phase")
    zamba2_launches = zamba2_phase(torch, get_config, smi)
    mark("zamba2_phase")
    rwkv6_launches = rwkv6_phase(torch, get_config, smi)
    mark("rwkv6_phase")
    whisper_launches = whisper_phase(torch, get_config, smi)
    mark("whisper_phase")
    train_launches, launcher_launches, train_arms = train_phases(
        torch, get_config, smi, cases)
    mark("train_phases")
    mesh_arms = {}           # phase 32's arms, run inside phases 24-25
    spmd_launches = spmd_phase(torch, get_config, smi, mesh_arms)
    mark("spmd_phase")
    mesh_launches, family_launches = mesh_phase(torch, get_config, smi,
                                                mesh_arms)
    mark("mesh_phase")
    remat_phase(torch, get_config, smi)
    mark("remat_phase")
    graph_launches = graphs_phase(torch, get_config, smi)
    mark("graphs_phase")
    prefill_launches = prefill_phase(torch, get_config, smi)
    mark("prefill_phase")
    fprefill_launches = family_prefill_phase(torch, get_config, smi)
    mark("family_prefill_phase")
    tgraph_launches = train_graphs_phase(torch, get_config, smi, train_arms)
    mark("train_graphs_phase")
    example_launches = examples_phase(torch, get_config, smi)
    mark("examples_phase")
    mgraph_launches = mesh_graphs_phase(torch, smi, mesh_arms)
    mark("mesh_graphs_phase")

    def entry(name):
        cs = cases[name]
        head = cs[0]                      # the decode shape: most launches
        src, replaces = SOURCES[name]
        at = lambda counts: counts.get(name, 0)       # noqa: E731
        # each kernel's count from the run of the path that carries it
        main = (train_launches if name.startswith("grouped_gemm_d") else
                spmd_launches if name == "flash_decode_partial" else
                parity_launches if name == "sample" else
                disagg_launches if name == "grouped_gemm_f32_bf16" else
                paged_launches if name not in DENSE_PATH else launches)
        return {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": at(main),
            "launches_by_phase": {"serve": at(launches),
                                  "serve-paged": at(paged_launches),
                                  "parity": at(parity_launches),
                                  **{f"modes ({m})": at(n)
                                     for m, n in mode_launches.items()},
                                  "control-plane": at(control_launches),
                                  "cluster": at(cluster_launches),
                                  "cluster-async": at(async_launches),
                                  "cluster-paged": at(cpaged_launches),
                                  "disaggregated": at(disagg_launches),
                                  "arctic": at(arctic_launches),
                                  "gemma3": at(gemma3_launches),
                                  "zamba2": at(zamba2_launches),
                                  "rwkv6": at(rwkv6_launches),
                                  "whisper": at(whisper_launches),
                                  "train": at(train_launches),
                                  "train-launcher":
                                      at(launcher_launches),
                                  "spmd": at(spmd_launches),
                                  "mesh": at(mesh_launches),
                                  **{f"mesh ({a})": at(n)
                                     for a, n in family_launches.items()
                                     if name in n},
                                  **{f"graphs ({a})": at(n)
                                     for a, n in graph_launches.items()},
                                  **{f"prefill ({a})": at(n)
                                     for a, n in prefill_launches.items()},
                                  **{f"family-prefill ({a})": at(n)
                                     for a, n in fprefill_launches.items()},
                                  **{f"train-graphs ({a}, eager)": at(n)
                                     for a, n in tgraph_launches.items()},
                                  **{f"examples ({a})": at(n)
                                     for a, n in example_launches.items()},
                                  **{f"mesh-graphs ({a})": at(n)
                                     for a, n in mgraph_launches.items()}},
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "card": smi, "cases": cs}

    # kernel 4 is one CUDA body with two entries: the slot entry carries
    # the serving path, the direct entry (the Pallas kernel's signature)
    # is listed under it
    summary = [entry(n) for n in ("grouped_gemm", "grouped_gemm_dx",
                                  "grouped_gemm_dw", "flash_decode",
                                  "flash_decode_partial",
                                  "paged_flash_decode", "combine_slots",
                                  "grouped_gemm_f32_bf16", "sample")]
    summary[6].update(launch_floor=floor,
                      entries=[entry("combine_weighted")])
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
