"""Which kernel moves the dense serve's result.

    PYTHONPATH=src python -m repro_torch.tools.serve_variants [--variants kernels,...]

Runs the dense serve of ``chip_smoke.py`` (deepseek-r1 at full width, depth
1 dense + 2 MoE blocks, 8 requests of 32 greedy tokens, expert server 1 down
for steps 10-20) once per variant, each on a fresh engine from the same
seed: with every CUDA kernel, then with the decode attention, the grouped
GEMM, or both computed by their plain PyTorch versions on the card.  Each
variant prints its ``miss`` count (routed tokens that found their expert's
server down), ``dropped``, completions, and a digest of the greedy tokens:
the variants that agree on the tokens agree on ``miss``.  A kernel whose
rounding moves the count shows as the variant that differs from the run
with every kernel.

``--variants`` runs only the named variants (comma-separated labels of
:data:`VARIANTS`); ``--variants kernels`` is the quick way to digest another
tree's served tokens, by running this file against that tree's package
(``PYTHONPATH=<tree>/src python <this file> --variants kernels``).

Needs one CUDA card with ~55 GiB free; the plain grouped GEMM makes its
variants take about a minute each.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention, grouped_gemm, ops
from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                 ServingEngine, WallClock)
from repro_torch.serving.metrics import ServingMetrics

PLAIN = {
    "flash_decode": lambda q, k, v, lengths, impl="auto":
        decode_attention.flash_decode_torch(q, k, v, lengths),
    "grouped_gemm": lambda x, w, sizes, impl="auto", **kw:
        grouped_gemm.grouped_gemm_torch(x, w, sizes),
}
VARIANTS = {"kernels": (), "plain decode attention": ("flash_decode",),
            "plain grouped GEMM": ("grouped_gemm",),
            "plain both": ("flash_decode", "grouped_gemm")}


def serve(cfg, ecfg) -> dict:
    """chip_smoke.py's dense serve on a fresh engine; its result."""
    eng = ServingEngine(cfg, ecfg, seed=0, clock=WallClock())
    rng = np.random.default_rng(0)
    # the warm-up's id: sampling keys take ids as uint32s
    eng.submit(Request(2 ** 32 - 1, rng.integers(0, cfg.vocab_size, 64,
                                                 np.int32),
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

    metrics = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    tokens = [list(map(int, r.output_tokens)) for r in reqs]
    result = {"completed": metrics.completed,
              "miss": int(eng.executor.miss),
              "dropped": int(eng.executor.dropped),
              "tokens_sha1": hashlib.sha1(
                  json.dumps(tokens).encode()).hexdigest()[:12],
              "first_tokens": [t[:4] for t in tokens]}
    del eng, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return result


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated labels of the variants to run")
    labels = ap.parse_args().variants.split(",")
    unknown = [v for v in labels if v not in VARIANTS]
    if unknown:
        ap.error(f"unknown variants {unknown}; expected {list(VARIANTS)}")
    if not torch.cuda.is_available():
        print("serve_variants: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    base = get_config("deepseek-r1")
    cfg = base.replace(num_layers=3,
                       moe=dataclasses.replace(base.moe, first_k_dense=1))
    ecfg = EngineConfig(max_batch=8, max_seq=1024, num_servers=4,
                        n_redundant=2, pool_tokens_per_client=512)
    kernels = {name: getattr(ops, name) for name in PLAIN}
    results = {}
    for label in labels:
        plain = VARIANTS[label]
        for name in PLAIN:
            setattr(ops, name, PLAIN[name] if name in plain
                    else kernels[name])
        t0 = time.perf_counter()
        results[label] = serve(cfg, ecfg)
        print(f"serve_variants: {label}: {json.dumps(results[label])} "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    for name in PLAIN:
        setattr(ops, name, kernels[name])
    print(json.dumps({"variants": {k: v["miss"] for k, v in
                                   results.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
