"""Wall time of the dense serve's decode step, and of its sampling, greedy
and at temperature 0.8.

    PYTHONPATH=src python -m repro_torch.tools.decode_step_time [--serves N]

Serves the dense traffic of ``chip_smoke.py`` (deepseek-r1 at full width,
depth 1 dense + 2 MoE blocks; a greedy warm-up request, then 8 requests of
64-512 prompt tokens and 32 new tokens each) on the card, with the
executor's decode steps as CUDA graphs (its default there): ``--serves``
times greedy, then as many times at temperature 0.8 (seeds 7-14), each on
a fresh engine from seed 0.  Per traffic it prints one JSON line: the
wall p50 and mean of the decode steps that ran all 8 rows (the clock
synchronizes the device at the step's end), the wall p50 of the sampling
call inside them (the device synchronized before it; the call copies its
tokens to the host), and a digest of the tokens.

To compare two trees on one card, run this file against each tree's
package, alternating (``PYTHONPATH=<tree>/src python <this file>``): it
uses only what the engine offered before its sampler kept keys on the
device.

Needs one CUDA card with ~40 GiB free.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import statistics
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                 ServingEngine, WallClock)

WARM_ID = 2 ** 32 - 1            # sampling keys take ids as uint32s


def serve(cfg, ecfg, temperature: float) -> dict:
    """One serve of the dense traffic at ``temperature``; its timings."""
    eng = ServingEngine(cfg, ecfg, seed=0, clock=WallClock())
    rng = np.random.default_rng(0)
    eng.submit(Request(WARM_ID, rng.integers(0, cfg.vocab_size, 64,
                                             np.int32),
                       SamplingParams(max_new_tokens=2)))
    eng.run()
    lengths = rng.integers(64, 513, 8)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, int(n), np.int32),
                    SamplingParams(max_new_tokens=32,
                                   temperature=temperature, seed=7 + i))
            for i, n in enumerate(lengths)]
    for r in reqs:
        eng.submit(r)
    steps, samples, inside = [], [], [False]
    decode, sample = eng._step_decode, eng._sample

    def timed_decode(plan):
        inside[0] = len(plan.slots) == len(reqs)
        t0 = time.perf_counter()
        decode(plan)
        if inside[0]:
            steps.append(time.perf_counter() - t0)
        inside[0] = False

    def timed_sample(*args):
        if not inside[0]:
            return sample(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(*args)
        samples.append(time.perf_counter() - t0)
        return out

    eng._step_decode, eng._sample = timed_decode, timed_sample
    metrics = eng.run()
    torch.cuda.synchronize()
    del eng._step_decode, eng._sample   # the class's methods: no cycle
    tokens = [list(map(int, r.output_tokens)) for r in reqs]
    out = {"temperature": temperature, "completed": metrics.completed,
           "full_steps": len(steps),
           "step_ms_p50": statistics.median(steps) * 1e3,
           "step_ms_mean": statistics.fmean(steps) * 1e3,
           "sample_ms_p50": statistics.median(samples) * 1e3,
           "tokens_sha1": hashlib.sha1(
               json.dumps(tokens).encode()).hexdigest()[:12]}
    del eng, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--serves", type=int, default=2,
                    help="serves of each traffic (the first pays the "
                         "graphs' captures)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_step_time: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # as chip_smoke.py
    torch.backends.cudnn.allow_tf32 = False
    base = get_config("deepseek-r1")
    cfg = base.replace(num_layers=3,
                       moe=dataclasses.replace(base.moe, first_k_dense=1))
    ecfg = EngineConfig(max_batch=8, max_seq=1024, num_servers=4,
                        n_redundant=2, pool_tokens_per_client=512)
    for temperature in (0.0, 0.8):
        for i in range(args.serves):
            print(json.dumps({"serve": i, **serve(cfg, ecfg, temperature)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
