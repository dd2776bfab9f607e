"""Time the grouped GEMM's backward kernels at the training path's shapes.

    PYTHONPATH=src python -m repro_torch.tools.bwd_times

One server of the full-width deepseek-r1 training run (bf16, G = 128
experts, C = 10240 rows of which 8192 live, drawn uniformly as
``chip_smoke.py`` draws them; gate/up K, N = 7168, 2048 and down 2048,
7168): ``grouped_gemm_dx``, ``grouped_gemm_dw`` and ``grouped_gemm_dw``
accumulating into a (G, K, N) buffer, each timed as ``chip_smoke.py``
times its kernels (the median of ``--reps`` CUDA-event samples of 5 eager
calls, and of a CUDA graph of the 5 calls: ``device_ms``).  Prints the
card's name and power limit, then one JSON line per (shape, kernel).

To compare two trees' kernels on one card, run this file against each
tree's package in turns (``PYTHONPATH=<tree>/src python <this file>``):
each builds its own tree's kernels.  Needs one CUDA card with ~30 GiB
free (a graph of 5 dw calls keeps their outputs).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.kernels import grouped_gemm as kgg


def time_ms(fn, reps: int, inner: int = 5, graph: bool = False) -> float:
    """Median over ``reps`` samples of CUDA events around ``inner`` calls
    (replayed from a CUDA graph with ``graph``), divided by ``inner``."""
    for _ in range(3):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bwd_times: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev, bf = "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    G, C = 128, 10240
    sizes = torch.bincount(torch.randint(
        0, G, (8192,), generator=torch.Generator().manual_seed(2)),
        minlength=G).to(dev)
    for shape, K, N in (("gate/up", 7168, 2048), ("down", 2048, 7168)):
        x = torch.randn(C, K, generator=gen, device=dev).to(bf)
        dy = torch.randn(C, N, generator=gen, device=dev).to(bf)
        w = (torch.randn(G, K, N, generator=gen, device=dev)
             / K ** 0.5).to(bf)
        buf = (torch.randn(G, K, N, generator=gen, device=dev) * 4).to(bf)
        calls = {
            "grouped_gemm_dx": lambda: kgg.grouped_gemm_dx_cuda(dy, w, sizes),
            "grouped_gemm_dw": lambda: kgg.grouped_gemm_dw_cuda(x, dy, sizes),
            "grouped_gemm_dw accumulate": lambda: kgg.grouped_gemm_dw_cuda(
                x, dy, sizes, out=buf)}
        for name, fn in calls.items():
            print(json.dumps({
                "shape": shape, "kernel": name,
                "ms": time_ms(fn, args.reps),
                "device_ms": time_ms(fn, args.reps, graph=True)}),
                flush=True)
        del x, dy, w, buf, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
