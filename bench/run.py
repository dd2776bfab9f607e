#!/usr/bin/env python3
"""The benchmark of ``repro_torch`` on the card: one run of one cell.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It finds the cell in ``BENCHMARK.json``, sets
up (weights from the seed, the port's serving engine, every shape of the
run's traffic warmed up), serves the cell's traffic for ``--seconds``
seconds, checks the served tokens against the plain reference, and prints
one JSON object as the last line of standard output: the end-to-end
metrics with ``--trace 0``, the per-layer metrics with ``--trace 1``.  The
numbers compared and their limits are the last lines of standard error.
Without a CUDA device it exits 2 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def _caches() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the port's nvcc objects go to ``build/kernels`` by themselves)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print("no CUDA device, or fewer than the cell's "
              f"{cell['chips']}: nothing measured", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from harness import runner
    res, notes = runner.run(ROOT, args.workload, args.seed, args.seconds,
                            bool(args.trace), T_PROCESS)
    emit(res, notes)
    return 0


def emit(res: dict, notes: dict) -> None:
    """The run's notes, then each number compared beside its limit as the
    last lines of standard error; the result as the last line of standard
    output."""
    print(json.dumps({"notes": notes}), file=sys.stderr)
    for name, (value, limit) in res["compared"].items():
        print(f"compared {name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    sys.exit(main())
