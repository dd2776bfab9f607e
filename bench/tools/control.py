#!/usr/bin/env python3
"""The readings that set a cell's limits (``bench/limits/<workload>.json``).

On one built engine (its graphs captured once), for each seed: redraw the
weights in place from the seed, serve the cell's traffic for a short
window at the cell's own load, pick the samples a run picks, and print
:func:`harness.check.summary` and :func:`harness.check.judge`'s verdict
under the cell's limits file, of

* the program's served tokens (the lower readings: sound runs);
* for the control seeds, the control's: the reference computed with
  every weight in float8 e4m3 (one scale per output column), the
  precision below the configuration's bfloat16, put in the program's
  place (at each position of the same prompts and served tokens, the
  token it puts first, or draws at the request's temperature);
* for the fault seeds, after the sound ones, the program's with each
  named fault of :mod:`harness.faults` planted in turn.

    python3 bench/tools/control.py --workload dsr1-chat \\
        --seeds 1,2,3 --control-seeds 1,2,3 --seconds 15 \\
        --faults argmax_sampler --fault-seeds 4,5,6
"""

import argparse
import json
import sys
import time

import common

common.setup_path()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    from harness import check, faults, runner, traffic
    from reference.moe_decoder import fp8_cast

    def ints(text):
        return [int(s) for s in text.split(",") if s]
    t_proc = time.perf_counter()
    _, _, config, mix = runner.load_cell(common.ROOT, args.workload)
    limits = check.load_limits(common.ROOT, args.workload)
    seeds, ctl = ints(args.seeds), set(ints(args.control_seeds))
    cell = runner.Cell(config, mix, args.seconds, seeds[0], args.device)
    n = cell.warm_shapes()
    runner.log(f"{n} shapes warmed", t_proc)
    m = config["model"]

    def one(seed, fault=None):
        cell.reset()
        cell.reseed(seed)
        items = traffic.schedule(mix, args.seconds, seed, m["vocab_size"])
        drop0 = int(cell.engine.executor.dropped)
        miss0 = int(cell.engine.executor.miss)
        ws, we = cell.serve(items, float(mix["warm_s"]), args.seconds)
        gs, ss = check.draw_samples(cell.driver, ws, we, limits, seed)
        greedy = check.served(cell.driver, gs)
        sampled = check.served(cell.driver, ss)
        temps = check.temperatures(cell.driver, ss)
        if args.device != "cpu":
            torch.cuda.synchronize()
        dropped = int(cell.engine.executor.dropped) - drop0
        miss = int(cell.engine.executor.miss) - miss0
        out = {"seed": seed, "dropped": dropped, "miss": miss}
        runs = [("program" if fault is None else fault, None)]
        if fault is None and seed in ctl:
            runs.append(("control", fp8_cast))
        for name, cast in runs:
            g, d = check.readings(cell.params, m, greedy, sampled, temps,
                                  args.device, config, cast=cast,
                                  seed=seed)
            ok, failed, _ = check.judge(g, d, dropped if cast is None
                                        else 0, miss if cast is None
                                        else 0, limits)
            out[name] = {"correct": ok, "failed": failed,
                         **check.summary(g, d)}
        if args.device != "cpu":
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)

    for seed in seeds:
        one(seed)
    for name in args.faults.split(","):
        if not name:
            continue
        patch = faults.Patches()
        faults.ALL[name](cell, patch)
        for seed in ints(args.fault_seeds):
            one(seed, name)
        patch.undo()
    return 0


if __name__ == "__main__":
    sys.exit(main())
