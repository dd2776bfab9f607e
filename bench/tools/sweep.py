#!/usr/bin/env python3
"""Find an open-loop cell's knee: serve its mix at each of several rates,
on one built engine, and print per rate the completed output tokens per
second, the tails and the backlog at the middle and the end of the
window.  The knee is the highest rate whose backlog does not grow.

    python3 bench/tools/sweep.py --workload dsr1-chat --rates 4,5,6,7 \\
        --seconds 20 --seed 5
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
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch
    from harness import drive, runner, traffic
    from harness.frozen import percentile
    t_proc = time.perf_counter()
    _, _, config, mix = runner.load_cell(common.ROOT, args.workload)
    rates = [float(r) for r in args.rates.split(",")]
    scheds = {}
    for r in rates:
        mix_r = dict(mix, rate_rps=r)
        scheds[r] = traffic.schedule(mix_r, args.seconds, args.seed,
                                     config["model"]["vocab_size"])
    cell = runner.Cell(config, mix, args.seconds, args.seed, args.device)
    cell.items = [it for r in rates for it in scheds[r]]
    n = cell.warm_shapes()
    runner.log(f"{n} shapes warmed", t_proc)
    for r in rates:
        cell.reset()
        sch = cell.engine.scheduler
        marks = {}

        def tick(now, marks=marks):
            for name, at in (("mid", ws_est + args.seconds / 2),
                             ("end", ws_est + args.seconds)):
                if name not in marks and now >= at:
                    marks[name] = (len(sch.queue),
                                   sch.pending_prefill_tokens())
        ws_est = time.perf_counter() + float(mix["warm_s"])
        ws, we = cell.serve(scheds[r], float(mix["warm_s"]), args.seconds,
                            on_tick=tick)
        t_sched0 = ws - float(mix["warm_s"])
        d = cell.driver
        steps = drive.window_steps(d.steps, ws, we)
        dec = [s for s in steps if s.kind == "decode"]
        pre = [s for s in steps if s.kind == "prefill"]
        out = {
            "rate_rps": r,
            "output_tok_s": drive.output_tokens(d.tracks, ws, we)
            / args.seconds,
            "ttft_p95_ms": 1e3 * percentile(drive.ttfts(d.tracks, ws, we),
                                            95),
            "itl_p95_ms": 1e3 * percentile(drive.itls(d.tracks, ws, we), 95),
            "occupancy": (sum(s.live for s in dec)
                          / max(1, len(dec)) / mix["engine"]["max_batch"]),
            "queue_mid_end": [marks.get("mid"), marks.get("end")],
            "due_in_window": sum(1 for it in scheds[r]
                                 if ws <= t_sched0 + it.due < we),
            "decode_step_ms": (1e3 * sum(s.t1 - s.t0 for s in dec)
                               / max(1, len(dec))),
            "prefill_ms_per_ktok": drive.prefill_ms_per_ktok(steps),
            "prefill_share": (sum(s.t1 - s.t0 for s in pre)
                              / args.seconds),
            "dropped": int(cell.engine.executor.dropped),
            "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                         if args.device != "cpu" else None),
        }
        print(json.dumps(out), flush=True)
    torch.cuda.synchronize() if args.device != "cpu" else None
    return 0


if __name__ == "__main__":
    sys.exit(main())
