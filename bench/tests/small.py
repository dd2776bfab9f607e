"""Small sizes of the benchmark's cells, for runs on the CPU: the cell's
own configuration and traffic mix with every width cut, a few slots,
short prompts and outputs, and an expert buffer that drops nothing."""

from __future__ import annotations

import copy
from pathlib import Path

from harness import runner

ROOT = Path(__file__).resolve().parents[2]


def sizes(workload: str):
    """(configuration, traffic mix) of ``workload`` at the small size."""
    _, _, config, mix = runner.load_cell(ROOT, workload)
    config, mix = copy.deepcopy(config), copy.deepcopy(mix)
    config["model"].update(d_model=256, num_heads=8, num_kv_heads=2,
                           d_head=32, d_ff=384, vocab_size=512,
                           num_experts=8, d_expert=64)
    mix.update(warm_s=0.5, shape_seed=7)
    if mix["kind"] == "open_loop":
        mix["rate_rps"] = 6.0
        # enough greedy requests finish inside a short window to compare
        mix["greedy_share"] = 0.5
    else:
        mix["queue_per_s"] = 20.0
    mix["prompt"].update(median=24, min=8, max=48)
    mix["output"].update(min=16, max=32)
    mix["engine"].update(max_batch=8, prefill_chunk=32,
                         pool_tokens_per_client=256, max_seq=96)
    return config, mix


def run(workload: str, seed: int = 123456789012, seconds: float = 3.0,
        trace: bool = False, plant=None):
    """One run of ``workload`` at the small size on the CPU -> (result
    line's object, notes)."""
    import time
    config, mix = sizes(workload)
    return runner.run(ROOT, workload, seed, seconds, trace,
                      time.perf_counter(), device="cpu", plant=plant,
                      config_override=config, mix_override=mix)
