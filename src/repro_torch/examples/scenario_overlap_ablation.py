"""Overlap-ablation tour: client pipelining on vs. off, chunked prefill
on vs. off, on one seeded bursty trace (paper §4.2 / Fig. 8; counterpart of
``examples/scenario_overlap_ablation.py``).

Four engines replay the *same* flash-crowd scenario under the overlap-aware
virtual clock:

* pipelined decode — two microbatches as independent subgraphs; the clock
  charges ``max(attention, expert) + ε`` per step;
* serialized decode — the same split with the expert round-trip exposed on
  the critical path (the ablation baseline; charged the sum);
* each crossed with chunked prefill (``policy="fair"``: at most one prompt
  chunk between decode steps), which bounds the worst decode gap at the
  price of one ``prefill_base`` per chunk.

Greedy outputs are token-identical across all four — the pipeline and the
chunking change *when* work runs, never *what* it computes.

Run:  PYTHONPATH=src python -m repro_torch.examples.scenario_overlap_ablation \\
          [--device cpu]
Same seed ⇒ identical output, every run, on any machine.
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.configs import get_config
from repro_torch.examples import add_device_flag, resolve, tokens
from repro_torch.serving import (EngineConfig, Scenario, ServingEngine,
                                 VirtualClock)


def run_variant(cfg, name: str, *, params=None, device=None, **kw):
    # dispatch buffers sized for the longest prefill (128 tokens/step) so no
    # variant ever drops a token — greedy outputs stay bitwise comparable;
    # the clock's decode cost is expert-heavy so the overlap term is visible
    ecfg = EngineConfig(mode="eaas", num_servers=4, max_batch=4, max_seq=128,
                        n_redundant=2, pool_tokens_per_client=128, **kw)
    eng = ServingEngine(cfg, ecfg, params=params,
                        clock=VirtualClock(decode_per_token=4e-3),
                        device=device)
    sc = (Scenario(horizon=0.5, seed=0, prompt_len=32, max_new=12,
                   vocab=cfg.vocab_size)
          .bursty(base=20, peak=200, period=0.2, duty=0.3))
    res = sc.run(eng)
    m = res.metrics
    print(f"  {name:22s} {m.decode_throughput:8.1f} tok/s"
          f"   max ITL {m.itl_stats()['max'] * 1e3:7.2f} ms"
          f"   p99 TTFT {m.ttft_stats()['p99'] * 1e3:7.2f} ms")
    return tokens(res.requests), m


def parser() -> argparse.ArgumentParser:
    return add_device_flag(argparse.ArgumentParser(
        prog="python -m repro_torch.examples.scenario_overlap_ablation"))


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    device = resolve(parser().parse_args(argv).device)
    cfg = get_config("deepseek-r1").reduced()
    print("== overlap ablation (bursty trace, long prompts, virtual clock)")
    tokens_, metrics = {}, {}
    for name, kw in (
            ("pipelined", dict(decode_mode="pipelined")),
            ("serialized", dict(decode_mode="serialized")),
            ("pipelined+chunked", dict(decode_mode="pipelined",
                                       prefill_chunk=8, policy="fair")),
            ("serialized+chunked", dict(decode_mode="serialized",
                                        prefill_chunk=8, policy="fair"))):
        tokens_[name], metrics[name] = run_variant(cfg, name, device=device,
                                                   **kw)
    m_pipe, m_ser = metrics["pipelined"], metrics["serialized"]
    m_pc = metrics["pipelined+chunked"]

    ident = all(t == tokens_["pipelined"] for t in tokens_.values())
    print(f"  greedy outputs token-identical across variants: {ident}")
    print(f"  overlap speedup (pipelined / serialized): "
          f"x{m_pipe.decode_throughput / m_ser.decode_throughput:.3f}")
    print(f"  chunking cuts max ITL: "
          f"{m_ser.itl_stats()['max'] * 1e3:.2f} ms -> "
          f"{m_pc.itl_stats()['max'] * 1e3:.2f} ms")
    return {"tokens": tokens_, "metrics": metrics, "identical": ident}


if __name__ == "__main__":
    main()
