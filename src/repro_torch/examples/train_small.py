"""Train a small MoE LM end-to-end with the EAAS expert tier in the loss
path (counterpart of ``examples/train_small.py``), demonstrating the
training substrate: Adafactor/AdamW, gradient clipping, int8 gradient
compression with error feedback, async fault-tolerant checkpointing,
restart-resume.

Default config is CI-sized (~3M params, 60 steps); ``--full`` trains a
~100M-param model for 300 steps.  The step is compiled where the
reference jits it (``train_loop.compile_train_step``: one CUDA graph on the
card, captured at the second step; its backward runs the grouped GEMM's
dx / dw kernels), and ``--restore`` restores into the live state, so a
resumed run keeps the graph.  Checkpoints (the reference's on-disk format)
go to ``experiments/ckpt_train_small_torch/`` in the checkout.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_small [--full] \\
          [--restore] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.moe_layer import default_runtime
from repro_torch.examples import add_device_flag, resolve
from repro_torch.models.transformer import TrainCtx, build_model
from repro_torch.training.checkpoint import (AsyncCheckpointer, latest_step,
                                             restore_checkpoint)
from repro_torch.training.data import synthetic_lm_batches
from repro_torch.training.optimizer import adamw, cosine_schedule
from repro_torch.training.train_loop import (compile_train_step,
                                             init_train_state,
                                             make_train_step)

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                        "experiments", "ckpt_train_small_torch")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.train_small")
    ap.add_argument("--full", action="store_true",
                    help="~100M params, 300 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    return add_device_flag(ap)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    args = parser().parse_args(argv)
    dev = resolve(args.device)

    base = get_config("kimi-k2-1t-a32b").reduced()
    if args.full:
        cfg = base.replace(num_layers=8, d_model=512, num_heads=8,
                           num_kv_heads=4, d_head=64, d_ff=1024,
                           vocab_size=32768)
        cfg = cfg.replace(moe=cfg.moe and base.moe.__class__(
            num_experts=16, top_k=2, d_expert=1024, num_shared_experts=1,
            first_k_dense=1))
        steps = args.steps or 300
        batch, seq = 8, 256
    else:
        cfg = base
        steps = args.steps or 60
        batch, seq = 8, 64

    S = 4
    # the reference's pool: S servers, no replicas
    model = build_model(cfg, S, np.zeros((S, 0), np.int32), dev)
    n_params = cfg.num_params()
    print(f"training {cfg.arch_id}: ~{n_params/1e6:.1f}M params, "
          f"{steps} steps, batch {batch} × seq {seq}")

    rt = default_runtime(cfg, S, batch * seq, dev)
    ctx = TrainCtx(remat=False, moe_runtime=rt, ce_chunk=64)
    opt = adamw(lr=cosine_schedule(3e-3, warmup=20, total=steps))
    data = synthetic_lm_batches(cfg, batch, seq, seed=0, device=dev)

    ckpt = AsyncCheckpointer(CKPT_DIR, keep=2)
    state = init_train_state(model, opt,
                             torch.Generator(device=dev).manual_seed(0),
                             compression=args.compress_grads)
    start = 0
    if args.restore and latest_step(CKPT_DIR) is not None:
        state, start = restore_checkpoint(CKPT_DIR, state, into=True)
        print(f"resumed from checkpoint step {start}")

    step_fn = compile_train_step(make_train_step(
        model, opt, ctx, compression=args.compress_grads), dev)
    first = last = None
    history = []
    for i in range(start, steps):
        state, m = step_fn(state, next(data))
        loss = float(m["loss"])
        first = first if first is not None else loss
        last = loss
        history.append({"step": i, "loss": loss,
                        "grad_norm": float(m["grad_norm"]),
                        "dropped": int(m["dropped"])})
        if i % 10 == 0 or i == steps - 1:
            print(f"step {i:4d}  loss {loss:.4f}  "
                  f"gnorm {history[-1]['grad_norm']:.3f}  "
                  f"dropped {history[-1]['dropped']}")
        if (i + 1) % 25 == 0:
            ckpt.save(i + 1, state)
    ckpt.wait()
    print(f"loss {first:.3f} -> {last:.3f}")
    assert last < first, "training must reduce loss"
    print("train_small OK")
    return {"history": history, "state": state, "step_fn": step_fn,
            "start": start}


if __name__ == "__main__":
    main()
