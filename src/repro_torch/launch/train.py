"""Training launcher (counterpart of ``src/repro/launch/train.py``).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        [--reduced] [--steps 50] [--batch 8] [--seq 64] [--lr 3e-3] \\
        [--ckpt-dir DIR [--resume]] [--compress-grads] [--device cuda|cpu]

The reference's settings: S = 2 expert servers for an MoE (its pool), no
remat, cross-entropy chunks of ``min(64, seq)``, AdamW under a cosine
schedule with 10 warm-up steps, the synthetic bigram stream (seed 0), an
asynchronous checkpoint every 20 steps.  It trains on the card (``--device
cuda``, the default: the hand-written kernels and their backward kernels)
and exits with an error when there is none; ``--device cpu`` runs the
plain versions and forces ``--reduced``, as the reference forces reduced
configs on a CPU backend.  The full MoE configs do not fit one card
(AdamW's moments alone are 8 bytes a parameter).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.core.moe_layer import default_runtime
from repro_torch.models.transformer import TrainCtx, build_model
from repro_torch.training.checkpoint import (AsyncCheckpointer, latest_step,
                                             restore_checkpoint)
from repro_torch.training.data import synthetic_lm_batches
from repro_torch.training.optimizer import adamw, cosine_schedule
from repro_torch.training.train_loop import init_train_state, make_train_step

CHECKPOINT_EVERY = 20


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="granite-3-2b", choices=sorted(REGISTRY))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the hand-written kernels on the card (an "
                         "error without one); cpu: their plain versions, "
                         "reduced configs only")
    return ap


def run(args: argparse.Namespace) -> List[dict]:
    """Train as the flags say; returns the logged steps (step, loss,
    grad_norm)."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port trains on the GPU — pass "
                         "--device cpu (reduced configs) to run the kernels' "
                         "plain versions")
    cfg = get_config(args.arch)
    if args.reduced or args.device == "cpu":
        cfg = cfg.reduced()
    dev = torch.device(args.device)
    S = 2 if cfg.moe else 1
    # the reference's pool: S servers, no replicas
    model = build_model(cfg, S, np.zeros((S, 0), np.int32), dev)
    rt = (default_runtime(cfg, S, args.batch * args.seq, dev) if cfg.moe
          else None)
    ctx = TrainCtx(moe_runtime=rt, remat=False, ce_chunk=min(64, args.seq))
    opt = adamw(lr=cosine_schedule(args.lr, warmup=10, total=args.steps))
    data = synthetic_lm_batches(cfg, args.batch, args.seq, seed=0,
                                device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = init_train_state(model, opt, gen,
                             compression=args.compress_grads)
    start, ck = 0, None
    if args.ckpt_dir:
        ck = AsyncCheckpointer(args.ckpt_dir)
        if args.resume and latest_step(args.ckpt_dir) is not None:
            state, start = restore_checkpoint(args.ckpt_dir, state)
            print(f"resumed at step {start}")
    step = make_train_step(model, opt, ctx, compression=args.compress_grads)
    history = []
    for i in range(start, args.steps):
        state, m = step(state, next(data))
        if i % 10 == 0 or i == args.steps - 1:
            history.append({"step": i, "loss": float(m["loss"]),
                            "grad_norm": float(m["grad_norm"])})
            print(f"step {i:5d}  loss {history[-1]['loss']:.4f}  "
                  f"gnorm {history[-1]['grad_norm']:.3f}", flush=True)
        if ck and (i + 1) % CHECKPOINT_EVERY == 0:
            ck.save(i + 1, state)
    if ck:
        ck.wait()
    return history


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
