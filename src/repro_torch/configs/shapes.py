"""Assigned input shapes (the port's own copy of the reference's
``configs/shapes.py``: pure data).

Every LM-family architecture is exercised on the same four shapes.
``decode_*`` and ``long_*`` are one new token against a KV cache of
``seq_len``, not a train step.  ``long_500k`` requires sub-quadratic
attention and is skipped for pure full-attention archs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

ALL_SHAPES: Tuple[InputShape, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                      LONG_500K)


def shape_by_name(name: str) -> InputShape:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}; have {[s.name for s in ALL_SHAPES]}")


def applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) is a valid cell; the reason if not."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k skipped: pure full-attention arch"
    return True, ""


def reduced_shape(shape: InputShape) -> InputShape:
    """CPU-sized version of a shape for smoke tests."""
    return InputShape(
        name=shape.name + "-reduced",
        seq_len=min(shape.seq_len, 64),
        global_batch=min(shape.global_batch, 4),
        kind=shape.kind,
    )
