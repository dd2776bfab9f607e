"""Whisper's frontend stand-in (counterpart of
``src/repro/models/whisper.py``).

The real model turns 30 s of audio into a log-mel spectrogram and runs two
conv layers that give 1500 frame embeddings.  As in the reference, the
backbone is what is ported: :func:`frame_embeddings` makes seeded
(batch, encoder_seq_len, d_model) inputs.  The encoder-decoder itself is
``models/transformer.py::_build_encdec``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def frame_embeddings(cfg: ModelConfig, batch: int,
                     generator: torch.Generator = None,
                     device=None) -> torch.Tensor:
    """The conv frontend's output stand-in: a standard normal times 0.1,
    (batch, encoder_seq_len, d_model) fp32, drawn from ``generator``.  The
    reference draws it with ``jax.random``, which torch cannot reproduce:
    the same seed gives other frames here, so a comparison of the two
    packages passes the same frames to both."""
    shape = (batch, cfg.encoder_seq_len, cfg.d_model)
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device).mul_(0.1)


def frame_spec(cfg: ModelConfig, batch: int):
    """The frames' (shape, dtype) as the dry-run's inputs give them:
    (batch, encoder_seq_len, d_model) bf16."""
    return (batch, cfg.encoder_seq_len, cfg.d_model), torch.bfloat16
