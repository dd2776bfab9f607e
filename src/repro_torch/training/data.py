"""Data (counterpart of ``src/repro/training/data.py``): the deterministic
synthetic LM stream and the ShareGPT-like length sampler.  The stream is
drawn with numpy exactly as the reference draws it, so a seed gives the
reference's tokens (and frames); the tensors are then placed on
``device``."""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


def synthetic_lm_batches(cfg: ModelConfig, batch: int, seq: int,
                         seed: int = 0, device="cpu") -> Iterator[Dict]:
    """Infinite stream of {tokens, labels (B, seq) int32[, frames]} with a
    learnable bigram structure (a sparse random transition table makes the
    next token predictable, so training visibly lowers the loss)."""
    rng = np.random.default_rng(seed)
    V = cfg.vocab_size
    fanout = 4
    table = rng.integers(0, V, size=(V, fanout))
    while True:
        toks = np.empty((batch, seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, V, size=batch)
        choices = rng.integers(0, fanout, size=(batch, seq))
        for t in range(seq):
            toks[:, t + 1] = table[toks[:, t], choices[:, t]]
        out = {"tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
               "labels": torch.from_numpy(toks[:, 1:].copy()).to(device)}
        if cfg.is_encoder_decoder:
            frames = rng.standard_normal(
                (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
            out["frames"] = torch.from_numpy(frames).to(device)
        yield out


@dataclasses.dataclass
class ShareGPTLike:
    """Prompt/response length sampler of the paper's workload shape:
    lognormal prompts, responses capped at 768 tokens (paper §5.1)."""

    seed: int = 0
    prompt_mu: float = 5.3       # median ~200 tokens
    prompt_sigma: float = 0.9
    response_mu: float = 5.0     # median ~150 tokens
    response_sigma: float = 0.8
    response_cap: int = 768
    prompt_cap: int = 4096

    def sample(self, n: int) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed)
        p = np.clip(rng.lognormal(self.prompt_mu, self.prompt_sigma, n),
                    1, self.prompt_cap).astype(np.int32)
        r = np.clip(rng.lognormal(self.response_mu, self.response_sigma, n),
                    1, self.response_cap).astype(np.int32)
        return p, r
