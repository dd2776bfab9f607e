"""Qwen2-VL frontend stub + M-RoPE position ids (counterpart of
``src/repro/models/vlm.py``).

The ViT patch encoder is a stub: the backbone consumes token embeddings
plus 3-stream M-RoPE position ids.  This module builds the (t, h, w)
position grids for image patches placed in a text sequence — the piece of
Qwen2-VL that interacts with the backbone.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig


def image_mrope_positions(text_len_before: int, grid_h: int, grid_w: int,
                          text_len_after: int, device=None) -> torch.Tensor:
    """(3, seq) int32 position ids for [text, image (h x w patches), text].

    Text tokens advance all three streams together; image patches share one
    temporal position while h / w advance over the grid (Qwen2-VL §2.1).
    """
    i32 = dict(dtype=torch.int32, device=device)
    t0 = text_len_before
    txt0 = torch.arange(t0, **i32)
    pre = torch.stack([txt0, txt0, txt0])
    hh, ww = torch.meshgrid(torch.arange(grid_h, **i32),
                            torch.arange(grid_w, **i32), indexing="ij")
    n_patch = grid_h * grid_w
    img = torch.stack([torch.full((n_patch,), t0, **i32),
                       t0 + hh.reshape(-1), t0 + ww.reshape(-1)])
    # text after the image resumes from the largest position + 1
    t1 = t0 + max(grid_h, grid_w)
    txt1 = torch.arange(t1, t1 + text_len_after, **i32)
    post = torch.stack([txt1, txt1, txt1])
    return torch.cat([pre, img, post], dim=1)


def patch_embeddings(cfg: ModelConfig, batch: int, n_patches: int,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> torch.Tensor:
    """Precomputed ViT patch-embedding stand-in: (B, n_patches, d_model)
    fp32, drawn from ``generator`` (the reference draws from its own
    ``jax.random`` seed, which torch cannot reproduce)."""
    return torch.randn((batch, n_patches, cfg.d_model), generator=generator,
                       dtype=torch.float32, device=device) * 0.1
