"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE."""

from __future__ import annotations

from typing import Tuple

import torch


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., seq) int -> cos, sin (..., seq, head_dim // 2)."""
    inv = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate pairs (x[..., ::2], x[..., 1::2]); x (..., seq, heads, hd)."""
    xf = x.float()
    x1, x2 = xf[..., ::2], xf[..., 1::2]
    cos, sin = cos[..., :, None, :], sin[..., :, None, :]
    out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def mrope_cos_sin(positions_thw: torch.Tensor, head_dim: int, theta: float,
                  sections: Tuple[int, ...]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE.

    positions_thw (3, ..., seq) int — temporal / height / width ids;
    ``sections`` partitions the head_dim // 2 frequency slots into (t, h, w)
    groups, each rotating by its own stream.  Returns cos, sin
    (..., seq, head_dim // 2).
    """
    if sum(sections) != head_dim // 2:
        raise ValueError(f"M-RoPE sections {sections} must sum to "
                         f"head_dim // 2 = {head_dim // 2}")
    inv = rope_freqs(head_dim, theta, positions_thw.device)
    ang = positions_thw.float()[..., None] * inv        # (3, ..., seq, hd/2)
    # filled on the device from host ints: no upload, no sync (a CUDA
    # graph captures it; meta runs it)
    sec_id = torch.cat([torch.full((n,), i, dtype=torch.int64,
                                   device=positions_thw.device)
                        for i, n in enumerate(sections)])
    # each frequency slot takes its own stream's angle
    ang = torch.movedim(ang, 0, -1).gather(
        -1, sec_id.expand(*ang.shape[1:-1], -1)[..., None])[..., 0]
    return torch.cos(ang), torch.sin(ang)


def text_mrope_positions(positions: torch.Tensor) -> torch.Tensor:
    """For pure-text tokens all three M-RoPE streams share the position."""
    return positions[None].expand(3, *positions.shape)
