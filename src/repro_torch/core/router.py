"""MoE gating: softmax / sigmoid scoring, top-k, aux losses (fp32)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.types import RouterOutput


def count_ids(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.bincount(ids, minlength=n)[:n]`` for ids >= 0 (ids past
    ``n - 1`` not counted) as an int64 ``scatter_add_`` into ``n + 1``
    bins: exact counts, and defined on ``meta`` tensors (bincount is
    not)."""
    flat = ids.reshape(-1).long().clamp(max=n)
    return torch.zeros(n + 1, dtype=torch.int64,
                       device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))[:n]


def init_router(d_model: int, num_experts: int, device, generator,
                lead=()) -> Dict:
    w = torch.randn((*lead, d_model, num_experts), generator=generator,
                    dtype=torch.float32, device=device)
    return {"w_router": w.mul_(0.02)}


def top_k(probs: torch.Tensor, k: int):
    """Top-k with ties broken toward the lower index, as ``jax.lax.top_k``
    does (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(params: Dict, x: torch.Tensor, cfg: MoEConfig,
          bias: Optional[torch.Tensor] = None) -> RouterOutput:
    """x (T, d) -> RouterOutput over cfg.num_experts with cfg.top_k.

    ``bias``: optional (E,) fp32 logit offset added before scoring (the
    scenario's traffic shaping, ``set_skew``); zeros reproduce the unbiased
    router bit for bit."""
    logits = x.float() @ params["w_router"]                  # (T, E)
    if bias is not None:
        logits = logits + bias.float()
    if cfg.router_score_fn == "softmax":
        probs = torch.softmax(logits, dim=-1)
    elif cfg.router_score_fn == "sigmoid":
        probs = torch.sigmoid(logits)
    else:
        raise ValueError(cfg.router_score_fn)
    scores, expert_ids = top_k(probs, cfg.top_k)
    if cfg.normalize_topk:
        scores = scores / scores.sum(dim=-1, keepdim=True).clamp(min=1e-9)

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    E = probs.shape[1]
    f = count_ids(expert_ids[:, 0], E).float() / probs.shape[0]
    aux = E * torch.sum(f * probs.mean(dim=0)) * cfg.router_aux_loss_coef
    lse = torch.logsumexp(logits, dim=-1)
    z = lse.square().mean() * cfg.router_z_loss_coef
    return RouterOutput(expert_ids=expert_ids, scores=scores,
                        full_probs=probs, aux_loss=aux, z_loss=z)


def expert_load(expert_ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Token count per expert (the load balancer's statistic)."""
    return count_ids(expert_ids, num_experts)
