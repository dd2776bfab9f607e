"""The plain reference of a decoder with grouped-query attention and
mixture-of-experts FFNs (DeepSeek-V3/R1 as the port runs it, Snowflake
Arctic), in float32.

Per layer, on the residual stream x (the published pre-norm block):

    h = rmsnorm(x) * ln1
    x = x + attention(h)     causal GQA over every earlier position, RoPE
                             on the interleaved pairs of q and k
    h = rmsnorm(x) * ln2
    x = x + ffn(h)           a dense SwiGLU, or
                             sum_k score_k * expert_k(h)  (top-k of the
                             router's sigmoid or softmax, renormalised)
                             + shared(h) (DeepSeek) + residual(h) (Arctic)

then logits = (rmsnorm(x) * final_ln) @ head.  Every matmul runs in
float32 with TF32 off; ``cast`` turns each stored weight into the float32
matrix used (the identity's upcast for the reference; a lower precision
for the control).  Attention is computed in query blocks so that a long
sequence fits.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch
import torch.nn.functional as F

Cast = Callable[[torch.Tensor], torch.Tensor]


def upcast(w: torch.Tensor) -> torch.Tensor:
    """The reference's cast: the stored weight, exactly, in float32."""
    return w.float()


def fp8_cast(w: torch.Tensor) -> torch.Tensor:
    """The control's cast: float8 e4m3 with one scale per output column
    (per row of an embedding gather, whose columns are the features)."""
    wf = w.float()
    scale = wf.abs().amax(dim=0, keepdim=True).clamp(min=1e-12) / 448.0
    q = wf.div_(scale).to(torch.float8_e4m3fn)
    del wf
    return q.float().mul_(scale)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, heads, hd) rotated by position: pairs (2i, 2i + 1) turn by
    pos * theta ** (-2i / hd)."""
    hd = x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = (pos.double()[:, None] * inv[None]).float()[:, None, :]
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = x[..., 0::2], x[..., 1::2]
    return torch.stack([a * c - b * s, b * c + a * s], -1).reshape(x.shape)


def _attention(h: torch.Tensor, L: Dict, m: dict, cast: Cast,
               q_block: int) -> torch.Tensor:
    S = h.shape[0]
    H, KV, hd = m["num_heads"], m["num_kv_heads"], m["d_head"]
    pos = torch.arange(S, device=h.device)
    q = _rope((h @ cast(L["wq"])).reshape(S, H, hd), pos, m["rope_theta"])
    k = _rope((h @ cast(L["wk"])).reshape(S, KV, hd), pos, m["rope_theta"])
    v = (h @ cast(L["wv"])).reshape(S, KV, hd)
    g = H // KV
    k = k.repeat_interleave(g, dim=1).transpose(0, 1)      # (H, S, hd)
    v = v.repeat_interleave(g, dim=1).transpose(0, 1)
    out = torch.empty(S, H, hd, device=h.device)
    for i in range(0, S, q_block):
        j = min(S, i + q_block)
        qi = q[i:j].transpose(0, 1)                          # (H, n, hd)
        sc = qi @ k[:, :j].transpose(1, 2) / math.sqrt(hd)   # (H, n, j)
        mask = pos[:j][None, :] > pos[i:j][:, None]
        sc = sc.masked_fill(mask[None], float("-inf"))
        out[i:j] = (torch.softmax(sc, -1) @ v[:, :j]).transpose(0, 1)
    return out.reshape(S, H * hd) @ cast(L["wo"])


def _swiglu(h: torch.Tensor, w: Dict, cast: Cast) -> torch.Tensor:
    return (F.silu(h @ cast(w["w_gate"])) * (h @ cast(w["w_up"]))) \
        @ cast(w["w_down"])


def _moe(h: torch.Tensor, L: Dict, m: dict, cast: Cast) -> torch.Tensor:
    logits = h @ L["router"].float()
    probs = (torch.sigmoid(logits) if m["router_score_fn"] == "sigmoid"
             else torch.softmax(logits, -1))
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :m["top_k"]], ids[:, :m["top_k"]]
    if m["normalize_topk"]:
        vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    y = torch.zeros_like(h)
    per, ex = L["per_server"], L["experts"]
    for e in torch.unique(ids).tolist():
        rows, slot = (ids == e).nonzero(as_tuple=True)
        w = {k: v[e // per, e % per] for k, v in ex.items()}
        y.index_add_(0, rows, vals[rows, slot][:, None]
                     * _swiglu(h[rows], w, cast))
    for extra in ("shared", "residual"):
        if extra in L:
            y = y + _swiglu(h, L[extra], cast)
    return y


@torch.no_grad()
def logits_at(W: Dict, m: dict, seqs: Sequence[torch.Tensor],
              at: Sequence[torch.Tensor], cast: Cast = upcast,
              q_block: int = 256) -> List[torch.Tensor]:
    """Float32 logits (len(at[i]), V) of sequence ``seqs[i]`` (int64 on the
    weights' device) at its positions ``at[i]``.  ``W`` is the plain view
    of the weights (one dict per layer); ``m`` the configuration's model
    sizes.  All sequences go through each layer together, so each expert's
    weights are cast once a layer."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        lens = [len(s) for s in seqs]
        # an embedding gather is cast per row: its columns are features
        x = torch.cat([cast(W["embed"][s].T).T for s in seqs])
        eps = m["rms_norm_eps"]
        for L in W["layers"]:
            h = _rms(x, L["ln1"], eps)
            parts = torch.split(h, lens)
            x = x + torch.cat([_attention(p, L, m, cast, q_block)
                               for p in parts])
            h = _rms(x, L["ln2"], eps)
            x = x + (_swiglu(h, L["mlp"], cast) if "mlp" in L
                     else _moe(h, L, m, cast))
        head = cast(W["head"])
        out, off = [], 0
        for n, pos in zip(lens, at):
            rows = _rms(x[off + pos], W["final_ln"], eps)
            out.append(rows @ head)
            off += n
        return out
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
