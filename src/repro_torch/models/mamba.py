"""Mamba2 block (zamba2's backbone): chunked SSD prefill and the one-step
decode recurrence (counterpart of ``src/repro/models/mamba.py``).

Per head, with a scalar decay (Mamba2's restriction):

    S_t = a_t · S_{t-1} + u_t ⊗ B_t          S: (P, N)
    y_t = S_t · C_t                           y: (P,)

with a_t = exp(dt_t · A) and u_t = dt_t · x_t.  Prefill runs the chunked
form (the quadratic form inside a chunk of Q tokens, the recurrence across
chunks); decode runs the recurrence one token at a time.  As in the
reference: B/C shared by every head (ngroups = 1) and the short causal
conv on x only.

The chunk is the reference's: ``Q = min(chunk, L)``, lowered until it
divides L.  Q sets the fp32 summation order, so the port keeps the rule
exactly; at a prime L it is 1, a per-token scan.  The reference
checkpoints each chunk's body; the port batches the chunks, so under
autograd the whole chunked scan is one checkpoint: the batched
intra-chunk tensors (the (B, nc, Q, Q, H) decay masks among them) are
recomputed in the backward, not saved.  The SSD scan is PyTorch on every
device: the reference computes it in jnp, not in a Pallas kernel.  fp32
islands as in the reference: ``dt`` (softplus), ``u``, B/C, the state and
the gate before the norm's input is rounded to the activations' dtype.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.models.common import (compiled_scan, dense_init,
                                       remat_if_recording, resolve_dtype,
                                       rms_norm)


class MambaState(NamedTuple):
    ssm: torch.Tensor       # ([lead,] B, H, P, N) fp32
    conv: torch.Tensor      # ([lead,] B, K-1, d_inner): trailing conv inputs


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    """(d_inner, heads, head_dim, d_state); heads x head_dim = d_inner."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.head_dim, s.d_state


def init_mamba(cfg: ModelConfig, dtype, device, generator,
               lead=()) -> Dict:
    """The reference's layout and distributions (not its numbers):
    ``in_proj`` projects to z, x, B, C and dt; ``A = -exp(A_log)``."""
    d = cfg.d_model
    d_inner, H, _, N = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    conv = torch.randn((*lead, cfg.ssm.d_conv, d_inner), generator=generator,
                       **f32)
    return {
        "in_proj": dense_init((*lead, d, 2 * d_inner + 2 * N + H), dtype,
                              device, generator),
        "conv_w": conv.mul_(0.1).to(dtype),
        "A_log": torch.zeros((*lead, H), **f32),
        "dt_bias": torch.zeros((*lead, H), **f32),
        "D": torch.ones((*lead, H), **f32),
        "norm_scale": torch.ones((*lead, d_inner), **f32),
        "out_proj": dense_init((*lead, d_inner, d), dtype, device, generator),
    }


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    """(z, x, B, C, dt) of the input projection."""
    d_inner, H, _, N = dims(cfg)
    return torch.split(proj, [d_inner, d_inner, N, N, H], dim=-1)


def _conv(x: torch.Tensor, w: torch.Tensor,
          state: Optional[torch.Tensor] = None):
    """Causal depthwise conv over time, then SiLU in fp32.  x (B, L, D);
    w (K, D); ``state`` the K-1 inputs before x (zeros if None).  Returns
    (out, the K-1 trailing inputs)."""
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    L = x.shape[1]
    out = sum(xp[:, i:i + L] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return F.silu(out.float()).to(x.dtype), new_state


def chunk_size(L: int, chunk: int) -> int:
    """The reference's chunk: ``min(chunk, L)``, lowered until it divides
    L (1 at a prime L above ``chunk``)."""
    Q = min(chunk, L)
    while L % Q:
        Q -= 1
    return Q


def _carry_loop(decay, dS, S):
    """The SSD's carry over chunks: decay (B, nc, H, 1, 1), dS (B, nc, H,
    P, N) from the state S (B, H, P, N) -> (each chunk's starting state
    (B, nc, H, P, N), the last state)."""
    starts = []
    for c in range(decay.shape[1]):
        starts.append(S)
        S = decay[:, c] * S + dS[:, c]
    return torch.stack(starts, dim=1), S


def _ssd_chunked(u, logA, Bm, Cm, S0, chunk: int):
    """Exact chunked SSD scan.

    u (B, L, H, P) dt-scaled inputs; logA (B, L, H) per-step log decay;
    Bm / Cm (B, L, N); S0 (B, H, P, N).  Returns y (B, L, H, P) and the
    final state, both fp32.

    The reference's chunk body, with what does not depend on the carried
    state batched over the chunks: the quadratic form inside each chunk
    and each chunk's state increment.  Only the carry, S' = exp(cum_Q) S
    + dS, runs chunk by chunk (two operations, not a chunk body's ~25:
    Q = 1 at a prime L makes a chunk of every token), through
    ``compiled_scan`` where autograd does not record: on the card a body
    of 64 chunks and one of a chunk, captured once and replayed, bitwise
    the loop (:func:`_carry_loop`).
    """
    Bsz, L, H, P = u.shape
    N = Bm.shape[-1]
    Q = chunk_size(L, chunk)
    nc = L // Q
    u = u.reshape(Bsz, nc, Q, H, P)
    Bc = Bm.reshape(Bsz, nc, Q, N)
    Cc = Cm.reshape(Bsz, nc, Q, N)
    cum = torch.cumsum(logA.reshape(Bsz, nc, Q, H), dim=2)   # inclusive
    ar = torch.arange(Q, device=u.device)
    tri = (ar[:, None] >= ar[None, :])[:, :, None]
    # intra-chunk: y_t += sum_{j<=t} exp(cum_t - cum_j) (C_t·B_j) u_j
    G = torch.einsum("bcqn,bcjn->bcqj", Cc, Bc)
    Mlog = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,c,Q,Q,H)
    M = torch.where(tri, torch.exp(Mlog), 0.0)
    y_intra = torch.einsum("bcqj,bcqjh,bcjhp->bcqhp", G, M, u)
    # the state a chunk adds: sum_j exp(cum_Q - cum_j) u_j ⊗ B_j
    wj = torch.exp(cum[:, :, -1:, :] - cum)
    dS = torch.einsum("bcqh,bcqhp,bcqn->bchpn", wj, u, Bc)
    decay = torch.exp(cum[:, :, -1, :])[..., None, None]     # (B,c,H,1,1)
    starts, S = compiled_scan("ssd_carry", _carry_loop, (decay, dS), (),
                              S0.float())
    # inter-chunk: y_t += exp(cum_t) C_t · S (the chunk's starting state)
    y_inter = torch.einsum("bcqh,bcqn,bchpn->bcqhp", torch.exp(cum), Cc,
                           starts)
    return (y_intra + y_inter).reshape(Bsz, L, H, P), S


def _ssd_scan_ref(u, logA, Bm, Cm, S0):
    """The per-step scan, the chunked form's oracle."""
    S = S0.float()
    ys = []
    for t in range(u.shape[1]):
        S = (torch.exp(logA[:, t])[:, :, None, None] * S
             + torch.einsum("bhp,bn->bhpn", u[:, t], Bm[:, t]))
        ys.append(torch.einsum("bhpn,bn->bhp", S, Cm[:, t]))
    return torch.stack(ys, dim=1), S


def _in_proj(params: Dict, x: torch.Tensor, tp):
    """The whole input projection and conv weight: ``x @ in_proj``, or
    under a layout (``in_proj`` column-parallel, ``conv_w`` cut over its
    channels; neither cut lines up with the [z, x, B, C, dt] segments)
    this rank's columns gathered to every column, the mixer then run whole
    on every rank (a gather's backward takes this rank's block)."""
    if tp is None:
        return x @ params["in_proj"], params["conv_w"]
    proj = tpl.col_linear(x, params["in_proj"], tp.model)
    return (tpl.gather(proj, -1, tp.model),
            tpl.gather(params["conv_w"], -1, tp.model))


def _gate_out(params: Dict, cfg: ModelConfig, y: torch.Tensor,
              z: torch.Tensor, dtype, tp=None) -> torch.Tensor:
    """y · silu(z) in fp32, rounded to the activations' dtype, gated RMS
    norm, output projection (row-parallel under a layout: this rank's
    ``d_inner`` columns, whole heads, times its rows, summed)."""
    y = y * F.silu(z.float())
    y = rms_norm(y.to(dtype), params["norm_scale"], cfg.rms_norm_eps)
    if tp is None:
        return y @ params["out_proj"]
    return tpl.row_linear(tpl.split(y, -1, tp.model), params["out_proj"],
                          tp.model)


def mamba_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                  state: Optional[MambaState] = None, *, chunk: int = 64,
                  use_ref_scan: bool = False, tp=None
                  ) -> Tuple[torch.Tensor, MambaState]:
    """Full-sequence forward (prefill).  x (B, L, d_model); ``state`` the
    recurrence to continue (zeros if None); ``tp`` a dense
    :class:`~repro_torch.distributed.tensor_parallel.Layout` whose
    ``in_proj`` / ``conv_w`` / ``out_proj`` are this rank's cuts.  Returns
    (out, new state)."""
    Bsz, L, _ = x.shape
    d_inner, H, P, N = dims(cfg)
    proj, conv_w = _in_proj(params, x, tp)
    z, xs, Bm, Cm, dt = _split_proj(cfg, proj)
    xs, conv_state = _conv(xs, conv_w,
                           None if state is None else state.conv)
    dt = F.softplus(dt.float() + params["dt_bias"])          # (B, L, H)
    logA = dt * -torch.exp(params["A_log"])
    xh = xs.reshape(Bsz, L, H, P).float()
    u = xh * dt[..., None]
    S0 = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
          if state is None else state.ssm)
    if use_ref_scan:
        y, S = _ssd_scan_ref(u, logA, Bm.float(), Cm.float(), S0)
    else:
        y, S = remat_if_recording(_ssd_chunked, u, logA, Bm.float(),
                                  Cm.float(), S0, chunk)
    y = y + params["D"][None, None, :, None] * xh
    out = _gate_out(params, cfg, y.reshape(Bsz, L, d_inner), z, x.dtype, tp)
    return out, MambaState(ssm=S, conv=conv_state)


def mamba_decode(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                 state: MambaState, tp=None
                 ) -> Tuple[torch.Tensor, MambaState]:
    """One-token decode.  x (B, 1, d_model); ``tp`` as
    :func:`mamba_forward`'s.  Returns (out, new state)."""
    Bsz = x.shape[0]
    d_inner, H, P, N = dims(cfg)
    proj, conv_w = _in_proj(params, x, tp)
    z, xs, Bm, Cm, dt = _split_proj(cfg, proj)
    xs, conv_state = _conv(xs, conv_w, state.conv)
    dt = F.softplus(dt.float() + params["dt_bias"])[:, 0]   # (B, H)
    a = torch.exp(dt * -torch.exp(params["A_log"]))
    xh = xs.reshape(Bsz, H, P).float()
    u = xh * dt[..., None]
    S = (a[:, :, None, None] * state.ssm
         + torch.einsum("bhp,bn->bhpn", u, Bm[:, 0].float()))
    y = torch.einsum("bhpn,bn->bhp", S, Cm[:, 0].float())
    y = y + params["D"][None, :, None] * xh
    out = _gate_out(params, cfg, y.reshape(Bsz, 1, d_inner), z, x.dtype, tp)
    return out, MambaState(ssm=S, conv=conv_state)


def init_mamba_state(cfg: ModelConfig, batch: int, device,
                     lead=()) -> MambaState:
    """Zero states, stacked over ``lead`` layer axes: the ssm state in
    fp32, the conv tail in the config's dtype."""
    d_inner, H, P, N = dims(cfg)
    K = cfg.ssm.d_conv
    return MambaState(
        ssm=torch.zeros((*lead, batch, H, P, N), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((*lead, batch, K - 1, d_inner),
                         dtype=resolve_dtype(cfg.dtype), device=device))
