"""RWKV-6 "Finch" block (rwkv6-7b): attention-free time-mix with a
data-dependent decay, and a squared-ReLU channel-mix (counterpart of
``src/repro/models/rwkv.py``).

Per head (key dim D = value dim D), state S (D, D):

    y_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t

with w_t = exp(-exp(w0 + tanh(x_w A) B)), Finch's per-channel decay.  As
in the reference, prefill batches the r / k / v / g projections and the
decay over the whole sequence and loops over tokens only for the wkv
recurrence; the token-shift mixes are static.  The recurrence is PyTorch
on every device: the reference computes it in jnp, not in a Pallas kernel.
Where autograd does not record, the reference's ``lax.scan`` body,
compiled once, is a CUDA graph of 64 tokens of the loop (and one of a
token, for the rest), captured once and replayed
(``common.compiled_scan``).
Under autograd it runs in chunks of Q tokens (the reference's ``chunk``
and its rule, ``mamba.chunk_size``), each chunk checkpointed as the
reference's ``jax.checkpoint(chunk_body)``: the backward keeps a chunk's
incoming state, not three (B, H, D, D) states a token.

Precision follows the reference's type promotion: the shift mixes ``mu``
are fp32, so a mixed bf16 activation is fp32 and its r / k / v / g (and
the channel-mix's k / r) products are fp32 products with the weights
widened (``_mm``); the wkv state, the decay (``decay_A`` / ``decay_B``)
and the group norm are fp32; the channel-mix rounds k to the activations'
dtype before ``w_v``, and the time-mix its output before ``w_o``.

:func:`rwkv_block_spmd` is the reference's tensor-parallel layer on a
mesh: every projection column-sharded over the model axis (the wkv state's
heads with them), ``w_o`` and the channel-mix ``w_v`` row-parallel with
one ``all_reduce`` each (``sharding_rules.ISLAND_PLACEMENTS`` is its
layout), and autograd-aware (training runs it).  The sharding table
matches the time-mix ``w_v`` as row-parallel; the port cuts it as the
island takes it, column-parallel, when the params are sharded
(``sharding_rules.placement_of``).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.kernels import meta
from repro_torch.models.common import (compiled_scan, dense_init, records,
                                       remat_if_recording, resolve_dtype,
                                       rms_norm)
from repro_torch.models.mamba import chunk_size


class RwkvState(NamedTuple):
    wkv: torch.Tensor          # ([lead,] B, H, D, D) fp32
    shift_tmix: torch.Tensor   # ([lead,] B, d) last token seen by time-mix
    shift_cmix: torch.Tensor   # ([lead,] B, d) last token seen by channel-mix


def dims(cfg: ModelConfig) -> Tuple[int, int]:
    """(heads, head_dim)."""
    D = cfg.ssm.head_dim if cfg.ssm else cfg.head_dim
    return cfg.d_model // D, D


def init_rwkv_tmix(cfg: ModelConfig, dtype, device, generator,
                   lead=()) -> Dict:
    """The reference's layout and distributions (not its numbers)."""
    d = cfg.d_model
    H, D = dims(cfg)
    lora = max(32, d // 64)
    f32 = dict(dtype=torch.float32, device=device)
    p = {"mu": torch.rand((*lead, 5, d), generator=generator, **f32)}
    for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
        p[name] = dense_init((*lead, d, d), dtype, device, generator)
    p.update(
        decay_w0=torch.full((*lead, d), -6.0, **f32),
        decay_A=dense_init((*lead, d, lora), torch.float32, device,
                           generator),
        decay_B=dense_init((*lead, lora, d), torch.float32, device,
                           generator),
        bonus_u=torch.zeros((*lead, H, D), **f32),
        ln_scale=torch.ones((*lead, d), **f32))
    return p


def init_rwkv_cmix(cfg: ModelConfig, dtype, device, generator,
                   lead=()) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu": torch.rand((*lead, 2, d), generator=generator,
                         dtype=torch.float32, device=device),
        "w_k": dense_init((*lead, d, f), dtype, device, generator),
        "w_v": dense_init((*lead, f, d), dtype, device, generator),
        "w_r": dense_init((*lead, d, d), dtype, device, generator),
    }


def _mix(x, prev, mu):
    """Token shift: lerp between the current and the previous token (fp32
    when ``mu`` is, as the reference promotes)."""
    return x + (prev - x) * mu


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with the reference's promotion: a wider ``x`` widens
    ``w``."""
    return x @ (w if w.dtype == x.dtype else w.to(x.dtype))


def _decay(params: Dict, xw: torch.Tensor) -> torch.Tensor:
    """Finch's data-dependent decay, (..., d) in (0, 1), fp32."""
    lo = torch.tanh(xw.float() @ params["decay_A"]) @ params["decay_B"]
    return torch.exp(-torch.exp(params["decay_w0"] + lo))


def _group_norm_out(params: Dict, y: torch.Tensor, g: torch.Tensor,
                    dtype) -> torch.Tensor:
    """Per-head RMS norm of y (..., H, D), scale, gate, rounding to the
    activations' dtype, output projection."""
    y = y * torch.rsqrt(y.square().mean(dim=-1, keepdim=True) + 1e-6)
    y = y.reshape(*y.shape[:-2], -1) * params["ln_scale"] * g
    return y.to(dtype) @ params["w_o"]


def _projections(params: Dict, x: torch.Tensor, prev: torch.Tensor, H: int,
                 D: int):
    """r, k, v (..., H, D) and the gate g (..., d) in fp32, and the decay
    w (..., H, D), from x and its shifted copy ``prev``."""
    mu = params["mu"]
    lead = x.shape[:-1]
    r, k, v = (_mm(_mix(x, prev, mu[i]), params[w]).reshape(*lead, H, D)
               .float() for i, w in enumerate(("w_r", "w_k", "w_v")))
    g = F.silu(_mm(_mix(x, prev, mu[4]), params["w_g"]).float())
    w = _decay(params, _mix(x, prev, mu[3])).reshape(*lead, H, D)
    return r, k, v, g, w


def _wkv_step(S, r, k, v, w, u):
    """One token of the recurrence: r / k / v / w (B, H, D), S (B, H, D, D)
    -> (S', y (B, H, D))."""
    kv = k[..., :, None] * v[..., None, :]
    y = (r[..., None, :] @ (S + u[None, :, :, None] * kv))[..., 0, :]
    return w[..., None] * S + kv, y


def _tmix_step(params: Dict, cfg: ModelConfig, S: torch.Tensor,
               prev_x: torch.Tensor, x_t: torch.Tensor):
    """One time-mix token.  x_t (B, d).  Returns (S', y_t)."""
    H, D = dims(cfg)
    r, k, v, g, w = _projections(params, x_t, prev_x, H, D)
    S, y = _wkv_step(S, r, k, v, w, params["bonus_u"])
    return S, _group_norm_out(params, y, g, x_t.dtype)


def _wkv_loop(r, k, v, w, u, S):
    """The recurrence token by token: r / k / v / w (B, T, H, D) from the
    state S -> (y (B, T, H, D), the last state), as ``meta.wkv``."""
    ys = []
    for t in range(r.shape[1]):
        S, y = _wkv_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def _recurrence(loop, r, k, v, w, u, S, chunk: int):
    """``loop`` (:func:`_wkv_loop`, or ``meta.wkv`` on ``meta``) over the
    sequence: where autograd does not record, one pass through
    ``compiled_scan`` (the reference's ``lax.scan`` of its compiled
    ``chunk_body``: on the card a 64-token and a 1-token body captured
    once and replayed, bitwise the loop; the plain loop on ``meta`` and
    under ``eager()``); under autograd chunk by chunk,
    ``chunk_size(L, chunk)`` tokens each, every chunk checkpointed.
    Returns (y, the last state)."""
    if not records(r, k, v, w, u, S):
        return compiled_scan("wkv", loop, (r, k, v, w), (u,), S)
    Q, ys = chunk_size(r.shape[1], chunk), []
    for c in range(0, r.shape[1], Q):
        sl = slice(c, c + Q)
        y, S = remat_if_recording(loop, r[:, sl], k[:, sl], v[:, sl],
                                  w[:, sl], u, S)
        ys.append(y)
    return torch.cat(ys, dim=1), S


def tmix_forward(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                 state: RwkvState, *, chunk: int = 64
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence time-mix.  x (B, L, d).  The projections and the decay
    run over the whole sequence, the wkv recurrence token by token (without
    grad, its body replayed from a CUDA graph on the card:
    :func:`_recurrence`).  Under
    autograd the recurrence runs chunk by chunk, Q = ``chunk_size(L,
    chunk)`` tokens each, every chunk checkpointed (its incoming state and
    its slices of r / k / v / w kept; its per-token states recomputed in
    the backward); the values do not depend on Q.  Without grad one pass
    over the sequence.  On ``meta`` tensors (the dry-run's accounting) the
    recurrence of a pass or a chunk is one op, ``kernels/meta.py``'s
    ``wkv``, counted as the loop's matmuls.  Returns (y, wkv state', last
    token)."""
    _, D = dims(cfg)
    H = params["w_r"].shape[1] // D
    shifted = torch.cat([state.shift_tmix.to(x.dtype)[:, None], x[:, :-1]],
                        dim=1)
    r, k, v, g, w = _projections(params, x, shifted, H, D)
    S, u = state.wkv, params["bonus_u"]
    y, S = _recurrence(meta.wkv if x.device.type == "meta" else _wkv_loop,
                       r, k, v, w, u, S, chunk)
    out = _group_norm_out(params, y, g, x.dtype)
    return out, S, x[:, -1]


def cmix_forward(params: Dict, x: torch.Tensor, prev_token: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-mix over a sequence.  x (B, L, d); prev_token (B, d)."""
    shifted = torch.cat([prev_token[:, None].to(x.dtype), x[:, :-1]], dim=1)
    xk = _mix(x, shifted, params["mu"][0])
    xr = _mix(x, shifted, params["mu"][1])
    k = torch.square(F.relu(_mm(xk, params["w_k"]).float()))
    v = k.to(x.dtype) @ params["w_v"]
    r = torch.sigmoid(_mm(xr, params["w_r"]).float())
    return (r * v.float()).to(x.dtype), x[:, -1]


def rwkv_block_forward(tparams: Dict, cparams: Dict, cfg: ModelConfig,
                       x: torch.Tensor, state: RwkvState,
                       norms: Tuple[torch.Tensor, torch.Tensor], *,
                       chunk: int = 64) -> Tuple[torch.Tensor, RwkvState]:
    """One RWKV layer over a sequence (pre-norm residuals); ``chunk`` as
    :func:`tmix_forward`'s."""
    n1, n2 = norms
    h = rms_norm(x, n1, cfg.rms_norm_eps)
    y, S, prev_t = tmix_forward(tparams, cfg, h, state, chunk=chunk)
    x = x + y
    y2, prev_c = cmix_forward(cparams, rms_norm(x, n2, cfg.rms_norm_eps),
                              state.shift_cmix)
    return x + y2, RwkvState(wkv=S, shift_tmix=prev_t, shift_cmix=prev_c)


def rwkv_block_decode(tparams: Dict, cparams: Dict, cfg: ModelConfig,
                      x: torch.Tensor, state: RwkvState,
                      norms: Tuple[torch.Tensor, torch.Tensor]
                      ) -> Tuple[torch.Tensor, RwkvState]:
    """One-token decode through a layer.  x (B, 1, d)."""
    n1, n2 = norms
    h = rms_norm(x, n1, cfg.rms_norm_eps)[:, 0]
    S, y = _tmix_step(tparams, cfg, state.wkv, state.shift_tmix, h)
    x = x + y[:, None]
    y2, prev_c = cmix_forward(cparams, rms_norm(x, n2, cfg.rms_norm_eps),
                              state.shift_cmix)
    return x + y2, RwkvState(wkv=S, shift_tmix=h, shift_cmix=prev_c)


def init_rwkv_state(cfg: ModelConfig, batch: int, device,
                    lead=()) -> RwkvState:
    """Zero states stacked over ``lead`` layer axes: wkv in fp32, the
    shifts in the config's dtype."""
    H, D = dims(cfg)
    dt = resolve_dtype(cfg.dtype)
    return RwkvState(
        wkv=torch.zeros((*lead, batch, H, D, D), dtype=torch.float32,
                        device=device),
        shift_tmix=torch.zeros((*lead, batch, cfg.d_model), dtype=dt,
                               device=device),
        shift_cmix=torch.zeros((*lead, batch, cfg.d_model), dtype=dt,
                               device=device))


def rwkv_block_spmd(tparams: Dict, cparams: Dict, cfg: ModelConfig,
                    x: torch.Tensor, state: RwkvState,
                    norms: Tuple[torch.Tensor, torch.Tensor], group
                    ) -> Tuple[torch.Tensor, RwkvState]:
    """One tensor-parallel RWKV layer over a sequence, on this rank's
    slices (``sharding_rules.ISLAND_PLACEMENTS``; ``state.wkv`` holds this
    rank's heads) of a layer: x (B, L, d) whole.  The wkv recurrence runs
    on the local heads (chunk-checkpointed under grad, as
    :func:`tmix_forward`'s, with no collective inside a chunk); ``w_o``'s
    and the channel-mix ``w_v``'s partial sums are the two sums over
    ``group`` (the model axis).

    Under grad the island keeps the Megatron conventions of
    :mod:`repro_torch.distributed.tensor_parallel`: the sums' backward is
    the identity (``reduce_from``), and the gradient of what feeds this
    rank's columns only — the time-mix input, its shift mixes ``mu`` and
    the decay's LoRA down-projection ``decay_A`` (whole leaves used on
    this rank's columns), the channel-mix key input — is summed over
    ``group`` (``copy_to``), as the transpose of the reference's
    ``shard_map`` sums its replicated inputs."""
    n1, n2 = norms
    h = tpl.copy_to(rms_norm(x, n1, cfg.rms_norm_eps), group)
    tparams = dict(tparams, mu=tpl.copy_to(tparams["mu"], group),
                   decay_A=tpl.copy_to(tparams["decay_A"], group))
    y, S, prev_t = tmix_forward(tparams, cfg, h, state)
    x = x + tpl.reduce_from(y, group)               # row-parallel w_o
    h2 = rms_norm(x, n2, cfg.rms_norm_eps)
    # channel-mix: w_k column-, w_v row-parallel; the gate r whole
    shifted = torch.cat([state.shift_cmix[:, None].to(h2.dtype), h2[:, :-1]],
                        dim=1)
    xk = tpl.copy_to(_mix(h2, shifted, cparams["mu"][0]), group)
    xr = _mix(h2, shifted, cparams["mu"][1])
    kk = torch.square(F.relu(_mm(xk, cparams["w_k"]).float()))
    v = tpl.reduce_from(kk.to(h2.dtype) @ cparams["w_v"], group)
    rr = torch.sigmoid(_mm(xr, cparams["w_r"]).float())
    x = x + (rr * v.float()).to(x.dtype)
    return x, RwkvState(wkv=S, shift_tmix=prev_t, shift_cmix=h2[:, -1])
