"""Optimizers (counterpart of ``src/repro/training/optimizer.py``): AdamW
for the small models and Adafactor (factored second moments: the only
optimizer whose state fits beside the large MoEs' weights).

Functional, over the reference's param dicts and with its roundings:
``opt.init(params) -> state``; ``opt.update(grads, state, params, step) ->
(updates, state)`` with each update cast to its parameter's dtype.  No
``torch.optim``.  ``opt.apply_(grads, state, params, step) -> state`` is
the same update added into the params in place (``p + u`` in p's dtype,
as the reference's train step adds it), without a tree of updates beside
the params, and with the optimizer's state written in place (the
returned state holds the input state's tensors); the port's train step
uses it.  Both run the same operations in the same order, so they agree
bitwise: ``update`` writes into fresh tensors what ``apply_`` writes over
the old state.

What depends on the step (the schedule's learning rate, ``t``, AdamW's
bias corrections, Adafactor's ``beta``) is computed once per call, in
float32, on the params' device, from a step tensor moved there: no host
scalar reaches a kernel, so a CUDA graph of the train step reads the step
it is replayed at (``train_loop.compile_train_step``).

Adafactor works through a large leaf in chunks of whole matrices (or of
rows, when one matrix is larger than the chunk): the factored statistics
are per matrix, so the chunks give them exactly (a matrix cut into row
chunks sums its column statistic chunk by chunk); the RMS update clip is a
mean over the whole leaf, so a chunked leaf takes a pass for it and a pass
for the update.  At full width one expert leaf holds 3.76 G elements: one
fp32 temporary of it would be 15 GB.

On a mesh each rank updates its shards: given each leaf's
``tensor_parallel.LeafShards``, a mean over a dim that is cut (the row and
column statistics, ``mean(vr)``) and the update clip's RMS are summed over
the axes that cut it and divided by the whole leaf's sizes, and the global
norm counts each leaf once.  Without (``shards=None``) the update is the
one-device one, unchanged.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.training import tree as T

CHUNK = 1 << 26         # elements of a leaf Adafactor's temporaries hold


class OptimizerBundle(NamedTuple):
    init: Callable
    update: Callable
    name: str
    apply_: Optional[Callable] = None


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    """sum(x.float() ** 2), in pieces of :data:`CHUNK` elements."""
    flat = x.reshape(-1)
    if flat.numel() <= CHUNK:
        return flat.float().square().sum()
    return sum(flat[i:i + CHUNK].float().square().sum()
               for i in range(0, flat.numel(), CHUNK))


def _leaf_sq(x: torch.Tensor, sh) -> torch.Tensor:
    """sum(x^2) of the whole leaf: this shard's, summed over the axes that
    cut it (each leaf counted once)."""
    s = _sq_sum(x)
    return s if sh is None else tpl.all_sum(s, sh.all)


def global_norm(tree, shards=None) -> torch.Tensor:
    """sqrt of the sum over leaves (the reference's order) of sum(x^2).
    ``shards``: a tree of ``tensor_parallel.LeafShards`` when ``tree``
    holds this rank's shards."""
    if shards is None:
        return torch.sqrt(sum(_sq_sum(x) for x in T.leaves(tree)))
    return torch.sqrt(sum(_leaf_sq(x, sh) for x, sh in
                          zip(T.leaves(tree), T.leaves(shards))))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm) in fp32, cast back; norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return T.map_params(lambda g: (g.float() * scale).to(g.dtype),
                        grads), norm


def clip_by_global_norm_(grads, max_norm: float,
                         shards=None) -> torch.Tensor:
    """:func:`clip_by_global_norm` in place (``g.mul_(scale)`` rounds as
    the reference's fp32 product cast back); returns the norm (of the
    whole leaves, for shards with ``shards``)."""
    norm = global_norm(grads, shards)
    scale = _clip_scale(norm, max_norm)
    for g in T.leaves(grads):
        g.mul_(scale)
    return norm


def cosine_schedule(base_lr: float, warmup: int, total: int) -> Callable:
    """Linear warm-up, then a cosine to 0 at ``total``; fp32 like the
    reference's."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr


def _lr_fn(lr) -> Callable:
    return lr if callable(lr) else (
        lambda step: torch.full((), lr, dtype=torch.float32,
                                device=step.device))


def _t(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32) + 1


def _bundle(init, scalars, leaf_update, name: str) -> OptimizerBundle:
    """``scalars(step) -> dict`` of the step's 0-d tensors (``step`` on
    the params' device); ``leaf_update(g, leaf_state, p, sc, emit, shards,
    out) -> out`` writes the leaf's new state into ``out`` (fresh tensors,
    or ``leaf_state`` itself), where ``emit(index, u)`` receives the
    update of ``p.view(-1, R, C)[index]`` (or of the whole leaf, index
    None) in p's dtype and ``shards`` is the leaf's ``LeafShards`` (None:
    a whole leaf)."""
    def scalars_of(step, params):
        dev = next(iter(T.leaves(params))).device
        return scalars(torch.as_tensor(step, device=dev))

    def update(grads, state, params, step, shards=None):
        sc = scalars_of(step, params)

        def one(g, f, p, sh):
            u = torch.empty_like(p)
            view = _as3(u)

            def emit(index, chunk):
                (u if index is None else view[index]).copy_(chunk)
            out = {k: torch.empty_like(v) for k, v in f.items()}
            return u, leaf_update(g, f, p, sc, emit, sh, out)
        pairs = T.map_params(one, grads, state_of(state), params,
                             _or_none(shards, params))
        return (T.map_params(lambda p, pr: pr[0], params, pairs),
                wrap(params, T.map_params(lambda p, pr: pr[1], params,
                                          pairs)))

    @torch.no_grad()
    def apply_(grads, state, params, step, shards=None):
        sc = scalars_of(step, params)

        def one(g, f, p, sh):
            view = _as3(p)

            def emit(index, chunk):
                (p if index is None else view[index]).add_(chunk)
            return leaf_update(g, f, p, sc, emit, sh, f)
        return wrap(params, T.map_params(one, grads, state_of(state),
                                         params, _or_none(shards, params)))

    def state_of(state):
        return state["f"] if name == "adafactor" else _zip_adam(state)

    def wrap(params, per_leaf):
        if name == "adafactor":
            return {"f": per_leaf}
        return {k: T.map_params(lambda p, s: s[k], params, per_leaf)
                for k in ("mu", "nu")}

    return OptimizerBundle(init, update, name, apply_)


def _or_none(shards, params):
    """``shards``, or a tree of None beside ``params``."""
    return shards if shards is not None else T.map_params(lambda p: None,
                                                          params)


def _mean(x: torch.Tensor, dim: int, group, n: int, keepdim=False):
    """``x.mean(dim)``; over a dim cut on ``group``, the shards' sums
    summed over the group, over the whole dim's ``n``."""
    if group is None:
        return x.mean(dim, keepdim=keepdim)
    return tpl.all_sum(x.sum(dim, keepdim=keepdim), group) / n


def _zip_adam(state):
    def z(mu, nu):
        if isinstance(mu, dict):
            return {k: z(mu[k], nu[k]) for k in mu}
        return {"mu": mu, "nu": nu}
    return z(state["mu"], state["nu"])


def _as3(p: torch.Tensor) -> Optional[torch.Tensor]:
    """(matrices, R, C) view of a leaf of 2+ dims."""
    return p.view(-1, *p.shape[-2:]) if p.dim() >= 2 else None


# ------------------------------------------------------------------- AdamW

def adamw(lr=1e-3, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> OptimizerBundle:
    lr_fn = _lr_fn(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                      device=p.device)
        return {"mu": T.map_params(zeros, params),
                "nu": T.map_params(zeros, params)}

    def scalars(step):
        t = _t(step)
        return {"neg_lr": -lr_fn(step),
                "bc1": 1 - torch.full_like(t, b1) ** t,
                "bc2": 1 - torch.full_like(t, b2) ** t}

    def leaf_update(g, s, p, sc, emit, sh, out):
        g = g.float()
        # b1 * mu + (1 - b1) * g, each product rounded as the functional
        # expression rounds it (a fused add_(g, alpha=...) would not)
        mu, nu = out["mu"], out["nu"]
        torch.mul(s["mu"], b1, out=mu)
        mu.add_((1 - b1) * g)
        torch.mul(s["nu"], b2, out=nu)
        nu.add_((1 - b2) * torch.square(g))
        u = (mu / sc["bc1"]) / (torch.sqrt(nu / sc["bc2"]) + eps)
        if weight_decay:
            u = u + weight_decay * p.float()
        emit(None, (sc["neg_lr"] * u).to(p.dtype))
        return out

    return _bundle(init, scalars, leaf_update, "adamw")


# --------------------------------------------------------------- Adafactor

def _chunks(n: int, R: int, C: int, limit: int):
    """Index tuples into an (n, R, C) view: whole matrices while one fits
    ``limit`` elements, else row ranges of one matrix."""
    if R * C <= limit:
        per = max(1, limit // (R * C))
        for b0 in range(0, n, per):
            yield slice(b0, min(n, b0 + per)), slice(0, R)
    else:
        rows = max(1, limit // C)
        for b in range(n):
            for r0 in range(0, R, rows):
                yield slice(b, b + 1), slice(r0, min(R, r0 + rows))


def adafactor(lr=1e-2, decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0) -> OptimizerBundle:
    """Factored second-moment optimizer (Shazeer & Stern, 2018), no first
    moment, as the reference's; a leaf larger than :data:`CHUNK` elements
    is updated in chunks (module docstring)."""
    lr_fn = _lr_fn(lr)

    def init(params):
        def factors(p):
            z = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **z),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **z)}
            return {"v": torch.zeros(p.shape, **z)}
        return {"f": T.map_params(factors, params)}

    def scalars(step):
        beta = 1.0 - _t(step) ** (-decay)
        return {"beta": beta, "1-beta": 1 - beta, "neg_lr": -lr_fn(step)}

    def leaf_update(g, f, p, sc, emit, sh, out):
        beta, nbeta, neg_lr = sc["beta"], sc["1-beta"], sc["neg_lr"]
        every = None if sh is None else sh.all

        def rms_of(sq_sum, n_local):
            if every is None:
                return torch.sqrt(sq_sum / n_local + eps)
            return torch.sqrt(tpl.all_sum(sq_sum, every)
                              / math.prod(sh.whole) + eps)
        if p.dim() < 2:
            g = g.float()
            v = out["v"]
            torch.mul(beta, f["v"], out=v)
            v.add_(nbeta * (torch.square(g) + eps))
            u = g / torch.sqrt(v + eps)
            if every is None:
                rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            else:
                rms = rms_of(torch.square(u).sum(), u.numel())
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            emit(None, (neg_lr * u).to(p.dtype))
            return out
        g3 = _as3(g)
        n, R, C = g3.shape
        rows, cols = (None, None) if sh is None else (sh.rows, sh.cols)
        R_all = R if sh is None else sh.whole[-2]
        C_all = C if sh is None else sh.whole[-1]
        vr_old = f["vr"].reshape(n, R)
        vc_old = f["vc"].reshape(n, C)
        parts = list(_chunks(n, R, C, CHUNK))
        # pass 1: the factored statistics (in place, ``out`` is ``f``: a
        # chunk reads its own old rows and columns before it writes them)
        vr = out["vr"].view(n, R)
        vc = out["vc"].view(n, C)
        col = {}
        for bs, rs in parts:
            g2 = torch.square(g3[bs, rs].float()) + eps
            vr[bs, rs] = beta * vr_old[bs, rs] + nbeta * _mean(
                g2, -1, cols, C_all)
            if rs.stop - rs.start == R:
                vc[bs] = beta * vc_old[bs] + nbeta * _mean(
                    g2, -2, rows, R_all)
            else:
                b = bs.start
                col[b] = col.get(b, 0) + g2.sum(-2)
                if rs.stop == R:
                    tot = col.pop(b)
                    if rows is not None:
                        tot = tpl.all_sum(tot, rows)
                    vc[bs] = beta * vc_old[bs] + nbeta * (tot / R_all)
        denom = torch.clamp(_mean(vr, -1, rows, R_all, keepdim=True),
                            min=eps)[..., None]

        def u_of(bs, rs):
            v = vr[bs, rs, None] * vc[bs, None, :] / denom[bs]
            return g3[bs, rs].float() / torch.sqrt(v + eps)
        # pass 2: the update's RMS over the whole leaf
        if len(parts) == 1:
            u = u_of(*parts[0])
            if every is None:
                rms = torch.sqrt(torch.mean(torch.square(u)) + eps)
            else:
                rms = rms_of(torch.square(u).sum(), u.numel())
        else:
            sq = sum(torch.square(u_of(bs, rs)).sum() for bs, rs in parts)
            rms = rms_of(sq, g.numel())
        scale = torch.clamp(rms / clip_threshold, min=1.0)
        # pass 3: the update, chunk by chunk
        for bs, rs in parts:
            uc = u if len(parts) == 1 else u_of(bs, rs)
            emit((bs, rs), (neg_lr * (uc / scale)).to(p.dtype))
        return out

    return _bundle(init, scalars, leaf_update, "adafactor")
