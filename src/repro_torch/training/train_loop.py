"""Train step and loop (counterpart of ``src/repro/training/train_loop.py``).

``make_train_step(model, opt, ctx)`` builds ``train_step(state, batch) ->
(state, metrics)``: ``loss.backward()`` through ``model.loss_fn`` (the
kernels' autograd Functions on the card), optional int8 gradient
compression with error feedback (the reference's model of a compressed
data-parallel reduction: the quantisation error is carried to the next
step), the global-norm clip, then the optimizer.

In place, to save memory: the step clips the gradients in place, and the
optimizer (``opt.apply_``) adds its update into ``state.params``, so the
returned state shares the input state's params (the reference's step is
pure).  Parameter leaves require grad; their ``.grad`` is cleared before
the backward and dropped after the update.  ``step`` is a 0-d int32
tensor on the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.models.transformer import Model, ParallelCtx, _tp
from repro_torch.training import tree as T
from repro_torch.training.optimizer import (OptimizerBundle,
                                            clip_by_global_norm_)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor
    # error-feedback residual for compressed gradients (None = off)
    ef_residual: Any = None


def init_train_state(model: Model, opt: OptimizerBundle,
                     generator: Optional[torch.Generator],
                     compression: bool = False, params=None) -> TrainState:
    """Seeded params (or ``params``, e.g. bridged), made leaves that
    require grad; the optimizer's state; a zero residual per leaf (fp32)
    under ``compression``."""
    if params is None:
        params = model.init_params(generator)
    for p in T.leaves(params):
        p.requires_grad_(True)
    ef = (T.map_params(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
          if compression else None)
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32),
                      ef_residual=ef)


def _compress_int8(g: torch.Tensor, group=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation (``torch.round`` rounds half
    to even, as ``jnp.round`` does); for a shard, the scale is the whole
    tensor's (the max over ``group``, the axes that cut it)."""
    scale = tpl.all_max(g.abs().max(), group) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(g: torch.Tensor, r: torch.Tensor, sh=None):
    """(the dequantised gradient in g's dtype, the new residual).  For a
    shard (``sh``, its ``LeafShards``) the per-tensor scale is the whole
    leaf's: the max over every shard."""
    g32 = g.float() + r
    q, scale = _compress_int8(g32, None if sh is None else sh.all)
    deq = _decompress_int8(q, scale)
    return deq.to(g.dtype), g32 - deq


def collect_grads(params) -> Dict:
    """Each leaf's ``.grad`` (zeros where the loss does not reach it, as
    ``jax.grad`` gives), detached from the leaves."""
    def take(p):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        p.grad = None
        return g
    return T.map_params(take, params)


def sync_grads_(grads, shards, lay) -> None:
    """Sum each gradient over the data axes, in place, unless a data axis
    cuts its leaf (ZeRO-3: the gather's backward reduce-scattered it)."""
    if lay.data is None:
        return
    for g, sh in zip(T.leaves(grads), T.leaves(shards)):
        if not sh.data_cut:
            torch.distributed.all_reduce(g, group=lay.data)


def make_train_step(model: Model, opt: OptimizerBundle, ctx: ParallelCtx,
                    *, max_grad_norm: float = 1.0,
                    compression: bool = False) -> Callable:
    """Build ``train_step(state, batch) -> (state, metrics)``; metrics are
    the loss_fn's plus ``loss`` and ``grad_norm`` (pre-clip), detached.

    On a mesh (``ctx.mesh`` with a ``dense_phase``) the state holds this
    rank's shards and the batch its rows: the gradients are summed over
    the data axes (:func:`sync_grads_`), and the norm, the clip, the int8
    scale and the optimizer's statistics reduce over the axes that cut
    each leaf (``tensor_parallel.leaf_shards``), so every shard is updated
    as the whole leaf would be."""
    lay = _tp(ctx)
    if ctx.mesh is not None and lay is None:
        raise ValueError("training on a mesh needs ctx.dense_phase")
    shards = {}

    def train_step(state: TrainState, batch: Dict):
        params = state.params
        if lay is not None and "tree" not in shards:
            shards["tree"] = tpl.leaf_shards(params, ctx.mesh, lay)
        sh = shards.get("tree")
        for p in T.leaves(params):
            p.grad = None
        loss, metrics = model.loss_fn(params, batch, ctx)
        loss.backward()
        with torch.no_grad():
            grads = collect_grads(params)
            if sh is not None:
                sync_grads_(grads, sh, lay)
            ef = state.ef_residual
            if compression:
                pairs = T.map_params(compress_with_feedback, grads, ef,
                                     *(() if sh is None else (sh,)))
                grads = T.map_params(lambda p, pr: pr[0], params, pairs)
                ef = T.map_params(lambda p, pr: pr[1], params, pairs)
            gnorm = clip_by_global_norm_(grads, max_grad_norm, sh)
            opt_state = opt.apply_(grads, state.opt_state, params,
                                   state.step, sh)
        del grads
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step + 1, ef_residual=ef)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)

    return train_step


def train_loop(model: Model, opt: OptimizerBundle, ctx: ParallelCtx,
               data_iter, num_steps: int,
               generator: Optional[torch.Generator], *, log_every: int = 10,
               checkpoint_fn: Optional[Callable] = None,
               checkpoint_every: int = 0, compression: bool = False):
    """The reference's small-scale driver: returns (state, history)."""
    state = init_train_state(model, opt, generator, compression)
    step_fn = make_train_step(model, opt, ctx, compression=compression)
    history = []
    for i in range(num_steps):
        state, metrics = step_fn(state, next(data_iter))
        if i % log_every == 0 or i == num_steps - 1:
            history.append({"step": i, "loss": float(metrics["loss"]),
                            "grad_norm": float(metrics["grad_norm"])})
            print(f"step {i:5d}  loss {history[-1]['loss']:.4f}  "
                  f"gnorm {history[-1]['grad_norm']:.3f}")
        if checkpoint_fn and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            checkpoint_fn(state, i + 1)
    return state, history
