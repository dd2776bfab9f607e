"""Train step and loop (counterpart of ``src/repro/training/train_loop.py``).

``make_train_step(model, opt, ctx)`` builds ``train_step(state, batch) ->
(state, metrics)``: ``loss.backward()`` through ``model.loss_fn`` (the
kernels' autograd Functions on the card), optional int8 gradient
compression with error feedback (the reference's model of a compressed
data-parallel reduction: the quantisation error is carried to the next
step), the global-norm clip, then the optimizer.

In place, to save memory and so that a CUDA graph of the step reads and
writes the same addresses at every step: the step clips the gradients in
place, the optimizer (``opt.apply_``) adds its update into
``state.params`` and writes its state over ``state.opt_state``, the int8
residual is written over ``state.ef_residual`` and ``state.step`` (a 0-d
int32 tensor on the params' device) is incremented in place, so the
returned state holds the input state's tensors (the reference's step is
pure).  Parameter leaves require grad; their ``.grad`` is cleared before
the backward and dropped after the update.

:func:`compile_train_step` is the reference's ``jax.jit`` of that step:
on the card, one CUDA graph captured once and replayed.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.mesh_axes import mesh_groups
from repro_torch.kernels import build
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
    under ``compression``; the step, 0, on the params' device."""
    if params is None:
        params = model.init_params(generator)
    for p in T.leaves(params):
        p.requires_grad_(True)
    dev = next(iter(T.leaves(params))).device
    ef = (T.map_params(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
          if compression else None)
    return TrainState(params=params, opt_state=opt.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev),
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


def compress_with_feedback(g: torch.Tensor, r: torch.Tensor, sh=None,
                           out: Optional[torch.Tensor] = None):
    """(the dequantised gradient in g's dtype, the new residual).  For a
    shard (``sh``, its ``LeafShards``) the per-tensor scale is the whole
    leaf's: the max over every shard.  The new residual is written into
    ``out`` when given (``r`` itself in the train step: r is read first)."""
    g32 = g.float() + r
    q, scale = _compress_int8(g32, None if sh is None else sh.all)
    deq = _decompress_int8(q, scale)
    return deq.to(g.dtype), torch.sub(g32, deq, out=out)


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
    as the whole leaf would be.  ``train_step.groups`` names the mesh's
    process groups (``mesh_axes.mesh_groups``): :func:`compile_train_step`
    captures the step with its collectives where they are all NCCL's."""
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
                grads = T.map_params(
                    lambda g, r, *s: compress_with_feedback(
                        g, r, *s, out=r)[0],
                    grads, ef, *(() if sh is None else (sh,)))
            gnorm = clip_by_global_norm_(grads, max_grad_norm, sh)
            opt_state = opt.apply_(grads, state.opt_state, params,
                                   state.step, sh)
            state.step.add_(1)
        del grads
        new_state = TrainState(params=params, opt_state=opt_state,
                               step=state.step, ef_residual=ef)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_state, dict(metrics, loss=loss.detach(), grad_norm=gnorm)

    train_step.groups = mesh_groups(ctx.mesh)
    return train_step


class CompiledTrainStep(build.CompiledFn):
    """``step_fn`` (a :func:`make_train_step` step, or any step that
    writes its state in place) compiled as the reference jits its train
    step: on the card, one CUDA graph of the whole step — forward,
    backward, gradient collection, compression, clip, optimizer and the
    step's increment — captured once and replayed
    (:class:`~repro_torch.kernels.build.CompiledFn` with ``held`` the
    state and the batch its one data argument).

    Each call first copies the batch into static buffers on ``device``,
    as the reference passes the batch as a jit argument; the data
    iterator's fresh tensors are never read by the graph.  The graph's
    key is the address, shape and dtype of every tensor the step reads or
    writes (the state's params, optimizer state, residual and step, and
    the batch buffers).  The step is not pure: the first call under a key
    is the eager step itself, the second is captured and replayed, later
    calls replay.  A state at other addresses captures again; a
    checkpoint restored into the live state
    (``checkpoint.restore_checkpoint(..., into=True)``) keeps the graph.

    A replay returns the caller's ``state`` (its tensors hold the new
    state) and the graph's static metrics (``loss``, ``grad_norm`` and the
    loss_fn's ``dropped`` / ``miss`` / aux losses): the next replay
    overwrites them, so clone what you keep.  The step's counter lives on
    the device and every step-dependent scalar (the schedule's learning
    rate, the bias corrections, Adafactor's decay) is computed from it in
    the graph, so nothing of the capture step is frozen into it.

    On a mesh (``step_fn.groups``, the mesh's process groups) the graph
    holds the step's collectives where every group is NCCL's, as the
    reference's jitted cell holds them (``src/repro/launch/dryrun.py:241``,
    the state donated as the port writes it in place); with gloo's or the
    fake world's it runs eagerly (:attr:`decision`, ``build.decide``).
    The step runs eagerly over the same staging on the CPU, on ``meta``
    and under ``step_graphs.eager()`` (``build.eager``, the reference's
    ``jax.disable_jit()``)."""

    PURE = False

    def __call__(self, state: TrainState, batch: Dict):
        if self.enabled and state.step.device.type != "cuda":
            raise ValueError(f"compile_train_step: the step counter is on "
                             f"{state.step.device}, not the card")
        return super().__call__(state, batch)

    def _run(self, state: TrainState, staged):
        new, metrics = self.fn(state, *staged)
        if build.addresses(new) != build.addresses(state):
            raise ValueError("compile_train_step: the step must write its "
                             "state in place (a new tensor in the returned "
                             "state)")
        return new, metrics

    def _captured(self, state: TrainState, staged):
        return self._run(state, staged)[1]

    def _result(self, state: TrainState):
        return state, dict(self._outputs)


def compile_train_step(step_fn: Callable, device) -> CompiledTrainStep:
    """The reference's ``jax.jit(make_train_step(...))``: ``step_fn`` as a
    :class:`CompiledTrainStep` on ``device`` (a CUDA graph on the card,
    with the collectives of ``step_fn.groups``)."""
    return CompiledTrainStep(step_fn, device,
                             groups=getattr(step_fn, "groups", ()))


def train_loop(model: Model, opt: OptimizerBundle, ctx: ParallelCtx,
               data_iter, num_steps: int,
               generator: Optional[torch.Generator], *, log_every: int = 10,
               checkpoint_fn: Optional[Callable] = None,
               checkpoint_every: int = 0, compression: bool = False):
    """The reference's small-scale driver: returns (state, history).  The
    step is compiled (:func:`compile_train_step`): a CUDA graph on the
    card, eager on the CPU and under ``eager()``."""
    state = init_train_state(model, opt, generator, compression)
    step_fn = compile_train_step(
        make_train_step(model, opt, ctx, compression=compression),
        state.step.device)
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
