"""The dry-run's cells on ``torch.distributed`` (counterpart of
``src/repro/launch/dryrun.py``): for each (architecture x input shape x
mesh) cell, the step a rank runs — the train step for a train shape, the
prefill or one serve step for an inference shape — and its accounting per
device.

* :func:`build_cell` builds a cell's step with the reference's contexts,
  phases, capacities and cache placements, compiled as the reference
  jits it: on the card over an NCCL mesh each step is a CUDA graph
  holding its collectives (the train step through
  ``train_loop.compile_train_step``, the prefill one graph per prompt
  shape, the serve step writing the cache in place as the reference
  donates it); over gloo ranks with ``device="cpu"`` (the tests) and on
  ``meta`` the same steps run eagerly (``build.decide``).  The params
  are the rank's shards (``sharding_rules.shard_params(..., dense=True)``).
* :func:`run_cell` is the accounting.  It runs the per-rank step once on
  ``meta`` tensors — the params built as ``jax.eval_shape(init_params)``
  builds them, cut to the rank's shards — under the ``fake`` process-group
  backend at the production world size (16 x 16 = 256 ranks, or 2 x 16 x
  16 = 512), with no card and no data.  It records per device: FLOPs
  (``FlopCounterMode``; each kernel, and rwkv6's wkv recurrence, counted
  by its own work, :mod:`repro_torch.kernels.meta`), the argument bytes
  (the shards of the params and optimizer state, the batch, the cache
  shard; exact from shapes), the peak live bytes (:class:`MetaMemory`), the collectives'
  bytes and counts by kind (:class:`CollectiveCounter`, over the ``c10d``
  ops) and whether the rank fits one H100's 80 GiB.  Eager execution
  counts every layer, so the reference's depth probes are not needed;
  :func:`probe_plan` and :func:`_lin` stay, and a test holds the probe
  extrapolation (:func:`run_probes`) equal to the full-depth count.
  It counts the cell's plain step (``Cell.plain``): the compiled
  wrapper's static buffers are its machinery, not the step's memory.

Not portable: the reference's ``parse_collective_bytes`` and
``_cost_dict`` read XLA's partitioned HLO text and ``cost_analysis()``,
which have no PyTorch counterpart; the counts here come from the ops the
step dispatches instead.  ``unroll_scans`` is XLA's (the port's layers
are a Python loop).

Results land in ``experiments/dryrun_torch/``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-r1 \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes]

No card is needed: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import (ALL_SHAPES, ASSIGNED_ARCHS, InputShape,
                                 applicable, get_config, shape_by_name)
from repro_torch.configs.base import ModelConfig
from repro_torch.core import expert_server
from repro_torch.core import mapping as emap
from repro_torch.core.moe_layer import MoERuntime, default_capacity
from repro_torch.distributed import mesh_axes
from repro_torch.distributed.mesh_axes import data_axes, mesh_groups
from repro_torch.distributed.sharding_rules import (cache_placements,
                                                    shard_leaf, shard_params,
                                                    train_phase_for)
from repro_torch.kernels import build
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import ParallelCtx, build_model
from repro_torch.models.whisper import frame_spec
from repro_torch.training import tree as T
from repro_torch.training.optimizer import adafactor
from repro_torch.training.train_loop import (TrainState, compile_train_step,
                                             make_train_step)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "experiments", "dryrun_torch")
H100_BYTES = 80 * 2**30


# ---------------------------------------------------------------------------
# Abstract inputs per (arch, shape)
# ---------------------------------------------------------------------------

class Spec(NamedTuple):
    """A model input's shape and dtype (``jax.ShapeDtypeStruct``'s)."""
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Spec]:
    """Stand-ins for every model input of this shape."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        specs = {"tokens": Spec((B, S), torch.int32),
                 "labels": Spec((B, S), torch.int32)}
    elif shape.kind == "prefill":
        specs = {"tokens": Spec((B, S), torch.int32)}
    else:  # decode: ONE new token against a cache of S tokens
        specs = {"tokens": Spec((B, 1), torch.int32)}
    if cfg.is_encoder_decoder and shape.kind == "train":
        specs["frames"] = Spec(*frame_spec(cfg, B))
    if cfg.mrope_sections is not None and shape.kind == "train":
        specs["mrope_positions"] = Spec((3, B, S), torch.int32)
    return specs


def moe_runtime_for(cfg: ModelConfig, mesh, shape: InputShape,
                    mode: str, device=None, gemm_impl: str = "dense"
                    ) -> Optional[MoERuntime]:
    """One logical server per rank of the ``model`` axis, two replicas a
    expert in the mapping, no redundant slots; the capacity sized for a
    client's tokens: a2a splits the batch over every rank, replicated over
    the data axes only; the expert GEMMs lowered ``dense`` (each local
    expert capped at ``ecap`` rows, as the reference's cells lower them),
    or ``gemm_impl="auto"`` for the grouped GEMM kernel.  The tables live
    on ``device`` (the mesh's device type by default)."""
    if cfg.moe is None:
        return None
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    S = sizes["model"]
    dp_total = math.prod(sizes[a] for a in data_axes(mesh))
    if mode == "a2a":
        tokens_per_client = shape.global_batch * shape.seq_len // (
            dp_total * S)
    else:
        tokens_per_client = max(shape.global_batch // dp_total, 1)
    device = device or mesh.device_type
    table = emap.default_mapping(cfg.moe.num_experts, S, max_replicas=2)
    local = expert_server.make_local_table(
        cfg.moe.num_experts, S, np.zeros((S, 0), np.int32))
    return MoERuntime(
        mapping=torch.as_tensor(table, dtype=torch.int64, device=device),
        alive=torch.ones(S, dtype=torch.bool, device=device),
        local_table=torch.as_tensor(local, dtype=torch.int64, device=device),
        num_servers=S,
        capacity=default_capacity(tokens_per_client, cfg.moe.top_k, S,
                                  cfg.moe.capacity_factor),
        gemm_impl=gemm_impl)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

class Cell(NamedTuple):
    """One cell's step on this rank.

    ``step``: train — ``(TrainState, batch rows) -> (state, metrics)``;
    prefill — ``(params, token rows) -> (logits, cache)``; decode —
    ``(params, token rows, cache shard) -> (next token, cache)``; compiled
    (:func:`compile_prefill`, :func:`compile_serve`,
    ``train_loop.compile_train_step``: ``step.decision`` says whether it
    runs as a CUDA graph, and why).  ``plain`` is the same step
    uncompiled.  ``phase`` is the sharding table's; ``seq_axes`` the
    decode cache's slot axes."""

    cfg: ModelConfig
    shape: InputShape
    mesh: object
    model: object
    ctx: ParallelCtx
    phase: str
    step: Callable
    opt: object = None
    seq_axes: tuple = ()
    plain: Callable = None

    def shard(self, full):
        """This rank's shards of a whole params tree (tensors or numpy
        arrays; views)."""
        return shard_params(full, self.mesh, self.phase, dense=True)

    def rows(self, name: str, a):
        """This rank's block of a batch input (``input_specs``' name):
        rows over the data axes — (dp, None) for tokens and labels, (dp,
        None, None) for whisper's frames, (None, dp, None) for M-RoPE
        positions — or all of it when the batch is 1."""
        B = self.shape.global_batch
        if B == 1:
            return a
        dp = self.ctx.axis_data
        spec = {"mrope_positions": (None, dp, None),
                "frames": (dp, None, None)}.get(name, (dp, None))
        return _shard(a, spec, self.mesh)

    def cache_shard(self, cache):
        """This rank's block of a whole cache (the decode cell's slot
        axes and batch rows, ``cache_placements``)."""
        specs = cache_placements(cache, self.shape.global_batch,
                                 self.ctx.axis_data, self.seq_axes,
                                 self.shape.seq_len)
        return T.map_paths(lambda _, leaf, spec: _shard(leaf, spec,
                                                        self.mesh),
                           cache, specs)

    def init_cache(self):
        """This rank's empty cache of the decode cell."""
        B = self.shape.global_batch
        b = B if B == 1 else B // mesh_axes.axes_size(self.mesh,
                                                      self.ctx.axis_data)
        return self.model.init_cache(b, self.shape.seq_len, self.ctx)


def _shard(a, spec, mesh):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return shard_leaf(a, spec, sizes, coord)


def build_cell(arch: str, shape: InputShape, mesh, cfg=None,
               device: Optional[str] = None) -> Cell:
    """One dry-run cell's step on this rank of ``mesh`` (the reference's
    ``build_cell``: the same contexts, phases, capacities and cache
    placements).  Its model lives on ``device`` (the mesh's device type
    by default; ``"meta"`` for the accounting)."""
    cfg = cfg or get_config(arch)
    device = device or mesh.device_type
    dp = data_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    S_servers = sizes["model"]
    n_servers = S_servers if cfg.moe else 1
    model = build_model(cfg, n_servers, np.zeros((n_servers, 0), np.int32),
                        device)
    mode = "a2a" if shape.kind in ("train", "prefill") else "replicated"
    rt = moe_runtime_for(cfg, mesh, shape, mode, device=device)
    # SP residual only where training is capacity-blocked (ZeRO-3 class)
    zero3 = train_phase_for(cfg.num_params(), S_servers) == "train"
    # decode: slot-shard the KV cache — over (data + model) for batch-1
    # long context, over model otherwise (attention weights replicated)
    seq_shard = shape.kind == "decode"
    seq_axes = ()
    if seq_shard:
        seq_axes = (*dp, "model") if shape.global_batch == 1 else ("model",)
    phase = {"train": "train" if zero3 else "train_tp",
             "prefill": "serve", "decode": "decode"}[shape.kind]
    ctx = ParallelCtx(mesh=mesh, axis_data=dp, moe_runtime=rt,
                      moe_mode=mode, seq_shard_cache=seq_shard,
                      seq_shard_axes=seq_axes, dense_phase=phase,
                      sp_residual=(shape.kind == "train" and zero3),
                      remat=True, ce_chunk=512)

    if shape.kind == "train":
        opt = adafactor(lr=1e-3)
        plain = make_train_step(model, opt, ctx)
        return Cell(cfg, shape, mesh, model, ctx, phase,
                    compile_train_step(plain, device), opt, plain=plain)

    if shape.kind == "prefill":
        plain = prefill_step_of(model, ctx, shape.seq_len)
        return Cell(cfg, shape, mesh, model, ctx, phase,
                    compile_prefill(plain, model, ctx, device), plain=plain)

    plain = serve_step_of(model, ctx)
    return Cell(cfg, shape, mesh, model, ctx, phase,
                compile_serve(plain, ctx, device), seq_axes=seq_axes,
                plain=plain)


def prefill_step_of(model, ctx: ParallelCtx, max_slots: int) -> Callable:
    """The prefill cell's step: ``(params, tokens, batch=None) -> (logits,
    cache)`` into a cache of ``max_slots`` slots."""
    def prefill_step(params, tokens, batch=None):
        logits, cache, _ = model.prefill(params, tokens, ctx,
                                         max_slots=max_slots, batch=batch)
        return logits, cache
    return prefill_step


def serve_step_of(model, ctx: ParallelCtx, logits: bool = False
                  ) -> Callable:
    """The serve cell's step: ``(params, token, cache) -> (next token,
    cache)``, greedy; with ``logits`` it also returns the step's logits
    (a caller that checks them)."""
    def serve_step(params, token, cache):
        out, cache, _ = model.decode_step(params, token, cache, ctx)
        nxt = torch.argmax(out, dim=-1, keepdim=True).to(torch.int32)
        return (nxt, cache, out) if logits else (nxt, cache)
    return serve_step


# the reference's prefill is one jitted function a prompt shape; zamba2's
# and rwkv6's loop over their scan bodies, each captured and replayed
# inside the eager prefill (``Model.prefill_per_shape``, the executor's
# rule)
SCAN_PREFILL = ("the family's prefill loops over its scan bodies, each a "
                "CUDA graph (Model.prefill_per_shape)")


def compile_prefill(step: Callable, model, ctx: ParallelCtx, device
                    ) -> build.CompiledPerShape:
    """``jax.jit`` of the prefill cell's ``step``: one CUDA graph per
    prompt shape (``build.CompiledPerShape``: the tokens, and a batch's
    inputs, copied into static buffers), returning clones of its logits
    and its fresh cache (the reference's ``out_shardings``); eager where
    the family's prefill replays scan bodies, over gloo and on
    ``meta``."""
    return build.CompiledPerShape(
        step, device, mesh_groups(ctx.mesh),
        None if model.prefill_per_shape else SCAN_PREFILL)


class CompiledServeStep(build.CompiledFn):
    """``jax.jit(serve_step, donate_argnums=(2,))``: the serve cell's step
    as one CUDA graph, ``(params, token, cache) -> (next token, cache,
    *rest)``.  The token is data (copied into a static buffer, so a new
    token replays); the params and the cache are read where they lie
    (their addresses key the graph), and the cache is written in place,
    as the reference donates it: a leaf the step returns fresh is copied
    back into the caller's (``build.adopt``), and the returned cache is
    the caller's.  The next token (and a step's logits) are the graph's
    static outputs, overwritten by the next replay.  The first call under
    a key runs eagerly, the second captures, later calls replay; a cache
    at other addresses captures again."""

    PURE = False

    def __call__(self, params, token, cache):
        return super().__call__((params, cache), token)

    def _run(self, held, staged):
        params, cache = held
        nxt, new, *rest = self.fn(params, *staged, cache)
        build.adopt(cache, new)
        return (nxt, cache, *rest)

    def _captured(self, held, staged):
        nxt, _, *rest = self._run(held, staged)
        return (nxt, *rest)

    def _result(self, held):
        nxt, *rest = self._outputs
        return (nxt, held[1], *rest)


def compile_serve(step: Callable, ctx: ParallelCtx, device
                  ) -> CompiledServeStep:
    """The serve cell's ``step`` compiled (:class:`CompiledServeStep`) with
    the collectives of ``ctx``'s mesh."""
    return CompiledServeStep(step, device, mesh_groups(ctx.mesh))


def init_state(cell: Cell, params) -> TrainState:
    """A train cell's state over this rank's params (made leaves that
    require grad); the step counter on their device, as the compiled
    step reads it."""
    for p in T.leaves(params):
        p.requires_grad_(True)
    return TrainState(params=params, opt_state=cell.opt.init(params),
                      step=torch.zeros((), dtype=torch.int32,
                                       device=next(iter(T.leaves(
                                           params))).device))


# ---------------------------------------------------------------------------
# Accounting on meta
# ---------------------------------------------------------------------------

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

COLLECTIVES = {"allreduce_": "all-reduce", "allreduce_coalesced_":
               "all-reduce", "_allgather_base_": "all-gather",
               "allgather_": "all-gather", "allgather_into_tensor_coalesced_":
               "all-gather", "_reduce_scatter_base_": "reduce-scatter",
               "reduce_scatter_": "reduce-scatter",
               "reduce_scatter_tensor_coalesced_": "reduce-scatter",
               "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
               "broadcast_": "broadcast"}


def _nbytes(t) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    if isinstance(t, (list, tuple)):
        return sum(_nbytes(x) for x in t)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Bytes and counts of the ``c10d`` collectives a step dispatches, by
    kind: each counts its output's bytes on this rank (the reference's
    convention: the per-device bytes of each collective's result)."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, int] = {}
        self.counts: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            kind = COLLECTIVES.get(func._opname)
            if kind is not None:
                out = args[0]
                self.bytes[kind] = self.bytes.get(kind, 0) + _nbytes(out)
                self.counts[kind] = self.counts.get(kind, 0) + 1
        return func(*args, **kwargs)


class MetaMemory(TorchDispatchMode):
    """Peak live bytes of the storages a step allocates: every op's
    outputs register their storage (by its identity, with a weak
    reference); a storage counts from its first output until it dies.
    Dead storages are swept only when a new one would raise the peak, so
    the peak is exact and the sweep rare."""

    def __init__(self, arguments=()):
        super().__init__()
        from torch.multiprocessing.reductions import StorageWeakRef
        self._ref = StorageWeakRef
        self.live: Dict[int, tuple] = {}
        self.current = 0
        self.peak = 0
        # the arguments' storages (counted apart): their views are free
        self.known = {t.untyped_storage()._cdata for t in arguments}

    def _sweep(self):
        dead = [k for k, (r, _) in self.live.items() if r.expired()]
        for k in dead:
            self.current -= self.live.pop(k)[1]

    def _see(self, t):
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live or key in self.known:
            return
        n = st.nbytes()
        if self.current + n > self.peak:
            self._sweep()
        self.live[key] = (self._ref(st), n)
        self.current += n
        self.peak = max(self.peak, self.current)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            self._see(t)
        return out


def _tensors(tree):
    """Every tensor of a tree of dicts, sequences and dataclasses."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _tensors(getattr(tree, f.name))


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _meta_params(cell: Cell):
    """This rank's shards as fresh ``meta`` tensors: the whole params
    built on ``meta`` (``jax.eval_shape(init_params)``'s), cut."""
    full = cell.model.init_params(torch.Generator().manual_seed(0))
    return T.map_params(lambda v: torch.empty(v.shape, dtype=v.dtype,
                                              device="meta"),
                        cell.shard(full))


def count_cell(cell: Cell) -> Dict:
    """One run of ``cell``'s step on ``meta`` (its model built there):
    FLOPs, argument and peak bytes, collectives."""
    from torch.utils.flop_counter import FlopCounterMode
    params = _meta_params(cell)
    specs = input_specs(cell.cfg, cell.shape)
    batch = {k: torch.zeros(cell.rows(k, torch.empty(s.shape,
                                                     device="meta")).shape,
                            dtype=s.dtype, device="meta")
             for k, s in specs.items()}
    held = {"params": params, "batch": batch}
    if cell.shape.kind == "train":
        state = init_state(cell, params)
        held["opt_state"] = state.opt_state
        call = lambda: cell.plain(state, batch)           # noqa: E731
    elif cell.shape.kind == "prefill":
        call = lambda: cell.plain(params, batch["tokens"])  # noqa: E731
    else:
        cache = held["cache"] = cell.init_cache()
        call = lambda: cell.plain(params, batch["tokens"], cache)  # noqa
    args = {k: _tree_bytes(v) for k, v in held.items()}
    flops, coll, mem = FlopCounterMode(display=False), CollectiveCounter(), \
        MetaMemory(list(_tensors(list(held.values()))))
    with flops, coll, mem:
        call()
    arg_bytes = sum(args.values())
    peak = arg_bytes + mem.peak
    return {"flops": float(flops.get_total_flops()),
            "flops_by_op": {str(k): float(v) for k, v in
                            flops.get_flop_counts()["Global"].items()},
            "argument_bytes": args, "argument_total": arg_bytes,
            "peak_bytes": peak, "fits_h100": peak <= H100_BYTES,
            "collective_bytes": coll.bytes, "collective_counts": coll.counts}


# ---------------------------------------------------------------------------
# Depth probes (the reference's; eager counts need none, a test holds them
# equal)
# ---------------------------------------------------------------------------

def probe_plan(cfg: ModelConfig):
    """Returns (probe_cfgs, combine(costs) -> cost_dict)."""

    def rep(**kw):
        return cfg.replace(**kw)

    if cfg.family == "audio":
        units = cfg.num_layers          # enc and dec both scale 1:1
        probes = [rep(num_layers=1, num_encoder_layers=1),
                  rep(num_layers=2, num_encoder_layers=2)]
        comb = lambda c: _lin(c[0], c[1], units)           # noqa: E731
    elif cfg.family == "hybrid":
        per = cfg.shared_block_every
        units = cfg.num_layers // per
        probes = [rep(num_layers=per), rep(num_layers=2 * per)]
        comb = lambda c: _lin(c[0], c[1], units)           # noqa: E731
    elif cfg.local_global_pattern:
        g = cfg.local_global_pattern + 1
        n_groups = cfg.num_layers // g
        remn = cfg.num_layers - n_groups * g
        probes = [rep(num_layers=g), rep(num_layers=2 * g)]
        if remn:
            probes.append(rep(num_layers=g + remn))
            comb = lambda c: _add(_lin(c[0], c[1], n_groups),  # noqa: E731
                                  _sub(c[2], c[0]))
        else:
            comb = lambda c: _lin(c[0], c[1], n_groups)    # noqa: E731
    else:
        k0 = cfg.moe.first_k_dense if cfg.moe else 0
        units = cfg.num_layers - k0
        probes = [rep(num_layers=k0 + 1), rep(num_layers=k0 + 2)]
        comb = lambda c: _lin(c[0], c[1], units)           # noqa: E731
    return probes, comb


def _lin(c1, c2, units):
    return {k: c1.get(k, 0) + (c2.get(k, 0) - c1.get(k, 0)) * (units - 1)
            for k in set(c1) | set(c2)}


def _add(a, b):
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _sub(a, b):
    return {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}


def _linear_costs(counts: Dict) -> Dict[str, float]:
    """The costs that grow with depth: FLOPs and collectives."""
    out = {"flops": counts["flops"]}
    for k, v in counts["collective_bytes"].items():
        out[f"coll_{k}"] = float(v)
    for k, v in counts["collective_counts"].items():
        out[f"n_{k}"] = float(v)
    return out


def run_probes(arch: str, shape: InputShape, mesh, cfg=None
               ) -> Dict[str, float]:
    """The reference's extrapolation from its depth probes, on meta."""
    cfg = cfg or get_config(arch)
    probes, comb = probe_plan(cfg)
    return comb([_linear_costs(count_cell(build_cell(
        arch, shape, mesh, cfg=pc, device="meta"))) for pc in probes])


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, cfg=None, probes: bool = False) -> Dict:
    """The accounting of one cell (module docstring); ``status`` is
    ``ok``, ``skip`` (not applicable) or ``error``."""
    shape = shape_by_name(shape_name)
    cfg = cfg or get_config(arch)
    ok, reason = applicable(cfg, shape)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "skip", "reason": reason}
    if not ok:
        _save(result, save)
        return result
    mesh = make_production_mesh(multi_pod)
    t0 = time.time()
    try:
        cell = build_cell(arch, shape, mesh, cfg=cfg, device="meta")
        counts = count_cell(cell)
        result.update({
            "status": "ok", "reason": "",
            "phase": cell.phase,
            "count_s": round(time.time() - t0, 2),
            "num_devices": mesh.size(),
            "flops_per_device": counts["flops"],
            "flops_by_op": counts["flops_by_op"],
            "collective_bytes_per_device": counts["collective_bytes"],
            "collective_counts": counts["collective_counts"],
            "memory": {"argument_bytes": counts["argument_bytes"],
                       "argument_total": counts["argument_total"],
                       "peak_bytes_per_device": counts["peak_bytes"],
                       "fits_h100_80gib": counts["fits_h100"]},
        })
        if probes:
            result["roofline_corrected"] = run_probes(arch, shape, mesh, cfg)
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"({result['count_s']:.1f}s, {counts['flops']:.3e} "
              f"flops/dev, peak {counts['peak_bytes'] / 2**30:.2f} GiB)")
    except Exception as e:  # a failing cell is a bug: record it loudly
        result.update({"status": "error",
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-4000:]})
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAILED - "
              f"{type(e).__name__}: {e}")
    _save(result, save)
    return result


def _save(result: Dict, save: bool) -> None:
    if not save:
        return
    os.makedirs(RESULTS_DIR, exist_ok=True)
    name = f"{result['arch']}_{result['shape']}_{result['mesh']}.json"
    with open(os.path.join(RESULTS_DIR, name), "w") as f:
        json.dump(result, f, indent=2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--probes", action="store_true",
                    help="also count the reference's depth probes")
    ap.add_argument("--no-save", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="print each cell's result as one JSON line")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in ALL_SHAPES] if (args.all or not args.shape)
              else [args.shape])
    tally: Dict[str, int] = {}
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, mp, save=not args.no_save,
                             probes=args.probes)
                if args.json:
                    print(json.dumps({k: v for k, v in r.items()
                                      if k != "traceback"}))
                tally[r["status"]] = tally.get(r["status"], 0) + 1
    print(f"dry-run: {json.dumps(tally, sort_keys=True)}")
    if tally.get("error"):
        raise SystemExit(f"{tally['error']} dry-run cells FAILED")


if __name__ == "__main__":
    main()
