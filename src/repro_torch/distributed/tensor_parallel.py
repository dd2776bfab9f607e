"""Dense tensor parallelism and ZeRO-3 on ``torch.distributed``: the
layouts GSPMD gives the reference from its sharding table
(:mod:`repro_torch.distributed.sharding_rules`), made explicit.

Each rank holds its shard of every leaf the table places and runs the
block on its data rows:

* column-parallel linears (``col``, ``att_col``; the head) multiply the
  whole activation by this rank's columns, row-parallel ones (``row``,
  ``att_row``) this rank's columns of the activation by its rows and sum
  over ``model`` (:func:`row_linear`);
* the embedding is cut over the vocabulary (``embed`` ``(mp, None)``): each
  rank looks up the tokens of its rows of the table and the lookups are
  summed (:func:`embed_lookup`); the head's logits are this rank's vocab
  columns (gathered for serving, :func:`gather`), and the cross entropy is
  computed over the vocab shards (:func:`vocab_parallel_ce_sum`);
* ZeRO-3 (phase ``train``): a leaf also cut over the data axes is gathered
  at use, one layer at a time (:func:`gather_for_use`), and its gradient
  reduce-scattered back to the shard;
* the sequence-parallel residual of ``_block_train`` (``sp_residual``):
  between blocks the residual stream holds this rank's sequence positions
  (:func:`split`), gathered at the next block's start (:func:`gather`).

**Gradients.**  An activation that is replicated over ``model`` carries
the whole gradient on every rank of it (Megatron's convention), and a
rank's gradient over the data axes is its own rows' part.  So a
column-parallel input's backward sums over ``model`` (:func:`copy_to`), a
row-parallel output's is the identity (:func:`reduce_from`), a gather over
``model``'s backward takes this rank's part (:func:`gather`) and a split's
gathers (:func:`split`): none sums a gradient that a replicated downstream
computation has summed already.  A ZeRO-3 gather's backward
reduce-scatters over the data axes (it sums the rows' parts); every other
leaf's gradient is summed over the data axes by the train step.

A group of one rank is no collective: each function returns its input
itself (no copy), so a 1 x 1 mesh runs the one-device program.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import mesh_axes
from repro_torch.distributed.sharding_rules import placement_of


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _gloo_cuda(x: torch.Tensor, group) -> bool:
    """gloo ranks on the card (several ranks on one device, where NCCL
    refuses): gloo has no single-tensor gather / reduce-scatter for CUDA
    tensors, so those run as its list gather and a sum."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` in rank
    order."""
    n = _size(group)
    xm = x.movedim(dim, 0).contiguous()
    if _gloo_cuda(xm, group):
        parts = [torch.empty_like(xm) for _ in range(n)]
        dist.all_gather(parts, xm, group=group)
        out = torch.cat(parts)
    else:
        out = xm.new_empty((n * xm.shape[0], *xm.shape[1:]))
        _gather_into(out, xm, group=group)
    return out.movedim(0, dim).contiguous()       # the kernels take these


def _reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's block of ``dim``."""
    n = _size(group)
    xm = x.movedim(dim, 0).contiguous()
    if _gloo_cuda(xm, group):
        out = _block(_all_reduce(xm, group), 0, group)
    else:
        out = xm.new_empty((xm.shape[0] // n, *xm.shape[1:]))
        _scatter_into(out, xm, group=group)
    return out.movedim(0, dim).contiguous()


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = x.shape[dim] // _size(group)
    return x.narrow(dim, _rank(group) * n, n)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group).contiguous(), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherForUse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(w, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the backward sums the gradient over ``group`` (a
    column-parallel linear's input, a replicated leaf used on this rank's
    rows only)."""
    return x if _size(group) == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``; the backward is the identity (a
    row-parallel linear's output, per-rank partial sums)."""
    return x if _size(group) == 1 else _ReduceFrom.apply(x, group)


def gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's blocks concatenated along ``dim``; the backward takes
    this rank's block of the (replicated) gradient."""
    return x if _size(group) == 1 else _Gather.apply(x, dim, group)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's block of ``dim``; the backward gathers the blocks'
    gradients."""
    return x if _size(group) == 1 else _Split.apply(x, dim, group)


def gather_for_use(w: torch.Tensor, dim: int, group) -> torch.Tensor:
    """ZeRO-3: a leaf's shards over ``group`` gathered along ``dim``; the
    backward reduce-scatters the gradient back onto the shard."""
    return w if _size(group) == 1 else _GatherForUse.apply(w, dim, group)


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum over ``group`` (no gradient)."""
    x = x.detach()
    return x if _size(group) == 1 else _all_reduce(x, group)


def all_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over ``group`` (no gradient)."""
    x = x.detach()
    return x if _size(group) == 1 else _all_reduce(x, group,
                                                    dist.ReduceOp.MAX)


# ------------------------------------------------------------ the layers

def col_linear(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """x (..., d) replicated over ``group`` times this rank's columns of
    w: this rank's columns of the product."""
    return copy_to(x, group) @ w


def row_linear(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """This rank's columns of x times its rows of w, summed over
    ``group``."""
    return reduce_from(x @ w, group)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor,
                 group) -> torch.Tensor:
    """Rows ``tokens`` of a table cut over its rows (the vocabulary) on
    ``group``: each rank looks up the tokens in its rows, zeros elsewhere,
    and the lookups are summed (exact: one term is nonzero)."""
    if _size(group) == 1:
        return table[tokens]
    n = table.shape[0]
    lo = _rank(group) * n
    mine = (tokens >= lo) & (tokens < lo + n)
    rows = table[(tokens - lo).clamp(0, n - 1)]
    return reduce_from(torch.where(mine[..., None], rows, 0), group)


def vocab_parallel_ce_sum(logits: torch.Tensor, labels: torch.Tensor,
                          group) -> torch.Tensor:
    """Sum over positions of ``logsumexp(logits) - logits[label]`` where
    ``logits (..., V / n)`` (fp32) is this rank's vocab block on
    ``group``: one MAX and two SUMs over the group, the logits never
    gathered."""
    n = logits.shape[-1]
    lo = _rank(group) * n
    m = all_max(logits.amax(dim=-1), group)
    se = reduce_from(torch.exp(logits - m[..., None]).sum(-1), group)
    mine = (labels >= lo) & (labels < lo + n)
    gold = torch.gather(logits, -1, (labels - lo).clamp(0, n - 1)[..., None])
    gold = reduce_from(torch.where(mine, gold[..., 0], 0.0), group)
    return (torch.log(se) + m - gold).sum()


def axes_group(mesh, axes: Sequence[str]):
    """The process group over ``axes`` of ``mesh`` (None when they span
    one rank)."""
    axes = tuple(axes)
    if not axes or mesh_axes.axes_size(mesh, axes) == 1:
        return None
    return mesh_axes.axes_group(mesh, axes)


def dims_over(spec, axes: Sequence[str]) -> list:
    """(dim, the axes of ``axes`` that cut it) for each dim of a
    placement cut over any of ``axes``."""
    out = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = (entry,) if isinstance(entry, str) else tuple(entry)
        hit = tuple(a for a in names if a in axes)
        if hit:
            out.append((dim, hit))
    return out



# ------------------------------------------------- a context's layout

@dataclasses.dataclass(frozen=True)
class Layout:
    """What a step executes of the sharding table on this rank: the
    table's ``phase``, the process groups of the ``model`` axis and of the
    data axes (None: one rank), and the axis names the table is written
    in."""

    phase: str
    model: object
    data: object
    dp: Tuple[str, ...]
    mp: str = "model"

    @property
    def n_model(self) -> int:
        return _size(self.model)

    @property
    def model_index(self) -> int:
        return _rank(self.model)

    @property
    def n_data(self) -> int:
        return _size(self.data)

    def attention_cut(self) -> bool:
        """The attention projections are cut over ``model`` (every phase
        but ``decode``, which keeps them whole beside a slot-sharded
        cache)."""
        return self.phase != "decode" and self.n_model > 1

    def whole_heads(self, cfg) -> bool:
        """Each rank's column block of q / k / v holds whole heads (and
        its q heads' kv heads): attention runs on this rank's heads."""
        n = self.n_model
        return cfg.num_heads % n == 0 and cfg.num_kv_heads % n == 0


def layout(mesh, phase: Optional[str], dp: Sequence[str],
           mp: str = "model") -> Optional[Layout]:
    """The layout of ``phase`` on ``mesh`` (None without a mesh or a
    phase: dense weights whole on every rank)."""
    if mesh is None or phase is None:
        return None
    dp = tuple(dp)
    return Layout(phase=phase, model=axes_group(mesh, (mp,)),
                  data=axes_group(mesh, dp), dp=dp, mp=mp)


def gather_params(tree, lay: Optional[Layout], prefix: str = ""):
    """ZeRO-3's gather at use: every leaf of ``tree`` (a layer's params,
    paths under ``prefix``) that the table cuts over the data axes in
    ``lay.phase``, gathered along those dims (:func:`gather_for_use`);
    the other leaves as they are."""
    if lay is None or lay.data is None:
        return tree

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        spec = placement_of(path, node.shape, lay.phase, lay.dp, lay.mp)
        for dim, _ in dims_over(spec, lay.dp):
            node = gather_for_use(node, dim, lay.data)
        return node
    return walk(tree, prefix)


@dataclasses.dataclass(frozen=True)
class LeafShards:
    """How one leaf is cut on the mesh, for the optimizer's and the norm's
    reductions: the process groups over the axes that cut the whole leaf,
    its second-to-last dim (rows) and its last dim (columns) (None: not
    cut), the leaf's whole shape, and whether a data axis cuts it
    (ZeRO-3: its gradient arrives summed over the data axes)."""

    whole: Tuple[int, ...]
    all: object = None
    rows: object = None
    cols: object = None
    data_cut: bool = False


def leaf_shards(params, mesh, lay: Layout):
    """A :class:`LeafShards` per leaf of this rank's ``params`` (a tree
    of shards under ``lay``'s phase), built in the sorted order of the
    paths, so every rank makes the same groups in the same order."""
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))

    def group(axes):
        return axes_group(mesh, [a for a in names if a in axes])

    def one(path, leaf):
        spec = placement_of(path, leaf.shape, lay.phase, lay.dp, lay.mp)
        spec = tuple(spec) + (None,) * (leaf.dim() - len(spec))
        cut = dict(dims_over(spec, names))
        whole = tuple(n * math.prod(sizes[a] for a in cut.get(d, ()))
                      for d, n in enumerate(leaf.shape))
        every = {a for axes in cut.values() for a in axes}
        nd = leaf.dim()
        return LeafShards(
            whole=whole, all=group(every),
            rows=group(cut.get(nd - 2, ())) if nd >= 2 else None,
            cols=group(cut.get(nd - 1, ())) if nd >= 1 else None,
            data_cut=bool(every & set(lay.dp)))

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(node[k], f"{path}/{k}" if path else k)
                    for k in sorted(node)}
        return one(path, node)
    return walk(params, "")
