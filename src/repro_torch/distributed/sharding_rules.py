"""Sharding rules: parameter / batch / cache placements per (arch family,
phase) — counterpart of ``src/repro/distributed/sharding_rules.py`` and of
the dry-run's ``_cache_sharding_specs``.

A placement is a tuple with one entry per dim: ``None`` (whole), an axis
name, or a tuple of axis names (the dim split over them jointly, the first
major); ``()`` is a replicated leaf.  Entries of one axis are written as
the bare name, as ``PartitionSpec`` writes them.

Mesh axes: ``("pod",) data, model``.  Phases:

* ``serve`` — dense weights tensor-parallel over ``model``; expert banks
  sharded over ``model`` (the logical servers), replicated over data;
* ``train`` — the same TP layout + ZeRO-3 (the non-server dim of every
  large tensor also over ``data``);
* ``decode`` — attention projections replicated (the KV cache is
  slot-sharded over ``model`` instead);
* ``train_tp`` — ``serve``'s layout for training models that fit
  replicated over data.

Placements are matched by parameter path suffix; stacked layer dims are
padded with ``None``.  The table is the reference's, as data.
:func:`shard_params` executes it: with ``dense=True`` every leaf as the
table places it (the decoder family's dense tensor-parallel and ZeRO-3
layouts, run by :mod:`repro_torch.distributed.tensor_parallel`); without,
the serving path's narrower layout: the expert banks over ``model`` and
the leaves of rwkv6's tensor-parallel island in its own layout, dense
weights whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

from repro_torch.models.rwkv import ISLAND_PLACEMENTS

Placement = Tuple


def _axes(a):
    """One axis as its name, several as a tuple (``PartitionSpec``'s
    spelling)."""
    if isinstance(a, (tuple, list)):
        return a[0] if len(a) == 1 else tuple(a)
    return a


def _rules(dp, mp: str):
    """(path suffix, core dims, (serve, train, decode) placements of the
    trailing dims)."""
    col = ((None, mp), (dp, mp), (None, mp))
    row = ((mp, None), (mp, dp), (mp, None))
    repl2 = ((None, None),) * 3
    att_col = ((None, mp), (dp, mp), (None, None))
    att_row = ((mp, None), (mp, dp), (None, None))
    expert = ((mp, None, None, None), (mp, None, dp, None),
              (mp, None, None, None))
    return [
        # embeddings / head
        ("embed", 2, ((mp, None), (mp, dp), (mp, None))),
        ("head", 2, col),
        # expert service tier (S, L, d|f, f|d)
        ("servers/w_gate", 4, expert),
        ("servers/w_up", 4, expert),
        ("servers/w_down", 4, expert),
        ("servers/local_table", 2, ((mp, None),) * 3),
        ("w_router", 2, repl2),
        # attention
        ("wq", 2, att_col), ("wk", 2, att_col),
        ("wv", 2, att_col), ("wo", 2, att_row),
        # dense / shared / residual FFN
        ("w_gate", 2, col), ("w_up", 2, col), ("w_down", 2, row),
        # mamba
        ("in_proj", 2, col), ("out_proj", 2, row),
        ("conv_w", 2, ((None, mp),) * 3),
        # rwkv
        ("cmix/w_r", 2, repl2),
        ("w_r", 2, col), ("w_k", 2, col), ("w_v", 2, row),
        ("w_g", 2, col), ("w_o", 2, row),
        ("decay_A", 2, repl2),
        ("decay_B", 2, col),
        ("decay_w0", 1, ((mp,),) * 3),
        ("bonus_u", 2, ((mp, None),) * 3),
        ("tmix/ln_scale", 1, ((mp,),) * 3),
    ]


_PHASE_IDX = {"serve": 0, "train": 1, "decode": 2, "train_tp": 0}


def train_phase_for(total_params: int, model_parallel: int = 16,
                    budget_bytes: int = 4 * 2**30) -> str:
    """ZeRO-3 only when bf16 params + grads per chip exceed the budget."""
    per_chip = 2 * 2 * total_params // model_parallel   # weights + grads
    return "train" if per_chip > budget_bytes else "train_tp"


def _match(path: str, shape, phase: str, dp, mp: str) -> Placement:
    idx = _PHASE_IDX[phase]
    for suffix, core_ndim, specs in _rules(dp, mp):
        if path.endswith(suffix) and len(shape) >= core_ndim:
            pad = len(shape) - core_ndim
            return (None,) * pad + tuple(_axes(a) if a is not None else None
                                         for a in specs[idx])
    return ()                                    # replicated


def placement_of(path: str, shape, phase: str, dp, mp: str = "model"
                 ) -> Placement:
    """The table's placement of one leaf (its path, its shape) in
    ``phase``; ``dp`` the data axes (a tuple, or one name)."""
    return _match(path, tuple(shape), phase, _axes(dp), mp)


def _map(fn, tree, path: str = ""):
    """``fn(path, leaf)`` over dicts, dataclasses (a KV cache) and named
    tuples (a recurrent state); a leaf has a ``shape``, anything else (a
    ring's window) is kept."""
    join = lambda k: f"{path}/{k}" if path else str(k)   # noqa: E731
    if isinstance(tree, dict):
        return {k: _map(fn, v, join(k)) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name), join(f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, join(k))
                            for k, v in zip(tree._fields, tree)))
    if hasattr(tree, "shape"):
        return fn(path, tree)
    return tree


def param_placements(params, phase: str = "serve", dp="data",
                     mp: str = "model"):
    """Placement tree matching ``params`` (anything with shapes).  ``dp``
    may be a tuple of axes (two pods: ("pod", "data") jointly)."""
    dp = _axes(dp)
    return _map(lambda p, leaf: _match(p, tuple(leaf.shape), phase, dp, mp),
                params)


def adafactor_state_placements(params, placements):
    """Adafactor's factored state: ``vr`` drops the last param dim, ``vc``
    the second-to-last, each keeping the surviving dims' placement."""
    def one(leaf, spec):
        nd = len(leaf.shape)
        full = list(spec) + [None] * (nd - len(spec))
        if nd >= 2:
            return {"vr": tuple(full[:-1]), "vc": (*full[:-2], full[-1])}
        return {"v": tuple(full)}

    def walk(p, s):
        if isinstance(p, dict):
            return {k: walk(p[k], s[k]) for k in p}
        return one(p, s)
    return {"f": walk(params, placements)}


def batch_placements(dp_axes: Tuple[str, ...]) -> Placement:
    """tokens / labels (B, S): batch over the data axes."""
    return (_axes(dp_axes), None)


def cache_placements(cache, batch: int, dp: Tuple[str, ...],
                     seq_axes: Tuple[str, ...], seq_len: int):
    """Slots (the dim of size ``seq_len``) over ``seq_axes``, the batch dim
    over the data axes (when batch > 1 and data isn't used for slots).
    Leaves without either dim (ring windows, SSM states, cross-attention
    K/V) stay batch-sharded or replicated."""
    batch_ok = batch > 1 and not set(dp) & set(seq_axes or ())

    def one(_, leaf):
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        start = 1 if len(shape) >= 3 else 0    # batch is never dim 0 there
        if seq_axes:
            for i, d in enumerate(shape):
                if d == seq_len:
                    spec[i] = _axes(seq_axes)
                    if batch_ok:
                        for j in range(start, len(shape)):
                            if j != i and shape[j] == batch:
                                spec[j] = _axes(dp)
                                break
                    return tuple(spec)
        if batch > 1:
            for i in range(start, len(shape)):
                if shape[i] == batch:
                    spec[i] = _axes(dp)
                    return tuple(spec)
        return tuple(spec)

    return _map(one, cache)


# ----------------------------------------------------------- executing them

def shard_leaf(leaf, placement: Placement, sizes: Mapping[str, int],
               coord: Mapping[str, int]):
    """This rank's block of ``leaf`` (a tensor or a numpy array; a view):
    each dim placed over axes is cut into their joint size, the block at
    this rank's flattened coordinate taken."""
    index = []
    for dim, axes in enumerate(placement):
        if axes is None:
            index.append(slice(None))
            continue
        axes = (axes,) if isinstance(axes, str) else axes
        n, i = 1, 0
        for a in axes:
            n, i = n * sizes[a], i * sizes[a] + coord[a]
        size = leaf.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of {tuple(leaf.shape)} does not "
                             f"split over {axes} ({n} ways)")
        step = size // n
        index.append(slice(i * step, (i + 1) * step))
    return leaf[tuple(index)]


def _executed(path: str, spec: Placement, ndim: int,
              dense: bool = False) -> Placement:
    """The part of ``spec`` the port executes: all of it with ``dense``;
    else the expert tier over the model axis, rwkv6's island leaves in the
    island's own layout (its time-mix ``w_v`` is column-parallel, not the
    table's row) and every other leaf whole."""
    if dense:
        return spec
    if "/servers/" in f"/{path}":
        return tuple(a if a == "model" else None for a in spec)
    parts = path.split("/")
    if len(parts) >= 2 and parts[-2] in ("tmix", "cmix"):
        core = ISLAND_PLACEMENTS[parts[-2]].get(parts[-1])
        if core is not None:
            return (None,) * (ndim - len(core)) + core
    return ()


def shard_params(full, mesh, phase: str = "serve", dense: bool = False):
    """This rank's slice of a whole params tree (tensors or numpy arrays)
    on ``mesh`` (anything with ``mesh_dim_names``, ``shape`` and
    ``get_coordinate()``, as a ``DeviceMesh``) in ``phase``: every leaf as
    the table places it with ``dense``, else the serving layout (see
    :func:`_executed`); slices are views, so a 1 x 1 mesh copies
    nothing."""
    names = tuple(mesh.mesh_dim_names)
    sizes: Dict[str, int] = dict(zip(names, mesh.shape))
    coord = dict(zip(names, mesh.get_coordinate()))
    dp = tuple(a for a in names if a != "model")
    placements = param_placements(full, phase, dp=dp)

    def one(path, leaf):
        spec = _executed(path, _get(placements, path), leaf.ndim, dense)
        return shard_leaf(leaf, spec, sizes, coord)
    return _map(one, full)


def _get(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree
