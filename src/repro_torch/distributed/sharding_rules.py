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
table places it (every family's dense tensor-parallel and ZeRO-3
layouts, run by :mod:`repro_torch.distributed.tensor_parallel`; rwkv6's
time-mix ``w_v`` cut as its island takes it, :func:`placement_of`); without,
the serving path's narrower layout: the expert banks over ``model`` and
the leaves of rwkv6's tensor-parallel island in its own layout, dense
weights whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

from repro_torch.training.tree import map_paths

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


# The layout of rwkv6's tensor-parallel island (``rwkv.rwkv_block_spmd``;
# the reference's in_specs, one layer's leaves): projections
# column-sharded over the model axis, w_o and the channel-mix w_v
# row-sharded, the per-channel decay, bonus and group-norm scale with
# their heads; the shift mixes, the decay's LoRA down-projection and the
# channel-mix gate whole.
_COL, _ROW, _WHOLE = (None, "model"), ("model", None), (None, None)
ISLAND_PLACEMENTS: Dict[str, Dict[str, tuple]] = {
    "tmix": {"mu": _WHOLE, "w_r": _COL, "w_k": _COL, "w_v": _COL,
             "w_g": _COL, "w_o": _ROW, "decay_w0": ("model",),
             "decay_A": _WHOLE, "decay_B": _COL, "bonus_u": _ROW,
             "ln_scale": ("model",)},
    "cmix": {"mu": _WHOLE, "w_k": _COL, "w_v": _ROW, "w_r": _WHOLE},
}


def _recut(path: str, spec: Placement) -> Placement:
    """The table matches rwkv6's time-mix ``w_v`` as row-parallel (suffix
    ``w_v``); the island takes it column-parallel.  The port cuts it so
    when the params are sharded — its two trailing cuts swapped — where
    the reference's GSPMD reshards it at every use."""
    if path.endswith("tmix/w_v") and len(spec) >= 2:
        return (*spec[:-2], spec[-1], spec[-2])
    return spec


def placement_of(path: str, shape, phase: str, dp, mp: str = "model"
                 ) -> Placement:
    """The placement the port executes for one leaf (its path, its shape)
    in ``phase`` under the table's layouts: the table's, but rwkv6's
    time-mix ``w_v`` cut as the island takes it (:func:`_recut`); ``dp``
    the data axes (a tuple, or one name)."""
    return _recut(path, _match(path, tuple(shape), phase, _axes(dp), mp))


def param_placements(params, phase: str = "serve", dp="data",
                     mp: str = "model"):
    """Placement tree matching ``params`` (anything with shapes).  ``dp``
    may be a tuple of axes (two pods: ("pod", "data") jointly)."""
    dp = _axes(dp)
    return map_paths(lambda p, leaf: _match("/".join(p), tuple(leaf.shape),
                                            phase, dp, mp), params)


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


# The roles of a cache's leaves, by the leaf's name: (batch dim, slot
# dim, head dim), each counted from the end (stacked layer dims lead; None:
# the leaf has no such dim).
CACHE_ROLES: Dict[str, tuple] = {
    # a KV cache's k / v (..., B, slots, KV, hd) and length (..., B)
    "k": (-4, -3, None), "v": (-4, -3, None), "length": (-1, None, None),
    # whisper's encoder K/V (..., B, S_enc, KV, hd): never slot-sharded
    "cross_k": (-4, None, None), "cross_v": (-4, None, None),
    # a Mamba state: ssm (..., B, H, P, N), conv (..., B, K - 1, d_inner)
    "ssm": (-4, None, None), "conv": (-3, None, None),
    # an RWKV state: wkv (..., B, H, D, D), its heads over the model axis
    # (the island's: each rank holds its heads); shifts (..., B, d)
    "wkv": (-4, None, -3), "shift_tmix": (-2, None, None),
    "shift_cmix": (-2, None, None),
}


def cache_placements(cache, batch: int, dp: Tuple[str, ...],
                     seq_axes: Tuple[str, ...], seq_len: int,
                     mp: str = "model"):
    """The reference's ``_cache_sharding_specs`` by role
    (:data:`CACHE_ROLES`, from each leaf's name): a leaf's slots over
    ``seq_axes`` where it holds ``seq_len`` slots (a sliding window's ring
    never does), its batch over the data axes (when batch > 1, and, under
    slot sharding, when the data axes cut no slots); every other leaf's
    batch over the data axes.  On every cell of the assigned shapes the
    roles give the reference's placements, where the port's gemma3 local
    stack flattens the reference's (groups, pattern) axes into one."""
    dp, seq = _axes(dp), _axes(seq_axes) if seq_axes else None
    batch_ok = batch > 1 and not set(_names(dp)) & set(seq_axes or ())

    def spec(path, leaf):
        b, slots, heads = CACHE_ROLES[path[-1]]
        out = [None] * leaf.ndim
        nd = leaf.ndim
        if slots is not None and seq and leaf.shape[nd + slots] == seq_len:
            out[nd + slots] = seq
            if batch_ok:
                out[nd + b] = dp
        elif batch > 1:
            out[nd + b] = dp
        if heads is not None:
            out[nd + heads] = mp
        return tuple(out)

    return map_paths(spec, cache)


def _names(axes) -> tuple:
    return (axes,) if isinstance(axes, str) else tuple(axes)


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
    """The part of the table's ``spec`` the port executes: all of it with
    ``dense``, rwkv6's time-mix ``w_v`` re-cut (:func:`_recut`); else the
    expert tier over the model axis, rwkv6's island leaves in the island's
    own layout and every other leaf whole."""
    if dense:
        return _recut(path, spec)
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

    def one(path, leaf, spec):
        spec = _executed("/".join(path), spec, leaf.ndim, dense)
        return shard_leaf(leaf, spec, sizes, coord)
    return map_paths(one, full, placements)
