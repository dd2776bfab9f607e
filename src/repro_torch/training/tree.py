"""Paths over the nested parameter dicts (the reference's pytrees): dict
keys in sorted order, as ``jax.tree`` flattens them; and over caches
(dicts of KV caches and recurrent states) and their placement trees."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, Tuple

import torch


def items(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """(path, leaf) of every tensor leaf, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], prefix + (k,))
    elif tree is not None:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def get(tree, path: Tuple) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def map_params(fn: Callable, params, *others):
    """``fn(p, *o)`` at every leaf of ``params``, where each ``o`` is the
    subtree of ``others`` at the same path (a leaf, or the per-leaf dict of
    a factored state): the reference's ``flatten_up_to``."""
    if isinstance(params, dict):
        return {k: map_params(fn, params[k], *(o[k] for o in others))
                for k in params}
    return fn(params, *others)


# ------------------------------------------------- caches and placement trees

def _children(node):
    """(key, child) of an inner node of a cache or placement tree — a
    dict (keys in order), a KV cache (a dataclass: its fields but a
    ring's ``window``) or a recurrent state (a named tuple) — or None
    for a leaf."""
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)
                if not isinstance(getattr(node, f.name), int)]
    return None


def paths(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) of every leaf of a cache (dicts, KV caches, recurrent
    states) or of its placement tree, in order."""
    kids = _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k, v in kids:
        yield from paths(v, prefix + (k,))


def map_paths(fn: Callable, tree, *others, prefix: Tuple = ()):
    """``tree`` with ``fn(path, leaf, *o)`` at every leaf, where each
    ``o`` is the leaf of ``others`` (trees of ``tree``'s structure, a
    placement tree) at the same path."""
    kids = _children(tree)
    if kids is None:
        return fn(prefix, tree, *others)
    new = {k: map_paths(fn, v, *(o[k] if isinstance(o, dict)
                                 else getattr(o, k) for o in others),
                        prefix=prefix + (k,))
           for k, v in kids}
    if isinstance(tree, dict):
        return new
    if hasattr(tree, "_replace"):
        return tree._replace(**new)
    return dataclasses.replace(tree, **new)
