"""Paths over the nested parameter dicts (the reference's pytrees): dict
keys in sorted order, as ``jax.tree`` flattens them."""

from __future__ import annotations

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
