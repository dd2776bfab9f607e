"""Checkpoints (counterpart of ``src/repro/training/checkpoint.py``) in the
reference's on-disk format, so either package restores the other's:

    <dir>/step_<N:08d>/<flat.param.path>.npy + manifest.json

Each leaf is saved as its raw bytes (a uint8 ``.npy``, the reference's
byte view) and the manifest names its shape and numpy dtype.  Paths are
the reference's: dict keys, NamedTuple field names (``params``,
``opt_state``, ``step``), sequence indices, joined by "/"; None leaves
(an absent ``ef_residual``) are skipped.  Writes go to ``step_<N>.tmp``
and are renamed once the manifest is fsynced, so a killed writer never
corrupts the latest checkpoint.

bfloat16 needs no ``ml_dtypes`` (which the port does not require): its
bytes are taken with ``tensor.view(torch.uint8)`` and restored with
``.view(torch.bfloat16)``; the manifest says ``"bfloat16"``, as numpy's
ml_dtypes name does.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

_TORCH_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.float64: "float64",
                torch.int64: "int64", torch.int32: "int32",
                torch.int16: "int16", torch.int8: "int8",
                torch.uint8: "uint8", torch.bool: "bool"}


def _children(node):
    """(key, child) pairs of a tree node, or None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, object]:
    flat = {}
    kids = _children(tree)
    if kids is None:
        if tree is not None:
            flat[prefix] = tree
        return flat
    for k, c in kids:
        flat.update(_flatten(c, f"{prefix}/{k}" if prefix else k))
    return flat


def _raw(leaf):
    """(uint8 bytes array shaped as the reference's byte view, shape,
    dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        shape, name = list(t.shape), _TORCH_NAMES[t.dtype]
        t = t.reshape(1) if t.dim() == 0 else t
        return t.view(torch.uint8).numpy(), shape, name
    arr = np.asarray(leaf)
    return (np.ascontiguousarray(arr).view(np.uint8), list(arr.shape),
            str(arr.dtype))


def save_checkpoint(directory: str, step: int, tree, *,
                    keep: int = 3) -> str:
    """Synchronous atomic save; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {}
    for key, leaf in _flatten(tree).items():
        fname = key.replace("/", ".") + ".npy"
        raw, shape, name = _raw(leaf)
        np.save(os.path.join(tmp, fname), raw)
        manifest[key] = {"file": fname, "shape": shape, "dtype": name}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "params": manifest}, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic commit
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d))


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _load(path: str, meta: Dict, like):
    """A saved leaf as a tensor on ``like``'s device (requiring grad if it
    does), or as numpy when ``like`` is not a tensor (bfloat16 stays a
    tensor: numpy has no such type without ml_dtypes)."""
    raw = np.load(os.path.join(path, meta["file"]))
    shape = tuple(meta["shape"])
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(raw)).view(
            torch.bfloat16).reshape(shape)
    else:
        arr = raw.view(np.dtype(meta["dtype"])).reshape(shape)
        if not isinstance(like, torch.Tensor):
            return arr
        t = torch.from_numpy(arr.copy())
    if isinstance(like, torch.Tensor):
        t = t.to(like.device)
        if like.requires_grad:
            t.requires_grad_(True)
    return t


def _rebuild(like, path: str, manifest: Dict, prefix: str = ""):
    kids = _children(like)
    if kids is None:
        if like is None:
            return None
        meta = manifest[prefix]
        out = _load(path, meta, like)
        if tuple(out.shape) != tuple(like.shape):
            raise ValueError(f"{prefix}: checkpoint shape {tuple(out.shape)}"
                             f" != {tuple(like.shape)}")
        return out
    vals = [_rebuild(c, path, manifest, f"{prefix}/{k}" if prefix else k)
            for k, c in kids]
    if isinstance(like, dict):
        return {k: v for (k, _), v in zip(kids, vals)}
    if hasattr(like, "_fields"):
        return type(like)(*vals)
    return type(like)(vals)


def restore_checkpoint(directory: str, tree_like, step: Optional[int] = None,
                       *, into: bool = False):
    """Restore into the structure of ``tree_like`` (shapes must match);
    returns (tree, step).  With ``into``, every saved leaf is copied into
    ``tree_like``'s own tensor (dtypes must match too) and ``tree_like``
    is returned: a resumed train step keeps its CUDA graph, which reads
    the state at its addresses (``train_loop.compile_train_step``)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)["params"]
    tree = _rebuild(tree_like, path, manifest)
    if not into:
        return tree, step
    loaded = _flatten(tree)
    with torch.no_grad():
        for key, dst in _flatten(tree_like).items():
            if not isinstance(dst, torch.Tensor) \
                    or loaded[key].dtype != dst.dtype:
                raise ValueError(f"{key}: restoring into a non-tensor or "
                                 f"into another dtype")
            dst.copy_(loaded[key])
    return tree_like, step


class AsyncCheckpointer:
    """Background-thread writer: training does not wait on I/O.  The
    device -> host copy happens on the caller's thread (a snapshot: the
    train step updates params in place), serialisation and fsync on the
    worker.  ``wait()`` drains pending writes (call it before exit)."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, tree) -> None:
        self.wait()
        host = _snapshot(tree)

        def work():
            try:
                save_checkpoint(self.directory, step, host, keep=self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _snapshot(tree):
    kids = _children(tree)
    if kids is None:
        if isinstance(tree, torch.Tensor):
            return tree.detach().to("cpu", copy=True)
        return None if tree is None else np.array(tree)
    vals = [_snapshot(c) for _, c in kids]
    if isinstance(tree, dict):
        return {k: v for (k, _), v in zip(kids, vals)}
    if hasattr(tree, "_fields"):
        return type(tree)(*vals)
    return type(tree)(vals)
