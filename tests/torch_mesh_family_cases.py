"""Shared machinery of the family cells' parity tests
(``tests/test_torch_mesh_*_families.py``): the dry-run cells of gemma3,
whisper, zamba2 and rwkv6 executed on 8 gloo ranks of a (2, 4) mesh
(``tests/torch_spmd_ranks.py``, ``cell:`` cases) against the JAX
package's ``build_cell`` on 8 host devices.

* :func:`write_inputs`: each case's reduced float32 config (with the
  case's overrides), the JAX package's params, numpy tokens / labels /
  frames and, for a decode cell, a whole cache in the reference's layout
  (every leaf under ``cache/<path>``), in one ``.npz``.
* :data:`JAX_SIDE`: the reference's cells on that mesh: a train step's
  metrics and updated params, a prefill's logits and cache, a serve step's
  logits (with the cell's context), next token and cache.
* :func:`run`: the JAX subprocess and the gloo world side by side.
* :func:`rank_shard`: a rank's expected shard of a whole reference array,
  cut as the port places it (``sharding_rules``), the reference's gemma3
  local stack flattened first.
"""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.distributed import sharding_rules as tsr
from repro_torch.models.transformer import build_model
from repro_torch.training import tree as T

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 240          # seconds a subprocess may take before it fails
B, S = 8, 48           # the cells' global batch and slots / sequence
DECODE_LEN = 20        # tokens already in the decode cells' caches
MESH = (2, 4)

# family: (arch, the config's overrides).  gemma3: 8 layers (one group of
# 5 local + 1 global layers, then 2 local), a 16-slot ring (not the cells'
# 48: the ring is not slot-sharded, and a 20-token cache wraps it);
# whisper: 2 heads, which do not split whole over 4 model ranks;
# zamba2: reduced as it is (in_proj's 552 columns over 4 ranks straddle
# its segments); rwkv6: reduced as it is.
FAMILIES = {
    "g3": ("gemma3-4b", {"num_layers": 8, "sliding_window": 16}),
    "wh": ("whisper-base", {"num_heads": 2, "num_kv_heads": 2}),
    "z2": ("zamba2-2.7b", {}),
    "rw": ("rwkv6-7b", {}),
}
KINDS = ("train", "prefill", "decode")


def cfg_of(family: str):
    """(the JAX config, the port's config) of a family's cases."""
    arch, over = FAMILIES[family]
    return (jget_config(arch).reduced().replace(dtype="float32", **over),
            get_config(arch).reduced().replace(dtype="float32", **over))


def _path(key_path) -> str:
    out = []
    for p in key_path:
        for attr in ("key", "name", "idx"):
            if hasattr(p, attr):
                out.append(str(getattr(p, attr)))
                break
    return "/".join(out)


def _put(out: dict, prefix: str, tree) -> None:
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{prefix}/{_path(kp)}"] = np.asarray(leaf)


def _random_cache(jm, rng) -> dict:
    """The reference's cache of B rows and S slots, random: K/V written up
    to DECODE_LEN (a ring everywhere), lengths DECODE_LEN, states and the
    encoder's K/V random."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            jm.init_cache(B, S))[0]:
        path, shape = _path(kp), tuple(leaf.shape)
        if path.endswith("length"):
            a = np.full(shape, DECODE_LEN, np.int32)
        else:
            a = rng.normal(size=shape).astype(np.float32)
            if (path.endswith("/k") or path.endswith("/v")) and \
                    shape[-3] == S:
                a[..., DECODE_LEN:, :, :] = 0.0
        out[path] = a
    return out


def write_inputs(path: Path, families) -> dict:
    """Every case of ``families``: params, data and caches, as numpy."""
    rng = np.random.default_rng(0)
    out, cases = {}, []
    for i, fam in enumerate(families):
        jcfg, _ = cfg_of(fam)
        jm = jbuild_model(jcfg)
        params = jm.init_params(jax.random.PRNGKey(i))
        for kind in KINDS:
            case = f"{fam}_{kind}"
            key = f"cell/{case}"
            cases.append(case)
            arch, over = FAMILIES[fam]
            out[key + "/arch"], out[key + "/dtype"] = np.array(arch), \
                np.array("float32")
            out[key + "/overrides"] = np.array(json.dumps(over))
            out[key + "/kind"], out[key + "/force"] = np.array(kind), \
                np.array("")
            out[key + "/mesh"] = np.array(MESH)
            out[key + "/shape"] = np.array((B, S))
            _put(out, key + "/params", params)
            if kind == "decode":
                out[key + "/tokens"] = rng.integers(
                    0, jcfg.vocab_size, (B, 1)).astype(np.int32)
                for p, a in _random_cache(jm, rng).items():
                    out[f"{key}/cache/{p}"] = a
                continue
            out[key + "/tokens"] = rng.integers(
                0, jcfg.vocab_size, (B, S)).astype(np.int32)
            if kind == "train":
                out[key + "/labels"] = rng.integers(
                    0, jcfg.vocab_size, (B, S)).astype(np.int32)
                if jcfg.is_encoder_decoder:
                    out[key + "/frames"] = (0.1 * rng.normal(size=(
                        B, jcfg.encoder_seq_len, jcfg.d_model))).astype(
                            np.float32)
    out["cell/cases"] = np.array(",".join(cases))
    np.savez(path, **out)
    return out


JAX_SIDE = textwrap.dedent("""
    import json, os, sys
    import repro.launch.dryrun as rd        # sets 512 host devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import InputShape, get_config
    from repro.models.transformer import ParallelCtx, build_model
    from repro.training.train_loop import TrainState

    inp = dict(np.load(sys.argv[1]))
    res = {}

    def path(kp):
        out = []
        for p in kp:
            for attr in ("key", "name", "idx"):
                if hasattr(p, attr):
                    out.append(str(getattr(p, attr)))
                    break
        return "/".join(out)

    def params_of(prefix):
        out = {}
        for key, val in inp.items():
            if key.startswith(prefix + "/"):
                node = out
                *parents, leaf = key[len(prefix) + 1:].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(val)
        return out

    def put_tree(prefix, tree):
        for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            res[prefix + "/" + path(kp)] = np.asarray(leaf)

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    for case in str(inp["cell/cases"]).split(","):
        key = "cell/" + case
        cfg = get_config(str(inp[key + "/arch"])).reduced().replace(
            dtype="float32", **json.loads(str(inp[key + "/overrides"])))
        kind = str(inp[key + "/kind"])
        Bg, Sg = (int(v) for v in inp[key + "/shape"])
        shape = InputShape(case, Sg, Bg, kind)
        params = params_of(key + "/params")
        tokens = jnp.asarray(inp[key + "/tokens"])
        fn, _ = rd.build_cell(cfg.arch_id, shape, mesh, cfg=cfg)
        if kind == "train":
            opt = rd.adafactor(lr=1e-3)
            state = TrainState(params=params, opt_state=opt.init(params),
                               step=jnp.zeros((), jnp.int32))
            batch = {k: jnp.asarray(inp[f"{key}/{k}"])
                     for k in ("tokens", "labels", "frames")
                     if f"{key}/{k}" in inp}
            new, met = fn(state, batch)
            for k in ("loss", "grad_norm", "ce"):
                res[f"{key}/{k}"] = np.asarray(met[k])
            put_tree(key + "/p", new.params)
        elif kind == "prefill":
            logits, cache = fn(params, tokens)
            res[key + "/logits"] = np.asarray(logits)
            put_tree(key, cache)
        else:
            model = build_model(cfg)
            flat = jax.tree_util.tree_flatten_with_path(
                model.init_cache(Bg, Sg))
            cache = jax.tree_util.tree_unflatten(flat[1], [
                jnp.asarray(inp[f"{key}/cache/{path(kp)}"])
                for kp, _ in flat[0]])
            ctx = ParallelCtx(mesh=mesh, axis_data=("data",),
                              moe_mode="replicated",
                              seq_shard_cache=True,
                              seq_shard_axes=("model",))
            logits = jax.jit(lambda p, t, c: model.decode_step(
                p, t, c, ctx)[0])(params, tokens, cache)
            res[key + "/logits"] = np.asarray(logits)
            nxt, cache = fn(params, tokens, cache)
            res[key + "/next"] = np.asarray(nxt)
            put_tree(key, cache)
    np.savez(sys.argv[2], **res)
""")


def _env() -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    return env


def _wait(label: str, procs) -> None:
    for p in procs:
        try:
            text, _ = p.communicate(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"{label} timed out after {TIMEOUT} s")
        assert p.returncode == 0, f"{label} failed:\n{text[-6000:]}"


def run(tmp: Path, families):
    """(inputs, the JAX outputs, [each rank's outputs])."""
    inputs = tmp / "inputs.npz"
    inp = write_inputs(inputs, families)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(inputs), str(tmp / "jax.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    out = tmp / "ranks"
    out.mkdir()
    cases = str(inp["cell/cases"])
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_spmd_ranks.py"),
         str(r), "8", str(tmp / "store"), str(inputs), str(out),
         "cell:" + cases],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(8)]
    _wait("the gloo ranks", ranks)
    _wait("the JAX reference", [jax_proc])
    return (inp, dict(np.load(tmp / "jax.npz")),
            [dict(np.load(out / f"rank{r}.npz")) for r in range(8)])


class Coord:
    """Rank (d, m) of the (2, 4) mesh, as ``shard_params`` reads it."""

    mesh_dim_names = ("data", "model")
    shape = MESH

    def __init__(self, d: int, m: int):
        self.coord = [d, m]

    def get_coordinate(self):
        return self.coord


def unflat(flat: dict, prefix: str) -> dict:
    out = {}
    for key, val in flat.items():
        if key.startswith(prefix):
            node = out
            *parents, leaf = key[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val
    return out


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def cache_specs(family: str, seq_axes) -> dict:
    """{path: placement} of the port's whole cache of the cells, by role
    (``sharding_rules.cache_placements``)."""
    _, cfg = cfg_of(family)
    whole = build_model(cfg, 1, None, "meta").init_cache(B, S)
    specs = tsr.cache_placements(whole, B, ("data",), seq_axes, S)
    leaves = dict(T.paths(whole))
    return {"/".join(p): (spec, tuple(leaves[p].shape))
            for p, spec in T.paths(specs)}


def rank_shard(ref: np.ndarray, spec, shape, d: int, m: int) -> np.ndarray:
    """Rank (d, m)'s block of a whole reference array placed ``spec`` on
    the port's whole ``shape`` (the reference's local stack flattened)."""
    return tsr.shard_leaf(ref.reshape(shape), spec,
                          dict(zip(Coord.mesh_dim_names, MESH)),
                          {"data": d, "model": m})
