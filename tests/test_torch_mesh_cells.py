"""The dry-run's cells executed on gloo ranks against the JAX package's
``build_cell`` on 8 forced host devices: dense tensor parallelism, ZeRO-3
and training on a mesh (``repro_torch.launch.dryrun.build_cell``).

* Inputs: the JAX package's params (``init_params``, one device, in this
  process) and numpy batches and caches, written once to an ``.npz``.
* JAX side: one subprocess, 8 host devices, runs the reference's
  ``build_cell`` steps on a (2, 4) mesh (ZeRO-3 forced by patching
  ``train_phase_for`` where the case says so), and the decode logits with
  the same context.
* Port side: a gloo world of 8 ranks (``tests/torch_spmd_ranks.py``,
  ``cell:`` cases) runs the port's cells on the same mesh.

Cases: reduced deepseek-r1 (fp32) trained in phase ``train`` (ZeRO-3 and
the sequence-parallel residual) and ``train_tp``: its 2 KV heads over 4
model ranks are a head cut (every rank gathers whole heads), and its
capacity drops tokens; reduced granite-3-2b (tied embeddings) in
``train``; the prefill (``serve``) and decode (``decode``: a slot-sharded
cache) cells of both.  After one step every updated shard, the loss,
grad norm, aux loss and dropped count equal the reference's at 1e-5; the
prefill's logits and cache and the serve step's logits, next token and
cache shard likewise.  The cells' steps are compiled as the reference
jits them (CUDA graphs over NCCL); on gloo they run eagerly, and two
calls of each equal two calls of the plain step bitwise, the second
train and serve calls on the state and cache the first wrote in place.  The same world checks the int8 compression of a
sharded leaf against the whole leaf's (one scale over every shard).

The reference's cells run as shipped: ``build_cell`` lowers the expert
GEMMs ``xla_dense``, which caps each local expert at ``ecap`` rows and
drops the rest (``src/repro/core/expert_server.py:238-242``), and so do
the port's (``gemm_impl="dense"`` on the cell's MoE runtime).
ds_train_tp's data routes more than ``ecap`` rows to one expert; its
step is also run with the runtime's ``gemm_impl`` set to ``xla_ragged``,
whose loss the dense one must move off:
``test_dense_lowering_caps_expert_rows``.  The reference's
``build_cell`` also sets the lowering process-wide
(``kops.set_default_impl``): it leaks into every later reference call of
the JAX subprocess whose impl is ``auto``.  The decode logits' context
below names ``xla_dense`` as ``build_cell``'s does; the port carries the
lowering on the step's runtime instead.
"""

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
from repro_torch.distributed import sharding_rules as tsr

ROOT = Path(__file__).resolve().parents[1]
F32 = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 240          # seconds a subprocess may take before it fails
B, S = 8, 32           # the cells' global batch and sequence
DECODE_LEN = 20        # tokens already in the decode cells' caches

CASES = {
    # case: (arch, kind, forced train phase)
    "ds_train": ("deepseek-r1", "train", "train"),
    "ds_train_tp": ("deepseek-r1", "train", ""),
    "gr_train": ("granite-3-2b", "train", "train"),
    "ds_prefill": ("deepseek-r1", "prefill", ""),
    "ds_decode": ("deepseek-r1", "decode", ""),
    "gr_prefill": ("granite-3-2b", "prefill", ""),
    "gr_decode": ("granite-3-2b", "decode", ""),
}
# the cases whose compiled step (build_cell's, as the reference jits it) is
# also called twice against two calls of the plain step
TWICE = ("ds_train", "gr_train", "ds_prefill", "gr_prefill", "ds_decode",
         "gr_decode")


def _put(out: dict, prefix: str, tree) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(out, f"{prefix}/{k}", v)
        return
    out[prefix] = np.asarray(tree)


def _cfg(arch):
    return jget_config(arch).reduced().replace(dtype="float32")


def _inputs(path: Path) -> dict:
    rng = np.random.default_rng(0)
    out = {}
    for i, (case, (arch, kind, force)) in enumerate(CASES.items()):
        key = f"cell/{case}"
        cfg = _cfg(arch)
        out[key + "/arch"], out[key + "/dtype"] = np.array(arch), np.array(
            "float32")
        out[key + "/kind"], out[key + "/force"] = np.array(kind), np.array(
            force)
        out[key + "/mesh"] = np.array((2, 4))
        out[key + "/shape"] = np.array((B, S))
        n_servers = 4 if cfg.moe else 1
        _put(out, key + "/params", jax.tree.map(np.asarray, jbuild_model(
            cfg, num_servers=n_servers).init_params(jax.random.PRNGKey(i))))
        if kind == "decode":
            out[key + "/tokens"] = rng.integers(0, cfg.vocab_size,
                                                (B, 1)).astype(np.int32)
            stacks = ["blocks"] + (["dense"] if cfg.moe and
                                   cfg.moe.first_k_dense else [])
            out[key + "/stacks"] = np.array(",".join(stacks))
            for name in stacks:
                n = (cfg.moe.first_k_dense if name == "dense" else
                     cfg.num_layers - (cfg.moe.first_k_dense if cfg.moe
                                       else 0))
                shp = (n, B, S, cfg.num_kv_heads, cfg.head_dim)
                kv = rng.normal(size=(2, *shp)).astype(np.float32)
                kv[:, :, :, DECODE_LEN:] = 0.0
                out[f"{key}/cache/{name}/k"] = kv[0]
                out[f"{key}/cache/{name}/v"] = kv[1]
                out[f"{key}/cache/{name}/length"] = np.full(
                    (n, B), DECODE_LEN, np.int32)
        else:
            out[key + "/tokens"] = rng.integers(0, cfg.vocab_size,
                                                (B, S)).astype(np.int32)
            if kind == "train":
                out[key + "/labels"] = rng.integers(
                    0, cfg.vocab_size, (B, S)).astype(np.int32)
    out["cell/cases"] = np.array(",".join(CASES))
    out["cell/twice"] = np.array(",".join(TWICE))
    np.savez(path, **out)
    return out


JAX_SIDE = textwrap.dedent("""
    import os, sys
    import repro.launch.dryrun as rd        # sets 512 host devices
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import InputShape, get_config
    from repro.distributed import sharding_rules as jsr
    from repro.models import kv_cache as kvc
    from repro.models.transformer import ParallelCtx, build_model
    from repro.training.train_loop import TrainState

    inp = dict(np.load(sys.argv[1]))
    res = {}

    def tree(prefix):
        out = {}
        for key, val in inp.items():
            if key.startswith(prefix + "/"):
                node = out
                *parents, leaf = key[len(prefix) + 1:].split("/")
                for p in parents:
                    node = node.setdefault(p, {})
                node[leaf] = jnp.asarray(val)
        return out

    def put(key, a):
        res[key] = np.asarray(a)

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    keep = jsr.train_phase_for
    dense_runtime = rd.moe_runtime_for

    def ragged_runtime(*a, **k):
        rt = dense_runtime(*a, **k)
        return rt if rt is None else rt._replace(gemm_impl="xla_ragged")

    def train(cfg, shape, key, force):
        jsr.train_phase_for = (lambda *a, **k: force) if force else keep
        fn, _ = rd.build_cell(cfg.arch_id, shape, mesh, cfg=cfg)
        jsr.train_phase_for = keep
        params = tree(key + "/params")
        opt = rd.adafactor(lr=1e-3)
        state = TrainState(params=params, opt_state=opt.init(params),
                           step=jnp.zeros((), jnp.int32))
        batch = {"tokens": jnp.asarray(inp[key + "/tokens"]),
                 "labels": jnp.asarray(inp[key + "/labels"])}
        return fn(state, batch)

    for case in str(inp["cell/cases"]).split(","):
        key = "cell/" + case
        cfg = get_config(str(inp[key + "/arch"])).reduced().replace(
            dtype="float32")
        kind, force = str(inp[key + "/kind"]), str(inp[key + "/force"])
        Bg, Sg = (int(v) for v in inp[key + "/shape"])
        shape = InputShape(case, Sg, Bg, kind)
        if case == "ds_train_tp":        # every row computed, none capped
            rd.moe_runtime_for = ragged_runtime
            _, met = train(cfg, shape, key, force)
            put(key + "/ragged_loss", met["loss"])
            rd.moe_runtime_for = dense_runtime
        params = tree(key + "/params")
        tokens = jnp.asarray(inp[key + "/tokens"])
        if kind == "train":
            new, met = train(cfg, shape, key, force)
            for k in ("loss", "grad_norm", "ce", "aux", "dropped"):
                put(f"{key}/{k}", met[k])
            flat = jax.tree_util.tree_flatten_with_path(new.params)[0]
            for path, leaf in flat:
                put(key + "/p/" + "/".join(p.key for p in path), leaf)
        elif kind == "prefill":
            fn, _ = rd.build_cell(cfg.arch_id, shape, mesh, cfg=cfg)
            logits, cache = fn(params, tokens)
            put(key + "/logits", logits)
            for name, c in cache.items():
                put(f"{key}/{name}/k", c.k)
                put(f"{key}/{name}/v", c.v)
        else:
            cache = {n: kvc.KVCache(
                k=jnp.asarray(inp[f"{key}/cache/{n}/k"]),
                v=jnp.asarray(inp[f"{key}/cache/{n}/v"]),
                length=jnp.asarray(inp[f"{key}/cache/{n}/length"]),
                window=0) for n in str(inp[key + "/stacks"]).split(",")}
            model = build_model(cfg, num_servers=4 if cfg.moe else 1)
            ctx = ParallelCtx(
                mesh=mesh, axis_data=("data",),
                moe_runtime=rd.moe_runtime_for(cfg, mesh, shape,
                                               "replicated"),
                moe_mode="replicated", gemm_impl="xla_dense",
                seq_shard_cache=True, seq_shard_axes=("model",))
            logits = jax.jit(lambda p, t, c: model.decode_step(
                p, t, c, ctx)[0])(params, tokens, cache)
            put(key + "/logits", logits)
            fn, _ = rd.build_cell(cfg.arch_id, shape, mesh, cfg=cfg)
            nxt, cache = fn(params, tokens, cache)
            put(key + "/next", nxt)
            for name, c in cache.items():
                put(f"{key}/{name}/k", c.k)
                put(f"{key}/{name}/v", c.v)
                put(f"{key}/{name}/length", c.length)
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX outputs, [rank outputs])."""
    tmp = tmp_path_factory.mktemp("cells")
    inputs = tmp / "inputs.npz"
    inp = _inputs(inputs)
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(inputs), str(tmp / "jax.npz")],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    out = tmp / "ranks"
    out.mkdir()
    ranks = [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_spmd_ranks.py"),
         str(r), "8", str(tmp / "store"), str(inputs), str(out),
         "cell:" + ",".join(CASES), "int8"],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(8)]
    _wait("the gloo ranks", ranks)
    _wait("the JAX reference", [jax_proc])
    return (inp, dict(np.load(tmp / "jax.npz")),
            [dict(np.load(out / f"rank{r}.npz")) for r in range(8)])


class _Coord:
    """Rank (d, m) of a (2, 4) mesh, as ``shard_params`` reads it."""

    mesh_dim_names = ("data", "model")
    shape = (2, 4)

    def __init__(self, d: int, m: int):
        self.coord = [d, m]

    def get_coordinate(self):
        return self.coord


def _unflat(flat: dict, prefix: str) -> dict:
    out = {}
    for key, val in flat.items():
        if key.startswith(prefix):
            node = out
            *parents, leaf = key[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val
    return out


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("case", ["ds_train", "ds_train_tp", "gr_train"])
def test_train_step_matches_reference(runs, case):
    """One train step: the metrics on every rank and each rank's updated
    shards equal the reference's (its whole params, cut by the table)."""
    _, ref, ranks = runs
    key = f"cell/{case}"
    phase = str(ranks[0][key + "/phase"])
    assert phase == ("train" if CASES[case][2] else "train_tp")
    for r in ranks:
        for k in ("loss", "grad_norm", "ce", "aux"):
            np.testing.assert_allclose(r[f"{key}/{k}"], ref[f"{key}/{k}"],
                                       **F32, err_msg=k)
        assert int(r[key + "/dropped"]) == int(ref[key + "/dropped"])
    if case.startswith("ds"):
        assert int(ref[key + "/dropped"]) > 0      # the capacity drops
    whole = _unflat(ref, key + "/p/")
    n = 0
    for d in range(2):
        for m in range(4):
            want = _flat(tsr.shard_params(whole, _Coord(d, m), phase,
                                          dense=True))
            got = _unflat(ranks[d * 4 + m], key + "/p/")
            got = _flat(got)
            assert set(got) == set(want)
            for path, w in want.items():
                np.testing.assert_allclose(got[path], w, **F32,
                                           err_msg=f"{path} @ {d}{m}")
                n += 1
    assert n > 8 * 10


@pytest.mark.parametrize("case", ["ds_prefill", "gr_prefill"])
def test_prefill_cell_matches_reference(runs, case):
    """The prefill cell (phase ``serve``): each rank's rows of the
    last-position logits and of the whole cache."""
    _, ref, ranks = runs
    key = f"cell/{case}"
    b = B // 2
    for rank, r in enumerate(ranks):
        d = rank // 4
        assert str(r[key + "/phase"]) == "serve"
        np.testing.assert_allclose(r[key + "/logits"],
                                   ref[key + "/logits"][d * b:(d + 1) * b],
                                   **F32)
        for name in ("blocks", "dense"):
            if f"{key}/{name}/k" in ref:
                for kv in ("k", "v"):
                    np.testing.assert_allclose(
                        r[f"{key}/{name}/{kv}"],
                        ref[f"{key}/{name}/{kv}"][:, d * b:(d + 1) * b],
                        **F32, err_msg=f"{name}/{kv}")


@pytest.mark.parametrize("case", ["ds_decode", "gr_decode"])
def test_decode_cell_matches_reference(runs, case):
    """The serve step (phase ``decode``, the cache slot-sharded over the
    model axis): each rank's rows of the logits and next token, and its
    shard of the cache (the new token written by its owner only)."""
    inp, ref, ranks = runs
    key = f"cell/{case}"
    b, w = B // 2, S // 4
    for rank, r in enumerate(ranks):
        d, m = divmod(rank, 4)
        assert str(r[key + "/phase"]) == "decode"
        rows = slice(d * b, (d + 1) * b)
        np.testing.assert_allclose(r[key + "/logits"],
                                   ref[key + "/logits"][rows], **F32)
        np.testing.assert_array_equal(r[key + "/next"],
                                      ref[key + "/next"][rows])
        for name in str(inp[key + "/stacks"]).split(","):
            for kv in ("k", "v"):
                np.testing.assert_allclose(
                    r[f"{key}/{name}/{kv}"],
                    ref[f"{key}/{name}/{kv}"][:, rows, m * w:(m + 1) * w],
                    **F32, err_msg=f"{name}/{kv} @ {d}{m}")
            np.testing.assert_array_equal(r[f"{key}/{name}/length"],
                                          ref[f"{key}/{name}/length"][:, rows])
    # the step wrote slot DECODE_LEN (model rank 2's first slot) and it moved
    k = ref[f"{key}/blocks/k"]
    assert np.abs(k[:, :, DECODE_LEN]).max() > 0


def test_dense_lowering_caps_expert_rows(runs):
    """The dry-run's xla_dense lowering drops an expert's rows past
    ``ecap``: on ds_train_tp's data the port's cell equals the shipped
    (dense) loss on every rank, and both move off the loss of the ragged
    lowering, which computes every row."""
    _, ref, ranks = runs
    key = "cell/ds_train_tp"
    for r in ranks:
        np.testing.assert_allclose(r[key + "/loss"], ref[key + "/loss"],
                                   **F32)
    assert abs(float(ref[key + "/ragged_loss"])
               - float(ranks[0][key + "/loss"])) > 1e-4


def test_int8_scale_is_the_whole_leafs(runs):
    """int8 compression on 8 row shards of one leaf equals the whole
    leaf's, bit for bit: the per-tensor scale is the max over every
    shard, not each shard's own."""
    import torch
    from repro_torch.training.train_loop import compress_with_feedback

    _, _, ranks = runs
    g = torch.randn(16, 8, generator=torch.Generator().manual_seed(3))
    g[5, 2] = 40.0
    deq, res = compress_with_feedback(g, torch.zeros_like(g))
    for r, out in enumerate(ranks):
        rows = slice(r * 2, (r + 1) * 2)
        np.testing.assert_array_equal(out["int8/deq"], deq[rows].numpy())
        np.testing.assert_array_equal(out["int8/res"], res[rows].numpy())


@pytest.mark.parametrize("case", TWICE)
def test_compiled_cell_equals_the_plain_step_twice(runs, case):
    """``build_cell``'s compiled step, called twice (the second call on
    other data, and for train and serve on the state or cache the first
    wrote in place), equals two calls of the plain step bitwise on every
    rank; on gloo it captures nothing and says why."""
    _, _, ranks = runs
    key = f"cell/{case}/compiled"
    for r in ranks:
        assert bool(r[key + "/equal"])
        assert bool(r[key + "/inplace"])
        assert int(r[key + "/captures"]) == 0
        reason = str(r[key + "/reason"])
        assert reason.startswith("eager: on cpu") and "gloo" in reason
