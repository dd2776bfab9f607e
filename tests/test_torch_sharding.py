"""The port's placement rules, mesh shapes and input shapes against the JAX
package's: ``param_placements`` equals ``param_shardings`` (as tuples)
for every family's reduced params in each phase, ``cache_placements`` the
dry-run's ``_cache_sharding_specs``, the shapes module the reference's
applicability matrix; and ``shard_params`` of a whole tree gives, on every
rank of a (2, 4) mesh, the reference's shard of each leaf the port
executes sharded (one JAX subprocess with 8 host devices computes those
shards) and every other leaf whole."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ALL_SHAPES as J_SHAPES
from repro.configs import ASSIGNED_ARCHS as J_ARCHS
from repro.configs import applicable as japplicable
from repro.configs import get_config as jget_config
from repro.distributed import sharding_rules as jsr
from repro.models.transformer import build_model as jbuild_model
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding_rules as tsr
from repro_torch.launch import mesh as tmesh
from repro_torch.models.transformer import build_model
from repro_torch.training import tree as T

ROOT = Path(__file__).resolve().parents[1]
PHASES = ("serve", "train", "decode", "train_tp")


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _num_servers(cfg):
    return 4 if cfg.moe is not None else 1


@pytest.mark.parametrize("arch", sorted(tconfigs.REGISTRY))
def test_param_placements_match_reference(arch):
    jcfg = jget_config(arch).reduced()
    tcfg = tconfigs.get_config(arch).reduced()
    abstract = jax.eval_shape(jbuild_model(jcfg, _num_servers(jcfg))
                              .init_params, jax.random.PRNGKey(0))
    S = _num_servers(tcfg)
    params = build_model(tcfg, S, np.zeros((S, 0), np.int32),
                         "meta").init_params(None)
    assert set(_flat(params)) == {
        "/".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(abstract)[0]}
    for phase in PHASES:
        for dp in ("data", ("pod", "data")):
            exp = _flat(jax.tree.map(
                tuple, jsr.param_shardings(abstract, None, phase, dp=dp),
                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
            got = _flat(tsr.param_placements(params, phase, dp=dp))
            assert got == exp, (phase, dp)
    # Adafactor's factored state inherits them
    pl = tsr.param_placements(params, "train")
    exp = jax.tree.map(tuple, jsr.adafactor_state_shardings(
        abstract, jsr.param_shardings(abstract, None, "train")),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert _flat(tsr.adafactor_state_placements(params, pl)) == _flat(exp)


def test_train_phase_and_batch_placements_match_reference():
    for n in (10 ** 9, 2 * 10 ** 10, 10 ** 12):
        for mp in (1, 16):
            assert tsr.train_phase_for(n, mp) == jsr.train_phase_for(n, mp)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 3)
    for dp in (("data",), ("pod", "data")):
        assert tsr.batch_placements(dp) == tuple(
            jsr.batch_shardings(mesh, dp).spec)


def _dry():
    # imported here: the module sets XLA_FLAGS, a no-op once jax has its
    # one CPU device (as tests/test_dryrun_units.py does)
    from repro.launch import dryrun
    return dryrun


@pytest.mark.parametrize("case", [
    ("decode_32k", (40, 128, 32768, 8, 128), 128, ("model",), 32768),
    ("long_500k", (40, 1, 524288, 8, 128), 1, ("data", "model"), 524288),
    ("window", (5, 128, 1024, 4, 256), 128, ("model",), 32768),
    ("prefill", (4, 32, 32768, 8, 128), 32, (), 32768),
    ("state", (4, 8, 16, 32, 32), 8, ("model",), 4096)])
def test_cache_placements_match_dryrun(case):
    """tests/test_dryrun_units.py's three cases and two more (a prefill
    cache, batch-sharded; a recurrent state without a slot dim)."""
    _, shape, batch, seq_axes, seq_len = case
    exp = _dry()._cache_sharding_specs(
        {"k": jax.ShapeDtypeStruct(shape, jnp.bfloat16)}, batch=batch,
        dp=("data",), seq_axes=seq_axes, seq_len=seq_len)["k"]
    got = tsr.cache_placements({"k": torch.empty(shape, device="meta")},
                               batch, ("data",), seq_axes, seq_len)["k"]
    assert got == tuple(exp)


def test_cache_placements_walk_a_kv_cache():
    """A decoder's cache (dicts of KVCache dataclasses): k / v slots over
    the slot axes, lengths over the batch; the window is kept."""
    cfg = tconfigs.get_config("granite-3-2b").reduced()
    cache = build_model(cfg, 1, None, "meta").init_cache(8, 64)
    pl = tsr.cache_placements(cache, 8, ("data",), ("model",), 64)
    assert pl["blocks"].k == (None, "data", "model", None, None)
    assert pl["blocks"].length == (None, "data")
    assert pl["blocks"].window == 0


def test_applicability_matrix():
    """The reference's test_applicability_matrix on the port's shapes."""
    assert tconfigs.ASSIGNED_ARCHS == J_ARCHS
    assert [(s.name, s.seq_len, s.global_batch, s.kind)
            for s in tconfigs.ALL_SHAPES] == [
        (s.name, s.seq_len, s.global_batch, s.kind) for s in J_SHAPES]
    skips = {(a, s.name) for a in tconfigs.ASSIGNED_ARCHS
             for s in tconfigs.ALL_SHAPES
             if not tconfigs.applicable(tconfigs.get_config(a), s)[0]}
    assert skips == {(a, "long_500k") for a in
                     ["granite-3-2b", "minitron-8b", "phi3-medium-14b",
                      "arctic-480b", "kimi-k2-1t-a32b", "whisper-base",
                      "qwen2-vl-2b"]}
    for a in J_ARCHS:
        for s, js in zip(tconfigs.ALL_SHAPES, J_SHAPES):
            assert tconfigs.applicable(tconfigs.get_config(a), s)[0] == \
                japplicable(jget_config(a), js)[0]
            r, jr = tconfigs.reduced_shape(s), __import__(
                "repro.configs", fromlist=["reduced_shape"]).reduced_shape(js)
            assert (r.name, r.seq_len, r.global_batch) == (
                jr.name, jr.seq_len, jr.global_batch)
    assert tconfigs.shape_by_name("decode_32k").seq_len == 32768
    with pytest.raises(KeyError):
        tconfigs.shape_by_name("nope")


def test_mesh_shapes_and_refusals(monkeypatch):
    """The production shapes; data_axes; no card and no device="cpu":
    the mesh functions raise rather than build a CPU mesh."""
    assert tmesh.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert tmesh.production_mesh_shape(multi_pod=True) == (
        (2, 16, 16), ("pod", "data", "model"))

    class Named:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 16, 16)
    assert tmesh.data_axes(Named()) == ("pod", "data")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tmesh.make_test_mesh(1, 1),
                  lambda: tmesh.init_distributed(0, 1, "tcp://localhost:1")):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    with pytest.raises(ValueError, match="device"):
        tmesh.make_test_mesh(1, 1, device="tpu")


class _Coord:
    """A rank's view of a (2, 4) mesh without a process group: what
    ``shard_params`` reads of a DeviceMesh."""

    mesh_dim_names = ("data", "model")
    shape = (2, 4)

    def __init__(self, d: int, m: int):
        self.coord = [d, m]

    def get_coordinate(self):
        return self.coord


JAX_SIDE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType, NamedSharding
    from repro.configs import get_config
    from repro.distributed.sharding_rules import param_shardings
    from repro.models import rwkv as rwk
    from repro.models.transformer import build_model

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    coords = {d: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
              for d in mesh.devices.flat}
    out = {}

    def shards(name, a, sharding):
        for s in jax.device_put(a, sharding).addressable_shards:
            d, m = coords[s.device]
            out[f"{name}@{d}{m}"] = np.asarray(s.data)

    kimi = get_config("kimi-k2-1t-a32b").reduced().replace(dtype="float32")
    p = build_model(kimi, num_servers=4).init_params(jax.random.PRNGKey(0))
    specs = param_shardings(p, mesh, "serve")
    for k in ("w_gate", "w_up", "w_down"):
        a, spec = p["blocks"]["moe"]["servers"][k], specs["blocks"]["moe"][
            "servers"][k]
        shards("kimi/blocks/moe/servers/" + k, a, NamedSharding(mesh, spec))
    # rwkv6's island: the shardings its compiled shard_map takes
    cfg = get_config("rwkv6-7b").reduced().replace(dtype="float32")
    layer = jax.tree.map(lambda a: a[0], build_model(cfg).init_params(
        jax.random.PRNGKey(1))["blocks"])
    B, L = 2, 4
    st = rwk.init_rwkv_state(cfg, B)
    x = jnp.zeros((B, L, cfg.d_model), jnp.float32)
    island = rwk.rwkv_block_spmd(cfg, mesh, ("data",), "model")
    args = (layer["tmix"], layer["cmix"], layer["ln1"], layer["ln2"], x,
            st.wkv, st.shift_tmix, st.shift_cmix)
    ins = jax.jit(island).lower(*args).compile().input_shardings[0]
    for part, tree, shd in (("tmix", layer["tmix"], ins[0]),
                            ("cmix", layer["cmix"], ins[1])):
        for k, a in tree.items():
            shards(f"rwkv/{part}/{k}", a, shd[k])
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def reference_shards(tmp_path_factory):
    path = tmp_path_factory.mktemp("shards") / "jax.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    res = subprocess.run([sys.executable, "-c", JAX_SIDE, str(path)],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    return dict(np.load(path))


def _numpy_tree(arch: str, key: int):
    cfg = jget_config(arch).reduced().replace(dtype="float32")
    return jax.tree.map(np.asarray, jbuild_model(cfg, _num_servers(cfg))
                        .init_params(jax.random.PRNGKey(key)))


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "rwkv6-7b"])
def test_shard_params_gives_the_reference_shards(reference_shards, arch):
    """Every rank's shard_params of the whole (numpy) tree: the expert
    banks (serve phase) and rwkv6's island leaves are the reference's
    shards on that device; every other leaf is the whole leaf, a view."""
    full = _numpy_tree(arch, 0 if arch.startswith("kimi") else 1)
    tag = "kimi" if arch.startswith("kimi") else "rwkv"
    for d in range(2):
        for m in range(4):
            got = _flat(tsr.shard_params(full, _Coord(d, m)))
            for path, leaf in _flat(full).items():
                # rwkv6's reference shards are of one layer: layer 0
                name = (f"kimi/{path}" if tag == "kimi" else
                        "rwkv/" + path.removeprefix("blocks/"))
                exp = reference_shards.get(f"{name}@{d}{m}")
                if exp is None:
                    assert np.shares_memory(got[path], leaf), path
                    assert got[path].shape == leaf.shape, path
                else:
                    mine = got[path] if tag == "kimi" else got[path][0]
                    np.testing.assert_array_equal(mine, exp)
    assert any(k.startswith(tag) for k in reference_shards)


def _ref_leaves(tree):
    """{path: leaf} of a JAX tree (dicts, dataclasses, named tuples)."""
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        parts = []
        for p in kp:
            for attr in ("key", "name", "idx"):
                if hasattr(p, attr):
                    parts.append(str(getattr(p, attr)))
                    break
        out["/".join(parts)] = leaf
    return out


def _port_leaves(specs):
    """{path: placement} of the port's placement tree."""
    return {"/".join(p): v for p, v in T.paths(specs)}


@pytest.mark.parametrize("phase", ["serve", "decode", "train_tp", "train"])
def test_rwkv_time_mix_w_v_is_cut_as_the_island_takes_it(phase):
    """The table places rwkv6's time-mix ``w_v`` as row-parallel (the
    reference's placement, kept by ``param_placements``); the placement
    the port executes swaps its two cuts, so under ``dense=True`` every
    rank holds the island's columns — the block the serving layout gives
    it — and a step reshards nothing."""
    cfg = tconfigs.get_config("rwkv6-7b").reduced()
    full = build_model(cfg, 1, None, "cpu").init_params(
        torch.Generator().manual_seed(0))
    path, leaf = "blocks/tmix/w_v", full["blocks"]["tmix"]["w_v"]
    table = tsr.param_placements(full, phase)["blocks"]["tmix"]["w_v"]
    got = tsr.placement_of(path, leaf.shape, phase, "data")
    assert got == (None, table[2], table[1])
    assert got[2] == "model"
    if phase == "train":
        return
    for d in range(2):
        for m in range(4):
            dense = tsr.shard_params(full, _Coord(d, m), phase, dense=True)
            island = tsr.shard_params(full, _Coord(d, m), phase)
            assert torch.equal(dense["blocks"]["tmix"]["w_v"],
                               island["blocks"]["tmix"]["w_v"])


@pytest.mark.parametrize("arch", ["gemma3-4b", "zamba2-2.7b", "rwkv6-7b",
                                  "whisper-base"])
def test_family_cache_placements_by_role(arch):
    """The four families' caches at their published widths, on every
    applicable serving shape: the port's placements (by role) are the
    reference's ``_cache_sharding_specs`` (by size), leaf by leaf.  The
    two layouts differ where the port's cache does: gemma3's local rings
    stack (groups * pattern) on one axis where the reference stacks
    (groups, pattern) on two; rwkv6's wkv state holds this rank's heads
    (the island's layout)."""
    from repro_torch.configs import applicable as tapplicable
    cfg, jcfg = tconfigs.get_config(arch), jget_config(arch)
    tm = build_model(cfg, 1, None, "meta")
    jm = jbuild_model(jcfg)
    checked = 0
    for shape in tconfigs.ALL_SHAPES:
        if shape.kind == "train" or not tapplicable(cfg, shape)[0]:
            continue
        B, S = shape.global_batch, shape.seq_len
        seq_axes = ()
        if shape.kind == "decode":
            seq_axes = ("data", "model") if B == 1 else ("model",)
        want = _ref_leaves(_dry()._cache_sharding_specs(
            jm.init_cache(B, S, abstract=True), B, ("data",), seq_axes, S))
        got = _port_leaves(tsr.cache_placements(
            tm.init_cache(B, S), B, ("data",), seq_axes, S))
        assert set(got) == set(want), shape.name
        for path, w in want.items():
            w, g = tuple(w), got[path]
            if path.startswith("local/"):    # (groups, pattern) -> one axis
                assert w[:2] == (None, None), (shape.name, path)
                w = w[1:]
            if path == "states/wkv":
                assert g == w[:2] + ("model",) + w[3:], (shape.name, path)
            else:
                assert g == w, (shape.name, path, g, w)
            checked += 1
    assert checked >= 6
