"""The port's multi-device serving path on gloo ranks against the JAX
package's SPMD runs (``tests/test_spmd.py``'s setup: reduced kimi-k2, 4
expert servers, T = 64 tokens, a (2, 4) mesh).

* Inputs: the JAX package's params (``init_params``, one device, in this
  process) and numpy data, written once to an ``.npz``.
* JAX side: one subprocess with 8 forced host devices computes every
  SPMD and local output (shard_map islands, ``jax.jit``).
* Port side: gloo worlds of 8, 4 and 2 ranks (``tests/torch_spmd_ranks.py``,
  which imports only the port) — the MoE island in ``a2a`` / ``replicated``
  (float32 and bfloat16), with a capacity that drops tokens, with a dead
  server under replicas; sequence-parallel decode attention over a cache
  sharded on the data axis (8 ways) and on the model axis (4 ways);
  rwkv6's tensor-parallel block on (1, 2) and (2, 2); and the slice as a
  whole, reduced kimi-k2 prefilled in a2a and decoded in replicated mode
  over a slot-sharded cache.

Tolerances: port SPMD vs JAX SPMD on the same mesh and mode 1e-5 (fp32) /
2e-2 (bf16), integer stats exact, aux / z losses 1e-6; port SPMD vs port
one-device 2e-4 (the reference's own bound for SPMD vs local).  The
partial flash decode is compared on the shards that hold a valid slot: an
empty shard's partial is (acc 0, m -1e30, l 0) in the port and
(sum of v, -1e30, slots) in the reference, both weighing 0 in the combine.
"""

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

from repro.configs import get_config as jget_config
from repro.core import expert_server as jserver
from repro.core import load_balance as jlb
from repro.core.moe_layer import default_runtime as jdefault_runtime
from repro.models import attention as jattn
from repro.models import kv_cache as jkvc
from repro.models.transformer import build_model as jbuild_model
from repro_torch.configs import get_config
from repro_torch.core import moe_layer as tmoe
from repro_torch.core.moe_layer import MoERuntime
from repro_torch.kernels.decode_attention import flash_decode_partial_torch
from repro_torch.models import attention as tattn
from repro_torch.models import kv_cache as tkvc
from repro_torch.models import rwkv as trwk
from repro_torch.models import transformer as ttr

ROOT = Path(__file__).resolve().parents[1]
T = 64
SLOTS, LENGTHS = 64, (37, 50)
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)
LOCAL = dict(rtol=2e-4, atol=2e-4)
TIMEOUT = 120          # seconds a subprocess may take before it fails


def _put(out: dict, prefix: str, tree) -> None:
    """Leaves of ``tree`` under ``prefix/...``; bfloat16 as uint16 bits."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _put(out, f"{prefix}/{k}", v)
        return
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        out[prefix + "~bf16"] = a.view(np.uint16)
    else:
        out[prefix] = a


def _runtime(out: dict, key: str, rt) -> None:
    for f in ("mapping", "alive", "local_table", "num_servers", "capacity"):
        out[f"{key}/{f}"] = np.asarray(getattr(rt, f))


def _inputs(path: Path) -> dict:
    """Everything both sides read; returns it (numpy) too."""
    rng = np.random.default_rng(0)
    out = {}
    cases = []
    for dt, tag in (("float32", "f32"), ("bfloat16", "bf16")):
        cfg = jget_config("kimi-k2-1t-a32b").reduced().replace(dtype=dt)
        params = jbuild_model(cfg, num_servers=4).init_params(
            jax.random.PRNGKey(0))
        layer0 = jax.tree.map(lambda a: np.asarray(a[0]),
                              params["blocks"]["moe"])
        x = np.asarray(jnp.asarray(rng.normal(size=(T, cfg.d_model)) * 0.3,
                                   dtype=dt))
        rt = jdefault_runtime(cfg, 4, T)._replace(
            capacity=T * cfg.moe.top_k)
        modes = {f"a2a_{tag}": ("a2a", rt, layer0),
                 f"replicated_{tag}": ("replicated", rt, layer0)}
        if tag == "f32":
            modes["drops"] = ("a2a", rt._replace(capacity=2), layer0)
            # failover (test_spmd.py): replicas of every expert, then
            # server 1 dead
            E, S = cfg.moe.num_experts, 4
            mapping, red = jlb.eplb_plan(np.ones(E), S, n_redundant=E // S,
                                         max_replicas=2)
            per = E // S
            bank = {k: layer0["servers"][k][:, :per].reshape(
                E, *layer0["servers"][k].shape[2:])
                for k in ("w_gate", "w_up", "w_down")}
            fo = dict(layer0, servers=jax.tree.map(
                np.asarray, jserver.build_server_weights(bank, S, red)))
            rt2 = rt._replace(
                mapping=jnp.asarray(mapping),
                local_table=jnp.asarray(jserver.make_local_table(E, S, red)))
            modes["fo_ok"] = ("a2a", rt2, fo)
            modes["fo_dead"] = ("a2a", rt2._replace(
                alive=rt2.alive.at[1].set(False)), fo)
        for case, (mode, r, p) in modes.items():
            key = f"moe/{case}"
            out[key + "/arch"] = np.array("kimi-k2-1t-a32b")
            out[key + "/dtype"] = np.array(dt)
            out[key + "/mode"] = np.array(mode)
            _put(out, key + "/params", p)
            _put(out, key + "/x", x)
            _runtime(out, key, r)
            cases.append(case)
    out["moe/cases"] = np.array(",".join(cases))

    # sequence-parallel decode: granite reduced, fp32, 2 rows of 64 slots
    cfg = jget_config("granite-3-2b").reduced().replace(dtype="float32")
    out["sp/arch"], out["sp/dtype"] = np.array("granite-3-2b"), np.array(
        "float32")
    _put(out, "sp/params", jax.tree.map(np.asarray, jattn.init_attention(
        jax.random.PRNGKey(0), cfg)))
    shape = (len(LENGTHS), SLOTS, cfg.num_kv_heads, cfg.head_dim)
    out["sp/k"] = rng.normal(size=shape).astype(np.float32)
    out["sp/v"] = rng.normal(size=shape).astype(np.float32)
    out["sp/length"] = np.array(LENGTHS, np.int32)
    out["sp/x"] = (rng.normal(size=(len(LENGTHS), 1, cfg.d_model))
                   * 0.3).astype(np.float32)
    for case, mesh, axes in (("data", (8, 1), "data"),
                             ("model", (1, 4), "model")):
        out[f"sp/{case}/mesh"] = np.array(mesh)
        out[f"sp/{case}/axes"] = np.array(axes)

    # rwkv6 reduced, fp32: one layer, per-head bonus / decay / scale drawn
    cfg = jget_config("rwkv6-7b").reduced().replace(dtype="float32")
    out["rwkv/arch"], out["rwkv/dtype"] = np.array("rwkv6-7b"), np.array(
        "float32")
    blocks = jbuild_model(cfg).init_params(jax.random.PRNGKey(3))["blocks"]
    layer = jax.tree.map(lambda a: np.array(a[0]), blocks)
    tm = layer["tmix"]
    tm["bonus_u"] = rng.normal(size=tm["bonus_u"].shape).astype(np.float32)
    tm["decay_w0"] += rng.normal(size=tm["decay_w0"].shape).astype(
        np.float32)
    tm["ln_scale"] += 0.1 * rng.normal(size=tm["ln_scale"].shape).astype(
        np.float32)
    _put(out, "rwkv/params", layer)
    H, D = cfg.d_model // cfg.head_dim, cfg.head_dim
    out["rwkv/x"] = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    out["rwkv/wkv"] = (0.1 * rng.normal(size=(2, H, D, D))).astype(
        np.float32)
    for k in ("shift_tmix", "shift_cmix"):
        out[f"rwkv/{k}"] = rng.normal(size=(2, cfg.d_model)).astype(
            np.float32)

    # rwkv6's builder on a mesh: the reduced model, 2 x 8 prompt tokens, 2
    # teacher-forced decode steps
    _put(out, "rwkvm/params", jax.tree.map(np.asarray, jbuild_model(
        cfg).init_params(jax.random.PRNGKey(4))))
    out["rwkvm/tokens"] = rng.integers(0, cfg.vocab_size, (2, 8)).astype(
        np.int32)
    out["rwkvm/steps"] = rng.integers(0, cfg.vocab_size, (2, 2)).astype(
        np.int32)

    # the slice as a whole: reduced kimi-k2 fp32, 2 x 16 prompt tokens, 4
    # teacher-forced decode steps, 32 slots
    cfg = jget_config("kimi-k2-1t-a32b").reduced().replace(dtype="float32")
    out["dec/arch"], out["dec/dtype"] = out["moe/a2a_f32/arch"], np.array(
        "float32")
    _put(out, "dec/params", jax.tree.map(np.asarray, jbuild_model(
        cfg, num_servers=4).init_params(jax.random.PRNGKey(5))))
    out["dec/tokens"] = rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32)
    out["dec/steps"] = rng.integers(0, cfg.vocab_size, (2, 4)).astype(
        np.int32)
    out["dec/slots"] = np.array(32)
    np.savez(path, **out)
    return out


JAX_SIDE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import InputShape, get_config
    from repro.core.moe_layer import MoERuntime
    from repro.models import attention as attn, kv_cache as kvc, rwkv as rwk
    from repro.models.transformer import (ParallelCtx, _moe_apply,
                                          _sp_decode_attention, build_model)

    inp, res = {}, {}
    for k, a in np.load(sys.argv[1]).items():
        if k.endswith("~bf16"):
            inp[k[:-5]] = jax.lax.bitcast_convert_type(jnp.asarray(a),
                                                       jnp.bfloat16)
        else:
            inp[k] = a

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

    def cfg_of(key):
        return get_config(str(inp[key + "/arch"])).reduced().replace(
            dtype=str(inp[key + "/dtype"]))

    def mesh(shape, names=("data", "model")):
        return jax.make_mesh(shape, names,
                             axis_types=(AxisType.Auto,) * len(shape))

    def put(key, a):
        res[key] = np.asarray(jnp.asarray(a, jnp.float32)
                              if jnp.issubdtype(a.dtype, jnp.floating)
                              else a)

    m24 = mesh((2, 4))
    for case in str(inp["moe/cases"]).split(","):
        key = "moe/" + case
        cfg = cfg_of(key)
        rt = MoERuntime(
            mapping=jnp.asarray(inp[key + "/mapping"]),
            alive=jnp.asarray(inp[key + "/alive"]),
            local_table=jnp.asarray(inp[key + "/local_table"]),
            num_servers=int(inp[key + "/num_servers"]),
            capacity=int(inp[key + "/capacity"]), gemm_impl="xla_ragged")
        p, x = tree(key + "/params"), jnp.asarray(inp[key + "/x"])
        ctx = ParallelCtx(mesh=m24, axis_data=("data",), moe_runtime=rt,
                          moe_mode=str(inp[key + "/mode"]), remat=False)
        for tag, c in (("", ctx), ("/local", ParallelCtx(moe_runtime=rt,
                                                        remat=False))):
            y, st = jax.jit(lambda p, x: _moe_apply(p, x, cfg, c))(p, x)
            put(key + tag + "/y", y)
            for f in st._fields:
                put(f"{key}{tag}/{f}", getattr(st, f))

    cfg = cfg_of("sp")
    p = tree("sp/params")
    cache = kvc.KVCache(k=jnp.asarray(inp["sp/k"]), v=jnp.asarray(inp["sp/v"]),
                        length=jnp.asarray(inp["sp/length"]), window=0)
    x = jnp.asarray(inp["sp/x"])
    y, c = attn.decode_attention(p, cfg, x, cache)
    put("sp/local/y", y)
    put("sp/local/k", c.k)
    for case, m, axes in (("data", mesh((8,), ("data",)), ()),
                          ("model", mesh((1, 4)), ("model",))):
        ctx = ParallelCtx(mesh=m, axis_data=("data",), seq_shard_cache=True,
                          seq_shard_axes=axes)
        y, c = jax.jit(lambda p, x, cc: _sp_decode_attention(
            p, cfg, x, cc, ctx))(p, x, cache)
        put(f"sp/{case}/y", y)
        put(f"sp/{case}/k", c.k)
        put(f"sp/{case}/length", c.length)

    cfg = cfg_of("rwkv")
    p = tree("rwkv/params")
    st = rwk.RwkvState(*(jnp.asarray(inp["rwkv/" + k]) for k in
                         ("wkv", "shift_tmix", "shift_cmix")))
    x = jnp.asarray(inp["rwkv/x"])
    out, new = rwk.rwkv_block_forward(p["tmix"], p["cmix"], cfg, x, st,
                                      (p["ln1"], p["ln2"]))
    put("rwkv/local/x", out)
    for f in new._fields:
        put("rwkv/local/" + f, getattr(new, f))
    for case in ("12", "22"):
        layer = rwk.rwkv_block_spmd(cfg, mesh((int(case[0]), int(case[1]))),
                                    ("data",), "model")
        out = jax.jit(lambda p, x, s: layer(p["tmix"], p["cmix"], p["ln1"],
                                            p["ln2"], x, *s))(p, x, st)
        for f, a in zip(("x", "wkv", "shift_tmix", "shift_cmix"), out):
            put(f"rwkv/{case}/{f}", a)

    model = build_model(cfg)
    p = tree("rwkvm/params")
    ctx = ParallelCtx(mesh=mesh((2, 2)), axis_data=("data",), remat=False)
    logits, cache = jax.jit(lambda p, t: model.prefill(p, t, ctx))(
        p, jnp.asarray(inp["rwkvm/tokens"]))
    put("rwkvm/logits0", logits)
    step = jax.jit(lambda p, t, c: model.decode_step(p, t, c, ctx))
    steps = jnp.asarray(inp["rwkvm/steps"])
    for i in range(steps.shape[1]):
        logits, cache, _ = step(p, steps[:, i:i + 1], cache)
        put(f"rwkvm/logits{i + 1}", logits)

    from repro.launch.dryrun import moe_runtime_for   # after the backend
    cfg = cfg_of("dec")
    model = build_model(cfg, num_servers=4)
    p = tree("dec/params")
    tokens = jnp.asarray(inp["dec/tokens"])
    steps = jnp.asarray(inp["dec/steps"])
    B, S = tokens.shape
    slots = int(inp["dec/slots"])
    pre = ParallelCtx(mesh=m24, axis_data=("data",), moe_mode="a2a",
                      remat=False, moe_runtime=moe_runtime_for(
                          cfg, m24, InputShape("p", S, B, "prefill"), "a2a"))
    dec = ParallelCtx(mesh=m24, axis_data=("data",), moe_mode="replicated",
                      remat=False, seq_shard_cache=True,
                      seq_shard_axes=("model",), moe_runtime=moe_runtime_for(
                          cfg, m24, InputShape("d", slots, B, "decode"),
                          "replicated"))
    res["dec/capacity"] = np.array([pre.moe_runtime.capacity,
                                    dec.moe_runtime.capacity])
    logits, cache = jax.jit(lambda p, t: model.prefill(
        p, t, pre, max_slots=slots))(p, tokens)
    put("dec/logits0", logits)
    step = jax.jit(lambda p, t, c: model.decode_step(p, t, c, dec))
    for i in range(steps.shape[1]):
        logits, cache, _ = step(p, steps[:, i:i + 1], cache)
        put(f"dec/logits{i + 1}", logits)
    put("dec/k", cache["blocks"].k)
    np.savez(sys.argv[2], **res)
""")


def _env() -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               OMP_NUM_THREADS="1")
    return env


def _world(tmp: Path, name: str, world: int, cases) -> list:
    """Start ``world`` gloo ranks on the inputs (a file store in ``tmp``)."""
    out = tmp / name
    out.mkdir()
    return [subprocess.Popen(
        [sys.executable, str(ROOT / "tests" / "torch_spmd_ranks.py"),
         str(r), str(world), str(tmp / f"{name}.store"),
         str(tmp / "inputs.npz"), str(out), *cases],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]


def _wait(label: str, procs) -> None:
    """Every process done within TIMEOUT and exit 0; else all killed."""
    try:
        logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{label}: timed out after {TIMEOUT} s")
    bad = [(i, log) for i, (p, log) in enumerate(zip(procs, logs))
           if p.returncode]
    assert not bad, f"{label}: rank/process {bad[0][0]} failed:\n{bad[0][1]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX outputs, {world: [rank outputs]}).  The JAX subprocess
    and the 8-rank world run at once; then the 4- and 2-rank worlds."""
    tmp = tmp_path_factory.mktemp("spmd")
    inp = _inputs(tmp / "inputs.npz")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SIDE, str(tmp / "inputs.npz"),
         str(tmp / "jax.npz")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        _wait("world of 8", _world(tmp, "w8", 8, ["moe", "sp:data", "dec"]))
        _wait("world of 4", _world(tmp, "w4", 4, ["sp:model", "rwkv:22",
                                                  "rwkvm"]))
        _wait("world of 2", _world(tmp, "w2", 2, ["rwkv:12"]))
    finally:
        _wait("JAX side", [jax_proc])
    ranks = {n: [dict(np.load(tmp / f"w{n}" / f"rank{r}.npz"))
                 for r in range(n)] for n in (8, 4, 2)}
    return inp, dict(np.load(tmp / "jax.npz")), ranks


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensor_tree(inp: dict, prefix: str):
    out = {}
    for key, a in inp.items():
        name = key[:-5] if key.endswith("~bf16") else key
        if not name.startswith(prefix + "/") or a.dtype.kind in "US":
            continue
        if key.endswith("~bf16"):
            t = torch.from_numpy(a).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))
        node = out
        *parents, leaf = name[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return out


def _port_local_moe(inp: dict, case: str):
    """The port's one-device MoE layer on the case's params and all T
    tokens."""
    key = f"moe/{case}"
    cfg = get_config("kimi-k2-1t-a32b").reduced().replace(
        dtype=str(inp[key + "/dtype"]))
    tree = _tensor_tree(inp, key)
    rt = MoERuntime(tree["mapping"].long(), tree["alive"],
                    tree["local_table"].long(), num_servers=4,
                    capacity=int(inp[key + "/capacity"]))
    return ttr._moe_apply(tree["params"], tree["x"], cfg,
                          ttr.ParallelCtx(moe_runtime=rt))


def test_comm_refuses_an_unknown_mode():
    """As the reference raises on an unknown transfer mode."""
    from repro_torch.core import comm, dispatch

    x = torch.zeros(4, 8)
    ids = torch.zeros(4, 1, dtype=torch.int64)
    buf = dispatch.pack(x, ids, torch.ones(4, 1), ids, 2, 4)
    assert comm.send_to_servers(buf, "local")[0] is buf.hidden
    for call in (lambda: comm.send_to_servers(buf, "bcast"),
                 lambda: comm.return_to_clients([x], "bcast"),
                 lambda: comm.finalize_combine(x, "bcast")):
        with pytest.raises(ValueError, match="unknown comm mode"):
            call()


def _rows(ranks, key, n_data, n_model):
    """The ranks' data blocks of ``key`` in order (model rank 0 of each)."""
    return np.concatenate([ranks[d * n_model][key] for d in range(n_data)])


@pytest.mark.parametrize("case", ["a2a_f32", "replicated_f32", "a2a_bf16",
                                  "replicated_bf16", "drops"])
def test_moe_island_matches_jax_spmd(runs, case):
    inp, jx, ranks = runs
    ranks = ranks[8]
    key = f"moe/{case}"
    tol = BF16 if case.endswith("bf16") else F32
    for d in range(2):                       # each data block, every server
        for m in range(4):
            np.testing.assert_allclose(
                ranks[d * 4 + m][key + "/y"],
                jx[key + "/y"][d * 32:(d + 1) * 32], **tol)
    for r in ranks:
        for f in ("dropped", "miss", "expert_load"):
            np.testing.assert_array_equal(r[f"{key}/{f}"], jx[f"{key}/{f}"])
        for f in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(r[f"{key}/{f}"], jx[f"{key}/{f}"],
                                       rtol=1e-6, atol=1e-6)
    if case == "drops":
        assert int(jx[key + "/dropped"]) > 0
    else:
        assert int(jx[key + "/dropped"]) == 0 and int(jx[key + "/miss"]) == 0
    # against the port's one-device layer (no drops: the reference's bound)
    if case != "drops" and case.endswith("f32"):
        y, st = _port_local_moe(inp, case)
        np.testing.assert_allclose(_rows(ranks, key + "/y", 2, 4),
                                   y.numpy(), **LOCAL)
        np.testing.assert_array_equal(ranks[0][key + "/expert_load"],
                                      st.expert_load.numpy())


def test_moe_island_failover_under_spmd(runs):
    """Server 1 dead with replicas of every expert: the output equals the
    healthy one within 2e-4 and nothing misses (test_spmd.py's check),
    and both runs equal JAX's."""
    _, jx, ranks = runs
    ok = _rows(ranks[8], "moe/fo_ok/y", 2, 4)
    dead = _rows(ranks[8], "moe/fo_dead/y", 2, 4)
    np.testing.assert_allclose(dead, ok, **LOCAL)
    np.testing.assert_allclose(ok, jx["moe/fo_ok/y"], **F32)
    np.testing.assert_allclose(dead, jx["moe/fo_dead/y"], **F32)
    assert all(int(r["moe/fo_dead/miss"]) == 0 for r in ranks[8])


def test_a2a_refuses_rows_that_do_not_divide(runs):
    assert all(bool(r.get("moe/indivisible_raised", False))
               for r in runs[2][8])


def _sp_check(runs, case, world, n_shards):
    inp, jx, ranks = runs
    ranks = ranks[world]
    for r in ranks:
        np.testing.assert_allclose(r[f"sp/{case}/y"], jx[f"sp/{case}/y"],
                                   **F32)
        np.testing.assert_allclose(r[f"sp/{case}/y"], jx["sp/local/y"],
                                   **LOCAL)
        np.testing.assert_array_equal(r[f"sp/{case}/length"],
                                      np.array(LENGTHS) + 1)
    # the shards' slots, in slot order, are JAX's cache
    per = len(ranks) // n_shards
    k = np.concatenate([ranks[i * per][f"sp/{case}/k"]
                        for i in range(n_shards)], axis=1)
    np.testing.assert_allclose(k, jx[f"sp/{case}/k"], **F32)
    np.testing.assert_allclose(k, jx["sp/local/k"], **F32)


def test_sp_decode_over_data_axis(runs):
    """(8,) slot shards over data: 8 slots each, shards 5-7 of row 0 hold
    no valid slot."""
    _sp_check(runs, "data", 8, 8)


def test_sp_decode_over_model_axis(runs):
    """(1, 4): slots over the model axis (the decode cells' layout)."""
    _sp_check(runs, "model", 4, 4)


@pytest.mark.parametrize("shards", [4, 8])
def test_partial_matches_reference_on_live_shards(runs, shards):
    """decode_attention_partial (port) and flash_decode_partial_torch
    against the reference's partial, shard by shard of the SP inputs: on
    the live (b, shard) pairs (acc, m, l) at 1e-5; on an empty one the
    port's is (0, -1e30, 0); and the combine over all shards equals the
    one-device attention."""
    inp = runs[0]
    cfg = jget_config("granite-3-2b").reduced().replace(dtype="float32")
    H, hd = cfg.num_heads, cfg.head_dim
    rng = np.random.default_rng(shards)
    q = rng.normal(size=(2, 1, H, hd)).astype(np.float32)
    w = SLOTS // shards
    parts = []
    for s in range(shards):
        k = inp["sp/k"][:, s * w:(s + 1) * w]
        v = inp["sp/v"][:, s * w:(s + 1) * w]
        n = np.clip(np.array(LENGTHS) - s * w, 0, w).astype(np.int32)
        ja, jm, jl = jattn.decode_attention_partial(
            None, cfg, jnp.asarray(q), jkvc.KVCache(
                k=jnp.asarray(k), v=jnp.asarray(v), length=jnp.asarray(n),
                window=0))
        tc = tkvc.KVCache(torch.from_numpy(k), torch.from_numpy(v),
                          torch.from_numpy(n))
        ta, tm, tl = tattn.decode_attention_partial(None, cfg,
                                                    torch.from_numpy(q), tc)
        pa, pm, pl = flash_decode_partial_torch(torch.from_numpy(q[:, 0]),
                                                tc.k, tc.v, tc.length)
        for a, b in ((ta[:, 0], pa), (tm[:, 0, :, 0], pm),
                     (tl[:, 0, :, 0], pl)):
            assert torch.equal(a, b)
        live = n > 0
        for got, exp in ((ta, ja), (tm, jm), (tl, jl)):
            np.testing.assert_allclose(got.numpy()[live],
                                       np.asarray(exp)[live], **F32)
        if (~live).any():
            assert (ta.numpy()[~live] == 0).all()
            assert (tl.numpy()[~live] == 0).all()
            assert (tm.numpy()[~live] == -1e30).all()
        parts.append((ta, tm, tl))
    # the cross-shard combine (its arithmetic, one process) == one device
    m = torch.stack([p[1] for p in parts]).amax(0)
    num = sum(p[0] * torch.exp(p[1] - m) for p in parts)
    den = sum(p[2] * torch.exp(p[1] - m) for p in parts)
    ref = jattn.decode_attention_partial(None, cfg, jnp.asarray(q), jkvc.KVCache(
        k=jnp.asarray(inp["sp/k"]), v=jnp.asarray(inp["sp/v"]),
        length=jnp.asarray(np.array(LENGTHS, np.int32)), window=0))
    np.testing.assert_allclose((num / den).numpy(),
                               np.asarray(ref[0] / ref[2]), **F32)


@pytest.mark.parametrize("mesh", ["12", "22"])
def test_rwkv_block_spmd(runs, mesh):
    """rwkv6's tensor-parallel block vs JAX's island on the same mesh and
    vs the one-device block, 1e-5: outputs, the wkv state's heads, the
    shifts."""
    inp, jx, ranks = runs
    n_data, n_model = int(mesh[0]), int(mesh[1])
    ranks = ranks[n_data * n_model]
    key = f"rwkv/{mesh}"
    for name in ("x", "shift_tmix", "shift_cmix"):
        got = _rows(ranks, f"{key}/{name}", n_data, n_model)
        np.testing.assert_allclose(got, jx[f"{key}/{name}"], **F32)
        np.testing.assert_allclose(got, jx[f"rwkv/local/{name}"], **F32)
    wkv = np.concatenate([np.concatenate(
        [ranks[d * n_model + m][key + "/wkv"] for m in range(n_model)],
        axis=1) for d in range(n_data)])
    np.testing.assert_allclose(wkv, jx[key + "/wkv"], **F32)
    np.testing.assert_allclose(wkv, jx["rwkv/local/wkv"], **F32)
    # the port's own one-device block agrees too
    cfg = get_config("rwkv6-7b").reduced().replace(dtype="float32")
    p = _tensor_tree(inp, "rwkv/params")
    st = trwk.RwkvState(*(torch.from_numpy(inp["rwkv/" + k]) for k in
                          ("wkv", "shift_tmix", "shift_cmix")))
    x, _ = trwk.rwkv_block_forward(p["tmix"], p["cmix"], cfg,
                                   torch.from_numpy(inp["rwkv/x"]), st,
                                   (p["ln1"], p["ln2"]))
    np.testing.assert_allclose(_rows(ranks, key + "/x", n_data, n_model),
                               x.numpy(), **F32)


def test_rwkv_model_on_a_mesh(runs):
    """rwkv6's builder on (2, 2): prefill through the tensor-parallel
    block, then 2 teacher-forced decode steps (the island over one
    token): logits equal JAX's model under the same mesh at 1e-5 and the
    port's one-device model."""
    inp, jx, ranks = runs
    ranks = ranks[4]
    cfg = get_config("rwkv6-7b").reduced().replace(dtype="float32")
    model = ttr.build_model(cfg, 1, None, "cpu")
    params = _tensor_tree(inp, "rwkvm/params")
    logits, cache, _ = model.prefill(
        params, torch.from_numpy(inp["rwkvm/tokens"]).long())
    local = [logits]
    steps = torch.from_numpy(inp["rwkvm/steps"]).long()
    for i in range(steps.shape[1]):
        logits, cache, _ = model.decode_step(params, steps[:, i:i + 1],
                                             cache)
        local.append(logits)
    for i, exp in enumerate(local):
        for d in range(2):
            for m in range(2):
                np.testing.assert_allclose(
                    ranks[d * 2 + m][f"rwkvm/logits{i}"],
                    jx[f"rwkvm/logits{i}"][d:d + 1], **F32)
        np.testing.assert_allclose(_rows(ranks, f"rwkvm/logits{i}", 2, 2),
                                   exp.numpy(), **F32)


def test_decoder_prefill_a2a_then_sp_decode(runs):
    """The slice as a whole: prefill logits and 4 teacher-forced decode
    steps of reduced kimi-k2 on (2, 4) — prefill in a2a, decode in
    replicated over a cache slot-sharded on the model axis — equal JAX's
    SPMD run at 1e-5 (every rank of a data block), the port's one-device
    model at 2e-4; the cache's slots equal JAX's; the capacities equal
    the reference's ``moe_runtime_for``."""
    inp, jx, ranks = runs
    ranks = ranks[8]
    np.testing.assert_array_equal(ranks[0]["dec/capacity"],
                                  jx["dec/capacity"])
    cfg = get_config("kimi-k2-1t-a32b").reduced().replace(dtype="float32")
    model = ttr.build_model(cfg, 4, None, "cpu")
    tokens = torch.from_numpy(inp["dec/tokens"]).long()
    steps = torch.from_numpy(inp["dec/steps"]).long()
    ctx = ttr.ParallelCtx(moe_runtime=tmoe.default_runtime(
        cfg, 4, 32, "cpu")._replace(capacity=32 * cfg.moe.top_k))
    params = _tensor_tree(inp, "dec/params")
    local = [model.prefill(params, tokens, ctx, max_slots=32)]
    cache = local[0][1]
    for i in range(steps.shape[1]):
        local.append(model.decode_step(params, steps[:, i:i + 1], cache,
                                       ctx))
    for i, step in enumerate(local):
        exp = jx[f"dec/logits{i}"]
        for d in range(2):
            for m in range(4):
                np.testing.assert_allclose(
                    ranks[d * 4 + m][f"dec/logits{i}"], exp[d:d + 1], **F32)
        np.testing.assert_allclose(_rows(ranks, f"dec/logits{i}", 2, 4),
                                   step[0].numpy(), **LOCAL)
    k = np.concatenate([np.concatenate(
        [ranks[d * 4 + m]["dec/k"] for m in range(4)], axis=2)
        for d in range(2)], axis=1)
    np.testing.assert_allclose(k, jx["dec/k"], **F32)
    assert all(int(r["dec/dropped0"]) == 0 for r in ranks)
