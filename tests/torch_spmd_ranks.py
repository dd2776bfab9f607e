"""One gloo rank of the port's SPMD parity runs (``tests/test_torch_spmd.py``).

    python tests/torch_spmd_ranks.py RANK WORLD STORE INPUTS OUT_DIR CASE...

Joins a gloo world of WORLD ranks through the file store STORE, runs each
CASE (``moe``, ``sp:<cases>``, ``rwkv:<meshes>``, ``rwkvm``, ``dec``,
``cell:<cases>``, ``int8``) on
the inputs (``INPUTS``, an ``.npz`` of numpy params and data written by
the test; bfloat16 leaves as their uint16 bits, under a key ending in
``~bf16``) and writes what this rank computed to
``OUT_DIR/rank<RANK>.npz``.  It imports the port only: no JAX.  One torch
thread; every collective times out after 60 s, so a rank stuck in one
fails instead of hanging the suite.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.bridge import params_from_numpy, shard_from_numpy
from repro_torch.configs import InputShape, get_config
from repro_torch.core.moe_layer import MoERuntime
from repro_torch.distributed.mesh_axes import axes_group
from repro_torch.distributed.sharding_rules import shard_leaf, shard_params
from repro_torch.kernels.build import tensors as leaves
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as meshlib
from repro_torch.launch.dryrun import moe_runtime_for
from repro_torch.models import kv_cache as kvc
from repro_torch.models import rwkv as rwk
from repro_torch.models import transformer as tr
from repro_torch.training import tree as T


def load(path):
    """The inputs: arrays as CPU tensors (``~bf16`` keys decoded), strings
    as numpy strings."""
    out = {}
    for key, a in np.load(path).items():
        if key.endswith("~bf16"):
            out[key[:-5]] = torch.from_numpy(a).view(torch.bfloat16)
        elif a.dtype.kind in "US":
            out[key] = a
        else:
            out[key] = torch.from_numpy(a)
    return out


def tree(inp, prefix):
    """The nested dict saved under ``prefix/`` (keys joined by "/")."""
    out = {}
    for key, val in inp.items():
        if key.startswith(prefix + "/"):
            node = out
            *parents, leaf = key[len(prefix) + 1:].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = val
    return out


def np_out(t):
    """A copy (a later in-place step must not move what was saved)."""
    return t.detach().float().numpy().copy()


def cfg_of(inp, key):
    """The case's reduced config in its dtype, with the case's overrides
    (a JSON object under ``<key>/overrides``) when it has any."""
    name, dtype = str(inp[key + "/arch"]), str(inp[key + "/dtype"])
    cfg = get_config(name).reduced().replace(dtype=dtype)
    if key + "/overrides" in inp:
        cfg = cfg.replace(**json.loads(str(inp[key + "/overrides"])))
    return cfg


def fill_cache(cache, inp, prefix):
    """A copy of ``cache`` whose every leaf is the input under
    ``prefix/<path>`` (reshaped: the reference stacks gemma3's local rings
    on two layer axes, the port on one)."""
    return T.map_paths(lambda path, leaf: inp[
        f"{prefix}/" + "/".join(path)].reshape(leaf.shape).to(
            leaf.dtype).clone(), cache)


def clone_cache(cache):
    """A copy of ``cache`` whose leaves are clones."""
    return T.map_paths(lambda _, leaf: leaf.clone(), cache)


def runtime(inp, key):
    return MoERuntime(
        mapping=torch.as_tensor(inp[key + "/mapping"]).long(),
        alive=torch.as_tensor(inp[key + "/alive"]),
        local_table=torch.as_tensor(inp[key + "/local_table"]).long(),
        num_servers=int(inp[key + "/num_servers"]),
        capacity=int(inp[key + "/capacity"]))


def data_rows(mesh, a):
    """This rank's block of ``a``'s rows over the data axis."""
    return shard_leaf(a, ("data",), dict(zip(mesh.mesh_dim_names,
                                              mesh.shape)),
                      dict(zip(mesh.mesh_dim_names, mesh.get_coordinate())))


def moe_cases(inp, out):
    """The MoE island on (2, 4): each key ``moe/<case>`` of the inputs
    names its params, runtime, mode and x; this rank's rows of y and the
    global stats are saved.  Then an a2a call whose rows do not divide
    over the servers must raise before any transfer."""
    mesh = meshlib.make_test_mesh(2, 4, device="cpu")
    for case in str(inp["moe/cases"]).split(","):
        key = f"moe/{case}"
        cfg = cfg_of(inp, key)
        p = shard_params(tree(inp, key + "/params"), mesh)
        ctx = tr.ParallelCtx(mesh=mesh, moe_runtime=runtime(inp, key),
                             moe_mode=str(inp[key + "/mode"]))
        x = data_rows(mesh, inp[key + "/x"])
        y, st = tr._moe_apply(p, x, cfg, ctx)
        out[key + "/y"] = np_out(y)
        for f in st._fields:
            out[f"{key}/{f}"] = st._asdict()[f].numpy()
        if case == "a2a_f32":
            try:
                tr._moe_apply(p, x[:-2], cfg, ctx)
            except ValueError:
                out["moe/indivisible_raised"] = np.array(True)


def sp_cases(inp, out, cases):
    """Sequence-parallel decode attention: ``sp/<case>`` on its mesh, this
    rank's output and its slots of the k cache."""
    for case in cases:
        key = f"sp/{case}"
        n_data, n_model = (int(v) for v in inp[key + "/mesh"])
        mesh = meshlib.make_test_mesh(n_data, n_model, device="cpu")
        axes = tuple(str(inp[key + "/axes"]).split(","))
        cfg = cfg_of(inp, "sp")
        ctx = tr.ParallelCtx(mesh=mesh, seq_shard_cache=True,
                             seq_shard_axes=axes)
        ridx, n = tr._slot_shard(ctx)
        k, v = inp["sp/k"], inp["sp/v"]
        w = k.shape[1] // n
        cache = kvc.KVCache(k[:, ridx * w:(ridx + 1) * w].clone(),
                            v[:, ridx * w:(ridx + 1) * w].clone(),
                            inp["sp/length"].clone())
        y, cache = tr._sp_decode_attention(tree(inp, "sp/params"), cfg,
                                           inp["sp/x"], cache, ctx)
        out[key + "/y"] = np_out(y)
        out[key + "/k"] = np_out(cache.k)
        out[key + "/length"] = cache.length.numpy()


def rwkv_cases(inp, out, cases):
    """rwkv6's tensor-parallel block on ``rwkv/<case>``'s mesh: this
    rank's rows of x and the shifts, and its heads of the wkv state."""
    cfg = cfg_of(inp, "rwkv")
    for case in cases:
        n_data, n_model = (int(v) for v in case)
        mesh = meshlib.make_test_mesh(n_data, n_model, device="cpu")
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        p = shard_params(tree(inp, "rwkv/params"), mesh)
        st = rwk.RwkvState(
            shard_leaf(inp["rwkv/wkv"], ("data", "model"), sizes, coord),
            data_rows(mesh, inp["rwkv/shift_tmix"]),
            data_rows(mesh, inp["rwkv/shift_cmix"]))
        x, new = rwk.rwkv_block_spmd(
            p["tmix"], p["cmix"], cfg, data_rows(mesh, inp["rwkv/x"]), st,
            (p["ln1"], p["ln2"]), axes_group(mesh, ("model",)))
        key = f"rwkv/{case}"
        out[key + "/x"] = np_out(x)
        for f in new._fields:
            out[f"{key}/{f}"] = np_out(getattr(new, f))


def rwkv_model_case(inp, out):
    """rwkv6's builder on (2, 2): prefill, then teacher-forced decode
    steps; this rank's rows of each step's logits."""
    mesh = meshlib.make_test_mesh(2, 2, device="cpu")
    cfg = cfg_of(inp, "rwkv")
    model = tr.build_model(cfg, 1, None, "cpu")
    params = shard_params(tree(inp, "rwkvm/params"), mesh)
    ctx = tr.ParallelCtx(mesh=mesh)
    steps = data_rows(mesh, inp["rwkvm/steps"]).long()
    logits, cache, _ = model.prefill(
        params, data_rows(mesh, inp["rwkvm/tokens"]).long(), ctx)
    out["rwkvm/logits0"] = np_out(logits)
    for i in range(steps.shape[1]):
        logits, cache, _ = model.decode_step(params, steps[:, i:i + 1],
                                             cache, ctx)
        out[f"rwkvm/logits{i + 1}"] = np_out(logits)


def decoder_case(inp, out):
    """The slice as a whole: reduced kimi-k2 on (2, 4), prefill in a2a,
    then teacher-forced decode steps in replicated mode over a cache
    slot-sharded over the model axis (the dry-run cells' contexts), this
    rank's batch rows; each step's logits saved."""
    mesh = meshlib.make_test_mesh(2, 4, device="cpu")
    cfg = cfg_of(inp, "dec")
    as_np = lambda t: ({k: as_np(v) for k, v in t.items()}   # noqa: E731
                       if isinstance(t, dict) else t.numpy())
    params = shard_from_numpy(as_np(tree(inp, "dec/params")), cfg, "cpu",
                              mesh)
    tokens = data_rows(mesh, inp["dec/tokens"]).long()
    steps = data_rows(mesh, inp["dec/steps"]).long()
    B, S = inp["dec/tokens"].shape
    slots = int(inp["dec/slots"])
    model = tr.build_model(cfg, 4, None, "cpu")
    pre = tr.ParallelCtx(mesh=mesh, moe_mode="a2a", seq_shard_cache=True,
                         seq_shard_axes=("model",), moe_runtime=moe_runtime_for(
                             cfg, mesh, InputShape("p", S, B, "prefill"),
                             "a2a"))
    dec = tr.ParallelCtx(mesh=mesh, moe_mode="replicated",
                         seq_shard_cache=True, seq_shard_axes=("model",),
                         moe_runtime=moe_runtime_for(
                             cfg, mesh, InputShape("d", slots, B, "decode"),
                             "replicated"))
    out["dec/capacity"] = np.array([pre.moe_runtime.capacity,
                                    dec.moe_runtime.capacity])
    logits, cache, st = model.prefill(params, tokens, pre, max_slots=slots)
    out["dec/logits0"] = np_out(logits)
    out["dec/dropped0"] = st.dropped.numpy()
    for i in range(steps.shape[1]):
        logits, cache, st = model.decode_step(params, steps[:, i:i + 1],
                                              cache, dec)
        out[f"dec/logits{i + 1}"] = np_out(logits)
    out["dec/k"] = np_out(cache["blocks"].k)


def _as_np(t):
    return ({k: _as_np(v) for k, v in t.items()} if isinstance(t, dict)
            else t.numpy())


def cell_cases(inp, out, cases):
    """Dry-run cells (``launch/dryrun.build_cell``) on a (2, 2) or (2, 4)
    gloo mesh: each key ``cell/<case>`` names the arch, the kind, the
    shape, the config's overrides and the whole params (and the decode
    cell's whole cache, every leaf under ``cache/<path>``; a train cell's
    frames); the phase is the cell's own unless ``force`` names ZeRO-3's
    ``train``.  Saved: a train step's metrics and this rank's updated
    shards; a prefill's rows of the logits and its cache; a serve step's
    rows of the next token and the logits and its shard of the cache,
    each cache leaf under ``<path>``.

    A case listed under ``cell/twice`` also calls its compiled step
    (``cell.step``) a second time, on other data — the train step on the
    state the first call wrote in place, the serve step on the cache it
    wrote and the token it returned — and the plain step (``cell.plain``)
    twice from the same inputs; saved under ``<key>/compiled/``: whether
    both calls were bitwise equal, whether the state or cache stayed in
    place, the compiled step's captures and its eager reason."""
    meshes = {}
    twice = set(str(inp.get("cell/twice", "")).split(","))
    for case in cases:
        key = f"cell/{case}"
        n_data, n_model = (int(v) for v in inp[key + "/mesh"])
        if (n_data, n_model) not in meshes:
            meshes[n_data, n_model] = meshlib.make_test_mesh(
                n_data, n_model, device="cpu")
        mesh = meshes[n_data, n_model]
        cfg = cfg_of(inp, key)
        kind = str(inp[key + "/kind"])
        B, S = (int(v) for v in inp[key + "/shape"])
        force = str(inp[key + "/force"])
        keep = dryrun.train_phase_for
        if force:
            dryrun.train_phase_for = lambda *a, **k: force
        try:
            cell = dryrun.build_cell(cfg.arch_id, InputShape(case, S, B, kind),
                                     mesh, cfg=cfg, device="cpu")
        finally:
            dryrun.train_phase_for = keep
        out[key + "/phase"] = np.array(cell.phase)
        params = params_from_numpy(
            cell.shard(_as_np(tree(inp, key + "/params"))), None, "cpu")
        rows = {k: cell.rows(k, inp[f"{key}/{k}"])
                for k in ("tokens", "labels", "mrope_positions", "frames")
                if f"{key}/{k}" in inp}
        rows = {k: v if k == "frames" else v.long() for k, v in rows.items()}
        if kind == "train":
            state = dryrun.init_state(cell, params)
            at = leaves(state)
            state, met = cell.step(state, rows)
            for k in ("loss", "grad_norm", "ce", "aux", "dropped"):
                if k in met:
                    out[f"{key}/{k}"] = met[k].float().numpy()
            for path, leaf in T.items(state.params):
                out[f"{key}/p/" + "/".join(path)] = np_out(leaf)
            if case in twice:
                other = dict(rows, tokens=rows["labels"],
                             labels=rows["tokens"])
                got = [met, cell.step(state, other)]
                inplace = all(a is b for a, b in zip(
                    at, leaves(got[1][0])))
                ref = dryrun.init_state(cell, params_from_numpy(
                    cell.shard(_as_np(tree(inp, key + "/params"))), None,
                    "cpu"))
                ref, m0 = cell.plain(ref, rows)
                want = [m0, cell.plain(ref, other)]
                same = all(torch.equal(a[k], b[k]) for a, b in
                           ((got[0], want[0]), (got[1][1], want[1][1]))
                           for k in ("loss", "grad_norm"))
                same &= all(torch.equal(a, b) for a, b in zip(
                    leaves(got[1][0]), leaves(want[1][0])))
                compiled_report(out, key, cell.step, same, inplace)
        elif kind == "prefill":
            logits, cache = cell.step(params, rows["tokens"])
            out[key + "/logits"] = np_out(logits)
            for path, leaf in T.paths(cache):
                out[f"{key}/" + "/".join(path)] = np_out(leaf)
            if case in twice:
                other = rows["tokens"].flip(1)
                got = [(logits, cache), cell.step(params, other)]
                want = [cell.plain(params, rows["tokens"]),
                        cell.plain(params, other)]
                same = all(torch.equal(a, b) for g, w in zip(got, want)
                           for a, b in zip(leaves(g), leaves(w)))
                compiled_report(out, key, cell.step, same, True)
        else:
            whole = fill_cache(cell.model.init_cache(B, S), inp,
                               key + "/cache")
            cache = clone_cache(cell.cache_shard(whole))
            start = clone_cache(cache)
            logits = cell.model.decode_step(params, rows["tokens"],
                                            clone_cache(cache), cell.ctx)[0]
            at = leaves(cache)
            nxt, cache = cell.step(params, rows["tokens"], cache)
            out[key + "/logits"] = np_out(logits)
            out[key + "/next"] = nxt.numpy().copy()
            for path, leaf in T.paths(cache):
                out[f"{key}/" + "/".join(path)] = (
                    leaf.numpy().copy()
                    if leaf.dtype in (torch.int32, torch.int64)
                    else np_out(leaf))
            if case in twice:
                got = [nxt.clone(), *cell.step(params, nxt, cache)]
                inplace = all(a is b for a, b in zip(at, leaves(got[2])))
                n0, ref = cell.plain(params, rows["tokens"], start)
                n1, ref = cell.plain(params, n0, ref)
                same = torch.equal(got[0], n0) and torch.equal(got[1], n1) \
                    and all(torch.equal(a, b) for a, b in zip(
                        leaves(got[2]), leaves(ref)))
                compiled_report(out, key, cell.step, same, inplace)


def compiled_report(out, key, step, same: bool, inplace: bool) -> None:
    """What a case's two compiled calls showed (``cell_cases``)."""
    out[key + "/compiled/equal"] = np.array(same)
    out[key + "/compiled/inplace"] = np.array(inplace)
    out[key + "/compiled/captures"] = np.array(step.captures)
    out[key + "/compiled/reason"] = np.array(step.decision.reason)


def int8_case(inp, out):
    """The int8 compression of a leaf cut into row blocks over the world:
    the scale is the whole leaf's (a max over every shard)."""
    from repro_torch.distributed.tensor_parallel import LeafShards
    from repro_torch.training.train_loop import compress_with_feedback

    g = torch.randn(16, 8, generator=torch.Generator().manual_seed(3))
    g[5, 2] = 40.0                       # the max lies in one shard
    n, r = dist.get_world_size(), dist.get_rank()
    mine = g[r * 16 // n:(r + 1) * 16 // n]
    deq, res = compress_with_feedback(
        mine, torch.zeros_like(mine),
        LeafShards(whole=(16, 8), all=dist.group.WORLD))
    out["int8/deq"], out["int8/res"] = deq.numpy(), res.numpy()


def main() -> int:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    store, inputs, out_dir = sys.argv[3:6]
    cases = sys.argv[6:]
    torch.set_num_threads(1)
    meshlib.init_distributed(rank, world, f"file://{store}", device="cpu",
                             timeout_s=60)
    inp = load(inputs)
    out = {}
    for case in cases:
        kind, _, arg = case.partition(":")
        if kind == "moe":
            moe_cases(inp, out)
        elif kind == "sp":
            sp_cases(inp, out, arg.split(","))
        elif kind == "rwkv":
            rwkv_cases(inp, out, arg.split(","))
        elif kind == "rwkvm":
            rwkv_model_case(inp, out)
        elif kind == "dec":
            decoder_case(inp, out)
        elif kind == "cell":
            cell_cases(inp, out, arg.split(","))
        elif kind == "int8":
            int8_case(inp, out)
        else:
            raise ValueError(case)
    np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
