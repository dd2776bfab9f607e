"""The dry-run's accounting on ``meta`` under the ``fake`` backend
(``repro_torch.launch.dryrun``).

* ``input_specs`` and ``probe_plan`` equal the reference's for every
  assigned architecture and shape.
* A cell's per-rank argument bytes are the shards' shapes as the table
  places every leaf.
* The FLOPs of a reduced dense and a reduced MoE prefill cell equal a hand
  count from the shapes (every matmul, the kernels by their own work).
* The full-depth count equals the reference's probe extrapolation.
* The collectives of a small decode cell equal a hand count, by kind.
* ``run_cell`` at the production meshes: ``ok`` for a cell of every
  family, ``skip`` where the reference skips; no cell is ``not_ported``.
* Every cell of gemma3, zamba2, rwkv6 and whisper (reduced) counts on a
  (2, 4) mesh; one prefill cell per family equals a hand count; the
  audio, hybrid and local-global probe plans extrapolate to the
  full-depth count.

The fake world lives in this process; the module fixture tears it down.
"""

import math
import os

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import (ALL_SHAPES, ASSIGNED_ARCHS, InputShape,
                                 get_config)
from repro_torch.distributed import sharding_rules as tsr
from repro_torch.launch import dryrun as tdr
from repro_torch.launch import mesh as tmesh
from repro_torch.training import tree as T

_flags = os.environ.get("XLA_FLAGS")
import repro.launch.dryrun as jdr  # noqa: E402  (sets XLA_FLAGS on import)
if _flags is None:
    os.environ.pop("XLA_FLAGS", None)
else:
    os.environ["XLA_FLAGS"] = _flags


@pytest.fixture(scope="module", autouse=True)
def _one_thread_and_teardown():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape, names=("data", "model")):
    from torch.distributed.device_mesh import init_device_mesh
    tmesh.fake_world(math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS + ["deepseek-r1"])
def test_input_specs_and_probe_plan_match_reference(arch):
    from repro.configs import get_config as jget
    cfg, jcfg = get_config(arch), jget(arch)
    for shape in ALL_SHAPES:
        from repro.configs import shape_by_name
        got = tdr.input_specs(cfg, shape)
        want = jdr.input_specs(jcfg, shape_by_name(shape.name))
        assert list(got) == list(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    probes, comb = tdr.probe_plan(cfg)
    jprobes, jcomb = jdr.probe_plan(jcfg)
    assert [(p.num_layers, p.num_encoder_layers) for p in probes] == [
        (p.num_layers, p.num_encoder_layers) for p in jprobes]
    costs = [{"flops": 10.0 * (i + 1) + i * i, "b": 3.0 * i}
             for i in range(len(probes))]
    assert comb(costs) == jcomb(costs)


def _whole_params(cell):
    return cell.model.init_params(torch.Generator().manual_seed(0))


def test_argument_bytes_are_the_shards():
    """Reduced deepseek-r1's ZeRO-3 train cell on (2, 4): the params'
    bytes are every leaf's shard as its placement cuts it; the optimizer
    state's are Adafactor's factors of those shards."""
    mesh = _mesh((2, 4))
    cfg = get_config("deepseek-r1").reduced()
    keep = tdr.train_phase_for
    tdr.train_phase_for = lambda *a, **k: "train"
    try:
        cell = tdr.build_cell(cfg.arch_id, InputShape("t", 32, 8, "train"),
                              mesh, cfg=cfg, device="meta")
    finally:
        tdr.train_phase_for = keep
    full = _whole_params(cell)
    specs = tsr.param_placements(full, "train", dp=("data",))
    sizes = {"data": 2, "model": 4}
    want, state, cut = 0, 0, 0
    for path, leaf in T.items(full):
        spec = T.get(specs, path)
        shard = [n // math.prod(sizes[a] for a in ((s,) if isinstance(
            s, str) else s)) if s is not None else n
            for n, s in zip(leaf.shape, tuple(spec) + (None,) * leaf.dim())]
        want += math.prod(shard) * leaf.element_size()
        state += 4 * (math.prod(shard[:-1]) + math.prod(shard[:-2])
                      * shard[-1] if len(shard) >= 2 else shard[0])
        cut += shard != list(leaf.shape)
    counts = tdr.count_cell(cell)
    assert counts["argument_bytes"]["params"] == want
    assert counts["argument_bytes"]["opt_state"] == state
    assert cut > 10
    assert counts["argument_bytes"]["batch"] == 2 * 4 * 32 * 4


def _prefill_flops(cfg, b, S, n, V):
    """Hand count of one rank's prefill on a (2, n) mesh, phase serve:
    every matmul 2·M·K·N; attention 4·b·H·S²·hd over whole heads (a head
    cut gathers them); the MoE tier by its kernels' work, the expert GEMMs
    by the cells' dense lowering (one batched product over L local
    experts x ``ecap`` rows each, as the reference counts its dry-run)."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    T_ = b * S
    gathered = H % n or KV % n
    attn = (2 * T_ * d * (H + 2 * KV) * hd // n
            + 4 * b * H * S * S * hd // (1 if gathered else n)
            + 2 * T_ * H * hd * d // n)

    def mlp(f):
        return 3 * 2 * T_ * d * f // n
    total = 0
    m = cfg.moe
    n_dense = m.first_k_dense if m else cfg.num_layers
    total += n_dense * (attn + mlp(cfg.d_ff))
    if m:
        from repro_torch.core.moe_layer import default_capacity
        t_loc = T_ // n
        C = default_capacity(t_loc, m.top_k, n, m.capacity_factor)
        M = n * C                       # the server's rows: n clients
        L = m.num_experts // n          # its local experts
        ecap = max(8, (-(-(M * 5) // (4 * L)) + 7) // 8 * 8)
        moe = (2 * t_loc * d * m.num_experts          # the router
               + 3 * 2 * L * ecap * d * m.d_expert    # the grouped GEMMs
               + t_loc * m.top_k * d                  # the combine
               + (mlp(m.d_expert * m.num_shared_experts)
                  if m.num_shared_experts else 0))
        total += (cfg.num_layers - n_dense) * (attn + moe)
    return total + 2 * b * d * V // n          # the last position's logits


@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-r1"])
def test_prefill_flops_equal_a_hand_count(arch):
    mesh = _mesh((2, 4))
    cfg = get_config(arch).reduced()
    cell = tdr.build_cell(arch, InputShape("p", 32, 8, "prefill"), mesh,
                          cfg=cfg, device="meta")
    got = tdr.count_cell(cell)["flops"]
    want = _prefill_flops(cfg, 4, 32, 4, cfg.padded_vocab)
    assert got == pytest.approx(want, rel=1e-9)


def test_full_depth_equals_the_probe_extrapolation():
    """Reduced deepseek-r1's train cell (1 dense + 3 MoE layers) on (2, 4):
    counted at full depth, and extrapolated from the reference's 2- and
    3-layer probes: FLOPs and every collective's bytes and count equal."""
    mesh = _mesh((2, 4))
    cfg = get_config("deepseek-r1").reduced()
    shape = InputShape("t", 32, 8, "train")
    full = tdr._linear_costs(tdr.count_cell(tdr.build_cell(
        cfg.arch_id, shape, mesh, cfg=cfg, device="meta")))
    probed = tdr.run_probes(cfg.arch_id, shape, mesh, cfg=cfg)
    assert set(full) == set(probed) and len(full) > 4
    for k, v in full.items():
        assert probed[k] == pytest.approx(v, rel=1e-9), k


def test_decode_collectives_equal_a_hand_count():
    """Reduced granite-3-2b's serve step on a (1, 2) mesh: per layer the
    slot-sharded attention's MAX of m (b, H) and SUM of (acc | l) (b, H,
    hd + 1) in fp32 and the MLP's row-parallel SUM (b, 1, d); the vocab-
    parallel embedding's SUM (b, 1, d); the logits gathered (b, V) fp32."""
    mesh = _mesh((1, 2))
    cfg = get_config("granite-3-2b").reduced()
    b = 2
    cell = tdr.build_cell(cfg.arch_id, InputShape("d", 32, b, "decode"),
                          mesh, cfg=cfg, device="meta")
    c = tdr.count_cell(cell)
    L, H, hd, d = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.d_model
    e = 2                                      # bf16
    assert c["collective_counts"] == {"all-reduce": 3 * L + 1,
                                      "all-gather": 1}
    assert c["collective_bytes"]["all-reduce"] == (
        L * (b * H * 4 + b * H * (hd + 1) * 4 + b * d * e) + b * d * e)
    assert c["collective_bytes"]["all-gather"] == b * cfg.padded_vocab * 4


def test_run_cell_at_production_scale():
    """The accounting at 16 x 16: ok for a decoder-family cell (per-rank
    numbers present) and for a cell of each of the other four families;
    the reference's skip kept; no status ``not_ported`` left."""
    r = tdr.run_cell("granite-3-2b", "decode_32k", False, save=False)
    assert r["status"] == "ok", r.get("traceback")
    assert r["num_devices"] == 256 and r["flops_per_device"] > 0
    assert r["memory"]["fits_h100_80gib"] is True
    assert r["collective_counts"]["all-reduce"] > 0
    for arch, shape in (("gemma3-4b", "long_500k"),
                        ("zamba2-2.7b", "decode_32k"),
                        ("whisper-base", "decode_32k"),
                        ("rwkv6-7b", "prefill_32k")):
        r = tdr.run_cell(arch, shape, False, save=False)
        assert r["status"] == "ok", (arch, r.get("traceback"))
        assert r["flops_per_device"] > 0 and r["collective_counts"], arch
    r = tdr.run_cell("granite-3-2b", "long_500k", True, save=False)
    assert r["status"] == "skip"
    assert not hasattr(tdr, "not_ported")


# ------------------------------------------------ the other four families

FAMILY_CFGS = {
    # gemma3 with a global group and a ring shorter than the cells' 32
    "gemma3-4b": dict(num_layers=8, sliding_window=16),
    "zamba2-2.7b": {},
    "rwkv6-7b": {},
    # 2 heads: not whole over 4 model ranks (the heads gathered)
    "whisper-base": dict(num_heads=2, num_kv_heads=2),
}


def _family_cfg(arch, **kw):
    return get_config(arch).reduced().replace(**{**FAMILY_CFGS[arch], **kw})


@pytest.mark.parametrize("arch", list(FAMILY_CFGS))
def test_family_cells_count(arch):
    """Each family's reduced train, prefill and decode cells count on a
    (2, 4) mesh in their phases: FLOPs, peak and collectives."""
    mesh = _mesh((2, 4))
    cfg = _family_cfg(arch)
    for kind, phase in (("train", "train_tp"), ("prefill", "serve"),
                        ("decode", "decode")):
        cell = tdr.build_cell(arch, InputShape(kind, 32, 8, kind), mesh,
                              cfg=cfg, device="meta")
        assert cell.phase == phase
        c = tdr.count_cell(cell)
        assert c["flops"] > 0 and c["peak_bytes"] > c["argument_total"]
        assert c["collective_counts"].get("all-reduce", 0) > 0, kind


def _attn_flops(cfg, b, Sq, Sk, n, gathered):
    """One attention layer on a rank: q over Sq positions, k / v over Sk,
    every score of the (Sq, Sk) block, whole heads when gathered."""
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    return (2 * b * Sq * d * H * hd // n + 2 * 2 * b * Sk * d * KV * hd // n
            + 4 * b * H * Sq * Sk * hd // (1 if gathered else n)
            + 2 * b * Sq * H * hd * d // n)


def _mlp_flops(cfg, T, n):
    mats = 3 if cfg.activation == "swiglu" else 2
    return mats * 2 * T * cfg.d_model * cfg.d_ff // n


def _ssd_flops(cfg, b, S):
    """The Mamba mixer's counted matmuls (the chunked SSD's einsums), run
    whole on every rank: counted on meta by ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import mamba as mam

    _, H, P, N = mam.dims(cfg)
    m = lambda *s: torch.empty(s, device="meta")   # noqa: E731
    with FlopCounterMode(display=False) as fl:
        mam._ssd_chunked(m(b, S, H, P), m(b, S, H), m(b, S, N), m(b, S, N),
                         m(b, H, P, N), 64)
    return fl.get_total_flops()


def _family_prefill_flops(arch, cfg, b, S, n):
    """Hand count of one rank's prefill on a (2, n) mesh, phase serve."""
    d, V = cfg.d_model, cfg.padded_vocab
    T = b * S
    gathered = bool(cfg.num_heads % n or cfg.num_kv_heads % n)
    logits = 2 * b * d * V // n
    if arch == "gemma3-4b":
        return cfg.num_layers * (_attn_flops(cfg, b, S, S, n, gathered)
                                 + _mlp_flops(cfg, T, n)) + logits
    if arch == "whisper-base":
        Se = cfg.encoder_seq_len
        enc = cfg.num_encoder_layers * (
            _attn_flops(cfg, b, Se, Se, n, gathered)
            + _mlp_flops(cfg, b * Se, n))
        dec = cfg.num_layers * (_attn_flops(cfg, b, S, S, n, gathered)
                                + _attn_flops(cfg, b, S, Se, n, gathered)
                                + _mlp_flops(cfg, T, n))
        return enc + dec + logits
    if arch == "zamba2-2.7b":
        from repro_torch.models import mamba as mam
        di, H, P, N = mam.dims(cfg)
        mamba = (2 * T * d * (2 * di + 2 * N + H) // n     # in_proj
                 + _ssd_flops(cfg, b, S)                   # mixer, whole
                 + 2 * T * di * d // n)                    # out_proj
        groups = cfg.num_layers // cfg.shared_block_every
        return (cfg.num_layers * mamba
                + groups * (_attn_flops(cfg, b, S, S, n, gathered)
                            + _mlp_flops(cfg, T, n)) + logits)
    # rwkv6: the island on this rank's heads and columns
    from repro_torch.kernels.meta import wkv_flops
    from repro_torch.models import rwkv as rwk
    H, D = rwk.dims(cfg)
    lora, f = max(32, d // 64), cfg.d_ff
    tmix = (4 * 2 * T * d * d // n                 # r, k, v, g (columns)
            + 2 * T * d * lora + 2 * T * lora * d // n     # the decay
            + wkv_flops(b, S, H // n, D, backward=False)
            + 2 * T * d * d // n)                  # w_o (rows)
    cmix = 2 * 2 * T * d * f // n + 2 * T * d * d  # w_k, w_v; w_r whole
    return cfg.num_layers * (tmix + cmix) + logits


@pytest.mark.parametrize("arch", list(FAMILY_CFGS))
def test_family_prefill_flops_equal_a_hand_count(arch):
    mesh = _mesh((2, 4))
    cfg = _family_cfg(arch)
    cell = tdr.build_cell(arch, InputShape("p", 32, 8, "prefill"), mesh,
                          cfg=cfg, device="meta")
    got = tdr.count_cell(cell)["flops"]
    assert got == pytest.approx(_family_prefill_flops(arch, cfg, 4, 32, 4),
                                rel=1e-9)


@pytest.mark.parametrize("arch,kw", [
    ("gemma3-4b", dict(num_layers=14)),         # 2 groups + 2 local
    ("zamba2-2.7b", dict(num_layers=18)),       # 3 groups
    ("whisper-base", dict(num_encoder_layers=4))])  # enc = dec depth
def test_family_probes_equal_the_full_depth(arch, kw):
    """The local-global, hybrid and audio branches of ``probe_plan``: the
    reference's extrapolation from its depth probes equals the train
    cell counted at full depth (FLOPs, every collective's bytes and
    count)."""
    mesh = _mesh((2, 4))
    cfg = _family_cfg(arch, **kw)
    shape = InputShape("t", 32, 8, "train")
    full = tdr._linear_costs(tdr.count_cell(tdr.build_cell(
        arch, shape, mesh, cfg=cfg, device="meta")))
    probed = tdr.run_probes(arch, shape, mesh, cfg=cfg)
    assert set(full) == set(probed) and len(full) > 4
    for k, v in full.items():
        assert probed[k] == pytest.approx(v, rel=1e-9), k


# ------------------------------------------- graphed or eager: the rule

@pytest.mark.parametrize("device,backends,graphed,words", [
    ("cuda", ("nccl", "nccl", "nccl"), True, ("graphed", "NCCL")),
    ("cuda", (), True, ("graphed",)),
    ("cuda", ("nccl", "gloo"), False, ("gloo",)),
    ("cuda", ("fake",), False, ("fake",)),
    ("meta", ("fake", "fake"), False, ("on meta", "fake")),
    ("cpu", ("gloo",), False, ("on cpu", "gloo")),
])
def test_graph_decision_from_device_and_backends(device, backends, graphed,
                                                 words):
    """``build.decide``: a CUDA graph on the card when every group is
    NCCL's; eager on the CPU, on ``meta`` and over gloo or the fake world,
    each reason named; under ``eager()`` always eager."""
    from repro_torch.kernels import build

    d = build.decide(device, backends)
    assert d.graphed is graphed
    assert all(w in d.reason for w in words), d.reason
    with build.eager():
        d = build.decide(device, backends)
    assert not d.graphed and "under eager()" in d.reason
    assert not build.decide(device, backends, "its own rule").graphed


@pytest.mark.parametrize("arch,kind", [("deepseek-r1", "train"),
                                       ("deepseek-r1", "prefill"),
                                       ("deepseek-r1", "decode"),
                                       ("rwkv6-7b", "prefill")])
def test_cells_on_meta_and_fake_stay_eager(arch, kind):
    """On a fake world's (2, 4) mesh, ``build_cell``'s compiled
    steps decide eager before any work: on ``meta``, and on the card too,
    since the fake backend's collectives cannot be captured.  rwkv6's
    prefill stays eager by the family's own rule (its scan bodies are the
    graphs).  The accounting counts the plain step and captures nothing."""
    from repro_torch.distributed.mesh_axes import mesh_groups
    from repro_torch.kernels import build

    mesh = _mesh((2, 4))
    cfg = get_config(arch).reduced()
    cell = tdr.build_cell(arch, InputShape("c", 64, 16, kind), mesh,
                          cfg=cfg, device="meta")
    d = cell.step.decision
    assert not d.graphed and "on meta" in d.reason and "fake" in d.reason
    on_card = build.decide("cuda", build.group_backends(mesh_groups(mesh)))
    assert not on_card.graphed and "fake" in on_card.reason
    assert (tdr.SCAN_PREFILL in d.reason) == (arch == "rwkv6-7b")
    assert tdr.count_cell(cell)["flops"] > 0
    assert cell.step.captures == 0
