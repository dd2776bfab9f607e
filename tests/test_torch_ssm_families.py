"""The last three model families — zamba2 (Mamba2 + one shared attention
block), rwkv6 (recurrent time-mix) and whisper (encoder-decoder) — in the
port against the JAX package, as a whole: configs and the registry, each
reduced model's prefill plus 8 teacher-forced decode steps, the lockstep
engine's greedy tokens and fingerprint under VirtualClock, the reference's
decode fault and its refusals, the executor's slot write for every cache
layout, and the serving launcher on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as jengine_mod
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import get_config as jget_config
from repro.models.transformer import ParallelCtx
from repro.models.transformer import _zero_stats as jzero_stats
from repro.models.transformer import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.serving import VirtualClock as JVirtualClock
from repro.serving.executor import _slot_write as jslot_write
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import REGISTRY, get_config
from repro_torch.launch import serve as launcher
from repro_torch.models.transformer import build_model
from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                 ServingEngine, VirtualClock)
from repro_torch.serving.executor import Executor

ARCHS = ["zamba2-2.7b", "rwkv6-7b", "whisper-base"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Reduced models run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (jget_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    assert repr(get_config(arch)) == repr(jget_config(arch))
    assert repr(get_config(arch).reduced()) == \
        repr(jget_config(arch).reduced())


def test_registry_is_the_reference_registry_and_every_arch_builds():
    """All eleven architectures; ``build_model`` builds each (reduced) and
    none raises NotImplementedError."""
    assert sorted(REGISTRY) == sorted(JREGISTRY)
    assert len(REGISTRY) == 11
    for arch in sorted(REGISTRY):
        cfg = get_config(arch).reduced()
        model = build_model(cfg, 2, np.zeros((2, 1), np.int32)
                            if cfg.moe else None, "cpu")
        assert model.cfg is cfg


# ---------------------------------------------- prefill + 8 decode steps

def _pair(arch, dtype):
    cfg, tcfg = _cfgs(arch, dtype=dtype)
    jm, tm = jbuild(cfg), build_model(tcfg, 1, None, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jm, tm, jp, tp


@functools.lru_cache(maxsize=None)
def _run_both(arch, dtype, plen=23, eager=False):
    """Prefill of 2 x ``plen`` tokens (whisper: with seeded frames), then 8
    teacher-forced decode steps, in both packages: the reference jitted,
    or eager (``jax.disable_jit``: op by op, as torch rounds).  Cached:
    the eager zamba2 run serves two tests."""
    cfg, jm, tm, jp, tp = _pair(arch, dtype)
    ctx = ParallelCtx(remat=False)
    jit = (lambda f: f) if eager else jax.jit
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, (2, plen)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (8, 2, 1)).astype(np.int32)
    jb = tb = None
    if cfg.family == "audio":
        f = (rng.normal(size=(2, cfg.encoder_seq_len, cfg.d_model))
             * 0.1).astype(np.float32)
        jb, tb = {"frames": jnp.asarray(f)}, {"frames": torch.as_tensor(f)}
    with jax.disable_jit(eager):
        jl, jc = jit(lambda p, t: jm.prefill(p, t, ctx, batch=jb,
                                             max_slots=64))(
            jp, jnp.asarray(prompt))
    tl, tc, st = tm.prefill(tp, torch.as_tensor(prompt).long(), None,
                            max_slots=64, batch=tb)
    pairs = [(tl, np.asarray(jl))]
    jdecode = jit(lambda p, t, c: jm.decode_step(p, t, c, ctx)[:2])
    stats = [st]
    for t in range(8):
        with jax.disable_jit(eager):
            jl, jc = jdecode(jp, jnp.asarray(steps[t]), jc)
        tl, tc, st = tm.decode_step(tp, torch.as_tensor(steps[t]).long(),
                                    tc, None)
        pairs.append((tl, np.asarray(jl)))
        stats.append(st)
    return pairs, stats


# zamba2's 12 reduced layers amplify any fp32 rounding
# (test_reduced_zamba2_amplifies_rounding): each Mamba layer alone is held
# at 1e-5 (tests/test_torch_mamba.py), the model's logits at 5e-4.
FP32_TOL = {"zamba2-2.7b": 5e-4, "rwkv6-7b": 1e-5, "whisper-base": 1e-5}


def test_reduced_zamba2_amplifies_rounding():
    """Why zamba2's model-level tolerance is not 1e-5: a relative change of
    1e-7 (an fp32 rounding) in its embeddings moves its fp32 logits by
    more than 5e-5 — the port's own sensitivity, with no reference in the
    comparison."""
    _, tcfg = _cfgs("zamba2-2.7b")
    tm = build_model(tcfg, 1, None, "cpu")
    p = tm.init_params(torch.Generator().manual_seed(0))
    prompt = torch.randint(0, 512, (2, 23),
                           generator=torch.Generator().manual_seed(3))
    noise = torch.randn(p["embed"].shape,
                        generator=torch.Generator().manual_seed(9))
    base = tm.prefill(p, prompt, None, max_slots=32)[0]
    moved = tm.prefill(dict(p, embed=p["embed"] * (1 + 1e-7 * noise)),
                       prompt, None, max_slots=32)[0]
    assert 5e-5 < (moved - base).abs().max() < 5e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_float32(arch):
    pairs, stats = _run_both(arch, "float32")
    tol = FP32_TOL[arch]
    for tl, jl in pairs:
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, rtol=tol, atol=tol)
    # zero stats where the reference returns None
    assert all(int(s.expert_load.sum()) == 0 and int(s.dropped) == 0
               for s in stats)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_bfloat16(arch):
    """XLA's fusions keep bf16 intermediates in fp32 where torch (and the
    eager reference) round them, and a reduced model's depth amplifies each
    rounding; zamba2 is held to the eager reference
    (``test_zamba2_bfloat16_rounds_as_the_eager_reference``), rwkv6 and
    whisper to the jitted one.  As ``tests/test_torch_model.py`` holds the
    decoder, the logits (std ~1) are held to a mean |difference| of 0.1 a
    step and the greedy token to agree on at least 16 of the 18 rows."""
    pairs, _ = _run_both(arch, "bfloat16", plen=12,
                         eager=arch == "zamba2-2.7b")
    agree = 0
    for tl, jl in pairs:
        assert np.isfinite(tl.numpy()).all()
        assert np.abs(tl.numpy() - jl).mean() <= 0.1
        agree += int((tl.numpy().argmax(-1) == jl.argmax(-1)).sum())
    assert agree >= 16


def test_zamba2_bfloat16_rounds_as_the_eager_reference():
    """In bf16 the port's zamba2 logits are nearer the eager reference's
    than the jitted reference's are: the jitted reference rounds
    elsewhere, so it is not the yardstick for zamba2's bf16 test."""
    eager, _ = _run_both("zamba2-2.7b", "bfloat16", plen=12, eager=True)
    jitted, _ = _run_both("zamba2-2.7b", "bfloat16", plen=12)
    port = np.mean([np.abs(t.numpy() - e).mean() for t, e in eager])
    jit = np.mean([np.abs(j - e).mean()
                   for (_, j), (_, e) in zip(jitted, eager)])
    assert port < jit


# ------------------------------------------------------------- engines

ENGINE = dict(max_batch=4, max_seq=128, prefill_chunk=32)
# a prime prompt (zamba2's chunked SSD runs Q = 1), a multiple of 64
# (Q = 64) and one whose Q is a smaller divisor (40)
PROMPTS = (71, 64, 40)


@pytest.fixture()
def jax_family_stats(monkeypatch):
    """The reference's zamba2, rwkv6 and whisper ``decode_step`` return
    stats None, which its engine's decode reads (``st.expert_load``:
    AttributeError, ROADMAP Queue 3).  Test-side only, the engine's model
    is wrapped to return the zero stats the dense decoder returns, so the
    reference's engine can serve them for the comparison."""
    orig = jengine_mod.build_model

    def build(cfg, **kw):
        m = orig(cfg, **kw)

        def decode_step(*a, **k):
            logits, cache, st = m.decode_step(*a, **k)
            return logits, cache, jzero_stats(cfg) if st is None else st
        return m._replace(decode_step=decode_step)
    monkeypatch.setattr(jengine_mod, "build_model", build)


def _serve(eng, req_cls, sp_cls):
    rng = np.random.default_rng(0)
    reqs = [req_cls(i, rng.integers(0, 512, size=n).astype(np.int32),
                    sp_cls(max_new_tokens=6))
            for i, n in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run()


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch, jax_family_stats):
    """Lockstep engine, dense cache, VirtualClock, fp32: the same greedy
    tokens and fingerprint.  Whole-prompt prefill (the chunk size is
    ignored, as the reference's engine ignores it for these families); the
    engine passes no frames, so whisper encodes zeros in both."""
    cfg, tcfg = _cfgs(arch)
    jeng = JServingEngine(cfg, JEngineConfig(**ENGINE), seed=0,
                          clock=JVirtualClock())
    jreqs, jm = _serve(jeng, JRequest, JSamplingParams)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               "cpu")
    teng = ServingEngine(tcfg, EngineConfig(**ENGINE), params=params,
                         clock=VirtualClock(), device="cpu")
    treqs, tm = _serve(teng, Request, SamplingParams)
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
    assert all(len(r.output_tokens) == 6 for r in treqs)
    assert tm.fingerprint() == jm.fingerprint()
    assert teng.pool is None and teng.model.cache_batch_axis is None
    assert teng.scheduler.cfg.prefill_chunk == \
        jeng.scheduler.cfg.prefill_chunk == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_decode_fault(arch):
    """Unwrapped, the reference's engine cannot decode these families (its
    decode_step returns no stats); the port's returns zero stats and
    serves (``test_engine_matches_reference``)."""
    cfg, _ = _cfgs(arch)
    eng = JServingEngine(cfg, JEngineConfig(**ENGINE), seed=0,
                         clock=JVirtualClock())
    eng.submit(JRequest(0, np.arange(10, dtype=np.int32),
                        JSamplingParams(max_new_tokens=3)))
    with pytest.raises(AttributeError, match="expert_load"):
        eng.run()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kw", [dict(kv_mode="paged"),
                                dict(decode_mode="pipelined"),
                                dict(decode_mode="serialized"),
                                dict(exec_mode="async")],
                         ids=["paged", "pipelined", "serialized", "async"])
def test_refusals_match_reference(arch, kw):
    """Paged KV, split decode and the async tier refuse these families in
    both packages, with the same error type and message."""
    cfg, tcfg = _cfgs(arch)
    ecfg = dict(ENGINE, **kw)
    with pytest.raises(Exception) as jerr:
        JServingEngine(cfg, JEngineConfig(**ecfg), seed=0,
                       clock=JVirtualClock())
    with pytest.raises(Exception) as terr:
        ServingEngine(tcfg, EngineConfig(**ecfg), clock=VirtualClock(),
                      device="cpu")
    assert type(terr.value) is type(jerr.value) is ValueError
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------- slot write

def _random_like(tree, rng):
    """A cache of the same structure with random (or random-integer)
    leaves, as numpy."""
    def fill(a):
        a = np.asarray(a)
        if a.dtype.kind in "iu":
            return rng.integers(0, 50, a.shape).astype(a.dtype)
        return rng.normal(size=a.shape).astype(a.dtype)
    return jax.tree.map(fill, tree)


def _to_port(tree_np, like):
    """numpy leaves -> the port's cache structure ``like``."""
    leaves = jax.tree.leaves(tree_np)
    it = iter(leaves)

    def rebuild(node):
        if isinstance(node, torch.Tensor):
            return tensor_from_numpy(next(it), "cpu")
        if isinstance(node, dict):
            return {k: rebuild(node[k]) for k in sorted(node)}
        if isinstance(node, tuple):
            return type(node)(*(rebuild(a) for a in node))
        return type(node)(**{f: rebuild(getattr(node, f))
                             for f in ("k", "v", "length")},
                          window=node.window)
    return rebuild(like)


@pytest.mark.parametrize("arch,max_batch", [
    ("zamba2-2.7b", 4), ("rwkv6-7b", 4), ("whisper-base", 4),
    ("deepseek-r1", 4), ("gemma3-4b", 3), ("zamba2-2.7b", 1)])
def test_commit_is_the_reference_slot_write(arch, max_batch):
    """``Executor._commit`` writes a batch-1 cache into slot b bitwise as
    the reference's ``_slot_write`` does: Mamba states (batch on axis 2),
    RWKV states, whisper's self KV and cross K/V, the decoder's and
    gemma3's KV stacks; with max_batch 1 it replaces every leaf."""
    cfg, tcfg = _cfgs(arch, dtype="bfloat16")
    S = 2 if cfg.moe else 1
    table = np.zeros((S, 1), np.int32) if cfg.moe else None
    jm = jbuild(cfg, S, table)
    tm = build_model(tcfg, S, table, "cpu")
    rng = np.random.default_rng(max_batch)
    big = _random_like(jm.init_cache(max_batch, 24), rng)
    one = _random_like(jm.init_cache(1, 24), rng)
    slot = max_batch - 2 if max_batch > 1 else 0
    want = jax.tree.map(lambda b, o: jslot_write(jnp.asarray(b),
                                                 jnp.asarray(o), slot),
                        big, one)
    ex = Executor(tm, {}, None, max_batch=max_batch, max_seq=24,
                  device="cpu")
    assert sorted(ex.cache) == sorted(big)
    ex.cache = _to_port(big, ex.cache)
    ex._commit(slot, _to_port(one, tm.init_cache(1, 24)))
    got = _to_port(want, ex.cache)
    for a, b in zip(jax.tree.leaves(ex.cache, is_leaf=torch.is_tensor),
                    jax.tree.leaves(got, is_leaf=torch.is_tensor)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b)


# ------------------------------------------------------------- launcher

@pytest.mark.parametrize("arch", ["rwkv6-7b", "deepseek-r1"])
def test_launcher_serves_on_the_cpu(arch, capsys):
    """``--device cpu`` runs reduced configs on the plain versions: the
    reference's launcher crashes on rwkv6 (its decode fault); the port's
    serves it and the deepseek-r1 cluster, and prints the summary."""
    assert launcher.main(["--arch", arch, "--device", "cpu", "--requests",
                          "2", "--max-new", "3"]) == 0
    out = capsys.readouterr().out
    assert f"=== summary ({arch}-reduced, cpu) ===" in out
    assert "  completed: 2" in out


def test_launcher_without_a_card_exits(monkeypatch):
    """``--device cuda`` (the default) with no card exits with an error;
    it does not carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as err:
        launcher.main(["--arch", "rwkv6-7b", "--requests", "1"])
    assert "no CUDA device" in str(err.value)
