"""Two-microbatch decode in the port (``repro_torch.core.overlap``, the
executor's ``decode_mode`` and ``decode_masked``) against the JAX package.

Mirrors tests/test_overlap.py (schedule, double-batch overlap, the split
decode step) and tests/test_engine_split.py (lockstep, pipelined and
serialized engines give identical tokens; the virtual clock charges the
pipelined step less), on a reduced deepseek-r1 in float32 with bridged
params: tokens and fingerprints equal the reference's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as J
from repro.configs import get_config as jget_config
from repro.core import overlap as joverlap
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import moe_layer
from repro_torch.core.overlap import (double_batch_overlap,
                                      microbatch_schedule, split_batch_decode)
from repro_torch.models.transformer import ParallelCtx, build_model

MODES = ("lockstep", "pipelined", "serialized")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------- microbatch_schedule

@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_schedule_phase_order_per_microbatch(n):
    steps = microbatch_schedule(n)
    assert steps == joverlap.microbatch_schedule(n)
    for mb in range(n):
        assert [ph for i, ph in steps if i == mb] == \
            ["attention", "dispatch", "combine"]


@pytest.mark.parametrize("n", [2, 3, 5, 8])
def test_schedule_overlaps_attention_with_expert_round_trip(n):
    pos = {(mb, ph): t for t, (mb, ph) in enumerate(microbatch_schedule(n))}
    for i in range(n - 1):
        assert pos[(i, "dispatch")] < pos[(i + 1, "attention")] \
            < pos[(i, "combine")]


# --------------------------------------------------- double_batch_overlap

def _toy_fns(seed, d=16):
    rng = np.random.default_rng(seed)
    wd = torch.as_tensor(rng.normal(size=(d, d)) * 0.1, dtype=torch.float32)
    wm = torch.as_tensor(rng.normal(size=(d, d)) * 0.1, dtype=torch.float32)
    return (lambda a: torch.tanh(a @ wd),
            lambda a: a + torch.nn.functional.gelu(a @ wm))


def _randn(seed, *shape):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape),
                           dtype=torch.float32)


def test_double_batch_overlap_matches_serialized():
    dense, moe = _toy_fns(0)
    x = _randn(1, 8, 16)
    torch.testing.assert_close(
        double_batch_overlap(dense, moe, x, enabled=True),
        double_batch_overlap(dense, moe, x, enabled=False), rtol=0, atol=0)


def test_double_batch_overlap_matches_unsplit():
    dense, moe = _toy_fns(2)
    x = _randn(3, 6, 16)
    torch.testing.assert_close(double_batch_overlap(dense, moe, x),
                               moe(dense(x)), rtol=1e-6, atol=1e-6)


def test_double_batch_overlap_rejects_odd_batch():
    dense, moe = _toy_fns(4)
    with pytest.raises(ValueError, match="even batch"):
        double_batch_overlap(dense, moe, torch.zeros(5, 16))


# ----------------------------------------------------- split_batch_decode

def test_split_batch_decode_matches_full_step():
    """Same logits, same state, summed stats, with the state's batch axis
    at 1 — the toy step appends in place, as the port's decode step does."""
    w = _randn(5, 16, 16) * 0.1

    def step(tokens, state):
        x = torch.nn.functional.one_hot(tokens[:, 0], 16).float() @ w
        state["cache"] += x[None]
        return state["cache"].sum(0), state, {"load": tokens.sum()}

    tokens = (torch.arange(8) % 16)[:, None]
    init = _randn(6, 3, 8, 16)
    full = {"cache": init.clone()}
    l_full, _, st_full = step(tokens, full)
    for enabled in (True, False):
        state = {"cache": init.clone()}
        l_sp, out, st_sp = split_batch_decode(step, tokens, state, axis=1,
                                              enabled=enabled)
        assert out is state
        torch.testing.assert_close(l_sp, l_full, rtol=0, atol=0)
        torch.testing.assert_close(state["cache"], full["cache"], rtol=0,
                                   atol=0)
        assert int(st_sp["load"]) == int(st_full["load"])
    with pytest.raises(ValueError, match="even batch"):
        split_batch_decode(step, tokens[:5], {"cache": init[:, :5].clone()},
                           axis=1)


def _decoder(max_batch=4, max_seq=32):
    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    model = build_model(cfg, 4, np.zeros((4, 0), np.int32), "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    # capacity for every pick of the full batch: neither split drops
    ctx = ParallelCtx(moe_runtime=moe_layer.default_runtime(
        cfg, 4, 4 * max_batch, "cpu"))
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (max_batch, 6), generator=g)
    _, cache, _ = model.prefill(params, prompt, ctx, max_slots=max_seq)
    return cfg, model, params, ctx, cache, g


def _clone(cache):
    return {n: type(c)(c.k.clone(), c.v.clone(), c.length.clone())
            for n, c in cache.items()}


def test_split_decode_step_matches_lockstep():
    """Over the reduced decoder: the two split modes agree bitwise (logits
    and caches: the same half-batch shapes), and with the full-batch step
    at 1e-5 in logits and caches — not bitwise, since the CPU's BLAS
    rounds a row differently at another row count (M = 1 takes a
    matrix-vector path) — with the stats summed exactly."""
    cfg, model, params, ctx, cache, g = _decoder()
    split = {True: _clone(cache), False: _clone(cache)}
    for _ in range(3):
        tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=g)
        l_full, cache, st_full = model.decode_step(params, tok, cache, ctx)
        out = {}
        for enabled, c in split.items():
            out[enabled] = split_batch_decode(
                lambda t, c: model.decode_step(params, t, c, ctx), tok, c,
                axis=1, enabled=enabled)
        assert torch.equal(out[True][0], out[False][0])
        for enabled, (l_sp, c, st_sp) in out.items():
            assert c is split[enabled]
            torch.testing.assert_close(l_sp, l_full, rtol=1e-5, atol=1e-5)
            assert torch.equal(st_sp.expert_load, st_full.expert_load)
            assert int(st_sp.dropped) == int(st_full.dropped) == 0
            assert int(st_sp.miss) == int(st_full.miss) == 0
        for name in cache:
            for f in ("k", "v", "length"):
                a, b = (getattr(split[e][name], f) for e in (True, False))
                assert torch.equal(a, b), (name, f)
                torch.testing.assert_close(a, getattr(cache[name], f),
                                           rtol=1e-5, atol=1e-5)
        # every row appended once, in place, through the views
        assert (split[True]["blocks"].length == cache["blocks"].length).all()


# ------------------------------------------------------------ engine level

def _cfgs():
    return (jget_config("deepseek-r1").reduced().replace(dtype="float32"),
            get_config("deepseek-r1").reduced().replace(dtype="float32"))


def _ecfg(mod, **kw):
    # tests/test_engine_split.py::_engine: buffers sized for the longest
    # prefill step, so no variant drops tokens
    kw.setdefault("pool_tokens_per_client", 128)
    return mod.EngineConfig(mode="eaas", num_servers=4, max_batch=4,
                            max_seq=128, n_redundant=2, **kw)


def _scenario(mod, vocab):
    return mod.Scenario(horizon=0.15, seed=7, prompt_len=8, max_new=5,
                        vocab=vocab).poisson(rate=100)


def _streams(res):
    return {r.request_id: tuple(r.output_tokens) for r in res.requests}


@pytest.fixture(scope="module")
def bridged():
    jcfg, tcfg = _cfgs()
    jeng = J.ServingEngine(jcfg, _ecfg(J), seed=0, clock=J.VirtualClock())
    params = jax.tree.map(np.asarray, jeng.params)
    return jcfg, tcfg, jeng, params


def _port(tcfg, params, **kw):
    return T.ServingEngine(tcfg, _ecfg(T, **kw),
                           params=params_from_numpy(params, tcfg, "cpu"),
                           clock=T.VirtualClock(), device="cpu")


@pytest.fixture(scope="module")
def scenario_runs(bridged):
    jcfg, tcfg, jeng, params = bridged
    out = {"jax": _scenario(J, jcfg.vocab_size).run(jeng)}
    for mode in MODES:
        out[mode] = _scenario(T, tcfg.vocab_size).run(
            _port(tcfg, params, decode_mode=mode))
    return out


def test_decode_modes_token_identical_to_jax(scenario_runs):
    """The acceptance pin: the split changes when work runs, not what it
    computes — and all three equal the reference's lockstep engine."""
    want = _streams(scenario_runs["jax"])
    assert len(want) > 4
    for mode in MODES:
        res = scenario_runs[mode]
        assert res.metrics.completed == res.metrics.total_requests
        assert _streams(res) == want, mode


def test_pipelined_beats_serialized_on_the_virtual_clock(bridged):
    """Mirrors tests/test_engine_split.py::test_pipelined_decode_throughput
    _beats_serialized: the same pre-submitted batch; the clock charges a
    pipelined step max(attention, expert) + eps, a serialized one the sum,
    the same as lockstep."""
    _, tcfg, _, params = bridged

    def run(mode):
        eng = _port(tcfg, params, decode_mode=mode)
        rng = np.random.default_rng(1)
        for i in range(8):
            eng.submit(T.Request(
                i, rng.integers(0, tcfg.vocab_size, size=8).astype(np.int32),
                T.SamplingParams(max_new_tokens=8)))
        return eng.run(max_steps=500)

    m = {mode: run(mode) for mode in MODES}
    assert all(x.completed == 8 for x in m.values())
    assert m["pipelined"].wall_time < m["serialized"].wall_time
    assert m["pipelined"].decode_throughput > \
        m["serialized"].decode_throughput
    assert m["serialized"].wall_time == pytest.approx(m["lockstep"].wall_time)


def test_pipelined_chunked_fingerprint_matches_jax(bridged):
    """Mirrors tests/test_engine_split.py::test_determinism_with_pipeline
    _and_chunking: the port's fingerprint equals the reference's."""
    jcfg, tcfg, _, params = bridged
    kw = dict(decode_mode="pipelined", prefill_chunk=4, policy="fair")
    jeng = J.ServingEngine(jcfg, _ecfg(J, **kw), seed=0,
                           clock=J.VirtualClock())
    jres = _scenario(J, jcfg.vocab_size).run(jeng)
    tres = _scenario(T, tcfg.vocab_size).run(_port(tcfg, params, **kw))
    assert tres.metrics.fingerprint() == jres.metrics.fingerprint()
    assert _streams(tres) == _streams(jres)


# ------------------------------------------------------------ decode_masked

def _ready(eng, mod, vocab):
    """Four requests prefilled into the four slots, one decode step run."""
    rng = np.random.default_rng(3)
    for i in range(4):
        eng.submit(mod.Request(i, rng.integers(0, vocab, 5 + i)
                               .astype(np.int32),
                               mod.SamplingParams(max_new_tokens=20)))
    for _ in range(5):
        eng.step()
    assert len(eng.scheduler.decode_ready()) == 4


def test_decode_masked_restores_inactive_rows(bridged):
    jcfg, tcfg, _, params = bridged
    eng = _port(tcfg, params)
    _ready(eng, T, tcfg.vocab_size)
    ex = eng.executor
    tokens = np.array([[3], [17], [250], [9]], np.int64)
    mask = np.array([True, False, True, False])
    before = _clone(ex.cache)
    logits_m, load_m = ex.decode_masked(tokens, mask)
    after_masked = _clone(ex.cache)
    ex.cache = _clone(before)
    logits_full, _ = ex.decode(tokens)
    active = torch.as_tensor(mask)
    assert torch.equal(logits_m[active], logits_full[active])
    for name, c in after_masked.items():
        full = ex.cache[name]
        for f in ("k", "v", "length"):
            got, old, new = (getattr(x, f) for x in (c, before[name], full))
            assert torch.equal(got[:, ~active], old[:, ~active]), (name, f)
            assert torch.equal(got[:, active], new[:, active]), (name, f)
    assert int(load_m.sum()) == 4 * tcfg.moe.top_k * \
        (tcfg.num_layers - tcfg.moe.first_k_dense)

    # the reference executor's decode_masked on the same state
    jeng = J.ServingEngine(jcfg, _ecfg(J), params=jax.tree.map(
        jnp.asarray, params), seed=0, clock=J.VirtualClock())
    _ready(jeng, J, jcfg.vocab_size)
    for name, c in before.items():
        np.testing.assert_array_equal(
            np.asarray(jeng.executor.cache[name].length), c.length.numpy())
    jlogits, jload = jeng.executor.decode_masked(tokens.astype(np.int32),
                                                 mask)
    np.testing.assert_allclose(logits_m[active].numpy(),
                               np.asarray(jlogits)[mask], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(load_m.numpy(), np.asarray(jload))
    for name, c in after_masked.items():
        np.testing.assert_array_equal(
            np.asarray(jeng.executor.cache[name].length), c.length.numpy())
        for f in ("k", "v"):
            np.testing.assert_allclose(
                np.asarray(getattr(jeng.executor.cache[name], f)),
                getattr(c, f).numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- refusals

@pytest.mark.parametrize("mode", ["pipelined", "serialized"])
def test_split_modes_refuse_paged_cache_and_odd_batch(mode):
    cfg = get_config("deepseek-r1").reduced()
    with pytest.raises(ValueError, match="kv_mode='paged'"):
        T.ServingEngine(cfg, T.EngineConfig(
            decode_mode=mode, kv_mode="paged", max_batch=4, max_seq=64),
            device="cpu")
    with pytest.raises(ValueError, match="even max_batch"):
        T.ServingEngine(cfg, T.EngineConfig(decode_mode=mode, max_batch=5),
                        device="cpu")


def test_unknown_decode_mode_raises():
    cfg = get_config("deepseek-r1").reduced()
    with pytest.raises(ValueError, match="unknown decode_mode"):
        T.ServingEngine(cfg, T.EngineConfig(decode_mode="wavefront"),
                        device="cpu")


# ------------------------------------------- every system x decode mode

_LOCKSTEP = {}


def _serve_mode(mode, decode_mode):
    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    eng = T.ServingEngine(cfg, T.EngineConfig(
        mode=mode, decode_mode=decode_mode, max_batch=4, max_seq=64,
        tp_batch_cap=2, restart_steps=5, tp_restart_steps=3,
        pool_tokens_per_client=64), clock=T.VirtualClock(), device="cpu")
    rng = np.random.default_rng(0)
    reqs = [T.Request(i, rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                      T.SamplingParams(max_new_tokens=5)) for i in range(4)]
    for r in reqs:
        eng.submit(r)

    def on_step(e):
        if e.step_idx == 6:
            e.inject_server_failure(1)
        if e.step_idx == 9:
            e.recover_server(1)
    m = eng.run(on_step=on_step)
    return [r.output_tokens for r in reqs], m


@pytest.mark.parametrize("decode_mode", MODES)
@pytest.mark.parametrize("mode", ["eaas", "monolithic_ep", "tp"])
def test_every_mode_serves_with_lockstep_tokens(mode, decode_mode):
    """Each system mode serves in each decode mode through a fail/recover
    (same seeded weights: seed 0): the split modes give lockstep's tokens
    and halts; pipelined is charged less virtual time, serialized the
    same."""
    if mode not in _LOCKSTEP:
        _LOCKSTEP[mode] = _serve_mode(mode, "lockstep")
    want, m0 = _LOCKSTEP[mode]
    got, m = _serve_mode(mode, decode_mode)
    assert m.completed == 4 and got == want
    halts = [x["halted"] for x in m.timeline]
    assert halts == [x["halted"] for x in m0.timeline]
    assert sum(halts) == {"eaas": 0, "monolithic_ep": 5, "tp": 3}[mode]
    if decode_mode == "pipelined":
        assert m.wall_time < m0.wall_time
    else:
        assert m.wall_time == pytest.approx(m0.wall_time)
