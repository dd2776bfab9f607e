"""The paper's baselines in the port against the JAX package: monolithic EP
and TP (``repro_torch.core.monolithic``, the engine's ``mode`` branches and
the scheduler's TP ``batch_cap``).

The MoE functions are compared in float32 at 1e-5 on bridged params.  The
engine modes replay the reference's Fig. 10 engine configuration
(``benchmarks/fault_tolerance.py:26-29``) on a seeded fail/recover
scenario under VirtualClock on a reduced deepseek-r1 in float32: greedy
tokens, virtual token times, the timeline's halted flags and
``metrics.fingerprint()`` must equal the reference's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as J
from repro.configs import get_config as jget_config
from repro.core import monolithic as jmono
from repro.serving.scheduler import Scheduler as JScheduler
from repro.serving.scheduler import SchedulerConfig as JSchedulerConfig
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import moe_layer, monolithic
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig

TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("eaas", "monolithic_ep", "tp")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch="deepseek-r1"):
    return (jget_config(arch).reduced().replace(dtype="float32"),
            get_config(arch).reduced().replace(dtype="float32"))


def _bridge_moe(jp, tcfg):
    """A MoE params subtree through the weight bridge (which wants a whole
    params tree: an embedding rides along)."""
    tree = {"embed": np.zeros((tcfg.padded_vocab, tcfg.d_model), np.float32),
            **jax.tree.map(np.asarray, jp)}
    return params_from_numpy(tree, tcfg, "cpu")


def _x(cfg, T_, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T_, cfg.d_model)) * 0.3).astype(np.float32)


# ------------------------------------------------------------ MoE functions

def test_monolithic_ep_equivalent_when_healthy():
    """EAAS degenerates exactly to monolithic EP with a primary-only map
    (mirrors tests/test_moe_layer.py::test_monolithic_ep_equivalent_when
    _healthy on the port)."""
    _, cfg = _cfgs("kimi-k2-1t-a32b")
    S, T_ = 4, 24
    params = monolithic.init_monolithic_ep(
        cfg, S, torch.float32, "cpu", torch.Generator().manual_seed(0))
    x = torch.as_tensor(_x(cfg, T_, 1))
    rt = moe_layer.default_runtime(cfg, S, T_, "cpu")
    rt = rt._replace(capacity=T_ * cfg.moe.top_k)
    y_eaas, _ = moe_layer.eaas_moe_apply(params, x, cfg.moe, rt,
                                         activation=cfg.activation)
    rt_mono = monolithic.monolithic_runtime(cfg, S, T_, "cpu")
    assert rt_mono.mapping.shape == (cfg.moe.num_experts, 1)
    assert bool(rt_mono.alive.all())
    rt_mono = rt_mono._replace(capacity=rt.capacity)
    y_mono, st = monolithic.monolithic_ep_apply(params, x, cfg, rt_mono)
    torch.testing.assert_close(y_mono, y_eaas, **TOL)
    assert int(st.miss) == 0


@pytest.mark.parametrize("arch", ["deepseek-r1", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("mode", ["monolithic_ep", "tp"])
def test_monolithic_apply_matches_jax(arch, mode):
    jcfg, tcfg = _cfgs(arch)
    S, T_ = 4, 24
    x = _x(tcfg, T_, 2)
    key = jax.random.PRNGKey(0)
    if mode == "tp":
        jp = jmono.init_tp_moe(key, jcfg)
        y, st = jmono.tp_moe_apply(jp, jnp.asarray(x), jcfg,
                                   gemm_impl="xla_ragged")
        ty, tst = monolithic.tp_moe_apply(_bridge_moe(jp, tcfg),
                                          torch.as_tensor(x), tcfg)
    else:
        jp = jmono.init_monolithic_ep(key, jcfg, S)
        jrt = jmono.monolithic_runtime(jcfg, S, T_ // 2, "xla_ragged")
        trt = monolithic.monolithic_runtime(tcfg, S, T_ // 2, "cpu")
        assert trt.capacity == jrt.capacity
        np.testing.assert_array_equal(trt.mapping.numpy(), jrt.mapping)
        np.testing.assert_array_equal(trt.local_table.numpy(),
                                      jrt.local_table)
        y, st = jmono.monolithic_ep_apply(jp, jnp.asarray(x), jcfg, jrt)
        ty, tst = monolithic.monolithic_ep_apply(_bridge_moe(jp, tcfg),
                                                 torch.as_tensor(x), tcfg,
                                                 trt)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_array_equal(tst.expert_load.numpy(),
                                  np.asarray(st.expert_load))
    assert int(tst.dropped) == int(st.dropped)
    assert int(tst.miss) == int(st.miss) == 0


def test_init_layouts():
    """Monolithic EP: S servers of E/S slots, no redundant slot; TP: one
    server of all E experts."""
    _, cfg = _cfgs()
    E, gen = cfg.moe.num_experts, torch.Generator().manual_seed(0)
    ep = monolithic.init_monolithic_ep(cfg, 4, torch.float32, "cpu", gen)
    tp = monolithic.init_tp_moe(cfg, torch.float32, "cpu", gen)
    assert ep["servers"]["w_gate"].shape[:2] == (4, E // 4)
    assert tp["servers"]["w_down"].shape[:2] == (1, E)


# ------------------------------------------------------------ engine halts

def _requests(n, vocab, max_new=8):
    rng = np.random.default_rng(0)
    return [T.Request(i, rng.integers(0, vocab, size=6).astype(np.int32),
                      T.SamplingParams(max_new_tokens=max_new))
            for i in range(n)]


def test_engine_eaas_survives_failure():
    """Mirrors tests/test_fault_tolerance.py::test_engine_eaas_survives
    _failure on the port."""
    cfg = get_config("deepseek-r1").reduced()
    eng = T.ServingEngine(cfg, T.EngineConfig(
        mode="eaas", num_servers=4, max_batch=2, max_seq=48, n_redundant=2),
        device="cpu")
    for r in _requests(4, cfg.vocab_size):
        eng.submit(r)
    eng.run(max_steps=20)                      # mid-flight
    eng.inject_server_failure(1)
    m = eng.run(max_steps=500)
    assert m.completed == 4
    assert not any(t.get("halted") for t in m.timeline)
    assert not eng.pool.smap.alive[1]


def test_engine_monolithic_halts_on_failure():
    """Mirrors tests/test_fault_tolerance.py::test_engine_monolithic_halts
    _on_failure on the port: a full group restart of 15 steps, then it
    recovers; the pool's liveness is never touched."""
    cfg = get_config("deepseek-r1").reduced()
    eng = T.ServingEngine(cfg, T.EngineConfig(
        mode="monolithic_ep", num_servers=4, max_batch=2, max_seq=48,
        restart_steps=15), device="cpu")
    assert eng.pool.redundant_table.shape[1] == 0
    assert eng.rebalancer is None
    for r in _requests(4, cfg.vocab_size):
        eng.submit(r)
    eng.run(max_steps=10)
    eng.inject_server_failure(0)
    m = eng.run(max_steps=800)
    halted = [t for t in m.timeline if t.get("halted")]
    assert len(halted) == 15
    assert all(t["tokens"] == 0 for t in halted)
    assert m.completed == 4
    assert eng.pool.smap.alive.all()


def test_engine_tp_caps_batch_and_halts_one_unit():
    cfg = get_config("deepseek-r1").reduced()
    eng = T.ServingEngine(cfg, T.EngineConfig(
        mode="tp", num_servers=4, max_batch=4, max_seq=48, tp_batch_cap=2,
        tp_restart_steps=7), device="cpu")
    assert eng.pool.num_servers == 1
    for r in _requests(4, cfg.vocab_size):
        eng.submit(r)
    eng.run(max_steps=6)
    assert eng.slots[2] is None and eng.slots[3] is None
    eng.inject_server_failure(3)
    m = eng.run(max_steps=800)
    assert sum(1 for t in m.timeline if t.get("halted")) == 7
    assert m.completed == 4
    assert max(t["tokens"] for t in m.timeline) <= 2


# ------------------------------------------------ Fig. 10 parity per mode

def _fig10_ecfg(mod, mode):
    # benchmarks/fault_tolerance.py:26-29
    return mod.EngineConfig(mode=mode, num_servers=4, max_batch=4,
                            max_seq=64, tp_batch_cap=2, n_redundant=2,
                            restart_steps=40, tp_restart_steps=10)


def _fig10_scenario(mod, vocab):
    """Poisson traffic; server 0 fails at 0.05 s and recovers at 0.1 s,
    server 1 fails at 0.15 s and recovers at 0.2 s (the benchmark's
    timeline, two failures)."""
    sc = mod.Scenario(horizon=0.25, seed=0, max_new=8, vocab=vocab)
    sc.poisson(80)
    for i in range(2):
        t0 = 0.05 + 0.1 * i
        sc.fail(rank=i, t=t0)
        sc.recover(rank=i, t=t0 + 0.05)
    return sc


@pytest.fixture(scope="module")
def fig10():
    jcfg, tcfg = _cfgs()
    out = {}
    for mode in MODES:
        jeng = J.ServingEngine(jcfg, _fig10_ecfg(J, mode), seed=0,
                               clock=J.VirtualClock())
        params = params_from_numpy(jax.tree.map(np.asarray, jeng.params),
                                   tcfg, "cpu")
        jres = _fig10_scenario(J, jcfg.vocab_size).run(jeng)
        teng = T.ServingEngine(tcfg, _fig10_ecfg(T, mode), params=params,
                               clock=T.VirtualClock(), device="cpu")
        tres = _fig10_scenario(T, tcfg.vocab_size).run(teng)
        out[mode] = (jres, tres)
    return out


@pytest.mark.parametrize("mode", MODES)
def test_fig10_tokens_and_times_match_jax(fig10, mode):
    jres, tres = fig10[mode]
    assert tres.metrics.completed == tres.metrics.total_requests > 8
    assert len(tres.requests) == len(jres.requests)
    for j, t in zip(jres.requests, tres.requests):
        assert t.output_tokens == j.output_tokens
        assert t.token_times == j.token_times
        assert t.finish_time == j.finish_time


@pytest.mark.parametrize("mode", MODES)
def test_fig10_halts_and_fingerprint_match_jax(fig10, mode):
    jres, tres = fig10[mode]
    flags = [x["halted"] for x in tres.metrics.timeline]
    assert flags == [x["halted"] for x in jres.metrics.timeline]
    expect = {"eaas": 0, "monolithic_ep": 2 * 40, "tp": 2 * 10}[mode]
    assert sum(flags) == expect
    assert tres.metrics.fingerprint() == jres.metrics.fingerprint()
    assert tres.metrics.p99_itl == jres.metrics.p99_itl


def test_fig10_eaas_outpaces_the_baselines(fig10):
    """The figure's ordering on the virtual clock: EAAS loses only the dead
    server's share, the baselines stall."""
    thr = {m: fig10[m][1].metrics.decode_throughput for m in MODES}
    assert thr["eaas"] > thr["monolithic_ep"]
    assert thr["eaas"] > thr["tp"]


# -------------------------------------------------------------- batch_cap

@pytest.mark.parametrize("cap", [None, 1, 2, 3])
def test_batch_cap_admission_matches_reference(cap):
    def drive(sched_cls, cfg_cls, req_cls, sp_cls):
        s = sched_cls(cfg_cls(max_batch=4, prefill_chunk=4, batch_cap=cap))
        for i in range(6):
            s.submit(req_cls(i, np.arange(6, dtype=np.int32),
                             sp_cls(max_new_tokens=2)))
        trace = []
        for step in range(12):
            p = s.next_plan()
            trace.append((type(p).__name__,
                          [r.request_id if r else None for r in s.slots]))
            if type(p).__name__ == "PrefillChunk":
                s.prefill_advanced(p.slot, p.length)
            elif step % 3 == 2 and s.decode_ready():
                s.release(s.decode_ready()[0])
        return trace

    got = drive(Scheduler, SchedulerConfig, T.Request, T.SamplingParams)
    want = drive(JScheduler, JSchedulerConfig, J.Request, J.SamplingParams)
    assert got == want
    if cap is not None:
        assert all(ids[cap:] == [None] * (4 - cap) for _, ids in got)


def test_unknown_mode_raises():
    cfg = get_config("deepseek-r1").reduced()
    with pytest.raises(ValueError, match="unknown mode"):
        T.ServingEngine(cfg, T.EngineConfig(mode="dp"), device="cpu")

