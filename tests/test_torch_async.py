"""The port's async engine (``exec_mode="async"``) against the JAX package
and against its own lockstep engine.

Reduced deepseek-r1 in float32 on the CPU under VirtualClock, on the
reference's own traces and seeds (``tests/test_async_engine.py``): the
bursty, diurnal and straggler traces and a server failing mid-drain run
through the JAX async engine once (module fixture) and through the port's
on the bridged weights.  Greedy tokens, ``ServingMetrics.fingerprint()``
(queue delays and their lanes included), ``EventTimeline.fingerprint()``
and the tier's counters must be equal — no tolerance: the values are fp32
greedy tokens, the times the reference's float64 host arithmetic.  Inside
the port, async tokens equal lockstep's at every depth, on the EOS and
``max_new_tokens=1`` edges, under live rebalancing and per-expert lanes.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import serving as J
from repro.configs import get_config as jget_config
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import expert_server

NUM_SERVERS, MAX_BATCH = 4, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of tiny ops: one intra-op thread spares them a pool's
    spin-waits when test workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get, num_experts=None):
    cfg = get("deepseek-r1").reduced().replace(dtype="float32")
    if num_experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                  num_experts=num_experts))
    return cfg


def _ecfg(mod, **kw):
    kw.setdefault("mode", "eaas")
    kw.setdefault("num_servers", NUM_SERVERS)
    kw.setdefault("max_batch", MAX_BATCH)
    kw.setdefault("max_seq", 64)
    kw.setdefault("n_redundant", 2)
    # drop-free dispatch: placement and routing never change which tokens
    # reach their experts
    kw.setdefault("pool_tokens_per_client", 16)
    return mod.EngineConfig(**kw)


def _expert_heavy(mod):
    """The reference's straggler cost model (expert share 0.8)."""
    return mod.VirtualClock(decode_base=2e-4, decode_per_token=2e-3,
                            expert_share=0.8)


def _bursty(mod, vocab):
    return (mod.Scenario(horizon=0.06, seed=11, prompt_len=8, max_new=12,
                         vocab=vocab)
            .bursty(base=50, peak=600, period=0.03, duty=0.3))


def _diurnal(mod, vocab):
    return (mod.Scenario(horizon=0.15, seed=3, prompt_len=8, max_new=8,
                         vocab=vocab)
            .diurnal(mean=150, amplitude=0.8, period=0.1))


def _straggler(mod, vocab):
    return (mod.Scenario(horizon=0.2, seed=7, prompt_len=8, max_new=6,
                         vocab=vocab)
            .poisson(rate=100)
            .slow_server(1, t=0.01, factor=6.0))


def _fail_mid_drain(mod, vocab):
    return (mod.Scenario(horizon=0.15, seed=17, prompt_len=8, max_new=8,
                         vocab=vocab)
            .poisson(rate=120)
            .fail(0, t=0.04).recover(0, t=0.1))


TRACES = {"bursty": (_bursty, None), "diurnal": (_diurnal, None),
          "straggler": (_straggler, _expert_heavy),
          "fail_mid_drain": (_fail_mid_drain, None)}


def _tokens(res):
    return {r.request_id: tuple(r.output_tokens) for r in res.requests}


def _port_engine(params, exec_mode, clock=None, **kw):
    cfg = _cfg(get_config)
    return T.ServingEngine(cfg, _ecfg(T, exec_mode=exec_mode, **kw),
                           params=params_from_numpy(params, cfg, "cpu"),
                           clock=clock or T.VirtualClock(), device="cpu")


def _port_run(params, name, exec_mode, **kw):
    make, clk = TRACES[name]
    eng = _port_engine(params, exec_mode, clock=clk(T) if clk else None,
                       **kw)
    return eng, make(T, eng.cfg.vocab_size).run(eng)


@pytest.fixture(scope="module")
def runs():
    """The JAX async engine on every trace (once), the port's async and
    lockstep engines on the same weights."""
    jcfg = _cfg(jget_config)
    out, params = {}, None
    for name, (make, clk) in TRACES.items():
        jeng = J.ServingEngine(jcfg, _ecfg(J, exec_mode="async"), seed=0,
                               clock=clk(J) if clk else J.VirtualClock())
        if params is None:
            params = jax.tree.map(np.asarray, jeng.params)
        jres = make(J, jcfg.vocab_size).run(jeng)
        out[name] = {"jax": (jeng, jres),
                     "async": _port_run(params, name, "async"),
                     "lockstep": _port_run(params, name, "lockstep")}
    out["params"] = params
    return out


# --------------------------------------------------------- against JAX

@pytest.mark.parametrize("trace", sorted(TRACES))
def test_async_matches_reference(runs, trace):
    jeng, jres = runs[trace]["jax"]
    teng, tres = runs[trace]["async"]
    assert _tokens(tres) == _tokens(jres)
    assert tres.metrics.fingerprint() == jres.metrics.fingerprint()
    assert teng.timeline.fingerprint() == jeng.timeline.fingerprint()
    assert tres.metrics.summary() == jres.metrics.summary()
    assert tres.metrics.queue_delay_stats(by="lane") \
        == jres.metrics.queue_delay_stats(by="lane")
    for k in ("enqueued", "completed", "cancelled", "redispatched"):
        assert getattr(teng.tier, k) == getattr(jeng.tier, k), k
    assert teng.clock == jeng.clock
    assert int(teng.executor.dropped) == 0


def test_fail_mid_drain_redispatches_without_token_loss(runs):
    """Server 0 dies with micro-batches queued on it: they move to
    surviving replicas, every request completes, the tokens are
    lockstep's and the tier balances."""
    teng, tres = runs["fail_mid_drain"]["async"]
    _, lres = runs["fail_mid_drain"]["lockstep"]
    assert _tokens(tres) == _tokens(lres)
    assert tres.metrics.completed == tres.metrics.total_requests > 0
    assert teng.tier.redispatched > 0
    assert teng.tier.in_flight() == 0
    assert teng.tier.enqueued == teng.tier.completed + teng.tier.cancelled
    assert any(e["event"] == "redispatch" for e in tres.metrics.events)


# ------------------------------------------------------- within the port

@pytest.mark.parametrize("trace", sorted(TRACES))
def test_async_tokens_equal_lockstep(runs, trace):
    _, tres = runs[trace]["async"]
    _, lres = runs[trace]["lockstep"]
    assert _tokens(tres) == _tokens(lres)
    assert lres.metrics.completed == lres.metrics.total_requests > 0
    assert tres.metrics.completed == tres.metrics.total_requests


def test_async_throughput_and_straggler_tail(runs):
    """Wave pipelining drains the bursty trace no slower than lockstep,
    and with server 1 six times slow async's p99 ITL beats lockstep's
    (only that server's micro-batches queue)."""
    eng_l, _ = runs["bursty"]["lockstep"]
    eng_a, _ = runs["bursty"]["async"]
    assert eng_a.metrics.total_output_tokens \
        == eng_l.metrics.total_output_tokens
    assert eng_a.metrics.total_output_tokens / eng_a.clock \
        >= eng_l.metrics.total_output_tokens / eng_l.clock
    eng_l, _ = runs["straggler"]["lockstep"]
    eng_a, _ = runs["straggler"]["async"]
    assert eng_a.metrics.p99_itl < eng_l.metrics.p99_itl
    assert max(eng_a.metrics.queue_delays) > 0.0


def test_same_seed_same_fingerprints_and_lockstep_has_no_tier(runs):
    eng_a, res_a = runs["straggler"]["async"]
    eng_b, res_b = _port_run(runs["params"], "straggler", "async")
    assert _tokens(res_a) == _tokens(res_b)
    assert res_a.metrics.fingerprint() == res_b.metrics.fingerprint()
    assert eng_a.timeline.fingerprint() == eng_b.timeline.fingerprint()
    assert eng_a.timeline.log
    eng_l, _ = runs["straggler"]["lockstep"]
    assert eng_l.metrics.queue_delays == [] and eng_l.timeline.log == []
    assert eng_l.tier is None and eng_l.queue_signals() is None


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_depth_k_token_identity(runs, depth):
    """Depth-K pipelining changes when work is dispatched, never which
    tokens it computes; depth 1 keeps lockstep's cadence within 1 %."""
    eng_l, lres = runs["bursty"]["lockstep"]
    jeng, jres = runs["bursty"]["jax"]
    eng, res = _port_run(runs["params"], "bursty", "async",
                         async_depth=depth)
    assert _tokens(res) == _tokens(lres) == _tokens(jres)
    assert res.metrics.completed == res.metrics.total_requests > 0
    if depth == 1:
        assert abs(eng.clock - eng_l.clock) <= 0.01 * eng_l.clock
    if depth == 2:
        assert eng.timeline.fingerprint() == jeng.timeline.fingerprint()


def test_max_new_tokens_1_and_prefill_sampled_eos(runs):
    """The pend-empty edge: a prefill-sampled token that already meets the
    done condition (max_new_tokens=1, or EOS at prefill) still decodes
    once, as in lockstep, and everything drains."""
    params = runs["params"]

    def pair(make, **kw):
        out = []
        for mode in ("lockstep", "async"):
            eng = _port_engine(params, mode, **kw)
            out.append(make(T, eng.cfg.vocab_size).run(eng))
        return out

    res_l, res_a = pair(lambda mod, v: mod.Scenario(
        horizon=0.06, seed=21, prompt_len=8, max_new=1, vocab=v)
        .poisson(rate=100))
    assert res_l.metrics.completed == res_l.metrics.total_requests > 0
    assert res_a.metrics.completed == res_a.metrics.total_requests
    assert _tokens(res_l) == _tokens(res_a)

    def eos_trace(mod, v):
        return (mod.Scenario(horizon=0.05, seed=23, prompt_len=8,
                             max_new=6, vocab=v).poisson(rate=80))
    probe = pair(eos_trace)[0]
    eos = int(min(probe.requests,
                  key=lambda r: r.request_id).output_tokens[0])
    res_l, res_a = pair(eos_trace, eos_token=eos)
    assert any(r.output_tokens and r.output_tokens[0] == eos
               for r in res_l.requests)
    assert res_a.metrics.completed == res_a.metrics.total_requests > 0
    assert _tokens(res_l) == _tokens(res_a)


def test_lanes_and_queue_aware_rebalance(runs):
    """16 experts under Zipf skew with a straggler: per-expert lanes
    (budget 2) against the aggregate per-server FIFO — equal tokens, lanes
    no slower, the per-server breakdown partitions the delays; then the
    live controller under async, queue-aware: tokens still lockstep's,
    migration chunks occupy the tier, the plan events carry the modelled
    delay, and the migrated weights are a fresh reshard of the committed
    placement."""
    cfg = _cfg(get_config, 16)
    seeded = T.ServingEngine(cfg, _ecfg(T), seed=0, clock=T.VirtualClock(),
                             device="cpu").params

    def engine(mode, **kw):
        # each engine its own copy: migrations write the weights in place
        params = jax.tree.map(lambda t: t.clone(), seeded)
        return T.ServingEngine(cfg, _ecfg(T, exec_mode=mode, max_batch=8,
                                          pool_tokens_per_client=32,
                                          charge_imbalance=True, **kw),
                               params=params, clock=_expert_heavy(T),
                               device="cpu")

    def lanes(queue_mode):
        eng = engine("async", queue_mode=queue_mode, lane_budget=2)
        res = (T.Scenario(horizon=0.3, seed=19, prompt_len=8, max_new=16,
                          vocab=cfg.vocab_size)
               .poisson(rate=80).zipf_skew(alpha=1.2, scale=0.5)
               .slow_server(3, t=0.015, factor=6.0)).run(eng)
        return eng, res

    eng_s, res_s = lanes("server")
    eng_e, res_e = lanes("expert")
    assert _tokens(res_s) == _tokens(res_e)
    assert res_e.metrics.completed == res_e.metrics.total_requests > 0
    assert max(len(q.lanes) for q in eng_e.tier.queues) >= 3
    assert eng_e.metrics.total_output_tokens / eng_e.clock \
        >= eng_s.metrics.total_output_tokens / eng_s.clock
    groups = eng_e.metrics._queue_groups("server")
    assert sum(len(v) for v in groups.values()) \
        == len(eng_e.metrics.queue_delays)

    def skew(mode):
        eng = engine(mode, rebalance_interval=0.02)
        res = (T.Scenario(horizon=0.5, seed=7, prompt_len=8, max_new=24,
                          vocab=cfg.vocab_size)
               .poisson(rate=60).zipf_skew(alpha=1.2, scale=1.0)).run(eng)
        return eng, res

    eng_l, res_l = skew("lockstep")
    eng_a, res_a = skew("async")
    assert _tokens(res_l) == _tokens(res_a)
    assert eng_a.metrics.rebalances >= 1 and eng_a.metrics.migrated_experts
    assert eng_a.tier.migration_busy > 0.0
    plans = [e for e in res_a.metrics.events
             if e["event"] == "rebalance_plan"]
    assert plans and all("queue_delay" in e for e in plans)
    assert all("queue_delay" not in e for e in res_l.metrics.events)
    E = cfg.moe.num_experts
    sw = eng_a.params["blocks"]["moe"]["servers"]
    want = {k: v.clone() for k, v in sw.items()}
    expert_server.reshard_server_weights(want, E, eng_a.pool.num_servers,
                                         eng_a.pool.redundant_table)
    for k in sw:
        assert torch.equal(sw[k], want[k]), k


def test_prefill_completion_tied_with_an_earlier_event(runs):
    """A divergence from the reference (ROADMAP Queue 3): when another
    event at the same instant fires before a prefill chunk's completion,
    the reference's client is free again with the completion pending,
    re-plans the same chunk and fails on its second completion
    (``KeyError`` in ``prefill_advanced``).  The port lets the pending
    completion fire instead: it serves the request as lockstep does."""
    t_done = T.VirtualClock().stop("prefill", tokens=8, servers=NUM_SERVERS)

    def run(mod, eng):
        req = mod.Request(0, np.arange(8, dtype=np.int32),
                          mod.SamplingParams(max_new_tokens=4))
        eng.submit(req)
        eng.timeline.post(t_done, "wave_done", wave=-1)   # the tie
        eng.run(max_steps=200)
        return req

    jeng = J.ServingEngine(_cfg(jget_config), _ecfg(J, exec_mode="async"),
                           seed=0, clock=J.VirtualClock())
    with pytest.raises(KeyError):
        run(J, jeng)
    got = run(T, _port_engine(runs["params"], "async"))
    want = run(T, _port_engine(runs["params"], "lockstep"))
    assert len(got.output_tokens) == 4
    assert got.output_tokens == want.output_tokens
    assert got.prefill_time == t_done


def test_async_validation():
    """The reference's validation (test_async_depth_validation and the
    exec_mode preconditions)."""
    cfg = _cfg(get_config)

    def build(clock=None, **kw):
        return T.ServingEngine(cfg, _ecfg(T, **kw),
                               clock=clock or T.VirtualClock(),
                               device="cpu")
    for kw in ({"async_depth": 0}, {"async_depth": 1.5},
               {"queue_mode": "bogus"}, {"lane_budget": 0},
               {"mode": "tp"}, {"kv_mode": "paged"},
               {"decode_mode": "pipelined"}):
        with pytest.raises(ValueError):
            build(exec_mode="async", **kw)
    with pytest.raises(ValueError, match="VirtualClock"):
        build(clock=T.WallClock(), exec_mode="async")
    with pytest.raises(ValueError, match="exec_mode"):
        build(exec_mode="eager")
