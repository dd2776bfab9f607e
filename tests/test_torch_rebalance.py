"""Live rebalancing in the port against the JAX package.

The reference's skew scenario (``tests/test_rebalance.py::_skew_scenario``:
Zipf 1.2 router skew, seed 7) on a reduced deepseek-r1 with 16 experts in
float32 under VirtualClock, frozen and with the live RebalanceController:
greedy tokens, ``metrics.fingerprint()``, the controller's events and
counters and the final placement must equal the reference's exactly (host
numpy, integer counts, fp32 greedy tokens: no tolerance).  Inside the port
the rebalanced run's tokens equal the frozen run's bit for bit.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import serving as J
from repro.configs import get_config as jget_config
from repro.core import expert_server as jexpert_server
from repro.core import load_balance as jload_balance
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import expert_server, load_balance


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


NUM_EXPERTS, NUM_SERVERS, MAX_BATCH = 16, 4, 8
CONTROL = ("rebalance_plan", "migrate", "rebalance_commit")


def _cfg(get, num_experts=NUM_EXPERTS):
    cfg = get("deepseek-r1").reduced().replace(dtype="float32")
    return cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               num_experts=num_experts))


def _ecfg(mod, rebalance: bool, **kw):
    return mod.EngineConfig(
        mode="eaas", num_servers=NUM_SERVERS, max_batch=MAX_BATCH,
        max_seq=kw.pop("max_seq", 64), n_redundant=2,
        pool_tokens_per_client=MAX_BATCH * NUM_SERVERS,
        charge_imbalance=True,
        rebalance_interval=0.02 if rebalance else 0.0, **kw)


def _clock(mod):
    return mod.VirtualClock(decode_base=2e-4, decode_per_token=2e-3,
                            expert_share=0.8)


def _skew_scenario(mod, vocab: int):
    return (mod.Scenario(horizon=0.5, seed=7, prompt_len=8, max_new=24,
                         vocab=vocab)
            .poisson(rate=60)
            .zipf_skew(alpha=1.2, scale=1.0))


def _port_engine(params, rebalance: bool, **kw):
    """A port engine on its own copy of the bridged weights (migrations
    write them in place)."""
    cfg = _cfg(get_config)
    return T.ServingEngine(cfg, _ecfg(T, rebalance, **kw),
                           params=params_from_numpy(params, cfg, "cpu"),
                           clock=_clock(T), device="cpu")


def _tokens(res):
    return {r.request_id: tuple(r.output_tokens) for r in res.requests}


@pytest.fixture(scope="module")
def runs():
    jcfg = _cfg(jget_config)
    out, params = {}, None
    for name, reb in (("frozen", False), ("rebalance", True)):
        jeng = J.ServingEngine(jcfg, _ecfg(J, reb), seed=0, clock=_clock(J))
        if params is None:
            params = jax.tree.map(np.asarray, jeng.params)
        jres = _skew_scenario(J, jcfg.vocab_size).run(jeng)
        teng = _port_engine(params, reb)
        tres = _skew_scenario(T, teng.cfg.vocab_size).run(teng)
        out[name] = dict(jeng=jeng, jres=jres, teng=teng, tres=tres)
    out["params"] = params
    return out


@pytest.mark.parametrize("name", ["frozen", "rebalance"])
def test_tokens_and_fingerprint_match_reference(runs, name):
    r = runs[name]
    assert _tokens(r["tres"]) == _tokens(r["jres"])
    assert r["tres"].metrics.fingerprint() == r["jres"].metrics.fingerprint()
    assert r["tres"].metrics.summary() == r["jres"].metrics.summary()
    assert r["tres"].metrics.throughput_curve(0.05) == \
        r["jres"].metrics.throughput_curve(0.05)
    assert int(r["teng"].executor.dropped) == 0
    assert int(r["teng"].executor.miss) == 0


@pytest.mark.parametrize("name", ["frozen", "rebalance"])
def test_control_events_counters_and_placement_match(runs, name):
    r = runs[name]
    tm, jm = r["tres"].metrics, r["jres"].metrics
    pick = lambda m: [e for e in m.events if e["event"] in CONTROL]  # noqa
    assert pick(tm) == pick(jm)
    for field in ("rebalances", "rebalance_noops", "migrated_experts",
                  "migration_time", "expert_imbalance",
                  "peak_expert_imbalance"):
        assert getattr(tm, field) == getattr(jm, field), field
    np.testing.assert_array_equal(r["teng"].pool.smap.table,
                                  r["jeng"].pool.smap.table)
    np.testing.assert_array_equal(r["teng"].pool.redundant_table,
                                  r["jeng"].pool.redundant_table)
    if name == "rebalance":
        assert tm.rebalances >= 1 and tm.migrated_experts > 0
        assert any(e["event"] == "migrate" for e in tm.events)


def test_port_frozen_equals_rebalanced_bitwise(runs):
    """Placement moves where experts run, never what they compute."""
    assert _tokens(runs["frozen"]["tres"]) == \
        _tokens(runs["rebalance"]["tres"])
    assert runs["rebalance"]["tres"].metrics.migrated_experts > 0


def test_migrated_replicas_equal_their_primaries(runs):
    """After the run every redundant slot holds its expert's primary
    weights bit for bit, and every empty slot is zero."""
    eng = runs["rebalance"]["teng"]
    per = NUM_EXPERTS // eng.pool.num_servers
    red = eng.pool.redundant_table
    for w in eng.params["blocks"]["moe"]["servers"].values():
        for s in range(red.shape[0]):
            for j, e in enumerate(red[s]):
                slot = w[:, s, per + j]
                want = (w[:, e // per, e % per] if e >= 0
                        else torch.zeros_like(slot))
                assert torch.equal(slot, want), (s, j, e)


def test_oneshot_rebalance_event_matches_reference(runs):
    """The scripted ``rebalance(t)`` verb: one-shot migration of the
    weights with the mapping, same tokens as the frozen run and the same
    fingerprint as the reference."""
    jcfg = _cfg(jget_config)
    jeng = J.ServingEngine(jcfg, _ecfg(J, False), seed=0, clock=_clock(J))
    jres = _skew_scenario(J, jcfg.vocab_size).rebalance(t=0.15).run(jeng)
    teng = _port_engine(runs["params"], False)
    tres = _skew_scenario(T, teng.cfg.vocab_size).rebalance(t=0.15).run(
        teng)
    assert _tokens(tres) == _tokens(runs["frozen"]["tres"])
    assert tres.metrics.fingerprint() == jres.metrics.fingerprint()
    assert tres.metrics.rebalances == 1 and tres.metrics.migrated_experts > 0


def test_prompt_heavy_trace_triggers_rebalance_via_prefill_feedback(runs):
    """Chunked-prefill steps feed ``expert_load`` into the traffic EMA: a
    prompt-heavy skewed trace rebalances from prompt traffic alone (the
    reference's ``tests/test_rebalance.py`` case, on the port)."""
    def run(feedback: bool):
        eng = _port_engine(runs["params"], True, max_seq=96,
                           prefill_chunk=8, prefill_load_feedback=feedback)
        (T.Scenario(horizon=0.5, seed=7, prompt_len=48, max_new=1,
                    vocab=eng.cfg.vocab_size)
         .poisson(rate=40).zipf_skew(alpha=1.2, scale=1.0)).run(eng)
        return eng

    fed, unfed = run(True), run(False)
    assert fed.metrics.rebalances >= 1
    assert fed.pool.stats.updates > 2 * unfed.pool.stats.updates
    assert fed.metrics.migrated_experts > 0


# ------------------------------------------------------------ weight paths

def test_migrate_slots_matches_rebuilt_layout_and_reference():
    """In-place per-slot migration lands exactly the layout a fresh build
    of the target table gives, and the reference's ``migrate_slots`` on
    the same numpy weights (bitwise)."""
    E, S = 8, 4
    rng = np.random.default_rng(0)
    bank = {k: rng.normal(size=(E, 6, 10)).astype(np.float32)
            for k in ("w_gate", "w_up", "w_down")}
    red_old = np.array([[4, -1], [5, -1], [6, -1], [7, -1]], np.int32)
    red_new = np.array([[6, 5], [4, -1], [7, -1], [-1, -1]], np.int32)
    aligned, updates = load_balance.migration_updates(red_old, red_new)
    per = E // S
    copies = [(s, per + j, new_e) for s, j, _, new_e in updates]
    tbank = {k: torch.from_numpy(v) for k, v in bank.items()}
    sw = expert_server.build_server_weights(tbank, S, red_old)
    # a stacked layer axis, as the engine keeps it
    sw = {k: torch.stack([v, 2 * v]) for k, v in sw.items()}
    ptrs = {k: v.data_ptr() for k, v in sw.items()}
    expert_server.migrate_slots(sw, E, copies)
    want = expert_server.build_server_weights(tbank, S, aligned)
    jsw = jexpert_server.build_server_weights(
        {k: jax.numpy.asarray(v) for k, v in bank.items()}, S, red_old)
    jsw = jexpert_server.migrate_slots(
        {k: jax.numpy.stack([v, 2 * v]) for k, v in jsw.items()}, E, copies)
    for k in sw:
        assert sw[k].data_ptr() == ptrs[k]              # in place
        assert torch.equal(sw[k][0], want[k])
        assert torch.equal(sw[k][1], 2 * want[k])
        np.testing.assert_array_equal(sw[k].numpy(), np.asarray(jsw[k]))


def test_migration_updates_alignment():
    """Experts that stay on a server keep their slot; only real occupant
    changes become updates (equal to the reference's)."""
    old = np.array([[3, 7], [2, -1]], np.int32)
    new = np.array([[7, 3], [2, 5]], np.int32)
    aligned, updates = load_balance.migration_updates(old, new)
    np.testing.assert_array_equal(aligned, [[3, 7], [2, 5]])
    assert updates == [(1, 1, -1, 5)]
    assert load_balance.migration_updates(old, old)[1] == []
    rng = np.random.default_rng(3)
    for _ in range(20):
        a = rng.integers(-1, 16, (4, 3)).astype(np.int32)
        b = rng.integers(-1, 16, (4, 3)).astype(np.int32)
        got = load_balance.migration_updates(a, b)
        want = jload_balance.migration_updates(a, b)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_plan_digest_ignores_replica_column_order():
    mapping = np.array([[0, 2, -1], [1, -1, 3]], np.int32)
    shuffled = np.array([[0, -1, 2], [1, 3, -1]], np.int32)
    other = np.array([[0, 2, -1], [1, -1, 2]], np.int32)
    d = load_balance.plan_digest(mapping, 4)
    assert d == load_balance.plan_digest(shuffled, 4)
    assert d == jload_balance.plan_digest(shuffled, 4)
    assert d != load_balance.plan_digest(other, 4)
    assert d != load_balance.plan_digest(mapping, 5)


# ---------------------------------------------------------- coordination

def _small_engine(rebalance: bool):
    cfg = _cfg(get_config, num_experts=8)
    return T.ServingEngine(cfg, _ecfg(T, rebalance), seed=0,
                           clock=_clock(T), device="cpu")


def test_autoscaler_defers_to_migration_in_flight():
    eng = _small_engine(rebalance=True)
    asc = T.Autoscaler(T.AutoscalerConfig(rate_per_server=1.0,
                                          min_servers=1, max_servers=8,
                                          window=0.1, cooldown=0.01))
    for t in np.linspace(0.9, 1.0, 20):
        asc.observe_arrival(float(t))       # high observed rate: wants 8
    eng.rebalancer._pending = [(0, 0, -1, 4)]
    assert asc.step(eng, t=1.0) is None     # replication first
    eng.rebalancer.abort()
    assert asc.step(eng, t=1.0) == 8        # then server-count scaling
    assert eng.pool.num_servers == 8
    assert eng.params["blocks"]["moe"]["servers"]["w_gate"].shape[1] == 8


def test_scale_to_aborts_staged_migration():
    eng = _small_engine(rebalance=True)
    eng.rebalancer._pending = [(0, 0, -1, 4)]
    eng.scale_to(2)
    assert not eng.rebalancer.migrating
    assert eng.pool.num_servers == 2
    assert eng.last_placement_change == eng.clock


class _Host:
    """The controller's host interface, without an engine: a pool, a
    metrics sink, a clock and live queue signals (an async tier's)."""

    def __init__(self, pool, metrics, signals):
        self.pool, self.metrics, self.clock = pool, metrics, 1.0
        self.last_placement_change = float("-inf")
        self._signals = signals

    def queue_signals(self):
        return self._signals


@pytest.mark.parametrize("backlog", [None, (0.0, 0.0), (0.02, 0.05),
                                     (0.01, 0.04)])
def test_queue_aware_gate_matches_reference(backlog):
    """With a host that reports queue backlog the gate reads the modelled
    queue-delay reduction, without backlog (or signals) the count gate:
    the same decision and event as the reference's controller."""
    from repro.core.elastic import ServerPool as JServerPool
    from repro.serving.metrics import ServingMetrics as JMetrics
    from repro.serving.rebalance import RebalanceController as JController
    from repro_torch.core.elastic import ServerPool

    load = np.ones(NUM_EXPERTS)
    load[3], load[9] = 30.0, 12.0
    sig = None if backlog is None else {
        "alive": NUM_SERVERS, "max_backlog": backlog[0],
        "total_backlog": backlog[1]}
    out = []
    for pool_cls, metrics_cls, ctl_cls in (
            (JServerPool, JMetrics, JController),
            (ServerPool, T.ServingMetrics, T.RebalanceController)):
        pool = pool_cls(_cfg(get_config), NUM_SERVERS, 32, n_redundant=2)
        pool.observe_load(load)
        host = _Host(pool, metrics_cls(), sig)
        ctl = ctl_cls()
        ctl._evaluate(host)
        out.append((host.metrics.events, host.metrics.rebalance_noops,
                    ctl._pending))
    assert out[0] == out[1]
    # a balanced backlog (max == mean) leaves nothing to gain: a no-op
    assert out[1][1] == (backlog == (0.01, 0.04))
