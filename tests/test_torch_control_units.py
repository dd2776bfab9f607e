"""Units of the port's control plane against the JAX package: the biased
router, the capacity-weighted replica lookup and the planner's capacity
accounting, the heartbeat monitor, the clocks' control-plane charges and
a straggler's virtual timeline.

Tolerances: replica picks, plans, events, counts and virtual times are
exact; router scores 1e-6 (fp32, the matmul's summation order differs);
expert ids exact.
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as J
from repro.configs import get_config as jget_config
from repro.core import load_balance as jload_balance
from repro.core import mapping as jmapping
from repro.core import router as jrouter
from repro.serving.clock import VirtualClock as JVirtualClock
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import load_balance, mapping, router
from repro_torch.core.monitor import Monitor
from repro_torch.serving.clock import VirtualClock, WallClock
from repro_torch.serving.scenario import zipf_bias


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------- router

@pytest.mark.parametrize("score_fn", ["sigmoid", "softmax"])
def test_route_with_bias_matches_reference(score_fn):
    cfg = dataclasses.replace(get_config("deepseek-r1").reduced().moe,
                              router_score_fn=score_fn)
    rng = np.random.default_rng(0)
    E, d = cfg.num_experts, 32
    w = (rng.normal(size=(d, E)) * 0.02).astype(np.float32)
    x = rng.normal(size=(24, d)).astype(np.float32)
    bias = zipf_bias(E, 1.2, scale=2.0, seed=3)
    got = router.route({"w_router": torch.from_numpy(w)},
                       torch.from_numpy(x), cfg, bias=torch.from_numpy(bias))
    want = jrouter.route({"w_router": jnp.asarray(w)}, jnp.asarray(x), cfg,
                         bias=jnp.asarray(bias))
    np.testing.assert_array_equal(got.expert_ids.numpy(),
                                  np.asarray(want.expert_ids))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores),
                               rtol=1e-6, atol=1e-6)
    # the bias moved the routing, and a zero bias is the unbiased router
    plain = router.route({"w_router": torch.from_numpy(w)},
                         torch.from_numpy(x), cfg)
    assert not torch.equal(plain.expert_ids, got.expert_ids)
    zero = router.route({"w_router": torch.from_numpy(w)},
                        torch.from_numpy(x), cfg,
                        bias=torch.zeros(E, dtype=torch.float32))
    for a, b in zip(zero, plain):
        assert torch.equal(a, b)


# ------------------------------------------------------- weighted lookup

def _lookup_pair(table, alive, eids, salt, caps):
    got = mapping.lookup(torch.from_numpy(table), torch.from_numpy(alive),
                         torch.from_numpy(eids).long(),
                         torch.from_numpy(salt).long(),
                         weights=(None if caps is None
                                  else torch.from_numpy(caps)))
    want = jmapping.lookup(jnp.asarray(table), jnp.asarray(alive),
                           jnp.asarray(eids), jnp.asarray(salt),
                           weights=None if caps is None
                           else jnp.asarray(caps))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("seed", range(6))
def test_weighted_lookup_matches_reference(seed):
    """Random replica tables, dead servers, heterogeneous capacities (and
    the homogeneous ``None``): the same server for every (token, k)."""
    rng = np.random.default_rng(seed)
    E, S, R, Tn, k = 16, 6, 4, 512, 3
    table = np.full((E, 2 * R), -1, np.int32)
    for e in range(E):
        reps = rng.choice(S, size=rng.integers(1, R + 1), replace=False)
        cols = rng.choice(2 * R, size=len(reps), replace=False)
        table[e, cols] = reps
    alive = rng.random(S) > 0.3
    eids = rng.integers(0, E, (Tn, k)).astype(np.int32)
    salt = (np.arange(Tn)[:, None] + np.arange(k)[None, :] +
            seed * 1_000_003).astype(np.int32)
    for caps in (None, rng.choice([0.5, 1.0, 2.0, 4.0], S).astype(
            np.float32)):
        got, want = _lookup_pair(table, alive, eids, salt, caps)
        np.testing.assert_array_equal(got, want)


def test_weighted_lookup_spreads_proportionally():
    """``tests/test_load_balance_edges.py``: a replica set's tokens spread
    in proportion to capacity, a dead replica's share flows to the
    survivors, and ``weights=None`` stays ``salt % count``."""
    table = np.full((1, 4), -1, np.int32)
    table[0, :3] = [0, 1, 2]
    Tn = 4096
    eids = np.zeros((Tn, 1), np.int32)
    salt = np.arange(Tn, dtype=np.int32)[:, None]
    caps = np.array([4.0, 2.0, 1.0, 1.0], np.float32)
    sv, want = _lookup_pair(table, np.ones(4, bool), eids, salt, caps)
    np.testing.assert_array_equal(sv, want)
    counts = np.bincount(sv.ravel(), minlength=4).astype(float)
    assert counts[3] == 0
    np.testing.assert_allclose(counts[:3] / counts[2], [4.0, 2.0, 1.0],
                               rtol=0.02)
    alive = np.array([True, False, True, True])
    sv, want = _lookup_pair(table, alive, eids, salt, caps)
    np.testing.assert_array_equal(sv, want)
    counts = np.bincount(sv.ravel(), minlength=4).astype(float)
    assert counts[1] == 0
    np.testing.assert_allclose(counts[0] / counts[2], 4.0, rtol=0.02)
    sv, _ = _lookup_pair(table, np.ones(4, bool), eids, salt, None)
    np.testing.assert_array_equal(sv.ravel(), table[0, :3][np.arange(Tn) % 3])


@pytest.mark.parametrize("seed", range(4))
def test_capacity_planning_matches_reference(seed):
    """``eplb_plan`` with capacities, ``server_loads``, ``lane_loads`` and
    ``imbalance`` (with liveness) equal the reference's."""
    rng = np.random.default_rng(seed)
    E, S = 16, 4
    load = rng.random(E) * 10
    load[rng.integers(E)] = 60.0
    caps = rng.choice([1.0, 2.0, 4.0], S)
    alive = np.array([True, True, seed % 2 == 0, True])
    for c in (None, caps):
        m, red = load_balance.eplb_plan(load, S, 2, capacities=c)
        jm, jred = jload_balance.eplb_plan(load, S, 2, capacities=c)
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(red, jred)
        for fn in ("server_loads", "lane_loads"):
            np.testing.assert_array_equal(
                getattr(load_balance, fn)(load, m, S, alive, c),
                getattr(jload_balance, fn)(load, m, S, alive, c))
        assert load_balance.imbalance(load, m, S, alive, c) == \
            jload_balance.imbalance(load, m, S, alive, c)


def test_register_drop_and_alive_replica_count():
    smap = mapping.ExpertServerMap(mapping.default_mapping(4, 2, 3), 2)
    smap.register_replica(0, 1)
    np.testing.assert_array_equal(smap.table[0], [0, 1, -1])
    smap.mark_dead(1)
    np.testing.assert_array_equal(smap.alive_replica_count(), [1, 1, 0, 0])
    smap.drop_replica(0, 1)
    np.testing.assert_array_equal(smap.table[0], [0, -1, -1])
    smap.register_replica(0, 1)
    smap.register_replica(0, 1)
    with pytest.raises(ValueError, match="full"):
        smap.register_replica(0, 1)


# ----------------------------------------------------------------- monitor

def test_monitor_detects_timeout_and_notifies():
    mon = Monitor(heartbeat_timeout=2.0)
    downs = []
    mon.subscribe_server_down(downs.append)
    mon.register("srv0", "server", t=0.0, experts=(0, 1), server_rank=0)
    mon.register("srv1", "server", t=0.0, experts=(2, 3), server_rank=1)
    mon.heartbeat("srv0", 1.0)
    mon.heartbeat("srv1", 1.0)
    assert mon.tick(2.5) == []
    mon.heartbeat("srv0", 3.0)            # srv1 goes silent
    assert mon.tick(3.5) == ["srv1"] and downs == [1]
    assert mon.alive_servers() == {0}


def test_monitor_reregistration_recovers():
    mon = Monitor(heartbeat_timeout=1.0)
    ups = []
    mon.subscribe_server_up(lambda w: ups.append(w.server_rank))
    mon.register("srv0", "server", t=0.0, server_rank=0)
    mon.tick(5.0)
    assert mon.alive_servers() == set()
    mon.register("srv0", "server", t=6.0, server_rank=0)
    assert mon.alive_servers() == {0}
    assert ups == [0, 0]
    assert [e.kind for e in mon.events] == ["register", "dead", "register"]


def test_engine_monitor_masks_a_silent_server():
    """The engine's monitor is wired to its pool: a server that misses its
    heartbeat is masked out of the mapping."""
    eng = T.ServingEngine(get_config("deepseek-r1").reduced(),
                          T.EngineConfig(), clock=VirtualClock(),
                          device="cpu")
    for r in range(4):
        eng.monitor.register(f"srv{r}", "server", t=0.0, server_rank=r)
    for r in (0, 1, 3):
        eng.monitor.heartbeat(f"srv{r}", 2.0)
    assert eng.monitor.tick(4.0) == ["srv2"]
    np.testing.assert_array_equal(eng.pool.smap.alive,
                                  [True, True, False, True])


# ------------------------------------------------------------------ clocks

KINDS = ("prefill", "decode", "migrate", "cold_start")


@pytest.mark.parametrize("kw", [
    {}, {"cold_start_base": 3e-3, "migrate_base": 2e-3,
         "migrate_per_expert": 5e-4},
    {"degrade_with_dead": False, "expert_share": 0.8, "overlap_eps": 1e-4}])
def test_virtual_clock_charges_equal_reference(kw):
    """Every kind, ``migrate`` and ``cold_start`` included, and every
    stretch return the reference's value exactly."""
    port, ref = VirtualClock(**kw), JVirtualClock(**kw)
    for kind, tok, S, alive, ov, im, co, st in itertools.product(
            KINDS, (0, 3, 17), (1, 4), (1.0, 0.75), (False, True),
            (1.0, 1.7), (1.0, 2.0), (1.0, 3.0)):
        args = dict(tokens=tok, servers=S, alive_frac=alive, overlap=ov,
                    imbalance=im, contention=co, straggle=st)
        assert port.stop(kind, **args) == ref.stop(kind, **args), \
            (kind, args)
    assert port.idle() == ref.idle()


def test_wall_clock_times_resultless_kinds():
    clk = WallClock()
    for kind in ("migrate", "cold_start"):
        clk.start()
        assert clk.stop(kind, tokens=2) >= 0.0


# --------------------------------------------------------------- straggler

def _slow_scenario(mod, vocab):
    return (mod.Scenario(horizon=0.2, seed=5, max_new=6, vocab=vocab)
            .poisson(rate=80).slow_server(rank=1, t=0.04, factor=3.0)
            .fail(rank=1, t=0.08).slow_server(rank=2, t=0.1, factor=2.0)
            .recover(rank=1, t=0.12).slow_server(rank=2, t=0.15,
                                                 factor=1.0))


def test_slow_server_timeline_matches_reference():
    import jax

    ecfg = dict(mode="eaas", num_servers=4, max_batch=4, max_seq=64,
                n_redundant=2, pool_tokens_per_client=16)
    jcfg = jget_config("deepseek-r1").reduced().replace(dtype="float32")
    jeng = J.ServingEngine(jcfg, J.EngineConfig(**ecfg), seed=0,
                           clock=J.VirtualClock())
    params = jax.tree.map(np.asarray, jeng.params)
    jres = _slow_scenario(J, jcfg.vocab_size).run(jeng)
    tcfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    teng = T.ServingEngine(tcfg, T.EngineConfig(**ecfg),
                           params=params_from_numpy(params, tcfg, "cpu"),
                           clock=T.VirtualClock(), device="cpu")
    tres = _slow_scenario(T, tcfg.vocab_size).run(teng)
    assert tres.metrics.timeline == jres.metrics.timeline
    assert tres.metrics.fingerprint() == jres.metrics.fingerprint()
    slows = [e for e in tres.metrics.events if e["event"] == "slow_server"]
    assert [(e["rank"], e["factor"]) for e in slows] == \
        [(1, 3.0), (2, 2.0), (2, 1.0)]
    np.testing.assert_array_equal(teng.server_speed, [1.0, 3.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="> 0"):
        teng.set_server_speed(0, 0.0)


@pytest.mark.parametrize("alpha,scale,seed,rotation", [
    (1.2, 2.0, 0, 0), (1.2, 1.0, 7, 0), (0.0, 2.0, 3, 0), (1.2, 3.0, 3, 2)])
def test_zipf_bias_equals_reference(alpha, scale, seed, rotation):
    from repro.serving.scenario import zipf_bias as jzipf_bias

    np.testing.assert_array_equal(
        zipf_bias(16, alpha, scale=scale, seed=seed, rotation=rotation),
        jzipf_bias(16, alpha, scale=scale, seed=seed, rotation=rotation))
