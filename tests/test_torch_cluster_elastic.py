"""The port's async cluster and its elasticity against the JAX package:
the shared async tier under faults, client drain and spawn, the
autoscaler's attention-tier controller, and the one shared weight bank
(``tests/test_elasticity.py``, ``tests/test_elastic_edges.py``,
``tests/test_async_engine.py``'s cluster case).

Reduced deepseek-r1 in float32 on the CPU under VirtualClock; the JAX side
runs once (module fixture), the port on its bridged weights:

* four async clients over one tier: a straggler, expert server 1 failing
  with micro-batches queued (re-dispatched) and client 2 failing (its
  micro-batches cancelled, nobody else's);
* two async clients, client 1 drained while its waves are in flight;
* two async clients under the autoscaler (servers and clients) on a
  constant-rate trace: its decision traces, the client trace and the
  resource trace;
* one client through a one-shot rebalance and ``scale_to`` 4 -> 8 -> 2 ->
  4: the weights after each step.

Tokens, fingerprints (``ClusterMetrics`` and every client's
``EventTimeline``), the traces and the weights must be equal — the weights
bitwise, also between a 4-client and a 1-client port cluster: the clients
share one bank, written once per migration chunk and per resize.
"""

import jax
import numpy as np
import pytest
import torch

from repro import serving as J
from repro.configs import get_config as jget_config
from repro.serving.autoscale import Autoscaler as JAutoscaler
from repro.serving.autoscale import AutoscalerConfig as JAutoscalerConfig
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.serving.autoscale import Autoscaler, AutoscalerConfig


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of tiny ops: one intra-op thread spares them a pool's
    spin-waits when test workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get):
    return get("deepseek-r1").reduced().replace(dtype="float32")


def _ecfg(mod, **kw):
    kw.setdefault("mode", "eaas")
    kw.setdefault("num_servers", 4)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 64)
    kw.setdefault("n_redundant", 2)
    # drop-free dispatch: placement never changes which tokens reach experts
    kw.setdefault("pool_tokens_per_client", 16)
    return mod.EngineConfig(**kw)


def _expert_heavy(mod):
    return lambda: mod.VirtualClock(decode_base=2e-4, decode_per_token=2e-3,
                                    expert_share=0.8)


def _cluster(mod, params, n, clock_factory=None, max_clients=None, **ekw):
    ccfg = mod.ClusterConfig(clients=n, max_clients=max_clients,
                             engine=_ecfg(mod, **ekw))
    clock_factory = clock_factory or mod.VirtualClock
    if mod is J:
        return J.Cluster(_cfg(jget_config), ccfg, seed=0,
                         clock_factory=clock_factory)
    cfg = _cfg(get_config)
    return T.Cluster(cfg, ccfg, seed=0, clock_factory=clock_factory,
                     params=params_from_numpy(params, cfg, "cpu"),
                     device="cpu")


def _tokens(reqs):
    return {r.request_id: tuple(r.output_tokens) for r in reqs}


def _requests(mod, vocab, n, max_new=8, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(0, vocab, size=8).astype(np.int32),
                        mod.SamplingParams(max_new_tokens=max_new))
            for i in range(n)]


# ------------------------------------------------------------------ runs

def _faulty_async(mod, params):
    cl = _cluster(mod, params, 4, clock_factory=_expert_heavy(mod),
                  exec_mode="async")
    sc = (mod.Scenario(horizon=0.15, seed=7, max_new=8, vocab=cl.cfg
                       .vocab_size, clients=4).poisson(300)
          .slow_server(3, t=0.02, factor=3.0)
          .fail(1, t=0.06).recover(1, t=0.1)
          .fail_client(i=2, t=0.04))
    return cl, sc.run(cl)


def _drain(mod, params, drain=True):
    cl = _cluster(mod, params, 2, exec_mode="async", async_depth=2)
    reqs = _requests(mod, cl.cfg.vocab_size, 10)
    for r in reqs:
        cl.submit(r)
    state = {"drained": False, "waves": 0}

    def on_step(c):
        # drain client 1 once it has decode waves in flight
        waves = len(c.clients[1]._waves)
        if drain and not state["drained"] and c.step_idx >= 4 and waves:
            state["waves"] = waves
            state["drained"] = c.drain_client(1)
    cl.run(max_steps=4000, on_step=on_step)
    return cl, reqs, state


def _autoscaled(mod, params):
    A, AC = ((JAutoscaler, JAutoscalerConfig) if mod is J
             else (Autoscaler, AutoscalerConfig))
    cl = _cluster(mod, params, 2, max_clients=2, exec_mode="async")
    scaler = A(AC(rate_per_server=30.0, min_servers=1, max_servers=4,
                  window=0.5, cooldown=0.05, rate_per_client=30.0,
                  min_clients=1, max_clients=2))
    sc = (mod.Scenario(horizon=0.8, seed=11, prompt_len=8, max_new=6,
                       vocab=cl.cfg.vocab_size).poisson(rate=20.0)
          .autoscale(scaler))
    res = sc.run(cl, max_steps=20_000)
    return cl, res, scaler


def _bank_trace(mod, params, n=1):
    """Serve a skewed trace, then a one-shot rebalance and scale_to 8, 2
    and 4; the shared bank's MoE server weights after each step."""
    cl = _cluster(mod, params, n)
    sc = (mod.Scenario(horizon=0.06, seed=5, max_new=6,
                       vocab=cl.cfg.vocab_size, clients=n).poisson(150)
          .zipf_skew(1.2, scale=2.0))
    sc.run(cl)
    snaps = []

    def snap():
        sw = cl.clients[0].executor.params["blocks"]["moe"]["servers"]
        snaps.append(({k: np.array(v) for k, v in sw.items()},
                      cl.pool.redundant_table.copy()))
    cl.rebalance()
    snap()
    for size in (8, 2, 4):
        cl.scale_to(size)
        snap()
    return cl, snaps


@pytest.fixture(scope="module")
def runs():
    out = {"params": jax.tree.map(
        np.asarray, _cluster(J, None, 1).clients[0].params)}
    params = out["params"]
    for name, fn in (("faulty", _faulty_async), ("drain", _drain),
                     ("autoscale", _autoscaled), ("bank", _bank_trace)):
        out[name] = {"jax": fn(J, params), "port": fn(T, params)}
    return out


# ------------------------------------------------------------ against JAX

def test_async_cluster_under_faults_matches_reference(runs):
    jcl, jres = runs["faulty"]["jax"]
    tcl, tres = runs["faulty"]["port"]
    assert _tokens(tres.requests) == _tokens(jres.requests)
    assert tcl.metrics.fingerprint() == jcl.metrics.fingerprint()
    assert tcl.metrics.summary() == jcl.metrics.summary()
    assert [c.timeline.fingerprint() for c in tcl.clients] \
        == [c.timeline.fingerprint() for c in jcl.clients]
    assert tcl.metrics.queue_delay_stats(by="server") \
        == jcl.metrics.queue_delay_stats(by="server")
    for k in ("enqueued", "completed", "cancelled", "redispatched"):
        assert getattr(tcl._tier, k) == getattr(jcl._tier, k), k


def test_async_cluster_faults_strand_only_their_client(runs):
    """Server 1's queued micro-batches re-dispatch (no token lost); client
    2's requests and micro-batches are abandoned, nobody else's; every
    completed request's tokens are the lockstep cluster's."""
    tcl, tres = runs["faulty"]["port"]
    m, tier = tcl.metrics, tcl._tier
    assert tier.redispatched > 0 and tier.cancelled > 0
    assert tier.in_flight() == 0
    assert tier.enqueued == tier.completed + tier.cancelled
    assert m.failed_requests > 0
    assert m.completed == m.total_requests - m.failed_requests
    assert all(c.metrics.completed > 0 for i, c in enumerate(tcl.clients)
               if i != 2)
    lock = _cluster(T, runs["params"], 4, clock_factory=_expert_heavy(T))
    lres = (T.Scenario(horizon=0.15, seed=7, max_new=8,
                       vocab=lock.cfg.vocab_size, clients=4).poisson(300)
            .slow_server(3, t=0.02, factor=3.0)
            .fail(1, t=0.06).recover(1, t=0.1)).run(lock)
    done = {r.request_id for r in tres.requests if r.finish_time is not None}
    assert len(done) == m.completed
    want, got = _tokens(lres.requests), _tokens(tres.requests)
    assert {i: got[i] for i in done} == {i: want[i] for i in done}


def test_drain_with_inflight_waves_matches_reference(runs):
    jcl, jreqs, jstate = runs["drain"]["jax"]
    tcl, treqs, tstate = runs["drain"]["port"]
    assert tstate == jstate and tstate["drained"]
    assert tstate["waves"] > 0              # the drain met in-flight waves
    assert _tokens(treqs) == _tokens(jreqs)
    assert tcl.metrics.fingerprint() == jcl.metrics.fingerprint()
    assert tcl.client_parked[1] and tcl.metrics.client_drains == 1
    assert tcl.metrics.failed_requests == 0
    clean, creqs, _ = _drain(T, runs["params"], drain=False)
    assert _tokens(treqs) == _tokens(creqs)
    assert tcl.metrics.completed == clean.metrics.completed == 10
    assert tcl.clock >= tcl.clients[0].clock


def test_autoscaler_traces_match_reference(runs):
    jcl, jres, jscaler = runs["autoscale"]["jax"]
    tcl, tres, tscaler = runs["autoscale"]["port"]
    assert tscaler.trace == jscaler.trace
    assert tscaler.client_trace == jscaler.client_trace
    assert tscaler.page_trace == jscaler.page_trace
    assert tcl.metrics.resource_trace == jcl.metrics.resource_trace
    assert tcl.metrics.fingerprint() == jcl.metrics.fingerprint()
    assert tres.server_trace == jres.server_trace
    assert _tokens(tres.requests) == _tokens(jres.requests)
    # the reference's no-flap pin: the pool size settles, never A-B-A
    sizes = [actual for _, _, _, actual in tscaler.trace]
    compact = [s for i, s in enumerate(sizes)
               if i == 0 or s != sizes[i - 1]]
    assert len(compact) == len(set(compact)) and compact[-1] < 4
    wants = [w for _, w, _ in tscaler.client_trace]
    assert wants and len(set(wants[len(wants) // 2:])) <= 1


def test_shared_bank_matches_reference_after_rebalance_and_resizes(runs):
    """After the rebalance and each resize the port's bank is, bitwise,
    the JAX cluster's weights bridged — but for a replica slot the plan
    left empty, which the port zeroes and the reference leaves holding its
    stale copy (no route reads it either way)."""
    jcl, jsnaps = runs["bank"]["jax"]
    tcl, tsnaps = runs["bank"]["port"]
    assert tcl.metrics.rebalances == jcl.metrics.rebalances == 1
    assert tcl.pool.num_servers == 4
    np.testing.assert_array_equal(tcl.pool.redundant_table,
                                  jcl.pool.redundant_table)
    E = tcl.cfg.moe.num_experts
    for (j, jred), (t, red) in zip(jsnaps, tsnaps):
        np.testing.assert_array_equal(red, jred)
        empty = np.zeros(t["w_gate"].shape[1:3], bool)    # (S, slots)
        S = red.shape[0]
        for s, col in zip(*np.nonzero(red < 0)):
            empty[s, E // S + col] = True
        for k in t:                         # the bridge keeps the layout
            assert t[k].dtype == j[k].dtype
            assert np.array_equal(t[k][:, ~empty], j[k][:, ~empty]), k
            assert not t[k][:, empty].any(), k


def test_four_clients_hold_one_bank_bitwise_a_single_clients(runs):
    """Four clients share one bank: after the same rebalance and resizes
    it is bitwise a 1-client cluster's, and every client reads it."""
    cl4, snaps4 = _bank_trace(T, runs["params"], n=4)
    _, snaps1 = runs["bank"]["port"]
    for (a, red_a), (b, red_b) in zip(snaps4, snaps1):
        np.testing.assert_array_equal(red_a, red_b)
        for k in a:
            assert np.array_equal(a[k], b[k]), k
    assert all(c.params is cl4.params for c in cl4.clients)
    assert all(c.executor.pool.num_servers == 4 for c in cl4.clients)


# ------------------------------------------------------- within the port

def test_spawn_revives_parked_then_builds_new(runs):
    cl = _cluster(T, runs["params"], 2, max_clients=3, exec_mode="async")
    for r in _requests(T, cl.cfg.vocab_size, 6):
        cl.submit(r)
    cl.run(max_steps=4000)
    assert cl.drain_client(1)
    cl.step()                               # an idle drain parks at once
    assert cl.client_parked[1]
    assert not cl.drain_client(0)           # the last active client stays
    assert cl.spawn_client() == 1           # the lowest parked revives
    assert cl.spawn_client() == 2           # a new engine joins the ring
    assert len(cl.clients) == 3 and cl.router.n_clients == 3
    new = cl.clients[2]
    assert new._shared_pool and new.params is cl.params
    assert new.tier is cl._tier
    assert cl.spawn_client() is None        # max_clients
    more = _requests(T, cl.cfg.vocab_size, 6, seed=9)
    for r in more:
        r.request_id += 50
        cl.submit(r)
    cl.run(max_steps=4000)
    assert cl.metrics.failed_requests == 0
    assert cl.metrics.completed == 12 and cl.metrics.routed[2] > 0
    assert cl.scale_clients(1) == 1         # drains the highest indices
    assert cl.metrics.client_spawns == 2


def test_cluster_page_out_evicts_from_the_shared_bank(runs):
    cl = _cluster(T, runs["params"], 2)
    red = cl.pool.redundant_table.copy()
    expert = int(red[red >= 0][0])
    assert cl.page_out_experts([expert]) == [expert]
    E, S = cl.cfg.moe.num_experts, cl.pool.num_servers
    per = E // S
    sw = cl.params["blocks"]["moe"]["servers"]
    for s, j in zip(*np.nonzero(red == expert)):
        for w in sw.values():
            assert not bool(w[:, s, per + j].any())
    assert cl.metrics.expert_page_outs == 1
    assert cl.metrics.resource_trace[-1][1] \
        == pytest.approx(2 + S * (1 - 1 / E))
    cl.metrics.wall_time = 1.0
    assert cl.metrics.resource_seconds_in(0.0, 1.0) >= 0.0
