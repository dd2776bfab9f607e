"""The port's cluster front-end (N attention clients over one expert tier)
against the JAX package's, on the reference's cluster traces
(``tests/test_cluster.py``).

Reduced deepseek-r1 in float32 on the CPU under VirtualClock; the JAX
clusters run once (module fixture), the port's on the JAX cluster's
bridged weights:

* one seeded Poisson trace at N = 1 (round robin; the port also at N = 4);
* N = 4 under faults: the shared-tier contention charge, a switch to
  ``least_loaded``, expert server 1 failing and recovering, client 0
  failing and recovering;
* N = 4 paged clients under ``session_affinity`` over shared-prefix
  traffic.

Greedy tokens, ``ClusterMetrics.fingerprint()`` (every client's
``ServingMetrics`` fingerprint, the routing and failure record), the
summary, routed counts and merged timeline must be equal.  Inside the
port: N = 1 and N = 4 give the same tokens, a client failure strands only
its in-flight requests (the survivors' tokens are the fault-free run's),
affinity beats round robin's prefix hit rate, and the guard rails and
router units hold.
"""

import jax
import numpy as np
import pytest
import torch

from repro import serving as J
from repro.configs import get_config as jget_config
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of tiny ops: one intra-op thread spares them a pool's
    spin-waits when test workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ecfg(mod, **kw):
    kw.setdefault("mode", "eaas")
    kw.setdefault("num_servers", 4)
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", 64)
    kw.setdefault("n_redundant", 2)
    # drop-free dispatch: routing never changes which tokens reach experts
    kw.setdefault("pool_tokens_per_client", 16)
    return mod.EngineConfig(**kw)


def _ccfg(mod, n, policy="round_robin", charge_contention=False,
          max_client_queue=0, **ekw):
    return mod.ClusterConfig(clients=n, frontend_policy=policy,
                             charge_contention=charge_contention,
                             max_client_queue=max_client_queue,
                             engine=_ecfg(mod, **ekw))


def _trace(mod, vocab, clients, horizon=0.15, rate=100, max_new=6, seed=7):
    return mod.Scenario(horizon=horizon, seed=seed, max_new=max_new,
                        vocab=vocab, clients=clients).poisson(rate)


def _faults(mod, vocab, client_events=True):
    sc = (_trace(mod, vocab, 4, horizon=0.2, rate=250, max_new=10)
          .set_frontend_policy(t=0.05, policy="least_loaded")
          .fail(1, t=0.08).recover(1, t=0.12))
    if client_events:
        sc = sc.fail_client(i=0, t=0.1).recover_client(i=0, t=0.17)
    return sc


def _affinity(mod, vocab):
    return (_trace(mod, vocab, 4, horizon=0.3, rate=120)
            .shared_prefix(n_prefixes=3, prefix_len=16, suffix_len=8))


# name: (cluster shape, kwargs, trace); the JAX package runs all but n4
CASES = {
    "n1": (1, {}, lambda mod, v: _trace(mod, v, 1)),
    "n4": (4, {}, lambda mod, v: _trace(mod, v, 4)),
    "faults": (4, {"charge_contention": True}, _faults),
    "affinity": (4, {"policy": "session_affinity", "kv_mode": "paged",
                     "kv_block_size": 8, "prefill_chunk": 8}, _affinity),
}
REFERENCE = ("n1", "faults", "affinity")


def _tokens(res):
    return {r.request_id: tuple(r.output_tokens) for r in res.requests}


def _port_cluster(params, n, **kw):
    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    return T.Cluster(cfg, _ccfg(T, n, **kw), seed=0,
                     clock_factory=T.VirtualClock,
                     params=params_from_numpy(params, cfg, "cpu"),
                     device="cpu")


@pytest.fixture(scope="module")
def runs():
    jcfg = jget_config("deepseek-r1").reduced().replace(dtype="float32")
    out, params = {}, None
    for name, (n, kw, make) in CASES.items():
        out[name] = {}
        if name in REFERENCE:
            jcl = J.Cluster(jcfg, _ccfg(J, n, **kw), seed=0,
                            clock_factory=J.VirtualClock)
            if params is None:
                params = jax.tree.map(np.asarray, jcl.clients[0].params)
            out[name].update(jcl=jcl, jres=make(J, jcfg.vocab_size).run(jcl))
        tcl = _port_cluster(params, n, **kw)
        out[name].update(tcl=tcl, tres=make(T, jcfg.vocab_size).run(tcl))
    out["params"] = params
    return out


# ------------------------------------------------------------ against JAX

@pytest.mark.parametrize("name", REFERENCE)
def test_cluster_matches_reference(runs, name):
    r = runs[name]
    tm, jm = r["tcl"].metrics, r["jcl"].metrics
    assert _tokens(r["tres"]) == _tokens(r["jres"])
    assert tm.fingerprint() == jm.fingerprint()
    assert tm.summary() == jm.summary()
    assert tm.routed == jm.routed
    assert tm.merged_timeline() == jm.merged_timeline()
    assert tm.throughput_curve(0.02) == jm.throughput_curve(0.02)
    assert tm.resource_trace == jm.resource_trace
    assert tm.resource_seconds == jm.resource_seconds
    assert r["tcl"].step_idx == r["jcl"].step_idx
    assert [int(c.executor.dropped) for c in r["tcl"].clients] \
        == [0] * len(r["tcl"].clients)


# ------------------------------------------------------- within the port

def test_n1_vs_n4_bitwise_token_identity(runs):
    t1, t4 = runs["n1"]["tres"], runs["n4"]["tres"]
    assert _tokens(t1) == _tokens(t4)
    assert t1.metrics.completed == t1.metrics.total_requests > 0
    assert t4.metrics.completed == t4.metrics.total_requests
    assert sum(n > 0 for n in t4.metrics.routed) == 4


def test_client_failure_strands_only_its_inflight(runs):
    """Client 0 dies at t = 0.1: its queued and slotted requests fail, the
    tier and the other clients keep serving (no halted step), and every
    surviving request's tokens are those of the same trace served without
    the client failure by one client."""
    cl, res = runs["faults"]["tcl"], runs["faults"]["tres"]
    m = cl.metrics
    assert m.failed_requests > 0
    assert m.completed == m.total_requests - m.failed_requests
    assert all(not e.get("halted") for c in cl.clients
               for e in c.metrics.timeline)
    ev = [e for e in m.events if e["event"] == "client_fail"]
    assert len(ev) == 1 and ev[0]["stranded"] == m.failed_requests
    assert cl.client_alive[0] and cl.clients[0].metrics.completed > 0
    assert cl.router.name == "least_loaded"
    one = _port_cluster(runs["params"], 1)
    clean = _faults(T, one.cfg.vocab_size, client_events=False).run(one)
    done = {r.request_id for r in res.requests if r.finish_time is not None}
    assert len(done) == m.completed
    want = _tokens(clean)
    assert {i: t for i, t in _tokens(res).items() if i in done} \
        == {i: want[i] for i in done}


def test_contention_charges_time_not_tokens(runs):
    """The shared-tier contention charge stretches the timeline, never the
    tokens (two clients, the reference's trace)."""
    out = []
    for charge in (False, True):
        cl = _port_cluster(runs["params"], 2, charge_contention=charge)
        out.append(_trace(T, cl.cfg.vocab_size, 2).run(cl))
    assert _tokens(out[0]) == _tokens(out[1]) == _tokens(runs["n1"]["tres"])
    assert out[0].metrics.completed == out[0].metrics.total_requests
    assert out[1].metrics.wall_time > out[0].metrics.wall_time


def test_session_affinity_beats_round_robin_prefix_hits(runs):
    aff = runs["affinity"]["tcl"]
    rr = _port_cluster(runs["params"], 4, policy="round_robin",
                       **{k: v for k, v in CASES["affinity"][1].items()
                          if k != "policy"})
    _affinity(T, rr.cfg.vocab_size).run(rr)
    assert aff.metrics.prefix_hit_rate > rr.metrics.prefix_hit_rate
    assert sum(1 for n in aff.metrics.routed if n > 0) <= 3


def test_shared_tier_state(runs):
    """A server failure is one liveness flip every client sees; a client's
    local mask changes only its own runtime; every client's traffic lands
    in the one pool EMA."""
    cl = runs["n4"]["tcl"]
    decode_steps = sum(sum(1 for e in c.metrics.timeline if e["tokens"] > 0)
                       for c in cl.clients)
    assert cl.pool.stats.updates >= decode_steps > 0
    cl.inject_server_failure(1)
    assert all(not bool(c.pool.smap.alive[1]) for c in cl.clients)
    cl.recover_server(1)
    assert all(bool(c.pool.smap.alive[1]) for c in cl.clients)
    view0 = cl.clients[0].pool
    view0.mask_server(2)
    assert not view0.runtime("cpu").alive[2]
    assert cl.clients[1].pool.runtime("cpu").alive[2]
    assert bool(cl.pool.smap.alive[2])
    assert view0.masked_servers == (2,)
    view0.unmask_server(2)
    assert bool(view0.runtime("cpu").alive[2])


def _req(mod, i):
    return mod.Request(i, np.arange(8, dtype=np.int32),
                       mod.SamplingParams(max_new_tokens=4))


def test_backpressure_and_total_client_loss(runs):
    cl = _port_cluster(runs["params"], 2, max_client_queue=2)
    for i in range(12):
        cl.submit(_req(T, i))
    cl._route_ingress()
    assert all(len(c.queue) == 2 for c in cl.clients)
    assert len(cl.ingress) == 8
    cl.run(max_steps=4000)
    assert cl.metrics.completed == 12 and not cl.ingress

    cl = _port_cluster(runs["params"], 2, max_client_queue=1)
    for i in range(8):
        cl.submit(_req(T, i))
    cl._route_ingress()
    assert len(cl.ingress) == 6
    cl.fail_client(0)
    cl.fail_client(1)
    m = cl.metrics
    assert not cl.ingress and m.ingress_failed == 6
    assert m.failed_requests == 8
    assert m.completed == m.total_requests - m.failed_requests == 0
    cl.submit(_req(T, 99))
    assert m.failed_requests == 9 and not cl.ingress
    with pytest.raises(ValueError, match="no client"):
        cl.fail_client(5)


def test_client_event_needs_cluster(runs):
    cfg = runs["n1"]["tcl"].cfg
    eng = T.ServingEngine(cfg, _ecfg(T), clock=T.VirtualClock(),
                          device="cpu")
    with pytest.raises(ValueError, match="Cluster"):
        _trace(T, cfg.vocab_size, 1).fail_client(i=0, t=0.05).run(eng)


def test_member_guard_rails_and_cluster_resize(runs):
    cl = _port_cluster(runs["params"], 2)
    for verb, arg in (("scale_to", 2), ("rebalance", None),
                      ("page_out_experts", [0])):
        with pytest.raises(RuntimeError, match="cluster"):
            getattr(cl.clients[0], verb)(*([] if arg is None else [arg]))
    cl.scale_to(2)
    assert cl.pool.num_servers == 2
    for eng in cl.clients:
        assert eng.pool.num_servers == 2
        assert eng.executor.pool.num_servers == 2
        assert eng.params is cl.params
    with pytest.raises(ValueError, match="at least one client"):
        T.Cluster(cl.cfg, _ccfg(T, 0), device="cpu")
    with pytest.raises(ValueError, match="not disaggregated"):
        T.Cluster(cl.cfg, _ccfg(T, 2, mode="tp"), device="cpu")


# ------------------------------------------------------------ router units

class _Fake:
    def __init__(self, backlog, free):
        self._b, self._f = backlog, free

    def pending_prefill_tokens(self):
        return self._b

    def free_kv_tokens(self):
        return self._f


def _router_trace(mod):
    out = []
    r = mod.RoundRobin(4)
    cands = [(i, None) for i in range(4)]
    out.append([r.pick(None, cands) for _ in range(5)])
    r = mod.RoundRobin(3)
    out.append([r.pick(None, [(0, None), (2, None)]) for _ in range(4)])
    r = mod.LeastLoaded(3)
    out.append(r.pick(None, [(0, _Fake(100, 10)), (1, _Fake(0, 50)),
                             (2, _Fake(0, 50))]))
    out.append(r.pick(None, [(0, _Fake(0, 500)), (1, _Fake(0, 50))]))
    r = mod.SessionAffinity(4, block_size=8)
    rng = np.random.default_rng(0)
    for _ in range(16):
        p = rng.integers(0, 512, 24).astype(np.int32)
        home = r.home(p)
        out.append((home, r.pick(mod.Request(0, p),
                                 [(i, None) for i in range(4)
                                  if i != home])))
    with pytest.raises(ValueError, match="unknown frontend policy"):
        mod.make_frontend_router("hash_ring", 4)
    out.append([mod.make_frontend_router(p, 3, block_size=8).name
                for p in mod.FRONTEND_POLICIES])
    return out


def test_routers_match_reference():
    from repro.serving import frontend as jfrontend
    import repro_torch.serving.frontend as tfrontend

    class Mod:
        pass
    mods = []
    for fe, serving in ((jfrontend, J), (tfrontend, T)):
        m = Mod()
        for k in ("RoundRobin", "LeastLoaded", "SessionAffinity",
                  "make_frontend_router", "FRONTEND_POLICIES"):
            setattr(m, k, getattr(fe, k))
        m.Request = serving.Request
        mods.append(m)
    assert _router_trace(mods[0]) == _router_trace(mods[1])
    assert _router_trace(mods[1])[:2] == [[0, 1, 2, 3, 0], [0, 2, 0, 2]]
