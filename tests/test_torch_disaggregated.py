"""The port's protocol-literal disaggregated tier (``repro_torch.serving
.disaggregated``, ``core.monitor.SharedBuffer``) against the reference's:
the mirrored protocol tests of ``tests/test_disaggregated.py`` and
``tests/test_fault_tolerance.py``, and one drive schedule through both
clusters on the same bank (outputs at 1e-5 in float32, and in bfloat16,
where both servers take their float32 batch against the bf16 weights in a
float32 product; retries, batches and served tokens exactly equal)."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serving.disaggregated import build_cluster as jbuild_cluster
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.monitor import (STATE_CLIENT_WRITE_DONE, STATE_EMPTY,
                                      STATE_OFFLINE, STATE_SERVER_DONE,
                                      Monitor, SharedBuffer)
from repro_torch.serving.disaggregated import build_cluster


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Thousands of tiny ops: one intra-op thread spares them a thread
    pool's spin-waits when test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(dtype="float32", n_servers=3, n_redundant=3, n_clients=2):
    """The reference's cluster and the port's over the same bank and
    router."""
    cfg = jget_config("deepseek-r1").reduced().replace(dtype=dtype)
    tcfg = get_config("deepseek-r1").reduced().replace(dtype=dtype)
    jc = jbuild_cluster(cfg, n_clients=n_clients, n_servers=n_servers,
                        n_redundant=n_redundant)
    bank = {k: tensor_from_numpy(np.asarray(v), "cpu")
            for k, v in jc[3].items()}
    router_w = tensor_from_numpy(np.asarray(jc[0][0].router_w), "cpu")
    tc = build_cluster(tcfg, n_clients, n_servers, n_redundant,
                       device="cpu", bank=bank, router_w=router_w)
    return tcfg, jc, tc


@pytest.fixture(scope="module")
def cluster():
    cfg = get_config("deepseek-r1").reduced()
    return cfg, build_cluster(cfg, n_clients=2, n_servers=3, n_redundant=3,
                              device="cpu")


def _drive(servers):
    def drive():
        for s in servers:
            s.tick()
    return drive


def _x(rng, n, d):
    return (rng.normal(size=(n, d)) * 0.3).astype(np.float32)


# ------------------------------------------ mirrors of test_disaggregated

def test_dynamic_batching_across_clients(cluster):
    """Both clients' slots are ready before the servers' first tick: one
    tick aggregates both clients' rows into one batch per server."""
    cfg, (clients, servers, smap, bank) = cluster
    rng = np.random.default_rng(0)
    x0, x1 = _x(rng, 8, cfg.d_model), _x(rng, 6, cfg.d_model)
    before = [(s.batches, s.served_tokens) for s in servers]
    drive = _drive(servers)
    y1 = []

    def drive0():                     # client 1 sends, then the servers tick
        if not y1:
            y1.append(clients[1].moe_layer(x1, drive))
        else:
            drive()
    y0 = clients[0].moe_layer(x0, drive0)
    assert torch.isfinite(y0).all() and torch.isfinite(y1[0]).all()
    served = [s.served_tokens - b[1] for s, b in zip(servers, before)]
    batches = [s.batches - b[0] for s, b in zip(servers, before)]
    assert sum(served) == (8 + 6) * cfg.moe.top_k
    assert batches == [int(n > 0) for n in served]     # one batch each
    # the same rows one client at a time give the same outputs
    torch.testing.assert_close(y0, clients[0].moe_layer(x0, drive),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(y1[0], clients[1].moe_layer(x1, drive),
                               rtol=1e-5, atol=1e-5)


def test_timeout_failover_transparent(cluster):
    cfg, (clients, servers, smap, bank) = cluster
    rng = np.random.default_rng(1)
    x = _x(rng, 10, cfg.d_model)
    drive = _drive(servers)
    y_ref = clients[0].moe_layer(x, drive)
    servers[0].alive = False                  # silent failure
    before = clients[0].retries
    y_fo = clients[0].moe_layer(x, drive)
    assert clients[0].retries > before        # ②(b) timeout path fired
    torch.testing.assert_close(y_ref, y_fo, rtol=1e-4, atol=1e-4)
    servers[0].alive = True                   # recovery: re-register
    smap.mark_alive(0)
    torch.testing.assert_close(y_ref, clients[0].moe_layer(x, drive),
                               rtol=1e-4, atol=1e-4)


def test_straggler_server_failover_transparent(cluster):
    """A straggler (slow_factor > the client timeout) looks dead to the
    timeout path: its rows re-route to replicas, the output is unchanged.
    Its own cluster: the fixture's mapping was failure-mutated above."""
    cfg, _ = cluster
    clients, servers, smap, bank = build_cluster(
        cfg, n_clients=2, n_servers=3, n_redundant=3, device="cpu")
    rng = np.random.default_rng(2)
    x = _x(rng, 10, cfg.d_model)
    drive = _drive(servers)
    y_ref = clients[1].moe_layer(x, drive)
    servers[0].slow_factor = 50               # straggler: ~never serves
    before = clients[1].retries
    y_slow = clients[1].moe_layer(x, drive)
    assert clients[1].retries > before
    torch.testing.assert_close(y_ref, y_slow, rtol=1e-4, atol=1e-4)
    servers[0].slow_factor = 1                # full speed + re-register
    smap.mark_alive(0)
    torch.testing.assert_close(y_ref, clients[1].moe_layer(x, drive),
                               rtol=1e-4, atol=1e-4)


def test_nonuniform_expert_counts(cluster):
    """EAAS does not require equal experts per server (paper §4.5)."""
    cfg, (clients, servers, smap, bank) = cluster
    counts = [len(s.expert_ids) for s in servers]
    assert len(set(counts)) > 1 or cfg.moe.num_experts % len(servers) == 0
    hosted = set()
    for s in servers:
        hosted.update(s.expert_ids)
    assert hosted == set(range(cfg.moe.num_experts))
    for s in servers:                         # stacked from the one bank
        for i, e in enumerate(s.expert_ids):
            assert torch.equal(s.w_up[i], bank["w_up"][e])


# ------------------------------------- mirrors of test_fault_tolerance:42-91

def test_client_failure_releases_buffer():
    """Paper Fig. 6 ①: the server releases a dead client's buffer slot."""
    mon = Monitor(heartbeat_timeout=1.0)
    buf = SharedBuffer(capacity=4, d_model=8)
    mon.subscribe_client_down(lambda cid: buf.release())
    mon.register("client0", "client", t=0.0)
    buf.write_request(0, np.ones((2, 8)), np.zeros(2, np.int32), np.ones(2))
    assert buf.state == STATE_CLIENT_WRITE_DONE
    mon.tick(3.0)
    assert buf.state == STATE_OFFLINE


def test_shared_buffer_protocol_roundtrip():
    buf = SharedBuffer(capacity=4, d_model=3)
    assert buf.state == STATE_EMPTY
    assert buf.try_read_result() is None
    assert buf.hidden.dtype == torch.float32   # the reference's payload
    h = np.arange(6, dtype=np.float32).reshape(2, 3)
    buf.write_request(layer_id=5, hidden=h,
                      expert_id=np.array([1, 2], np.int32),
                      score=np.array([0.5, 0.5], np.float32))
    assert buf.poll()
    layer_id, hid, eid, sc = buf.take_request()
    assert layer_id == 5
    np.testing.assert_array_equal(hid.numpy(), h)
    assert eid.tolist() == [1, 2] and sc.tolist() == [0.5, 0.5]
    buf.write_result(hid * 2)
    assert buf.state == STATE_SERVER_DONE
    out = buf.try_read_result()
    np.testing.assert_array_equal(out.numpy(), h * 2)
    assert buf.state == STATE_EMPTY          # slot recycled


def test_shared_buffer_rejects_overwrite():
    buf = SharedBuffer(capacity=2, d_model=2)
    buf.write_request(0, np.zeros((1, 2)), np.zeros(1, np.int32),
                      np.zeros(1))
    with pytest.raises(AssertionError):
        buf.write_request(0, np.zeros((1, 2)), np.zeros(1, np.int32),
                          np.zeros(1))


# ---------------------------------------------------- parity with the JAX

def _schedule(clients, servers, smap, d):
    """Healthy layers of both clients, server 0 killed silently, server 0
    a straggler, then re-registered."""
    rng = np.random.default_rng(0)
    x0, x1 = _x(rng, 8, d), _x(rng, 6, d)
    drive = _drive(servers)
    outs = [clients[0].moe_layer(x0, drive), clients[1].moe_layer(x1, drive)]
    servers[0].alive = False
    outs.append(clients[0].moe_layer(x0, drive))
    servers[0].alive = True
    smap.mark_alive(0)
    servers[0].slow_factor = 50
    outs.append(clients[1].moe_layer(x1, drive))
    servers[0].slow_factor = 1
    smap.mark_alive(0)
    outs.append(clients[1].moe_layer(x1, drive))
    return ([np.asarray(o) for o in outs], [c.retries for c in clients],
            [(s.batches, s.served_tokens) for s in servers],
            smap.alive.copy())


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-5)])
def test_matches_jax_cluster(dtype, tol):
    """Same outputs (bf16 weights: the float32 payload against them in a
    float32 product, as the reference's ragged_dot promotes the pair), and
    the protocol's counts exactly."""
    tcfg, (jc, js, jm, _), (tc, ts, tm, _) = _both(dtype)
    jo, jr, jb, ja = _schedule(jc, js, jm, tcfg.d_model)
    to, tr, tb, ta = _schedule(tc, ts, tm, tcfg.d_model)
    assert tr == jr and min(tr) > 0
    assert tb == jb
    np.testing.assert_array_equal(ta, ja)
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t, j, rtol=tol, atol=tol)
    assert [s.expert_ids for s in ts] == [s.expert_ids for s in js]


def test_build_cluster_seeded():
    """Without a bank the cluster draws its own from the seed: the same
    seed gives the same weights and outputs; the bank keeps the config's
    dtype."""
    cfg = get_config("deepseek-r1").reduced()
    a = build_cluster(cfg, 1, 2, 2, device="cpu", seed=3)
    b = build_cluster(cfg, 1, 2, 2, device="cpu", seed=3)
    assert a[3]["w_gate"].dtype == torch.bfloat16
    assert all(torch.equal(a[3][k], b[3][k]) for k in a[3])
    x = _x(np.random.default_rng(4), 5, cfg.d_model)
    assert torch.equal(a[0][0].moe_layer(x, _drive(a[1])),
                       b[0][0].moe_layer(x, _drive(b[1])))


# ------------------------------- an unhosted row in a server's batch

def _serve_batch(server, x, eids, scores):
    """One batch through a server's own buffer protocol (either package):
    a probe client writes it, the server ticks once, the result is read."""
    buf = server.attach_client("probe")
    buf.write_request(0, x, eids, scores)
    server.tick()
    out = buf.try_read_result()
    del server.buffers["probe"]
    return np.asarray(out)


def test_unhosted_row_leaves_hosted_rows_unchanged():
    """A batch holding a row of an expert the server does not host: the
    port's hosted rows equal the same batch's without that row, and the
    row itself is 0.  The reference sorts the unhosted row first but
    hands ragged_dot only the hosted sizes, so its hosted rows meet the
    wrong experts (src/repro/serving/disaggregated.py:106-109,121): they
    move by more than the outputs' own size."""
    tcfg, (_, js, _, _), (_, ts, _, _) = _both(n_servers=4, n_redundant=1)
    hosted = ts[0].expert_ids
    assert hosted == js[0].expert_ids
    other = next(e for e in range(tcfg.moe.num_experts) if e not in hosted)
    rng = np.random.default_rng(5)
    x = _x(rng, 6, tcfg.d_model)
    eids = np.array([hosted[i % len(hosted)] for i in range(6)], np.int32)
    eids[2] = other
    scores = rng.uniform(0.2, 1.0, 6).astype(np.float32)
    keep = np.arange(6) != 2
    outs = {}
    for name, server in (("port", ts[0]), ("reference", js[0])):
        with_row = _serve_batch(server, x, eids, scores)
        without = _serve_batch(server, x[keep], eids[keep], scores[keep])
        outs[name] = (with_row, without)
    with_row, without = outs["port"]
    np.testing.assert_allclose(with_row[keep], without, rtol=1e-6,
                               atol=1e-6)
    assert not with_row[2].any()
    scale = np.abs(without).max()
    jwith, jwithout = outs["reference"]
    np.testing.assert_allclose(jwithout, without, rtol=1e-5, atol=1e-5)
    assert np.abs(jwith[keep] - jwithout).max() > 0.5 * scale


def test_unhosted_fallback_through_the_cluster():
    """1 client, 4 servers, one redundant slot each, server 1 dead: an
    expert that server 1 alone hosted falls back to server 0, which does
    not host it, and its rows share server 0's batch with hosted ones.
    Every token whose experts all have a live server gets the healthy
    run's output in the port; the reference's move."""
    tcfg, (jc, js, jm, _), (tc, ts, tm, _) = _both(
        n_servers=4, n_redundant=1, n_clients=1)
    x = _x(np.random.default_rng(6), 16, tcfg.d_model)
    eids = tc[0]._route(torch.as_tensor(x)).expert_ids.numpy()
    live = set()
    for s in ts:
        if s.rank != 1:
            live.update(s.expert_ids)
    whole = np.all(np.isin(eids, sorted(live)), axis=1)
    assert whole.any() and not whole.all()
    got = {}
    for name, (clients, servers) in (("port", (tc, ts)),
                                     ("reference", (jc, js))):
        healthy = np.asarray(clients[0].moe_layer(x, _drive(servers)))
        servers[1].alive = False
        failed = np.asarray(clients[0].moe_layer(x, _drive(servers)))
        got[name] = (healthy, failed)
    healthy, failed = got["port"]
    np.testing.assert_allclose(failed[whole], healthy[whole], rtol=1e-5,
                               atol=1e-5)
    jhealthy, jfailed = got["reference"]
    np.testing.assert_allclose(jhealthy, healthy, rtol=1e-5, atol=1e-5)
    assert tc[0].retries > 0 and jc[0].retries > 0
    assert (np.abs(jfailed[whole] - jhealthy[whole]).max()
            > 0.1 * np.abs(jhealthy).max())
