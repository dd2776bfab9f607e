"""Elastic scaling and scale-to-zero in the port against the JAX package.

Reduced deepseek-r1 (8 experts) in float32 under VirtualClock, drop-free
dispatch (``pool_tokens_per_client=16``): a scenario that resizes the pool
4 -> 8 -> 2, and expert page-out with a cold-start charge, give the same
greedy tokens, ``metrics.fingerprint()`` and pool trace in both packages
(exact).  The per-tensor reshard equals the reference's bitwise; with
``cold_start_base=0`` page-out changes neither tokens nor timeline.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as J
from repro.configs import get_config as jget_config
from repro.core import elastic as jelastic
from repro.core import expert_server as jexpert_server
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import elastic, expert_server
from repro_torch.core.elastic import ServerPool


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ENGINE = dict(mode="eaas", num_servers=4, max_batch=4, max_seq=64,
              n_redundant=2, pool_tokens_per_client=16)


@pytest.fixture(scope="module")
def cfgs():
    return (jget_config("deepseek-r1").reduced().replace(dtype="float32"),
            get_config("deepseek-r1").reduced().replace(dtype="float32"))


@pytest.fixture(scope="module")
def jax_params(cfgs):
    eng = J.ServingEngine(cfgs[0], J.EngineConfig(**ENGINE), seed=0,
                          clock=J.VirtualClock())
    return jax.tree.map(np.asarray, eng.params)


def _port(cfgs, params, clock=None):
    tcfg = cfgs[1]
    return T.ServingEngine(tcfg, T.EngineConfig(**ENGINE),
                           params=params_from_numpy(params, tcfg, "cpu"),
                           clock=clock or T.VirtualClock(), device="cpu")


def _tokens(reqs):
    return {r.request_id: tuple(r.output_tokens) for r in reqs}


# ------------------------------------------------------------- scale_to

def _scale_scenario(mod, vocab):
    return (mod.Scenario(horizon=0.3, seed=0, max_new=4, vocab=vocab)
            .poisson(rate=100).scale_to(n=8, t=0.1).scale_to(n=2, t=0.2))


def test_scale_scenario_matches_reference(cfgs, jax_params):
    jeng = J.ServingEngine(cfgs[0], J.EngineConfig(**ENGINE), seed=0,
                           clock=J.VirtualClock())
    jres = _scale_scenario(J, cfgs[0].vocab_size).run(jeng)
    teng = _port(cfgs, jax_params)
    tres = _scale_scenario(T, cfgs[1].vocab_size).run(teng)
    assert _tokens(tres.requests) == _tokens(jres.requests)
    assert tres.metrics.fingerprint() == jres.metrics.fingerprint()
    assert tres.server_trace == jres.server_trace
    assert [n for _, n in tres.server_trace][-1] == 2
    assert {4, 8, 2} <= {n for _, n in tres.server_trace}
    tos = [e["to"] for e in tres.metrics.events if e["event"] == "scale"]
    assert tos == [8, 2]
    assert tres.metrics.completed == tres.metrics.total_requests > 0
    assert int(teng.executor.dropped) == 0 and int(teng.executor.miss) == 0
    np.testing.assert_array_equal(teng.pool.redundant_table,
                                  jeng.pool.redundant_table)
    # the resharded weights are the reference's, bit for bit
    for k, w in teng.params["blocks"]["moe"]["servers"].items():
        np.testing.assert_array_equal(
            w.numpy(), np.asarray(jeng.params["blocks"]["moe"]["servers"][k]))


def test_reshard_equals_reference_and_roundtrips(cfgs, jax_params):
    """``reshard_server_weights`` on bridged weights (a stacked layer axis,
    redundant slots filled and empty) equals the reference's output
    bitwise, and ``extract_bank`` recovers the bank from every layout."""
    E = cfgs[1].moe.num_experts
    jsw = jax_params["blocks"]["moe"]["servers"]
    bank = jexpert_server.extract_bank(jsw, E)
    for n, red in ((8, np.array([[1, -1], [3, 0], [5, 2], [7, -1],
                                 [0, 4], [6, -1], [2, 3], [-1, -1]],
                                np.int32)),
                   (2, np.array([[6, -1], [0, 3]], np.int32)),
                   (1, np.array([[5]], np.int32))):
        tsw = params_from_numpy(jax_params, cfgs[1], "cpu")["blocks"]["moe"][
            "servers"]
        got = expert_server.reshard_server_weights(tsw, E, n, red)
        assert got is tsw                                # entries replaced
        want = jexpert_server.reshard_server_weights(jsw, E, n, red)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            np.testing.assert_array_equal(
                expert_server.extract_bank(got, E)[k].numpy(),
                np.asarray(bank[k]))


def test_pool_liveness_survives_rebalance_and_scale(cfgs):
    """``tests/test_elastic_edges.py`` on the port's pool."""
    cfg = cfgs[1]
    pool = ServerPool(cfg, num_servers=4, tokens_per_client=8,
                      n_redundant=2)
    pool.server_failed(2)
    load = np.ones(cfg.moe.num_experts)
    load[0] = 50.0
    pool.observe_load(load)
    assert pool.rebalance() is True
    assert not pool.smap.alive[2] and pool.smap.alive[[0, 1, 3]].all()
    assert (pool.smap.table[0] >= 0).sum() >= 2        # the hot replicas
    assert pool.rebalance() is False                   # identical plan

    pool = ServerPool(cfg, num_servers=4, tokens_per_client=8,
                      n_redundant=1)
    pool.server_failed(1)
    pool.scale_to(8)
    assert pool.num_servers == 8 and not pool.smap.alive[1]
    assert pool.smap.alive[[0, 2, 3, 4, 5, 6, 7]].all()
    pool.scale_to(2)
    assert pool.smap.alive[0] and not pool.smap.alive[1]
    with pytest.raises(ValueError, match="feasible"):
        pool.scale_to(3)
    assert pool.feasible_counts() == [1, 2, 4, 8]
    # every mapped replica hosts its expert after a resize (miss == 0)
    pool.observe_load(np.arange(cfg.moe.num_experts, dtype=float) + 1)
    pool.scale_to(4)
    local = expert_server.make_local_table(cfg.moe.num_experts, 4,
                                           pool.redundant_table)
    for e in range(cfg.moe.num_experts):
        for s in pool.smap.table[e][pool.smap.table[e] >= 0]:
            assert local[s, e] >= 0, (e, s)


# ---------------------------------------------------------- scale-to-zero

def _requests(mod, cfg, n=8, max_new=6, seed=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(0, cfg.vocab_size, size=8).astype(
        np.int32), mod.SamplingParams(max_new_tokens=max_new))
        for i in range(n)]


def _page_run(mod, eng, cfg, page: bool):
    reqs = _requests(mod, cfg)
    for r in reqs:
        eng.submit(r)

    def on_step(e):
        if page and e.step_idx == 6:
            e.page_out_experts(list(range(cfg.moe.num_experts)))
    eng.run(max_steps=4000, on_step=on_step)
    return reqs


def test_page_out_with_cold_start_matches_reference(cfgs, jax_params):
    jeng = J.ServingEngine(cfgs[0], J.EngineConfig(**ENGINE), seed=0,
                           clock=J.VirtualClock(cold_start_base=5e-3))
    jreqs = _page_run(J, jeng, cfgs[0], True)
    teng = _port(cfgs, jax_params, T.VirtualClock(cold_start_base=5e-3))
    treqs = _page_run(T, teng, cfgs[1], True)
    assert _tokens(treqs) == _tokens(jreqs)
    assert teng.metrics.fingerprint() == jeng.metrics.fingerprint()
    assert teng.metrics.expert_page_outs == jeng.metrics.expert_page_outs > 0
    assert teng.metrics.cold_starts == jeng.metrics.cold_starts > 0
    assert teng.metrics.cold_start_time > 0.0
    assert teng.metrics.summary()["elastic"] == \
        jeng.metrics.summary()["elastic"]
    assert teng.pool.cold == jeng.pool.cold
    # evicted replica slots are zero in the weights
    per = cfgs[1].moe.num_experts // 4
    for w in teng.params["blocks"]["moe"]["servers"].values():
        for s, j in zip(*np.nonzero(teng.pool.redundant_table < 0)):
            assert not w[:, s, per + j].any()


def test_cold_start_free_elastic_equals_static(cfgs, jax_params):
    """With ``cold_start_base=0`` paging is resource policy only: tokens
    and the step timeline equal the static run's."""
    static = _port(cfgs, jax_params)
    s_reqs = _page_run(T, static, cfgs[1], False)
    paged = _port(cfgs, jax_params)
    p_reqs = _page_run(T, paged, cfgs[1], True)
    assert _tokens(p_reqs) == _tokens(s_reqs)
    assert paged.metrics.timeline == static.metrics.timeline
    assert paged.metrics.expert_page_outs > 0
    assert paged.metrics.cold_starts > 0
    assert paged.metrics.cold_start_time == 0.0


def test_page_out_masks_replicas_keeps_primary(cfgs):
    pool = ServerPool(cfgs[1], num_servers=4, tokens_per_client=16,
                      n_redundant=2)
    E = cfgs[1].moe.num_experts
    paged, updates = pool.page_out_experts([0, 1])
    assert paged == [0, 1] and pool.cold == {0, 1}
    assert all(e == -1 for _, _, e in updates)
    assert pool.resident_fraction() == (E - 2) / E
    assert not np.isin(pool.redundant_table, [0, 1]).any()
    for e in (0, 1):
        assert (pool.smap.table[e] >= 0).sum() == 1
    _, red = pool.plan()
    assert not np.isin(red, [0, 1]).any()
    assert pool.page_in_expert(0, 0.5) and pool.page_in_t[0] == 0.5
    pool.scale_to(2)
    assert pool.cold == set() and pool.resident_fraction() == 1.0


# -------------------------------------------------------------- provision

@pytest.mark.parametrize("rate,per,gran", [
    (0.0, 10.0, 1), (-5.0, 10.0, 1), (0.1, 10.0, 1), (10.1, 10.0, 1),
    (0.5, 0.0, 1), (5.0, 1.0, 4), (8.0, 1.0, 4), (8192, 128.0, 1),
    (5120, 128.0, 1), (5120, 128.0, 64)])
def test_provision_equals_reference(rate, per, gran):
    assert elastic.provision(rate, per, gran) == \
        jelastic.provision(rate, per, gran)


@pytest.mark.parametrize("rate,per,group", [
    (0.0, 10.0, 8), (5120, 8192 / 64, 64), (9.0, 10.0, 4), (32.0, 1.0, 4)])
def test_resource_saving_equals_reference(rate, per, group):
    assert elastic.resource_saving(rate, per, group) == \
        jelastic.resource_saving(rate, per, group)


def test_resource_saving_paper_case():
    """The paper's headline: traffic 8192 -> 5120 saves 37.5 %."""
    rate = 8192 / 64
    assert elastic.provision(8192, rate, 1) == 64
    assert elastic.provision(5120, rate, 1) == 40
    assert elastic.provision(5120, rate, 64) == 64
    assert abs(elastic.resource_saving(5120, rate, 64) - 0.375) < 1e-9


def test_reshard_keeps_dtype_and_device_bf16():
    """A bf16 stack (the full-width dtype) reshards bitwise too."""
    rng = np.random.default_rng(1)
    E = 8
    bank = {k: torch.from_numpy(rng.normal(size=(E, 4, 6)).astype(
        np.float32)).to(torch.bfloat16)
        for k in ("w_gate", "w_up", "w_down")}
    red4 = np.array([[1], [3], [5], [7]], np.int32)
    sw = {k: torch.stack([v, v]) for k, v in
          expert_server.build_server_weights(bank, 4, red4).items()}
    red2 = np.array([[6], [0]], np.int32)
    expert_server.reshard_server_weights(sw, E, 2, red2)
    want = expert_server.build_server_weights(bank, 2, red2)
    for k in sw:
        assert sw[k].dtype == torch.bfloat16
        assert torch.equal(sw[k][1], want[k])
    jbank = {k: jnp.asarray(v.float().numpy()) for k, v in bank.items()}
    jwant = jexpert_server.build_server_weights(jbank, 2, red2)
    for k in sw:
        np.testing.assert_array_equal(sw[k][0].float().numpy(),
                                      np.asarray(jwant[k]))
