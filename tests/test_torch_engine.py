"""Port ServingEngine against the JAX ServingEngine: reduced deepseek-r1 in
float32 under VirtualClock, 4 requests, expert server 1 failing and
recovering mid-decode.  Greedy tokens, virtual token times and the
replica placement must be identical."""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.serving import VirtualClock as JVirtualClock
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                 ServingEngine, VirtualClock)


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


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, 16).astype(np.int32) for _ in range(4)]


def _drive(eng, req_cls, sp_cls, temperature=0.0):
    reqs = [req_cls(i, p, sp_cls(max_new_tokens=8, temperature=temperature,
                                 seed=3))
            for i, p in enumerate(_prompts())]
    for r in reqs:
        eng.submit(r)

    def on_step(e):
        if e.step_idx == 6:
            e.inject_server_failure(1)
        if e.step_idx == 9:
            e.recover_server(1)
    metrics = eng.run(on_step=on_step)
    return reqs, metrics


@pytest.fixture(scope="module")
def runs():
    cfg = jget_config("deepseek-r1").reduced().replace(dtype="float32")
    jeng = JServingEngine(cfg, JEngineConfig(**ENGINE), seed=0,
                          clock=JVirtualClock())
    jreqs, jmetrics = _drive(jeng, JRequest, JSamplingParams)
    tcfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               "cpu")
    teng = ServingEngine(tcfg, EngineConfig(**ENGINE), params=params,
                         clock=VirtualClock(), device="cpu")
    treqs, tmetrics = _drive(teng, Request, SamplingParams)
    return dict(jeng=jeng, jreqs=jreqs, jm=jmetrics, teng=teng, treqs=treqs,
                tm=tmetrics, tcfg=tcfg, params=params)


def test_greedy_tokens_identical(runs):
    for j, t in zip(runs["jreqs"], runs["treqs"]):
        assert len(t.output_tokens) == 8
        assert t.output_tokens == j.output_tokens


def test_virtual_token_times_identical(runs):
    for j, t in zip(runs["jreqs"], runs["treqs"]):
        assert t.prefill_time == j.prefill_time
        assert t.token_times == j.token_times
        assert t.finish_time == j.finish_time
    assert runs["tm"].ttfts == runs["jm"].ttfts
    assert runs["tm"].itls == runs["jm"].itls
    assert runs["tm"].summary() == {k: v for k, v in runs["jm"].summary()
                                    .items() if k in runs["tm"].summary()}


def test_placement_and_failover_identical(runs):
    np.testing.assert_array_equal(runs["teng"].pool.redundant_table,
                                  runs["jeng"].pool.redundant_table)
    np.testing.assert_array_equal(runs["teng"].pool.smap.table,
                                  runs["jeng"].pool.smap.table)
    assert runs["teng"].pool.smap.alive.all()          # recovered
    kinds = [e["event"] for e in runs["tm"].events]
    assert kinds == [e["event"] for e in runs["jm"].events]
    assert "server_fail" in kinds and "server_recover" in kinds
    assert runs["tm"].timeline == runs["jm"].timeline


def test_temperature_streams_replay(runs):
    """Sampled streams are a function of (seed, request id, token index):
    two runs agree (they are not comparable with the reference's)."""
    streams = []
    for _ in range(2):
        eng = ServingEngine(runs["tcfg"], EngineConfig(**ENGINE),
                            params=runs["params"], clock=VirtualClock(),
                            device="cpu")
        reqs, metrics = _drive(eng, Request, SamplingParams,
                               temperature=0.8)
        assert metrics.completed == 4
        streams.append([r.output_tokens for r in reqs])
    assert streams[0] == streams[1]
    assert streams[0] != [r.output_tokens for r in runs["treqs"]]


def test_unported_modes_raise():
    """Every engine mode is ported now (the async tier too:
    tests/test_torch_async.py); what raises is async's validation, as in
    the reference's test_async_depth_validation."""
    tcfg = get_config("deepseek-r1").reduced()
    for kw in ({"async_depth": 0}, {"queue_mode": "bogus"},
               {"lane_budget": 0}):
        with pytest.raises(ValueError):
            ServingEngine(tcfg, EngineConfig(**{**ENGINE, **kw,
                                                "exec_mode": "async"}),
                          clock=VirtualClock(), device="cpu")
    with pytest.raises(ValueError, match="needs a VirtualClock"):
        ServingEngine(tcfg, EngineConfig(**{**ENGINE, "exec_mode": "async"}),
                      device="cpu")
    eng = ServingEngine(tcfg, EngineConfig(**{**ENGINE, "exec_mode": "async",
                                              "async_depth": 3}),
                        clock=VirtualClock(), device="cpu")
    assert eng.tier is not None and eng.tier.num_servers == 4
