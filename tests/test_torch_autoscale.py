"""The port's Autoscaler against the JAX package's.

On the reference's autoscaler traces (``tests/test_scenario.py``: a rate
step 300 -> 80 req/s at granularity 1, 80 req/s at granularity 4) and on a
skewed diurnal trace with scale-to-zero paging, reduced deepseek-r1 in
float32 under VirtualClock: the decision trace, the page trace, the pool
trace, greedy tokens and ``metrics.fingerprint()`` equal the reference's
exactly, and the pool converges to ``provision()`` at its granularity.
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
from repro_torch.core.elastic import provision


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ENGINE = dict(mode="eaas", num_servers=8, max_batch=4, max_seq=64,
              n_redundant=1)


def _trace_rate_step(mod, vocab):
    return (mod.Scenario(horizon=1.2, seed=1, max_new=4, vocab=vocab)
            .poisson(rate=300).set_rate(t=0.6, rate=80))


def _trace_flat(mod, vocab):
    return mod.Scenario(horizon=0.8, seed=1, max_new=4,
                        vocab=vocab).poisson(rate=80)


def _trace_paging(mod, vocab):
    return (mod.Scenario(horizon=0.6, seed=1, prompt_len=8, max_new=6,
                         vocab=vocab)
            .diurnal(40, amplitude=0.9, period=0.6)
            .zipf_skew(1.2, scale=3.0)
            .set_elastic(0.3, False))


CASES = {
    "rate_step": (_trace_rate_step, dict(granularity=1, window=0.2,
                                         cooldown=0.1), {}),
    "granularity4": (_trace_flat, dict(granularity=4, window=0.2,
                                       cooldown=0.1), {}),
    "paging": (_trace_paging, dict(window=0.1, cooldown=0.05,
                                   expert_idle_fraction=0.5,
                                   page_in_protect=0.1),
               dict(num_servers=4, n_redundant=2,
                    pool_tokens_per_client=16)),
}


def _run(mod, cfg, case, params=None):
    trace, akw, ekw = CASES[case]
    asc = mod.Autoscaler(mod.AutoscalerConfig(
        rate_per_server=40, min_servers=1, max_servers=8, **akw))
    ecfg = mod.EngineConfig(**{**ENGINE, **ekw})
    if mod is J:
        eng = J.ServingEngine(cfg, ecfg, seed=0, clock=J.VirtualClock())
        params = jax.tree.map(np.asarray, eng.params)
    else:
        eng = T.ServingEngine(cfg, ecfg,
                              params=params_from_numpy(params, cfg, "cpu"),
                              clock=T.VirtualClock(), device="cpu")
    res = trace(mod, cfg.vocab_size).autoscale(asc).run(eng)
    return dict(eng=eng, asc=asc, res=res, params=params)


@pytest.fixture(scope="module", params=list(CASES))
def pair(request):
    jcfg = jget_config("deepseek-r1").reduced().replace(dtype="float32")
    tcfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    j = _run(J, jcfg, request.param)
    t = _run(T, tcfg, request.param, j["params"])
    return request.param, j, t


def test_traces_match_reference(pair):
    case, j, t = pair
    assert t["asc"].trace == j["asc"].trace
    assert t["asc"].page_trace == j["asc"].page_trace
    assert t["res"].server_trace == j["res"].server_trace
    assert [tuple(r.output_tokens) for r in t["res"].requests] == \
        [tuple(r.output_tokens) for r in j["res"].requests]
    assert t["res"].metrics.fingerprint() == j["res"].metrics.fingerprint()
    assert t["eng"].pool.num_servers == j["eng"].pool.num_servers
    m = t["res"].metrics
    assert m.completed == m.total_requests > 0


def test_converges_to_provision_at_granularity(pair):
    case, _, t = pair
    eng, res = t["eng"], t["res"]
    sizes = [n for _, n in res.server_trace]
    if case == "rate_step":
        target = provision(80, rate_per_server=40, granularity=1)
        assert eng.pool.num_servers == target == 2
        assert 8 in sizes and target in sizes
        tos = [e["to"] for e in res.metrics.events if e["event"] == "scale"]
        assert tos and tos[-1] == target
    elif case == "granularity4":
        assert eng.pool.num_servers == provision(80, 40, granularity=4) == 4
        assert set(sizes) <= {4, 8}          # whole groups of 4 only
    else:
        # paging: experts paged out while the controllers were live, none
        # after set_elastic froze them at t = 0.3
        pages = t["asc"].page_trace
        assert pages and all(tp < 0.3 for tp, _ in pages)
        assert res.metrics.expert_page_outs == sum(n for _, n in pages) > 0


def test_backlog_and_kv_pressure_signals():
    """The autoscaler's prefill-backlog and KV-pressure terms read the
    engine's signals: equal to the reference's on a chunked-prefill
    backlog (dense), and the paged pool's free fraction drops as
    requests are admitted."""
    def drive(mod, cfg, params=None, **kw):
        ecfg = mod.EngineConfig(**{**ENGINE, "max_batch": 2,
                                   "prefill_chunk": 4, "num_servers": 4,
                                   "n_redundant": 2, **kw})
        if mod is J:
            eng = J.ServingEngine(cfg, ecfg, seed=0, clock=J.VirtualClock())
        else:
            eng = T.ServingEngine(
                cfg, ecfg, params=params_from_numpy(params, cfg, "cpu"),
                clock=T.VirtualClock(), device="cpu")
        rng = np.random.default_rng(2)
        for i in range(3):
            eng.submit(mod.Request(i, rng.integers(0, 500, 10).astype(
                np.int32), mod.SamplingParams(max_new_tokens=2)))
        asc = mod.Autoscaler(mod.AutoscalerConfig(
            rate_per_server=1e9, max_servers=8,
            prefill_tokens_per_server=6.0, kv_pressure_threshold=0.9))
        seen = []
        for _ in range(3):
            eng.step()
            seen.append((eng.pending_prefill_tokens(),
                         eng.kv_free_fraction(),
                         asc.desired_servers(0.0, len(eng.queue),
                                             eng.pending_prefill_tokens(),
                                             eng.kv_free_fraction())))
        return eng, seen

    jcfg = jget_config("deepseek-r1").reduced().replace(dtype="float32")
    tcfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    jeng, jseen = drive(J, jcfg)
    params = jax.tree.map(np.asarray, jeng.params)
    _, tseen = drive(T, tcfg, params)
    assert tseen == jseen
    assert tseen[0][0] == 30 - 4 and tseen[0][2] == 1 + 26 // 6
    _, paged = drive(T, tcfg, params, kv_mode="paged", kv_block_size=4,
                     max_seq=32, kv_num_blocks=17)
    assert paged[0][1] < 1.0 and paged[-1][1] < paged[0][1] + 1e-9
