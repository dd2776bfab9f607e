"""Port paged KV (block pool, paged cache ops, chunked prefill, scheduler,
paged engine) against the JAX package on the same numpy inputs: reduced
deepseek-r1, float32 unless stated, engines under VirtualClock.

Token-identity pins compare runs with the same ``prefill_chunk``: paged
prefill always runs the chunk path, and a whole-prompt prefill agrees with
it only up to matmul-shape LSBs (tests/test_paged_kv.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.elastic import ServerPool as JServerPool
from repro.kernels import ops as jops
from repro.models import kv_cache as jkvc
from repro.models.transformer import ParallelCtx, build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Scenario as JScenario
from repro.serving import ServingEngine as JServingEngine
from repro.serving import VirtualClock as JVirtualClock
from repro.serving import kv_pool as jkv_pool
from repro.serving import scheduler as jsched
from repro.serving.request import Request as JRequest
from repro.serving.request import SamplingParams as JSamplingParams
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.elastic import ServerPool
from repro_torch.kernels import ops
from repro_torch.models import kv_cache as kvc
from repro_torch.models.transformer import ParallelCtx as TParallelCtx
from repro_torch.models.transformer import build_model
from repro_torch.serving import (EngineConfig, Scenario, ServingEngine,
                                 VirtualClock, kv_pool, scheduler)
from repro_torch.serving.request import Request, SamplingParams


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The reduced engines run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ENGINE = dict(mode="eaas", num_servers=4, max_batch=4, max_seq=128,
              n_redundant=2, pool_tokens_per_client=128, prefill_chunk=8,
              policy="fair")


def _both(a: np.ndarray, dtype: str = "float32"):
    """The same values as a JAX array and a CPU tensor."""
    j = jnp.asarray(a, DTYPES[dtype])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(j, np.float32))


# ------------------------------------------------------------------ kernel

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,hd,bs,mb", [
    (2, 8, 2, 32, 16, 4),
    (3, 4, 4, 64, 32, 2),
    (1, 16, 8, 16, 8, 4),
])
def test_paged_flash_decode_plain_vs_pallas(b, h, kv, hd, bs, mb, dtype,
                                            rng):
    nb = b * mb + 1
    jq, tq = _both(rng.normal(size=(b, h, hd)), dtype)
    jk, tk = _both(rng.normal(size=(nb, bs, kv, hd)), dtype)
    jv, tv = _both(rng.normal(size=(nb, bs, kv, hd)), dtype)
    tables = rng.permutation(np.arange(1, nb)).reshape(b, mb).astype(np.int32)
    lengths = rng.integers(1, mb * bs + 1, size=b).astype(np.int32)
    exp = jops.paged_flash_decode(jq, jk, jv, jnp.asarray(tables),
                                  jnp.asarray(lengths),
                                  impl="pallas_interpret")
    out = ops.paged_flash_decode(tq, tk, tv, torch.as_tensor(tables),
                                 torch.as_tensor(lengths))
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(exp, np.float32), rtol=tol,
                               atol=tol)


def test_paged_plain_equals_dense_plain_on_gathered_view(rng):
    b, h, kv, hd, bs, mb = 3, 4, 2, 16, 8, 3
    nb = b * mb + 1
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), dtype=torch.float32)
    kp = torch.as_tensor(rng.normal(size=(nb, bs, kv, hd)),
                         dtype=torch.float32)
    vp = torch.as_tensor(rng.normal(size=(nb, bs, kv, hd)),
                         dtype=torch.float32)
    tables = torch.as_tensor(rng.permutation(np.arange(1, nb))
                             .reshape(b, mb))
    lengths = torch.tensor([5, 20, 40])          # the last past the view
    kd = kp[tables].reshape(b, mb * bs, kv, hd)
    vd = vp[tables].reshape(b, mb * bs, kv, hd)
    assert torch.equal(ops.paged_flash_decode(q, kp, vp, tables, lengths),
                       ops.flash_decode(q, kd, vd, lengths))


def test_paged_cuda_wrapper_rejects_cpu_tensors():
    """The CUDA wrapper never runs the plain version: CPU tensors raise."""
    from repro_torch.kernels.decode_attention import paged_flash_decode_cuda
    with pytest.raises(ValueError, match="one CUDA device"):
        paged_flash_decode_cuda(torch.zeros(1, 2, 8),
                                torch.zeros(3, 4, 1, 8),
                                torch.zeros(3, 4, 1, 8),
                                torch.tensor([[1, 2]]), torch.tensor([5]))


# ----------------------------------------------------------- cache ops

def _paged_pair(rng, tables, lengths, nb=9, bs=4, kv=2, hd=8):
    jk, tk = _both(rng.normal(size=(nb, bs, kv, hd)))
    jv, tv = _both(rng.normal(size=(nb, bs, kv, hd)))
    jt, tt = jnp.asarray(tables, jnp.int32), torch.as_tensor(tables,
                                                             dtype=torch.int32)
    jl, tl = jnp.asarray(lengths, jnp.int32), torch.as_tensor(
        lengths, dtype=torch.int32)
    return (jkvc.PagedKVCache(jk, jv, jt, jl, block_size=bs),
            kvc.PagedKVCache(tk, tv, tt, tl))


def test_write_chunk_vs_reference(rng):
    jk, tk = _both(np.zeros((1, 16, 2, 8)))
    jl, tl = jnp.zeros(1, jnp.int32), torch.zeros(1, dtype=torch.int32)
    jnew, tnew = _both(rng.normal(size=(1, 5, 2, 8)))
    jc = jkvc.write_chunk(jkvc.KVCache(jk, jk, jl), jnew, 2 * jnew, 6)
    tc = kvc.write_chunk(kvc.KVCache(tk.clone(), tk.clone(), tl), tnew,
                         2 * tnew, 6)
    _eq(tc.k, jc.k)
    _eq(tc.v, jc.v)
    _eq(tc.length, jc.length)


def test_paged_append_decode_vs_reference(rng):
    """Live rows, a row at capacity (clamped into its last block) and two
    idle rows (length 0, table unset: both write scratch block 0)."""
    tables = np.array([[3, 5, 0], [1, 2, 4], [0, 0, 0], [6, 7, 8],
                       [0, 0, 0]], np.int32)
    lengths = np.array([5, 12, 0, 9, 0], np.int32)
    jc, tc = _paged_pair(rng, tables, lengths)
    jnew, tnew = _both(rng.normal(size=(5, 1, 2, 8)))
    jc = jkvc.paged_append_decode(jc, jnew, -jnew)
    tc = kvc.paged_append_decode(tc, tnew, -tnew)
    _eq(tc.length, jc.length)
    _eq(tc.k[1:], jc.k[1:])
    _eq(tc.v[1:], jc.v[1:])
    _eq(tc.k[0, 1:], jc.k[0, 1:])
    # duplicates resolve in row order: the last idle row's values
    assert torch.equal(tc.k[0, 0], tnew[4, 0])
    assert torch.equal(tc.v[0, 0], -tnew[4, 0])
    # the uploaded lengths stay as they were (shared by every layer)
    assert tc.length.tolist() == [6, 13, 1, 10, 1]


def test_paged_write_chunk_gather_and_mask_vs_reference(rng):
    tables = np.array([[3, 5, 1]], np.int32)
    jc, tc = _paged_pair(rng, tables, np.array([0], np.int32))
    jnew, tnew = _both(rng.normal(size=(1, 6, 2, 8)))
    jc = jkvc.paged_write_chunk(jc, jnew, 2 * jnew, 3)
    tc = kvc.paged_write_chunk(tc, tnew, 2 * tnew, 3)
    _eq(tc.k, jc.k)
    _eq(tc.v, jc.v)
    _eq(tc.length, jc.length)
    for t, j in zip(kvc.gather_blocks(tc), jkvc.gather_blocks(jc)):
        _eq(t, j)
    np.testing.assert_array_equal(kvc.paged_valid_mask(tc).numpy(),
                                  np.asarray(jkvc.paged_valid_mask(jc)))


def test_copy_blocks_stacked_vs_reference(rng):
    jk, tk = _both(rng.normal(size=(2, 6, 4, 2, 8)))
    jv, tv = _both(rng.normal(size=(2, 6, 4, 2, 8)))
    tab = np.zeros((1, 2), np.int32)
    jc = jkvc.PagedKVCache(jk, jv, jnp.asarray(tab), jnp.zeros(1, jnp.int32),
                           block_size=4)
    tc = kvc.PagedKVCache(tk, tv, torch.as_tensor(tab),
                          torch.zeros(1, dtype=torch.int32))
    src, dst = np.array([1, 3]), np.array([3, 5])     # 3 is read, then written
    jc = jkvc.copy_blocks(jc, jnp.asarray(src), jnp.asarray(dst),
                          stacked=True)
    tc = kvc.copy_blocks(tc, torch.as_tensor(src), torch.as_tensor(dst),
                         stacked=True)
    _eq(tc.k, jc.k)
    _eq(tc.v, jc.v)


def test_prefill_chunk_paged_then_decode_vs_jax():
    """The decoder's chunked prefill (chunks of 8) into a paged cache, then
    8 decode steps through the paged kernel's plain version, against the
    JAX decoder on the same bridged weights and tables."""
    cfg = jget_config("deepseek-r1").reduced().replace(dtype="float32")
    tcfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    jpool = JServerPool(cfg, 4, tokens_per_client=32, n_redundant=2)
    tpool = ServerPool(tcfg, 4, tokens_per_client=32, n_redundant=2)
    jmodel = jbuild(cfg, 4, jpool.redundant_table)
    tmodel = build_model(tcfg, 4, tpool.redundant_table, "cpu")
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    ctx = ParallelCtx(moe_runtime=jpool.runtime("xla_ragged"), remat=False)
    trt = TParallelCtx(moe_runtime=tpool.runtime("cpu"))
    jchunk = jax.jit(lambda p, t, c, s: jmodel.prefill_chunk(p, t, c, s, ctx))
    jdecode = jax.jit(lambda p, t, c: jmodel.decode_step(p, t, c, ctx))
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, 24)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(8, 1, 1)).astype(np.int32)
    bs, nb, mb = 8, 9, 8
    row = np.array([[4, 1, 7, 2, 0, 0, 0, 0]], np.int32)

    jc = jmodel.init_paged_cache(nb, bs, 1, mb * bs)
    tc = tmodel.init_paged_cache(nb, bs, 1, mb * bs)
    tab = torch.as_tensor(row)
    pairs = []
    for start in range(0, 24, 8):
        jview = {k: jkvc.PagedKVCache(
            c.k, c.v, jnp.broadcast_to(row, (c.k.shape[0], 1, mb)),
            jnp.full((c.k.shape[0], 1), start, jnp.int32), bs)
            for k, c in jc.items()}
        jl, jview, _ = jchunk(jparams, jnp.asarray(prompt[:, start:start + 8]),
                              jview, jnp.int32(start))
        jc = {k: jkvc.PagedKVCache(jview[k].k, jview[k].v,
                                   jc[k].block_tables, jc[k].length, bs)
              for k in jc}
        tview = {k: kvc.PagedKVCache(c.k, c.v, tab,
                                     torch.tensor([start], dtype=torch.int32))
                 for k, c in tc.items()}
        tl, _, _ = tmodel.prefill_chunk(
            tparams, torch.as_tensor(prompt[:, start:start + 8]).long(),
            tview, start, trt)
    pairs.append((tl, jl))
    for t in range(8):
        n = 24 + t
        lengths = np.array([n], np.int32)
        jview = {k: jkvc.PagedKVCache(
            c.k, c.v, jnp.broadcast_to(row, (c.k.shape[0], 1, mb)),
            jnp.broadcast_to(lengths, (c.k.shape[0], 1)), bs)
            for k, c in jc.items()}
        jl, jview, _ = jdecode(jparams, jnp.asarray(steps[t]), jview)
        jc = {k: jkvc.PagedKVCache(jview[k].k, jview[k].v,
                                   jc[k].block_tables, jc[k].length, bs)
              for k in jc}
        tview = {k: kvc.PagedKVCache(c.k, c.v, tab, torch.as_tensor(lengths))
                 for k, c in tc.items()}
        tl, _, _ = tmodel.decode_step(tparams,
                                      torch.as_tensor(steps[t]).long(),
                                      tview, trt)
        pairs.append((tl, jl))
    for tl, jl in pairs:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    for name in tc:
        np.testing.assert_allclose(tc[name].k.numpy(),
                                   np.asarray(jc[name].k), rtol=0,
                                   atol=1e-5)


# ------------------------------------------------------------ block pool

def _pool_state(p):
    return (list(p._free), p._ref.tolist(), list(p._evictable),
            dict(p._hash_of), p.matched_blocks, p.queried_blocks,
            p.evictions, p.cow_forks, p.available(), p.utilization())


def test_block_pool_vs_reference():
    rng = np.random.default_rng(0)
    pools = [kv_pool.BlockPool(12, 4), jkv_pool.BlockPool(12, 4)]
    prompts = [rng.integers(0, 3, 16) for _ in range(6)]
    for p in prompts:
        assert kv_pool.block_hashes(p, 4) == jkv_pool.block_hashes(p, 4)
    held = []
    for _ in range(600):
        op = int(rng.integers(0, 6))
        if op == 0:
            n = int(rng.integers(1, 4))
            outs = [p.allocate(n) for p in pools]
            held += outs[0] or []
        elif op == 1:
            hs = kv_pool.block_hashes(prompts[rng.integers(6)], 4)
            outs = [p.match_prefix(hs) for p in pools]
            held += outs[0]
        elif not held:
            continue
        elif op == 2:
            bid = held[rng.integers(len(held))]
            h = kv_pool.block_hashes(prompts[rng.integers(6)],
                                     4)[rng.integers(4)]
            outs = [p.register(bid, h) for p in pools]
        elif op == 3:
            bid = held[rng.integers(len(held))]
            outs = [p.fork(bid) for p in pools]
            held += [] if outs[0] is None else [outs[0]]
        elif op == 4:
            bid = held[rng.integers(len(held))]
            outs = [p.incref(bid) for p in pools]
            held.append(bid)
        else:
            bid = held.pop(rng.integers(len(held)))
            outs = [p.decref(bid) for p in pools]
        assert outs[0] == outs[1]
        assert _pool_state(pools[0]) == _pool_state(pools[1])
    assert pools[0].evictions > 0 and pools[0].matched_blocks > 0
    assert pools[0].cow_forks > 0


# ------------------------------------------------------------- scheduler

def _plan_key(plan):
    if isinstance(plan, (scheduler.PrefillChunk, jsched.PrefillChunk)):
        return ("prefill", plan.slot, plan.request.request_id, plan.start,
                plan.length, plan.is_first, plan.is_last,
                plan.tokens.tolist(), plan.copies)
    if isinstance(plan, (scheduler.DecodeBatch, jsched.DecodeBatch)):
        return ("decode", plan.slots)
    return ("idle",)


def _drive_scheduler(mod, pool_mod, req_cls, sp_cls, arrivals):
    """Host-only engine loop: the model's tokens are a function of the
    request id and token index, so both schedulers see the same stream."""
    sch = mod.Scheduler(
        mod.SchedulerConfig(max_batch=4, prefill_chunk=8, policy="fair",
                            max_seq=64),
        kv_pool=pool_mod.BlockPool(17, 8))
    trace, t, ai = [], 0, 0
    reqs = [req_cls(i, p, sp_cls(max_new_tokens=n), arrival_time=float(at))
            for i, (p, n, at) in enumerate(arrivals)]
    while t < 2000 and (ai < len(reqs) or sch.queue
                        or any(s is not None for s in sch.slots)):
        while ai < len(reqs) and reqs[ai].arrival_time <= t:
            sch.submit(reqs[ai])
            ai += 1
        plan = sch.next_plan()
        if isinstance(plan, mod.PrefillChunk):
            sch.prefill_advanced(plan.slot, plan.length)
            r = plan.request
            if plan.is_last and not r.output_tokens:
                r.output_tokens.append((r.request_id * 31) % 512)
        elif isinstance(plan, mod.DecodeBatch):
            for b in plan.slots:
                r = sch.slots[b]
                r.output_tokens.append((r.request_id * 7
                                        + len(r.output_tokens)) % 512)
                if len(r.output_tokens) >= r.sampling.max_new_tokens:
                    sch.release(b)
        trace.append((_plan_key(plan), sch.block_tables.tolist(),
                      sch.preemptions, sch.cache_lengths().tolist()))
        t += 1
    return trace, [r.output_tokens for r in reqs]


def test_scheduler_vs_reference_through_preemption():
    """Max_seq 64 over 16 usable blocks of 8: four slots of up to 63
    tokens oversubscribe the pool; every third prompt is the bare shared
    prefix, so its admission forks the cached tail block."""
    rng = np.random.default_rng(1)
    shared = rng.integers(0, 512, 16).astype(np.int32)
    arrivals = []
    for i in range(12):
        n = 0 if i % 3 == 0 else int(rng.integers(8, 25))
        prompt = np.concatenate([shared, rng.integers(0, 512, n)])
        arrivals.append((prompt.astype(np.int32), int(rng.integers(10, 25)),
                         i // 3))
    port = _drive_scheduler(scheduler, kv_pool, Request, SamplingParams,
                            arrivals)
    ref = _drive_scheduler(jsched, jkv_pool, JRequest, JSamplingParams,
                           arrivals)
    assert len(port[0]) == len(ref[0])
    for step, (p, r) in enumerate(zip(port[0], ref[0])):
        assert p == r, step
    assert port[1] == ref[1]
    assert port[0][-1][2] > 0                     # preemptions happened
    assert any(k[0][0] == "prefill" and k[0][8] for k in port[0])  # COW


# ---------------------------------------------------------------- engine

def _shared_prefix_scenario(mod, vocab, max_new=5, horizon=0.15, rate=100,
                            seed=7, events=False):
    # two 16-token system prompts (2 blocks, 2 chunks) + unique suffixes
    sc = (mod(horizon=horizon, seed=seed, max_new=max_new, vocab=vocab)
          .shared_prefix(n_prefixes=2, prefix_len=16, suffix_len=6)
          .poisson(rate=rate))
    if events:        # the scenario verbs the port replays
        sc = (sc.fail(rank=1, t=0.04).set_policy(t=0.06,
                                                 policy="prefill-priority")
              .recover(rank=1, t=0.09).set_policy(t=0.12, policy="fcfs"))
    return sc


def _tokens(res):
    return {r.request_id: tuple(r.output_tokens) for r in res.requests}


@pytest.fixture(scope="module")
def paged_runs():
    cfg = jget_config("deepseek-r1").reduced().replace(dtype="float32")
    tcfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    kw = dict(ENGINE, kv_mode="paged", kv_block_size=8)
    jeng = JServingEngine(cfg, JEngineConfig(**kw), seed=0,
                          clock=JVirtualClock())
    jres = _shared_prefix_scenario(JScenario, cfg.vocab_size,
                                   events=True).run(jeng)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               "cpu")

    def port(**over):
        eng = ServingEngine(tcfg, EngineConfig(**{**kw, **over}),
                            params=params, clock=VirtualClock(),
                            device="cpu")
        return eng, eng.metrics

    teng, _ = port()
    tres = _shared_prefix_scenario(Scenario, cfg.vocab_size,
                                   events=True).run(teng)
    return dict(jres=jres, tres=tres, teng=teng, port=port, tcfg=tcfg)


def test_paged_engine_vs_jax(paged_runs):
    j, t = paged_runs["jres"], paged_runs["tres"]
    for tr, jr in zip(t.requests, j.requests, strict=True):   # same trace
        assert tr.arrival_time == jr.arrival_time
        np.testing.assert_array_equal(tr.prompt, jr.prompt)
    assert t.metrics.completed == t.metrics.total_requests > 0
    assert _tokens(t) == _tokens(j)
    for tr, jr in zip(t.requests, j.requests):
        assert tr.prefill_time == jr.prefill_time
        assert tr.token_times == jr.token_times
    assert t.metrics.ttfts == j.metrics.ttfts
    assert t.metrics.summary()["kv"] == j.metrics.summary()["kv"]
    assert t.metrics.prefix_hit_blocks > 0
    assert [e["event"] for e in t.metrics.events
            if e["event"] != "prefill"] == [
        "server_fail", "set_policy", "server_recover", "set_policy"]
    assert t.metrics.fingerprint() == j.metrics.fingerprint()


def test_paged_equals_dense_chunked_tokens(paged_runs):
    toks = []
    for kind in ("dense", "paged"):
        eng, _ = paged_runs["port"](kv_mode=kind)
        toks.append(_tokens(_shared_prefix_scenario(Scenario, 512).run(eng)))
    assert toks[0] == toks[1]


def test_squeezed_pool_preempts_with_identical_tokens(paged_runs):
    """Pool squeezed to the single-request minimum: admission gates,
    preemption recomputes, and every token stream equals the unconstrained
    pool's."""
    runs = []
    for nb in (17, None):
        eng, _ = paged_runs["port"](kv_num_blocks=nb)
        runs.append(_shared_prefix_scenario(Scenario, 512, max_new=24,
                                            rate=150).run(eng))
    small, big = runs
    assert small.metrics.completed == small.metrics.total_requests > 0
    assert small.metrics.preemptions > 0
    assert small.metrics.kv_peak_block_util == pytest.approx(1.0)
    assert big.metrics.preemptions == 0
    assert _tokens(small) == _tokens(big)


def test_cow_fork_on_fully_cached_prompt(paged_runs):
    eng, _ = paged_runs["port"]()
    res = (Scenario(horizon=0.1, seed=3, max_new=6, vocab=512)
           .shared_prefix(n_prefixes=1, prefix_len=24, suffix_len=0)
           .poisson(rate=120)).run(eng)
    m = res.metrics
    assert m.completed == m.total_requests > 1
    assert m.kv_cow_forks == m.total_requests - 1
    assert len({tuple(r.output_tokens) for r in res.requests}) == 1


def test_paged_config_validation(paged_runs):
    with pytest.raises(ValueError, match="multiple of"):
        paged_runs["port"](kv_block_size=24)
    with pytest.raises(ValueError, match="maximal request"):
        paged_runs["port"](kv_num_blocks=8)


def test_scenario_unported_verbs_raise():
    """Every scenario verb builds its event now, the cluster's too; a
    client-level event replayed on a single engine raises the reference's
    "needs a Cluster" error."""
    sc = (Scenario(horizon=1.0, clients=4).scale_to(2, t=0.5)
          .rebalance(t=0.6).slow_server(1, t=0.7).zipf_skew(1.2)
          .set_elastic(0.8, False).fail_client(0, t=0.1)
          .recover_client(0, t=0.2)
          .set_frontend_policy(0.3, "session_affinity"))
    assert [e.kind for e in sc.events] == [
        "scale_to", "rebalance", "slow_server", "set_skew", "set_elastic",
        "fail_client", "recover_client", "set_frontend_policy"]
    eng = ServingEngine(get_config("deepseek-r1").reduced(), EngineConfig(
        kv_mode="paged", max_batch=2, max_seq=64), clock=VirtualClock(),
        device="cpu")
    with pytest.raises(ValueError, match="needs a Cluster engine"):
        (Scenario(horizon=1.0).fail_client(0, t=0.0)).run(eng)
