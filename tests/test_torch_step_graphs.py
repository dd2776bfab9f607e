"""The executor's decode variants over static buffers
(``repro_torch/serving/step_graphs.py``), the counterpart of the
reference's compiled step variants (``src/repro/serving/executor.py``
``_build_jits``).

On the CPU a variant runs eagerly over the same static buffers a CUDA
graph reads on the card, so these hold what staging and keying do (the
card's tests hold the graphs themselves, ``tests/test_torch_cuda.py``):

* staging changes nothing: decode through the static buffers is bitwise
  the step as it ran before them (fresh tensors uploaded each step,
  ``model.decode_step`` called directly), for lockstep, pipelined,
  serialized, masked and paged decode, through a failure and a router
  bias; and the engines' tokens, token times and fingerprints equal the
  JAX engine's on the reference's Fig. 10 fail/recover scenario;
* the key stays: through a server failure and recovery, a client's
  ``mask_server``, a page-out, a one-shot rebalance's migration and router
  bias value changes each variant keeps one key (no capture on the card);
  the first ``set_skew`` gives one new key, ``scale_to`` another;
* storage stays: for zamba2, rwkv6, gemma3 and whisper every cache leaf
  keeps its address across decode steps, and the tokens equal the
  reference engine's.

Reduced configs in float32, one torch thread.
"""

import jax
import numpy as np
import pytest
import torch

import repro.serving.engine as jengine_mod
from repro import serving as J
from repro.configs import get_config as jget_config
from repro.models.transformer import _zero_stats as jzero_stats
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.elastic import ServerPool
from repro_torch.core.overlap import split_batch_decode
from repro_torch.models.transformer import ParallelCtx, build_model
from repro_torch.serving import step_graphs
from repro_torch.serving.executor import Executor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Reduced engines run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(get=get_config, arch="deepseek-r1", **kw):
    return get(arch).reduced().replace(dtype="float32", **kw)


# ------------------------------------------------- staging changes nothing

B, SEQ, BS = 4, 32, 8


def _executor(mode, kv_mode, params=None):
    cfg = _cfg()
    pool = ServerPool(cfg, 4, tokens_per_client=B)
    model = build_model(cfg, 4, pool.redundant_table, "cpu")
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0))
    return Executor(model, params, pool, max_batch=B, max_seq=SEQ,
                    device="cpu", decode_mode=mode, kv_mode=kv_mode,
                    kv_block_size=BS,
                    kv_num_blocks=B * SEQ // BS + 1 if kv_mode == "paged"
                    else 0)


def _tables():
    per = SEQ // BS
    return np.arange(1, B * per + 1, dtype=np.int32).reshape(B, per)


def _prefill(ex, rng, lengths):
    for b, n in enumerate(lengths):
        prompt = rng.integers(0, ex.model.cfg.vocab_size, n)
        if ex.kv_mode == "paged":
            ex.prefill_chunk_paged(prompt, 0, _tables()[b])
        else:
            ex.prefill(b, prompt)


def _copy_cache(dst, src):
    for a, b in zip(step_graphs.tensors(dst.cache),
                    step_graphs.tensors(src.cache)):
        a.copy_(b)


def _fresh(ex, tokens):
    """The step as it ran before the static buffers: every input a fresh
    tensor, the runtime re-uploaded from the pool."""
    return (torch.as_tensor(np.asarray(tokens, np.int64)),
            ParallelCtx(moe_runtime=ex.pool.runtime("cpu")))


def _decode_before(ex, tokens):
    tok, ctx = _fresh(ex, tokens)
    if ex.decode_mode == "lockstep":
        logits, ex.cache, stats = ex.model.decode_step(ex.params, tok,
                                                       ex.cache, ctx)
    else:
        logits, ex.cache, stats = split_batch_decode(
            lambda t, c: ex.model.decode_step(ex.params, t, c, ctx),
            tok, ex.cache, axis=1, enabled=ex.decode_mode == "pipelined")
    ex._tally(stats)
    return logits, stats.expert_load


def _masked_before(ex, tokens, mask):
    keep = torch.as_tensor(np.asarray(mask, bool))
    saved = {}
    for name, c in ex.cache.items():
        n_layers, Bc, slots = c.k.shape[:3]
        at = (torch.arange(n_layers)[:, None], torch.arange(Bc)[None, :],
              c.length.clamp(max=slots - 1).long())
        saved[name] = (at, c.k[at], c.v[at], c.length.clone())
    tok, ctx = _fresh(ex, tokens)
    logits, ex.cache, stats = ex.model.decode_step(ex.params, tok, ex.cache,
                                                   ctx)
    for name, (at, k_old, v_old, len_old) in saved.items():
        c = ex.cache[name]
        row = keep[None, :, None, None]
        c.k[at] = torch.where(row, c.k[at], k_old)
        c.v[at] = torch.where(row, c.v[at], v_old)
        c.length.copy_(torch.where(keep[None, :], c.length, len_old))
    ex._tally(stats)
    return logits, stats.expert_load


def _paged_before(ex, tokens, lengths):
    from repro_torch.models import kv_cache as kvc
    tok, ctx = _fresh(ex, tokens)
    t = torch.as_tensor(_tables())
    n = torch.as_tensor(np.asarray(lengths, np.int32))
    view = {name: kvc.PagedKVCache(c.k, c.v, t, n)
            for name, c in ex.cache.items()}
    logits, _, stats = ex.model.decode_step(ex.params, tok, view, ctx)
    ex._tally(stats)
    return logits, stats.expert_load


VARIANTS = {"lockstep": ("lockstep", "dense"),
            "pipelined": ("pipelined", "dense"),
            "serialized": ("serialized", "dense"),
            "masked": ("lockstep", "dense"),
            "paged": ("lockstep", "paged")}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_staging_changes_nothing(variant):
    """Three steps through the static buffers against the step as it ran
    before them, on twin executors over one pool: server 1 fails after
    the first step, a router bias appears after the second.  Logits,
    expert loads, every cache leaf and the drop / miss totals bitwise."""
    mode, kv_mode = VARIANTS[variant]
    ex = _executor(mode, kv_mode)
    old = _executor(mode, kv_mode, params=ex.params)
    old.pool = ex.pool
    rng = np.random.default_rng(1)
    lengths = [5, 9, 3, 12]
    _prefill(ex, rng, lengths)
    _copy_cache(old, ex)
    ex.dropped.zero_()                  # the prefills' drops: ex's alone
    ex.miss.zero_()
    mask = np.array([True, False, True, True])
    for step in range(3):
        tokens = rng.integers(0, ex.model.cfg.vocab_size, (B, 1))
        if variant == "masked":
            got = ex.decode_masked(tokens, mask)
            want = _masked_before(old, tokens, mask)
        elif variant == "paged":
            now = [n + step for n in lengths]
            got = ex.decode_paged(tokens, _tables(), now)
            want = _paged_before(old, tokens, now)
        else:
            got = ex.decode(tokens)
            want = _decode_before(old, tokens)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (variant, step)
        for a, b in zip(step_graphs.tensors(ex.cache),
                        step_graphs.tensors(old.cache)):
            assert torch.equal(a, b), (variant, step)
        if step == 0:
            ex.pool.server_failed(1)
        elif step == 1:
            ex.pool.set_route_bias(
                rng.normal(size=ex.model.cfg.moe.num_experts) * 2)
    assert torch.equal(ex.dropped, old.dropped)
    assert torch.equal(ex.miss, old.miss)
    name = {"masked": "decode_masked", "paged": "decode_paged"}.get(
        variant, "decode")
    # the bias's arrival is a new structure (the router adds it); the
    # failure is data
    assert len(ex.graphs.keys[name]) == 2
    assert ex.graphs.captures == {} and ex.graphs.replays == {}


def test_static_buffers_upload_only_what_changed():
    """A buffer keeps its tensor while the array keeps its shape and dtype,
    is rewritten only where a value changed, and is reallocated (a new
    address, so a graph over it is captured again) where the shape did."""
    st = step_graphs.StaticInputs("cpu")
    a = st.put("x", np.arange(4))
    ptr = a.data_ptr()
    assert st.put("x", np.arange(4)) is a
    b = st.put("x", np.arange(4) * 2)
    assert b is a and a.tolist() == [0, 2, 4, 6] and a.data_ptr() == ptr
    c = st.put("x", np.arange(5))
    assert c is not a and c.tolist() == list(range(5))
    d = st.put("x", np.arange(5).astype(np.int32))
    assert d is not c and d.dtype == torch.int32


# ----------------------------------------------- Fig. 10 against the JAX one

def _fig10_ecfg(mod, **kw):
    # benchmarks/fault_tolerance.py:26-29, EAAS
    return mod.EngineConfig(mode="eaas", num_servers=4, max_batch=4,
                            max_seq=64, n_redundant=2, **kw)


def _fig10_scenario(mod, vocab):
    """Poisson traffic; server 0 fails at 0.05 s and recovers at 0.1 s,
    server 1 fails at 0.15 s and recovers at 0.2 s."""
    sc = mod.Scenario(horizon=0.25, seed=0, max_new=8, vocab=vocab)
    sc.poisson(80)
    for i in range(2):
        t0 = 0.05 + 0.1 * i
        sc.fail(rank=i, t=t0)
        sc.recover(rank=i, t=t0 + 0.05)
    return sc


FIG10 = {"lockstep": dict(decode_mode="lockstep"),
         "pipelined": dict(decode_mode="pipelined"),
         "paged": dict(kv_mode="paged", kv_block_size=8, prefill_chunk=8)}


@pytest.mark.parametrize("variant", list(FIG10))
def test_fig10_engine_matches_reference(variant):
    """The reference's Fig. 10 engine (VirtualClock, fp32) through two
    server failures: tokens, token times and fingerprint equal the JAX
    engine's, the decode variant keeps one key throughout and each prefill
    variant one key per shape."""
    jcfg, tcfg = _cfg(jget_config), _cfg()
    kw = FIG10[variant]
    jeng = J.ServingEngine(jcfg, _fig10_ecfg(J, **kw), seed=0,
                           clock=J.VirtualClock())
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               "cpu")
    jres = _fig10_scenario(J, jcfg.vocab_size).run(jeng)
    teng = T.ServingEngine(tcfg, _fig10_ecfg(T, **kw), params=params,
                           clock=T.VirtualClock(), device="cpu")
    tres = _fig10_scenario(T, tcfg.vocab_size).run(teng)
    assert tres.metrics.completed == tres.metrics.total_requests > 8
    for j, t in zip(jres.requests, tres.requests):
        assert t.output_tokens == j.output_tokens
        assert t.token_times == j.token_times
    assert tres.metrics.fingerprint() == jres.metrics.fingerprint()
    name = "decode_paged" if variant == "paged" else "decode"
    keys = teng.executor.graphs.keys
    assert len(keys[name]) == 1
    # the other variants are the prefill ones, one key per shape each
    assert set(keys) - {name} <= {"prefill", "prefill_chunk",
                                  "prefill_chunk_paged", "copy_blocks"}
    for other in set(keys) - {name}:
        shapes = [shape for _, shape in keys[other]]
        assert len(shapes) == len(set(shapes)), other


# ------------------------------------------------------------ the key stays

KEY_CASES = {"decode": dict(),
             "decode_masked": dict(exec_mode="async"),
             "decode_paged": dict(kv_mode="paged", kv_block_size=8,
                                  prefill_chunk=8)}


def _steps(cl, variant, n=3):
    """Step the cluster until every client has run ``variant`` ``n`` more
    times (so each has decoded under the change before the check)."""
    start = [c.executor.calls for c in cl.clients]
    for _ in range(2000):
        if all(c.executor.calls - s >= n
               for c, s in zip(cl.clients, start)):
            return
        cl.step()
    raise AssertionError("a client stopped decoding")


def _count_calls(ex, variant):
    ex.calls = 0
    run = getattr(ex, variant)

    def counted(*a):
        ex.calls += 1
        return run(*a)
    setattr(ex, variant, counted)


@pytest.mark.parametrize("variant", list(KEY_CASES))
def test_key_stays_through_the_control_plane(variant):
    """A 2-client cluster decoding throughout: a server failure and its
    recovery, client 0 masking a server, a page-out, a router bias's
    values changing and a one-shot rebalance's migration keep each
    client's key; the first bias (the router's add appears) gives one new
    key and ``scale_to`` another (new shapes, new weight tensors)."""
    cfg = _cfg()
    ccfg = T.ClusterConfig(clients=2, engine=T.EngineConfig(
        mode="eaas", num_servers=4, max_batch=4, max_seq=128,
        n_redundant=2, pool_tokens_per_client=16, **KEY_CASES[variant]))
    cl = T.Cluster(cfg, ccfg, seed=0, clock_factory=T.VirtualClock,
                   device="cpu")
    rng = np.random.default_rng(4)
    for i in range(8):
        cl.submit(T.Request(i, rng.integers(0, cfg.vocab_size, 6)
                            .astype(np.int32),
                            T.SamplingParams(max_new_tokens=100)))
    for c in cl.clients:
        _count_calls(c.executor, variant)
    _steps(cl, variant)

    def keys():
        return [len(c.executor.graphs.keys.get(variant, ()))
                for c in cl.clients]
    assert keys() == [1, 1]
    cl.inject_server_failure(1)
    _steps(cl, variant)
    cl.recover_server(1)
    cl.clients[0].pool.mask_server(2)
    _steps(cl, variant)
    cl.clients[0].pool.unmask_server(2)
    E = cfg.moe.num_experts
    # a replicated expert's replica slots zeroed through the migration
    # path (past the async tier's in-flight gate, which is not at issue)
    red = cl.pool.redundant_table
    paged, updates = cl.pool.page_out_experts([int(red[red >= 0][0])])
    assert paged and updates
    cl.apply_migration(updates)
    _steps(cl, variant)
    assert keys() == [1, 1]
    cl.set_skew(np.linspace(0.0, 4.0, E))
    _steps(cl, variant)
    assert keys() == [2, 2]
    cl.set_skew(np.linspace(4.0, 0.0, E))
    _steps(cl, variant)
    w = cl.params["blocks"]["moe"]["servers"]["w_gate"]
    before = w.clone()
    cl.rebalance()
    assert not torch.equal(w, before)        # a migration wrote in place
    _steps(cl, variant)
    assert keys() == [2, 2]
    cl.scale_to(2)
    _steps(cl, variant)
    assert keys() == [3, 3]
    assert all(not c.executor.graphs.captures for c in cl.clients)


# ---------------------------------------------------------- storage stays

FAMILIES = {"zamba2-2.7b": {}, "rwkv6-7b": {},
            "gemma3-4b": {"num_layers": 6}, "whisper-base": {}}


@pytest.fixture()
def jax_zero_stats(monkeypatch):
    """The reference's decode steps of these families return stats None,
    which its engine cannot read (ROADMAP Queue 3): test-side only, its
    model is wrapped to return zero stats."""
    orig = jengine_mod.build_model

    def build(cfg, **kw):
        m = orig(cfg, **kw)

        def decode_step(*a, **k):
            logits, cache, st = m.decode_step(*a, **k)
            return logits, cache, jzero_stats(cfg) if st is None else st
        return m._replace(decode_step=decode_step)
    monkeypatch.setattr(jengine_mod, "build_model", build)


def _serve(eng, req_cls, sp_cls):
    rng = np.random.default_rng(0)
    reqs = [req_cls(i, rng.integers(0, 512, size=n).astype(np.int32),
                    sp_cls(max_new_tokens=6))
            for i, n in enumerate((71, 64, 40))]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return reqs


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_cache_storage_stays(arch, jax_zero_stats):
    """Every cache leaf (KV stacks, rings, Mamba and RWKV states,
    whisper's cross K/V) keeps its address and shape at every decode step,
    so a graph captured over it stays right; the greedy tokens equal the
    reference engine's."""
    ecfg = dict(max_batch=4, max_seq=128)
    jcfg = _cfg(jget_config, arch, **FAMILIES[arch])
    tcfg = _cfg(get_config, arch, **FAMILIES[arch])
    jeng = J.ServingEngine(jcfg, J.EngineConfig(**ecfg), seed=0,
                           clock=J.VirtualClock())
    jreqs = _serve(jeng, J.Request, J.SamplingParams)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               "cpu")
    teng = T.ServingEngine(tcfg, T.EngineConfig(**ecfg), params=params,
                           clock=T.VirtualClock(), device="cpu")
    ex = teng.executor
    first = step_graphs.addresses(ex.cache)
    seen = []
    decode = ex.decode

    def watched(tokens):
        out = decode(tokens)
        seen.append(step_graphs.addresses(ex.cache))
        return out
    ex.decode = watched
    treqs = _serve(teng, T.Request, T.SamplingParams)
    assert len(seen) >= 5 and all(s == first for s in seen)
    assert len(ex.graphs.keys["decode"]) == 1
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
    assert all(len(r.output_tokens) == 6 for r in treqs)


def test_adopt_keeps_the_input_storage():
    """A step that returns fresh state tensors has them copied into the
    cache it was given, field by field (named tuples, dataclasses)."""
    from repro_torch.models.mamba import MambaState
    old = {"s": MambaState(torch.zeros(2, 3), torch.zeros(4)),
           "k": torch.zeros(2)}
    same = old["k"]
    new = {"s": MambaState(torch.ones(2, 3), torch.full((4,), 2.0)),
           "k": same}
    ptrs = step_graphs.addresses(old)
    step_graphs.adopt(old, new)
    assert step_graphs.addresses(old) == ptrs
    assert old["s"].ssm.eq(1).all() and old["s"].conv.eq(2).all()
    assert old["k"] is same


def test_eager_context_restores():
    assert not step_graphs._EAGER[0]
    with step_graphs.eager():
        assert step_graphs._EAGER[0]
        with step_graphs.eager():
            pass
        assert step_graphs._EAGER[0]
    assert not step_graphs._EAGER[0]
    assert not step_graphs.StepGraphs("cpu").enabled
