"""The decoder family's prefill variants over static buffers
(``repro_torch/serving/executor.py``: ``prefill``, ``prefill_chunk``,
``prefill_chunk_paged``, ``copy_blocks``), the counterpart of the
reference's per-shape compiled prefill (``src/repro/serving/executor.py``
``_jit_prefill`` / ``_jit_chunk`` / ``_jit_paged_chunk`` / ``_jit_copy``).

On the CPU a variant runs eagerly over the same static buffers a CUDA
graph reads on the card (the card's tests hold the graphs themselves,
``tests/test_torch_cuda.py``), so these hold:

* ``start`` as device data: ``write_chunk``, ``paged_write_chunk`` and
  ``chunk_attention`` with a 0-d tensor ``start`` are bitwise the int
  path and the pre-tensor slice write, and match the reference's under
  ``jax.jit`` with a traced ``start`` (the clamp edge included);
* staging changes nothing: whole prefill into any slot, dense chunks of
  two interleaved requests (each request's staging bitwise at every
  chunk), paged chunks after a prefix hit and copy-on-write copies are
  bitwise the calls as they ran before the static buffers;
* keys: one per distinct prompt or chunk length (or number of copy
  pairs), the same across slots, requests and ``start`` values;
  alternating lengths keep both; a resize drops all;
* a chunked dense engine and a paged engine whose prompts repeat their
  chunk lengths give the JAX engine's tokens, token times and
  fingerprint.

Reduced configs in float32, one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serving as J
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import kv_cache as jkvc
from repro_torch import serving as T
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.elastic import ServerPool
from repro_torch.models import attention as attn
from repro_torch.models import kv_cache as kvc
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


def _close(t: torch.Tensor, j, tol: float = 1e-5) -> None:
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


# ------------------------------------------------- start as device data

SLOTS, CHUNK = 16, 5


@pytest.mark.parametrize("start", [0, 6, 11, 14])
def test_write_chunk_tensor_start(start):
    """A 0-d tensor ``start`` writes bitwise what an int does and what the
    slice write did before it (``at = max(0, min(start, slots - chunk))``,
    length ``start + chunk``), and what the reference's ``write_chunk``
    writes under ``jax.jit`` with ``start`` traced; 14 > 16 - 5 is the
    clamp edge."""
    rng = np.random.default_rng(start)
    k0 = rng.normal(size=(2, SLOTS, 2, 8)).astype(np.float32)
    new = rng.normal(size=(2, CHUNK, 2, 8)).astype(np.float32)
    length = np.array([3, 7], np.int32)

    def port(s):
        c = kvc.KVCache(torch.tensor(k0), torch.tensor(-k0),
                        torch.tensor(length))
        return kvc.write_chunk(c, torch.tensor(new), torch.tensor(2 * new), s)
    by_int, by_tensor = port(start), port(torch.tensor(start))
    slice_k, slice_v = torch.tensor(k0), torch.tensor(-k0)
    at = max(0, min(start, SLOTS - CHUNK))
    slice_k[:, at:at + CHUNK] = torch.tensor(new)
    slice_v[:, at:at + CHUNK] = torch.tensor(2 * new)
    for c in (by_int, by_tensor):
        assert torch.equal(c.k, slice_k) and torch.equal(c.v, slice_v)
        assert c.length.tolist() == [start + CHUNK] * 2
        assert c.length.dtype == torch.int32
    jc = jax.jit(jkvc.write_chunk)(
        jkvc.KVCache(jnp.asarray(k0), jnp.asarray(-k0), jnp.asarray(length)),
        jnp.asarray(new), jnp.asarray(2 * new), jnp.int32(start))
    _close(by_tensor.k, jc.k)
    _close(by_tensor.v, jc.v)
    np.testing.assert_array_equal(by_tensor.length.numpy(),
                                  np.asarray(jc.length))


@pytest.mark.parametrize("start", [0, 3, 6])
def test_paged_write_chunk_tensor_start(start):
    """Through a block table (blocks of 4, a row of 3): a tensor ``start``
    is bitwise the int, the lengths the executor uploaded stay as they
    were, and the reference's ``paged_write_chunk`` under ``jax.jit``
    with ``start`` traced writes the same pool."""
    rng = np.random.default_rng(10 + start)
    pool = rng.normal(size=(7, 4, 2, 8)).astype(np.float32)
    new = rng.normal(size=(1, 6, 2, 8)).astype(np.float32)
    row = np.array([[3, 5, 1]], np.int32)
    lengths = np.array([start], np.int32)

    def port(s):
        c = kvc.PagedKVCache(torch.tensor(pool), torch.tensor(-pool),
                             torch.tensor(row), torch.tensor(lengths))
        out = kvc.paged_write_chunk(c, torch.tensor(new),
                                    torch.tensor(2 * new), s)
        assert c.length.tolist() == [start]
        return out
    by_int, by_tensor = port(start), port(torch.tensor(start))
    for a, b in ((by_int.k, by_tensor.k), (by_int.v, by_tensor.v),
                 (by_int.length, by_tensor.length)):
        assert torch.equal(a, b)
    assert by_tensor.length.tolist() == [start + 6]
    jc = jax.jit(jkvc.paged_write_chunk)(
        jkvc.PagedKVCache(jnp.asarray(pool), jnp.asarray(-pool),
                          jnp.asarray(row), jnp.asarray(lengths),
                          block_size=4),
        jnp.asarray(new), jnp.asarray(2 * new), jnp.int32(start))
    _close(by_tensor.k, jc.k)
    _close(by_tensor.v, jc.v)
    np.testing.assert_array_equal(by_tensor.length.numpy(),
                                  np.asarray(jc.length))


def _attention_params(cfg, rng):
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    return {name: (rng.normal(size=shape) / np.sqrt(shape[0]))
            .astype(np.float32)
            for name, shape in (("wq", (d, h * hd)), ("wk", (d, kv * hd)),
                                ("wv", (d, kv * hd)), ("wo", (h * hd, d)))}


@pytest.mark.parametrize("arch", ["deepseek-r1", "qwen2-vl-2b"])
@pytest.mark.parametrize("paged", [False, True])
def test_chunk_attention_tensor_start(arch, paged):
    """A chunk at ``start`` 8 over a cache holding positions [0, 8)
    (qwen2-vl-2b: M-RoPE, rotated as text): a 0-d tensor ``start`` gives
    the int's output and cache bitwise, and the reference's
    ``chunk_attention`` under ``jax.jit`` with its positions traced from
    ``start`` gives the same output and cache at 1e-5."""
    cfg = _cfg(arch=arch)
    rng = np.random.default_rng(3)
    p = _attention_params(cfg, rng)
    kvh, hd, start, C = cfg.num_kv_heads, cfg.head_dim, 8, 6
    x = rng.normal(size=(1, C, cfg.d_model)).astype(np.float32)
    if paged:
        store = rng.normal(size=(6, 4, kvh, hd)).astype(np.float32)
        row = np.array([[2, 4, 1, 5, 3]], np.int32)
    else:
        store = np.zeros((1, 24, kvh, hd), np.float32)
        store[:, :start] = rng.normal(size=(1, start, kvh, hd))

    def port(s):
        if paged:
            c = kvc.PagedKVCache(torch.tensor(store), torch.tensor(-store),
                                 torch.tensor(row),
                                 torch.tensor([start], dtype=torch.int32))
        else:
            c = kvc.KVCache(torch.tensor(store), torch.tensor(-store),
                            torch.tensor([start], dtype=torch.int32))
        return attn.chunk_attention({k: torch.tensor(v) for k, v in p.items()},
                                    cfg, torch.tensor(x), c, s)
    (o_int, c_int), (o_t, c_t) = port(start), port(torch.tensor(start))
    assert torch.equal(o_int, o_t)
    for a, b in ((c_int.k, c_t.k), (c_int.v, c_t.v),
                 (c_int.length, c_t.length)):
        assert torch.equal(a, b)
    jcfg = _cfg(jget_config, arch)
    if paged:
        jc = jkvc.PagedKVCache(jnp.asarray(store), jnp.asarray(-store),
                               jnp.asarray(row),
                               jnp.asarray([start], jnp.int32), block_size=4)
    else:
        jc = jkvc.KVCache(jnp.asarray(store), jnp.asarray(-store),
                          jnp.asarray([start], jnp.int32))

    @jax.jit
    def ref(params, x, cache, s):
        return jattn.chunk_attention(params, jcfg, x, cache,
                                     s + jnp.arange(C, dtype=jnp.int32))
    jo, jcache = ref({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), jc, jnp.int32(start))
    _close(o_t, jo)
    _close(c_t.k, jcache.k)
    _close(c_t.v, jcache.v)
    np.testing.assert_array_equal(c_t.length.numpy(),
                                  np.asarray(jcache.length))


# ------------------------------------------------- staging changes nothing

B, SEQ, BS = 4, 32, 8


def _executor(kv_mode, params=None, pool=None):
    cfg = _cfg()
    pool = pool or ServerPool(cfg, 4, tokens_per_client=SEQ)
    model = build_model(cfg, 4, pool.redundant_table, "cpu")
    if params is None:
        params = model.init_params(torch.Generator().manual_seed(0))
    return Executor(model, params, pool, max_batch=B, max_seq=SEQ,
                    device="cpu", kv_mode=kv_mode, kv_block_size=BS,
                    kv_num_blocks=B * SEQ // BS + 1 if kv_mode == "paged"
                    else 0)


def _twins(kv_mode):
    """The executor under test and one that runs the calls as they ran
    before the static buffers, on the same weights and pool."""
    ex = _executor(kv_mode)
    return ex, _executor(kv_mode, params=ex.params, pool=ex.pool)


def _ctx(ex):
    return ParallelCtx(moe_runtime=ex.pool.runtime("cpu"))


def _tok(a):
    return torch.as_tensor(np.asarray(a, np.int64))[None]


def _old_slot_write(big, one, slot: int) -> None:
    if big.shape == one.shape:
        big.copy_(one)
        return
    for axis, (db, do) in enumerate(zip(big.shape, one.shape)):
        if db != do and do == 1:
            big.narrow(axis, slot, 1).copy_(one)
            return


def _commit_before(ex, slot, one):
    for big, small in zip(step_graphs.tensors(ex.cache),
                          step_graphs.tensors(one)):
        _old_slot_write(big, small, slot)


def _prefill_before(ex, slot, prompt):
    logits, one, stats = ex.model.prefill(ex.params, _tok(prompt), _ctx(ex),
                                          max_slots=SEQ)
    _commit_before(ex, slot, one)
    ex._tally(stats)
    return logits, stats.expert_load


def _chunk_before(ex, staging, slot, chunk, start, is_first, is_last):
    if is_first:
        staging[slot] = ex.model.init_cache(1, SEQ)
    logits, _, stats = ex.model.prefill_chunk(ex.params, _tok(chunk),
                                              staging[slot], start, _ctx(ex))
    if is_last:
        _commit_before(ex, slot, staging.pop(slot))
    ex._tally(stats)
    return logits, stats.expert_load


def _paged_before(ex, chunk, start, row):
    t = torch.as_tensor(np.asarray(row, np.int32))[None]
    n = torch.tensor([start], dtype=torch.int32)
    view = {name: kvc.PagedKVCache(c.k, c.v, t, n)
            for name, c in ex.cache.items()}
    logits, _, stats = ex.model.prefill_chunk(ex.params, _tok(chunk), view,
                                              start, _ctx(ex))
    ex._tally(stats)
    return logits, stats.expert_load


def _copy_before(ex, pairs):
    src = torch.as_tensor([s for s, _ in pairs])
    dst = torch.as_tensor([d for _, d in pairs])
    for c in ex.cache.values():
        kvc.copy_blocks(c, src, dst, stacked=True)


def _same(ex, old, got=(), want=()):
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    for a, b in zip(step_graphs.tensors(ex.cache),
                    step_graphs.tensors(old.cache)):
        assert torch.equal(a, b)
    assert torch.equal(ex.dropped, old.dropped)
    assert torch.equal(ex.miss, old.miss)


def _shapes(ex, name):
    return [shape for _, shape in ex.graphs.keys.get(name, ())]


def test_whole_prefill_staging_changes_nothing():
    """Whole prompts into slots 0, 2, 1 and 3 (lengths 7, 7, 5, 7), a
    decode step between two of them: logits, expert loads, every cache
    leaf and the drop / miss totals bitwise the call as it ran before
    (a fresh token tensor, the batch-1 cache written at a host slot); one
    key per length whatever the slot."""
    ex, old = _twins("dense")
    rng = np.random.default_rng(5)
    V = ex.model.cfg.vocab_size
    for i, (slot, n) in enumerate(((0, 7), (2, 7), (1, 5), (3, 7))):
        prompt = rng.integers(0, V, n)
        got = (ex.prefill(slot, prompt),)
        want = (_prefill_before(old, slot, prompt)[0],)
        _same(ex, old, got, want)
        if i == 1:
            tokens = rng.integers(0, V, (B, 1))
            _same(ex, old, ex.decode(tokens), old.decode(tokens))
    assert _shapes(ex, "prefill") == [(7,), (5,)]
    assert len({key for key, _ in ex.graphs.keys["prefill"]}) == 1


def _staging_of(ex, slot):
    return ex._stage if ex._stage_slot == slot else ex._parked[slot]


def test_dense_chunks_interleaved_staging_changes_nothing():
    """Two requests chunked by 8 (slot 1: 20 tokens, 8 + 8 + 4; slot 3:
    13 tokens, 8 + 5) whose chunks interleave, with a decode step between
    two of them, then a third (slot 0, 16 tokens, 8 + 8): every call's
    logits and load, the batch cache, the drop / miss totals and each
    unfinished request's staging bitwise the per-slot fresh staging as it
    ran before; one key per chunk length (8, 5, 4) whatever the slot and
    ``start``."""
    ex, old = _twins("dense")
    rng = np.random.default_rng(6)
    V = ex.model.cfg.vocab_size
    prompts = {1: rng.integers(0, V, 20), 3: rng.integers(0, V, 13),
               0: rng.integers(0, V, 16)}
    plan = [(1, 0, 8), (3, 0, 8), (1, 8, 16), "decode", (3, 8, 13),
            (1, 16, 20), (0, 0, 8), (0, 8, 16)]
    staging = {}
    for step in plan:
        if step == "decode":
            tokens = rng.integers(0, V, (B, 1))
            _same(ex, old, ex.decode(tokens), old.decode(tokens))
            continue
        slot, lo, hi = step
        first, last = lo == 0, hi == len(prompts[slot])
        chunk = prompts[slot][lo:hi]
        got = ex.prefill_chunk(slot, chunk, lo, is_first=first,
                               is_last=last)
        want = _chunk_before(old, staging, slot, chunk, lo, first, last)
        _same(ex, old, got, want)
        for s, one in staging.items():
            for a, b in zip(step_graphs.tensors(_staging_of(ex, s)),
                            step_graphs.tensors(one)):
                assert torch.equal(a, b), (step, s)
    assert _shapes(ex, "prefill_chunk") == [(8,), (5,), (4,)]
    assert len({key for key, _ in ex.graphs.keys["prefill_chunk"]}) == 1
    stage = step_graphs.addresses(ex._stage)
    ex.prefill_chunk(2, prompts[0][:8], 0, is_first=True, is_last=False)
    assert step_graphs.addresses(ex._stage) == stage
    assert _shapes(ex, "prefill_chunk") == [(8,), (5,), (4,)]


def _rows():
    per = SEQ // BS
    return np.arange(1, B * per + 1, dtype=np.int32).reshape(B, per)


def test_paged_chunks_and_copies_staging_changes_nothing():
    """Request A (row 0) prefilled in chunks of 8 at ``start`` 0, 8, 16;
    request B shares A's first two blocks (a prefix hit: its chunks
    start at 16, then 24) after a copy-on-write fork of A's third block
    into its own; then a two-pair copy.  Logits, loads, the pools and the
    totals bitwise the calls with fresh tensors; one key per chunk
    length and per number of copy pairs."""
    ex, old = _twins("paged")
    rng = np.random.default_rng(7)
    V = ex.model.cfg.vocab_size
    a_row = _rows()[0]
    b_row = np.concatenate([a_row[:2], _rows()[1][2:]])
    a, b = rng.integers(0, V, 24), rng.integers(0, V, 32)
    for lo in (0, 8, 16):
        _same(ex, old, ex.prefill_chunk_paged(a[lo:lo + 8], lo, a_row),
              _paged_before(old, a[lo:lo + 8], lo, a_row))
    pairs = [(int(a_row[2]), int(b_row[2]))]
    ex.copy_blocks(pairs)
    _copy_before(old, pairs)
    _same(ex, old)
    for lo in (16, 24):
        _same(ex, old, ex.prefill_chunk_paged(b[lo:lo + 8], lo, b_row),
              _paged_before(old, b[lo:lo + 8], lo, b_row))
    pairs = [(int(b_row[2]), int(_rows()[2][0])),
             (int(a_row[1]), int(_rows()[2][1]))]
    ex.copy_blocks(pairs)
    _copy_before(old, pairs)
    _same(ex, old)
    assert _shapes(ex, "prefill_chunk_paged") == [(8,)]
    assert _shapes(ex, "copy_blocks") == [(1,), (2,)]


# ----------------------------------------------------------------- keys

def _engine(**kw):
    cfg = _cfg()
    return T.ServingEngine(cfg, T.EngineConfig(
        mode="eaas", num_servers=4, max_batch=4, max_seq=64, n_redundant=2,
        pool_tokens_per_client=32, prefill_chunk=8, **kw),
        seed=0, clock=T.VirtualClock(), device="cpu")


def _serve(eng, lengths, first_id=0, max_new=3):
    rng = np.random.default_rng(first_id)
    for i, n in enumerate(lengths):
        eng.submit(T.Request(first_id + i, rng.integers(0, 512, n)
                             .astype(np.int32),
                             T.SamplingParams(max_new_tokens=max_new)))
    eng.run()


@pytest.mark.parametrize("kv_mode", ["dense", "paged"])
def test_one_key_per_length_until_a_resize(kv_mode):
    """Prompts of 20, 12, 20, 12 and 6 tokens (chunks 8 + 8 + 4, 8 + 4,
    whole 6): each variant keeps one key per length side by side across
    slots, requests and ``start`` values, alternating lengths included;
    ``scale_to`` drops them all (the next calls list their keys again
    under the new structure)."""
    eng = _engine(kv_mode=kv_mode, kv_block_size=4)
    _serve(eng, [20, 12, 20, 12, 6])
    g = eng.executor.graphs
    # paged, every prompt runs the chunk path; dense, a whole prefill
    chunked, lengths = (("prefill_chunk_paged", [(8,), (4,), (6,)])
                        if kv_mode == "paged" else
                        ("prefill_chunk", [(8,), (4,)]))
    assert _shapes(eng.executor, chunked) == lengths
    if kv_mode == "dense":
        assert _shapes(eng.executor, "prefill") == [(6,)]
    structures = {name: {key for key, _ in keys}
                  for name, keys in g.keys.items()}
    assert all(len(s) == 1 for s in structures.values()), structures
    _serve(eng, [12, 20, 6], first_id=10)
    assert _shapes(eng.executor, chunked) == lengths
    eng.scale_to(2)
    _serve(eng, [20, 12], first_id=20)
    assert _shapes(eng.executor, chunked) == lengths + [(8,), (4,)]
    assert len({key for key, _ in g.keys[chunked]}) == 2
    assert g.captures == {} and g.replays == {}


# ------------------------------------------------- engines against the JAX one

def _ecfg(mod, **kw):
    return mod.EngineConfig(mode="eaas", num_servers=4, max_batch=4,
                            max_seq=64, n_redundant=2, prefill_chunk=8,
                            policy="fair", **kw)


def _scenario(mod, vocab, paged):
    """Poisson traffic, server 1 down at 0.05-0.1 s; prompts of 20 tokens
    (chunks 8 + 8 + 4), or two shared 16-token prefixes and 12-token
    suffixes (prefix hits: chunks from ``start`` 16)."""
    sc = mod.Scenario(horizon=0.2, seed=1, prompt_len=20, max_new=6,
                      vocab=vocab)
    sc.poisson(60)
    if paged:
        sc.shared_prefix(2, 16, 12)
    sc.fail(rank=1, t=0.05)
    sc.recover(rank=1, t=0.1)
    return sc


ENGINES = {"dense": dict(), "paged": dict(kv_mode="paged", kv_block_size=8)}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_engine_matches_reference(kind):
    """A chunked dense engine and a paged engine (VirtualClock, fp32)
    whose prompts repeat their chunk lengths, through a server failure:
    tokens, token times and the fingerprint equal the JAX engine's; each
    prefill variant kept one key per shape."""
    jcfg, tcfg = _cfg(jget_config), _cfg()
    kw = ENGINES[kind]
    jeng = J.ServingEngine(jcfg, _ecfg(J, **kw), seed=0,
                           clock=J.VirtualClock())
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               "cpu")
    jres = _scenario(J, jcfg.vocab_size, kind == "paged").run(jeng)
    teng = T.ServingEngine(tcfg, _ecfg(T, **kw), params=params,
                           clock=T.VirtualClock(), device="cpu")
    tres = _scenario(T, tcfg.vocab_size, kind == "paged").run(teng)
    assert tres.metrics.completed == tres.metrics.total_requests > 6
    for j, t in zip(jres.requests, tres.requests):
        assert t.output_tokens == j.output_tokens
        assert t.token_times == j.token_times
    assert tres.metrics.fingerprint() == jres.metrics.fingerprint()
    ex = teng.executor
    chunked = "prefill_chunk_paged" if kind == "paged" else "prefill_chunk"
    assert _shapes(ex, chunked) == [(8,), (4,)]
    if kind == "paged":
        assert tres.metrics.prefix_hit_blocks > 0
