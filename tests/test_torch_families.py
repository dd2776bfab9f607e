"""The rest of the decoder family in the port against the JAX package:
Arctic's dense-residual MoE, gemma3's local/global attention with ring
caches, Qwen2-VL's M-RoPE, squared-ReLU (minitron), phi3 and granite.
Reduced configs in float32 with bridged params: prefill logits plus 8
teacher-forced decode steps at 1e-5, the layers' pieces at 1e-5, and the
lockstep engine's greedy tokens and fingerprint under VirtualClock equal
to the JAX engine's; the reference's refusals for local/global raise the
same error types."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as jengine_mod
from repro.configs import get_config as jget_config
from repro.core.elastic import ServerPool as JServerPool
from repro.core.monolithic import monolithic_ep_apply as jmono_apply
from repro.core.monolithic import monolithic_runtime as jmono_runtime
from repro.core.monolithic import tp_moe_apply as jtp_apply
from repro.models import attention as jattn
from repro.models import kv_cache as jkvc
from repro.models import mlp as jmlp
from repro.models import rope as jrope
from repro.models import vlm as jvlm
from repro.models.transformer import ParallelCtx
from repro.models.transformer import _zero_stats as jzero_stats
from repro.models.transformer import build_model as jbuild
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.serving import VirtualClock as JVirtualClock
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import moe_layer
from repro_torch.core.elastic import ServerPool
from repro_torch.core.monolithic import (monolithic_ep_apply,
                                         monolithic_runtime, tp_moe_apply)
from repro_torch.models import attention, kv_cache, mlp, rope, vlm
from repro_torch.models.common import activation_fn, softcap
from repro_torch.models.transformer import ParallelCtx as TParallelCtx
from repro_torch.models.transformer import build_model
from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                 ServingEngine, VirtualClock)

NEW_ARCHS = ["arctic-480b", "gemma3-4b", "granite-3-2b", "minitron-8b",
             "phi3-medium-14b", "qwen2-vl-2b"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Reduced models run thousands of tiny ops: one intra-op thread
    spares them a thread pool's spin-waits when test workers share the
    cores (restored after the module)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **kw):
    kw.setdefault("dtype", "float32")
    return (jget_config(arch).reduced().replace(**kw),
            get_config(arch).reduced().replace(**kw))


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=0,
                               atol=tol)


# ------------------------------------------------------------- configs

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_reference(arch):
    assert repr(get_config(arch)) == repr(jget_config(arch))
    assert repr(get_config(arch).reduced()) == \
        repr(jget_config(arch).reduced())


# --------------------------------------------------- activations / MLP

@pytest.mark.parametrize("act", ["swiglu", "gelu", "relu_sq"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(0)
    p = jmlp.init_mlp(jax.random.PRNGKey(0), 32, 64, act, jnp.float32)
    x = rng.normal(size=(5, 32)).astype(np.float32)
    tp = {k: _t(v) for k, v in p.items()}
    assert sorted(tp) == sorted(
        mlp.init_mlp(32, 64, act, torch.float32, "cpu",
                     torch.Generator().manual_seed(0)))
    _close(mlp.mlp(tp, torch.as_tensor(x), act),
           jmlp.mlp(p, jnp.asarray(x), act))


def test_activation_and_softcap_functions():
    x = np.linspace(-4, 4, 41).astype(np.float32)
    from repro.models.common import activation_fn as jact
    from repro.models.common import softcap as jsoftcap
    for name in ("gelu", "relu_sq", "swiglu"):
        _close(activation_fn(name)(torch.as_tensor(x)),
               jact(name)(jnp.asarray(x)))
    _close(softcap(torch.as_tensor(x) * 20, 30.0),
           jsoftcap(jnp.asarray(x) * 20, 30.0))
    with pytest.raises(ValueError):
        activation_fn("tanh")


# ---------------------------------------------------------------- rope

@pytest.mark.parametrize("hd,sections", [(32, (4, 6, 6)),
                                         (128, (16, 24, 24))])
def test_mrope_cos_sin_matches_reference(hd, sections):
    pos = np.random.default_rng(0).integers(0, 5000, size=(3, 2, 9))
    jc, js = jrope.mrope_cos_sin(jnp.asarray(pos, jnp.int32), hd, 1e6,
                                 sections)
    tc, ts = rope.mrope_cos_sin(torch.as_tensor(pos), hd, 1e6, sections)
    _close(tc, jc)
    _close(ts, js)
    # text positions: M-RoPE reduces to RoPE
    p = torch.arange(8)[None]
    c1, s1 = rope.rope_cos_sin(p, hd, 1e4)
    c2, s2 = rope.mrope_cos_sin(rope.text_mrope_positions(p), hd, 1e4,
                                sections)
    torch.testing.assert_close(c1, c2, rtol=1e-6, atol=0)
    torch.testing.assert_close(s1, s2, rtol=1e-6, atol=0)


@pytest.mark.parametrize("grid", [(4, 3, 5, 6), (0, 2, 2, 0), (7, 1, 8, 3)])
def test_image_mrope_positions_match_reference(grid):
    assert np.array_equal(vlm.image_mrope_positions(*grid).numpy(),
                          np.asarray(jvlm.image_mrope_positions(*grid)))


# ------------------------------------------------- attention and caches

def _attn_params(cfg):
    p = jattn.init_attention(jax.random.PRNGKey(0), cfg)
    return p, {k: _t(v) for k, v in p.items()}


def test_sliding_window_mask():
    """Mirror of the reference's: early tokens (inside everyone's window)
    agree between local and global; late ones differ; both equal the
    reference's."""
    cfg, tcfg = _cfgs("gemma3-4b")
    jp, tp = _attn_params(cfg)
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(1, 128, cfg.d_model)) * 0.1).astype(np.float32)
    pos = torch.arange(128)
    o_local = attention.full_attention(tp, tcfg, torch.as_tensor(x), pos,
                                       is_local=True)
    o_global = attention.full_attention(tp, tcfg, torch.as_tensor(x), pos)
    w = cfg.sliding_window
    torch.testing.assert_close(o_local[:, :w // 2], o_global[:, :w // 2],
                               rtol=1e-4, atol=1e-4)
    assert not torch.allclose(o_local[:, -1], o_global[:, -1])
    jpos = jnp.arange(128, dtype=jnp.int32)
    _close(o_local, jattn.full_attention(jp, cfg, jnp.asarray(x), jpos,
                                         is_local=True))
    _close(o_global, jattn.full_attention(jp, cfg, jnp.asarray(x), jpos))


def test_chunked_local_attention_matches_reference():
    """The q-block path at the chunked threshold, with the window and a
    softcap."""
    cfg, tcfg = _cfgs("gemma3-4b", attn_logit_softcap=20.0)
    jp, tp = _attn_params(cfg)
    x = (np.random.default_rng(1).normal(size=(1, 2048, cfg.d_model))
         * 0.1).astype(np.float32)
    got = attention.full_attention(tp, tcfg, torch.as_tensor(x),
                                   torch.arange(2048), is_local=True)
    _close(got, jattn.full_attention(jp, cfg, jnp.asarray(x),
                                     jnp.arange(2048, dtype=jnp.int32),
                                     is_local=True))


def test_decode_matches_full():
    """Mirror of the reference's, on the port: a decode step after a
    prefill equals the full attention's last row."""
    _, cfg = _cfgs("phi3-medium-14b")
    _, p = _attn_params(_cfgs("phi3-medium-14b")[0])
    S = 16
    x = torch.as_tensor(np.random.default_rng(0).normal(
        size=(2, S, cfg.d_model)) * 0.2, dtype=torch.float32)
    o_full, (k, v) = attention.full_attention(p, cfg, x, torch.arange(S),
                                              return_kv=True)
    cache = kv_cache.init_kv_cache(2, S + 4, cfg.num_kv_heads, cfg.head_dim,
                                   torch.float32, "cpu")
    kv_cache.write_prefill(cache, k[:, :-1], v[:, :-1])
    o_dec, _ = attention.decode_attention(p, cfg, x[:, -1:], cache)
    torch.testing.assert_close(o_dec[:, 0], o_full[:, -1], rtol=1e-4,
                               atol=1e-4)


def test_ring_buffer_window_cache():
    """Mirror of the reference's ring test, plus its valid mask and the
    write index ``length % slots``."""
    cache = kv_cache.init_kv_cache(1, 100, 2, 4, torch.float32, "cpu",
                                   window=8)
    assert cache.k.shape[1] == 8
    for t in range(20):
        k = torch.full((1, 1, 2, 4), float(t))
        kv_cache.append_decode(cache, k, k)
    assert int(cache.length[0]) == 20
    assert kv_cache.valid_mask(cache).all()
    assert sorted(set(cache.k[0, :, 0, 0].tolist())) == \
        [float(v) for v in range(12, 20)]
    assert cache.k[0, 19 % 8, 0, 0] == 19.0
    with pytest.raises(ValueError):
        kv_cache.write_chunk(cache, k, k, 0)


@pytest.mark.parametrize("seq", [5, 8, 21])
def test_ring_prefill_matches_reference(seq):
    """A prompt longer than the window keeps its trailing window at the
    ring's phase; the valid mask is the reference's."""
    rng = np.random.default_rng(seq)
    k = rng.normal(size=(2, seq, 2, 4)).astype(np.float32)
    jc = jkvc.write_prefill(jkvc.init_kv_cache(2, 100, 2, 4, jnp.float32,
                                               window=8),
                            jnp.asarray(k), jnp.asarray(-k))
    tc = kv_cache.write_prefill(
        kv_cache.init_kv_cache(2, 100, 2, 4, torch.float32, "cpu",
                               window=8), torch.as_tensor(k),
        torch.as_tensor(-k))
    _close(tc.k, jc.k, 0)
    _close(tc.v, jc.v, 0)
    assert np.array_equal(kv_cache.valid_mask(tc).numpy(),
                          np.asarray(jkvc.valid_mask(jc)))


@pytest.mark.parametrize("cap", [None, 5.0])
def test_ring_decode_matches_reference(cap):
    """Decode over a wrapped ring through the kernel's plain version
    (``min(length, slots)`` valid, slots in ring order) equals the
    reference's masked decode; with a softcap too."""
    cfg, tcfg = _cfgs("gemma3-4b", attn_logit_softcap=cap)
    jp, tp = _attn_params(cfg)
    rng = np.random.default_rng(2)
    w = cfg.sliding_window
    jc = jkvc.init_kv_cache(3, 256, cfg.num_kv_heads, cfg.head_dim,
                            jnp.float32, window=w)
    tc = kv_cache.init_kv_cache(3, 256, cfg.num_kv_heads, cfg.head_dim,
                                torch.float32, "cpu", window=w)
    kv = rng.normal(size=(2, 3, w, cfg.num_kv_heads, cfg.head_dim))
    jc = jkvc.KVCache(jnp.asarray(kv[0], jnp.float32),
                      jnp.asarray(kv[1], jnp.float32),
                      jnp.asarray([10, 64, 150], jnp.int32), window=w)
    tc.k.copy_(torch.as_tensor(kv[0]))
    tc.v.copy_(torch.as_tensor(kv[1]))
    tc.length.copy_(torch.tensor([10, 64, 150]))
    for _ in range(3):
        x = (rng.normal(size=(3, 1, cfg.d_model)) * 0.5).astype(np.float32)
        jo, jc = jattn.decode_attention(jp, cfg, jnp.asarray(x), jc,
                                        is_local=True)
        to, tc = attention.decode_attention(tp, tcfg, torch.as_tensor(x),
                                            tc)
        _close(to, jo)
    _close(tc.k, jc.k)


def test_mrope_attention_with_image_grid():
    """Full attention with an image grid's (t, h, w) ids equals the
    reference's; with text ids it equals plain RoPE's."""
    cfg, tcfg = _cfgs("qwen2-vl-2b")
    jp, tp = _attn_params(cfg)
    x = (np.random.default_rng(3).normal(size=(2, 22, cfg.d_model))
         * 0.1).astype(np.float32)
    mp = vlm.image_mrope_positions(4, 3, 4, 6)
    got = attention.full_attention(tp, tcfg, torch.as_tensor(x),
                                   torch.arange(22), mrope_positions=mp)
    _close(got, jattn.full_attention(
        jp, cfg, jnp.asarray(x), jnp.arange(22, dtype=jnp.int32),
        mrope_positions=jvlm.image_mrope_positions(4, 3, 4, 6)))
    text = attention.full_attention(tp, tcfg, torch.as_tensor(x),
                                    torch.arange(22))
    plain = attention.full_attention(tp, tcfg.replace(mrope_sections=None),
                                     torch.as_tensor(x), torch.arange(22))
    torch.testing.assert_close(text, plain, rtol=1e-5, atol=1e-5)
    assert (got - text).abs().max() > 1e-5      # the grid moved it


# ----------------------------------------------------------- MoE layer

def test_dense_residual_moe_and_baselines():
    """Arctic's layer: init has the residual FFN; EAAS, monolithic EP and
    TP outputs equal the reference's (the residual rides the combine's
    addend)."""
    cfg, tcfg = _cfgs("arctic-480b")
    p = moe_layer.init_eaas_moe(tcfg, 2, np.zeros((2, 1), np.int32),
                                torch.float32, "cpu",
                                torch.Generator().manual_seed(0))
    assert p["residual"]["w_up"].shape == (cfg.d_model, cfg.d_ff)
    assert "shared" not in p
    from repro.core.moe_layer import init_eaas_moe as jinit
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(12, cfg.d_model)) * 0.5).astype(np.float32)
    for S, apply_pair in ((2, "mono"), (1, "tp")):
        jp = jinit(jax.random.PRNGKey(S), cfg, S,
                   redundant_table=np.zeros((S, 0), np.int32))
        tp = jax.tree.map(_t, jp)
        if apply_pair == "mono":
            jrt = jmono_runtime(cfg, S, 12, "xla_ragged")
            jy, jst = jax.jit(lambda p, x: jmono_apply(p, x, cfg, jrt))(
                jp, jnp.asarray(x))
            ty, tst = monolithic_ep_apply(
                tp, torch.as_tensor(x), tcfg,
                monolithic_runtime(tcfg, S, 12, "cpu"))
        else:
            jy, jst = jax.jit(lambda p, x: jtp_apply(p, x, cfg,
                                                     "xla_ragged"))(
                jp, jnp.asarray(x))
            ty, tst = tp_moe_apply(tp, torch.as_tensor(x), tcfg)
        _close(ty, jy)
        assert np.array_equal(tst.expert_load.numpy(),
                              np.asarray(jst.expert_load))
        no_res = moe_layer.eaas_moe_apply(
            {k: v for k, v in tp.items() if k != "residual"},
            torch.as_tensor(x), tcfg.moe,
            monolithic_runtime(tcfg, S, 12, "cpu"))[0]
        assert not torch.allclose(no_res, ty, atol=1e-3)


# ------------------------------------------- the decoder, prefill + decode

def _decoder_pair(arch, **kw):
    cfg, tcfg = _cfgs(arch, **kw)
    S = 2 if cfg.moe else 1
    if cfg.moe:
        jpool = JServerPool(cfg, S, tokens_per_client=48, n_redundant=1)
        tpool = ServerPool(tcfg, S, tokens_per_client=48, n_redundant=1)
        jm = jbuild(cfg, S, jpool.redundant_table)
        tm = build_model(tcfg, S, tpool.redundant_table, "cpu")
        ctx = ParallelCtx(moe_runtime=jpool.runtime("xla_ragged"),
                          remat=False)
        trt = TParallelCtx(moe_runtime=tpool.runtime("cpu"))
    else:
        jm, tm = jbuild(cfg, 1), build_model(tcfg, 1, None, "cpu")
        ctx, trt = ParallelCtx(remat=False), None
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    return cfg, jm, tm, jparams, tparams, ctx, trt


FAMILY_CASES = {
    # name: (arch, config overrides, prompt length, image grid)
    "arctic": ("arctic-480b", {}, 24, None),
    # 10 layers: one group (5 local + 1 global) and 4 remainder locals;
    # the prompt is longer than the reduced window (64): the rings wrap
    "gemma3": ("gemma3-4b", {"num_layers": 10}, 80, None),
    "gemma3_softcap": ("gemma3-4b", {"num_layers": 6,
                                     "attn_logit_softcap": 8.0}, 70, None),
    "qwen2_vl_text": ("qwen2-vl-2b", {}, 24, None),
    "qwen2_vl_image": ("qwen2-vl-2b", {}, 24, (4, 3, 4)),
    "minitron": ("minitron-8b", {}, 24, None),
    "phi3": ("phi3-medium-14b", {}, 24, None),
    "granite": ("granite-3-2b", {}, 24, None),
}


@pytest.mark.parametrize("case", sorted(FAMILY_CASES))
def test_prefill_and_decode_match_reference(case):
    arch, kw, plen, grid = FAMILY_CASES[case]
    cfg, jm, tm, jparams, tparams, ctx, trt = _decoder_pair(arch, **kw)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, plen)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(8, 2, 1)).astype(np.int32)
    jb = tb = None
    if grid is not None:
        t0, gh, gw = grid
        after = plen - t0 - gh * gw
        jb = {"mrope_positions": jvlm.image_mrope_positions(t0, gh, gw,
                                                            after)}
        tb = {"mrope_positions": vlm.image_mrope_positions(t0, gh, gw,
                                                           after)}
    jprefill = jax.jit(lambda p, t: jm.prefill(p, t, ctx, batch=jb,
                                               max_slots=96))
    jdecode = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, ctx)[:2])
    jl, jc = jprefill(jparams, jnp.asarray(prompt))
    tl, tc, _ = tm.prefill(tparams, torch.as_tensor(prompt).long(), trt,
                           max_slots=96, batch=tb)
    _close(tl, jl)
    for t in range(8):
        jl, jc = jdecode(jparams, jnp.asarray(steps[t]), jc)
        tl, tc, _ = tm.decode_step(tparams, torch.as_tensor(steps[t]).long(),
                                   tc, trt)
        _close(tl, jl)
    if cfg.local_global_pattern:
        pat = cfg.local_global_pattern
        assert tc["local"].k.shape[2] == cfg.sliding_window       # rings
        assert tc["global"].k.shape[2] == 96
        _close(tc["local"].k.reshape(jc["local"].k.shape), jc["local"].k)
        _close(tc["global"].k, jc["global"].k)
        if "rem" in jc:
            _close(tc["rem"].k, jc["rem"].k)
        assert tc["local"].k.shape[0] == pat * (cfg.num_layers // (pat + 1))


# ------------------------------------------------------------- engines

ENGINE = dict(mode="eaas", num_servers=4, max_batch=4, max_seq=128,
              n_redundant=2, pool_tokens_per_client=16, prefill_chunk=32)


@pytest.fixture()
def jax_local_global_stats(monkeypatch):
    """The reference's local/global ``decode_step`` returns stats None,
    which its engine's decode reads (``st.expert_load``: AttributeError,
    ROADMAP Queue 3).  Test-side only, the engine's model is wrapped to
    return the zero stats its dense decoder returns, so the reference's
    engine can serve gemma3 for the comparison."""
    orig = jengine_mod.build_model

    def build(cfg, **kw):
        m = orig(cfg, **kw)
        if not cfg.local_global_pattern:
            return m

        def decode_step(*a, **k):
            logits, cache, st = m.decode_step(*a, **k)
            return logits, cache, jzero_stats(cfg) if st is None else st
        return m._replace(decode_step=decode_step)
    monkeypatch.setattr(jengine_mod, "build_model", build)


def _serve(eng, req_cls, sp_cls):
    rng = np.random.default_rng(0)
    reqs = [req_cls(i, rng.integers(0, 512, size=70 + 5 * i)
                    .astype(np.int32), sp_cls(max_new_tokens=6))
            for i in range(3)]
    for r in reqs:
        eng.submit(r)

    def on_step(e):
        if e.pool is not None and e.step_idx == 4:
            e.inject_server_failure(1)
        if e.pool is not None and e.step_idx == 7:
            e.recover_server(1)
    return reqs, eng.run(on_step=on_step)


@pytest.mark.parametrize("arch,layers", [("arctic-480b", None),
                                         ("gemma3-4b", 10)])
def test_engine_matches_reference(arch, layers, jax_local_global_stats):
    """Lockstep engine, dense KV, VirtualClock: the same greedy tokens and
    fingerprint.  Arctic prefills in chunks of 32 through a server
    failure; gemma3 prefills whole prompts (70-80 tokens: its 64-slot
    rings wrap), as the reference's engine does for a family without
    chunked prefill."""
    kw = {"num_layers": layers} if layers else {}
    cfg, tcfg = _cfgs(arch, **kw)
    jeng = JServingEngine(cfg, JEngineConfig(**ENGINE), seed=0,
                          clock=JVirtualClock())
    jreqs, jm = _serve(jeng, JRequest, JSamplingParams)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               "cpu")
    teng = ServingEngine(tcfg, EngineConfig(**ENGINE), params=params,
                         clock=VirtualClock(), device="cpu")
    treqs, tm = _serve(teng, Request, SamplingParams)
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
    assert all(len(r.output_tokens) == 6 for r in treqs)
    assert tm.fingerprint() == jm.fingerprint()
    assert (teng.pool is None) == (cfg.moe is None)
    assert teng.scheduler.cfg.prefill_chunk == \
        jeng.scheduler.cfg.prefill_chunk


def test_reference_local_global_decode_fault():
    """Unwrapped, the reference's engine cannot decode gemma3 (its
    local/global decode_step returns no stats); the port's returns zero
    stats and serves (``test_engine_matches_reference``)."""
    cfg, _ = _cfgs("gemma3-4b", num_layers=6)
    eng = JServingEngine(cfg, JEngineConfig(**ENGINE), seed=0,
                         clock=JVirtualClock())
    eng.submit(JRequest(0, np.arange(10, dtype=np.int32),
                        JSamplingParams(max_new_tokens=3)))
    with pytest.raises(AttributeError):
        eng.run()


@pytest.mark.parametrize("kw", [dict(kv_mode="paged"),
                                dict(decode_mode="pipelined"),
                                dict(decode_mode="serialized"),
                                dict(exec_mode="async")])
def test_local_global_refusals_match_reference(kw):
    """Paged KV, split decode and the async tier refuse gemma3 in both
    packages, with the same error type."""
    cfg, tcfg = _cfgs("gemma3-4b", num_layers=6)
    ecfg = dict(ENGINE, **kw)
    with pytest.raises(Exception) as jerr:
        JServingEngine(cfg, JEngineConfig(**ecfg), seed=0,
                       clock=JVirtualClock())
    with pytest.raises(Exception) as terr:
        ServingEngine(tcfg, EngineConfig(**ecfg), clock=VirtualClock(),
                      device="cpu")
    assert type(terr.value) is type(jerr.value) is ValueError


def test_patch_embeddings_stub_is_seeded():
    """The ViT patch-embedding stand-in: (B, n, d_model) fp32 at the
    reference's scale (0.1), the same draw from the same seed."""
    _, cfg = _cfgs("qwen2-vl-2b")
    a = vlm.patch_embeddings(cfg, 2, 12, torch.Generator().manual_seed(5))
    b = vlm.patch_embeddings(cfg, 2, 12, torch.Generator().manual_seed(5))
    assert a.shape == (2, 12, cfg.d_model) and a.dtype == torch.float32
    assert torch.equal(a, b) and 0.05 < float(a.std()) < 0.2
