"""Every family's prefill compiled as the reference compiles it
(``src/repro/serving/executor.py``: ``_jit_prefill``, one executable per
prompt length, whose recurrences are ``lax.scan`` bodies compiled once):

* gemma3's and whisper's whole-prompt prefill is a step variant of the
  executor, one graph per prompt length (``Model.prefill_per_shape``),
  the slot as data;
* rwkv6's wkv recurrence and zamba2's SSD carry run through
  ``models/common.py::compiled_scan``: a body of 64 steps and one of a
  step over static buffers, captured once on the card and replayed.

On the CPU a variant and a scan body run eagerly over the same static
buffers a CUDA graph reads on the card (the card's tests hold the graphs
themselves, ``tests/test_torch_cuda.py``), so these hold:

* the scan's staging is bitwise the plain loops (``rwkv._wkv_loop``,
  ``mamba._carry_loop``) at every length around the 64-step block, and
  ``eager()``, autograd and ``meta`` take the plain loop;
* ``tmix_forward`` and ``_ssd_chunked`` through the staging match the
  reference's at 1e-5;
* keys: one per prompt length for gemma3 and whisper, the same across
  slots; none for zamba2 and rwkv6, whose prefill stays eager;
* reduced gemma3, whisper, zamba2 and rwkv6 engines whose prompt lengths
  repeat give the JAX engine's tokens and fingerprint.

Reduced configs in float32, one torch thread.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving.engine as jengine_mod
from repro.configs import get_config as jget_config
from repro.models import mamba as jmamba
from repro.models import rwkv as jrwkv
from repro.models.transformer import _zero_stats as jzero_stats
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.serving import VirtualClock as JVirtualClock
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import build
from repro_torch.models import common, mamba, rwkv
from repro_torch.models.transformer import build_model
from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                 ServingEngine, VirtualClock, step_graphs)
from repro_torch.serving.executor import Executor

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Reduced engines run thousands of tiny ops: one intra-op thread
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


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _names():
    return sorted({sig[0] for sig in common._SCANS})


# ------------------------------------------- the scan's staging is the loop

def _wkv_inputs(rng, B, L, H=3, D=8):
    r, k, v = (torch.as_tensor(rng.normal(size=(B, L, H, D))
                               .astype(np.float32)) for _ in range(3))
    w = torch.as_tensor(rng.uniform(0.5, 1.0, (B, L, H, D))
                        .astype(np.float32))
    u = torch.as_tensor(rng.normal(size=(H, D)).astype(np.float32))
    S = torch.as_tensor((rng.normal(size=(B, H, D, D)) * 0.2)
                        .astype(np.float32))
    return r, k, v, w, u, S


@pytest.mark.parametrize("L", [1, 2, 63, 64, 65, 130, 257])
def test_wkv_staging_is_the_loop(L):
    """The recurrence through ``compiled_scan`` (64-token blocks, then
    single tokens), under ``inference_mode`` and under ``no_grad``, is
    bitwise ``_wkv_loop``; the caller's state is left as it was, and the
    returned state is no static buffer."""
    common.reset_scans()
    rng = np.random.default_rng(L)
    r, k, v, w, u, S = _wkv_inputs(rng, 2, L)
    S_in = S.clone()
    y0, S0 = rwkv._wkv_loop(r, k, v, w, u, S)
    for mode in (torch.inference_mode, torch.no_grad):
        with mode():
            y, S1 = rwkv._recurrence(rwkv._wkv_loop, r, k, v, w, u, S, 64)
        assert torch.equal(y, y0) and torch.equal(S1, S0)
        assert torch.equal(S, S_in)
    scan, = common._SCANS.values()
    assert sorted(scan.bodies) == [1] * (L % 64 > 0) + [64] * (L >= 64)
    assert S1.data_ptr() != scan.carry.data_ptr()
    assert all(y.data_ptr() != o.data_ptr() for b in scan.bodies.values()
               for o in b.xs)


@pytest.mark.parametrize("nc", [1, 63, 64, 65, 131])
def test_carry_staging_is_the_loop(nc):
    """The SSD carry over ``nc`` chunks through ``compiled_scan`` is
    bitwise ``_carry_loop``: every chunk's starting state and the last."""
    common.reset_scans()
    rng = np.random.default_rng(nc)
    B, H, P, N = 2, 3, 4, 5
    decay = torch.as_tensor(rng.uniform(0.3, 1.0, (B, nc, H, 1, 1))
                            .astype(np.float32))
    dS = torch.as_tensor(rng.normal(size=(B, nc, H, P, N)).astype(np.float32))
    S = torch.as_tensor(rng.normal(size=(B, H, P, N)).astype(np.float32))
    starts0, last0 = mamba._carry_loop(decay, dS, S)
    with torch.inference_mode():
        starts, last = common.compiled_scan("ssd_carry", mamba._carry_loop,
                                            (decay, dS), (), S)
    assert torch.equal(starts, starts0) and torch.equal(last, last0)
    assert _names() == ["ssd_carry"]


def test_eager_autograd_and_meta_take_the_plain_loop():
    """Under ``eager()`` (``step_graphs.eager`` is ``build.eager``, one
    switch), where autograd records, and on ``meta``, the recurrence is
    the plain call: no static buffer is made."""
    assert step_graphs.eager is build.eager
    assert step_graphs._EAGER is build.EAGER
    common.reset_scans()
    rng = np.random.default_rng(0)
    r, k, v, w, u, S = _wkv_inputs(rng, 1, 70)
    with torch.no_grad(), step_graphs.eager():
        y, S1 = rwkv._recurrence(rwkv._wkv_loop, r, k, v, w, u, S, 64)
    y0, S0 = rwkv._wkv_loop(r, k, v, w, u, S)
    assert torch.equal(y, y0) and torch.equal(S1, S0)
    assert not common._SCANS
    rg = r.clone().requires_grad_()
    y, _ = common.compiled_scan("wkv", rwkv._wkv_loop, (rg, k, v, w), (u,),
                                S)
    assert y.grad_fn is not None and not common._SCANS
    m = [t.to("meta") for t in (r, k, v, w, u, S)]
    with torch.no_grad():
        y, S1 = common.compiled_scan("wkv", rwkv._wkv_loop, m[:4], m[4:5],
                                     m[5])
    assert y.device.type == "meta" and tuple(y.shape) == tuple(r.shape)
    assert not common._SCANS


def test_two_bodies_serve_every_layer_and_length():
    """Over layers and prompt lengths of one shape of state, the scan
    keeps one signature and its two bodies (64 steps, one step): the
    carry passes from one body to the next in place."""
    common.reset_scans()
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for L in (70, 64, 129, 5):
            for _ in range(3):                      # layers
                r, k, v, w, u, S = _wkv_inputs(rng, 1, L)
                y, S1 = rwkv._recurrence(rwkv._wkv_loop, r, k, v, w, u, S,
                                         64)
                y0, S0 = rwkv._wkv_loop(r, k, v, w, u, S)
                assert torch.equal(y, y0) and torch.equal(S1, S0)
    scan, = common._SCANS.values()
    assert sorted(scan.bodies) == [1, 64]


# ------------------------------------------------- against the reference

def _rwkv_params(cfg, seed=0):
    k1, _ = jax.random.split(jax.random.PRNGKey(seed))
    tp = jrwkv.init_rwkv_tmix(k1, cfg)
    rng = np.random.default_rng(seed)
    tp = dict(tp, bonus_u=jnp.asarray(rng.normal(size=tp["bonus_u"].shape)
                                      * 0.5, jnp.float32),
              decay_w0=jnp.asarray(rng.uniform(-3, 0, tp["decay_w0"].shape),
                                   jnp.float32))
    return tp, jax.tree.map(
        lambda a: tensor_from_numpy(np.asarray(a), "cpu"), tp)


@pytest.mark.parametrize("L", [67, 130])
def test_tmix_forward_through_the_scan_matches_reference(L):
    """``tmix_forward`` without grad (its recurrence through the staging:
    67 = 64 + 3, 130 = 2 x 64 + 2) against the reference's at 1e-5."""
    cfg, tcfg = _cfgs("rwkv6-7b")
    jt, tt = _rwkv_params(cfg)
    rng = np.random.default_rng(L)
    H, D = rwkv.dims(tcfg)
    wkv = (rng.normal(size=(2, H, D, D)) * 0.2).astype(np.float32)
    sh = [(rng.normal(size=(2, cfg.d_model)) * 0.5).astype(np.float32)
          for _ in range(2)]
    x = (rng.normal(size=(2, L, cfg.d_model)) * 0.5).astype(np.float32)
    common.reset_scans()
    with torch.inference_mode():
        ty, tS, tlast = rwkv.tmix_forward(
            tt, tcfg, torch.as_tensor(x),
            rwkv.RwkvState(*(torch.as_tensor(a) for a in (wkv, *sh))))
    assert _names() == ["wkv"]
    jy, jS, jlast = jrwkv.tmix_forward(
        jt, cfg, jnp.asarray(x),
        jrwkv.RwkvState(*(jnp.asarray(a) for a in (wkv, *sh))))
    _close(ty, jy)
    _close(tS, jS)
    _close(tlast, jlast)


@pytest.mark.parametrize("L", [131, 128])
def test_ssd_chunked_through_the_scan_matches_reference(L):
    """``_ssd_chunked`` without grad, its carry through the staging (131:
    Q = 1, 64 + 64 + 3 chunks; 128: Q = 64, two chunks) against the
    reference's at 1e-5."""
    rng = np.random.default_rng(L)
    B, H, P, N = 2, 3, 4, 5
    u = (rng.normal(size=(B, L, H, P)) * 0.3).astype(np.float32)
    logA = -rng.uniform(0.01, 0.3, size=(B, L, H)).astype(np.float32)
    Bm = (rng.normal(size=(B, L, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, L, N)) * 0.5).astype(np.float32)
    S0 = (rng.normal(size=(B, H, P, N)) * 0.3).astype(np.float32)
    common.reset_scans()
    with torch.inference_mode():
        ty, tS = mamba._ssd_chunked(*(torch.as_tensor(a) for a in
                                      (u, logA, Bm, Cm, S0)), chunk=64)
    assert _names() == ["ssd_carry"]
    jy, jS = jmamba._ssd_chunked(*(jnp.asarray(a) for a in
                                   (u, logA, Bm, Cm, S0)), chunk=64)
    _close(ty, jy)
    _close(tS, jS)


# ----------------------------------------------------------------- keys

@pytest.mark.parametrize("arch", ["gemma3-4b", "whisper-base"])
def test_one_key_per_prompt_length(arch):
    """Whole prompts of 20, 20, 30, 20 and 30 tokens into slots 0, 2, 1, 3
    and 0: one key per length whatever the slot, under one structure;
    each call's logits and the slot's cache rows bitwise the model's own
    prefill."""
    _, cfg = _cfgs(arch, num_layers=6) if arch == "gemma3-4b" \
        else _cfgs(arch)
    model = build_model(cfg, 1, None, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    ex = Executor(model, params, None, max_batch=4, max_seq=64,
                  device="cpu")
    assert model.prefill_per_shape
    rng = np.random.default_rng(2)
    for slot, n in ((0, 20), (2, 20), (1, 30), (3, 20), (0, 30)):
        prompt = rng.integers(0, cfg.vocab_size, n)
        got = ex.prefill(slot, prompt)
        with torch.inference_mode():
            want, one, _ = model.prefill(
                params, torch.as_tensor(prompt[None].astype(np.int64)),
                None, max_slots=64)
        assert torch.equal(got, want)
        for big, small in zip(step_graphs.tensors(ex.cache),
                              step_graphs.tensors(one)):
            axis = next(a for a, (db, do) in enumerate(zip(big.shape,
                                                           small.shape))
                        if db != do)
            assert torch.equal(big.narrow(axis, slot, 1), small)
    assert [s for _, s in ex.graphs.keys["prefill"]] == [(20,), (30,)]
    assert len({key for key, _ in ex.graphs.keys["prefill"]}) == 1


@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-7b"])
def test_recurrent_prefill_is_not_a_step_graph(arch):
    """zamba2's and rwkv6's prefill is no per-shape variant (its loops
    are not one graph a prompt length): the executor keeps no key for it,
    and its recurrence runs through the scan's staging."""
    _, cfg = _cfgs(arch)
    model = build_model(cfg, 1, None, "cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    ex = Executor(model, params, None, max_batch=2, max_seq=128,
                  device="cpu")
    assert not model.prefill_per_shape
    common.reset_scans()
    rng = np.random.default_rng(3)
    for slot, n in ((0, 71), (1, 71)):
        ex.prefill(slot, rng.integers(0, cfg.vocab_size, n))
    assert "prefill" not in ex.graphs.keys
    assert _names() == (["ssd_carry"] if arch == "zamba2-2.7b" else ["wkv"])


# ------------------------------------------- engines against the JAX one

ENGINE = dict(max_batch=4, max_seq=128, prefill_chunk=32)
# lengths that repeat: a prime above the block (zamba2's SSD at Q = 1,
# 64 + 7 steps of the scan), a multiple of 64 and a short one
PROMPTS = (71, 40, 71, 64, 40, 71)


@pytest.fixture()
def jax_family_stats(monkeypatch):
    """The reference's gemma3, zamba2, rwkv6 and whisper ``decode_step``
    return stats None, which its engine's decode reads
    (``st.expert_load``: AttributeError, ROADMAP Queue 3).  Test-side
    only, the engine's model is wrapped to return the zero stats the dense
    decoder returns, so the reference's engine can serve them."""
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
                    sp_cls(max_new_tokens=5))
            for i, n in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    return reqs, eng.run()


@pytest.mark.parametrize("arch,layers", [("gemma3-4b", 6),
                                         ("whisper-base", None),
                                         ("zamba2-2.7b", None),
                                         ("rwkv6-7b", None)])
def test_engine_matches_reference(arch, layers, jax_family_stats):
    """Lockstep engine, dense cache, VirtualClock, fp32, prompt lengths
    that repeat: the same greedy tokens and fingerprint as the JAX
    engine's.  gemma3 and whisper keep one prefill key per length (71
    wraps gemma3's rings); zamba2 and rwkv6 none, their recurrence
    through the scan's two bodies."""
    kw = {"num_layers": layers} if layers else {}
    cfg, tcfg = _cfgs(arch, **kw)
    jeng = JServingEngine(cfg, JEngineConfig(**ENGINE), seed=0,
                          clock=JVirtualClock())
    jreqs, jm = _serve(jeng, JRequest, JSamplingParams)
    params = params_from_numpy(jax.tree.map(np.asarray, jeng.params), tcfg,
                               "cpu")
    common.reset_scans()
    teng = ServingEngine(tcfg, EngineConfig(**ENGINE), params=params,
                         clock=VirtualClock(), device="cpu")
    treqs, tm = _serve(teng, Request, SamplingParams)
    assert [r.output_tokens for r in treqs] == \
        [r.output_tokens for r in jreqs]
    assert all(len(r.output_tokens) == 5 for r in treqs)
    assert tm.fingerprint() == jm.fingerprint()
    keys = teng.executor.graphs.keys
    if teng.model.prefill_per_shape:
        assert [s for _, s in keys["prefill"]] == [(71,), (40,), (64,)]
        assert len({key for key, _ in keys["prefill"]}) == 1
        assert not common._SCANS
    else:
        assert "prefill" not in keys
        scan, = common._SCANS.values()
        assert sorted(scan.bodies) == [1, 64]
