"""whisper's encoder-decoder in the port against the JAX package: the
bidirectional (non-causal) attention of the encoder, cross-attention over a
prompt and against the cached encoder K/V (the plain path of
``ops.flash_decode`` on the CPU), the model's prefill with numpy frames and
with none (zeros, as the engine passes), decode steps, and the seeded
frame stand-in.  fp32 at 1e-5 (rtol and atol, as
``tests/test_kernels.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models.transformer import ParallelCtx
from repro.models.transformer import build_model as jbuild
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import attention, whisper
from repro_torch.models.transformer import build_model

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jget_config("whisper-base").reduced().replace(dtype="float32"),
            get_config("whisper-base").reduced().replace(dtype="float32"))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _attn_params(cfg, seed=0):
    jp = jattn.init_cross_attention(jax.random.PRNGKey(seed), cfg)
    return jp, jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"),
                            jp)


def _x(cfg, rng, *shape):
    return (rng.normal(size=(*shape, cfg.d_model)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("seq", [20, 32])
def test_bidirectional_attention_matches_reference(seq):
    """causal=False sees every position; causal=True does not."""
    cfg, tcfg = _cfgs()
    jp, tp = _attn_params(cfg)
    x = _x(cfg, np.random.default_rng(seq), 2, seq)
    pos = np.arange(seq)
    got = attention.full_attention(tp, tcfg, torch.as_tensor(x),
                                   torch.as_tensor(pos), causal=False)
    _close(got, jattn.full_attention(jp, cfg, jnp.asarray(x),
                                     jnp.asarray(pos, jnp.int32),
                                     causal=False))
    causal = attention.full_attention(tp, tcfg, torch.as_tensor(x),
                                      torch.as_tensor(pos))
    assert (got - causal)[:, :-1].abs().max() > 1e-3
    torch.testing.assert_close(got[:, -1], causal[:, -1], rtol=1e-5,
                               atol=1e-5)


def test_cross_attention_matches_reference():
    cfg, tcfg = _cfgs()
    jp, tp = _attn_params(cfg, 1)
    rng = np.random.default_rng(1)
    x, enc = _x(cfg, rng, 2, 7), _x(cfg, rng, 2, cfg.encoder_seq_len)
    _close(attention.cross_attention(tp, tcfg, torch.as_tensor(x),
                                     torch.as_tensor(enc)),
           jattn.cross_attention(jp, cfg, jnp.asarray(x), jnp.asarray(enc)))


@pytest.mark.parametrize("s", [1, 3])
def test_cross_attention_cached_matches_reference(s):
    """One query: the flash-decode path (its plain version on the CPU)
    with every encoder position valid; more: the plain core."""
    cfg, tcfg = _cfgs()
    jp, tp = _attn_params(cfg, 2)
    rng = np.random.default_rng(2 + s)
    x = _x(cfg, rng, 3, s)
    shape = (3, cfg.encoder_seq_len, cfg.num_kv_heads, cfg.head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want = jattn.cross_attention_cached(jp, cfg, jnp.asarray(x),
                                        jnp.asarray(k), jnp.asarray(v))
    got = attention.cross_attention_cached(tp, tcfg, torch.as_tensor(x),
                                           torch.as_tensor(k),
                                           torch.as_tensor(v))
    _close(got, want)
    if s == 1:
        lengths = torch.full((3,), cfg.encoder_seq_len, dtype=torch.int32)
        torch.testing.assert_close(
            attention.cross_attention_cached(tp, tcfg, torch.as_tensor(x),
                                             torch.as_tensor(k),
                                             torch.as_tensor(v), lengths),
            got, rtol=0, atol=0)


def _models(**kw):
    cfg, tcfg = (c.replace(**kw) for c in _cfgs())
    jm, tm = jbuild(cfg), build_model(tcfg, 1, None, "cpu")
    jp = jm.init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return cfg, jm, tm, jp, tp


@pytest.mark.parametrize("frames", [True, False])
def test_prefill_and_decode_match_reference(frames):
    """Prefill (encoder, cross K/V cache, decoder) and 8 teacher-forced
    decode steps: logits and the caches.  Without frames both packages
    encode zeros."""
    cfg, jm, tm, jp, tp = _models()
    ctx = ParallelCtx(remat=False)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, (8, 2, 1)).astype(np.int32)
    jb = tb = None
    if frames:
        f = (rng.normal(size=(2, cfg.encoder_seq_len, cfg.d_model))
             * 0.1).astype(np.float32)
        jb, tb = {"frames": jnp.asarray(f)}, {"frames": torch.as_tensor(f)}
    jl, jc = jax.jit(lambda p, t: jm.prefill(p, t, ctx, batch=jb,
                                             max_slots=48))(
        jp, jnp.asarray(prompt))
    tl, tc, st = tm.prefill(tp, torch.as_tensor(prompt).long(), None,
                            max_slots=48, batch=tb)
    _close(tl, jl)
    _close(tc["cross_k"], jc["cross_k"])
    _close(tc["cross_v"], jc["cross_v"])
    assert int(st.expert_load.sum()) == 0
    if not frames:      # zeros through the encoder stay zeros
        assert not tc["cross_k"].any()
    jdecode = jax.jit(lambda p, t, c: jm.decode_step(p, t, c, ctx)[:2])
    for t in range(8):
        jl, jc = jdecode(jp, jnp.asarray(steps[t]), jc)
        tl, tc, st = tm.decode_step(tp, torch.as_tensor(steps[t]).long(),
                                    tc, None)
        _close(tl, jl)
    _close(tc["self"].k, jc["self"].k)
    assert tc["self"].length.tolist() == np.asarray(
        jc["self"].length).tolist()
    assert int(st.expert_load.sum()) == 0


def test_cache_layout_matches_reference():
    cfg, jm, tm, _, _ = _models()
    jc, tc = jm.init_cache(3, 40), tm.init_cache(3, 40)
    assert sorted(jc) == sorted(tc)
    for name in ("cross_k", "cross_v"):
        assert tuple(tc[name].shape) == jc[name].shape == (
            cfg.num_layers, 3, cfg.encoder_seq_len, cfg.num_kv_heads,
            cfg.head_dim)
    assert tuple(tc["self"].k.shape) == jc["self"].k.shape


def test_frame_embeddings_are_seeded():
    """The frontend stand-in: (B, encoder_seq_len, d_model) fp32 at the
    reference's scale (0.1); one generator seed, one set of frames."""
    _, cfg = _cfgs()
    a = whisper.frame_embeddings(cfg, 2, torch.Generator().manual_seed(4))
    b = whisper.frame_embeddings(cfg, 2, torch.Generator().manual_seed(4))
    c = whisper.frame_embeddings(cfg, 2, torch.Generator().manual_seed(5))
    assert a.shape == (2, cfg.encoder_seq_len, cfg.d_model)
    assert a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.05 < float(a.std()) < 0.2
