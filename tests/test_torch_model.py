"""Port decoder against the JAX decoder: reduced deepseek-r1 with bridged
params, prefill logits plus 8 teacher-forced decode steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.elastic import ServerPool as JServerPool
from repro.models.transformer import ParallelCtx, build_model as jbuild
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.elastic import ServerPool
from repro_torch.models import attention, kv_cache
from repro_torch.models.transformer import ParallelCtx as TParallelCtx
from repro_torch.models.transformer import build_model

S_SERVERS, MAX_SLOTS = 4, 64


def _run_both(dtype: str):
    cfg = jget_config("deepseek-r1").reduced().replace(dtype=dtype)
    tcfg = get_config("deepseek-r1").reduced().replace(dtype=dtype)
    jpool = JServerPool(cfg, S_SERVERS, tokens_per_client=48, n_redundant=2)
    tpool = ServerPool(tcfg, S_SERVERS, tokens_per_client=48, n_redundant=2)
    jmodel = jbuild(cfg, S_SERVERS, jpool.redundant_table)
    tmodel = build_model(tcfg, S_SERVERS, tpool.redundant_table, "cpu")
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg,
                                "cpu")
    ctx = ParallelCtx(moe_runtime=jpool.runtime("xla_ragged"), remat=False)
    trt = TParallelCtx(moe_runtime=tpool.runtime("cpu"))

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 24)).astype(np.int32)
    steps = rng.integers(0, cfg.vocab_size, size=(8, 2, 1)).astype(np.int32)

    jprefill = jax.jit(lambda p, t: jmodel.prefill(p, t, ctx,
                                                   max_slots=MAX_SLOTS))
    jdecode = jax.jit(lambda p, t, c: jmodel.decode_step(p, t, c, ctx))
    jl, jc = jprefill(jparams, jnp.asarray(prompt))
    tl, tc, _ = tmodel.prefill(tparams, torch.as_tensor(prompt).long(), trt,
                               max_slots=MAX_SLOTS)
    pairs = [(tl, jl, None, None)]
    for t in range(8):
        jl, jc, jst = jdecode(jparams, jnp.asarray(steps[t]), jc)
        tl, tc, tst = tmodel.decode_step(tparams,
                                         torch.as_tensor(steps[t]).long(),
                                         tc, trt)
        pairs.append((tl, jl, tst, jst))
    return pairs, tc, jc


def test_decoder_matches_jax_float32():
    pairs, tc, jc = _run_both("float32")
    for tl, jl, tst, jst in pairs:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
        if tst is not None:
            np.testing.assert_array_equal(tst.expert_load.numpy(),
                                          np.asarray(jst.expert_load))
    for name in ("dense", "blocks"):
        np.testing.assert_allclose(tc[name].k.numpy(),
                                   np.asarray(jc[name].k), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(tc[name].length.numpy(),
                                      np.asarray(jc[name].length))


def test_decoder_matches_jax_bfloat16():
    """bf16 rounds at other places under XLA (the jitted reference keeps
    the head product in fp32, for one) than in torch, and a rounding step
    can flip a near-tie in the router's top-k, which moves a whole row.
    So the logits (std ~1 here) are held to a mean |difference| of 0.1 per
    step, and the greedy token to agree on at least 16 of the 18 rows."""
    pairs, _, _ = _run_both("bfloat16")
    agree = 0
    for tl, jl, _, _ in pairs:
        jl = np.asarray(jl)
        assert np.abs(tl.numpy() - jl).mean() <= 0.1
        agree += int((tl.numpy().argmax(-1) == jl.argmax(-1)).sum())
    assert agree >= 16


def test_append_decode_clamps_past_the_cache():
    """Idle engine slots keep decoding: the write index clamps to the last
    slot (as the reference's dynamic_update_slice does) and the length
    keeps growing, which the valid mask and the flash kernel clamp."""
    cache = kv_cache.init_kv_cache(2, 4, 1, 2, torch.float32, "cpu")
    cache.length[:] = torch.tensor([4, 1], dtype=torch.int32)
    new = torch.ones(2, 1, 1, 2)
    kv_cache.append_decode(cache, new, 2 * new)
    assert cache.length.tolist() == [5, 2]
    assert cache.k[0, 3].eq(1).all() and cache.v[1, 1].eq(2).all()
    assert kv_cache.valid_mask(cache).tolist() == [[True] * 4,
                                                   [True, True, False, False]]


def test_chunked_core_equals_dense_core():
    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 32, 4, 32, generator=g)
    k = torch.randn(1, 32, 2, 32, generator=g)
    v = torch.randn(1, 32, 2, 32, generator=g)
    pos = torch.arange(32)[None]
    dense = attention._dense_core(cfg, q, k, v, pos, pos)
    chunked = attention._chunked_core(cfg, q, k, v, pos, q_blocks=4)
    torch.testing.assert_close(chunked, dense, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("arch", ["deepseek-r1", "kimi-k2-1t-a32b"])
def test_configs_match_reference(arch):
    ref = jget_config(arch)
    port = get_config(arch)
    assert repr(port) == repr(ref)
    assert repr(port.reduced()) == repr(ref.reduced())
