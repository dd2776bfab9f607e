"""Temperature sampling against the JAX package's: the reference's streams
bit for bit (``repro_torch.kernels.sampling``, ``serving.sampling``).

* Keys: ``prng_key`` / ``fold_in`` / ``slot_key`` equal
  ``jax.random.PRNGKey`` / ``fold_in`` (seeds past int32 and negative
  ones included); a request id outside uint32 raises in both.
* Noise: the threefry bits of each row's step key over ``(V,)`` (and the
  reference's first-token ``(1, V)``), and the uniforms, bitwise
  ``jax.random``'s; the Gumbel noise within 2 ulp at its scale
  (``max(|g|, 1)``): each ``log`` is the host library's, one ulp apart
  from XLA's.
* Tokens: ``sample_batch`` equal to the reference's jitted one over 8 rows
  of mixed temperatures (greedy rows included), with every sampled row's
  top-two margin above 1e-5, so that a near tie fails loudly rather than
  pass by luck; and the first-token draw, ``sample`` over (1, V).
* Engines: the reduced float32 deepseek-r1 engine at temperature 0.8 (two
  rows greedy), lockstep and async, on the JAX engine's weights: every
  request's tokens equal the JAX engine's.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSamplingParams
from repro.serving import ServingEngine as JServingEngine
from repro.serving import VirtualClock as JVirtualClock
from repro.serving.sampling import sample as jsample
from repro.serving.sampling import sample_batch as jsample_batch
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels import sampling as S
from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                 ServingEngine, VirtualClock)
from repro_torch.serving.sampling import SlotSampler, sample_batch, slot_key
from torch_examples_cases import one_thread

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_thread)

TINY = np.finfo(np.float32).tiny


def _jkey(seed):
    with warnings.catch_warnings():      # seeds past int32 are truncated
        warnings.simplefilter("ignore")
        return jax.random.PRNGKey(seed)


def _keys(B, rng):
    """B base keys as the reference's scheduler stores them (uint32)."""
    seeds = rng.integers(0, 2 ** 31, B)
    return np.stack([np.asarray(jax.random.fold_in(_jkey(int(s)), i))
                     for i, s in enumerate(seeds)]).astype(np.uint32)


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 40 + 3,
                                  -1, -7])
def test_keys_equal_jax(seed):
    key = S.prng_key(seed)
    jk = _jkey(seed)
    assert key == tuple(int(v) for v in np.asarray(jk))
    for data in (0, 1, 77, 2 ** 32 - 1):
        want = np.asarray(jax.random.fold_in(jk, data))
        assert S.fold_in(key, data) == tuple(int(v) for v in want)
    np.testing.assert_array_equal(
        slot_key(seed, 5), np.asarray(jax.random.fold_in(jk, 5)))


def test_request_ids_outside_uint32_raise_as_in_jax():
    for rid in (-1, 2 ** 32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(_jkey(0), rid)
        with pytest.raises(OverflowError):
            slot_key(0, rid)


@pytest.mark.parametrize("V", [1, 7, 4096, 50_000])
def test_bits_and_uniforms_bitwise(V):
    rng = np.random.default_rng(V)
    keys = _keys(4, rng)
    steps = rng.integers(0, 1000, 4)
    bits = S.random_bits(torch.from_numpy(keys.astype(np.int64)),
                         torch.from_numpy(steps), V)
    u = S.uniform(bits).numpy()
    for b in range(4):
        sk = jax.random.fold_in(jnp.asarray(keys[b]), int(steps[b]))
        want = np.asarray(jax.random.bits(sk, (V,), jnp.uint32))
        np.testing.assert_array_equal(bits[b].numpy(), want)
        np.testing.assert_array_equal(
            np.asarray(jax.random.bits(sk, (1, V), jnp.uint32))[0], want)
        ju = np.asarray(jax.random.uniform(sk, (V,), jnp.float32,
                                           minval=TINY, maxval=1.0))
        np.testing.assert_array_equal(u[b].view(np.int32),
                                      ju.view(np.int32))


def test_gumbel_within_two_ulp():
    rng = np.random.default_rng(1)
    keys = _keys(4, rng)
    steps = rng.integers(0, 1000, 4)
    V = 100_000
    g = S.gumbel(S.random_bits(torch.from_numpy(keys.astype(np.int64)),
                               torch.from_numpy(steps), V)).numpy()
    for b in range(4):
        sk = jax.random.fold_in(jnp.asarray(keys[b]), int(steps[b]))
        jg = np.asarray(jax.random.gumbel(sk, (V,), jnp.float32))
        scale = np.spacing(np.maximum(np.abs(jg), 1.0).astype(np.float32))
        assert (np.abs(g[b] - jg) <= 2 * scale).all(), b
        assert np.isfinite(g[b]).all()


def _margins(logits, temps, keys, steps):
    """Each sampled row's gap between its two largest noisy values."""
    t = torch.from_numpy(temps)
    noisy = (S.gumbel(S.random_bits(torch.from_numpy(keys.astype(np.int64)),
                                    torch.from_numpy(steps.astype(np.int64)),
                                    logits.shape[1]))
             + torch.from_numpy(logits) / torch.where(t > 0, t, 1.0)[:, None])
    top = torch.topk(noisy, 2, dim=-1).values
    return (top[:, 0] - top[:, 1])[t > 0]


@pytest.mark.parametrize("V", [1000, 50_000])
def test_sample_batch_equals_the_reference(V):
    rng = np.random.default_rng(V + 3)
    B = 8
    logits = (rng.standard_normal((B, V)) * 2).astype(np.float32)
    temps = np.array([0.8, 0.0, 1.0, 0.5, -1.0, 0.8, 2.0, 0.1], np.float32)
    keys = _keys(B, rng)
    steps = rng.integers(0, 64, B).astype(np.int32)
    assert bool((_margins(logits, temps, keys, steps) > 1e-5).all())
    want = np.asarray(jsample_batch(jnp.asarray(logits), jnp.asarray(temps),
                                    jnp.asarray(keys), jnp.asarray(steps)))
    got = sample_batch(torch.from_numpy(logits), temps, keys, steps)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the greedy rows are argmax; the sampled ones mostly are not
    assert (got.numpy()[temps <= 0] == logits[temps <= 0].argmax(-1)).all()
    assert (got.numpy()[temps > 0] != logits[temps > 0].argmax(-1)).any()


@pytest.mark.parametrize("t", [0.0, 0.7])
def test_first_token_equals_the_reference_sample(t):
    """The reference's prefill draws its first token with ``sample`` over
    (1, V) and ``fold_in(slot_key, 0)``; the port with ``sample_batch`` at
    step 0."""
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((1, 3000)).astype(np.float32)
    key = slot_key(11, 4)
    want = np.asarray(jsample(jnp.asarray(logits), t, jax.random.fold_in(
        jnp.asarray(key), 0)))
    got = sample_batch(torch.from_numpy(logits), [t], key[None], [0])
    np.testing.assert_array_equal(got.numpy(), want)


def test_ops_sample_rows_are_independent():
    """A row's draw depends on its own key, step and temperature only: the
    same row alone or in a batch, at any position, is the same token."""
    rng = np.random.default_rng(9)
    B, V = 6, 2000
    logits = torch.from_numpy(rng.standard_normal((B, V)).astype(np.float32))
    temps = torch.tensor([0.9, 0.0, 1.3, 0.6, 0.9, 2.0])
    keys = torch.from_numpy(_keys(B, rng).astype(np.int64))
    steps = torch.from_numpy(rng.integers(0, 50, B))
    whole = ops.sample(logits, temps, keys, steps)
    perm = torch.tensor([3, 0, 5, 1, 4, 2])
    np.testing.assert_array_equal(
        ops.sample(logits[perm], temps[perm], keys[perm], steps[perm]),
        whole[perm])
    for b in range(B):
        s = slice(b, b + 1)
        assert int(ops.sample(logits[s], temps[s], keys[s], steps[s])) \
            == int(whole[b])


def _slots(temps, seeds, ids):
    """A scheduler's slots as :class:`SlotSampler` reads them."""
    from types import SimpleNamespace as NS
    return NS(slots=[NS(sampling=NS(temperature=t)) for t in temps],
              slot_keys=np.stack([slot_key(s, i) for s, i in zip(seeds,
                                                                 ids)]))


def test_slot_sampler_follows_admissions():
    """The engine's sampler equals ``sample_batch`` on the slots' keys and
    temperatures, in any slot order, after a slot is taken by another
    request (a new key and temperature) as before it."""
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((4, 700)).astype(
        np.float32))
    sch = _slots([0.8, 0.0, 1.5, 0.6], [1, 2, 3, 4], [10, 11, 12, 13])
    sampler = SlotSampler(4)
    for slots, steps in (([0, 1, 2, 3], [0, 3, 1, 7]), ([2, 0], [2, 1]),
                         ([3, 1, 0], [9, 4, 2])):
        want = sample_batch(logits[:len(slots)],
                            [sch.slots[b].sampling.temperature
                             for b in slots], sch.slot_keys[slots], steps)
        got = sampler(sch, logits[:len(slots)], slots, steps)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        sch.slots[slots[0]].sampling.temperature += 0.25   # re-admitted
        sch.slot_keys[slots[-1]] = slot_key(99, 5 + len(slots))


def test_all_greedy_batches_are_argmax(monkeypatch):
    """A batch with no temperature above 0 is ``torch.argmax`` (the first
    maximum, a NaN the largest) and never reaches the sampler's kernel
    route, through ``sample_batch`` and the engine's sampler alike."""
    def refuse(*a, **k):
        raise AssertionError("an all-greedy batch reached ops.sample")
    monkeypatch.setattr(ops, "sample", refuse)
    logits = torch.tensor([[0.0, 2.0, 2.0, -1.0], [1.0, float("nan"), 3.0,
                                                   float("nan")],
                           [5.0, 4.0, 5.0, 5.0]])
    want = [1, 1, 0]
    sch = _slots([0.0, -1.0, 0.0], [1, 2, 3], [4, 5, 6])
    np.testing.assert_array_equal(sample_batch(
        logits, [0.0, -1.0, 0.0], sch.slot_keys, [0, 0, 0]).numpy(), want)
    np.testing.assert_array_equal(SlotSampler(3)(
        sch, logits, [0, 1, 2], [4, 0, 2]).numpy(), want)


ENGINE = dict(mode="eaas", num_servers=4, max_batch=4, max_seq=64,
              n_redundant=2, pool_tokens_per_client=16)


def _requests(req_cls, sp_cls):
    rng = np.random.default_rng(0)
    temps = (0.8, 0.0, 0.8, 0.8, 0.0, 0.8)
    return [req_cls(i, rng.integers(0, 512, 8 + 2 * i).astype(np.int32),
                    sp_cls(max_new_tokens=8, temperature=t, seed=3 + i % 2))
            for i, t in enumerate(temps)]


@pytest.fixture(scope="module")
def engines():
    """The JAX engine's tokens per exec mode, and its weights."""
    cfg = jget_config("deepseek-r1").reduced().replace(dtype="float32")
    out, params = {}, None
    for mode in ("lockstep", "async"):
        jeng = JServingEngine(cfg, JEngineConfig(**ENGINE, exec_mode=mode),
                              seed=0, clock=JVirtualClock())
        if params is None:
            params = jax.tree.map(np.asarray, jeng.params)
        reqs = _requests(JRequest, JSamplingParams)
        for r in reqs:
            jeng.submit(r)
        jeng.run()
        out[mode] = [r.output_tokens for r in reqs]
    out["params"] = params
    return out


@pytest.mark.parametrize("mode", ["lockstep", "async"])
def test_engine_temperature_tokens_equal_the_jax_engine(engines, mode):
    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    eng = ServingEngine(cfg, EngineConfig(**ENGINE, exec_mode=mode),
                        params=params_from_numpy(engines["params"], cfg,
                                                 "cpu"),
                        clock=VirtualClock(), device="cpu")
    reqs = _requests(Request, SamplingParams)
    for r in reqs:
        eng.submit(r)
    metrics = eng.run()
    assert metrics.completed == len(reqs)
    got = [r.output_tokens for r in reqs]
    assert all(len(t) == 8 for t in got)
    assert got == engines[mode]
