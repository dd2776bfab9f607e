"""Port MoE client tier and expert server against the JAX package, float32,
same numpy inputs: router, lookup, pack, serve and the whole EAAS layer
(1e-5, integer outputs exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import dispatch as jdispatch
from repro.core import expert_server as jserver
from repro.core import load_balance as jlb
from repro.core import mapping as jmapping
from repro.core import moe_layer as jmoe
from repro.core import router as jrouter
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import dispatch, expert_server, load_balance, mapping
from repro_torch.core import moe_layer, router

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a) -> torch.Tensor:
    return tensor_from_numpy(np.asarray(a), "cpu")


def _eq(t: torch.Tensor, j) -> None:
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _close(t: torch.Tensor, j) -> None:
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL)


@pytest.mark.parametrize("arch", ["deepseek-r1", "kimi-k2-1t-a32b"])
def test_router_matches_jax(arch, rng):
    m = get_config(arch).reduced().moe
    x = rng.normal(size=(40, 128)).astype(np.float32)
    w = (rng.normal(size=(128, m.num_experts)) * 0.02).astype(np.float32)
    exp = jrouter.route({"w_router": jnp.asarray(w)}, jnp.asarray(x), m)
    got = router.route({"w_router": _t(w)}, _t(x), m)
    _eq(got.expert_ids, exp.expert_ids)
    for name in ("scores", "full_probs", "aux_loss", "z_loss"):
        _close(getattr(got, name), getattr(exp, name))


def test_top_k_breaks_ties_toward_lower_index():
    probs = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    exp = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)[1]
    _eq(router.top_k(probs, 3)[1], exp)


def test_planner_copy_matches_jax(rng):
    load = rng.random(16) * 10
    for S, n_red in ((4, 2), (8, 1)):
        np.testing.assert_array_equal(
            np.concatenate(load_balance.eplb_plan(load, S, n_red), axis=None),
            np.concatenate(jlb.eplb_plan(load, S, n_red), axis=None))
    np.testing.assert_array_equal(load_balance.primary_owner(10, 4),
                                  jlb.primary_owner(10, 4))


def test_lookup_with_dead_server(rng):
    E, S = 16, 4
    table, _ = jlb.eplb_plan(rng.random(E), S, n_redundant=3)
    alive = np.array([True, False, True, True])
    ids = rng.integers(0, E, size=(30, 4)).astype(np.int32)
    salt = (np.arange(30)[:, None] + np.arange(4)[None, :]).astype(np.int32)
    exp = jmapping.lookup(jnp.asarray(table), jnp.asarray(alive),
                          jnp.asarray(ids), jnp.asarray(salt))
    got = mapping.lookup(torch.as_tensor(table).long(),
                         torch.as_tensor(alive), torch.as_tensor(ids).long(),
                         torch.as_tensor(salt).long())
    _eq(got, exp)
    assert not (got == 1).any()


@pytest.mark.parametrize("method", ["onehot", "sort"])
@pytest.mark.parametrize("capacity", [6, 64])      # 6 drops tokens
def test_pack_buffers_identical(method, capacity, rng):
    T, k, S, d = 20, 2, 4, 8
    x = rng.normal(size=(T, d)).astype(np.float32)
    eids = rng.integers(0, 16, size=(T, k)).astype(np.int32)
    scores = rng.random(size=(T, k)).astype(np.float32)
    sids = rng.integers(0, S, size=(T, k)).astype(np.int32)
    exp = jdispatch.pack(jnp.asarray(x), jnp.asarray(eids),
                         jnp.asarray(scores), jnp.asarray(sids), S, capacity,
                         method=method)
    got = dispatch.pack(_t(x), torch.as_tensor(eids).long(), _t(scores),
                        torch.as_tensor(sids).long(), S, capacity,
                        method=method)
    for name in exp._fields:
        _eq(getattr(got, name), getattr(exp, name))
    if capacity == 6:
        assert int(got.dropped) > 0


def test_serve_outputs_and_stats(rng):
    E, S, d, f, C = 8, 2, 16, 24, 12
    red = np.array([[5, -1], [0, 1]], np.int32)
    bank = {k: (rng.normal(size=shape) * 0.2).astype(np.float32)
            for k, shape in (("w_gate", (E, d, f)), ("w_up", (E, d, f)),
                             ("w_down", (E, f, d)))}
    jw = jserver.build_server_weights(
        {k: jnp.asarray(v) for k, v in bank.items()}, S, red)
    tw = expert_server.build_server_weights(
        {k: _t(v) for k, v in bank.items()}, S, red)
    for k in jw:
        _eq(tw[k], jw[k])
    jtab = jserver.make_local_table(E, S, red)
    np.testing.assert_array_equal(expert_server.make_local_table(E, S, red),
                                  jtab)
    tokens = rng.normal(size=(2, C, d)).astype(np.float32)
    eids = rng.integers(-1, E, size=(2, C)).astype(np.int32)
    scores = rng.random(size=(2, C)).astype(np.float32)
    counts = np.array([9, 12], np.int32)
    s = 0                                  # hosts 0-3 + 5: 4, 6, 7 miss
    exp, jst = jserver.serve(
        jnp.asarray(tokens), jnp.asarray(eids), jnp.asarray(scores),
        jnp.asarray(counts),
        jserver.ServerWeights(jw["w_gate"][s], jw["w_up"][s],
                              jw["w_down"][s], jnp.asarray(jtab[s])),
        impl="xla_ragged")
    got, tst = expert_server.serve(
        _t(tokens), torch.as_tensor(eids).long(), _t(scores),
        torch.as_tensor(counts).long(),
        expert_server.ServerWeights(tw["w_gate"][s], tw["w_up"][s],
                                    tw["w_down"][s],
                                    torch.as_tensor(jtab[s]).long()))
    _close(got, exp)
    assert int(tst.miss) == int(jst.miss) > 0
    assert int(tst.served) == int(jst.served)


def test_fill_redundant_matches_bank_layout(rng):
    E, S, d, f = 8, 4, 4, 6
    red = np.array([[3, 7], [0, -1], [5, 2], [-1, -1]], np.int32)
    bank = torch.as_tensor(rng.normal(size=(E, d, f)), dtype=torch.float32)
    full = expert_server.build_server_weights({"w": bank}, S, red)["w"]
    lean = torch.zeros_like(full)
    lean[:, :E // S] = bank.reshape(S, E // S, d, f)
    torch.testing.assert_close(expert_server.fill_redundant(lean, E, red),
                               full, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["deepseek-r1", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("dead", [None, 2])
def test_eaas_moe_apply_matches_jax(arch, dead):
    cfg = jget_config(arch).reduced().replace(dtype="float32")
    tcfg = get_config(arch).reduced().replace(dtype="float32")
    S, T = 4, 24
    _, red = jlb.eplb_plan(np.ones(cfg.moe.num_experts), S, n_redundant=2)
    jp = jmoe.init_eaas_moe(jax.random.PRNGKey(0), cfg, S,
                            redundant_table=red)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (T, cfg.d_model))) * 0.3
    jrt = jmoe.default_runtime(cfg, S, T // 2, redundant_table=red,
                               gemm_impl="xla_ragged")
    trt = moe_layer.default_runtime(tcfg, S, T // 2, "cpu",
                                    redundant_table=red)
    assert jrt.capacity == trt.capacity
    if dead is not None:
        jrt = jrt._replace(alive=jrt.alive.at[dead].set(False))
        trt = trt._replace(alive=trt.alive.clone().index_fill_(0,
                           torch.tensor([dead]), False))
    y, st = jmoe.eaas_moe_apply(jp, jnp.asarray(x), cfg.moe, jrt,
                                activation=cfg.activation)
    tp = params_from_numpy(jax.tree.map(np.asarray, {"embed": np.zeros(
        (tcfg.padded_vocab, tcfg.d_model), np.float32), **jp}), tcfg, "cpu")
    ty, tst = moe_layer.eaas_moe_apply(tp, _t(x), tcfg.moe, trt,
                                       activation=tcfg.activation)
    _close(ty, y)
    _eq(tst.expert_load, st.expert_load)
    assert int(tst.dropped) == int(st.dropped)
    assert int(tst.miss) == int(st.miss)
    if dead is not None:
        assert int(tst.miss) > 0
