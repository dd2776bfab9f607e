"""Gradients of the training path's kernels and of the MoE layer, float32,
against the JAX package's (``jax.grad`` through ``lax.ragged_dot``, the
trainer's ``gemm_impl``, and ``repro.core.dispatch.combine``) and against
autograd through the plain versions; the stacked views' gradients; the
raw CUDA wrappers' refusal under grad.

Tolerances: 1e-6 (relative to the gradient's largest entry, at least 1)
for the kernels' gradients; 1e-5 for the MoE layer's leaves (its router
and softmax add float32 roundings that differ between the packages).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core import dispatch as jdispatch
from repro.core import moe_layer as jmoe
from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.core import moe_layer
from repro_torch.kernels import combine as kcb
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import grouped_gemm as kgg
from repro_torch.kernels import ops
from repro_torch.kernels.autograd import grad_target, stacked_view
from repro_torch.training import tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got: torch.Tensor, exp, tol: float) -> None:
    exp = np.asarray(exp, np.float32)
    scale = max(1.0, float(np.abs(exp).max()) if exp.size else 1.0)
    np.testing.assert_allclose(got.detach().float().numpy(), exp,
                               rtol=0, atol=tol * scale)


GG_CASES = {"empty groups, rows past the sum": (40, 6, 5, [3, 0, 7, 0, 20]),
            "G = 1": (16, 8, 4, [16]),
            "G = 1, rows past the sum": (16, 8, 4, [9]),
            "G = 130": (300, 4, 3, "130")}


def _gg_inputs(rng, case):
    M, K, N, sizes = GG_CASES[case]
    if sizes == "130":
        sizes = np.bincount(rng.integers(0, 130, size=M - 20), minlength=130)
        sizes[:5] = 0
    sizes = np.asarray(sizes, np.int32)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w = rng.normal(size=(len(sizes), K, N)).astype(np.float32)
    dy = rng.normal(size=(M, N)).astype(np.float32)
    return x, w, sizes, dy


@pytest.mark.parametrize("case", list(GG_CASES))
def test_grouped_gemm_gradients(case, rng):
    """GroupedGemm's (dx, dw) == autograd through grouped_gemm_torch ==
    jax.grad of the reference's xla_ragged path; zero dx past the sum,
    zero dw for an empty group."""
    from repro.kernels import ops as jops
    x, w, sizes, dy = _gg_inputs(rng, case)

    def jloss(x, w):
        y = jops.grouped_gemm(x, w, jnp.asarray(sizes), impl="xla_ragged")
        return jnp.sum(y * dy)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))

    got, plain = [], []
    for fn, out in ((ops.grouped_gemm, got), (kgg.grouped_gemm_torch, plain)):
        tx = torch.from_numpy(x).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        (fn(tx, tw, torch.from_numpy(sizes)) * torch.from_numpy(dy)).sum() \
            .backward()
        out.extend([tx.grad, tw.grad])
    for g, p, j in zip(got, plain, (jdx, jdw)):
        _close(g, p.numpy(), 1e-6)
        _close(g, j, 1e-6)
    live = int(sizes.sum())
    assert not got[0][live:].any()
    assert not got[1][torch.from_numpy(sizes) == 0].any()


def test_backward_plain_versions_accumulate(rng):
    """grouped_gemm_dw_torch(out=...) adds into the groups that hold rows
    and leaves the empty ones as they were."""
    x, _, sizes, dy = _gg_inputs(rng, "empty groups, rows past the sum")
    tx, tdy, ts = (torch.from_numpy(a) for a in (x, dy, sizes))
    base = torch.from_numpy(rng.normal(size=(5, 6, 5)).astype(np.float32))
    got = kgg.grouped_gemm_dw_torch(tx, tdy, ts, out=base.clone())
    full = kgg.grouped_gemm_dw_torch(tx, tdy, ts)
    live = ts > 0
    torch.testing.assert_close(got[live], base[live] + full[live])
    assert torch.equal(got[~live], base[~live])
    dx = kgg.grouped_gemm_dx_torch(tdy, torch.from_numpy(
        rng.normal(size=(5, 6, 5)).astype(np.float32)), ts)
    assert dx.shape == (40, 6) and not dx[30:].any()


@pytest.mark.parametrize("layout", ["tensor", "list"])
def test_combine_slots_gradients(layout, rng):
    """CombineSlots' gradients == jax.grad of the reference's combine plus
    the addend (drops, a -1 slot per token row, k = 3)."""
    S, C, d, T, k = 3, 8, 8, 7, 3
    resp = rng.normal(size=(S, C, d)).astype(np.float32)
    slots = rng.permutation(S * C)[:T * k].reshape(T, k).astype(np.int64)
    slots[::2, 1] = -1
    add = rng.normal(size=(T, d)).astype(np.float32)
    dy = rng.normal(size=(T, d)).astype(np.float32)

    def jloss(r, a):
        y = jdispatch.combine(r, jnp.asarray(slots)) + a
        return jnp.sum(y * dy)
    jdr, jda = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(resp),
                                               jnp.asarray(add))
    tr = torch.from_numpy(resp).requires_grad_()
    ta = torch.from_numpy(add).requires_grad_()
    bufs = tr if layout == "tensor" else list(tr.unbind(0))
    y = ops.combine_slots(bufs, torch.from_numpy(slots), addend=ta)
    _close(y, np.asarray(jdispatch.combine(jnp.asarray(resp),
                                           jnp.asarray(slots))) + add, 1e-6)
    (y * torch.from_numpy(dy)).sum().backward()
    _close(tr.grad, jdr, 1e-6)
    _close(ta.grad, jda, 1e-6)


def test_moe_layer_gradients_every_leaf(rng):
    """eaas_moe_apply (reduced deepseek-r1: shared expert, sigmoid top-2,
    a capacity that drops) against the JAX layer: the output and the
    gradient of x and of every parameter leaf (router, the servers'
    stacked weights, the shared expert) at 1e-5; stats exact."""
    S, T = 2, 24
    jcfg = jget_config("deepseek-r1").reduced().replace(dtype="float32")
    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    red = np.zeros((S, 0), np.int32)
    jp = jmoe.init_eaas_moe(jax.random.PRNGKey(3), jcfg, S,
                            redundant_table=red)
    jrt = jmoe.default_runtime(jcfg, S, T, gemm_impl="xla_ragged")._replace(
        capacity=8)
    x = rng.normal(size=(T, cfg.d_model)).astype(np.float32)
    dy = rng.normal(size=(T, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        y, st = jmoe.eaas_moe_apply(p, x, jcfg.moe, jrt)
        return jnp.sum(y * dy) + st.aux_loss + st.z_loss, (y, st)
    (_, (jy, jst)), (jg, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        return tensor_from_numpy(np.asarray(t), "cpu").requires_grad_()
    tp = conv(jp)
    tx = torch.from_numpy(x).requires_grad_()
    rt = moe_layer.default_runtime(cfg, S, T, "cpu")._replace(capacity=8)
    y, st = moe_layer.eaas_moe_apply(tp, tx, cfg.moe, rt)
    ((y * torch.from_numpy(dy)).sum() + st.aux_loss + st.z_loss).backward()
    _close(y, jy, 1e-5)
    assert int(st.dropped) == int(jst.dropped) > 0
    assert int(st.miss) == int(jst.miss)
    np.testing.assert_array_equal(st.expert_load.numpy(), jst.expert_load)
    _close(tx.grad, jgx, 1e-5)
    for path, leaf in tree.items(tp):
        assert leaf.grad is not None, path
        _close(leaf.grad, tree.get(jax.tree.map(np.asarray, jg), path), 1e-5)


def test_stacked_view_gradient_goes_into_the_leaf():
    """A stacked view (nested, then through the grouped GEMM's dw) adds
    its gradient into the leaf's .grad in place and equals autograd's;
    without grad mode it is plain indexing."""
    g = torch.Generator().manual_seed(0)
    W = torch.randn(3, 2, 4, 6, 5, generator=g).requires_grad_()
    x = torch.randn(10, 6, generator=g).requires_grad_()
    sizes = torch.tensor([2, 0, 5, 3])
    v = stacked_view(stacked_view(W, 1), (0,))
    assert grad_target(v)[0] is W and grad_target(v)[1] == (1, 0)
    y = ops.grouped_gemm(x, v, sizes) + ops.grouped_gemm(
        x, stacked_view(W, (2, 1)), sizes)
    u = stacked_view(W, (0, 1))            # used outside the GEMM too
    (y.square().sum() + u.sum()).backward()
    W2 = W.detach().clone().requires_grad_()
    x2 = x.detach().clone().requires_grad_()
    y2 = (kgg.grouped_gemm_torch(x2, W2[1, 0], sizes)
          + kgg.grouped_gemm_torch(x2, W2[2, 1], sizes))
    (y2.square().sum() + W2[0, 1].sum()).backward()
    torch.testing.assert_close(W.grad, W2.grad)
    torch.testing.assert_close(x.grad, x2.grad)
    with torch.no_grad():
        plain = stacked_view(W, 1)
    assert plain.grad_fn is None and grad_target(plain) is None


def test_raw_cuda_wrappers_raise_under_grad():
    """A raw CUDA wrapper returns no grad_fn: under grad with an input
    that requires grad it raises before anything else (here, before the
    device check it would fail without grad)."""
    x = torch.zeros(8, 16, requires_grad=True)
    w = torch.zeros(2, 16, 16)
    sz = torch.tensor([4, 4])
    q = torch.zeros(1, 2, 16, requires_grad=True)
    kv = torch.zeros(1, 4, 1, 16)
    slot = torch.zeros(2, 1, dtype=torch.int64)
    calls = [lambda: kgg.grouped_gemm_cuda(x, w, sz),
             lambda: kgg.grouped_gemm_dx_cuda(x, w, sz),
             lambda: kgg.grouped_gemm_dw_cuda(x, x, sz),
             lambda: kcb.combine_slots_cuda(x.reshape(1, 8, 16), slot),
             lambda: kcb.combine_weighted_cuda(x.reshape(1, 8, 16),
                                               torch.ones(1, 8)),
             lambda: kda.flash_decode_cuda(q, kv, kv, torch.tensor([2])),
             lambda: kda.paged_flash_decode_cuda(
                 q, kv, kv, torch.tensor([[0]]), torch.tensor([2]))]
    for call in calls:
        with pytest.raises(RuntimeError, match="records no gradient"):
            call()
    with torch.no_grad():
        for call in calls:
            with pytest.raises(ValueError, match="CUDA device"):
                call()


def test_bridged_params_keep_the_reference_layout():
    """loss_fn's stacked views index the bridged params as the reference
    scans them (a layer of a stacked leaf is its leading index)."""
    cfg = get_config("granite-3-2b").reduced().replace(dtype="float32")
    jcfg = jget_config("granite-3-2b").reduced().replace(dtype="float32")
    from repro.models.transformer import build_model as jbuild
    jp = jbuild(jcfg).init_params(jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tp["blocks"]["attn"]["wq"].requires_grad_()
    v = stacked_view(tp["blocks"]["attn"]["wq"], 2)
    np.testing.assert_array_equal(v.detach().numpy(),
                                  np.asarray(jp["blocks"]["attn"]["wq"][2]))
