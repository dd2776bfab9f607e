"""Port kernels: the plain PyTorch versions against the JAX package's Pallas
kernels (interpret mode) on the same numpy inputs, at the sweeps and
tolerances of tests/test_kernels.py.  The CUDA kernels are held against
these plain versions on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import group_shrink as jgs
from repro.kernels import ops as jops
from repro_torch.bridge import tensor_from_numpy
from repro_torch.kernels import group_shrink as gs
from repro_torch.kernels import ops

DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor."""
    j = jnp.asarray(a, DTYPES[dtype])
    return j, tensor_from_numpy(np.asarray(j), "cpu")


def _close(t: torch.Tensor, j, tol: float):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,g,tm", [
    (64, 32, 32, 4, 8),
    (128, 64, 48, 6, 16),
    (96, 128, 128, 3, 32),
    (256, 64, 128, 16, 8),
])
def test_grouped_gemm_plain_vs_pallas(m, k, n, g, tm, dtype, rng):
    sizes = rng.multinomial(m - 8, np.ones(g) / g).astype(np.int32)
    jx, tx = _both(rng.normal(size=(m, k)), dtype)
    jw, tw = _both(rng.normal(size=(g, k, n)) * 0.1, dtype)
    exp = jops.grouped_gemm(jx, jw, jnp.asarray(sizes),
                            impl="pallas_interpret", tm=tm, tn=16, tk=16)
    out = ops.grouped_gemm(tx, tw, torch.as_tensor(sizes))
    assert out.dtype == tx.dtype and out.shape == (m, n)
    _close(out, exp, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("m,k,n,g", [(28, 64, 32, 40), (64, 48, 40, 4),
                                     (96, 128, 128, 3)])
def test_grouped_gemm_f32_rows_bf16_weights_vs_ragged_dot(m, k, n, g, rng):
    """float32 rows against bfloat16 weights: the plain version equals
    ``lax.ragged_dot(f32, bf16)`` (the reference's promoted float32
    product, rows past the sum zeroed) at 1e-5, in float32."""
    sizes = rng.multinomial(m - 4, np.ones(g) / g).astype(np.int32)
    jx, tx = _both(rng.normal(size=(m, k)), "float32")
    jw, tw = _both(rng.normal(size=(g, k, n)) * 0.1, "bfloat16")
    exp = jops.grouped_gemm(jx, jw, jnp.asarray(sizes), impl="xla_ragged")
    assert exp.dtype == jnp.float32
    out = ops.grouped_gemm(tx, tw, torch.as_tensor(sizes))
    assert out.dtype == torch.float32 and out.shape == (m, n)
    _close(out, exp, 1e-5)
    assert out[m - 4:].eq(0).all()


def test_grouped_gemm_mixed_pair_has_no_gradient(rng):
    x = torch.as_tensor(rng.normal(size=(8, 16)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(2, 16, 8)), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="no gradient"):
        ops.grouped_gemm(x.requires_grad_(), w, torch.tensor([4, 4]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [None, 8, 24])
def test_grouped_gemm_dense_vs_reference(dtype, cap, rng):
    """The ``xla_dense`` lowering (GShard capacity: a group's rows past
    ``cap`` and the rows past the sum give 0) against the reference's,
    its default capacity included; float32 rows against bfloat16
    weights promote as in jnp."""
    m, k, n, g = 80, 32, 24, 5
    sizes = np.array([3, 30, 0, 12, 27], np.int32)       # 72 live rows
    jx, tx = _both(rng.normal(size=(m, k)), dtype)
    jw, tw = _both(rng.normal(size=(g, k, n)) * 0.1, dtype)
    for x_pair, w_pair in (((jx, tx), (jw, tw)),
                           (_both(rng.normal(size=(m, k)), "float32"),
                            _both(rng.normal(size=(g, k, n)) * 0.1,
                                  "bfloat16"))):
        exp = jops.grouped_gemm(x_pair[0], w_pair[0], jnp.asarray(sizes),
                                impl="xla_dense", expert_capacity=cap)
        out = ops.grouped_gemm(x_pair[1], w_pair[1], torch.as_tensor(sizes),
                               impl="dense", expert_capacity=cap)
        assert out.dtype == x_pair[1].dtype
        _close(out, exp, 1e-5 if out.dtype == torch.float32 else 2e-2)
    if cap == 8:                                        # rows dropped
        assert out[3 + 8:3 + 30].eq(0).all()


def test_grouped_gemm_dense_gradient_is_autograds(rng):
    """The dense lowering trains through autograd (plain ops): its
    gradients equal ``jax.grad`` of the reference's ``xla_dense``."""
    import jax

    m, k, n, g, cap = 40, 16, 12, 4, 8
    sizes = np.array([5, 12, 0, 20], np.int32)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(g, k, n)) * 0.1).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)

    def jloss(x, w):
        y = jops.grouped_gemm(x, w, jnp.asarray(sizes), impl="xla_dense",
                              expert_capacity=cap)
        return jnp.sum(y * dy)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                               jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y = ops.grouped_gemm(tx, tw, torch.as_tensor(sizes), impl="dense",
                         expert_capacity=cap)
    (y * torch.from_numpy(dy)).sum().backward()
    _close(tx.grad, jdx, 1e-5)
    _close(tw.grad, jdw, 1e-5)


def test_grouped_gemm_empty_groups(rng):
    x = torch.as_tensor(rng.normal(size=(32, 16)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(4, 16, 16)), dtype=torch.float32)
    out = ops.grouped_gemm(x, w, torch.zeros(4, dtype=torch.int32))
    assert torch.equal(out, torch.zeros(32, 16))


def test_tile_table_shrinks_inactive_groups():
    sizes = [16, 0, 0, 8, 0, 24]
    table = gs.build_tile_table(torch.tensor(sizes), m=64, tm=8)
    assert int(table.num_tiles) == 6
    assert table.tile_gid[:6].tolist() == [0, 0, 3, 5, 5, 5]
    assert int(table.tile_valid.sum()) == 6
    jt = jgs.build_tile_table(jnp.asarray(sizes, jnp.int32), m=64, tm=8)
    for name in ("tile_gid", "tile_valid", "padded_offset", "num_tiles"):
        np.testing.assert_array_equal(getattr(table, name).numpy(),
                                      np.asarray(getattr(jt, name)))
    # row ranges: each live tile covers its share of its group's rows
    assert table.row_start[:6].tolist() == [0, 8, 16, 24, 32, 40]
    assert table.row_end[:6].tolist() == [8, 16, 24, 32, 40, 48]
    assert table.row_end[6:].eq(0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,hd,s,ts,past_end", [
    (2, 8, 2, 32, 64, 16, False),
    (3, 4, 4, 64, 128, 32, False),
    (1, 16, 8, 16, 32, 8, False),
    (3, 8, 2, 32, 64, 16, True),     # idle engine slots: lengths > S
])
def test_flash_decode_plain_vs_pallas(b, h, kv, hd, s, ts, past_end, dtype,
                                      rng):
    jq, tq = _both(rng.normal(size=(b, h, hd)), dtype)
    jk, tk = _both(rng.normal(size=(b, s, kv, hd)), dtype)
    jv, tv = _both(rng.normal(size=(b, s, kv, hd)), dtype)
    hi = 2 * s if past_end else s
    lengths = rng.integers(1, hi + 1, size=b).astype(np.int32)
    if past_end:
        lengths[0] = s + 5
    exp = jops.flash_decode(jq, jk, jv, jnp.asarray(lengths),
                            impl="pallas_interpret", ts=ts)
    out = ops.flash_decode(tq, tk, tv, torch.as_tensor(lengths))
    _close(out, exp, 1e-5 if dtype == "float32" else 3e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,k,d,tt,td", [(64, 2, 128, 16, 32),
                                         (128, 8, 256, 32, 64)])
def test_combine_plain_vs_pallas(t, k, d, tt, td, dtype, rng):
    jx, tx = _both(rng.normal(size=(t, k, d)), dtype)
    jw, tw = _both(rng.random(size=(t, k)), "float32")
    exp = jops.combine_weighted(jx, jw, impl="pallas_interpret", tt=tt,
                                td=td)
    out = ops.combine_weighted(tx, tw)
    _close(out, exp, 1e-5 if dtype == "float32" else 2e-2)


def _slots(rng, T, k, S, C, drop=0.1):
    """(T, k) flat slots into S*C, distinct rows, ~``drop`` of them -1 and
    every slot of token 0 dropped."""
    slots = rng.permutation(S * C)[:T * k].reshape(T, k)
    slots[rng.random((T, k)) < drop] = -1
    slots[0] = -1
    return slots


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["tensor", "list"])
@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("with_addend", [False, True])
def test_combine_slots_plain_vs_reference(dtype, layout, k, with_addend,
                                          rng):
    """The slot entry against repro.core.dispatch.combine (+ the addend
    added after it, as the reference's MoE layer adds the shared experts)."""
    from repro.core import dispatch as jdispatch
    S, C, d, T = 4, 32, 64, 12
    jr, tr = _both(rng.normal(size=(S, C, d)), dtype)
    slots = _slots(rng, T, k, S, C)
    exp = jdispatch.combine(jr, jnp.asarray(slots, jnp.int32))
    addend = None
    if with_addend:
        ja, addend = _both(rng.normal(size=(T, d)), dtype)
        exp = exp + ja
    responses = tr if layout == "tensor" else list(tr.unbind(0))
    out = ops.combine_slots(responses, torch.as_tensor(slots),
                            addend=addend)
    assert out.dtype == tr.dtype and out.shape == (T, d)
    _close(out, exp, 1e-5 if dtype == "float32" else 2e-2)
    if addend is None:
        assert torch.equal(out[0], torch.zeros(d, dtype=tr.dtype))
    else:
        assert torch.equal(out[0], addend[0])


def test_combine_slots_cuda_entry_refuses_what_the_kernel_cannot_take():
    """No fallback: a CPU tensor given to the kernel's entry raises, and so
    do buffers that differ in dtype or more buffers than the launch's
    parameters hold."""
    from repro_torch.kernels import combine
    bufs = [torch.zeros(4, 8) for _ in range(3)]
    slots = torch.zeros(2, 2, dtype=torch.int64)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.combine_slots(bufs, slots, impl="cuda")
    with pytest.raises(ValueError, match="one CUDA device"):
        combine.combine_slots_cuda(bufs, slots)
    with pytest.raises(ValueError, match="one\\s+shape, dtype"):
        combine.combine_slots_cuda(bufs[:2] + [bufs[2].double()], slots)
    with pytest.raises(ValueError, match="buffers, expected"):
        combine.combine_slots_cuda(bufs * 22, slots)
