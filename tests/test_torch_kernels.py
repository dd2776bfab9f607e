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
