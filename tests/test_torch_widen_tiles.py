"""The grouped GEMM's widening route's work split and arithmetic, on the
CPU.

float32 rows against bf16 weights (``lax.ragged_dot`` promotes the pair to
a float32 product) run ``csrc/grouped_gemm.cu``'s widening kernel: a walk
over (group, <= 64-row tile, 64-column tile) items of the in-kernel scan,
stated in plain PyTorch as ``kernels/group_shrink.py::widen_items``, and
the rows split into three bf16 planes for the tensor cores
(``kernels/grouped_gemm.py::widen_planes``).  These tests check that the
planes sum to the rows exactly and that their products with bf16 weights
are exact in float32; and over groups of 1, 8, 9, 16, 64 and 65 rows (the
token widths' and the row tile's edges), empty groups, no live row, and K
and N off the 8- and 64-grids, that the walk covers every live row and
column tile once, then run a tiled fp32 emulation that follows the kernel
— the item's rows loaded in 8- to 64-row boxes (the next group's rows
included, rows past the tensor zero), 64-wide K stages zero-filled past
K, each stage's first plane and its other two summed apart, then added to
the running sum of the stage's parity (two warpgroups take alternate
stages), the two sums added at the end, only the item's rows stored —
against the plain version and the reference's
``grouped_gemm(impl="xla_ragged")`` at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import grouped_gemm as kgg
from repro_torch.kernels.group_shrink import (WIDEN_COLS, WIDEN_K, WIDEN_ROWS,
                                              widen_items)
from repro_torch.kernels.grouped_gemm import widen_planes

CASES = {
    # name: (sizes, rows past the sum, K, N)
    "one group of 1 row": ([1], 3, 64, 64),
    "one group of 16 rows": ([16], 0, 96, 72),
    "one group of 64 rows": ([64], 5, 128, 64),
    "one group of 65 rows": ([65], 0, 72, 136),
    "empty groups, K and N off the 8-grid": ([0, 5, 0, 0, 23, 2], 7, 37, 70),
    "no live row": ([0, 0, 0], 6, 64, 40),
    "decode batch: 28 rows over 40 groups":
        (np.random.default_rng(3).multinomial(
            28, np.ones(40) / 40).tolist(), 0, 160, 136),
    "a group of 130 rows, N < 8": ([3, 130, 0, 1], 2, 33, 7),
    "8, 9, 32 and 33 rows: the token widths change":
        ([8, 9, 0, 32, 33], 0, 200, 72),
}


@pytest.fixture(params=list(CASES))
def case(request):
    sizes, extra, k, n = CASES[request.param]
    return torch.tensor(sizes), sum(sizes) + extra, k, n


def test_widen_walk_covers_each_live_row_and_column_tile_once(case):
    sizes, m, _, n = case
    items = widen_items(sizes, m, n)
    live = int(sizes.sum())
    nct = -(-n // WIDEN_COLS)
    # the launch's static bound on items (its grid)
    assert items.shape[0] <= (m // WIDEN_ROWS + len(sizes)) * nct
    ends = torch.cumsum(sizes, 0)
    starts = ends - sizes
    cover = torch.zeros((m, nct), dtype=torch.int64)
    for g, r0, r1, n0 in items.tolist():
        assert 0 < r1 - r0 <= WIDEN_ROWS and n0 % WIDEN_COLS == 0
        assert starts[g] <= r0 and r1 <= ends[g]        # one group an item
        cover[r0:r1, n0 // WIDEN_COLS] += 1
    assert torch.equal(cover[:live], torch.ones_like(cover[:live]))
    assert not cover[live:].any()                     # past the sum: none
    # the column tile fastest: a row tile's column tiles sit side by side,
    # the row tiles in row order
    if items.shape[0]:
        assert bool((items[:, 1][1:] >= items[:, 1][:-1]).all())
        assert torch.equal(items[:nct, 3],
                           torch.arange(min(nct, items.shape[0])) * WIDEN_COLS)


def _token_width(rows: int) -> int:
    """csrc/grouped_gemm.cu::token_width: the rows an item loads."""
    return 8 if rows <= 8 else 16 if rows <= 16 else 32 if rows <= 32 else 64


def _widen_tiled(x, w, sizes):
    """out as the widening kernel computes it (see the module docstring)."""
    m, k = x.shape
    n = w.shape[2]
    out = torch.full((m, n), float("nan"))
    out[int(sizes.sum()):] = 0.0                       # zeroed apart
    ks = -(-k // WIDEN_K) * WIDEN_K
    xp = torch.zeros((m + WIDEN_ROWS, ks))
    xp[:m, :k] = x
    planes = widen_planes(xp)
    for g, r0, r1, n0 in widen_items(sizes, m, n).tolist():
        nt = _token_width(r1 - r0)
        wt = torch.zeros((ks, WIDEN_COLS))
        cols = min(WIDEN_COLS, n - n0)
        wt[:k, :cols] = w[g, :, n0:n0 + cols].float()  # zero fill
        total = torch.zeros((2, nt, WIDEN_COLS))       # even, odd stages
        for s in range(0, ks, WIDEN_K):                # K stages
            p1, p2, p3 = (pl[r0:r0 + nt, s:s + WIDEN_K] for pl in planes)
            ws = wt[s:s + WIDEN_K]
            acc0 = p1 @ ws
            acc1 = p2 @ ws + p3 @ ws
            par = (s // WIDEN_K) % 2
            total[par] = (total[par] + acc0) + acc1
        out[r0:r1, n0:n0 + cols] = (total[0] + total[1])[:r1 - r0, :cols]
    return out


def test_planes_sum_to_the_rows_and_multiply_exactly():
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=20_000) * np.exp(
        rng.normal(size=20_000) * 8), dtype=torch.float32)
    x = torch.cat([x, torch.tensor([0.0, -0.0, 3.4e38, -1e-30, float("inf"),
                                    -float("inf"), float("nan")])])
    p1, p2, p3 = widen_planes(x)
    finite = torch.isfinite(x)
    assert torch.equal((p1.double() + p2.double() + p3.double())[finite],
                       x.double()[finite])
    assert torch.equal(p1[~finite].isnan(), x[~finite].isnan())
    assert torch.equal(p1[~finite & ~x.isnan()], x[~finite & ~x.isnan()])
    normal = finite & (x.abs() >= torch.finfo(torch.float32).tiny)
    w = torch.as_tensor(rng.normal(size=x.shape[0]),
                        dtype=torch.float32).to(torch.bfloat16).float()
    for p in (p1, p2, p3):
        q = p[normal]
        assert torch.equal(q.to(torch.bfloat16).float(), q)   # a bf16
        prod = q * w[normal]                                  # fp32 product
        assert torch.equal(prod.double(), q.double() * w[normal].double())


def test_tiled_emulation_equals_plain_and_reference(case):
    sizes, m, k, n = case
    rng = np.random.default_rng(m * 31 + k)
    x = torch.as_tensor(rng.normal(size=(m, k)), dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(len(sizes), k, n)) / k ** 0.5,
                        dtype=torch.float32).to(torch.bfloat16)
    got = _widen_tiled(x, w, sizes)
    assert not torch.isnan(got).any()                  # every row written
    plain = kgg.grouped_gemm_torch(x, w, sizes)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
    ref = np.asarray(jops.grouped_gemm(
        jnp.asarray(x.numpy()), jnp.asarray(w.float().numpy(),
                                            jnp.bfloat16),
        jnp.asarray(sizes.numpy(), jnp.int32), impl="xla_ragged"))
    assert ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_widen_walk_keeps_a_groups_row_tiles_in_one_wave():
    # a prefill payload of ~64 rows a group: a group's row tiles past 64
    # rows load the same weight tiles, which the walk puts fewer items
    # apart than an H100's 132 persistent CTAs, so both loads meet in L2
    sizes = torch.bincount(torch.multinomial(
        torch.full((40,), 1 / 40), 2560, replacement=True,
        generator=torch.Generator().manual_seed(3)), minlength=40)
    items = widen_items(sizes, 2560, 2048)
    first = {}
    gaps = []
    for i, (g, _, _, n0) in enumerate(items.tolist()):
        if (g, n0) in first:
            gaps.append(i - first[(g, n0)])
        else:
            first[(g, n0)] = i
    assert gaps and max(gaps) < 132
    assert len(first) == 40 * 2048 // WIDEN_COLS
