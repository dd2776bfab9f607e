"""The grouped GEMM's backward kernels' work split, on the CPU.

``csrc/grouped_gemm_bwd.cu`` walks persistent work items drawn from an
in-kernel scan of the group sizes; ``kernels/group_shrink.py`` states the
same walks in plain PyTorch (``dx_items`` / ``dw_items``).  Over drawn
group sizes (empty groups, a group of more than 256 rows, row offsets off
the 8-row grid, G = 1 and G = 1024) these tests check that the walks cover
what the kernels must write exactly once, and run a tiled fp32 emulation
that follows them — 64-row dy boxes that take in the next group's rows and
mask them at the store (dx), 64-row stages whose rows past the group are
zeroed in the x box (dw), zero fill past the tensors' edges — against the
plain versions ``grouped_gemm_dx_torch`` / ``grouped_gemm_dw_torch``
within 1e-6.  The inputs are scaled so that the gradients are of order 0.1
to 1: fp32 sums taken in another order then differ by ~1e-7, while a row
of the wrong group, or one left unmasked, moves a value by ~1e-2.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import grouped_gemm as kgg
from repro_torch.kernels.group_shrink import (DW_STAGE, DX_COLS, DX_ROWS,
                                              DW_COLS, DW_ROWS, dw_items,
                                              dx_items)


def _draw(rng, g, rows, zero_share=0.3):
    """``rows`` rows over g groups, about ``zero_share`` of them empty."""
    p = rng.random(g) * (rng.random(g) > zero_share)
    if not p.any():
        p[0] = 1.0
    return rng.multinomial(rows, p / p.sum()).tolist()


def _cases():
    rng = np.random.default_rng(21)
    return {
        # name: (sizes, rows past the sum, K, N)
        "empty groups, offsets off the 8-row grid":
            ([0, 13, 0, 29, 3, 0, 51], 11, 72, 40),
        "a group of 300 rows": ([3, 300, 0, 17, 129, 1], 9, 136, 200),
        "G = 1": ([77], 0, 64, 24),
        "G = 1, rows past the sum": ([130], 70, 24, 136),
        "every group empty but the last": ([0] * 9 + [45], 5, 40, 64),
        "drawn, G = 130": (_draw(rng, 130, 1000), 280, 48, 136),
        "G = 1024": (_draw(rng, 1024, 1500, 0.5), 37, 24, 16),
    }


CASES = _cases()


@pytest.fixture(params=list(CASES))
def case(request):
    sizes, extra, k, n = CASES[request.param]
    return torch.tensor(sizes), sum(sizes) + extra, k, n


def _tiles(total, width):
    return -(-total // width)


def test_dx_walk_covers_each_live_row_and_column_tile_once(case):
    sizes, m, k, _ = case
    items = dx_items(sizes, m, k)
    live = int(sizes.sum())
    nkt = _tiles(k, DX_COLS)
    # the launch's static bound on items (grid size)
    assert items.shape[0] <= (m // DX_ROWS + len(sizes)) * nkt
    ends = torch.cumsum(sizes, 0)
    starts = ends - sizes
    cover = torch.zeros((m, nkt), dtype=torch.int64)
    for g, r0, r1, k0 in items.tolist():
        assert 0 < r1 - r0 <= DX_ROWS and k0 % DX_COLS == 0
        assert starts[g] <= r0 and r1 <= ends[g]        # one group an item
        cover[r0:r1, k0 // DX_COLS] += 1
    assert torch.equal(cover[:live], torch.ones_like(cover[:live]))
    assert not cover[live:].any()                     # past the sum: none


def test_dw_walk_writes_every_group_tile_once(case):
    """Without ``accumulate``: every (group, K tile, N tile) once, and an
    empty group's items hold no rows (they write zeros)."""
    sizes, m, k, n = case
    items = dw_items(sizes, m, k, n, accumulate=False)
    nkt, nnt = _tiles(k, DW_ROWS), _tiles(n, DW_COLS)
    assert items.shape[0] == len(sizes) * nkt * nnt
    cover = torch.zeros((len(sizes), nkt, nnt), dtype=torch.int64)
    ends = torch.cumsum(sizes, 0)
    for g, r0, r1, k0, n0 in items.tolist():
        assert (r0, r1) == (int(ends[g] - sizes[g]), int(ends[g]))
        cover[g, k0 // DW_ROWS, n0 // DW_COLS] += 1
    assert torch.equal(cover, torch.ones_like(cover))
    empty = (items[:, 1] == items[:, 2])
    assert torch.equal(torch.unique(items[empty, 0]),
                       torch.nonzero(sizes == 0).flatten())


def test_dw_walk_under_accumulate_skips_empty_groups(case):
    sizes, m, k, n = case
    items = dw_items(sizes, m, k, n, accumulate=True)
    nkt, nnt = _tiles(k, DW_ROWS), _tiles(n, DW_COLS)
    live_g = torch.nonzero(sizes > 0).flatten()
    assert items.shape[0] == len(live_g) * nkt * nnt
    assert bool((items[:, 2] > items[:, 1]).all())     # never an empty one
    keys = (items[:, 0] * nkt + items[:, 3] // DW_ROWS) * nnt \
        + items[:, 4] // DW_COLS
    assert torch.unique(keys).numel() == keys.numel()
    assert torch.equal(torch.unique(items[:, 0]), live_g)


def _padded(t, rows, cols):
    """``t`` with zero rows / columns past its edges (TMA's fill)."""
    out = torch.zeros((t.shape[0] + rows, t.shape[1] + cols), dtype=t.dtype)
    out[:t.shape[0], :t.shape[1]] = t
    return out


def _dx_tiled(dy, w, sizes):
    """dx as the kernel computes it: per item, two warpgroups of 64 rows,
    each a full 64-row dy box (the next group's rows included) against
    w[g]'s 128 rows k0.., only the item's rows stored."""
    m, n = dy.shape
    k = w.shape[1]
    dx = torch.full((m, k), float("nan"))
    dx[int(sizes.sum()):] = 0.0                         # zeroed apart
    dyp = _padded(dy, DX_ROWS, 0)
    for g, r0, r1, k0 in dx_items(sizes, m, k).tolist():
        wk = _padded(w[g], DX_COLS, 0)[k0:k0 + DX_COLS]
        cols = min(DX_COLS, k - k0)
        for wg in range(DX_ROWS // 64):
            rb = r0 + 64 * wg
            rows = min(64, r1 - rb)
            if rows <= 0:
                continue                                # this warpgroup idles
            acc = torch.zeros((64, DX_COLS))
            for s in range(0, n, 64):                   # 64-wide N stages
                acc += dyp[rb:rb + 64, s:s + 64] @ wk[:, s:s + 64].T
            dx[rb:rb + rows, k0:k0 + cols] = acc[:rows, :cols]
    return dx


def _dw_tiled(x, dy, sizes, out=None):
    """dw as the kernel computes it: per item, 64-row stages of x and dy
    boxes, the stage's rows past the group zeroed in the x box; written,
    or added into ``out`` (empty groups never visited)."""
    m, k = x.shape
    n = dy.shape[1]
    dw = (out.clone() if out is not None
          else torch.full((len(sizes), k, n), float("nan")))
    xp = _padded(x, DW_STAGE, DW_ROWS)
    dyp = _padded(dy, DW_STAGE, DW_COLS)
    for g, r0, r1, k0, n0 in dw_items(sizes, m, k, n,
                                      out is not None).tolist():
        acc = torch.zeros((DW_ROWS, DW_COLS))
        for rs in range(r0, r1, DW_STAGE):
            a = xp[rs:rs + DW_STAGE, k0:k0 + DW_ROWS].clone()
            a[min(DW_STAGE, r1 - rs):] = 0.0           # the next group's rows
            acc += a.T @ dyp[rs:rs + DW_STAGE, n0:n0 + DW_COLS]
        kk, nn = min(DW_ROWS, k - k0), min(DW_COLS, n - n0)
        if out is not None:
            dw[g, k0:k0 + kk, n0:n0 + nn] += acc[:kk, :nn]
        else:
            dw[g, k0:k0 + kk, n0:n0 + nn] = acc[:kk, :nn]
    return dw


def _inputs(case, seed=0):
    sizes, m, k, n = case
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(size=(m, k)) * 0.1, dtype=torch.float32)
    dy = torch.as_tensor(rng.normal(size=(m, n)) * 0.1, dtype=torch.float32)
    w = torch.as_tensor(rng.normal(size=(len(sizes), k, n)) * 0.1,
                        dtype=torch.float32)
    return x, dy, w, sizes


def test_tiled_dx_emulation_equals_plain(case):
    x, dy, w, sizes = _inputs(case)
    got = _dx_tiled(dy, w, sizes)
    assert not torch.isnan(got).any()                  # every row written
    torch.testing.assert_close(got, kgg.grouped_gemm_dx_torch(dy, w, sizes),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("accumulate", [False, True])
def test_tiled_dw_emulation_equals_plain(case, accumulate):
    x, dy, w, sizes = _inputs(case, seed=1)
    base = w.clone() if accumulate else None
    got = _dw_tiled(x, dy, sizes, out=base)
    assert not torch.isnan(got).any()                  # every group written
    want = kgg.grouped_gemm_dw_torch(
        x, dy, sizes, out=None if base is None else base.clone())
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if accumulate:
        empty = sizes == 0
        assert torch.equal(got[empty], w[empty])       # left as they were
