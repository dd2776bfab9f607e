"""The CUDA sampler's split of a row over blocks, on the CPU.

``csrc/sample.cu`` gives each of a batch's B rows ``split_count(B, V,
slots)`` blocks (``slots``: the blocks the card holds at once), each a
contiguous column range (``split_ranges``); every block keeps its range's
winner, and
the row's last block to finish reduces the winners by one total order —
the larger value, a NaN the largest, the smaller index on ties.  These
tests check that the plan fills the card at decode batches and covers
every column once, and run a plain emulation of the split reduction, the
blocks finishing in a drawn order, against the plain sampler
(``sample_torch``) and, for greedy rows, the reference's ``jnp.argmax``:
equal maxima either side of a boundary, NaNs and infinities in later
splits, exact ties of a sampled row's noisy values, more splits than
columns.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import sampling as ksm
from torch_sample_cases import boundary_rows

SLOTS = 132 * 8          # an H100 holding 8 blocks of 256 threads an SM


@pytest.mark.parametrize("V", [129_280, 1000])
@pytest.mark.parametrize("B", [1, 2, 8, 64, 256, 512, 1056, 4224, 9000])
def test_split_plan_fills_the_card(B, V):
    S = ksm.split_count(B, V, SLOTS)
    assert S >= 1 and B * S <= max(4 * SLOTS, B)   # the workspace's bound
    if B <= SLOTS // 4:
        assert S > 1 and B * S > SLOTS // 2 - B    # half a wave at least
    if B * S > SLOTS and S > 1:                    # past a wave: ~4,096
        assert -(-V // S) <= ksm.SPLIT_COLUMNS or B * S > 3 * SLOTS
    if B >= 4 * SLOTS:
        assert S == 1


@pytest.mark.parametrize("V,S", [(129_280, 132), (129_280, 17), (1000, 1056),
                                 (1, 1056), (5, 3), (4096, 1), (7, 2)])
def test_split_ranges_cover_each_column_once(V, S):
    ranges = ksm.split_ranges(V, S)
    assert len(ranges) == S
    j = 0
    for j0, j1 in ranges:
        assert j0 == min(j, V) and j0 <= j1 <= V
        assert j1 == V or (j1 - j0) % 4 == 0       # whole float4s
        j = j1
    assert j == V


def _beats(va, ia, vb, ib) -> bool:
    """csrc/sample.cu::beats."""
    na, nb = va != va, vb != vb
    if na or nb:
        return na and (not nb or ia < ib)
    return va > vb or (va == vb and ia < ib)


def _split_sample(logits, temps, keys, steps, S, order_rng):
    """The kernel's arithmetic over its splits: each range's winner (the
    first maximum, NaN largest), then the winners reduced by ``_beats`` in
    a drawn finishing order; an empty range leaves none."""
    B, V = logits.shape
    safe = torch.where(temps > 0, temps, 1.0)
    noisy = torch.where((temps > 0)[:, None],
                        ksm.gumbel(ksm.random_bits(keys, steps, V))
                        + logits / safe[:, None], logits)
    out = []
    for b in range(B):
        parts = []
        for j0, j1 in ksm.split_ranges(V, S):
            if j1 > j0:
                i = j0 + int(torch.argmax(noisy[b, j0:j1]))
                parts.append((float(noisy[b, i]), i))
        best = None
        for p in order_rng.permutation(len(parts)):
            v, i = parts[p]
            if best is None or _beats(v, i, *best):
                best = (v, i)
        out.append(best[1])
    return torch.tensor(out)


@pytest.mark.parametrize("V,B", [(129_280, 7), (4096, 7)])
def test_boundary_rows_reduce_to_the_plain_tokens(V, B):
    S = ksm.split_count(B, V, SLOTS)
    logits, temps, keys, steps, want = boundary_rows(
        V, ksm.split_ranges(V, S))
    plain = ksm.sample_torch(logits, temps, keys, steps)
    assert torch.equal(plain, want)
    rng = np.random.default_rng(V)
    for _ in range(3):                   # any block may finish last
        assert torch.equal(_split_sample(logits, temps, keys, steps, S, rng),
                           want)
    greedy = (temps <= 0).numpy()
    ref = np.asarray(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1))
    np.testing.assert_array_equal(ref[greedy], want.numpy()[greedy])


@pytest.mark.parametrize("V,B", [(1, 1), (5, 1), (1000, 3), (33, 64),
                                 (50_000, 8)])
def test_split_emulation_equals_plain_on_drawn_rows(V, B):
    rng = np.random.default_rng(V * 7 + B)
    logits = torch.as_tensor(rng.standard_normal((B, V)) * 3,
                             dtype=torch.float32)
    temps = torch.as_tensor(rng.choice([0.0, 0.8, 1.0, -1.0, 0.3], B),
                            dtype=torch.float32)
    keys = torch.as_tensor(rng.integers(0, 2 ** 32, (B, 2)))
    steps = torch.as_tensor(rng.integers(0, 4096, B))
    S = ksm.split_count(B, V, SLOTS)
    got = _split_sample(logits, temps, keys, steps, S, rng)
    assert torch.equal(got, ksm.sample_torch(logits, temps, keys, steps))
