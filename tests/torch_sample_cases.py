"""Sampler rows whose winner lies on the CUDA kernel's column splits.

``csrc/sample.cu`` splits each row into contiguous column ranges
(``kernels/sampling.py::split_ranges``), one block each, and the row's last
block reduces the blocks' winners.  :func:`boundary_rows` builds rows whose
answer depends on that reduction: equal maxima on either side of a split
boundary (greedy, infinite, and a sampled row whose noisy values tie
exactly), and NaNs in a later split.  The CPU test
(``test_torch_sample_splits.py``) and the card test
(``test_torch_cuda.py``) share it; neither imports JAX here.
"""

import numpy as np
import torch

from repro_torch.kernels import sampling as ksm


def _tie(g_a: np.float32, l_a: np.float32, g_b: np.float32) -> np.float32:
    """A float32 logit ``l_b`` with ``g_b + l_b == g_a + l_a`` exactly, in
    float32 (the kernel's and the plain version's rounding)."""
    v = np.float32(g_a + l_a)
    cand = np.float32(v - g_b)
    for _ in range(16):
        s = np.float32(g_b + cand)
        if s == v:
            return cand
        cand = np.nextafter(cand, np.float32(np.inf if s < v else -np.inf))
    raise AssertionError("no float32 logit ties the pair")


def boundary_rows(V: int, ranges, device="cpu"):
    """Seven rows of ``V`` columns over the kernel's ``ranges`` (at least
    six non-empty): logits, temperatures, keys, steps on ``device`` and
    the tokens the order (larger value, NaN largest, smaller index on
    ties) gives.  A sampled row's noise is the plain version's on
    ``device`` (the kernel's bitwise)."""
    live = [r for r in ranges if r[1] > r[0]]
    assert len(live) >= 6, "boundary_rows needs six non-empty splits"
    (a0, a1), (b0, b1), (c0, c1), (d0, d1), (e0, e1), (f0, _) = live[:6]
    rng = np.random.default_rng(23)
    B = 7
    logits = (rng.standard_normal((B, V)) - 30.0).astype(np.float32)
    temps = np.array([0.0, 0.0, -1.0, 0.0, 1.0, 1.0, 0.0], np.float32)
    keys = torch.as_tensor(rng.integers(0, 2 ** 32, (B, 2)), device=device)
    steps = torch.as_tensor(rng.integers(0, 4096, B), device=device)
    g = ksm.gumbel(ksm.random_bits(keys, steps, V)).cpu().numpy()
    want = np.zeros(B, np.int64)
    # 0: greedy, equal maxima either side of the first boundary
    logits[0, a1 - 1] = logits[0, b0] = 7.0
    want[0] = a1 - 1
    # 1: greedy, equal maxima at the start of split 3 and the end of 2
    logits[1, c0] = logits[1, b1 - 1] = 5.5
    want[1] = b1 - 1
    # 2: greedy, a NaN in a later split beats a larger finite value
    logits[2, a0] = 1e30
    logits[2, (d0 + d1) // 2] = np.nan
    want[2] = (d0 + d1) // 2
    # 3: greedy, two NaNs in two later splits: the first
    logits[3, e1 - 1] = np.nan
    logits[3, c1 - 1] = np.nan
    want[3] = c1 - 1
    # 4: sampled at t = 1, noisy values tying exactly across a boundary
    logits[4, a1 - 1] = np.float32(50.0)
    logits[4, b0] = _tie(g[4, a1 - 1], np.float32(50.0), g[4, b0])
    want[4] = a1 - 1
    # 5: sampled, a NaN logit in a later split
    logits[5, a0] = 80.0
    logits[5, f0] = np.nan
    want[5] = f0
    # 6: greedy, +inf in the first and a later split
    logits[6, a0 + 1 if a1 - a0 > 1 else a0] = np.inf
    logits[6, e0] = np.inf
    want[6] = a0 + 1 if a1 - a0 > 1 else a0
    return (torch.as_tensor(logits, device=device),
            torch.as_tensor(temps, device=device), keys, steps,
            torch.as_tensor(want, device=device))
