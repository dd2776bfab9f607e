"""Split-KV flash-decoding: the two-pass arithmetic of the port's decode
kernels (``csrc/decode_attention.cuh``), emulated in plain PyTorch from the
package's own split plan (``decode_attention.split_plan``, the host code
that sizes the grid), held against the JAX package's Pallas kernels in
interpret mode at float32, 1e-5.

Pass 1 cuts each sequence into chunks of ``SPLIT`` logical positions; a
chunk at or past the clamped length is dead and gives no partial, a live
one runs the online softmax over 32-slot tiles into ``(m, l, acc)``.
Pass 2 merges the live partials in a fixed order.  The kernels themselves
run only on the card (``tests/test_torch_cuda.py``)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import decode_attention as da

TILE = 32          # slots per tile of the kernels' online softmax


def split_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd), k/v (B, S, KV, hd): the two passes, in fp32."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    nsplit = da.split_plan(S)
    lens = lengths.clamp(0, S)
    qf = q.reshape(B, KV, G, hd).float()
    out = torch.zeros(B, KV, G, hd)
    for b in range(B):
        n = int(lens[b])
        for h in range(KV):
            parts = []
            for z in range(nsplit):
                c0 = z * da.SPLIT
                if c0 >= n:
                    continue                       # dead chunk
                c1 = min(n, c0 + da.SPLIT)
                m = torch.full((G,), -math.inf)
                l = torch.zeros(G)
                acc = torch.zeros(G, hd)
                for s0 in range(c0, c1, TILE):
                    s1 = min(c1, s0 + TILE)
                    sc = qf[b, h] @ k[b, s0:s1, h].float().T * scale
                    m_new = torch.maximum(m, sc.max(-1).values)
                    p = torch.exp(sc - m_new[:, None])
                    alpha = torch.exp(m - m_new)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + p @ v[b, s0:s1, h].float()
                    m = m_new
                parts.append((m, l, acc))
            if not parts:
                continue                           # length 0: zeros
            mx = torch.stack([p[0] for p in parts]).max(0).values
            lsum = torch.zeros(G)
            a = torch.zeros(G, hd)
            for m, l, acc in parts:                # split order
                w = torch.exp(m - mx)
                lsum = lsum + w * l
                a = a + w[:, None] * acc
            out[b, h] = a / lsum.clamp_min(1e-30)[:, None]
    return out.reshape(B, H, hd)


def _inputs(rng, shape_q, shape_kv):
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


def test_split_plan_is_a_constant_chunk_width():
    assert da.SPLIT % TILE == 0
    assert [da.split_plan(n) for n in (1, 64, 65, 128, 1024, 1032)] == \
        [1, 1, 2, 2, 16, 17]


@pytest.mark.parametrize("b,h,kv,hd,s,lengths", [
    # empty chunks (length 1 in a 3-chunk view), chunk edges, past S, 0
    (6, 8, 2, 32, 192, [1, 64, 65, 200, 0, 191]),
    (3, 16, 4, 64, 128, [128, 129, 33]),
    (2, 4, 4, 16, 64, [64, 7]),                 # one chunk covers the view
])
def test_split_emulation_vs_flash_decode_pallas(b, h, kv, hd, s, lengths,
                                                rng):
    q, k, v = _inputs(rng, (b, h, hd), (b, s, kv, hd))
    lens = np.asarray(lengths, np.int32)
    exp = jops.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(lens), impl="pallas_interpret",
                            ts=64)
    out = split_decode(torch.as_tensor(q), torch.as_tensor(k),
                       torch.as_tensor(v), torch.as_tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=1e-5,
                               atol=1e-5)
    live = lens > 0          # the plain version's masked softmax needs one
    plain = da.flash_decode_torch(torch.as_tensor(q), torch.as_tensor(k),
                                  torch.as_tensor(v), torch.as_tensor(lens))
    np.testing.assert_allclose(out.numpy()[live], plain.numpy()[live],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bs,mb,lengths", [
    (16, 8, [1, 64, 65, 140, 128]),
    (8, 12, [96, 1, 65, 0, 33]),
])
def test_split_emulation_vs_paged_flash_decode_pallas(bs, mb, lengths, rng):
    b, h, kv, hd = len(lengths), 8, 2, 32
    nb = b * mb + 1
    q, kp, vp = _inputs(rng, (b, h, hd), (nb, bs, kv, hd))
    tables = rng.permutation(np.arange(1, nb)).reshape(b, mb) \
        .astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    exp = jops.paged_flash_decode(jnp.asarray(q), jnp.asarray(kp),
                                  jnp.asarray(vp), jnp.asarray(tables),
                                  jnp.asarray(lens),
                                  impl="pallas_interpret")
    # the kernels' split plan runs over the gathered view, max_blocks * bs
    kd = torch.as_tensor(kp)[tables].reshape(b, mb * bs, kv, hd)
    vd = torch.as_tensor(vp)[tables].reshape(b, mb * bs, kv, hd)
    out = split_decode(torch.as_tensor(q), kd, vd, torch.as_tensor(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=1e-5,
                               atol=1e-5)
