"""Temperature sampling as the reference draws it: JAX's threefry-2x32
Gumbel-max, bit for bit.

The reference's ``serving/sampling.py::sample_batch`` (a jitted jnp
function; no Pallas kernel lies behind it) draws row ``b`` as
``argmax(gumbel(fold_in(key_b, step_b), (V,)) + logits_b / t_b)``, the
first index on ties, and greedy ``argmax(logits_b)`` where ``t_b <= 0``.
The pieces are JAX's (``jax/_src/prng.py`` and ``random.py``, in the
partitionable threefry mode that is the installed JAX's default):

* ``fold_in(key, d)``: ``threefry2x32(key, (0, d))``, both output words;
* ``random_bits(key, (V,))``: element ``j`` hashes the counter
  ``(j >> 32, j & 0xffffffff)`` and keeps ``x0 ^ x1`` (the same counters
  over ``(1, V)``: the flattened index);
* ``uniform(minval=tiny)``: ``bits >> 9 | 0x3f800000`` as a float32 in
  [1, 2), minus 1, then ``max(tiny, f * (1 - tiny) + tiny)``, which in
  float32 is ``max(tiny, f + tiny)``;
* ``gumbel`` (mode "low"): ``-log(-log(u))``.

The plain version computes all of it on int64 tensors holding 32-bit
words, every row at once.  The CUDA kernel (``csrc/sample.cu``), one launch
a batch, splits each row into :func:`split_count` contiguous column ranges
(:func:`split_ranges`), one block each, so that a decode batch of a few
rows still reaches every SM: a block hashes its columns, forms
``logits / t + gumbel`` in fp32 with ``logf`` and keeps a running (value,
index) maximum; a row with ``t <= 0`` skips the hash and takes the plain
argmax over 16-byte loads.  Each block leaves its winner in a workspace
(:func:`reserve`, one a device, never allocated while a stream captures);
the row's last block to finish, found through a per-row counter, reduces
the row's partials, writes the token and sets the counter back to 0.  The
order (larger value, NaN largest, smaller index on ties) is total, so the
token is ``argmax``'s whichever block finishes last.  Temperatures, keys
and steps are device tensors (the launch can be captured).  A second,
small kernel (:func:`probe_cuda`) writes every element's bits, uniform and
noise through the same device helpers, for the tests.

What bounds it on an H100: operations.  Each element of a sampled row
reads 4 bytes of logits but issues the hash's integer instructions (a
rotate is one funnel shift), the uniform's few and two ``logf``, most of
them on the integer pipes, which issue half as many a clock as the
float32 ones.  The splits put all 132 SMs on that work at any batch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = float(np.finfo(np.float32).tiny)
SPLIT_COLUMNS = 4096     # a range's columns the split aims at, past a wave


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    the key ``(k0, k1)``: Python ints, numpy int64 arrays or int64
    tensors holding 32-bit words (broadcast) -> the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)`` as the reference runs it (64-bit types
    off: the seed is taken as an int32, so the key's high word is 0 and
    its low word ``seed mod 2**32``)."""
    return 0, int(seed) & MASK


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in(key, data)`` on a host key; ``data`` must be
    a uint32, as the reference's ``jnp.asarray(data, 'uint32')`` requires
    (it raises ``OverflowError`` otherwise)."""
    data = int(data)
    if not 0 <= data <= MASK:
        raise OverflowError(f"Python integer {data} out of bounds for uint32")
    return threefry2x32(int(key[0]), int(key[1]), 0, data)


def step_keys(keys: torch.Tensor, steps: torch.Tensor) -> tuple:
    """Each row's ``fold_in(keys[b], steps[b])``: keys (B, 2), steps (B,)
    int64 -> two (B,) int64 words."""
    return threefry2x32(keys[:, 0], keys[:, 1], torch.zeros_like(steps),
                        steps & MASK)


def random_bits(keys: torch.Tensor, steps: torch.Tensor, V: int
                ) -> torch.Tensor:
    """``random_bits(fold_in(keys[b], steps[b]), 32, (V,))`` of every row:
    (B, V) int64 holding uint32s."""
    k0, k1 = step_keys(keys, steps)
    j = torch.arange(V, dtype=torch.int64, device=keys.device)
    x0, x1 = threefry2x32(k0[:, None], k1[:, None], j >> 32, j & MASK)
    return x0 ^ x1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``uniform(minval=tiny, maxval=1)`` from 32 random bits: float32."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f + TINY, TINY)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """JAX's low-mode Gumbel noise from 32 random bits: float32."""
    return -torch.log(-torch.log(uniform(bits)))


def sample_torch(logits: torch.Tensor, temperatures: torch.Tensor,
                 keys: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Plain version: logits (B, V) fp32, temperatures (B,) fp32, keys
    (B, 2) and steps (B,) int64 -> (B,) int64 tokens."""
    B, V = logits.shape
    # torch.argmax, like jnp.argmax: the first maximum, a NaN the largest
    greedy = torch.argmax(logits, dim=-1)
    if B == 0 or not bool((temperatures > 0).any()):
        return greedy
    safe_t = torch.where(temperatures > 0, temperatures, 1.0)
    noisy = gumbel(random_bits(keys, steps, V)) + logits / safe_t[:, None]
    return torch.where(temperatures > 0, torch.argmax(noisy, dim=-1),
                       greedy)


def _check(logits, temperatures, keys, steps) -> int:
    req = build.require
    req(logits.is_cuda and all(t.device == logits.device
                               for t in (temperatures, keys, steps)),
        "sample: logits, temperatures, keys and steps must be on one CUDA "
        "device")
    req(logits.dim() == 2 and logits.dtype == torch.float32
        and logits.stride(1) == 1,
        f"sample: logits must be (B, V) float32 with unit column stride, "
        f"got {tuple(logits.shape)} {logits.dtype}")
    B, V = logits.shape
    req(1 <= V < 2 ** 31, f"sample: V={V}")
    req(temperatures.shape == (B,) and temperatures.dtype == torch.float32
        and keys.shape == (B, 2) and keys.dtype == torch.int64
        and steps.shape == (B,) and steps.dtype == torch.int64
        and keys.is_contiguous(),
        f"sample: temperatures ({B},) float32, keys ({B}, 2) and steps "
        f"({B},) int64 expected")
    return B


# the blocks of the kernel each device holds at once (sample_slots), and
# each device's workspace: (rows, partials, counters, values, indices)
_SLOTS: dict = {}
_WORKSPACE: dict = {}
# workspaces a larger batch replaced: kept, since a captured graph may
# still hold their addresses
_RETIRED: list = []


def split_count(B: int, V: int, slots: int) -> int:
    """The column ranges the kernel splits each of ``B`` rows of ``V``
    columns into, ``slots`` being the blocks the card holds at once: at a
    decode batch half a wave of blocks (a few rows still reach every SM),
    at larger batches ranges of about 4,096 columns, so that blocks that
    finish early (greedy rows) leave room for the rest; within four waves
    (the workspace's bound), one range a row once the rows alone fill
    them."""
    return max(1, min(max(slots // (2 * B), -(-V // SPLIT_COLUMNS)),
                      4 * slots // B))


def split_ranges(V: int, S: int) -> list:
    """The kernel's column ranges ``[j0, j1)`` of a row of ``V`` columns
    in ``S`` splits (``csrc/sample.cu::split_range``): ``ceil(V / S)``
    rounded up to a multiple of 4, the last cut at ``V``, any after it
    empty."""
    w = (-(-V // S) + 3) // 4 * 4
    return [(min(V, s * w), min(V, s * w + w)) for s in range(S)]


def _slots(device: torch.device) -> int:
    if device.index not in _SLOTS:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            build.check(build.load_library().sample_slots(ctypes.byref(n)),
                        "sample_slots")
        _SLOTS[device.index] = n.value
    return _SLOTS[device.index]


def reserve(device, max_batch: int) -> tuple:
    """The device's workspace, grown (never while a stream captures) to
    hold batches of up to ``max_batch`` rows: the per-row counters (zero
    between calls) and every (row, split) partial, ``max(4 * slots, B)``
    entries, which bounds ``B * split_count(B, V)``.  An engine reserves
    its batch at construction (:class:`~repro_torch.serving.sampling.
    SlotSampler`)."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    need = max(4 * _slots(device), max_batch)
    ws = _WORKSPACE.get(device.index)
    if ws is not None and ws[0] >= max_batch and ws[1] >= need:
        return ws
    build.require(not torch.cuda.is_current_stream_capturing(),
                  f"sample: the workspace for {max_batch} rows must be "
                  "reserved before a capture (sampling.reserve)")
    if ws is not None:
        _RETIRED.append(ws)
        max_batch, need = max(max_batch, ws[0]), max(need, ws[1])
    counters = torch.zeros(max_batch, dtype=torch.int32, device=device)
    values = torch.empty(need, dtype=torch.float32, device=device)
    indices = torch.empty(need, dtype=torch.int32, device=device)
    _WORKSPACE[device.index] = ws = (max_batch, need, counters, values,
                                     indices)
    return ws


def sample_cuda(logits: torch.Tensor, temperatures: torch.Tensor,
                keys: torch.Tensor, steps: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no sync) -> (B,)
    int64 tokens.  One workspace a device: calls on two streams of one
    device must not overlap (the port samples on one)."""
    B = _check(logits, temperatures, keys, steps)
    out = torch.empty(B, dtype=torch.int64, device=logits.device)
    if B:
        _, _, counters, values, indices = reserve(logits.device, B)
        S = split_count(B, logits.shape[1], _slots(logits.device))
        temperatures = temperatures.contiguous()
        steps = steps.contiguous()
        err = build.load_library().sample_launch(
            logits.data_ptr(), logits.stride(0), temperatures.data_ptr(),
            keys.data_ptr(), steps.data_ptr(), out.data_ptr(),
            values.data_ptr(), indices.data_ptr(), counters.data_ptr(), B,
            logits.shape[1], S, build.stream_of(logits))
        build.check(err, "sample")
        build.count("sample")
    return out


def probe_cuda(keys: torch.Tensor, steps: torch.Tensor, V: int) -> tuple:
    """The kernel's hash, uniform and noise for every element, through the
    helpers the sampler runs (a second, small kernel; no serving path
    calls it and it counts no launch): keys (B, 2), steps (B,) int64 on
    one CUDA device -> bits (B, V) int64 holding uint32s, uniforms and
    Gumbel noise (B, V) float32."""
    B = keys.shape[0]
    build.require(keys.is_cuda and steps.device == keys.device
                  and keys.shape == (B, 2) and steps.shape == (B,)
                  and keys.dtype == steps.dtype == torch.int64
                  and 1 <= B <= 65535 and 1 <= V < 2 ** 31,
                  "probe: keys (B, 2) and steps (B,) int64 on one CUDA "
                  "device, 1 <= B <= 65535")
    bits, u, g = (torch.empty((B, V), dtype=dt, device=keys.device)
                  for dt in (torch.int32, torch.float32, torch.float32))
    err = build.load_library().sample_probe_launch(
        keys.contiguous().data_ptr(), steps.contiguous().data_ptr(),
        bits.data_ptr(), u.data_ptr(), g.data_ptr(), B, V,
        build.stream_of(keys))
    build.check(err, "sample_probe")
    return bits.to(torch.int64) & MASK, u, g
