"""Port CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA card every test skips (the CUDA kernels have no CPU mode).
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def cuda():
    """Decided here, not at import: every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("m,k,n,g", [(64, 32, 32, 4), (256, 64, 128, 16),
                                     (1280, 256, 512, 66)])
def test_grouped_gemm_cuda_vs_plain(cuda, m, k, n, g, dtype, tol, rng):
    sizes = torch.as_tensor(rng.multinomial(m - 8, np.ones(g) / g),
                            device=cuda)
    sizes[1] = 0
    x = torch.as_tensor(rng.normal(size=(m, k)), device=cuda).to(dtype)
    w = torch.as_tensor(rng.normal(size=(g, k, n)) * 0.1,
                        device=cuda).to(dtype)
    out = ops.grouped_gemm(x, w, sizes, impl="cuda")
    exp = ops.grouped_gemm(x, w, sizes, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,kv,hd,s", [(2, 8, 2, 32, 64),
                                         (8, 128, 8, 64, 256)])
def test_flash_decode_cuda_vs_plain(cuda, b, h, kv, hd, s, dtype, tol, rng):
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), device=cuda).to(dtype)
    k = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    v = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    lengths = torch.as_tensor(rng.integers(1, 2 * s, size=b), device=cuda)
    out = ops.flash_decode(q, k, v, lengths, impl="cuda")
    exp = ops.flash_decode(q, k, v, lengths, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_combine_cuda_vs_plain(cuda, dtype, tol, rng):
    x = torch.as_tensor(rng.normal(size=(64, 8, 7168)), device=cuda).to(dtype)
    w = torch.as_tensor(rng.random(size=(64, 8)), device=cuda).float()
    out = ops.combine_weighted(x, w, impl="cuda")
    exp = ops.combine_weighted(x, w, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


def _paged_inputs(cuda, rng, b, h, kv, hd, bs, dtype):
    """A pool of 8 blocks per sequence plus scratch, tables a permutation,
    lengths from 1 to past the view width."""
    mb = 8
    nb = b * mb + 1
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), device=cuda).to(dtype)
    kp = torch.as_tensor(rng.normal(size=(nb, bs, kv, hd)),
                         device=cuda).to(dtype)
    vp = torch.as_tensor(rng.normal(size=(nb, bs, kv, hd)),
                         device=cuda).to(dtype)
    tables = torch.as_tensor(rng.permutation(np.arange(1, nb))
                             .reshape(b, mb), device=cuda)
    lengths = torch.as_tensor(rng.integers(1, mb * bs + 9, size=b),
                              device=cuda)
    return q, kp, vp, tables, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,kv,hd,bs", [(2, 8, 2, 32, 8),
                                          (8, 128, 8, 64, 16)])
def test_paged_flash_decode_cuda_vs_plain(cuda, b, h, kv, hd, bs, dtype, tol,
                                          rng):
    args = _paged_inputs(cuda, rng, b, h, kv, hd, bs, dtype)
    out = ops.paged_flash_decode(*args, impl="cuda")
    exp = ops.paged_flash_decode(*args, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16, 32, 12])
def test_paged_cuda_equals_dense_cuda_on_gathered_view(cuda, bs, dtype, rng):
    q, kp, vp, tables, lengths = _paged_inputs(cuda, rng, 4, 16, 2, 64, bs,
                                               dtype)
    b, mb = tables.shape
    kd = kp[tables].reshape(b, mb * bs, *kp.shape[2:])
    vd = vp[tables].reshape(b, mb * bs, *vp.shape[2:])
    assert torch.equal(
        ops.paged_flash_decode(q, kp, vp, tables, lengths, impl="cuda"),
        ops.flash_decode(q, kd, vd, lengths, impl="cuda"))


# ---- split-KV edges: chunk boundaries, lengths past the view, grid sizes --

def _edge_lengths(b, s):
    """1, exactly one chunk, one past it, past S, 0 (zero output), then
    the rest spread over the view."""
    base = [1, 64, 65, s + 7, 0, s, 128, 129]
    return [base[i] if i < len(base) else 1 + (37 * i) % s
            for i in range(b)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,kv,hd,s", [
    (3, 8, 2, 32, 64),        # one chunk: pass 1 writes the output
    (8, 32, 2, 64, 320),      # B*KV = 16 blocks per chunk, < 132 SMs
    (24, 128, 8, 64, 200),    # B*KV = 192 > 132 SMs, ragged last chunk
    (5, 4, 4, 128, 130),      # G = 1, hd = 128
    (4, 64, 2, 16, 256),      # G = 32: two m16 tiles, hd = 16
    (8, 64, 8, 112, 200),     # kimi-k2's G = 8, hd = 112
    (3, 12, 2, 40, 130),      # hd = 40: rows zero-padded to 48 (bf16)
    (4, 6, 2, 33, 100),       # hd = 33: rows staged element by element
])
def test_flash_decode_split_edges(cuda, b, h, kv, hd, s, dtype, tol, rng):
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), device=cuda).to(dtype)
    k = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    v = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    lengths = torch.as_tensor(_edge_lengths(b, s), device=cuda)
    out = ops.flash_decode(q, k, v, lengths, impl="cuda")
    live = lengths > 0
    exp = ops.flash_decode(q, k, v, lengths, impl="torch")
    torch.testing.assert_close(out[live].float(), exp[live].float(),
                               rtol=tol, atol=tol)
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [8, 16, 32, 12])
def test_paged_split_edges_equal_dense(cuda, bs, dtype, rng):
    """Chunk-boundary lengths through a paged pool: torch.equal to the
    dense kernel over the gathered view, and close to the plain version."""
    b, h, kv, hd, mb = 8, 32, 2, 64, 12
    nb = b * mb + 1
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), device=cuda).to(dtype)
    kp = torch.as_tensor(rng.normal(size=(nb, bs, kv, hd)),
                         device=cuda).to(dtype)
    vp = torch.as_tensor(rng.normal(size=(nb, bs, kv, hd)),
                         device=cuda).to(dtype)
    tables = torch.as_tensor(rng.permutation(np.arange(1, nb))
                             .reshape(b, mb), device=cuda)
    lengths = torch.as_tensor(_edge_lengths(b, mb * bs), device=cuda)
    kd = kp[tables].reshape(b, mb * bs, kv, hd)
    vd = vp[tables].reshape(b, mb * bs, kv, hd)
    out = ops.paged_flash_decode(q, kp, vp, tables, lengths, impl="cuda")
    assert torch.equal(out, ops.flash_decode(q, kd, vd, lengths,
                                             impl="cuda"))
    live = lengths > 0
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    exp = ops.paged_flash_decode(q, kp, vp, tables, lengths, impl="torch")
    torch.testing.assert_close(out[live].float(), exp[live].float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [112, 40, 33])
def test_paged_head_widths_equal_dense(cuda, hd, dtype, rng):
    """Head widths off the 16-wide mma grid, through a bs-12 pool: torch.equal
    to the dense kernel over the gathered view, and close to the plain
    version."""
    q, kp, vp, tables, lengths = _paged_inputs(cuda, rng, 4, 16, 2, hd, 12,
                                               dtype)
    b, mb = tables.shape
    kd = kp[tables].reshape(b, mb * 12, *kp.shape[2:])
    vd = vp[tables].reshape(b, mb * 12, *vp.shape[2:])
    out = ops.paged_flash_decode(q, kp, vp, tables, lengths, impl="cuda")
    assert torch.equal(out, ops.flash_decode(q, kd, vd, lengths,
                                             impl="cuda"))
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    exp = ops.paged_flash_decode(q, kp, vp, tables, lengths, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_unaligned_inputs(cuda, dtype, rng):
    """q, k and v whose bases are not 16-byte aligned (views one element
    in) take the element-wise staging and still match the plain version."""
    b, h, kv, hd, s = 3, 16, 2, 64, 130

    def shifted(*shape):
        n = int(np.prod(shape))
        flat = torch.as_tensor(rng.normal(size=n + 1), device=cuda).to(dtype)
        return flat[1:].view(*shape)
    q, k, v = shifted(b, h, hd), shifted(b, s, kv, hd), shifted(b, s, kv, hd)
    assert q.data_ptr() % 16 != 0
    lengths = torch.as_tensor([1, 65, 200], device=cuda)
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(
        ops.flash_decode(q, k, v, lengths, impl="cuda").float(),
        ops.flash_decode(q, k, v, lengths, impl="torch").float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
def test_decode_kernels_run_twice_bitwise(cuda, rng):
    """No atomics in the split-KV combine: two runs are torch.equal."""
    b, h, kv, hd, bs, mb = 8, 128, 8, 64, 16, 64
    q, kp, vp, tables, lengths = _paged_inputs(cuda, rng, b, h, kv, hd, bs,
                                               torch.bfloat16)
    tables = torch.as_tensor(rng.permutation(np.arange(1, b * mb + 1))
                             .reshape(b, mb), device=cuda)
    kp = torch.as_tensor(rng.normal(size=(b * mb + 1, bs, kv, hd)),
                         device=cuda).to(torch.bfloat16)
    vp = kp.flip(0).contiguous()
    lengths = torch.as_tensor(rng.integers(64, 545, size=b), device=cuda)
    kd = kp[tables].reshape(b, mb * bs, kv, hd)
    vd = vp[tables].reshape(b, mb * bs, kv, hd)
    for fn, args in ((ops.flash_decode, (q, kd, vd, lengths)),
                     (ops.paged_flash_decode, (q, kp, vp, tables, lengths))):
        first = fn(*args, impl="cuda")
        assert torch.equal(first, fn(*args, impl="cuda"))


# ---- grouped GEMM edges: the in-kernel scan and the zero tail ------------

GG_EDGES = {
    # name: (M, K, N, sizes)
    "all_empty": (96, 64, 64, [0] * 6),
    "sizes_003555": (32, 128, 96, [0, 0, 3, 5, 5, 5]),
    "one_group": (200, 64, 128, [0, 0, 200, 0]),
    "sum_below_m": (300, 256, 200, "150 over 8"),
    "g_above_66": (1280, 128, 64, "1000 over 130"),
    "m_ragged": (100, 72, 136, "100 over 5"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(GG_EDGES))
def test_grouped_gemm_edges(cuda, case, dtype, tol, rng):
    m, k, n, sizes = GG_EDGES[case]
    if isinstance(sizes, str):
        live, g = (int(t) for t in sizes.split(" over "))
        sizes = rng.multinomial(live, np.ones(g) / g)
    g = len(sizes)
    sizes = torch.as_tensor(np.asarray(sizes), device=cuda)
    x = torch.as_tensor(rng.normal(size=(m, k)), device=cuda).to(dtype)
    w = torch.as_tensor(rng.normal(size=(g, k, n)) * 0.1,
                        device=cuda).to(dtype)
    out = ops.grouped_gemm(x, w, sizes, impl="cuda")
    exp = ops.grouped_gemm(x, w, sizes, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)
    live = int(sizes.sum())
    assert torch.equal(out[live:], torch.zeros_like(out[live:]))
    # int32 sizes (cast to the kernel's int64 by the wrapper) give the same
    assert torch.equal(out, ops.grouped_gemm(x, w, sizes.to(torch.int32),
                                             impl="cuda"))


@pytest.mark.cuda
def test_grouped_gemm_run_twice_bitwise(cuda, rng):
    """Each output tile has one writer (no split-K atomics): two runs over
    garbage-filled outputs are torch.equal."""
    m, k, n, g = 1280, 1024, 512, 66
    sizes = torch.as_tensor(rng.multinomial(1000, np.ones(g) / g),
                            device=cuda)
    x = torch.as_tensor(rng.normal(size=(m, k)),
                        device=cuda).to(torch.bfloat16)
    w = torch.as_tensor(rng.normal(size=(g, k, n)) * 0.05,
                        device=cuda).to(torch.bfloat16)
    first = ops.grouped_gemm(x, w, sizes, impl="cuda")
    torch.empty(m * n * 4, device=cuda).fill_(float("nan"))   # dirty pool
    assert torch.equal(first, ops.grouped_gemm(x, w, sizes, impl="cuda"))


# ---- combine over the servers' response buffers (slot entry) -------------

def _slot_inputs(cuda, rng, T, k, S, C, d, dtype, *, layout="list",
                 addend=True, offset=0):
    """S response buffers (C, d) (as a list, or one (S, C, d) tensor), slots
    (T, k) over distinct rows with ~10 % dropped and every slot of token 0
    dropped, and an addend (T, d).  ``offset`` elements shift every base
    off the 16-byte grid."""
    n = S * C * d
    flat = torch.as_tensor(rng.normal(size=n + offset),
                           device=cuda).to(dtype)[offset:]
    stacked = flat.view(S, C, d)
    responses = list(stacked.unbind(0)) if layout == "list" else stacked
    slots = rng.permutation(S * C)[:T * k].reshape(T, k)
    slots[rng.random((T, k)) < 0.1] = -1
    if T:
        slots[0] = -1
    slots = torch.as_tensor(slots, device=cuda)
    add = (torch.as_tensor(rng.normal(size=(T, d)), device=cuda).to(dtype)
           if addend else None)
    return responses, stacked, slots, add


def _check_slots(responses, stacked, slots, add, tol):
    """Close to the plain version, and bitwise: equal to the plain
    sequential loop, to the direct entry over the gathered view with 0/1
    weights (+ the addend added after it), and to a second run."""
    out = ops.combine_slots(responses, slots, addend=add, impl="cuda")
    exp = ops.combine_slots(responses, slots, addend=add, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)
    assert torch.equal(out, exp)
    T, k = slots.shape
    d = stacked.shape[-1]
    gathered = stacked.reshape(-1, d)[slots.clamp(min=0)].reshape(T, k, d)
    direct = ops.combine_weighted(gathered, (slots >= 0).float(),
                                  impl="cuda")
    assert torch.equal(out, direct if add is None else direct + add)
    assert torch.equal(out, ops.combine_slots(responses, slots, addend=add,
                                              impl="cuda"))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T", [8, 512])
@pytest.mark.parametrize("addend", [False, True])
def test_combine_slots_cuda_deepseek_width(cuda, T, addend, dtype, tol, rng):
    """deepseek-r1's combine: 4 servers x C = 1280, top-8, d = 7168."""
    _check_slots(*_slot_inputs(cuda, rng, T, 8, 4, 1280, 7168, dtype,
                               addend=addend), tol)


SLOT_EDGES = {
    # name: (T, k, S, C, d, layout, offset)
    "T0": (0, 8, 4, 64, 256, "list", 0),
    "k1": (16, 1, 4, 64, 256, "list", 0),
    "S1": (16, 8, 1, 256, 256, "list", 0),
    "S1_tensor": (16, 8, 1, 256, 256, "tensor", 0),
    "S16_list": (32, 8, 16, 64, 512, "list", 0),
    "S4_tensor": (32, 8, 4, 128, 512, "tensor", 0),
    "d7164_scalar": (8, 8, 4, 64, 7164, "list", 0),
    "offset_base_scalar": (8, 8, 4, 64, 7168, "list", 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", sorted(SLOT_EDGES))
def test_combine_slots_cuda_edges(cuda, case, dtype, tol, rng):
    T, k, S, C, d, layout, offset = SLOT_EDGES[case]
    inputs = _slot_inputs(cuda, rng, T, k, S, C, d, dtype, layout=layout,
                          offset=offset)
    if offset:
        assert inputs[1].data_ptr() % 16 != 0
    out = _check_slots(*inputs, tol)
    if T:                                # token 0: every slot dropped
        assert torch.equal(out[0], inputs[3][0])


@pytest.mark.cuda
def test_combine_slots_cuda_graph_capture(cuda, rng):
    """The S buffer addresses travel in the launch's parameters: a captured
    launch replays over the buffers' new contents."""
    responses, stacked, slots, add = _slot_inputs(
        cuda, rng, 8, 8, 4, 1280, 7168, torch.bfloat16)
    ops.combine_slots(responses, slots, addend=add, impl="cuda")   # build
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = ops.combine_slots(responses, slots, addend=add, impl="cuda")
    stacked.copy_(torch.as_tensor(rng.normal(size=tuple(stacked.shape)),
                                  device=cuda).to(torch.bfloat16))
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ops.combine_slots(responses, slots, addend=add,
                                              impl="torch"))


# ------------------------------------------------- control-plane weight paths

def _stacked_servers(device, E, S, red, d, f, dtype, seed=0):
    """(2, S, L, ...) per-server weights with the redundant slots filled, as
    ``init_eaas_moe(lead=(2,))`` lays them out."""
    from repro_torch.core import expert_server

    gen = torch.Generator(device="cpu").manual_seed(seed)
    out = {}
    for name, (a, b) in (("w_gate", (d, f)), ("w_up", (d, f)),
                         ("w_down", (f, d))):
        w = torch.empty((2, S, E // S + red.shape[1], a, b), dtype=dtype)
        w[:, :, :E // S] = torch.randn((2, S, E // S, a, b),
                                       generator=gen).to(dtype)
        out[name] = expert_server.fill_redundant(w, E, red).to(device)
    return out


@pytest.mark.cuda
def test_migrate_slots_on_card_equals_cpu_bitwise(cuda):
    from repro_torch.core import expert_server, load_balance

    E, S = 64, 4
    red_old = np.array([[5, -1], [17, 40], [-1, 2], [63, 20]], np.int32)
    red_new = np.array([[40, 7], [17, -1], [2, 33], [-1, 0]], np.int32)
    _, updates = load_balance.migration_updates(red_old, red_new)
    per = E // S
    copies = [(s, per + j, e) for s, j, _, e in updates]
    card = _stacked_servers(cuda, E, S, red_old, 256, 128, torch.bfloat16)
    host = {k: v.cpu() for k, v in card.items()}
    ptrs = {k: v.data_ptr() for k, v in card.items()}
    expert_server.migrate_slots(card, E, copies)
    expert_server.migrate_slots(host, E, copies)
    for k in card:
        assert card[k].data_ptr() == ptrs[k]            # in place
        assert torch.equal(card[k].cpu(), host[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("new_servers", [8, 2])
def test_reshard_on_card_equals_cpu_and_bounds_peak(cuda, new_servers):
    """E = 64, d = 1024 in bf16: the card's per-tensor reshard equals the
    CPU's bitwise, and its peak stays within the larger of the resident
    weights before and after plus one stacked tensor (the larger of old
    and new) plus 5 % — growing, the last name is built on top of the
    others' new tensors."""
    from repro_torch.core import expert_server, load_balance

    E, S, d, f = 64, 4, 1024, 512
    red = load_balance.eplb_plan(np.arange(E, dtype=float), S, 2)[1]
    new_red = load_balance.eplb_plan(np.arange(E, dtype=float)[::-1],
                                     new_servers, 2)[1]
    card = _stacked_servers(cuda, E, S, red, d, f, torch.bfloat16)
    host = {k: v.cpu() for k, v in card.items()}
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    L2 = E // new_servers + 2
    one = 2 * max(new_servers * L2, S * (E // S + 2)) * d * f * 2  # bf16
    torch.cuda.reset_peak_memory_stats()
    expert_server.reshard_server_weights(card, E, new_servers, new_red)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    after = torch.cuda.memory_allocated()
    expert_server.reshard_server_weights(host, E, new_servers, new_red)
    for k in card:
        assert card[k].shape == (2, new_servers, L2, *host[k].shape[-2:])
        assert torch.equal(card[k].cpu(), host[k]), k
    assert peak <= max(resident, after) + 1.05 * one, (peak, resident, after)


@pytest.mark.cuda
def test_expert_output_independent_of_placement(cuda):
    """The identity the elastic serve rests on: a token's expert output
    does not depend on which server, slot or group count computes it —
    one server of 66 slots vs the same experts spread over 8 servers of
    10 slots, with replicas (bitwise, bf16)."""
    from repro_torch.core import expert_server
    from repro_torch.core.expert_server import ServerWeights

    E, d, f, C = 64, 512, 256, 96
    gen = torch.Generator(device="cpu").manual_seed(3)
    bank = {k: (torch.randn((E, a, b), generator=gen) / a ** 0.5).to(
        torch.bfloat16).to(cuda)
        for k, (a, b) in (("w_gate", (d, f)), ("w_up", (d, f)),
                          ("w_down", (f, d)))}
    x = torch.randn((1, C, d), generator=gen).to(torch.bfloat16).to(cuda)
    eid = torch.randint(0, E, (1, C), generator=gen).to(cuda)
    sc = torch.rand((1, C), generator=gen).to(cuda)

    def run(S, red):
        sw = expert_server.build_server_weights(bank, S, red)
        local = expert_server.make_local_table(E, S, red)
        # each token to one server hosting its expert, spread by index
        hosts = [np.flatnonzero(local[:, e] >= 0) for e in range(E)]
        owner = torch.as_tensor([hosts[e][t % len(hosts[e])] for t, e in
                                 enumerate(eid[0].tolist())], device=cuda)
        out = torch.zeros((C, d), dtype=torch.bfloat16, device=cuda)
        for s in range(S):
            mine = owner == s
            w = ServerWeights(sw["w_gate"][s], sw["w_up"][s],
                              sw["w_down"][s],
                              torch.as_tensor(local[s], device=cuda))
            y, st = expert_server.serve(
                x, torch.where(mine, eid, -1), sc,
                torch.tensor([C], device=cuda), w)
            assert int(st.miss) == 0
            out += torch.where(mine[:, None], y[0], 0)
        return out

    one = run(1, np.array([[3, 9]], np.int32))
    red8 = np.array([[9, 3], [1, -1], [17, 40], [-1, 2], [63, 20],
                     [5, 6], [7, -1], [0, 8]], np.int32)
    assert torch.equal(one, run(8, red8))


@pytest.mark.cuda
@pytest.mark.parametrize("live", [64, 4096])
def test_grouped_gemm_tp_shape(cuda, live, rng):
    """The TP mode's one server: G = 256 groups over C = 5120 rows (decode:
    64 live rows; prefill: 4096), narrow K and N so the plain loop stays
    quick; rows past the live ones come back zero."""
    G, C, K, N = 256, 5120, 256, 192
    sizes = torch.as_tensor(rng.multinomial(live, np.ones(G) / G),
                            device=cuda)
    x = torch.as_tensor(rng.normal(size=(C, K)), device=cuda).to(
        torch.bfloat16)
    w = torch.as_tensor(rng.normal(size=(G, K, N)) * K ** -0.5,
                        device=cuda).to(torch.bfloat16)
    out = ops.grouped_gemm(x, w, sizes, impl="cuda")
    exp = ops.grouped_gemm(x, w, sizes, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=2e-2,
                               atol=2e-2)
    assert not out[live:].any()


def _reduced_bf16():
    from repro_torch.configs import get_config
    return get_config("deepseek-r1").reduced()


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["monolithic_ep", "tp"])
def test_monolithic_moe_on_card_equals_cpu(cuda, mode):
    """Both baselines' MoE layers on the card (the CUDA kernels) against the
    port's plain versions on the CPU, same bf16 weights (bf16 tolerance)."""
    from repro_torch.core import monolithic

    cfg = _reduced_bf16()
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((24, cfg.d_model), generator=gen) * 0.3).to(
        torch.bfloat16)
    if mode == "tp":
        params = monolithic.init_tp_moe(cfg, torch.bfloat16, "cpu", gen)
        run = lambda p, a: monolithic.tp_moe_apply(p, a, cfg)  # noqa: E731
    else:
        params = monolithic.init_monolithic_ep(cfg, 4, torch.bfloat16,
                                               "cpu", gen)

        def run(p, a):
            rt = monolithic.monolithic_runtime(cfg, 4, a.shape[0], a.device)
            return monolithic.monolithic_ep_apply(p, a, cfg, rt)
    y_cpu, st_cpu = run(params, x)
    y_card, st_card = run(_to(params, cuda), x.to(cuda))
    torch.testing.assert_close(y_card.float().cpu(), y_cpu.float(),
                               rtol=2e-2, atol=2e-2)
    assert torch.equal(st_card.expert_load.cpu(), st_cpu.expert_load)
    assert int(st_card.miss) == int(st_cpu.miss) == 0


def _card_decoder(cuda, batch=4):
    from repro_torch.core import moe_layer
    from repro_torch.models.transformer import ParallelCtx, build_model

    cfg = _reduced_bf16()
    model = build_model(cfg, 4, np.zeros((4, 0), np.int32), cuda)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0))
    ctx = ParallelCtx(moe_runtime=moe_layer.default_runtime(
        cfg, 4, 4 * batch, cuda))
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, 6), generator=gen)
    _, cache, _ = model.prefill(params, prompt.to(cuda), ctx, max_slots=32)
    return cfg, model, params, ctx, cache, gen


def _clone_cache(cache):
    return {n: type(c)(c.k.clone(), c.v.clone(), c.length.clone())
            for n, c in cache.items()}


@pytest.mark.cuda
def test_pipelined_two_streams_equal_serialized_bitwise(cuda):
    """Pipelined decode (microbatch B on a second stream, joined by an
    event) gives logits and caches bitwise those of the serialized split
    (one stream), step after step on a reduced decoder in bf16."""
    from repro_torch.core.overlap import split_batch_decode

    cfg, model, params, ctx, cache, gen = _card_decoder(cuda)
    caches = {True: cache, False: _clone_cache(cache)}
    side = torch.cuda.Stream(cuda)
    for _ in range(4):
        tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen).to(
            cuda)
        logits = {}
        for enabled, c in caches.items():
            logits[enabled], _, _ = split_batch_decode(
                lambda t, c: model.decode_step(params, t, c, ctx), tok, c,
                axis=1, enabled=enabled, stream=side)
        torch.cuda.synchronize()
        assert torch.equal(logits[True], logits[False])
        for name in cache:
            for f in ("k", "v", "length"):
                assert torch.equal(getattr(caches[True][name], f),
                                   getattr(caches[False][name], f)), (name, f)


@pytest.mark.cuda
def test_pipelined_second_stream_runs_beside_the_first(cuda):
    """Microbatch B's stream waits for the caller's earlier work, not for
    microbatch A: while A's half still runs (a ~0.2 s spin on the caller's
    stream), B's half finishes.  Without a side stream on the card the
    pipelined split raises."""
    from repro_torch.core.overlap import split_batch_decode

    side = torch.cuda.Stream(cuda)
    done = {}

    def step(t, c):
        if not done:                      # microbatch A, the caller's stream
            torch.cuda._sleep(400_000_000)
            done["a"] = torch.cuda.Event()
            done["a"].record()
        else:                             # microbatch B, the side stream
            done["b"] = torch.cuda.Event()
            done["b"].record()
        return t.float() * 2, c, {"n": t.shape[0]}

    tok = torch.arange(4, device=cuda)[:, None]
    cache = {"k": torch.zeros(2, 4, 3, device=cuda)}
    logits, _, stats = split_batch_decode(step, tok, cache, axis=1,
                                          stream=side)
    deadline = time.monotonic() + 5.0
    while not done["b"].query() and time.monotonic() < deadline:
        time.sleep(1e-3)
    assert done["b"].query() and not done["a"].query()
    torch.cuda.synchronize()
    assert torch.equal(logits, tok.float() * 2) and stats == {"n": 4}
    with pytest.raises(ValueError, match="side stream"):
        split_batch_decode(step, tok, cache, axis=1)


@pytest.mark.cuda
def test_decode_masked_restores_rows_on_card(cuda):
    """The executor's decode_masked on the card: the inactive rows' K, V and
    length come back bitwise, the active rows' logits are bitwise a full
    decode's."""
    from repro_torch.serving import EngineConfig, ServingEngine, VirtualClock
    from repro_torch.serving.request import Request, SamplingParams

    cfg = _reduced_bf16()
    eng = ServingEngine(cfg, EngineConfig(max_batch=4, max_seq=64,
                                          pool_tokens_per_client=64),
                        clock=VirtualClock(), device=cuda)
    rng = np.random.default_rng(3)
    for i in range(4):
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, 5 + i)
                           .astype(np.int32),
                           SamplingParams(max_new_tokens=9)))
    for _ in range(5):
        eng.step()
    ex = eng.executor
    tokens = np.array([[3], [17], [250], [9]], np.int64)
    mask = np.array([False, True, True, False])
    before = _clone_cache(ex.cache)
    logits_m, _ = ex.decode_masked(tokens, mask)
    masked = _clone_cache(ex.cache)
    ex.cache = _clone_cache(before)
    logits_full, _ = ex.decode(tokens)
    active = torch.as_tensor(mask, device=cuda)
    assert torch.equal(logits_m[active], logits_full[active])
    for name, c in masked.items():
        for f in ("k", "v", "length"):
            got, old, new = (getattr(x[name], f)
                             for x in (masked, before, ex.cache))
            assert torch.equal(got[:, ~active], old[:, ~active]), (name, f)
            assert torch.equal(got[:, active], new[:, active]), (name, f)


@pytest.mark.cuda
def test_pool_client_runtime_masks_alive_on_card(cuda):
    """A cluster client's PoolClient view: its runtime's ``alive`` tensor
    lies on the card and drops the servers this client masked; the shared
    pool and a sibling's view are untouched."""
    from repro_torch.core.elastic import ServerPool

    pool = ServerPool(_reduced_bf16(), 4, tokens_per_client=8)
    mine, other = pool.client_view(0), pool.client_view(1)
    mine.mask_server(2)
    pool.server_failed(0)
    rt = mine.runtime(cuda)
    assert rt.alive.device.type == "cuda"
    assert rt.alive.cpu().tolist() == [False, True, False, True]
    assert other.runtime(cuda).alive.cpu().tolist() == [False, True, True,
                                                        True]
    assert pool.runtime(cuda).alive.cpu().tolist() == [False, True, True,
                                                       True]
    assert rt.mapping.device.type == "cuda"
    assert torch.equal(rt.mapping, pool.runtime(cuda).mapping)


def _async_engine(device, params):
    from repro_torch.serving import EngineConfig, ServingEngine, VirtualClock
    from repro_torch.serving.request import Request, SamplingParams

    cfg = _reduced_bf16()
    eng = ServingEngine(cfg, EngineConfig(max_batch=4, max_seq=64,
                                          pool_tokens_per_client=64,
                                          exec_mode="async"),
                        params=params, clock=VirtualClock(), device=device)
    rng = np.random.default_rng(5)
    for i in range(6):
        eng.submit(Request(i, rng.integers(0, cfg.vocab_size, 5 + i)
                           .astype(np.int32),
                           SamplingParams(max_new_tokens=6)))
    waves = []
    masked = eng.executor.decode_masked

    def record(tokens, mask):
        before = _clone_cache(eng.executor.cache)
        logits, load = masked(tokens, mask)
        waves.append((tokens.copy(), mask.copy(), before, logits.clone()))
        return logits, load
    eng.executor.decode_masked = record
    eng.run()
    return eng, waves


@pytest.mark.cuda
def test_async_wave_logits_on_card(cuda):
    """The async engine on the card: each wave's logits are bitwise those
    of ``decode_masked`` replayed on the same cache; its greedy tokens are
    their argmax; the first wave's logits agree with the CPU port's on the
    same weights within bf16 tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    from repro_torch.models.transformer import build_model
    cfg = _reduced_bf16()
    model = build_model(cfg, 4, np.zeros((4, 0), np.int32), cuda)
    params = model.init_params(gen)
    eng, waves = _async_engine(cuda, params)
    assert eng.metrics.completed == 6 and len(waves) > 3
    ex = eng.executor
    keep = ex.cache
    for tokens, mask, before, logits in waves[:3]:
        ex.cache = _clone_cache(before)
        again, _ = ex.decode_masked(tokens, mask)
        assert torch.equal(again, logits)
    ex.cache = keep
    cpu_eng, cpu_waves = _async_engine("cpu", _to(params, "cpu"))
    tokens, mask, _, logits = waves[0]
    ctok, cmask, _, clogits = cpu_waves[0]
    assert np.array_equal(tokens, ctok) and np.array_equal(mask, cmask)
    rows = torch.as_tensor(mask)
    torch.testing.assert_close(logits.cpu()[rows].float(),
                               clogits[rows].float(), rtol=3e-2, atol=3e-2)


@pytest.mark.cuda
def test_cluster_writes_the_shared_bank_once_on_card(cuda):
    """Four clients on the card hold one bank: building them allocates no
    second copy; a one-shot rebalance calls ``migrate_slots`` on one
    executor only; after it and ``scale_to`` 8 -> 2 -> 4 the bank is
    bitwise a 1-client cluster's on the same traffic."""
    from repro_torch.serving import (Cluster, ClusterConfig, EngineConfig,
                                     Request, SamplingParams, VirtualClock,
                                     zipf_bias)

    cfg = _reduced_bf16()
    ecfg = EngineConfig(max_batch=4, max_seq=64, pool_tokens_per_client=64)
    banks, calls = [], []
    for n in (1, 4):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        cl = Cluster(cfg, ClusterConfig(clients=n, engine=ecfg), seed=0,
                     clock_factory=VirtualClock, device=cuda)
        torch.cuda.synchronize()
        banks.append(torch.cuda.memory_allocated() - base)
        assert all(c.params is cl.params for c in cl.clients)
        cl.set_skew(zipf_bias(cfg.moe.num_experts, 1.2, scale=2.0))
        rng = np.random.default_rng(1)
        for i in range(8):
            cl.submit(Request(i, rng.integers(0, cfg.vocab_size, 8)
                              .astype(np.int32),
                              SamplingParams(max_new_tokens=4)))
        cl.run()
        count = [0] * n
        for i, c in enumerate(cl.clients):
            def counted(copies, i=i, f=c.executor.migrate_slots):
                count[i] += 1
                return f(copies)
            c.executor.migrate_slots = counted
        cl.rebalance()
        assert cl.metrics.rebalances == 1
        calls.append(count)
        for size in (8, 2, 4):
            cl.scale_to(size)
        sw = cl.params["blocks"]["moe"]["servers"]
        banks[-1] = (banks[-1], {k: v.clone() for k, v in sw.items()})
        del cl
    (one, w1), (four, w4) = banks
    assert calls == [[1], [1, 0, 0, 0]]
    bank = sum(w.numel() * w.element_size() for w in w1.values())
    # three more clients add their KV caches, not a second bank
    assert four - one < 0.25 * bank
    for k in w1:
        assert torch.equal(w1[k], w4[k]), k


# ---- decode attention past hd = 128, softcap, ring caches ------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("b,h,kv,hd,s", [
    (8, 8, 4, 256, 1024),     # gemma3-4b: G = 2, a local layer's ring
    (8, 8, 4, 256, 2048),     # gemma3-4b: a global layer at max_seq 2048
    (3, 24, 1, 160, 130),     # G = 24: two m16 tiles at a staged 160
    (4, 16, 2, 200, 100),     # hd = 200: staged 224, two warps of 112
    (4, 6, 2, 129, 70),       # hd = 129: element-wise staging, staged 160
])
def test_flash_decode_wide_heads(cuda, b, h, kv, hd, s, dtype, tol, rng):
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), device=cuda).to(dtype)
    k = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    v = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    lengths = torch.as_tensor(_edge_lengths(b, s), device=cuda)
    out = ops.flash_decode(q, k, v, lengths, impl="cuda")
    live = lengths > 0
    exp = ops.flash_decode(q, k, v, lengths, impl="torch")
    torch.testing.assert_close(out[live].float(), exp[live].float(),
                               rtol=tol, atol=tol)
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))
    assert torch.equal(out, ops.flash_decode(q, k, v, lengths, impl="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs", [16, 12])
def test_paged_hd256_equals_dense(cuda, bs, dtype, rng):
    """The paged kernel at hd = 256 is torch.equal to the dense one over
    the gathered view and close to the plain version."""
    q, kp, vp, tables, lengths = _paged_inputs(cuda, rng, 4, 8, 4, 256, bs,
                                               dtype)
    b, mb = tables.shape
    kd = kp[tables].reshape(b, mb * bs, *kp.shape[2:])
    vd = vp[tables].reshape(b, mb * bs, *vp.shape[2:])
    out = ops.paged_flash_decode(q, kp, vp, tables, lengths, impl="cuda")
    assert torch.equal(out, ops.flash_decode(q, kd, vd, lengths,
                                             impl="cuda"))
    tol = 1e-5 if dtype == torch.float32 else 3e-2
    exp = ops.paged_flash_decode(q, kp, vp, tables, lengths, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cap", [50.0, 1.5])
@pytest.mark.parametrize("hd", [64, 256])
def test_decode_softcap(cuda, hd, cap, dtype, tol, rng):
    """cap * tanh(s / cap) on the scaled scores, dense and paged; at cap
    1.5 the capped output differs from the uncapped one."""
    b, h, kv, s = 4, 8, 2, 300
    q = torch.as_tensor(rng.normal(size=(b, h, hd)) * 3,
                        device=cuda).to(dtype)
    k = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    v = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    lengths = torch.as_tensor([1, 64, 200, 300], device=cuda)
    out = ops.flash_decode(q, k, v, lengths, softcap=cap, impl="cuda")
    exp = ops.flash_decode(q, k, v, lengths, softcap=cap, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)
    if cap < 2:
        plain = ops.flash_decode(q, k, v, lengths, impl="torch")
        assert (exp.float() - plain.float()).abs().max() > 10 * tol
    args = _paged_inputs(cuda, rng, 4, h, kv, hd, 16, dtype)
    pout = ops.paged_flash_decode(*args, softcap=cap, impl="cuda")
    pexp = ops.paged_flash_decode(*args, softcap=cap, impl="torch")
    torch.testing.assert_close(pout.float(), pexp.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_decode_wrapped_ring(cuda, dtype, tol, rng):
    """A sliding-window ring (64 slots, lengths past it, written at
    length % 64) read unchanged: the kernel equals the plain version and
    the same keys laid out in time order."""
    b, h, kv, hd, w = 4, 8, 4, 256, 64
    lengths = torch.as_tensor([30, 64, 65, 1000], device=cuda)
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), device=cuda).to(dtype)
    k = torch.as_tensor(rng.normal(size=(b, w, kv, hd)),
                        device=cuda).to(dtype)
    v = torch.as_tensor(rng.normal(size=(b, w, kv, hd)),
                        device=cuda).to(dtype)
    out = ops.flash_decode(q, k, v, lengths, impl="cuda")
    torch.testing.assert_close(
        out.float(), ops.flash_decode(q, k, v, lengths, impl="torch").float(),
        rtol=tol, atol=tol)
    # rotate each ring into time order: oldest slot first
    order = [(torch.arange(w, device=cuda) + int(n) % w) % w
             if int(n) > w else torch.arange(w, device=cuda)
             for n in lengths.tolist()]
    kt = torch.stack([k[i, o] for i, o in enumerate(order)]).contiguous()
    vt = torch.stack([v[i, o] for i, o in enumerate(order)]).contiguous()
    torch.testing.assert_close(
        out.float(), ops.flash_decode(q, kt, vt, lengths, impl="cuda").float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(7168, 4864), (4864, 7168)])
def test_grouped_gemm_arctic_shape(cuda, k, n, rng):
    """Arctic's expert server: G = 34 hosted experts (32 primaries and 2
    replicas), a decode's 40 live rows of C = 128."""
    g, m = 34, 128
    sizes = torch.as_tensor(rng.multinomial(40, np.ones(g) / g), device=cuda)
    x = torch.as_tensor(rng.normal(size=(m, k)),
                        device=cuda).to(torch.bfloat16)
    w = (torch.randn(g, k, n, device=cuda,
                     generator=torch.Generator(cuda).manual_seed(0))
         * 0.02).to(torch.bfloat16)
    out = ops.grouped_gemm(x, w, sizes, impl="cuda")
    exp = ops.grouped_gemm(x, w, sizes, impl="torch")
    torch.testing.assert_close(out.float(), exp.float(), rtol=2e-2,
                               atol=2e-2)
    assert torch.equal(out[40:], torch.zeros_like(out[40:]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("case", ["zamba2 shared block", "whisper self",
                                  "whisper cross"])
def test_flash_decode_g1_shapes(cuda, case, dtype, tol, rng):
    """G = 1 (one query head per KV head: one row of the m16 tile):
    zamba2's shared block (32 heads over 32 KV heads of hd 80, 2048
    slots), whisper's decoder self-attention (448 slots, hd 64) and its
    cross-attention (1500 encoder positions, every one valid); hd 80 in
    fp32 is the FMA body's 8-wide rows.  Against the plain version, and
    run twice bitwise."""
    b, h, hd, s, lens = {
        "zamba2 shared block": (4, 32, 80, 2048, [256, 1056, 1, 2048]),
        "whisper self": (4, 8, 64, 448, [16, 96, 65, 448]),
        "whisper cross": (4, 8, 64, 1500, [1500] * 4)}[case]
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), device=cuda).to(dtype)
    k, v = (torch.as_tensor(rng.normal(size=(b, s, h, hd)),
                            device=cuda).to(dtype) for _ in range(2))
    lengths = torch.as_tensor(lens, device=cuda)
    out = ops.flash_decode(q, k, v, lengths, impl="cuda")
    torch.testing.assert_close(
        out.float(), ops.flash_decode(q, k, v, lengths, impl="torch").float(),
        rtol=tol, atol=tol)
    assert torch.equal(out, ops.flash_decode(q, k, v, lengths, impl="cuda"))


# ---- training: the grouped GEMM's backward kernels and the autograd path

def _bwd_inputs(cuda, rng, m, k, n, sizes, dtype, scale=1.0):
    g = len(sizes)
    x = torch.as_tensor(rng.normal(size=(m, k)) * scale,
                        device=cuda).to(dtype)
    dy = torch.as_tensor(rng.normal(size=(m, n)) * scale,
                         device=cuda).to(dtype)
    w = torch.as_tensor(rng.normal(size=(g, k, n)) * 0.1,
                        device=cuda).to(dtype)
    return x, dy, w, torch.as_tensor(sizes, device=cuda)


BWD_CASES = {"empty groups, rows past the sum": (96, 64, 48, [0, 20, 0, 30]),
             "G = 1": (64, 32, 80, [64]),
             "one group holds every row": (128, 96, 64, [0, 0, 128, 0]),
             "G = 130, ragged widths": (700, 72, 136, [5] * 130),
             # x and dy at 1/4: a 300-row sum of unit products reaches
             # ~50, where fp32's summation order alone moves a value by
             # ~1e-5; scaled, it stays ~3 as the other cases' sums do
             "a group of 300 rows, sizes off the 16-row grid":
                 (640, 192, 136, [300, 13, 0, 77, 5, 129]),
             "G = 1024": (2048, 64, 64, np.bincount(
                 np.random.default_rng(3).integers(0, 1024, 1800),
                 minlength=1024).tolist()),
             "many items, G = 128 of ~64 rows": (10240, 256, 128, np.bincount(
                 np.random.default_rng(4).integers(0, 128, 8192),
                 minlength=128).tolist())}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_grouped_gemm_backward_kernels_vs_plain(cuda, case, dtype, tol, rng):
    from repro_torch.kernels import grouped_gemm as kgg
    m, k, n, sizes = BWD_CASES[case]
    scale = 0.25 if max(sizes) > 256 else 1.0
    x, dy, w, sz = _bwd_inputs(cuda, rng, m, k, n, sizes, dtype, scale)
    dx = kgg.grouped_gemm_dx_cuda(dy, w, sz)
    torch.testing.assert_close(dx.float(),
                               kgg.grouped_gemm_dx_torch(dy, w, sz).float(),
                               rtol=tol, atol=tol)
    live = int(sz.sum())
    assert torch.equal(dx[live:], torch.zeros_like(dx[live:]))
    dw = kgg.grouped_gemm_dw_cuda(x, dy, sz)
    torch.testing.assert_close(dw.float(),
                               kgg.grouped_gemm_dw_torch(x, dy, sz).float(),
                               rtol=tol, atol=tol)
    empty = sz == 0
    assert torch.equal(dw[empty], torch.zeros_like(dw[empty]))
    # accumulate: added into what the buffer holds, empty groups untouched
    base = torch.as_tensor(rng.normal(size=dw.shape), device=cuda).to(dtype)
    got = kgg.grouped_gemm_dw_cuda(x, dy, sz, out=base.clone())
    exp = kgg.grouped_gemm_dw_torch(x, dy, sz, out=base.clone())
    torch.testing.assert_close(got.float(), exp.float(), rtol=tol, atol=tol)
    assert torch.equal(got[empty], base[empty])


@pytest.mark.cuda
def test_grouped_gemm_backward_kernels_run_twice_bitwise(cuda, rng):
    """bf16: each output tile has one writer, no atomics: two runs of dx,
    dw and dw accumulating agree bitwise."""
    from repro_torch.kernels import grouped_gemm as kgg
    m, k, n, sizes = BWD_CASES["many items, G = 128 of ~64 rows"]
    x, dy, w, sz = _bwd_inputs(cuda, rng, m, k, n, sizes, torch.bfloat16)
    assert torch.equal(kgg.grouped_gemm_dx_cuda(dy, w, sz),
                       kgg.grouped_gemm_dx_cuda(dy, w, sz))
    assert torch.equal(kgg.grouped_gemm_dw_cuda(x, dy, sz),
                       kgg.grouped_gemm_dw_cuda(x, dy, sz))
    assert torch.equal(kgg.grouped_gemm_dw_cuda(x, dy, sz, out=w.clone()),
                       kgg.grouped_gemm_dw_cuda(x, dy, sz, out=w.clone()))


@pytest.mark.cuda
def test_grouped_gemm_backward_bf16_needs_tma_alignment(cuda, rng):
    """The bf16 kernels load through TMA: an operand off the 16-byte grid
    or a width off a multiple of 8 raises rather than falling back."""
    from repro_torch.kernels import grouped_gemm as kgg
    m, k, n, sizes = BWD_CASES["empty groups, rows past the sum"]
    x, dy, w, sz = _bwd_inputs(cuda, rng, m, k, n, sizes, torch.bfloat16)
    off = torch.empty(m * n + 1, device=cuda,
                      dtype=torch.bfloat16)[1:].view(m, n).copy_(dy)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kgg.grouped_gemm_dx_cuda(off, w, sz)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kgg.grouped_gemm_dw_cuda(x, off, sz)
    with pytest.raises(ValueError, match="multiples of 8"):
        kgg.grouped_gemm_dw_cuda(x[:, :60].contiguous(), dy, sz)


@pytest.mark.cuda
def test_autograd_through_the_kernels_matches_the_cpu(cuda, rng):
    """ops.grouped_gemm and ops.combine_slots under grad: the card's
    backward kernels against the CPU's plain backward, float32."""
    from repro_torch.kernels import build
    m, k, n, sizes = BWD_CASES["empty groups, rows past the sum"]
    x, dy, w, sz = _bwd_inputs(cuda, rng, m, k, n, sizes, torch.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        xs = x.to(dev).requires_grad_()
        ws = w.to(dev).requires_grad_()
        build.reset_launches()
        out = ops.grouped_gemm(xs, ws, sz.to(dev))
        resp = out.reshape(2, m // 2, n)
        slot = torch.as_tensor([[0, 5, -1], [50, 95, 3]], device=dev)
        add = torch.ones((2, n), device=dev, requires_grad=True)
        y = ops.combine_slots(resp, slot, addend=add)
        (out * dy.to(dev)).sum().add((y * y).sum()).backward()
        grads[dev] = [t.grad.cpu() for t in (xs, ws, add)]
        if dev == "cuda":
            n_l = ops.launch_counts()
            assert n_l["grouped_gemm_dx"] == 1 and n_l["grouped_gemm_dw"] == 1
            assert n_l["grouped_gemm"] == 1 and n_l["combine_slots"] == 1
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_raw_wrappers_raise_under_grad(cuda):
    from repro_torch.kernels import combine as kcb
    from repro_torch.kernels import decode_attention as kda
    from repro_torch.kernels import grouped_gemm as kgg
    x = torch.zeros(8, 16, device=cuda, requires_grad=True)
    w = torch.zeros(2, 16, 16, device=cuda)
    sz = torch.tensor([4, 4], device=cuda)
    q = torch.zeros(1, 2, 16, device=cuda, requires_grad=True)
    kv = torch.zeros(1, 4, 1, 16, device=cuda)
    for call in (lambda: kgg.grouped_gemm_cuda(x, w, sz),
                 lambda: kgg.grouped_gemm_dx_cuda(x, w, sz),
                 lambda: kgg.grouped_gemm_dw_cuda(x, x, sz),
                 lambda: kcb.combine_slots_cuda(x.reshape(1, 8, 16),
                                                torch.zeros(2, 1, dtype=torch
                                                            .int64,
                                                            device=cuda)),
                 lambda: kda.flash_decode_cuda(q, kv, kv, torch.tensor(
                     [2], device=cuda))):
        with pytest.raises(RuntimeError, match="records no gradient"):
            call()
    with torch.no_grad():
        kgg.grouped_gemm_cuda(x, w, sz)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["deepseek-r1", "granite-3-2b"])
def test_loss_and_gradients_card_vs_cpu(cuda, arch):
    """A reduced model's loss_fn and every gradient leaf, float32: the card
    (kernels and backward kernels) against the CPU (plain versions)."""
    from repro_torch.configs import get_config
    from repro_torch.core.moe_layer import default_runtime
    from repro_torch.kernels import build
    from repro_torch.models.transformer import TrainCtx, build_model
    from repro_torch.training import tree
    from repro_torch.training.data import synthetic_lm_batches

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced().replace(dtype="float32")
    S = 2 if cfg.moe else 1
    batch = next(synthetic_lm_batches(cfg, 2, 32, seed=0))
    out, params0 = {}, None
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, S, np.zeros((S, 0), np.int32), dev)
        if params0 is None:
            params0 = model.init_params(torch.Generator().manual_seed(0))
        params = tree.map_params(
            lambda p: p.detach().clone().to(dev).requires_grad_(), params0)
        rt = default_runtime(cfg, S, 64, dev) if cfg.moe else None
        build.reset_launches()
        loss, _ = model.loss_fn(params, {k: v.to(dev)
                                         for k, v in batch.items()},
                                TrainCtx(moe_runtime=rt, ce_chunk=16))
        loss.backward()
        out[dev] = (loss.item(), [p.grad.cpu() for p in tree.leaves(params)])
        if dev == "cuda" and cfg.moe:
            assert all(ops.launch_counts()[k] > 0 for k in (
                "grouped_gemm", "grouped_gemm_dx", "grouped_gemm_dw",
                "combine_slots"))
    assert abs(out["cuda"][0] - out["cpu"][0]) < 1e-5
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def _partial_inputs(cuda, rng, b, h, kv, hd, s, dtype):
    q = torch.as_tensor(rng.normal(size=(b, h, hd)), device=cuda).to(dtype)
    k = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    v = torch.as_tensor(rng.normal(size=(b, s, kv, hd)),
                        device=cuda).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-3)])
@pytest.mark.parametrize("b,h,kv,hd,s,lengths", [
    (4, 8, 2, 32, 64, [1, 33, 64, 90]),            # one split
    (4, 16, 2, 64, 320, [0, 65, 400, 128]),        # an empty shard, past S
    (8, 128, 8, 64, 1024, [513, 520, 530, 544, 1, 0, 64, 65]),
    (4, 12, 2, 33, 200, [0, 65, 200, 129])])       # hd off the grid
def test_flash_decode_partial_cuda_vs_plain(cuda, b, h, kv, hd, s, lengths,
                                            dtype, tol, rng):
    """(acc, m, l) against the plain version; an empty shard is exactly
    (0, -1e30, 0); a second run is bitwise the first.  bf16 is held at
    1e-3: both read the same bf16 inputs and sum in fp32."""
    q, k, v = _partial_inputs(cuda, rng, b, h, kv, hd, s, dtype)
    lens = torch.as_tensor(lengths, dtype=torch.int32, device=cuda)
    got = ops.flash_decode_partial(q, k, v, lens, impl="cuda")
    exp = ops.flash_decode_partial(q, k, v, lens, impl="torch")
    for g, e in zip(got, exp):
        torch.testing.assert_close(g, e, rtol=tol, atol=tol)
    dead = lens == 0
    assert (got[0][dead] == 0).all() and (got[2][dead] == 0).all()
    assert (got[1][dead] == -1e30).all()
    again = ops.flash_decode_partial(q, k, v, lens, impl="cuda")
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 3e-2)])
def test_flash_decode_partial_shards_combine_to_flash_decode(cuda, dtype,
                                                             tol, rng):
    """A 1024-slot cache cut into 4 slot shards (one of them empty for a
    row): the partials combined (max, scaled sums) equal flash decode over
    the whole cache."""
    b, h, kv, hd, s = 4, 128, 8, 64, 1024
    q, k, v = _partial_inputs(cuda, rng, b, h, kv, hd, s, dtype)
    lens = torch.as_tensor([700, 256, 1024, 5], dtype=torch.int32,
                           device=cuda)
    w = s // 4
    parts = []
    for i in range(4):
        n = (lens - i * w).clamp(0, w).to(torch.int32)
        parts.append(ops.flash_decode_partial(
            q, k[:, i * w:(i + 1) * w].contiguous(),
            v[:, i * w:(i + 1) * w].contiguous(), n, impl="cuda"))
    m = torch.stack([p[1] for p in parts]).amax(0)
    num = sum(p[0] * torch.exp(p[1] - m)[..., None] for p in parts)
    den = sum(p[2] * torch.exp(p[1] - m) for p in parts)
    out = (num / den[..., None]).to(dtype)
    exp = ops.flash_decode(q, k, v, lens, impl="cuda")
    torch.testing.assert_close(out.float(), exp.float(), rtol=tol, atol=tol)


@pytest.fixture()
def nccl_mesh(cuda):
    """A 1 x 1 NCCL mesh in this process, torn down after the test."""
    import socket

    import torch.distributed as dist

    from repro_torch.launch import mesh as meshlib

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    meshlib.init_distributed(0, 1, f"tcp://127.0.0.1:{port}", timeout_s=120)
    try:
        yield meshlib.make_test_mesh(1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_spmd_decoder_on_a_one_rank_nccl_mesh(nccl_mesh):
    """Reduced deepseek-r1 in float32 on the card: prefill in a2a, 8
    greedy decode steps in replicated mode over a slot-sharded cache
    (grouped GEMM, combine and the partial kernel launched) give the
    one-device path's tokens, logits within 1e-5."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.distributed.sharding_rules import shard_params
    from repro_torch.launch.dryrun import moe_runtime_for
    from repro_torch.models import transformer as tr

    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    model = tr.build_model(cfg, 1, np.zeros((1, 0), np.int32), "cuda")
    full = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    params = shard_params(full, nccl_mesh)
    rts = [moe_runtime_for(cfg, nccl_mesh, InputShape(n, s, 2, n), mode)
           for n, s, mode in (("prefill", 24, "a2a"),
                              ("decode", 64, "replicated"))]
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(1))

    def run(p, pre, dec):
        logits, cache, _ = model.prefill(p, prompt, pre, max_slots=64)
        seq = [logits]
        for _ in range(8):
            logits, cache, _ = model.decode_step(
                p, seq[-1].argmax(-1)[:, None], cache, dec)
            seq.append(logits)
        return torch.stack(seq)
    ops.reset_launches()
    with torch.no_grad():
        spmd = run(params, *(tr.ParallelCtx(
            mesh=nccl_mesh, moe_runtime=rt, moe_mode=mode,
            seq_shard_cache=True, seq_shard_axes=("model",))
            for rt, mode in zip(rts, ("a2a", "replicated"))))
        n = ops.launch_counts()
        local = run(full, *(tr.ParallelCtx(moe_runtime=rt) for rt in rts))
    assert all(n[k] > 0 for k in ("grouped_gemm", "combine_slots",
                                  "flash_decode_partial"))
    torch.testing.assert_close(spmd, local, rtol=1e-5, atol=1e-5)
    assert torch.equal(spmd.argmax(-1), local.argmax(-1))


# ---- the decode variants as CUDA graphs (serving/step_graphs.py) ----------

GRAPH_VARIANTS = {"lockstep": ("lockstep", "dense"),
                  "pipelined": ("pipelined", "dense"),
                  "serialized": ("serialized", "dense"),
                  "masked": ("lockstep", "dense"),
                  "paged": ("lockstep", "paged")}


def _graph_executor(cuda, mode, kv_mode, params=None, prefill=True):
    """A reduced bf16 deepseek-r1 executor on the card: 4 slots of 64,
    prefilled with 4 prompts unless ``prefill`` is false (paged: through
    per-slot block tables of 8 blocks of 8)."""
    from repro_torch.core.elastic import ServerPool
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.executor import Executor

    cfg = _reduced_bf16()
    pool = ServerPool(cfg, 4, tokens_per_client=16)
    model = build_model(cfg, 4, pool.redundant_table, cuda)
    if params is None:
        params = model.init_params(
            torch.Generator(device=cuda).manual_seed(0))
    ex = Executor(model, params, pool, max_batch=4, max_seq=64, device=cuda,
                  decode_mode=mode, kv_mode=kv_mode, kv_block_size=8,
                  kv_num_blocks=33 if kv_mode == "paged" else 0)
    rng = np.random.default_rng(2)
    for b, n in enumerate((5, 9, 3, 12) if prefill else ()):
        prompt = rng.integers(0, cfg.vocab_size, n)
        if kv_mode == "paged":
            ex.prefill_chunk_paged(prompt, 0, _graph_tables()[b])
        else:
            ex.prefill(b, prompt)
    return ex


def _graph_tables():
    return np.arange(1, 33, dtype=np.int32).reshape(4, 8)


def _graph_step(ex, variant, tokens, step):
    if variant == "masked":
        return ex.decode_masked(tokens, np.array([True, False, True, True]))
    if variant == "paged":
        return ex.decode_paged(tokens, _graph_tables(),
                               [n + step for n in (5, 9, 3, 12)])
    return ex.decode(tokens)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(GRAPH_VARIANTS))
def test_graph_decode_equals_eager_bitwise(cuda, variant):
    """Each decode variant captured once and replayed gives logits, expert
    loads, caches and drop / miss totals bitwise those of the same steps
    under ``step_graphs.eager()`` (the pipelined mode's two streams
    included), through a server failure and a router bias's new values;
    its kernel launches count as the eager steps' do."""
    from repro_torch.kernels import build
    from repro_torch.serving import step_graphs

    mode, kv_mode = GRAPH_VARIANTS[variant]
    graphed = _graph_executor(cuda, mode, kv_mode)
    plain = _graph_executor(cuda, mode, kv_mode, params=graphed.params)
    plain.pool = graphed.pool
    graphed.pool.set_route_bias(np.linspace(0.0, 1.0, 8))
    rng = np.random.default_rng(3)
    counts = {}
    for step in range(6):
        tokens = rng.integers(0, 512, (4, 1))
        ops.reset_launches()
        got = [t.clone() for t in _graph_step(graphed, variant, tokens,
                                              step)]
        counts.setdefault("graph", []).append(dict(build.LAUNCHES))
        ops.reset_launches()
        with step_graphs.eager():
            want = _graph_step(plain, variant, tokens, step)
        counts.setdefault("eager", []).append(dict(build.LAUNCHES))
        for g, w in zip(got, want):
            assert torch.equal(g, w), (variant, step)
        for a, b in zip(step_graphs.tensors(graphed.cache),
                        step_graphs.tensors(plain.cache)):
            assert torch.equal(a, b), (variant, step)
        if step == 2:
            graphed.pool.server_failed(1)
        elif step == 3:
            graphed.pool.set_route_bias(np.linspace(1.0, 0.0, 8))
    assert torch.equal(graphed.dropped, plain.dropped)
    assert torch.equal(graphed.miss, plain.miss)
    name = {"masked": "decode_masked", "paged": "decode_paged"}.get(
        variant, "decode")
    g = graphed.graphs
    assert len(g.keys[name]) == 1 and g.captures[name] == 1
    assert g.replays[name] == 5
    assert counts["graph"] == counts["eager"]
    assert counts["graph"][-1][
        "paged_flash_decode" if variant == "paged" else "flash_decode"] > 0


@pytest.mark.cuda
def test_one_capture_through_failure_and_migration(cuda):
    """An engine on the card captures its decode step once through a
    server failure, its recovery and a rebalance's migration (in place),
    and once more after ``scale_to``; its tokens equal the same engine's
    under ``step_graphs.eager()``."""
    from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                     ServingEngine, VirtualClock, zipf_bias)
    from repro_torch.serving import step_graphs

    cfg = _reduced_bf16()
    runs = {}
    for graphs in (True, False):
        eng = ServingEngine(cfg, EngineConfig(max_batch=4, max_seq=64,
                                              pool_tokens_per_client=64),
                            seed=0, clock=VirtualClock(), device=cuda)
        eng.set_skew(zipf_bias(cfg.moe.num_experts, 1.2, scale=2.0))
        rng = np.random.default_rng(4)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, 6)
                        .astype(np.int32), SamplingParams(max_new_tokens=40))
                for i in range(4)]
        for r in reqs:
            eng.submit(r)
        with contextlib.nullcontext() if graphs else step_graphs.eager():
            for i in range(48):
                if i == 10:
                    eng.inject_server_failure(1)
                elif i == 16:
                    eng.recover_server(1)
                elif i == 20:
                    eng.rebalance()
                    assert eng.metrics.migrated_experts > 0
                elif i == 24:
                    captures = dict(eng.executor.graphs.captures)
                    eng.scale_to(2)
                eng.step()
        runs[graphs] = ([r.output_tokens for r in reqs], captures,
                        dict(eng.executor.graphs.captures))
        del eng
    (tokens, before, after), (eager_tokens, none, _) = runs[True], runs[False]
    assert tokens == eager_tokens
    # the four 6-token prompts: one prefill capture (the second of them)
    assert before == {"decode": 1, "prefill": 1}
    assert after == {"decode": 2, "prefill": 1}
    assert none == {}


# ---- the prefill variants as CUDA graphs, one per shape --------------------

def _prefill_calls(variant, rng, V):
    """Each variant's calls: every shape at least three times, over other
    slots, requests and starts (``(method, args, kwargs)``)."""
    rows = _graph_tables()
    if variant == "prefill":
        return [("prefill", (b, rng.integers(0, V, n)), {})
                for b, n in ((0, 12), (1, 12), (2, 7), (3, 12), (1, 7),
                             (0, 7), (2, 12))]
    if variant == "prefill_chunk":
        calls = []
        for slot, n in ((1, 20), (3, 20), (0, 12), (2, 20), (1, 12)):
            p = rng.integers(0, V, n)
            for lo in range(0, n, 8):
                calls.append(("prefill_chunk",
                              (slot, p[lo:lo + 8], lo),
                              dict(is_first=lo == 0, is_last=lo + 8 >= n)))
        # two requests interleaved
        a, b = rng.integers(0, V, 16), rng.integers(0, V, 16)
        for lo in (0, 8):
            for slot, p in ((2, a), (3, b)):
                calls.append(("prefill_chunk", (slot, p[lo:lo + 8], lo),
                              dict(is_first=lo == 0, is_last=lo == 8)))
        return calls
    if variant == "prefill_chunk_paged":
        # a shared first block: later rows start past it (prefix hits)
        calls = []
        for r, start, n in ((0, 0, 24), (1, 8, 20), (2, 8, 20), (3, 0, 12)):
            row = rows[r].copy()
            if start:
                row[0] = rows[0][0]
            p = rng.integers(0, V, n)
            for lo in range(start, n, 8):
                calls.append(("prefill_chunk_paged", (p[lo:lo + 8], lo, row),
                              {}))
        return calls
    return [("copy_blocks", (pairs,), {})
            for pairs in ([(1, 30)], [(9, 31)], [(2, 32), (3, 29)],
                          [(17, 28)], [(10, 27), (11, 26)],
                          [(4, 25), (5, 24)])]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["prefill", "prefill_chunk",
                                     "prefill_chunk_paged", "copy_blocks"])
def test_graph_prefill_equals_eager_bitwise(cuda, variant):
    """Each prefill variant captured once per shape and replayed gives
    outputs, caches and drop / miss totals bitwise those of the same calls
    under ``step_graphs.eager()``, and counts the eager calls' kernel
    launches; the slots, requests, ``start`` values and copy pairs change
    between the calls of a shape without a new capture; every shape seen
    three times or more replays."""
    import collections

    from repro_torch.kernels import build
    from repro_torch.serving import step_graphs

    kv_mode = "paged" if variant in ("prefill_chunk_paged",
                                     "copy_blocks") else "dense"
    # the copies copy prefilled blocks; the other variants start clean
    filled = variant == "copy_blocks"
    graphed = _graph_executor(cuda, "lockstep", kv_mode, prefill=filled)
    plain = _graph_executor(cuda, "lockstep", kv_mode, params=graphed.params,
                            prefill=filled)
    plain.pool = graphed.pool
    rng = np.random.default_rng(5)
    calls = _prefill_calls(variant, rng, 512)
    seen = collections.Counter()
    for i, (method, args, kw) in enumerate(calls):
        shape = (len(args[0]) if method == "copy_blocks" else
                 len(args[1] if method in ("prefill", "prefill_chunk")
                     else args[0]),)
        seen[shape] += 1
        ops.reset_launches()
        out = getattr(graphed, method)(*args, **kw)
        got = [t.clone() for t in step_graphs.tensors(out)]
        launched = dict(build.LAUNCHES)
        ops.reset_launches()
        with step_graphs.eager():
            want = list(step_graphs.tensors(getattr(plain, method)(*args,
                                                                   **kw)))
        assert launched == dict(build.LAUNCHES), (variant, i)
        for g, w in zip(got, want):
            assert torch.equal(g, w), (variant, i)
        for a, b in zip(step_graphs.tensors(graphed.cache),
                        step_graphs.tensors(plain.cache)):
            assert torch.equal(a, b), (variant, i)
    assert torch.equal(graphed.dropped, plain.dropped)
    assert torch.equal(graphed.miss, plain.miss)
    g = graphed.graphs
    assert [s for _, s in g.keys[variant]] == list(seen)
    assert g.captures[variant] == sum(n >= 2 for n in seen.values())
    for shape, n in seen.items():
        assert g.per_shape.get((variant, shape), [0, 0]) == \
            ([1, n - 1] if n >= 2 else [0, 0]), shape
    assert min(seen.values()) >= 3
    assert not plain.graphs.captures and not plain.graphs.replays
    if variant != "copy_blocks":
        assert build.LAUNCHES["grouped_gemm"] > 0


# ---- every family's prefill compiled: per-shape graphs and scan bodies ----

def _scan_inputs(cuda, L, seed):
    """A reduced fp32 rwkv6 time-mix layer's params, state and input, and
    a (B = 1) chunked SSD's inputs, L steps each, on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv

    cfg = get_config("rwkv6-7b").reduced().replace(dtype="float32")
    g = torch.Generator(device=cuda).manual_seed(seed)
    tp = rwkv.init_rwkv_tmix(cfg, torch.float32, cuda, g)
    tp["bonus_u"].normal_(generator=g)
    state = rwkv.init_rwkv_state(cfg, 1, cuda)
    state.wkv.normal_(generator=g).mul_(0.2)
    x = torch.randn(1, L, cfg.d_model, generator=g, device=cuda) * 0.5
    H, P, N = 4, 8, 16
    ssd = (torch.randn(1, L, H, P, generator=g, device=cuda) * 0.3,
           -torch.rand(1, L, H, generator=g, device=cuda) * 0.3,
           torch.randn(1, L, N, generator=g, device=cuda) * 0.5,
           torch.randn(1, L, N, generator=g, device=cuda) * 0.5,
           torch.randn(1, H, P, N, generator=g, device=cuda) * 0.3)
    return cfg, tp, state, x, ssd


@pytest.mark.cuda
def test_scan_bodies_graph_equals_eager_bitwise(cuda):
    """``tmix_forward`` and ``_ssd_chunked`` without grad, their scans
    captured once and replayed, give outputs and states bitwise those of
    the same calls under ``step_graphs.eager()`` (the plain loops) at L =
    1, 63, 64, 65 and 1021 (a prime: the SSD at Q = 1, 15 x 64 + 61
    chunks), each length run three times; two bodies per scan captured
    over all of it."""
    from repro_torch.models import common, mamba, rwkv
    from repro_torch.serving import step_graphs

    common.reset_scans()
    with torch.inference_mode():
        for L in (1, 63, 64, 65, 1021):
            cfg, tp, state, x, ssd = _scan_inputs(cuda, L, L)
            with step_graphs.eager():
                want = (*rwkv.tmix_forward(tp, cfg, x, state),
                        *mamba._ssd_chunked(*ssd, chunk=64))
            for _ in range(3):
                got = (*rwkv.tmix_forward(tp, cfg, x, state),
                       *mamba._ssd_chunked(*ssd, chunk=64))
                for a, b in zip(got, want):
                    assert torch.equal(a, b), L
    stats = common.SCAN_STATS
    assert stats["wkv"]["captures"] == 2
    assert stats["ssd_carry"]["captures"] == 2
    assert stats["wkv"]["replays"] > 0 and stats["ssd_carry"]["replays"] > 0


def _family_executor(cuda, arch, params=None):
    """A reduced bf16 executor of ``arch`` on the card: 4 slots of 128."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import build_model
    from repro_torch.serving.executor import Executor

    kw = {"num_layers": 6} if arch == "gemma3-4b" else {}
    cfg = get_config(arch).reduced().replace(dtype="bfloat16", **kw)
    model = build_model(cfg, 1, None, cuda)
    if params is None:
        params = model.init_params(
            torch.Generator(device=cuda).manual_seed(0))
    return Executor(model, params, None, max_batch=4, max_seq=128,
                    device=cuda)


FAMILY_PROMPTS = ((0, 71), (2, 71), (1, 40), (3, 71), (0, 40), (2, 40),
                  (1, 64))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["gemma3-4b", "whisper-base",
                                  "zamba2-2.7b", "rwkv6-7b"])
def test_family_prefill_graphs_equal_eager_bitwise(cuda, arch):
    """Whole prompts of 71, 40 and 64 tokens into changing slots: each
    call's logits and every cache leaf bitwise those of the same calls
    under ``step_graphs.eager()``.  gemma3 and whisper capture once per
    length seen twice or more (never on a first sight, never per slot)
    and replay after; zamba2 and rwkv6 keep no prefill graph, and capture
    their scan's two bodies once for every layer and prompt."""
    import collections

    from repro_torch.models import common
    from repro_torch.serving import step_graphs

    common.reset_scans()
    graphed = _family_executor(cuda, arch)
    plain = _family_executor(cuda, arch, params=graphed.params)
    rng = np.random.default_rng(6)
    seen = collections.Counter()
    for slot, n in FAMILY_PROMPTS:
        prompt = rng.integers(0, graphed.model.cfg.vocab_size, n)
        seen[n] += 1
        got = graphed.prefill(slot, prompt).clone()
        with step_graphs.eager():
            want = plain.prefill(slot, prompt)
        assert torch.equal(got, want), (arch, slot, n)
        for a, b in zip(step_graphs.tensors(graphed.cache),
                        step_graphs.tensors(plain.cache)):
            assert torch.equal(a, b), (arch, slot, n)
    g = graphed.graphs
    if graphed.model.prefill_per_shape:
        assert [s for _, s in g.keys["prefill"]] == [(n,) for n in seen]
        for n, k in seen.items():
            assert g.per_shape.get(("prefill", (n,)), [0, 0]) == \
                ([1, k - 1] if k >= 2 else [0, 0]), n
        assert not common.SCAN_STATS
    else:
        assert "prefill" not in g.keys and not g.captures
        name = "ssd_carry" if arch == "zamba2-2.7b" else "wkv"
        assert list(common.SCAN_STATS) == [name]
        assert common.SCAN_STATS[name]["captures"] == 2
    assert not plain.graphs.captures and not plain.graphs.replays


# ---- the train step as one CUDA graph (train_loop.compile_train_step)

def _graph_train_run(cuda, cfg, make_opt, compression, batches, graphs,
                     resume_at=None, tmp=None):
    """``len(batches)`` compiled steps of reduced ``cfg`` from seed 0, as
    CUDA graphs or under ``eager()``: each step's (loss, grad_norm) and
    launches, the final state's tensors, captures and replays.  With
    ``resume_at``, the state is saved before that step, two steps run on
    other data and the save is restored into the live state."""
    from repro_torch.core.moe_layer import default_runtime
    from repro_torch.kernels import build
    from repro_torch.models.transformer import TrainCtx, build_model
    from repro_torch.serving import step_graphs
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.train_loop import (compile_train_step,
                                                 init_train_state,
                                                 make_train_step)

    S = 2 if cfg.moe else 1
    with contextlib.nullcontext() if graphs else step_graphs.eager():
        model = build_model(cfg, S, np.zeros((S, 0), np.int32), cuda)
        rt = (default_runtime(cfg, S, batches[0]["tokens"].numel(), cuda)
              if cfg.moe else None)
        opt = make_opt()
        state = init_train_state(
            model, opt, torch.Generator(device=cuda).manual_seed(0),
            compression=compression)
        step = compile_train_step(make_train_step(
            model, opt, TrainCtx(moe_runtime=rt, remat=False, ce_chunk=16),
            compression=compression), cuda)
        metrics, launches = [], []
        for i, b in enumerate(batches):
            if i == resume_at:
                ckpt.save_checkpoint(tmp, i, state)
                for other in batches[:2]:
                    state, _ = step(state, {"tokens": other["labels"],
                                            "labels": other["tokens"]})
                state, _ = ckpt.restore_checkpoint(tmp, state, into=True)
            before = dict(build.LAUNCHES)
            state, m = step(state, b)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
            launches.append({k: build.LAUNCHES[k] - before[k]
                             for k in before})
        return (metrics, launches,
                [t.clone() for t in step_graphs.tensors(state)],
                step.captures, step.replays)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_graph_train_step_equals_eager_bitwise(cuda, opt):
    """Reduced deepseek-r1 in bf16, 5 steps of the compiled train step as
    one CUDA graph against ``eager()`` from the same seed: AdamW under a
    cosine warm-up (a new learning rate and bias correction every step)
    with int8 compression, and Adafactor.  A learning rate or decay
    frozen at the capture step, or a state read from stale addresses,
    would show from step 3 on.  One capture, three replays; the
    training-path kernels launched every step, as often as eagerly."""
    from repro_torch.configs import get_config
    from repro_torch.training import optimizer as topt
    from repro_torch.training.data import synthetic_lm_batches

    cfg = get_config("deepseek-r1").reduced()
    data = synthetic_lm_batches(cfg, 4, 32, seed=0, device=cuda)
    batches = [next(data) for _ in range(5)]
    make = ((lambda: topt.adamw(lr=topt.cosine_schedule(3e-3, 3, 8)))
            if opt == "adamw" else (lambda: topt.adafactor(lr=1e-2)))
    comp = opt == "adamw"
    g = _graph_train_run(cuda, cfg, make, comp, batches, True)
    e = _graph_train_run(cuda, cfg, make, comp, batches, False)
    assert g[0] == e[0] and g[1] == e[1]
    assert all(torch.equal(a, b) for a, b in zip(g[2], e[2]))
    assert (g[3], g[4], e[3], e[4]) == (1, 3, 0, 0)
    assert all(n[k] > 0 for n in g[1] for k in (
        "grouped_gemm", "grouped_gemm_dx", "grouped_gemm_dw",
        "combine_slots"))


@pytest.mark.cuda
def test_graph_train_step_keeps_its_graph_through_a_restore(cuda, tmp_path):
    """Reduced granite in bf16: a checkpoint restored into the live state
    mid-run (after two steps on other data) keeps the one graph, and the
    run is bitwise the eager run that did the same."""
    from repro_torch.configs import get_config
    from repro_torch.training import optimizer as topt
    from repro_torch.training.data import synthetic_lm_batches

    cfg = get_config("granite-3-2b").reduced()
    data = synthetic_lm_batches(cfg, 4, 32, seed=0, device=cuda)
    batches = [next(data) for _ in range(6)]

    def make():
        return topt.adamw(lr=topt.cosine_schedule(3e-3, 3, 8))
    g = _graph_train_run(cuda, cfg, make, False, batches, True, 3,
                         str(tmp_path / "g"))
    e = _graph_train_run(cuda, cfg, make, False, batches, False, 3,
                         str(tmp_path / "e"))
    assert g[0] == e[0]
    assert all(torch.equal(a, b) for a, b in zip(g[2], e[2]))
    assert (g[3], g[4]) == (1, 6)
