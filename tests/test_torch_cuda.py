"""Port CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Without a CUDA card every test skips (the CUDA kernels have no CPU mode).
"""

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
    from repro_torch.models.transformer import build_model

    cfg = _reduced_bf16()
    model = build_model(cfg, 4, np.zeros((4, 0), np.int32), cuda)
    params = model.init_params(torch.Generator(device=cuda).manual_seed(0))
    rt = moe_layer.default_runtime(cfg, 4, 4 * batch, cuda)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (batch, 6), generator=gen)
    _, cache, _ = model.prefill(params, prompt.to(cuda), rt, max_slots=32)
    return cfg, model, params, rt, cache, gen


def _clone_cache(cache):
    return {n: type(c)(c.k.clone(), c.v.clone(), c.length.clone())
            for n, c in cache.items()}


@pytest.mark.cuda
def test_pipelined_two_streams_equal_serialized_bitwise(cuda):
    """Pipelined decode (microbatch B on a second stream, joined by an
    event) gives logits and caches bitwise those of the serialized split
    (one stream), step after step on a reduced decoder in bf16."""
    from repro_torch.core.overlap import split_batch_decode

    cfg, model, params, rt, cache, gen = _card_decoder(cuda)
    caches = {True: cache, False: _clone_cache(cache)}
    side = torch.cuda.Stream(cuda)
    for _ in range(4):
        tok = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen).to(
            cuda)
        logits = {}
        for enabled, c in caches.items():
            logits[enabled], _, _ = split_batch_decode(
                lambda t, c: model.decode_step(params, t, c, rt), tok, c,
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
