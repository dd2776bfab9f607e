"""The MoE path on ``meta`` tensors, and the kernels' ``meta`` route.

* ``dispatch.pack`` writes at a fixed shape (a scratch row for dropped
  entries) and every ``bincount`` of the path is an int64
  ``scatter_add_``: the buffers and ``serve``'s output are bitwise those
  of the boolean-mask / bincount version they replaced (kept here), with
  drops, for both packing methods.
* ``ops.grouped_gemm`` / ``combine_slots`` / ``flash_decode(_partial)``
  (and the backward pair through ``kernels/autograd.py``) on ``meta``
  tensors return empty outputs of the kernel's shapes, counted by
  ``FlopCounterMode`` at the kernel's own work (``kernels/meta.py``); the
  MoE layer runs forward and backward there.
* rwkv6's wkv recurrence is one op there, counted as the per-token loop,
  over a whole sequence and, under autograd, a chunk at a time under the
  chunk's checkpoint, as the chunked loop.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_config
from repro_torch.core import dispatch, expert_server, router
from repro_torch.core.moe_layer import default_runtime
from repro_torch.core.types import DispatchBuffers
from repro_torch.kernels import ops
from repro_torch.models import transformer as tr


def _pack_masked(x, expert_ids, scores, server_ids, num_servers, capacity,
                 method="onehot"):
    """``pack`` as it was: boolean-mask indexing and ``bincount``."""
    T, d = x.shape
    k = expert_ids.shape[1]
    S, C = num_servers, capacity
    flat_server = server_ids.reshape(-1)
    flat_token = torch.arange(T).repeat_interleave(k)
    if method == "sort":
        order = torch.argsort(flat_server, stable=True)
        counts = torch.bincount(flat_server, minlength=S)
        starts = torch.cumsum(counts, 0) - counts
        slot_sorted = torch.arange(T * k) - starts[flat_server[order]]
        slot = torch.empty_like(slot_sorted)
        slot[order] = slot_sorted
    else:
        onehot = F.one_hot(flat_server, S)
        ranks = torch.cumsum(onehot, dim=0) - onehot
        slot = torch.gather(ranks, 1, flat_server[:, None])[:, 0]
        counts = onehot.sum(dim=0)
    valid = slot < C
    flat_idx = flat_server * C + slot
    dest = flat_idx[valid]
    hidden = torch.zeros((S * C, d), dtype=x.dtype)
    hidden[dest] = x[flat_token[valid]]
    eid = torch.full((S * C,), -1, dtype=torch.int64)
    eid[dest] = expert_ids.reshape(-1)[valid]
    sc = torch.zeros((S * C,), dtype=torch.float32)
    sc[dest] = scores.reshape(-1)[valid].float()
    return DispatchBuffers(
        hidden=hidden.reshape(S, C, d), expert_id=eid.reshape(S, C),
        score=sc.reshape(S, C), counts=counts.clamp(max=C),
        combine_slot=torch.where(valid, flat_idx, -1).reshape(T, k),
        dropped=(counts - C).clamp(min=0).sum())


@pytest.mark.parametrize("method", ["onehot", "sort"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("capacity", [3, 8, 40])
def test_pack_bitwise_the_masked_version(method, dtype, capacity):
    g = torch.Generator().manual_seed(capacity)
    T, k, S, E, d = 37, 2, 4, 8, 24
    x = torch.randn(T, d, generator=g).to(dtype)
    eids = torch.randint(0, E, (T, k), generator=g)
    servers = torch.randint(0, S, (T, k), generator=g)
    scores = torch.rand(T, k, generator=g)
    got = dispatch.pack(x, eids, scores, servers, S, capacity, method)
    want = _pack_masked(x, eids, scores, servers, S, capacity, method)
    for f in DispatchBuffers._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if capacity == 3:
        assert int(got.dropped) > 0


def test_count_ids_is_bincount():
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, 9, (5, 7), generator=g)
    assert torch.equal(router.count_ids(ids, 12),
                       torch.bincount(ids.reshape(-1), minlength=12))
    assert router.count_ids(ids, 12).dtype == torch.int64
    # ids past n - 1 are not counted, as bincount(...)[:n] drops them
    assert torch.equal(router.count_ids(ids, 5),
                       torch.bincount(ids.reshape(-1), minlength=5)[:5])


def test_serve_bitwise_the_bincount_version(monkeypatch):
    """``serve`` with its group sizes from ``count_ids`` equals ``serve``
    with them from ``torch.bincount(...)[:L]``, bit for bit (unhosted and
    dropped slots included, and a local table naming a slot past the
    server's L weights, which that slice never counted)."""
    g = torch.Generator().manual_seed(1)
    Sc, C, d, f, L = 3, 8, 16, 24, 3
    tokens = torch.randn(Sc, C, d, generator=g)
    eids = torch.randint(-1, 6, (Sc, C), generator=g)
    eids[0, :4] = torch.tensor([1, 4, -1, 2])        # unhosted, invalid
    scores = torch.rand(Sc, C, generator=g)
    counts = torch.tensor([8, 5, 0])
    w = expert_server.ServerWeights(
        torch.randn(L, d, f, generator=g), torch.randn(L, d, f, generator=g),
        torch.randn(L, f, d, generator=g),
        torch.tensor([0, -1, 1, 2, -1, 4]))    # slot 4 >= L: not counted
    got, st = expert_server.serve(tokens, eids, scores, counts, w)
    monkeypatch.setattr(expert_server, "count_ids", lambda ids, n:
                        torch.bincount(ids.reshape(-1), minlength=n)[:n])
    want, st2 = expert_server.serve(tokens, eids, scores, counts, w)
    assert torch.equal(got, want)
    assert int(st.miss) == int(st2.miss) and int(st.miss) > 0


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_grouped_gemm_meta_route_counts_its_work():
    M, K, N, G = 96, 32, 48, 5
    x, w = _meta(M, K, dtype=torch.bfloat16), _meta(G, K, N,
                                                     dtype=torch.bfloat16)
    sizes = _meta(G, dtype=torch.int64)
    with FlopCounterMode(display=False) as fc:
        y = ops.grouped_gemm(x, w, sizes)
    assert y.shape == (M, N) and y.is_meta and y.dtype == torch.bfloat16
    assert fc.get_total_flops() == 2 * M * K * N
    # the backward pair: dx and dw, each 2·M·K·N
    x.requires_grad_(True)
    w.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        ops.grouped_gemm(x, w, sizes).sum().backward()
    assert fc.get_total_flops() == 3 * 2 * M * K * N
    assert x.grad.shape == x.shape and w.grad.shape == w.shape
    with pytest.raises(ValueError, match="meta"):
        ops.grouped_gemm(torch.zeros(2, 3), torch.zeros(1, 3, 2),
                         torch.ones(1, dtype=torch.int64), impl="meta")


def test_combine_and_decode_meta_routes():
    S, C, d, T, k = 4, 8, 16, 10, 2
    with FlopCounterMode(display=False) as fc:
        y = ops.combine_slots(_meta(S, C, d), _meta(T, k,
                                                    dtype=torch.int64))
    assert y.shape == (T, d) and fc.get_total_flops() == T * k * d
    with FlopCounterMode(display=False) as fc:
        y = ops.combine_slots([_meta(C, d)] * S, _meta(T, k,
                                                       dtype=torch.int64),
                              addend=_meta(T, d))
    assert y.shape == (T, d) and fc.get_total_flops() == T * k * d + T * d
    B, H, KV, Sl, hd = 2, 8, 2, 64, 32
    q, kc = _meta(B, H, hd), _meta(B, Sl, KV, hd)
    lengths = _meta(B, dtype=torch.int32)
    with FlopCounterMode(display=False) as fc:
        acc, m, l = ops.flash_decode_partial(q, kc, kc, lengths)
        out = ops.flash_decode(q, kc, kc, lengths)
    assert acc.shape == (B, H, hd) and m.shape == l.shape == (B, H)
    assert acc.dtype == torch.float32 and out.shape == q.shape
    assert fc.get_total_flops() == 2 * 4 * B * H * Sl * hd
    with pytest.raises(NotImplementedError, match="meta"):
        ops.paged_flash_decode(q, kc, kc, _meta(B, 4, dtype=torch.int32),
                               lengths)


def test_meta_ops_refuse_real_tensors():
    from repro_torch.kernels import meta
    with pytest.raises(RuntimeError, match="meta tensors only"):
        meta.grouped_gemm(torch.zeros(4, 3), torch.zeros(2, 3, 5),
                          torch.tensor([2, 2]))


def test_moe_model_runs_on_meta():
    """Reduced deepseek-r1's prefill and its loss with the backward on
    ``meta``: no data-dependent shape, no host sync, every kernel op on
    its meta route (none launched)."""
    cfg = get_config("deepseek-r1").reduced()
    model = tr.build_model(cfg, 2, np.zeros((2, 0), np.int32), "meta")
    params = model.init_params(torch.Generator().manual_seed(0))
    rt = default_runtime(cfg, 2, 64, "cpu")
    rt = rt._replace(**{f: getattr(rt, f).to("meta")
                        for f in ("mapping", "alive", "local_table")})
    tokens = torch.zeros(2, 32, dtype=torch.int64, device="meta")
    ops.reset_launches()
    logits, cache, st = model.prefill(params, tokens,
                                      tr.ParallelCtx(moe_runtime=rt))
    assert logits.shape == (2, cfg.padded_vocab) and logits.is_meta
    for p in (params["blocks"]["moe"]["servers"]["w_gate"],
              params["blocks"]["attn"]["wq"]):
        p.requires_grad_(True)
    loss, _ = model.loss_fn(params, {"tokens": tokens, "labels": tokens},
                            tr.ParallelCtx(moe_runtime=rt))
    loss.backward()
    assert params["blocks"]["moe"]["servers"]["w_gate"].grad.is_meta
    assert not any(ops.launch_counts().values())


# ------------------------------------------ rwkv6's recurrence on meta

def _wkv_loop(r, k, v, w, u, S):
    """``models/rwkv.py::tmix_forward``'s per-token loop, as the card and
    the CPU run it."""
    from repro_torch.models import rwkv as rwk
    ys = []
    for t in range(r.shape[1]):
        S, y = rwk._wkv_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def _wkv_count(fn, grad, B, L, H, D):
    from repro_torch.launch.dryrun import MetaMemory
    m = lambda *s: torch.empty(s, device="meta",        # noqa: E731
                               requires_grad=grad)
    args = [m(B, L, H, D) for _ in range(4)] + [m(H, D), m(B, H, D, D)]
    fl, mem = FlopCounterMode(display=False), MetaMemory(args)
    with fl, mem:
        y, S = fn(*args)
        assert y.shape == (B, L, H, D) and S.shape == (B, H, D, D)
        if grad:
            y.sum().backward()
    return fl.get_total_flops(), mem.peak


@pytest.mark.parametrize("shape", [(2, 5, 3, 4), (2, 1, 3, 4),
                                   (3, 7, 2, 16), (16, 64, 4, 64)])
def test_wkv_meta_route_counts_as_the_loop(shape):
    """The accounting's one-op route of the wkv recurrence
    (``kernels/meta.py::wkv``) against the per-token loop on meta: FLOPs
    equal, forward and backward; the peak equal without grad (prefill,
    decode) and, under grad, within 1 % at (16, 64, 4, 64) (the loop's
    backward keeps per-token temporaries the op does not model: within
    25 % at the toy shapes)."""
    from repro_torch.kernels import meta
    for grad in (False, True):
        f_loop, p_loop = _wkv_count(_wkv_loop, grad, *shape)
        f_op, p_op = _wkv_count(meta.wkv, grad, *shape)
        assert f_op == f_loop
        if not grad:
            assert p_op == p_loop
        else:
            tol = 0.01 if shape[1] >= 64 else 0.25
            assert abs(p_op - p_loop) <= tol * p_loop, (p_op, p_loop)


@pytest.mark.parametrize("shape,chunk", [((2, 8, 3, 4), 4), ((3, 7, 2, 16), 3),
                                         ((16, 128, 4, 64), 64)])
def test_wkv_meta_route_counts_as_the_chunked_loop(shape, chunk):
    """Under autograd ``rwkv._recurrence`` runs the recurrence a chunk at
    a time, each chunk checkpointed: its ``meta`` route (``meta.wkv`` a
    chunk) against the chunked per-token loop on meta, both recomputed in
    the backward.  FLOPs equal; the peak equal without grad and within
    the tolerances above under grad (1 % at chunks of 64 tokens, 25 % at
    the toy chunks: 2 chunks of 4, 7 chunks of 1)."""
    from repro_torch.kernels import meta
    from repro_torch.models import rwkv as rwk
    run = lambda loop: lambda *a: rwk._recurrence(    # noqa: E731
        loop, *a, chunk=chunk)
    Q = rwk.chunk_size(shape[1], chunk)
    for grad in (False, True):
        f_loop, p_loop = _wkv_count(run(_wkv_loop), grad, *shape)
        f_op, p_op = _wkv_count(run(meta.wkv), grad, *shape)
        assert f_op == f_loop
        if not grad:
            assert p_op == p_loop
        else:
            tol = 0.01 if Q >= 64 else 0.25
            assert abs(p_op - p_loop) <= tol * p_loop, (p_op, p_loop)
    # the backward recomputes each chunk's forward: 2 + 4 + 2 passes' work
    B, L, H, D = shape
    assert f_op == meta.wkv_flops(B, L, H, D, False) * 2 + \
        meta.wkv_flops(B, L, H, D, True)


def test_peak_holders_names_the_storages_live_at_the_peak():
    """``tools/peak_holders.py``'s memory: the peak is ``MetaMemory``'s,
    and the storages live there are grouped by the op that made them (a
    freed storage's address, reused, is not taken for the old one)."""
    from repro_torch.tools.peak_holders import HolderMemory
    mem = HolderMemory()
    mem.step = 1
    with mem:
        a = torch.empty(256, 1024, device="meta")         # 1 MiB
        b = a.exp()
        del a
        c = b.repeat(4, 1)                                 # 4 MiB
        del c
        b.sum()
    assert mem.peak == 5 * 2**20
    assert dict(mem.groups()) == {
        ("aten.exp.default", (256, 1024), "float32"): 2**20,
        ("aten.repeat.default", (1024, 1024), "float32"): 4 * 2**20}
