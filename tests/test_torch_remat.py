"""The checkpoints inside a layer (``models/common.py::remat_if_recording``,
the reference's ``jax.checkpoint`` inside attention's q-block scan, the
SSD scan and the wkv recurrence) against the graphs without them.

A non-reentrant checkpoint keeps the autograd graph and recomputes what it
would have saved, so the outputs and every gradient are bitwise those of
the un-checkpointed graph: here the attention's q-block core as the port
had it (kept below as the oracle) over 16 q-blocks with and without the
sliding window, and reduced deepseek-r1's loss at 2,048 tokens under the
per-block remat, where the attention's checkpoints nest inside each
block's and the MoE's stacked expert leaves take their gradients through
``kernels/autograd.py::stacked_view``.  The bytes saved for the backward,
counted through ``torch.autograd.graph.saved_tensors_hooks``, hold no
(b, H, bq, s) probabilities between q-blocks.  No checkpoint is taken
where autograd does not record (serving, ``no_grad``)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.moe_layer import default_runtime
from repro_torch.models import attention, common, mamba, rwkv
from repro_torch.models.transformer import TrainCtx, build_model
from repro_torch.training import tree

S_LONG = attention.CHUNKED_ATTN_THRESHOLD      # 2048: the q-block path


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunked_core_unchecked(cfg, q, k, v, positions, *, is_local=False,
                            causal=True, q_blocks):
    """``attention._chunked_core`` before its checkpoints: every q-block's
    scores and probabilities stay saved for the backward."""
    b, s = q.shape[:2]
    bq = s // q_blocks
    outs = [attention._dense_core(cfg, q[:, i * bq:(i + 1) * bq], k, v,
                                  positions[:, i * bq:(i + 1) * bq],
                                  positions, is_local=is_local,
                                  causal=causal)
            for i in range(q_blocks)]
    return torch.cat(outs, dim=1)


class SavedBytes(torch.autograd.graph.saved_tensors_hooks):
    """The tensors autograd saves for the backward while it is entered:
    their distinct storages' bytes and the largest tensor's elements (a
    checkpoint's inputs pass through it; what a checkpoint recomputes
    does not)."""

    def __init__(self):
        self.storages, self.largest = {}, 0

        def pack(t):
            st = t.untyped_storage()
            self.storages[st.data_ptr()] = st.nbytes()
            self.largest = max(self.largest, t.numel())
            return t

        super().__init__(pack, lambda t: t)

    @property
    def nbytes(self) -> int:
        return sum(self.storages.values())


def _qkv(cfg, b, s, seed):
    g = torch.Generator().manual_seed(seed)
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = torch.randn(b, s, h, hd, generator=g)
    k, v = (torch.randn(b, s, kvh, hd, generator=g) for _ in range(2))
    pos = torch.arange(s)[None].expand(b, s)
    return [t.requires_grad_(True) for t in (q, k, v)], pos


# (arch, is_local, causal): granite causal and bidirectional, gemma3's
# sliding window (64 positions in its reduced config) and its globals
ATTN_CASES = {"causal": ("granite-3-2b", False, True),
              "bidirectional": ("granite-3-2b", False, False),
              "sliding window": ("gemma3-4b", True, True),
              "global": ("gemma3-4b", False, True)}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_q_block_checkpoint_bitwise_and_keeps_no_probabilities(case):
    """``_chunked_core`` over 16 q-blocks of 128 against the unchecked
    copy: output and the gradients of q / k / v bitwise equal.  The
    checkpointed core saves its inputs only (q, k, v, positions), no
    tensor of (b, H, bq, s) elements; the copy saves at least 16 blocks'
    fp32 probabilities."""
    arch, is_local, causal = ATTN_CASES[case]
    cfg = get_config(arch).reduced().replace(dtype="float32")
    b, s, nq = 1, S_LONG, 16
    outs, grads, saved = [], [], []
    for core in (attention._chunked_core, _chunked_core_unchecked):
        (q, k, v), pos = _qkv(cfg, b, s, seed=1)
        sb = SavedBytes()
        with sb:
            out = core(cfg, q, k, v, pos, is_local=is_local, causal=causal,
                       q_blocks=nq)
        (out * torch.linspace(-1, 1, out.shape[-1])).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in (q, k, v)])
        saved.append(sb)
    assert torch.equal(outs[0], outs[1])
    for a, e in zip(*grads):
        assert torch.equal(a, e)
    probs = b * cfg.num_heads * (s // nq) * s
    inputs = sum(t.numel() * t.element_size() for t in (q, k, v, pos))
    assert saved[0].largest < probs and saved[0].nbytes <= inputs
    assert saved[1].largest >= probs
    assert saved[1].nbytes >= nq * probs * 4


def test_full_attention_gradients_bitwise_through_the_checkpoints(
        monkeypatch):
    """``full_attention`` at 2,048 tokens (the q-block path) with its
    projections and RoPE: the output and every weight's and the input's
    gradient bitwise the unchecked graph's."""
    cfg = get_config("gemma3-4b").reduced().replace(dtype="float32")
    res = []
    for core in (attention._chunked_core, _chunked_core_unchecked):
        monkeypatch.setattr(attention, "_chunked_core", core)
        g = torch.Generator().manual_seed(2)
        p = attention.init_attention(cfg, torch.float32, "cpu", g)
        for t in p.values():
            t.requires_grad_(True)
        x = torch.randn(2, S_LONG, cfg.d_model, generator=g,
                        requires_grad=True)
        out = attention.full_attention(p, cfg, x, torch.arange(S_LONG),
                                       is_local=True)
        out.square().mean().backward()
        res.append([out.detach(), x.grad, *(p[w].grad for w in sorted(p))])
    for a, e in zip(*res):
        assert torch.equal(a, e)


def test_moe_block_remat_nests_the_q_block_checkpoints(monkeypatch):
    """Reduced deepseek-r1's ``loss_fn`` over 1 x 2,048 tokens with the
    per-block remat: the attention's q-block checkpoints nest inside each
    block's, the MoE beside them.  Loss, metrics and every gradient leaf
    (the stacked expert banks through ``stacked_view`` among them)
    bitwise those of the same step without the q-block checkpoints.  The
    core runs 16 times a layer in the forward and 16 in the block's
    recomputation, and with the checkpoints 16 more in the backward."""
    cfg = get_config("deepseek-r1").reduced().replace(dtype="float32")
    B, L, S = 1, S_LONG, 2
    model = build_model(cfg, S, np.zeros((S, 0), np.int32), "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L + 1)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    dense_core = attention._dense_core
    runs = []
    for core in (attention._chunked_core, _chunked_core_unchecked):
        calls = []

        def counted(*a, **kw):
            calls.append(None)
            return dense_core(*a, **kw)

        monkeypatch.setattr(attention, "_chunked_core", core)
        monkeypatch.setattr(attention, "_dense_core", counted)
        params = model.init_params(torch.Generator().manual_seed(0))
        for p in tree.leaves(params):
            p.requires_grad_(True)
        rt = default_runtime(cfg, S, B * L, "cpu")
        loss, met = model.loss_fn(params, batch,
                                  TrainCtx(moe_runtime=rt, remat=True,
                                           ce_chunk=512))
        loss.backward()
        runs.append((len(calls), loss.detach(), met, tree.items(params)))
    monkeypatch.undo()
    (n0, l0, m0, p0), (n1, l1, m1, p1) = runs
    assert (n0, n1) == (3 * 16 * cfg.num_layers, 2 * 16 * cfg.num_layers)
    assert torch.equal(l0, l1)
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    stacked = 0
    for (path, a), (_, e) in zip(p0, p1):
        assert a.grad is not None and torch.equal(a.grad, e.grad), path
        stacked += "servers" in path
    assert stacked > 0


def _refuse(*a, **kw):
    raise AssertionError("a checkpoint was taken")


def test_no_checkpoint_where_autograd_does_not_record(monkeypatch):
    """Serving and ``no_grad``: the attention's q-block path, the SSD scan
    and the wkv recurrence take no checkpoint, under ``no_grad`` or with
    no input requiring grad; with grad they take one a q-block, one a
    scan and one a chunk."""
    taken = []
    real = common.checkpoint
    monkeypatch.setattr(common, "checkpoint",
                        lambda fn, *a, **kw: taken.append(fn) or real(
                            fn, *a, **kw))
    acfg = get_config("granite-3-2b").reduced().replace(dtype="float32")
    mcfg = get_config("zamba2-2.7b").reduced().replace(dtype="float32")
    rcfg = get_config("rwkv6-7b").reduced().replace(dtype="float32")
    g = torch.Generator().manual_seed(4)
    ap = attention.init_attention(acfg, torch.float32, "cpu", g)
    mp = mamba.init_mamba(mcfg, torch.float32, "cpu", g)
    rp = rwkv.init_rwkv_tmix(rcfg, torch.float32, "cpu", g)
    xa = torch.randn(1, S_LONG, acfg.d_model, generator=g)
    xm = torch.randn(2, 128, mcfg.d_model, generator=g)
    xr = torch.randn(2, 128, rcfg.d_model, generator=g)
    st = rwkv.init_rwkv_state(rcfg, 2, "cpu")

    def run():
        attention.full_attention(ap, acfg, xa, torch.arange(S_LONG))
        mamba.mamba_forward(mp, mcfg, xm)
        rwkv.tmix_forward(rp, rcfg, xr, st)

    run()                                   # nothing requires grad
    for p in (*ap.values(), *mp.values(), *rp.values()):
        p.requires_grad_(True)
    with torch.no_grad():
        run()
    assert taken == []
    run()
    assert taken == ([attention._dense_core] * 16 + [mamba._ssd_chunked]
                     + [rwkv._wkv_loop] * 2)
