"""The port's RWKV-6 block (``repro_torch.models.rwkv``) against the JAX
package's: the decay, one time-mix token, the sequence time-mix (at a prime
length, where the reference's chunk falls to 1), the channel-mix, a layer's
forward and decode, and decode after prefill equal to the longer prefill.
fp32 at 1e-5 (rtol and atol, as ``tests/test_kernels.py``), same numpy
inputs in both packages.  Under autograd the time-mix checkpoints its
recurrence chunk by chunk: against the per-token graph it replaced (kept
here as the oracle), outputs and gradients bitwise, and the bytes saved
for the backward hold a chunk's incoming state, not three a token."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import rwkv as jrwkv
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import rwkv

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(dtype="float32"):
    return (jget_config("rwkv6-7b").reduced().replace(dtype=dtype),
            get_config("rwkv6-7b").reduced().replace(dtype=dtype))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _t(a):
    return tensor_from_numpy(np.asarray(a), "cpu")


def _params(cfg, seed=0):
    """Reference params with a bonus and a decay offset that are not the
    init's constants (zeros and -6 would hide their terms)."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    tp = jrwkv.init_rwkv_tmix(k1, cfg)
    cp = jrwkv.init_rwkv_cmix(k2, cfg)
    rng = np.random.default_rng(seed)
    tp = dict(tp, bonus_u=jnp.asarray(rng.normal(size=tp["bonus_u"].shape)
                                      * 0.5, jnp.float32),
              decay_w0=jnp.asarray(rng.uniform(-3, 0, tp["decay_w0"].shape),
                                   jnp.float32))
    return tp, cp, jax.tree.map(_t, tp), jax.tree.map(_t, cp)


def _state(cfg, rng, B, dtype=np.float32):
    H, D = rwkv.dims(get_config("rwkv6-7b").reduced())
    wkv = (rng.normal(size=(B, H, D, D)) * 0.2).astype(np.float32)
    sh = [(rng.normal(size=(B, cfg.d_model)) * 0.5).astype(dtype)
          for _ in range(2)]
    return (jrwkv.RwkvState(jnp.asarray(wkv), *map(jnp.asarray, sh)),
            rwkv.RwkvState(torch.as_tensor(wkv),
                           *(torch.as_tensor(s) for s in sh)))


def _x(cfg, rng, *shape):
    return (rng.normal(size=(*shape, cfg.d_model)) * 0.5).astype(np.float32)


def test_init_and_dims_match_reference():
    cfg, tcfg = _cfgs()
    assert rwkv.dims(tcfg) == jrwkv.dims(cfg)
    assert rwkv.dims(get_config("rwkv6-7b")) == (64, 64)
    jt, jc = (jrwkv.init_rwkv_tmix(jax.random.PRNGKey(0), cfg),
              jrwkv.init_rwkv_cmix(jax.random.PRNGKey(1), cfg))
    g = torch.Generator().manual_seed(0)
    tt = rwkv.init_rwkv_tmix(tcfg, torch.float32, "cpu", g, (3,))
    tc = rwkv.init_rwkv_cmix(tcfg, torch.float32, "cpu", g, (3,))
    for j, t in ((jt, tt), (jc, tc)):
        assert sorted(j) == sorted(t)
        for k in j:
            assert tuple(t[k].shape) == (3,) + j[k].shape, k
            assert t[k].dtype == torch.float32
    assert torch.equal(tt["decay_w0"], torch.full_like(tt["decay_w0"], -6.0))


def test_decay_matches_reference():
    cfg, _ = _cfgs()
    jt, _, tt, _ = _params(cfg)
    x = _x(cfg, np.random.default_rng(1), 3, 5)
    _close(rwkv._decay(tt, torch.as_tensor(x)),
           jrwkv._decay(jt, jnp.asarray(x)))


def test_tmix_step_matches_reference():
    cfg, tcfg = _cfgs()
    jt, _, tt, _ = _params(cfg)
    rng = np.random.default_rng(2)
    jst, tst = _state(cfg, rng, 3)
    x = _x(cfg, rng, 3)
    jS, jy = jrwkv._tmix_step(jt, cfg, jst.wkv, jst.shift_tmix,
                              jnp.asarray(x))
    tS, ty = rwkv._tmix_step(tt, tcfg, tst.wkv, tst.shift_tmix,
                             torch.as_tensor(x))
    _close(tS, jS)
    _close(ty, jy)


@pytest.mark.parametrize("L", [67, 16])
def test_tmix_forward_matches_reference(L):
    """At a prime L the reference's chunk falls to 1 (it groups the
    rematerialized steps); the values do not depend on it."""
    cfg, tcfg = _cfgs()
    jt, _, tt, _ = _params(cfg)
    rng = np.random.default_rng(L)
    jst, tst = _state(cfg, rng, 2)
    x = _x(cfg, rng, 2, L)
    jy, jS, jlast = jrwkv.tmix_forward(jt, cfg, jnp.asarray(x), jst)
    ty, tS, tlast = rwkv.tmix_forward(tt, tcfg, torch.as_tensor(x), tst)
    _close(ty, jy)
    _close(tS, jS)
    _close(tlast, jlast)


def test_cmix_forward_matches_reference():
    cfg, _ = _cfgs()
    _, jc, _, tc = _params(cfg)
    rng = np.random.default_rng(3)
    x, prev = _x(cfg, rng, 2, 7), _x(cfg, rng, 2)
    jy, jlast = jrwkv.cmix_forward(jc, jnp.asarray(x), jnp.asarray(prev))
    ty, tlast = rwkv.cmix_forward(tc, torch.as_tensor(x),
                                  torch.as_tensor(prev))
    _close(ty, jy)
    _close(tlast, jlast)


def _norms(cfg, rng):
    n = [(1 + 0.1 * rng.normal(size=cfg.d_model)).astype(np.float32)
         for _ in range(2)]
    return tuple(map(jnp.asarray, n)), tuple(map(torch.as_tensor, n))


def test_block_forward_and_decode_match_reference():
    cfg, tcfg = _cfgs()
    jt, jc, tt, tc = _params(cfg, seed=5)
    rng = np.random.default_rng(5)
    jn, tn = _norms(cfg, rng)
    jst, tst = _state(cfg, rng, 2)
    x = _x(cfg, rng, 2, 11)
    jx, jnew = jrwkv.rwkv_block_forward(jt, jc, cfg, jnp.asarray(x), jst, jn)
    tx, tnew = rwkv.rwkv_block_forward(tt, tc, tcfg, torch.as_tensor(x), tst,
                                       tn)
    _close(tx, jx)
    for a, b in zip(tnew, jnew):
        _close(a, b)
    x1 = _x(cfg, rng, 2, 1)
    jx, jd = jrwkv.rwkv_block_decode(jt, jc, cfg, jnp.asarray(x1), jnew, jn)
    tx, td = rwkv.rwkv_block_decode(tt, tc, tcfg, torch.as_tensor(x1), tnew,
                                    tn)
    _close(tx, jx)
    for a, b in zip(td, jd):
        _close(a, b)


def test_decode_after_prefill_equals_the_longer_prefill():
    """Prefill of L - 1 tokens, then one decode step, equals the prefill of
    L tokens: the last output and every state leaf."""
    cfg, tcfg = _cfgs()
    _, _, tt, tc = _params(cfg, seed=6)
    rng = np.random.default_rng(6)
    _, tn = _norms(cfg, rng)
    zero = rwkv.init_rwkv_state(tcfg, 2, "cpu")
    x = torch.as_tensor(_x(cfg, rng, 2, 13))
    full, fst = rwkv.rwkv_block_forward(tt, tc, tcfg, x, zero, tn)
    part, pst = rwkv.rwkv_block_forward(tt, tc, tcfg, x[:, :-1], zero, tn)
    last, dst = rwkv.rwkv_block_decode(tt, tc, tcfg, x[:, -1:], pst, tn)
    _close(last, full[:, -1:].numpy())
    for a, b in zip(dst, fst):
        _close(a, b.numpy())


def test_bfloat16_keeps_the_reference_promotions():
    """bf16 weights: the mixes are fp32 (mu is), so r / k / v / g are fp32
    products, and k is rounded to bf16 before w_v; within the bf16
    tolerance of tests/test_kernels.py."""
    cfg, tcfg = _cfgs("bfloat16")
    jt, jc, tt, tc = _params(cfg, seed=7)
    rng = np.random.default_rng(7)
    jst, tst = _state(cfg, rng, 2)
    x = _x(cfg, rng, 2, 9)
    jb, tb = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    jst = jst._replace(shift_tmix=jst.shift_tmix.astype(jnp.bfloat16))
    tst = tst._replace(shift_tmix=tst.shift_tmix.bfloat16())
    jy, jS, _ = jrwkv.tmix_forward(jt, cfg, jb, jst)
    ty, tS, _ = rwkv.tmix_forward(tt, tcfg, tb, tst)
    assert ty.dtype == torch.bfloat16 and tS.dtype == torch.float32
    _close(ty, jy, tol=2e-2)
    _close(tS, jS, tol=2e-2)
    jy, _ = jrwkv.cmix_forward(jc, jb, jst.shift_cmix)
    ty, _ = rwkv.cmix_forward(tc, tb, tst.shift_cmix)
    _close(ty, jy, tol=2e-2)


def test_init_state_matches_reference():
    cfg, tcfg = _cfgs("bfloat16")
    js = jrwkv.init_rwkv_state(cfg, 3)
    ts = rwkv.init_rwkv_state(tcfg, 3, "cpu", (4,))
    for a, b in zip(ts, js):
        assert tuple(a.shape) == (4,) + b.shape
        assert str(a.dtype)[6:] == str(b.dtype)


# ------------------------------------ the recurrence's chunk checkpoint

def _tmix_per_token(params, cfg, x, state):
    """``rwkv.tmix_forward`` before its chunk checkpoints: one per-token
    loop over the whole sequence, every token's states saved for the
    backward."""
    _, D = rwkv.dims(cfg)
    H = params["w_r"].shape[1] // D
    shifted = torch.cat([state.shift_tmix.to(x.dtype)[:, None], x[:, :-1]],
                        dim=1)
    r, k, v, g, w = rwkv._projections(params, x, shifted, H, D)
    S, u = state.wkv, params["bonus_u"]
    ys = []
    for t in range(x.shape[1]):
        S, y = rwkv._wkv_step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        ys.append(y)
    y = torch.stack(ys, dim=1)
    return rwkv._group_norm_out(params, y, g, x.dtype), S, x[:, -1]


class _SavedStates(torch.autograd.graph.saved_tensors_hooks):
    """The distinct storages of the (B, H, D, D) states (any view of one:
    a batched matmul saves its (B·H, D, D) operand) autograd saves for
    the backward while it is entered (a checkpoint's inputs pass
    through it; what it recomputes does not)."""

    def __init__(self, state):
        self.states = set()

        def pack(t):
            if t.numel() == state.numel():
                self.states.add(t.untyped_storage().data_ptr())
            return t

        super().__init__(pack, lambda t: t)


@pytest.mark.parametrize("L", [128, 60, 67])
def test_chunk_checkpoint_bitwise_the_per_token_graph(L):
    """L = 128 (two chunks of 64), 60 (one chunk of 60) and the prime 67
    (Q = 1: a chunk a token): output, last state and the gradients of x,
    the incoming state and every time-mix leaf bitwise the per-token
    graph's, except ``bonus_u``'s, within 1e-6 relative: every token adds
    to it, and the chunks may group that sum apart from the per-token
    graph (as the reference's checkpointed scan groups it).  The
    checkpointed graph saves at most L / Q + 1 (B, H, D, D) states (each
    chunk's incoming state, and the last state, which the test's loss
    squares); the per-token graph saves three a token (kv, the bracket
    u·kv + S and the state before the step), at least 3 L."""
    cfg, tcfg = _cfgs()
    _, _, tt, _ = _params(cfg, seed=L)
    rng = np.random.default_rng(L)
    _, tst = _state(cfg, rng, 2)
    x0 = torch.as_tensor(_x(cfg, rng, 2, L))
    H, D = rwkv.dims(tcfg)
    Q = rwkv.chunk_size(L, 64)
    runs = []
    for fn in (rwkv.tmix_forward, _tmix_per_token):
        p = {k: v.clone().requires_grad_(True) for k, v in tt.items()}
        x = x0.clone().requires_grad_(True)
        st = tst._replace(wkv=tst.wkv.clone().requires_grad_(True))
        saved = _SavedStates(st.wkv)
        with saved:
            y, S, last = fn(p, tcfg, x, st)
        (y * torch.linspace(-1, 1, y.shape[-1])).sum().add(
            S.square().sum()).backward()
        runs.append(((y, S, last), {"x": x.grad, "wkv": st.wkv.grad,
                                    **{k: v.grad for k, v in p.items()}},
                     len(saved.states)))
    (out, grads, n), (out0, grads0, n0) = runs
    for a, e in zip(out, out0):
        assert torch.equal(a, e)
    for k, e in grads0.items():
        if k == "bonus_u":
            np.testing.assert_allclose(grads[k].numpy(), e.numpy(),
                                       rtol=1e-6, atol=0)
        else:
            assert torch.equal(grads[k], e), k
    assert n <= L // Q + 1, (n, L, Q)
    assert n0 >= 3 * L, n0


def test_block_chunk_and_no_grad_take_one_pass():
    """``rwkv_block_forward``'s ``chunk`` (the reference's keyword) moves
    no value: under grad at chunk 64, 16 and 7 (Q = 64, 16, 4 at L = 128)
    and without grad (one pass), the outputs and new states equal."""
    cfg, tcfg = _cfgs()
    _, _, tt, tc = _params(cfg, seed=8)
    rng = np.random.default_rng(8)
    _, tn = _norms(cfg, rng)
    _, tst = _state(cfg, rng, 2)
    x = torch.as_tensor(_x(cfg, rng, 2, 128))
    with torch.no_grad():
        want = rwkv.rwkv_block_forward(tt, tc, tcfg, x, tst, tn)
    xg = x.clone().requires_grad_(True)
    for chunk in (64, 16, 7):
        got = rwkv.rwkv_block_forward(tt, tc, tcfg, xg, tst, tn,
                                      chunk=chunk)
        assert torch.equal(got[0], want[0])
        for a, e in zip(got[1], want[1]):
            assert torch.equal(a, e)
