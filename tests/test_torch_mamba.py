"""The port's Mamba2 block (``repro_torch.models.mamba``) against the JAX
package's: the causal conv, the chunked SSD scan and its chunk rule (Q =
64, a smaller divisor, a prime length's per-token scan), the forward from
a nonzero state and the one-token decode.  fp32 at 1e-5 (rtol and atol,
as ``tests/test_kernels.py``), same numpy inputs in both packages.  Under
autograd the forward checkpoints the chunked scan: against the same
forward without the checkpoint, outputs and gradients bitwise, and the
batched (B, nc, Q, Q, H) decay masks are not saved for the backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import mamba as jmamba
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import mamba

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jget_config("zamba2-2.7b").reduced().replace(dtype="float32"),
            get_config("zamba2-2.7b").reduced().replace(dtype="float32"))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), rtol=tol, atol=tol)


def _params(cfg, seed=1):
    jp = jmamba.init_mamba(jax.random.PRNGKey(seed), cfg)
    # a decay and skip that are not the init's constants
    rng = np.random.default_rng(seed)
    H = jp["A_log"].shape[0]
    jp = dict(jp, A_log=jnp.asarray(rng.normal(size=H) * 0.3, jnp.float32),
              dt_bias=jnp.asarray(rng.normal(size=H) * 0.5, jnp.float32),
              D=jnp.asarray(rng.normal(size=H), jnp.float32))
    return jp, jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a),
                                                        "cpu"), jp)


def _state(cfg, rng, B):
    d_inner, H, P, N = mamba.dims(get_config("zamba2-2.7b").reduced())
    ssm = (rng.normal(size=(B, H, P, N)) * 0.3).astype(np.float32)
    conv = (rng.normal(size=(B, cfg.ssm.d_conv - 1, d_inner))
            * 0.5).astype(np.float32)
    return (jmamba.MambaState(jnp.asarray(ssm), jnp.asarray(conv)),
            mamba.MambaState(torch.as_tensor(ssm), torch.as_tensor(conv)))


def test_dims_and_init_match_reference():
    cfg, tcfg = _cfgs()
    assert mamba.dims(tcfg) == jmamba.dims(cfg)
    full = get_config("zamba2-2.7b")
    assert mamba.dims(full) == (5120, 80, 64, 64)
    jp = jmamba.init_mamba(jax.random.PRNGKey(0), cfg)
    tp = mamba.init_mamba(tcfg, torch.float32, "cpu",
                          torch.Generator().manual_seed(0), (2, 3))
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert tuple(tp[k].shape) == (2, 3) + jp[k].shape, k
    assert torch.equal(tp["D"], torch.ones_like(tp["D"]))


@pytest.mark.parametrize("with_state", [False, True])
def test_conv_matches_reference(with_state):
    cfg, _ = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    w = (rng.normal(size=(cfg.ssm.d_conv, 24)) * 0.3).astype(np.float32)
    st = (rng.normal(size=(2, cfg.ssm.d_conv - 1, 24)).astype(np.float32)
          if with_state else None)
    jo, js = jmamba._conv(jnp.asarray(x), jnp.asarray(w),
                          None if st is None else jnp.asarray(st))
    to, ts = mamba._conv(torch.as_tensor(x), torch.as_tensor(w),
                         None if st is None else torch.as_tensor(st))
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("L,Q", [(128, 64), (96, 48), (67, 1), (23, 23)])
def test_chunk_rule(L, Q):
    """Q = min(64, L), lowered until it divides L: the reference's rule."""
    assert mamba.chunk_size(L, 64) == Q


@pytest.mark.parametrize("L", [128, 96, 67])
def test_ssd_chunked_matches_reference_and_scan(L):
    """At Q = 64, at Q = 48 (a smaller divisor) and at a prime L (Q = 1):
    equal to the JAX package's chunked scan and to the port's per-step
    scan, outputs and final state."""
    rng = np.random.default_rng(L)
    B, H, P, N = 2, 3, 4, 5
    u = (rng.normal(size=(B, L, H, P)) * 0.3).astype(np.float32)
    logA = -rng.uniform(0.01, 0.3, size=(B, L, H)).astype(np.float32)
    Bm = (rng.normal(size=(B, L, N)) * 0.5).astype(np.float32)
    Cm = (rng.normal(size=(B, L, N)) * 0.5).astype(np.float32)
    S0 = (rng.normal(size=(B, H, P, N)) * 0.3).astype(np.float32)
    j = [jnp.asarray(a) for a in (u, logA, Bm, Cm, S0)]
    t = [torch.as_tensor(a) for a in (u, logA, Bm, Cm, S0)]
    jy, jS = jmamba._ssd_chunked(*j, chunk=64)
    ty, tS = mamba._ssd_chunked(*t, chunk=64)
    _close(ty, jy)
    _close(tS, jS)
    ry, rS = mamba._ssd_scan_ref(*t)
    _close(ty, ry)
    _close(tS, rS)
    jry, jrS = jmamba._ssd_scan_ref(*j)
    _close(ry, jry)
    _close(rS, jrS)


@pytest.mark.parametrize("L,ref_scan", [(64, False), (48, False), (31, False),
                                        (31, True)])
def test_forward_from_state_matches_reference(L, ref_scan):
    cfg, tcfg = _cfgs()
    jp, tp = _params(cfg)
    rng = np.random.default_rng(L)
    x = (rng.normal(size=(2, L, cfg.d_model)) * 0.5).astype(np.float32)
    jst, tst = _state(cfg, rng, 2)
    jy, jnew = jmamba.mamba_forward(jp, cfg, jnp.asarray(x), jst,
                                    use_ref_scan=ref_scan)
    ty, tnew = mamba.mamba_forward(tp, tcfg, torch.as_tensor(x), tst,
                                   use_ref_scan=ref_scan)
    _close(ty, jy)
    _close(tnew.ssm, jnew.ssm)
    _close(tnew.conv, jnew.conv)


def test_decode_continues_the_forward():
    """A forward of L - 1 tokens then one decode step equals the forward of
    L tokens (last output, state); the decode equals the reference's."""
    cfg, tcfg = _cfgs()
    jp, tp = _params(cfg, seed=4)
    rng = np.random.default_rng(5)
    L = 20
    x = torch.as_tensor((rng.normal(size=(2, L, cfg.d_model))
                         * 0.5).astype(np.float32))
    full, fst = mamba.mamba_forward(tp, tcfg, x)
    part, pst = mamba.mamba_forward(tp, tcfg, x[:, :-1])
    last, dst = mamba.mamba_decode(tp, tcfg, x[:, -1:], pst)
    _close(last, full[:, -1:].numpy())
    _close(dst.ssm, fst.ssm.numpy())
    _close(dst.conv, fst.conv.numpy())
    jst = jmamba.MambaState(jnp.asarray(pst.ssm.numpy()),
                            jnp.asarray(pst.conv.numpy()))
    jlast, jdst = jmamba.mamba_decode(jp, cfg, jnp.asarray(x[:, -1:].numpy()),
                                      jst)
    _close(last, jlast)
    _close(dst.ssm, jdst.ssm)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_state_matches_reference(dtype):
    cfg, tcfg = (c.replace(dtype=dtype) for c in _cfgs())
    js = jmamba.init_mamba_state(cfg, 3)
    ts = mamba.init_mamba_state(tcfg, 3, "cpu", (2, 6))
    for a, b in zip(ts, js):
        assert tuple(a.shape) == (2, 6) + b.shape
        assert str(a.dtype)[6:] == str(b.dtype)
        assert not a.any()


def test_bfloat16_forward_keeps_the_reference_roundings():
    """bf16 weights and activations: the gate is fp32 and rounded to bf16
    before the norm, as in the reference; within the bf16 tolerance of
    tests/test_kernels.py."""
    cfg, tcfg = (c.replace(dtype="bfloat16") for c in _cfgs())
    jp, tp = _params(cfg, seed=6)
    rng = np.random.default_rng(6)
    x = (rng.normal(size=(2, 16, cfg.d_model)) * 0.5).astype(np.float32)
    jy, _ = jmamba.mamba_forward(jp, cfg, jnp.asarray(x, jnp.bfloat16))
    ty, _ = mamba.mamba_forward(tp, tcfg, torch.as_tensor(x).bfloat16())
    assert ty.dtype == torch.bfloat16
    _close(ty, jy, tol=2e-2)


def _plain(fn, *args, **kwargs):
    """``common.remat_if_recording`` without the checkpoint: the scan as
    the forward called it before."""
    return fn(*args, **kwargs)


@pytest.mark.parametrize("L", [128, 60, 67])
def test_ssd_checkpoint_bitwise_the_unchecked_forward(L, monkeypatch):
    """``mamba_forward`` from a nonzero state at L = 128 (Q = 64), 60 (one
    chunk) and the prime 67 (Q = 1), with the chunked scan checkpointed
    and without: output, new states and the gradients of x, the incoming
    state and every leaf bitwise equal.  The checkpointed forward saves
    no (B, nc, Q, Q, H) mask for the backward; without it, it does."""
    cfg, tcfg = _cfgs()
    _, tp = _params(cfg, seed=L)
    rng = np.random.default_rng(L)
    _, tst = _state(cfg, rng, 2)
    # steps of dt ~0.1 (Mamba2's init range): where a chunk's decays sum
    # past ~88, a masked entry of exp(Mlog) overflows and its zero
    # gradient times inf is nan, in both graphs (the reference's too)
    tp = dict(tp, dt_bias=tp["dt_bias"] - 2.5)
    x0 = torch.as_tensor((rng.normal(size=(2, L, cfg.d_model))
                          * 0.5).astype(np.float32))
    H = mamba.dims(tcfg)[1]
    Q = mamba.chunk_size(L, 64)
    masks = (2, L // Q, Q, Q, H)
    runs = []
    for remat in (mamba.remat_if_recording, _plain):
        monkeypatch.setattr(mamba, "remat_if_recording", remat)
        p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
        x = x0.clone().requires_grad_(True)
        st = tst._replace(ssm=tst.ssm.clone().requires_grad_(True))
        shapes = set()
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: shapes.add(tuple(t.shape)) or t, lambda t: t):
            y, new = mamba.mamba_forward(p, tcfg, x, st)
        (y.square().sum() + new.ssm.square().sum()).backward()
        runs.append(((y, *new), {"x": x.grad, "ssm": st.ssm.grad,
                                 **{k: v.grad for k, v in p.items()}},
                     masks in shapes))
    (out, grads, big), (out0, grads0, big0) = runs
    for a, e in zip(out, out0):
        assert torch.equal(a, e)
    for k, e in grads0.items():
        assert torch.isfinite(e).all() and torch.equal(grads[k], e), k
    assert not big and big0
