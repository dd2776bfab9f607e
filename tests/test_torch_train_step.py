"""``make_train_step`` against the JAX package's, float32, reduced granite
(dense) and deepseek-r1 (MoE, S = 2, through ``gemm_impl="xla_ragged"``),
AdamW and Adafactor, with and without int8 compression; the launcher's
context (no remat, CE chunks of 16).

Three steps, each started in both packages from the reference's state
(teacher forcing: two float32 implementations drift apart over free-running
steps, and the MoE's top-k then routes differently): the loss and
grad_norm within 1e-5 (relative), the new params, optimizer state and
error-feedback residual within 1e-5 (absolute; Adafactor's factored
moments relative to their largest entry).  AdamW runs with eps = 1e-3:
at the default 1e-8 its update ``g / (|g| + eps)`` turns a 1e-9
float32 difference of a near-zero gradient into a tenth of a step.
Under compression a gradient entry that lies on an int8 rounding boundary
can quantise one step apart in the two packages.  Such entries may
differ by up to 2 * lr in the params and by one quantisation step in the
residual and the optimizer state: at most 1 in 1000 of the tree's
entries under AdamW, 1 in 20 under Adafactor, which spreads a flip over
its entry's row and column (the factored moments: 255 of the 16384
entries of a 128 x 128 leaf); every other entry holds the bounds above.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.moe_layer import default_runtime as jdefault_runtime
from repro.models.transformer import ParallelCtx
from repro.models.transformer import build_model as jbuild_model
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro.training.data import synthetic_lm_batches
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.moe_layer import default_runtime
from repro_torch.models.transformer import TrainCtx, build_model
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.training import tree


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, L, LR = 2, 16, {"adamw": 3e-3, "adafactor": 3e-2}
OPTS = {"adamw": (lambda: jopt.adamw(lr=3e-3, eps=1e-3),
                  lambda: topt.adamw(lr=3e-3, eps=1e-3)),
        "adafactor": (lambda: jopt.adafactor(lr=3e-2),
                      lambda: topt.adafactor(lr=3e-2))}


def _to_port(t):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _to_port(v) for k, v in t.items()}
    return tensor_from_numpy(np.asarray(t), "cpu")


def _compare(name, jtree, ttree, tol, flips, lr, quantum):
    """Every entry within ``tol`` except, under compression, a ``flips``
    share of the tree's entries (counted over the whole tree: a flip in a
    small leaf is one entry of many) within 2 * lr (params) or a quantum
    (state, residual)."""
    off_total = n_total = 0
    for path, leaf in tree.items(ttree):
        exp = np.asarray(tree.get(jtree, path), np.float32)
        got = leaf.detach().float().numpy()
        scale = (max(1.0, float(np.abs(exp).max())) if name == "opt"
                 else 1.0)
        err = np.abs(got - exp)
        off = err > tol * scale
        if not flips:
            assert not off.any(), (name, path, float(err.max()))
            continue
        bound = 2 * lr if name == "params" else quantum(path)
        assert (err[off] <= bound).all(), (name, path, float(err.max()))
        off_total += int(off.sum())
        n_total += off.size
    assert off_total <= flips * max(n_total, 1), (name, off_total, n_total)


@pytest.mark.parametrize("compression", [False, True],
                         ids=["plain", "int8"])
@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-r1"])
def test_train_step_matches_the_reference(arch, opt, compression):
    kw = {"num_layers": 2}
    jcfg = jget_config(arch).reduced().replace(dtype="float32", **kw)
    cfg = get_config(arch).reduced().replace(dtype="float32", **kw)
    S = 2 if cfg.moe else 1
    jm = jbuild_model(jcfg, num_servers=S)
    jrt = (jdefault_runtime(jcfg, S, B * L, gemm_impl="xla_ragged")
           if jcfg.moe else None)
    jo, to = (f() for f in OPTS[opt])
    jstate = jtl.init_train_state(jm, jo, jax.random.PRNGKey(0),
                                  compression=compression)
    jstep = jax.jit(jtl.make_train_step(
        jm, jo, ParallelCtx(remat=False, moe_runtime=jrt, ce_chunk=16),
        compression=compression))
    model = build_model(cfg, S, None, "cpu")
    rt = default_runtime(cfg, S, B * L, "cpu") if cfg.moe else None
    tstep = ttl.make_train_step(model, to, TrainCtx(
        moe_runtime=rt, remat=False, ce_chunk=16), compression=compression)
    data = synthetic_lm_batches(jcfg, B, L, seed=0)
    for _ in range(3):
        batch = next(data)
        tstate = ttl.TrainState(
            params=_to_port(jstate.params),
            opt_state=_to_port(jstate.opt_state),
            step=torch.tensor(int(jstate.step), dtype=torch.int32),
            ef_residual=_to_port(jstate.ef_residual))
        for p in tree.leaves(tstate.params):
            p.requires_grad_(True)
        jstate, jm_ = jstep(jstate, batch)
        tstate, tm_ = tstep(tstate, {k: torch.from_numpy(np.array(v))
                                     for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=1e-5)
        assert int(tstate.step) == int(jstate.step)

        def quantum(path):
            """The quantisation step of the param leaf that a params /
            state / residual path names (an optimizer path drops its mu /
            nu / f head and Adafactor's factor tail), bounded by twice the
            reference's new residual: |g32 - deq| <= step / 2."""
            if path[0] in ("mu", "nu", "f"):
                path = path[1:-1] if path[0] == "f" else path[1:]
            return 2.02 * float(np.abs(tree.get(jstate.ef_residual,
                                                path)).max())
        flips = compression and {"adamw": 1e-3, "adafactor": 5e-2}[opt]
        _compare("params", jstate.params, tstate.params, 1e-5, flips,
                 LR[opt], quantum)
        _compare("opt", jstate.opt_state, tstate.opt_state, 1e-5, flips,
                 LR[opt], quantum)
        if compression:
            _compare("ef", jstate.ef_residual, tstate.ef_residual, 1e-5,
                     flips, LR[opt], quantum)
