"""The compiled train step (``train_loop.compile_train_step``, the
reference's ``jax.jit`` of its train step) on the CPU, where it runs the
graph's staging eagerly: reduced granite (dense) and deepseek-r1 (MoE,
S = 2), float32.

* Over 5 free-running steps it is bitwise a pure step built from the
  same pieces with the functional ``opt.update`` (fresh params, optimizer
  state, residual and step each step): AdamW under a cosine schedule with
  warm-up (a new learning rate every step), Adafactor with its leaves cut
  into chunks (``CHUNK`` below every matrix leaf), int8 compression on
  and off.
* Teacher-forced against the JAX package's jitted step, written into one
  live state each step (so the compiled step keeps its addresses), at
  ``test_torch_train_step.py``'s tolerances.
* On ``meta``, no op of the step receives a host tensor: what would be
  frozen into a CUDA graph as a kernel argument at capture.
* A checkpoint restored into the live state mid-run, and the launcher
  inside and outside ``eager()``.
"""

import contextlib
import math

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jget_config
from repro.core.moe_layer import default_runtime as jdefault_runtime
from repro.models.transformer import ParallelCtx
from repro.models.transformer import build_model as jbuild_model
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro.training.data import synthetic_lm_batches as jbatches
from repro_torch.configs import get_config
from repro_torch.core.moe_layer import default_runtime
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import TrainCtx, build_model
from repro_torch.serving import step_graphs
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import train_loop as ttl
from repro_torch.training import tree
from repro_torch.training.data import synthetic_lm_batches
from test_torch_train_step import _compare, _to_port


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B, L, STEPS = 2, 16, 5
CHUNK = 20000     # a 128 x 128 matrix a chunk; 128 x 256 and 512 x 128 in rows
OPTS = {"adamw": (lambda: jopt.adamw(lr=jopt.cosine_schedule(3e-3, 3, 8),
                                     eps=1e-3),
                  lambda: topt.adamw(lr=topt.cosine_schedule(3e-3, 3, 8),
                                     eps=1e-3), 3e-3),
        "adafactor": (lambda: jopt.adafactor(lr=3e-2),
                      lambda: topt.adafactor(lr=3e-2), 3e-2)}


def _port_setup(arch, opt, dev="cpu"):
    cfg = get_config(arch).reduced().replace(dtype="float32", num_layers=2)
    S = 2 if cfg.moe else 1
    model = build_model(cfg, S, np.zeros((S, 0), np.int32), dev)
    rt = default_runtime(cfg, S, B * L, dev) if cfg.moe else None
    ctx = TrainCtx(moe_runtime=rt, remat=False, ce_chunk=16)
    return cfg, model, OPTS[opt][1](), ctx


def _state(model, opt, compression, seed=0):
    return ttl.init_train_state(model, opt,
                                torch.Generator().manual_seed(seed),
                                compression)


def _pure_step(model, opt, ctx, compression):
    """The reference's pure step from the port's pieces: fresh leaves,
    the functional clip and ``opt.update``, ``p + u``, a new residual and
    a new step."""
    def step(state, batch):
        params = tree.map_params(
            lambda p: p.detach().clone().requires_grad_(), state.params)
        loss, metrics = model.loss_fn(params, batch, ctx)
        loss.backward()
        with torch.no_grad():
            grads = ttl.collect_grads(params)
            ef = state.ef_residual
            if compression:
                pairs = tree.map_params(ttl.compress_with_feedback, grads,
                                        ef)
                grads = tree.map_params(lambda p, pr: pr[0], params, pairs)
                ef = tree.map_params(lambda p, pr: pr[1], params, pairs)
            grads, gnorm = topt.clip_by_global_norm(grads, 1.0)
            updates, opt_state = opt.update(grads, state.opt_state, params,
                                            state.step)
            params = tree.map_params(
                lambda p, u: (p + u).requires_grad_(), params, updates)
        return (ttl.TrainState(params, opt_state, state.step + 1, ef),
                dict(metrics, loss=loss.detach(), grad_norm=gnorm))
    return step


def _leaves(state):
    return list(step_graphs.tensors(state))


@pytest.mark.parametrize("compression", [False, True], ids=["plain", "int8"])
@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-r1"])
def test_compiled_step_is_the_pure_step_bitwise(arch, opt, compression,
                                                monkeypatch):
    if opt == "adafactor":
        monkeypatch.setattr(topt, "CHUNK", CHUNK)
    cfg, model, o, ctx = _port_setup(arch, opt)
    live = _state(model, o, compression)
    pure = _state(model, o, compression)
    addrs = step_graphs.addresses(live)
    step = ttl.compile_train_step(
        ttl.make_train_step(model, o, ctx, compression=compression), "cpu")
    ref = _pure_step(model, o, ctx, compression)
    data = synthetic_lm_batches(cfg, B, L, seed=0)
    if opt == "adafactor":       # leaves cut into matrices and into rows
        shapes = [p.shape for p in tree.leaves(live.params) if p.dim() >= 2]
        cuts = [list(topt._chunks(math.prod(sh[:-2]), *sh[-2:], CHUNK))
                for sh in shapes]
        assert any(c[0][1].stop < sh[-2] for c, sh in zip(cuts, shapes))
        assert any(len(c) > 1 and c[0][1].stop == sh[-2]
                   for c, sh in zip(cuts, shapes))
    else:                        # the warm-up and cosine: a new lr a step
        lr = topt.cosine_schedule(3e-3, 3, 8)
        assert len({float(lr(i)) for i in range(STEPS)}) == STEPS
    for i in range(STEPS):
        batch = next(data)
        live, got = step(live, batch)
        pure, want = ref(pure, batch)
        for k in want:
            assert torch.equal(got[k], want[k]), (i, k)
        assert step_graphs.addresses(live) == addrs
        for a, b in zip(_leaves(live), _leaves(pure)):
            assert a.dtype == b.dtype and torch.equal(a, b), i
    assert int(live.step) == STEPS and live.step.dtype == torch.int32
    assert step.captures == step.replays == 0
    if compression:
        assert any(float(r.abs().max()) > 0
                   for r in tree.leaves(live.ef_residual))


def _write(live, jstate):
    """The reference's state into the live state's own tensors."""
    with torch.no_grad():
        for name in ("params", "opt_state", "ef_residual"):
            for path, leaf in tree.items(getattr(live, name)):
                leaf.copy_(_to_port(tree.get(getattr(jstate, name), path)))
        live.step.fill_(int(jstate.step))


@pytest.mark.parametrize("arch,opt,compression", [
    ("granite-3-2b", "adamw", True), ("granite-3-2b", "adafactor", False),
    ("deepseek-r1", "adamw", False), ("deepseek-r1", "adafactor", True)])
def test_compiled_step_matches_the_jitted_reference(arch, opt, compression):
    jcfg = jget_config(arch).reduced().replace(dtype="float32", num_layers=2)
    S = 2 if jcfg.moe else 1
    jm = jbuild_model(jcfg, num_servers=S)
    jrt = (jdefault_runtime(jcfg, S, B * L, gemm_impl="xla_ragged")
           if jcfg.moe else None)
    jo = OPTS[opt][0]()
    jstate = jtl.init_train_state(jm, jo, jax.random.PRNGKey(0),
                                  compression=compression)
    jstep = jax.jit(jtl.make_train_step(
        jm, jo, ParallelCtx(remat=False, moe_runtime=jrt, ce_chunk=16),
        compression=compression))
    cfg, model, o, ctx = _port_setup(arch, opt)
    live = _state(model, o, compression)
    step = ttl.compile_train_step(
        ttl.make_train_step(model, o, ctx, compression=compression), "cpu")
    data = jbatches(jcfg, B, L, seed=0)
    lr = OPTS[opt][2]
    for _ in range(3):
        batch = next(data)
        _write(live, jstate)
        jstate, jm_ = jstep(jstate, batch)
        live, tm_ = step(live, {k: torch.from_numpy(np.array(v))
                                for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]),
                                       rtol=1e-5)
        assert int(live.step) == int(jstate.step)

        def quantum(path):
            if path[0] in ("mu", "nu", "f"):
                path = path[1:-1] if path[0] == "f" else path[1:]
            return 2.02 * float(np.abs(tree.get(jstate.ef_residual,
                                                path)).max())
        flips = compression and {"adamw": 1e-3, "adafactor": 5e-2}[opt]
        _compare("params", jstate.params, live.params, 1e-5, flips, lr,
                 quantum)
        _compare("opt", jstate.opt_state, live.opt_state, 1e-5, flips, lr,
                 quantum)
        if compression:
            _compare("ef", jstate.ef_residual, live.ef_residual, 1e-5,
                     flips, lr, quantum)


class _HostTensors(TorchDispatchMode):
    """Records every op that receives or returns a tensor off ``meta``."""

    def __init__(self):
        super().__init__()
        self.ops, self.seen = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        devs = {t.device.type for t in step_graphs.tensors(
            [list(args), list(kwargs.values()), out])}
        self.seen += 1
        if devs - {"meta"}:
            self.ops.append((str(func), sorted(devs)))
        return out


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("arch", ["granite-3-2b", "deepseek-r1"])
def test_no_host_tensor_reaches_an_op_of_the_step(arch, opt):
    """On ``meta`` every tensor of the step (forward, backward, clip,
    int8 compression, optimizer, the step's increment) stays on the
    device: the step counter, the learning rate and the bias corrections
    included, so a graph captured at one step reads the next one's."""
    _, model, o, ctx = _port_setup(arch, opt, "meta")
    state = ttl.init_train_state(model, o, None, compression=True)
    assert state.step.device.type == "meta"
    inner = ttl.make_train_step(model, o, ctx, compression=True)
    rec = _HostTensors()

    def recorded(state, batch):
        with rec:
            return inner(state, batch)
    step = ttl.compile_train_step(recorded, "meta")
    tokens = torch.zeros((B, L), dtype=torch.int32)
    state, m = step(state, {"tokens": tokens, "labels": tokens})
    assert rec.seen > 100 and rec.ops == []
    assert m["loss"].device.type == "meta"


def test_step_that_returns_new_tensors_is_refused():
    _, model, o, ctx = _port_setup("granite-3-2b", "adamw")
    step = ttl.compile_train_step(_pure_step(model, o, ctx, False), "cpu")
    batch = next(synthetic_lm_batches(get_config("granite-3-2b").reduced(),
                                      B, L, seed=0))
    with pytest.raises(ValueError, match="in place"):
        step(_state(model, o, False), batch)


def test_checkpoint_restored_into_the_live_state(tmp_path):
    """Two steps, a save, two steps on other data, the save restored into
    the live state (its addresses kept, so a graph of the step would
    replay on), three steps: bitwise an uninterrupted five."""
    cfg, model, o, ctx = _port_setup("deepseek-r1", "adamw")
    data = synthetic_lm_batches(cfg, B, L, seed=0)
    batches = [next(data) for _ in range(STEPS)]
    other = synthetic_lm_batches(cfg, B, L, seed=7)
    runs = {}
    for name in ("straight", "resumed"):
        state = _state(model, o, True)
        addrs = step_graphs.addresses(state)
        step = ttl.compile_train_step(
            ttl.make_train_step(model, o, ctx, compression=True), "cpu")
        for i, b in enumerate(batches):
            if name == "resumed" and i == 2:
                ckpt.save_checkpoint(str(tmp_path), 2, state)
                for _ in range(2):
                    state, _ = step(state, next(other))
                assert int(state.step) == 4
                back, s = ckpt.restore_checkpoint(str(tmp_path), state,
                                                  into=True)
                assert s == 2 and back is state and int(state.step) == 2
            state, m = step(state, b)
        assert step_graphs.addresses(state) == addrs
        runs[name] = (float(m["loss"]), _leaves(state))
    assert runs["straight"][0] == runs["resumed"][0]
    for a, b in zip(runs["straight"][1], runs["resumed"][1]):
        assert torch.equal(a, b)
    wider = state._replace(params=tree.map_params(
        lambda p: p.detach().double(), state.params))
    with pytest.raises(ValueError, match="another dtype"):
        ckpt.restore_checkpoint(str(tmp_path), wider, into=True)


def test_launcher_and_train_loop_inside_and_outside_eager(capsys):
    args = ["--device", "cpu", "--arch", "deepseek-r1", "--steps", "12",
            "--batch", "2", "--seq", "16"]
    seen = []
    hist = launch_train.run(launch_train.parser().parse_args(args),
                            observe=lambda i, st, m, step, b: seen.append(
                                (i, float(m["loss"]), int(st.step),
                                 step.captures)))
    with step_graphs.eager():
        again = launch_train.run(launch_train.parser().parse_args(args))
    assert [h["step"] for h in hist] == [0, 10, 11] and hist == again
    assert seen == [(i, seen[i][1], i + 1, 0) for i in range(12)]
    assert seen[10][1] == hist[1]["loss"]
    cfg, model, o, ctx = _port_setup("granite-3-2b", "adamw")
    out = []
    for arm in (False, True):
        with step_graphs.eager() if arm else contextlib.nullcontext():
            state, h = ttl.train_loop(
                model, o, ctx, synthetic_lm_batches(cfg, B, L, seed=0), 4,
                torch.Generator().manual_seed(0), log_every=2)
        out.append((h, _leaves(state)))
    assert out[0][0] == out[1][0] and [e["step"] for e in out[0][0]] == \
        [0, 2, 3]
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)
    assert "step     0" in capsys.readouterr().out
