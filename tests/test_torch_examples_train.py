"""``repro_torch.examples.train_small`` against ``examples/train_small.py``
(loaded from its path, unedited), float32, at ``--steps 10`` (the JAX
script's own flag; its default, 60, takes minutes in both packages here).

The JAX script runs first; a stand-in for its ``jax`` records each jitted
step's state, batch and metrics.  The port's tour then starts from the JAX
tour's initial params (bridged) and, as ``tests/test_torch_train_step.py``
holds the train step, every later step starts from the JAX tour's state
before it (teacher forcing, written into the port's live state in place:
two float32 implementations drift apart over free-running steps).  Each
step's batch equals the JAX one; loss and grad_norm within 1e-5
(relative), ``dropped`` exact; the printed lines equal but the numbers of
the step and loss lines (excepted: printed at 3-4 decimals, they are held
through the values at 1e-5).  With ``--compress-grads`` the error-feedback
residual is forced too.

``--restore``: a checkpoint of the JAX tour's state after step 7, written
by the JAX package, is restored by both tours (the port's into its live
state); the first resumed step is not forced, so its loss holds the
restore, and both tours end the same way (the script's loss assert holds
or fails in both).  Checkpoints go to ``tmp_path``.
"""

import re
import shutil
import types

import jax
import numpy as np
import pytest
import torch

from repro.training.checkpoint import save_checkpoint
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.training import tree
from torch_examples_cases import (fp32, lines, load_example, one_thread,
                                  port_example)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_thread)

STEPS = 10


def _recording_jax(calls):
    def jit(f):
        g = jax.jit(f)

        def step(state, batch):
            before = jax.tree.map(np.asarray, state)
            out = g(state, batch)
            calls.append((before, {k: np.asarray(v)
                                   for k, v in batch.items()},
                          jax.tree.map(np.asarray, out[1]), out[0]))
            return out
        return step
    return types.SimpleNamespace(jit=jit, random=jax.random)


def _force(tstate, jstate) -> None:
    """Write the JAX state into the port's live state, in place."""
    with torch.no_grad():
        for ttree, jtree in ((tstate.params, jstate.params),
                             (tstate.opt_state, jstate.opt_state),
                             (tstate.ef_residual, jstate.ef_residual)):
            if ttree is None:
                continue
            for path, leaf in tree.items(ttree):
                leaf.copy_(torch.from_numpy(
                    np.array(tree.get(jtree, path))).to(leaf.dtype))
        tstate.step.fill_(int(jstate.step))


def _run(monkeypatch, capsys, tmp_path, argv, ckpt=None):
    jmod, tmod = load_example("train_small"), port_example("train_small")
    fp32(monkeypatch, jmod)
    fp32(monkeypatch, tmod)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    if ckpt is not None:
        shutil.copytree(ckpt, jdir)
        shutil.copytree(ckpt, tdir)
    monkeypatch.setattr(jmod, "CKPT_DIR", jdir)
    monkeypatch.setattr(tmod, "CKPT_DIR", tdir)
    calls = []
    monkeypatch.setattr(jmod, "jax", _recording_jax(calls))
    monkeypatch.setattr("sys.argv", ["train_small.py", *argv])
    jerr = terr = None
    try:
        jmod.main()
    except AssertionError as e:
        jerr = str(e)
    jout = lines(capsys.readouterr().out)

    cfg = get_config("kimi-k2-1t-a32b").reduced().replace(dtype="float32")
    real_init, real_compile = tmod.init_train_state, tmod.compile_train_step
    if ckpt is None:      # restored runs keep the port's own seeded init
        monkeypatch.setattr(tmod, "init_train_state",
                            lambda *a, **kw: real_init(*a, params=(
                                params_from_numpy(calls[0][0].params, cfg,
                                                  "cpu")), **kw))
    seen = []

    def compile_forced(step_fn, dev):
        compiled = real_compile(step_fn, dev)

        def step(state, batch):
            i = len(seen)
            if i or ckpt is None:
                _force(state, calls[i][0])
            out = compiled(state, batch)
            seen.append(({k: v.numpy().copy() for k, v in batch.items()},
                         {k: v.detach().clone() for k, v in out[1].items()}))
            return out
        return step

    monkeypatch.setattr(tmod, "compile_train_step", compile_forced)
    try:
        res = tmod.main(["--device", "cpu", *argv])
    except AssertionError as e:
        terr, res = str(e), None
    tout = lines(capsys.readouterr().out)
    return jout, tout, calls, seen, jerr, terr, res


def _check(jout, tout, calls, seen):
    assert len(seen) == len(calls) > 0
    for (jbefore, jbatch, jm, _), (tbatch, tm) in zip(calls, seen):
        for k in jbatch:
            np.testing.assert_array_equal(tbatch[k], jbatch[k])
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-5)
        assert int(tm["dropped"]) == int(jm["dropped"])
    number = re.compile(r"-?\d+\.\d+")
    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        if b.startswith("step ") or b.startswith("loss "):
            assert number.sub("#", a) == number.sub("#", b), (a, b)
            for x, y in zip(number.findall(a), number.findall(b)):
                assert abs(float(x) - float(y)) <= 2e-3, (a, b)
        else:
            assert a == b, (a, b)


@pytest.mark.parametrize("flags", [[], ["--compress-grads"]],
                         ids=["plain", "int8"])
def test_train_small_matches_the_jax_tour(monkeypatch, capsys, tmp_path,
                                          flags):
    jout, tout, calls, seen, jerr, terr, res = _run(
        monkeypatch, capsys, tmp_path, ["--steps", str(STEPS), *flags])
    assert jerr is None and terr is None
    _check(jout, tout, calls, seen)
    assert len(calls) == STEPS
    assert res["history"][-1]["loss"] < res["history"][0]["loss"]


def test_train_small_restores_a_jax_checkpoint(monkeypatch, capsys,
                                               tmp_path):
    """The JAX tour's state after 7 steps, saved by the JAX package as
    step 7, restored by both tours and trained 3 more steps."""
    calls = []
    jmod = load_example("train_small")
    fp32(monkeypatch, jmod)
    monkeypatch.setattr(jmod, "CKPT_DIR", str(tmp_path / "first"))
    monkeypatch.setattr(jmod, "jax", _recording_jax(calls))
    monkeypatch.setattr("sys.argv", ["train_small.py", "--steps", "8"])
    jmod.main()
    capsys.readouterr()
    ckpt = tmp_path / "ckpt"
    save_checkpoint(str(ckpt), 7, calls[7][0])
    monkeypatch.undo()
    jout, tout, calls, seen, jerr, terr, res = _run(
        monkeypatch, capsys, tmp_path, ["--restore", "--steps", "10"],
        ckpt=ckpt)
    assert jout[1] == tout[1] == "resumed from checkpoint step 7"
    assert (jerr is None) == (terr is None)
    assert len(calls) == len(seen) == 3
    _check(jout, tout, calls, seen)
