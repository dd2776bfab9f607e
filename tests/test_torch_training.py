"""The port's training substrate against the JAX package's: optimizers
(AdamW, Adafactor, its chunked update), clip, schedule, int8 compression,
the synthetic data stream, checkpoints across packages (both ways, bf16
and Adafactor's nested state included, bitwise), the train launcher on
the CPU; and the reference's own training tests
(tests/test_training_and_checkpoint.py) mirrored on the port.

Tolerances: the optimizers' updates and states within 2e-7 of the
reference's on the same inputs (the schedule's cosine, the powers and
Adafactor's means round in another order); the chunked Adafactor within
1e-6 of the whole-leaf one (the column statistic of a matrix cut into
row chunks is summed chunk by chunk); data, quantised values and
checkpoints exact.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.training import checkpoint as jckpt
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro.models.transformer import build_model as jbuild_model
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import TrainCtx, build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as topt
from repro_torch.training import tree
from repro_torch.training.data import ShareGPTLike, synthetic_lm_batches
from repro_torch.training.train_loop import (TrainState,
                                             compress_with_feedback,
                                             init_train_state,
                                             make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(rng):
    """Mixed 1-D / 2-D / 4-D, float32 / bfloat16 leaves."""
    return {"a": rng.normal(size=(7,)).astype(np.float32),
            "b": {"w": rng.normal(size=(2, 3, 5, 6)).astype(np.float32),
                  "h": rng.normal(size=(4, 9)).astype(ml_dtypes.bfloat16),
                  "n": rng.normal(size=(3,)).astype(ml_dtypes.bfloat16)}}


def _port(t):
    if isinstance(t, dict):
        return {k: _port(v) for k, v in t.items()}
    return tensor_from_numpy(np.asarray(t), "cpu")


def _assert_tree(got, exp, atol=0.0, rel=False):
    for path, leaf in tree.items(got):
        e = np.asarray(tree.get(exp, path), np.float32)
        tol = atol * (max(1e-30, float(np.abs(e).max())) if rel else 1.0)
        np.testing.assert_allclose(leaf.detach().float().numpy(), e,
                                   rtol=0, atol=tol, err_msg=str(path))


OPTS = {"adamw": (lambda: jopt.adamw(lr=jopt.cosine_schedule(1e-2, 2, 10),
                                     weight_decay=0.1),
                  lambda: topt.adamw(lr=topt.cosine_schedule(1e-2, 2, 10),
                                     weight_decay=0.1), 2e-7),
        "adafactor": (lambda: jopt.adafactor(lr=3e-2),
                      lambda: topt.adafactor(lr=3e-2), 2e-7)}


@pytest.mark.parametrize("name", list(OPTS))
def test_optimizer_update_and_state_match_the_reference(name, rng):
    """init / update over 3 steps on a mixed tree: updates, states and
    the params after ``p + u``; ``apply_`` gives the same params and
    state in place."""
    mk_j, mk_t, tol = OPTS[name]
    jo, to = mk_j(), mk_t()
    params = _np_tree(rng)
    jp = jax.tree.map(jnp.asarray, params)
    tp, tp2 = _port(params), _port(params)
    js, ts, ts2 = jo.init(jp), to.init(tp), to.init(tp2)
    _assert_tree(ts, js)
    for step in range(3):
        g = _np_tree(rng)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp, step)
        tu, ts = to.update(_port(g), ts, tp, step)
        _assert_tree(tu, ju, tol)
        _assert_tree(ts, js, tol, rel=True)
        jp = jax.tree.map(lambda p, u: p + u.astype(p.dtype), jp, ju)
        tp = tree.map_params(lambda p, u: p + u, tp, tu)
        ts2 = to.apply_(_port(g), ts2, tp2, step)
        for a, b in zip(tree.leaves(tp), tree.leaves(tp2)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(tree.leaves(ts), tree.leaves(ts2)):
            assert torch.equal(a, b)
    _assert_tree(tp, jp, tol * 10)


@pytest.mark.parametrize("chunk", [60, 7, 1], ids=["whole matrices",
                                                   "row chunks", "one row"])
def test_adafactor_chunked_equals_whole_leaf(chunk, rng, monkeypatch):
    """The chunked update (matrices, then rows of one matrix: CHUNK set
    below a leaf's size) against the whole-leaf update: updates and
    factored state."""
    p = {"w": torch.from_numpy(rng.normal(size=(3, 2, 5, 6))
                               .astype(np.float32)),
         "v": torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))}
    opt = topt.adafactor(lr=3e-2)
    sw, sp = opt.init(p), opt.init(p)
    for step in range(3):
        g = {k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
             for k, v in p.items()}
        uw, sw = opt.update(g, sw, p, step)
        with monkeypatch.context() as m:
            m.setattr(topt, "CHUNK", chunk)
            up, sp = opt.update(g, sp, p, step)
        for a, b in zip(tree.leaves(up) + tree.leaves(sp),
                        tree.leaves(uw) + tree.leaves(sw)):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    assert len(list(topt._chunks(6, 5, 6, chunk))) > 1 or chunk == 60


def test_clip_schedule_and_int8_compression_match_the_reference(rng):
    g = _np_tree(rng)
    jc, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    tc, tn = topt.clip_by_global_norm(_port(g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _assert_tree(tc, jc, 1e-7)
    tg = _port(g)
    assert float(topt.clip_by_global_norm_(tg, 1.0)) == float(tn)
    for a, b in zip(tree.leaves(tg), tree.leaves(tc)):
        assert torch.equal(a, b)
    for base, warm, total in ((1.0, 10, 100), (3e-3, 10, 10), (0.5, 0, 5)):
        jl, tl = jopt.cosine_schedule(base, warm, total), \
            topt.cosine_schedule(base, warm, total)
        for s in (0, 3, 5, 10, 11, 50, 100, 120):
            np.testing.assert_allclose(float(tl(s)), float(jl(s)),
                                       rtol=1e-6, atol=1e-12)
    # int8 with error feedback: ties at .5 round half to even in both
    x = rng.normal(size=(64,)).astype(np.float32)
    x[:4] = [127.0, 0.5, 1.5, -2.5]
    r = rng.normal(size=(64,)).astype(np.float32) * 0.01
    r[:4] = 0.0
    jq, jscale = jtl._compress_int8(jnp.asarray(x + r))
    deq, res = compress_with_feedback(torch.from_numpy(x),
                                      torch.from_numpy(r))
    exp_deq = np.asarray(jtl._decompress_int8(jq, jscale))
    np.testing.assert_array_equal(deq.numpy(), exp_deq)
    np.testing.assert_array_equal(res.numpy(), (x + r) - exp_deq)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-base"])
def test_synthetic_stream_is_the_reference_stream(arch):
    jcfg = jget_config(arch).reduced()
    cfg = get_config(arch).reduced()
    js = jdata.synthetic_lm_batches(jcfg, 3, 12, seed=5)
    ts = synthetic_lm_batches(cfg, 3, 12, seed=5)
    for _ in range(3):
        jb, tb = next(js), next(ts)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    jp, jr = jdata.ShareGPTLike(seed=3).sample(100)
    tp, tr = ShareGPTLike(seed=3).sample(100)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tr, jr)


def _tiny(jax_side: bool):
    kw = dict(num_layers=2, d_ff=128, vocab_size=64)
    if jax_side:
        cfg = jget_config("granite-3-2b").reduced().replace(**kw)
        return cfg, jbuild_model(cfg)
    cfg = get_config("granite-3-2b").reduced().replace(**kw)
    return cfg, build_model(cfg, 1, None, "cpu")


def _same_leaves(jtree, ttree):
    flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    assert len(flat) == len(ckpt._flatten(ttree))
    for path, leaf in flat:
        key = "/".join(str(getattr(p, "key", getattr(p, "name",
                                                     getattr(p, "idx", p))))
                       for p in path)
        t = ckpt._flatten(ttree)[key].detach()
        a = np.asarray(leaf)
        assert a.dtype.name == ckpt._TORCH_NAMES[t.dtype], key
        got = (t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16
               else t.numpy())
        exp = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        np.testing.assert_array_equal(got, exp, err_msg=key)


def test_checkpoints_restore_across_packages(tmp_path):
    """A bf16 train state with Adafactor's nested state and a residual:
    JAX saves, the port restores; the port saves, JAX restores — bitwise."""
    jcfg, jm = _tiny(True)
    jo = jopt.adafactor()
    jstate = jtl.init_train_state(jm, jo, jax.random.PRNGKey(0),
                                  compression=True)
    jstate = jstate._replace(step=jnp.asarray(7, jnp.int32))
    assert jax.tree.leaves(jstate.params)[0].dtype == jnp.bfloat16
    jckpt.save_checkpoint(str(tmp_path / "jax"), 7, jstate)
    _, tm = _tiny(False)
    to = topt.adafactor()
    like = init_train_state(tm, to, torch.Generator().manual_seed(1),
                            compression=True)
    restored, step = ckpt.restore_checkpoint(str(tmp_path / "jax"), like)
    assert step == 7 and isinstance(restored, TrainState)
    _same_leaves(jstate, restored)
    assert all(p.requires_grad for p in tree.leaves(restored.params))
    # and back: the port writes, the reference reads
    ckpt.save_checkpoint(str(tmp_path / "port"), 9, restored)
    with open(tmp_path / "port" / "step_00000009" / "manifest.json") as f:
        assert f.read() == open(tmp_path / "jax" / "step_00000007" /
                                "manifest.json").read().replace(
                                    '"step": 7', '"step": 9')
    back, jstep = jckpt.restore_checkpoint(str(tmp_path / "port"), jstate)
    assert jstep == 9
    _same_leaves(back, restored)


def test_launcher_trains_checkpoints_and_resumes_on_the_cpu(tmp_path,
                                                            capsys):
    """``--device cpu`` (reduced, plain versions): trains, checkpoints at
    step 20, resumes from it; the default device needs a card."""
    args = ["--device", "cpu", "--arch", "deepseek-r1", "--steps", "21",
            "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    hist = launch_train.run(launch_train.parser().parse_args(args))
    assert [h["step"] for h in hist] == [0, 10, 20]
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert ckpt.latest_step(str(tmp_path)) == 20
    hist2 = launch_train.run(launch_train.parser().parse_args(
        args[:5] + ["22"] + args[6:] + ["--resume"]))
    assert "resumed at step 20" in capsys.readouterr().out
    assert [h["step"] for h in hist2] == [20, 21]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            launch_train.main(["--steps", "1"])


# ---- the reference's tests/test_training_and_checkpoint.py, on the port

def _tiny_port():
    cfg, model = _tiny(False)
    return cfg, model


@pytest.mark.parametrize("make_opt", [lambda: topt.adamw(lr=3e-3),
                                      lambda: topt.adafactor(lr=3e-2)],
                         ids=["adamw", "adafactor"])
def test_training_reduces_loss(make_opt):
    cfg, model = _tiny_port()
    ctx = TrainCtx(remat=False, ce_chunk=16)
    data = synthetic_lm_batches(cfg, batch=8, seq=32, seed=0)
    opt = make_opt()
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    step = make_train_step(model, opt, ctx)
    losses = []
    for _ in range(30):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses[::6]


def test_compressed_gradients_still_train():
    cfg, model = _tiny_port()
    ctx = TrainCtx(remat=False, ce_chunk=16)
    data = synthetic_lm_batches(cfg, batch=8, seq=32, seed=0)
    opt = topt.adamw(lr=3e-3)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0),
                             compression=True)
    step = make_train_step(model, opt, ctx, compression=True)
    losses = []
    for _ in range(30):
        state, m = step(state, next(data))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.9, losses[::6]
    assert any(float(r.abs().max()) > 0
               for r in tree.leaves(state.ef_residual))


def test_clip_and_schedule():
    g = {"a": torch.ones(4) * 100.0}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(
        1.0, rel=1e-4)
    lr = topt.cosine_schedule(1.0, warmup=10, total=100)
    assert float(lr(5)) == pytest.approx(0.5)
    assert float(lr(10)) == pytest.approx(1.0, rel=1e-2)
    assert float(lr(100)) == pytest.approx(0.0, abs=1e-6)


def test_sharegpt_like_distribution():
    p, r = ShareGPTLike(seed=0).sample(2000)
    assert r.max() <= 768 and p.max() <= 4096       # the paper's caps
    assert 50 < np.median(p) < 1000


def test_checkpoint_roundtrip(tmp_path):
    cfg, model = _tiny_port()
    state = init_train_state(model, topt.adamw(lr=1e-3),
                             torch.Generator().manual_seed(0))
    path = ckpt.save_checkpoint(str(tmp_path), 7, state.params)
    assert os.path.basename(path) == "step_00000007"
    restored, step = ckpt.restore_checkpoint(str(tmp_path), state.params)
    assert step == 7
    for a, b in zip(tree.leaves(state.params), tree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_gc_and_latest(tmp_path):
    t = {"w": np.arange(4.0)}
    for s in (1, 2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), s, t, keep=2)
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    ckpt._gc(str(tmp_path), 1)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004"]


def test_async_checkpointer(tmp_path):
    t = {"w": torch.arange(8.0)}
    ac = ckpt.AsyncCheckpointer(str(tmp_path))
    ac.save(1, t)
    t["w"].mul_(2)                            # after the snapshot
    ac.save(2, {"w": torch.arange(8.0) * 3})  # waits for 1 internally
    ac.wait()
    restored, step = ckpt.restore_checkpoint(str(tmp_path), t)
    assert step == 2
    assert torch.equal(restored["w"], torch.arange(8.0) * 3)
    first, _ = ckpt.restore_checkpoint(str(tmp_path), t, step=1)
    assert torch.equal(first["w"], torch.arange(8.0))


def test_restart_resumes_training(tmp_path):
    """Kill-and-restore mid-run reproduces the state."""
    cfg, model = _tiny_port()
    ctx = TrainCtx(remat=False, ce_chunk=16)
    opt = topt.adamw(lr=3e-3)
    data = synthetic_lm_batches(cfg, batch=4, seq=32, seed=1)
    batches = [next(data) for _ in range(8)]
    step = make_train_step(model, opt, ctx)
    state = init_train_state(model, opt, torch.Generator().manual_seed(0))
    for b in batches[:4]:
        state, _ = step(state, b)
    ckpt.save_checkpoint(str(tmp_path), 4, state)
    for b in batches[4:]:
        state, m_final = step(state, b)
    fresh = init_train_state(model, opt, torch.Generator().manual_seed(9))
    restored, s = ckpt.restore_checkpoint(str(tmp_path), fresh)
    assert s == 4 and int(restored.step) == 4
    for b in batches[4:]:
        restored, m2_final = step(restored, b)
    assert float(m2_final["loss"]) == float(m_final["loss"])
    for a, b in zip(tree.leaves(state.params), tree.leaves(restored.params)):
        assert torch.equal(a, b)
