"""The layer tours and the tours' command lines against the JAX scripts of
``examples/`` (loaded from their paths, unedited).

* ``quickstart``: the JAX script runs as it is; its jitted calls are
  recorded (params, batch, outputs) through a stand-in for the script's
  ``jax`` whose ``jit`` wraps ``jax.jit``.  The port's tour runs on the
  same params and batch.  Float32: every printed line equal, the three
  layer outputs within 1e-5.  Bfloat16 (the config as shipped): both
  tours take the JAX script's own float32 batch, unrounded, and promote
  it against the bfloat16 weights (float32 products, the grouped GEMM's
  widening route): every line equal, the outputs within 1e-5.
* ``disaggregated_serving``: the port's tour on the JAX cluster's bank and
  router; the outputs of all four layer calls within 1e-5 in both dtypes
  (bfloat16: the float32 payload promoted against the weights, as in
  quickstart); every line equal but the failover delta's (excepted: the
  reference prints ~2e-8 there, the port 0; both far under the tour's
  bound).
* The port parses ``serve_moe``'s and ``train_small``'s flags as the JAX
  scripts do (every option's default, type, choices and help, and the
  namespaces of sample command lines), plus only ``--device``; the other
  tours take only ``--device``, as the JAX scripts take no flags.
* On ``--device cuda`` (the default) without a card every tour raises
  before it builds anything.
"""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_numpy, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.serving.step_graphs import CompiledFn
from torch_examples_cases import (fp32, lines, load_example, one_thread,
                                  port_example)

TOURS = ("quickstart", "disaggregated_serving", "serve_moe",
         "scenario_prefix_cache", "scenario_overlap_ablation",
         "scenario_expert_balance", "scenario_cluster_failover",
         "scenario_autoscale", "train_small")

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_thread)


def _recording_jax(calls):
    """A stand-in for the script's ``jax``: ``jit`` records each call's
    arguments (as numpy, before the script mutates its params dict) and
    outputs."""
    def jit(f):
        g = jax.jit(f)

        def call(p, x, *rest):
            out = g(p, x, *rest)
            calls.append((jax.tree.map(np.asarray, p), np.asarray(x),
                          jax.tree.map(np.asarray, out)))
            return out
        return call
    return types.SimpleNamespace(jit=jit, random=jax.random)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-5)])
def test_quickstart_matches_the_jax_tour(monkeypatch, capsys, dtype, tol):
    jmod, tmod = load_example("quickstart"), port_example("quickstart")
    if dtype == "float32":
        fp32(monkeypatch, jmod)
    calls = []
    monkeypatch.setattr(jmod, "jax", _recording_jax(calls))
    jmod.main()
    jout = lines(capsys.readouterr().out)
    assert len(calls) == 3                 # fn, fn2 healthy, fn2 failover

    cfg = get_config("kimi-k2-1t-a32b").reduced().replace(dtype=dtype)
    params0, x, _ = calls[0]
    params = params_from_numpy(params0, None, "cpu")
    res = tmod.tour(cfg, torch.device("cpu"), params=params,
                    x=torch.from_numpy(np.array(x)))
    tout = lines(capsys.readouterr().out)

    assert len(tout) == len(jout)
    for i, (a, b) in enumerate(zip(tout, jout)):
        assert a == b, (i, a, b)
    assert any(ln.startswith("server 2 killed") for ln in tout)
    for got, (_, _, (want, stats)) in zip(
            (res["y"], res["y_healthy"], res["y_failover"]), calls):
        got = got.float().numpy()
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=0)
        assert got.shape == want.shape
    assert int(res["failover_stats"].miss) == int(calls[2][2][1].miss)
    assert res["err"] < 1e-3
    # on the CPU nothing is captured: the programs run eagerly
    assert res["fn"].captures == res["fn2"].captures == 0


class _Experts:
    """``get_config(arch).reduced()`` in float32 with ``num_experts`` /
    ``top_k`` replaced."""

    def __init__(self, real, **moe):
        self._real, self._moe = real, moe

    def __call__(self, arch):
        return self

    def reduced(self):
        cfg = self._real("kimi-k2-1t-a32b").reduced()
        return cfg.replace(dtype="float32", moe=dataclasses.replace(
            cfg.moe, **self._moe))


def test_quickstart_fails_alike_past_the_planners_window(monkeypatch,
                                                         capsys):
    """With 64 experts top-8 (reduced widths) the reference's planner
    replicates only its 32-expert candidate window, so server 2's other
    experts lose their one home: both tours' failover calls miss alike
    and both fail the tour's assert, after the same printed lines."""
    jmod, tmod = load_example("quickstart"), port_example("quickstart")
    monkeypatch.setattr(jmod, "get_config", _Experts(
        jmod.get_config, num_experts=64, top_k=8))
    calls = []
    monkeypatch.setattr(jmod, "jax", _recording_jax(calls))
    with pytest.raises(AssertionError):
        jmod.main()
    jout = lines(capsys.readouterr().out)
    cfg = _Experts(get_config, num_experts=64, top_k=8).reduced()
    params0, x, _ = calls[0]
    with pytest.raises(AssertionError):
        tmod.tour(cfg, torch.device("cpu"),
                  params=params_from_numpy(params0, None, "cpu"),
                  x=torch.from_numpy(np.array(x)))
    tout = lines(capsys.readouterr().out)
    assert tout == jout
    assert "miss=0" not in jout[-1] and "killed" in jout[-1]


def test_quickstart_failover_is_data(monkeypatch, capsys):
    """The port's failover call reads the liveness mask from the static
    buffer the healthy call filled: the same buffers (none reallocated),
    the mask rewritten in place, the mapping unchanged."""
    tmod = port_example("quickstart")
    seen = []

    class Spy(CompiledFn):
        def __call__(self, *a):
            out = super().__call__(*a)
            seen.append((self, [(b.data_ptr(), b.clone())
                                for b in self._data.values()]))
            return out

    monkeypatch.setattr(tmod, "compile_fn", Spy)
    cfg = get_config("kimi-k2-1t-a32b").reduced().replace(dtype="float32")
    res = tmod.tour(cfg, torch.device("cpu"))
    capsys.readouterr()
    assert len(seen) == 3
    (_, first), (fn2, healthy), (fn2b, failover) = seen
    assert fn2 is fn2b and fn2 is not seen[0][0]
    assert [p for p, _ in healthy] == [p for p, _ in failover]
    (_, x_h), (_, map_h), (_, alive_h) = healthy
    (_, x_f), (_, map_f), (_, alive_f) = failover
    assert alive_h.tolist() == [True] * 4
    assert alive_f.tolist() == [True, True, False, True]
    assert torch.equal(map_h, map_f) and torch.equal(x_h, x_f)
    assert not torch.equal(map_h, first[1][1][:, :map_h.shape[1]]) or \
        map_h.shape != first[1][1].shape
    assert res["failover_captures"] == 0 and res["err"] < 1e-3


def _numpy_bank(bank):
    return {k: np.asarray(v) for k, v in bank.items()}


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-5)])
def test_disaggregated_matches_the_jax_tour(monkeypatch, capsys, dtype,
                                            tol):
    jmod = load_example("disaggregated_serving")
    tmod = port_example("disaggregated_serving")
    if dtype == "float32":
        fp32(monkeypatch, jmod)
        fp32(monkeypatch, tmod)
    built, outs = [], []
    real = jmod.build_cluster

    def jbuild(*a, **kw):
        clients, servers, smap, bank = real(*a, **kw)
        for c in clients:
            layer = c.moe_layer

            def rec(x, drive, layer=layer):
                y = layer(x, drive)
                outs.append(np.asarray(y, np.float32))
                return y
            c.moe_layer = rec
        built.append((clients, servers, smap, bank))
        return clients, servers, smap, bank

    monkeypatch.setattr(jmod, "build_cluster", jbuild)
    jmod.main()
    jout = lines(capsys.readouterr().out)

    jclients, jservers, _, jbank = built[0]
    bank = {k: tensor_from_numpy(v, "cpu")
            for k, v in _numpy_bank(jbank).items()}
    router_w = tensor_from_numpy(np.asarray(jclients[0].router_w), "cpu")
    treal = tmod.build_cluster
    monkeypatch.setattr(tmod, "build_cluster", lambda *a, **kw: treal(
        *a, bank=bank, router_w=router_w, **kw))
    res = tmod.main(["--device", "cpu"])
    tout = lines(capsys.readouterr().out)

    assert len(tout) == len(jout)
    for a, b in zip(tout, jout):
        if not b.startswith("output delta after failover"):
            assert a == b, (a, b)
    got = [res[k] for k in ("y0_healthy", "y1_healthy", "y0_failover",
                            "y0_back")]
    assert len(outs) == 4
    for g, w in zip(got, outs):
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0)
    assert [s.batches for s in res["servers"]] == \
        [s.batches for s in jservers]
    assert [s.served_tokens for s in res["servers"]] == \
        [s.served_tokens for s in jservers]
    assert [c.retries for c in res["clients"]] == \
        [c.retries for c in jclients]
    assert res["y0_healthy"].dtype == torch.float32


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch, name):
    """The parser the JAX script's ``main`` builds, caught at its
    ``parse_args``."""
    import argparse
    jmod = load_example(name)
    caught = []

    def parse_args(self, *a, **kw):
        caught.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", parse_args)
        with pytest.raises(_Parsed):
            jmod.main()
    return caught[0]


def _options(ap):
    return {a.option_strings[0]: a for a in ap._actions
            if a.option_strings and a.dest != "help"}


SAMPLES = {
    "serve_moe": ([], ["--requests", "4"],
                  ["--clients", "4", "--frontend-policy", "least_loaded",
                   "--fail-client", "1", "--kv-mode", "paged",
                   "--kv-blocks", "13"],
                  ["--exec-mode", "async", "--async-depth", "4",
                   "--mode", "monolithic_ep"],
                  ["--clients", "2", "--elastic"]),
    "train_small": ([], ["--full"], ["--steps", "7", "--restore"],
                    ["--compress-grads", "--steps", "3"]),
}


@pytest.mark.parametrize("name", list(SAMPLES))
def test_flags_parse_as_the_jax_script(monkeypatch, name):
    jap = _jax_parser(monkeypatch, name)
    tap = port_example(name).parser()
    jopts, topts = _options(jap), _options(tap)
    assert set(topts) == set(jopts) | {"--device"}
    for opt, ja in jopts.items():
        ta = topts[opt]
        for attr in ("dest", "default", "type", "choices", "nargs", "const",
                     "required", "help"):
            assert getattr(ta, attr) == getattr(ja, attr), (opt, attr)
        assert type(ta) is type(ja), opt
    assert topts["--device"].default == "cuda"
    for argv in SAMPLES[name]:
        want = vars(jap.parse_args(argv))
        got = vars(tap.parse_args(argv + ["--device", "cpu"]))
        assert got.pop("device") == "cpu"
        assert got == want, argv


@pytest.mark.parametrize("name", [t for t in TOURS if t not in SAMPLES])
def test_flagless_tours_take_only_the_device(name):
    src = (load_example(name).__file__)
    assert "argparse" not in open(src).read()   # the JAX script has none
    tap = port_example(name).parser()
    assert list(_options(tap)) == ["--device"]
    assert tap.parse_args([]).device == "cuda"
    with pytest.raises(SystemExit):
        tap.parse_args(["--device", "tpu"])


@pytest.mark.parametrize("name", TOURS)
def test_tours_refuse_the_card_without_one(monkeypatch, name):
    """No fallback: on ``--device cuda`` (the default) with no card the
    tour raises before it builds an engine or draws a weight."""
    mod = port_example(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    built = []
    for attr in ("ServingEngine", "Cluster", "build_cluster", "build_model",
                 "init_inputs"):
        if hasattr(mod, attr):
            monkeypatch.setattr(mod, attr,
                                lambda *a, **kw: built.append(a))
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main([])
    assert built == []
