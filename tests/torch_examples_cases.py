"""Shared machinery of the ``test_torch_examples_*`` files: each runs a
JAX tour from ``examples/`` (loaded from its path, not edited) and the
port's ``repro_torch.examples`` counterpart on the same weights.

* :func:`load_example` imports a script of ``examples/`` as a module;
* :func:`fp32` patches a tour module's ``get_config`` so that
  ``get_config(arch).reduced()`` is the reduced config with float32
  parameters (both packages' greedy tokens are then the same function);
* :func:`record` wraps a name of a tour module (an engine or cluster
  class, ``Scenario``, ``Request``) so every object the tour makes is kept;
* :func:`inject` wraps the port tour's engine or cluster class so the
  n-th one it builds gets the n-th JAX engine's params, bridged;
* :func:`run_tours` runs a JAX tour (in a thread) and the port's at
  once, each port engine waiting for its JAX counterpart's params.
"""

import importlib.util
import io
import pathlib
import queue
import sys
import threading

import numpy as np
import torch

from repro_torch.bridge import params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parents[1]


def load_example(name: str):
    """``examples/<name>.py`` as a fresh module (``main`` not run)."""
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name: str):
    return importlib.import_module(f"repro_torch.examples.{name}")


class _Float32:
    def __init__(self, cfg):
        self._cfg = cfg

    def reduced(self):
        return self._cfg.reduced().replace(dtype="float32")


def fp32(monkeypatch, mod) -> None:
    real = mod.get_config
    monkeypatch.setattr(mod, "get_config", lambda arch: _Float32(real(arch)))


def record(monkeypatch, mod, name: str, keep=None) -> list:
    """Every object ``mod.<name>(...)`` makes, in order; ``keep(obj)`` of
    each as it is made under ``made.kept`` (an engine's params before the
    tour migrates or resizes them); for ``Scenario`` the results of its
    runs, under ``made.runs``."""
    made = _Made()
    cls = getattr(mod, name)
    if hasattr(cls, "run") and name == "Scenario":
        class Recorded(cls):
            def run(self, *a, **kw):
                res = super().run(*a, **kw)
                made.runs.append(res)
                return res

        def make(*a, **kw):
            obj = Recorded(*a, **kw)
            made.append(obj)
            return obj
    else:
        def make(*a, **kw):
            obj = cls(*a, **kw)
            made.append(obj)
            if keep is not None:
                made.kept.append(keep(obj))
            return obj
    monkeypatch.setattr(mod, name, make)
    return made


class _Made(list):
    def __init__(self):
        super().__init__()
        self.runs = []
        self.kept = []


def jax_params(obj):
    """The numpy params tree of a JAX engine or cluster."""
    import jax
    params = obj.clients[0].params if hasattr(obj, "clients") else obj.params
    return jax.tree.map(np.asarray, params)


def inject(monkeypatch, mod, name: str, trees: list) -> list:
    """``mod.<name>`` (a port engine or cluster class) takes the next tree
    of ``trees`` as its params, bridged onto the CPU; returns the objects
    made."""
    cls, made = getattr(mod, name), []
    trees = list(trees)

    def make(cfg, *a, **kw):
        if kw.get("params") is None:
            kw["params"] = params_from_numpy(trees.pop(0), cfg, "cpu")
        obj = cls(cfg, *a, **kw)
        made.append(obj)
        return obj

    monkeypatch.setattr(mod, name, make)
    return made


def tokens(requests) -> dict:
    return {r.request_id: tuple(r.output_tokens) for r in requests}


def one_thread():
    """Thousands of tiny ops: one intra-op thread spares them a pool's
    spin-waits when test workers share the cores (restored after)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lines(out: str) -> list:
    return out.rstrip("\n").split("\n")


class _PerThreadOut:
    """``sys.stdout`` for two tours printing at once: each thread's writes
    go to its own buffer."""

    def __init__(self):
        self._bufs = {}

    def write(self, text):
        buf = self._bufs.setdefault(threading.get_ident(), io.StringIO())
        return buf.write(text)

    def flush(self):
        pass

    def lines(self, ident):
        return lines(self._bufs.get(ident, io.StringIO()).getvalue())


def run_tours(monkeypatch, name: str, builders, argv=()):
    """Run the JAX tour ``name`` and the port's on the JAX engines' params,
    both with float32 configs.  ``builders`` names the engine and cluster
    classes the tours build: the JAX tour runs in a thread, each of its
    engines handing its params (snapshotted as it is built) to the port's
    engine built in the same order, so both tours run at once.  Returns a
    namespace: the printed lines (``jout`` / ``tout``), the JAX and port
    objects per builder (``jmade`` / ``tmade``), the scenario results in
    run order (``jruns`` / ``truns``) and the port tour's return value
    (``res``)."""
    import types
    jmod, tmod = load_example(name), port_example(name)
    fp32(monkeypatch, jmod)
    fp32(monkeypatch, tmod)
    handed = {b: queue.Queue() for b in builders}
    jmade = {}
    for b in builders:
        jmade[b] = record(monkeypatch, jmod, b, keep=jax_params)
        cls = getattr(jmod, b)

        def handing(*a, _cls=cls, _q=handed[b], _made=jmade[b], **kw):
            obj = _cls(*a, **kw)
            _q.put(_made.kept[-1])
            return obj
        monkeypatch.setattr(jmod, b, handing)
    jsc = record(monkeypatch, jmod, "Scenario") \
        if hasattr(jmod, "Scenario") else None
    monkeypatch.setattr("sys.argv", [f"{name}.py", *argv])
    out = _PerThreadOut()
    monkeypatch.setattr(sys, "stdout", out)
    failure = []

    def run_jax():
        try:
            jmod.main()
        except BaseException as e:           # re-raised below
            failure.append(e)
            for q in handed.values():
                q.put(None)

    jthread = threading.Thread(target=run_jax)
    jthread.start()
    tmade = {}
    for b in builders:
        cls, made = getattr(tmod, b), tmade.setdefault(b, [])

        def make(cfg, *a, _cls=cls, _q=handed[b], _made=made, **kw):
            if kw.get("params") is None:
                tree = _q.get(timeout=600)
                if tree is None:
                    raise RuntimeError("the JAX tour failed")
                kw["params"] = params_from_numpy(tree, cfg, "cpu")
            obj = _cls(cfg, *a, **kw)
            _made.append(obj)
            return obj
        monkeypatch.setattr(tmod, b, make)
    tsc = record(monkeypatch, tmod, "Scenario") \
        if hasattr(tmod, "Scenario") else None
    try:
        res = tmod.main(["--device", "cpu", *argv])
    finally:
        jthread.join()
    if failure:
        raise failure[0]
    return types.SimpleNamespace(
        jout=out.lines(jthread.ident), tout=out.lines(threading.get_ident()),
        jmade=jmade, tmade=tmade, res=res,
        jruns=jsc.runs if jsc is not None else [],
        truns=tsc.runs if tsc is not None else [])


def assert_same_runs(r) -> None:
    """Every printed line equal; per scenario run, the greedy tokens, the
    completed / total counts and the metrics fingerprint (every request's
    virtual times, the timeline, the controller and autoscaler events)
    equal."""
    assert r.tout == r.jout
    assert len(r.truns) == len(r.jruns) > 0
    for t, j in zip(r.truns, r.jruns):
        assert tokens(t.requests) == tokens(j.requests)
        assert t.metrics.completed == j.metrics.completed
        assert t.metrics.fingerprint() == j.metrics.fingerprint()
        assert t.summary() == j.summary()
