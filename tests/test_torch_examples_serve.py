"""``repro_torch.examples.serve_moe`` against ``examples/serve_moe.py``
(loaded from its path, unedited), float32, at ``--requests 4`` (the
verify skill's recipe) and at ``--requests 4 --kv-mode paged --kv-blocks
16`` (a pool small enough to preempt), each cluster on the JAX cluster's
params.  (The script's docstring suggests ``--kv-blocks 13``: there both
packages' schedulers preempt every step and complete nothing in the
4000-step budget, so the script's own assert fails in both.)

Lockstep serving runs under the wall clock, so the lines that print wall
times are excepted: the ``[t=...s]`` chaos lines (their text after the
time is held), and the summary's ``wall_time_s``, ``decode_tok_per_s``,
``itl`` and ``ttft``.  Every other line (requests, completed, failed,
output tokens, routing, per-client counts, the balance line but its
``migration_time_s``, halted steps, the kv-pool lines) is equal, and so are each request's greedy tokens, each client's
dropped / miss counters, and the step at which each chaos event fired.
"""

import ast
import re

import pytest

from repro.serving import Request as JRequest
from torch_examples_cases import (fp32, inject, jax_params, lines,
                                  load_example, one_thread, port_example,
                                  record, tokens)

_one_torch_thread = pytest.fixture(scope="module", autouse=True)(one_thread)

WALL = ("wall_time_s", "decode_tok_per_s", "itl", "ttft")
MIGRATION = re.compile(r"'migration_time_s': [0-9.e-]+")
CHAOS = re.compile(r"^\[t=\d+\.\d+s\] ")


def _held(out):
    """The lines with their wall-clock parts taken out."""
    held = []
    for ln in out:
        if CHAOS.match(ln):
            held.append(CHAOS.sub("[t=*] ", ln))
        elif any(ln.startswith(f"  {k}: ") for k in WALL):
            held.append(ln.split(":")[0])
        elif ln.startswith("  balance: "):
            held.append(MIGRATION.sub("'migration_time_s': *", ln))
        else:
            held.append(ln)
    return held


@pytest.mark.parametrize("argv", [
    ["--requests", "4"],
    ["--requests", "4", "--kv-mode", "paged", "--kv-blocks", "16"]],
    ids=["dense", "paged"])
def test_serve_moe_matches_the_jax_tour(monkeypatch, capsys, argv):
    jmod, tmod = load_example("serve_moe"), port_example("serve_moe")
    fp32(monkeypatch, jmod)
    fp32(monkeypatch, tmod)
    jcl = record(monkeypatch, jmod, "Cluster", keep=jax_params)
    jreq = record(monkeypatch, jmod, "Request")
    monkeypatch.setattr("sys.argv", ["serve_moe.py", *argv])
    jmod.main()
    jout = lines(capsys.readouterr().out)
    assert all(isinstance(r, JRequest) for r in jreq)

    tcl = inject(monkeypatch, tmod, "Cluster", jcl.kept)
    res = tmod.main(["--device", "cpu", *argv])
    tout = lines(capsys.readouterr().out)

    assert _held(tout) == _held(jout)
    assert tokens(res["requests"]) == tokens(jreq)
    assert all(r.output_tokens for r in res["requests"])
    jm, tm = jcl[0].metrics, res["metrics"]
    assert tm.completed == jm.completed == 4 - jm.failed_requests
    for tc, jc in zip(tcl[0].clients, jcl[0].clients):
        tt = [(t.get("dropped"), t.get("miss"), t.get("halted"))
              for t in tc.metrics.timeline]
        jt = [(t.get("dropped"), t.get("miss"), t.get("halted"))
              for t in jc.metrics.timeline]
        assert tt == jt
    summary = {ln.split(": ")[0].strip(): ln.split(": ", 1)[1]
               for ln in tout if ln.startswith("  ") and ": " in ln}
    assert ast.literal_eval(summary["completed"]) == 4
    if "--kv-mode" in argv:
        assert any(ln.startswith("  client 0 kv pool: 15 blocks x 8")
                   for ln in tout)
        assert tcl[0].clients[0].metrics.preemptions > 0
