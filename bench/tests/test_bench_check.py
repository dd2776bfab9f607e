"""``correct`` holds a sound run and fails a broken one: the whole run at
small sizes on the CPU, once sound (each cell) and once with the timed
path broken underneath (each fault a serving cell can have), and the
control, the reference in float8 put in the program's place."""

import json
from pathlib import Path

import pytest
import torch

import small
from harness import check, drive, faults, runner, traffic
from reference.moe_decoder import fp8_cast

ROOT = Path(__file__).resolve().parents[2]
WORKLOADS = [w["name"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    res, notes = small.run(workload)
    assert res["correct"], res["compared"]
    assert res["failed"] == 0 and res["compared"]["compared_tokens"][0] > 0
    assert notes["captures_in_window"] == 0


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "no_exchange", "token_altered",
                                   "argmax_sampler"])
def test_fault_is_not_correct(fault, monkeypatch):
    """Each fault read not correct.  (``temperature_ignored`` moves the
    small model's near-flat distributions too little to show in a few
    dozen tokens; :func:`test_sampled_tokens_are_judged_by_their_
    distribution` holds the number it moves.)"""
    res, _ = small.run("dsr1-chat", plant=lambda cell:
                       faults.ALL[fault](cell, monkeypatch.setattr))
    assert not res["correct"], res["compared"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_reads_apart_from_the_program(workload):
    """At the small size, over three seeds: the float8 control, put in the
    program's place through the run's own readings, reads a mean gap
    three times the program's or more.  (Its verdict under the cell's
    limits file is read on the card at the cell's size, by
    ``bench/tools/control.py``: the limits hold at that size, and the
    small model's gaps are of another scale.)"""
    config, mix = small.sizes(workload)
    # every request greedy (the ones compared), a few dozen tokens each
    mix.update(greedy_share=1.0)
    mix["output"].update(min=24, max=32)
    lim = check.load_limits(ROOT, workload)
    m = config["model"]
    cell = runner.Cell(config, mix, 4.0, 1, "cpu")
    cell.warm_shapes()
    prog, ctl = [], []
    for seed in (11, 12, 13):
        cell.reset()
        cell.reseed(seed)
        items = traffic.schedule(mix, 4.0, seed, m["vocab_size"])
        ws, we = cell.serve(items, mix["warm_s"], 4.0)
        gs, _ = check.draw_samples(cell.driver, ws, we, lim, seed)
        args = (cell.params, m, check.served(cell.driver, gs), [], [],
                "cpu", config)
        prog += check.readings(*args)[0]
        ctl += check.readings(*args, cast=fp8_cast, seed=seed)[0]
    p, c = check.summary(prog), check.summary(ctl)
    assert p["tokens"] >= 200
    assert c["gap_mean"] >= 3 * p["gap_mean"] and c["gap_mean"] > 0, (p, c)


def test_sampled_tokens_are_judged_by_their_distribution():
    """Draws from the reference's own distribution read a standard
    normal's size; the argmax, or draws at temperature 1 for 0.7, read
    far above it."""
    g = torch.Generator().manual_seed(5)
    logits = 2.0 * torch.randn(600, 512, generator=g)
    T = 0.7
    p = torch.softmax(logits / T, -1)
    fair = torch.multinomial(p, 1, generator=g)[:, 0]
    hot = torch.multinomial(torch.softmax(logits, -1), 1, generator=g)[:, 0]
    z = {name: check.summary([], [check._draw(logits, t, T)])
         ["sample_z_abs"]
         for name, t in (("fair", fair), ("argmax", logits.argmax(-1)),
                         ("hot", hot))}
    assert z["fair"] < 3.0 and z["argmax"] > 20.0 and z["hot"] > 8.0, z


def test_open_gap_and_due_time_count():
    """The tails count what users wait for: TTFT from the due time, a
    request with no first token by the window's end at its wait so far,
    and a request still decoding adds its open gap."""
    tr = {1: drive.Track(due=1.0, prompt_len=4, times=[1.5, 1.6, 1.9]),
          2: drive.Track(due=2.0, prompt_len=4, times=[]),
          3: drive.Track(due=0.5, prompt_len=4, times=[0.8, 1.2, 1.4],
                         done=True)}
    ws, we = 1.0, 3.0
    assert sorted(drive.ttfts(tr, ws, we)) == pytest.approx([0.5, 1.0])
    assert sorted(drive.itls(tr, ws, we)) == pytest.approx(
        [0.1, 0.2, 0.3, 0.4, 1.1])
    assert drive.output_tokens(tr, ws, we) == 5
