"""The harness is driven by data: a traffic mix, a configuration and a
per-layer metric are files found by the names in ``BENCHMARK.json``, the
schedule follows the seed, the FLOP count follows the shapes, and the
frozen copies of the program's generator and percentiles still give
their sources' numbers."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from harness import flops, frozen, runner, traffic

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
WORKLOADS = [w["name"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_same_seed_same_schedule(workload):
    _, _, config, mix = runner.load_cell(ROOT, workload)
    V = config["model"]["vocab_size"]
    a = traffic.schedule(mix, 10.0, 2 ** 31 + 17, V)
    b = traffic.schedule(mix, 10.0, 2 ** 31 + 17, V)
    c = traffic.schedule(mix, 10.0, 99, V)
    assert len(a) == len(b) == len(c) > 0
    for x, y in zip(a, b):
        assert (x.due, x.max_new, x.temperature) == \
            (y.due, y.max_new, y.temperature)
        assert np.array_equal(x.prompt, y.prompt)
    # another seed: the same arrivals and sizes in the same order, other
    # tokens
    assert [(x.due, len(x.prompt), x.max_new, x.temperature) for x in a] \
        == [(x.due, len(x.prompt), x.max_new, x.temperature) for x in c]
    assert not all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, c))
    # a sampled mix spreads its greedy requests over the arrivals
    if mix.get("temperature", 0.0) > 0.0:
        g = [x.temperature == 0.0 for x in a]
        half = len(g) // 2
        assert 0 < sum(g[:half]) and 0 < sum(g[half:])
    p, o = mix["prompt"], mix["output"]
    assert all(p["min"] <= len(x.prompt) <= p["max"] for x in a)
    assert all(o["min"] <= x.max_new <= o["max"] for x in a)
    assert all(0 <= x.prompt.min() and x.prompt.max() < V for x in a)


def _copy(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_new_cell_found_by_its_files(tmp_path):
    """A traffic mix, its cell's limits, a per-layer and an end-to-end
    metric added as files and entries: nothing else edited."""
    root = _copy(tmp_path)
    mix = json.loads((BENCH / "traffic" / "dsr1-chat.json").read_text())
    mix.update(rate_rps=1.5, shape_seed=5)
    mix["prompt"].update(median=100, min=64, max=128)
    (root / "bench" / "traffic" / "trickle.json").write_text(
        json.dumps(mix))
    (root / "bench" / "limits" / "dsr1-trickle.json").write_text(
        (BENCH / "limits" / "dsr1-chat.json").read_text())
    (root / "bench" / "layer_metrics" / "steps_seen.py").write_text(
        "def read(run):\n    return float(len(run['steps'])) or None\n")
    (root / "bench" / "end_to_end" / "ttft_p50_ms.py").write_text(
        "def read(run):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"].append({"name": "ttft_p50_ms", "unit": "ms",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["dsr1-trickle"]})
    bench["workloads"].append({"name": "dsr1-trickle", "config": "dsr1-3l",
                               "traffic": "trickle", "chips": 1,
                               "why": "a test's cell"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "scheduler",
                               "moves": "output_tok_s",
                               "workloads": ["dsr1-trickle"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _, cell, config, got = runner.load_cell(root, "dsr1-trickle")
    assert got == mix and config["port_arch"] == "deepseek-r1"
    items = traffic.schedule(got, 20.0, 3, config["model"]["vocab_size"])
    assert 10 < len(items) < 60
    assert all(64 <= len(i.prompt) <= 128 for i in items)
    rd = runner.readers(root, ["steps_seen"])["steps_seen"]
    assert rd.read({"steps": [1, 2, 3]}) == 3.0
    e2e = runner.readers(root, ["ttft_p50_ms"], "end_to_end")
    assert e2e["ttft_p50_ms"].read({}) == 1.0
    from harness import check
    assert check.load_limits(root, "dsr1-trickle")["sample"] > 0


def test_every_name_has_its_file():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert (BENCH / "layer_metrics" / f"{m['name']}.py").is_file()
    for m in bench["end_to_end"]:
        assert (BENCH / "end_to_end" / f"{m['name']}.py").is_file()


def test_flops_one_layer_by_hand():
    """One MoE layer of DeepSeek-R1 as the port runs it, counted by hand:
    q (7168 x 128 x 64), k and v (7168 x 8 x 64), o (128 x 64 x 7168), the
    router (7168 x 256), 8 routed and 1 shared expert (3 x 7168 x 2048
    each)."""
    _, _, config, _ = runner.load_cell(ROOT, "dsr1-chat")
    m = dict(config["model"])
    attn = 7168 * 8192 + 2 * 7168 * 512 + 8192 * 7168
    moe = 7168 * 256 + 9 * 3 * 7168 * 2048
    assert flops.layer_params(m, dense=False) == attn + moe
    assert flops.layer_params(m, dense=True) == attn + 3 * 7168 * 18432
    # a token at context 100 through 1 dense and 2 MoE layers and the head
    ctx = 4 * 100 * 128 * 64 * 3
    want = 2.0 * (attn + 3 * 7168 * 18432 + 2 * (attn + moe)
                  + 7168 * 129280) + ctx
    assert flops.token_flops(m, 100, head=True) == want
    # a chunk: its tokens' parameters and attention over 1 + ... + n
    # positions past the start; the last token's logits
    n, start = 5, 10
    per_tok = flops.token_flops(m, 0, head=False)
    attn_ctx = sum(start + i + 1 for i in range(n))
    assert flops.chunk_flops(m, start, n, head=True) == (
        n * per_tok + 4 * attn_ctx * 128 * 64 * 3 + 2.0 * 7168 * 129280)


def test_frozen_copies_match_their_sources():
    from repro_torch.serving import metrics, scenario
    rate = lambda t: 3.0 + 2.0 * np.sin(t)  # noqa: E731
    for rate_max in (None, 5.0):
        a = frozen.sample_arrival_times(rate, 40.0,
                                        np.random.default_rng(35),
                                        rate_max=rate_max)
        b = scenario.sample_arrival_times(rate, 40.0,
                                          np.random.default_rng(35),
                                          rate_max=rate_max)
        assert np.array_equal(a, b) and len(a) > 50
    xs = list(np.random.default_rng(36).lognormal(0.0, 1.0, 501))
    stats = metrics._latency_stats(xs)
    assert frozen.percentile(xs, 50) == stats["p50"]
    assert frozen.percentile(xs, 99) == stats["p99"]
    assert frozen.percentile([], 95) is None
