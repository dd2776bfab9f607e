"""``BENCHMARK.json`` against the benchmark's contract: its keys, names,
units and limits, the files it names, and the configurations' cuts."""

import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
B = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden_size|intermediate_size|latent|state_size|proj|"
                   r"_dim$|_rank$|head_size|expan|experts_per_tok)")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes():
    assert list(B) == ["command", "paths", "run_seconds", "configs",
                       "workloads", "end_to_end", "per_layer"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(B["paths"]) <= 16 and 1 <= len(B["command"]) <= 32
    for p in B["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", p) and ".." not in p
        assert (ROOT / p).is_dir()
    assert all(_text(w) and not w.startswith("/") for w in B["command"])
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    # a full check of 24 cells fits in its 43,200 seconds
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (B["run_seconds"]
                                                       + 60)


def test_names_units_and_entries():
    names = set()
    for c in B["configs"]:
        assert list(c) == ["name", "source", "file", "reduced", "why"]
        assert NAME.match(c["name"]) and _text(c["source"])
        assert _text(c["why"]) and len(c["reduced"]) <= 16
        assert any(c["file"].startswith(p + "/") for p in B["paths"])
        assert all(NAME.match(k) and not WIDTH.search(k)
                   for k in c["reduced"])
        names.add(c["name"])
    assert 1 <= len(B["configs"]) <= 24
    cells = set()
    pairs = set()
    for w in B["workloads"]:
        assert list(w) == ["name", "config", "traffic", "chips", "why"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _text(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
    assert len(cells) == len(B["workloads"]) and 1 <= len(cells) <= 24
    assert sum(w["chips"] == 4 for w in B["workloads"]) <= 1
    assert {w["config"] for w in B["workloads"]} == names
    e2e = {}
    for e in B["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
        e2e[e["name"]] = set(e.get("workloads", cells))
    assert "setup_s" in e2e
    metrics = list(B["end_to_end"]) + list(B["per_layer"])
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    layers = set()
    for p in B["per_layer"]:
        assert list(p) == ["name", "unit", "better", "source", "layer",
                           "moves", "workloads"]
        assert p["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(p["layer"]) and p["moves"] in e2e
        # every cell that reports it reports what it moves
        assert set(p["workloads"]) <= e2e[p["moves"]]
        layers.add(p["layer"])
    for c in cells:
        assert sum(c in v for v in e2e.values()) >= 2
        assert any(c in p["workloads"] for p in B["per_layer"])


def test_configuration_files_state_their_cuts():
    for c in B["configs"]:
        f = json.loads((ROOT / c["file"]).read_text())
        assert f["reduced"] == c["reduced"]
        assert set(f["published"]) == set(c["reduced"])
        for k in c["reduced"]:
            assert f[k] != f["published"][k], k
        assert "deployment" in f and "assumed" in f
