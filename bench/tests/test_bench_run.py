"""A whole run of the harness on the CPU, at small sizes, in a process of
its own: the result line the contract asks for, and no module of the JAX
package or JAX itself in the process."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _run(*args, timeout=600):
    return subprocess.run([sys.executable, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("workload,trace", [("dsr1-chat", 0),
                                            ("arctic-batch", 1)])
def test_result_line(workload, trace):
    p = _run(str(BENCH / "tests" / "cpu_run.py"), workload, str(trace))
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "compared"
    for key in ("metrics", "device"):
        assert key in line
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in bench[kind]
             if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    # the compared numbers close standard error, one a line
    tail = p.stderr.strip().splitlines()[-len(line["compared"]):]
    assert all(t.startswith("compared ") for t in tail)
    mods = next(json.loads(t)["modules"] for t in p.stderr.splitlines()
                if t.startswith('{"modules"'))
    assert not FORBIDDEN & set(mods), FORBIDDEN & set(mods)
    assert "repro_torch" in mods


def test_without_a_card_no_result():
    p = _run("bench/run.py", "--workload", "dsr1-chat", "--seed",
             str(2 ** 31 + 5), "--seconds", "1", "--trace", "0",
             timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert not set(_imports(f)) & (FORBIDDEN | {"repro_torch",
                                                    "harness"}), f
    code = ("import sys; sys.path.insert(0, 'bench'); "
            "import reference.moe_decoder; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    p = _run("-c", code)
    assert p.returncode == 0, p.stderr
    mods = set(ast.literal_eval(p.stdout.strip()))
    assert not mods & (FORBIDDEN | {"repro_torch", "harness"})


def test_nothing_reads_the_jax_packages_benchmarks():
    for f in sorted(BENCH.rglob("*.py")):
        if f.parent.name == "tests":
            continue
        assert "benchmarks" not in f.read_text(), f
        assert not set(_imports(f)) & FORBIDDEN, f
