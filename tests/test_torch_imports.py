"""Guards of the port's boundary: no JAX and nothing of the JAX package in
``src/repro_torch`` or ``chip_smoke.py``; no silent CPU fallback."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.kernels import ops
from repro_torch.configs import get_config
from repro_torch.serving import (EngineConfig, Scenario, ServingEngine,
                                 VirtualClock)

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(?!_torch)\b"
    r"|from\s+repro(?!_torch)\b)", re.M)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_importing_the_port_loads_no_jax():
    """In a subprocess: this pytest process already imported jax."""
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
            "or m.startswith('repro.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(_modules()) >= 25
    # the control plane's, the baselines', the async tier's, the
    # cluster's and the training slice's modules are among those imported
    assert {"repro_torch.core.monitor", "repro_torch.core.elastic",
            "repro_torch.serving.rebalance",
            "repro_torch.serving.autoscale", "repro_torch.core.monolithic",
            "repro_torch.core.overlap", "repro_torch.serving.event_loop",
            "repro_torch.serving.frontend",
            "repro_torch.serving.cluster", "repro_torch.models.mamba",
            "repro_torch.models.rwkv", "repro_torch.models.whisper",
            "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.kernels.autograd",
            "repro_torch.training.optimizer",
            "repro_torch.training.train_loop", "repro_torch.training.data",
            "repro_torch.training.checkpoint",
            "repro_torch.configs.shapes", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun",
            "repro_torch.distributed.sharding_rules",
            "repro_torch.distributed.mesh_axes"} <= set(_modules())


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*PORT.rglob("*.py"),
                                       ROOT / "chip_smoke.py"]))
def test_source_imports_no_jax_or_reference(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


def test_engine_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(get_config("deepseek-r1").reduced(), EngineConfig())


@pytest.mark.parametrize("call", [
    lambda: ops.grouped_gemm(torch.zeros(8, 8), torch.zeros(2, 8, 8),
                             torch.tensor([4, 4]), impl="cuda"),
    lambda: ops.flash_decode(torch.zeros(1, 2, 8), torch.zeros(1, 4, 1, 8),
                             torch.zeros(1, 4, 1, 8), torch.tensor([2]),
                             impl="cuda"),
    lambda: ops.paged_flash_decode(torch.zeros(1, 2, 8),
                                   torch.zeros(3, 4, 1, 8),
                                   torch.zeros(3, 4, 1, 8),
                                   torch.tensor([[1, 2]]), torch.tensor([5]),
                                   impl="cuda"),
    lambda: ops.combine_weighted(torch.zeros(2, 2, 8), torch.zeros(2, 2),
                                 impl="cuda"),
    lambda: ops.flash_decode_partial(torch.zeros(1, 2, 8),
                                     torch.zeros(1, 4, 1, 8),
                                     torch.zeros(1, 4, 1, 8),
                                     torch.tensor([2]), impl="cuda"),
    lambda: ops.sample(torch.zeros(2, 8), torch.ones(2),
                       torch.zeros(2, 2, dtype=torch.int64),
                       torch.zeros(2, dtype=torch.int64), impl="cuda"),
], ids=["grouped_gemm", "flash_decode", "paged_flash_decode",
        "combine_weighted", "flash_decode_partial", "sample"])
def test_cuda_impl_on_cpu_tensors_raises(call):
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA"):
        call()


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="unknown kernel impl"):
        ops.combine_weighted(torch.zeros(2, 2, 8), torch.zeros(2, 2),
                             impl="pallas")


@pytest.mark.parametrize("verb,key,arg", [
    ("fail_client", "i", 0), ("recover_client", "i", 1),
    ("set_frontend_policy", "policy", "least_loaded")])
def test_cluster_scenario_verbs_raise_naming_roadmap_item_8(verb, key, arg):
    """The cluster's scenario verbs are ported (they were ROADMAP Queue 1
    item 2): each builds its event; replayed on a single engine it raises
    the reference's "needs a Cluster" error before the engine steps."""
    sc = getattr(Scenario(horizon=1.0, clients=2), verb)(t=0.0,
                                                         **{key: arg})
    assert [(e.t, e.kind, e.value) for e in sc.events] == [(0.0, verb, arg)]
    assert sc.clients == 2
    eng = ServingEngine(get_config("deepseek-r1").reduced(), EngineConfig(),
                        clock=VirtualClock(), device="cpu")
    with pytest.raises(ValueError, match="needs a Cluster engine"):
        sc.run(eng)
    assert eng.step_idx == 0
