"""Serving runtime of the port: the lockstep engine over a dense or a
paged KV cache, in the three system modes (``eaas`` with the control plane
over the expert tier, and the paper's baselines ``monolithic_ep`` and
``tp``) and three decode modes (``lockstep``, ``pipelined`` two-microbatch
decode on two CUDA streams, and its ``serialized`` ablation).

``ServingEngine`` (scheduler -> executor -> metrics around a clock), with
``WallClock`` for real timing on the card and ``VirtualClock`` for the
reference's deterministic cost model; ``Scenario`` replays a seeded
traffic, fault, skew and scaling timeline against it; the
``RebalanceController`` migrates replicas live and the ``Autoscaler``
resizes the pool and pages cold experts out.
"""

from repro_torch.serving.autoscale import Autoscaler, AutoscalerConfig  # noqa: F401
from repro_torch.serving.clock import Clock, VirtualClock, WallClock  # noqa: F401
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: F401
from repro_torch.serving.metrics import ServingMetrics  # noqa: F401
from repro_torch.serving.rebalance import (RebalanceConfig,  # noqa: F401
                                           RebalanceController)
from repro_torch.serving.request import Request, SamplingParams  # noqa: F401
from repro_torch.serving.scenario import (Scenario, ScenarioResult,  # noqa: F401
                                          zipf_bias)
