"""Serving runtime of the port.

The public entry point is the :class:`Cluster` front-end: N attention
clients (each a ``ServingEngine``: scheduler -> executor -> metrics around a
clock) sharing ONE expert tier (``ServerPool``) and one weight bank, with
pluggable request routing (``round_robin`` / ``least_loaded`` /
``session_affinity``), per-client admission backpressure, client failure,
drain and spawn, and the cluster-owned placement control plane.
``ServingEngine`` alone serves one client.

Engines run over a dense or a paged KV cache, in the three system modes
(``eaas`` with failover, rebalancing and elasticity over the expert tier,
and the paper's baselines ``monolithic_ep`` and ``tp``), three decode
modes (``lockstep``, ``pipelined`` two-microbatch decode on two CUDA
streams, and its ``serialized`` ablation) and two execution modes:
``lockstep`` and ``async`` — the event-driven expert tier
(``AsyncExpertTier`` micro-batch queues over an ``EventTimeline``), whose
tokens are lockstep's and whose times are the ``VirtualClock``'s.

``WallClock`` times the card; ``VirtualClock`` is the reference's
deterministic cost model.  ``Scenario`` replays a seeded traffic, fault,
skew and scaling timeline against an engine or a cluster; the
``RebalanceController`` migrates replicas live and the ``Autoscaler``
resizes the pool, the client fleet and the resident expert set.
"""

from repro_torch.serving.autoscale import (Autoscaler,  # noqa: F401
                                           AutoscalerConfig)
from repro_torch.serving.clock import (Clock, Event,  # noqa: F401
                                       EventTimeline, VirtualClock,
                                       WallClock)
from repro_torch.serving.cluster import Cluster, ClusterConfig  # noqa: F401
from repro_torch.serving.engine import (EngineConfig,  # noqa: F401
                                        ServingEngine)
from repro_torch.serving.event_loop import (AsyncExpertTier,  # noqa: F401
                                            MicroBatch, ServerQueue)
from repro_torch.serving.frontend import (  # noqa: F401
    FRONTEND_POLICIES, FrontendRouter, LeastLoaded, RoundRobin,
    SessionAffinity, make_frontend_router)
from repro_torch.serving.metrics import (ClusterMetrics,  # noqa: F401
                                         ServingMetrics)
from repro_torch.serving.rebalance import (RebalanceConfig,  # noqa: F401
                                           RebalanceController)
from repro_torch.serving.request import Request, SamplingParams  # noqa: F401
from repro_torch.serving.scenario import (Scenario,  # noqa: F401
                                          ScenarioResult, zipf_bias)
