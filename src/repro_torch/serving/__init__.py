"""Serving runtime of the port: the lockstep EAAS engine over a dense or
a paged KV cache.

``ServingEngine`` (scheduler -> executor -> metrics around a clock), with
``WallClock`` for real timing on the card and ``VirtualClock`` for the
reference's deterministic cost model; ``Scenario`` replays a seeded
traffic and failure timeline against it.
"""

from repro_torch.serving.clock import Clock, VirtualClock, WallClock  # noqa: F401
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: F401
from repro_torch.serving.request import Request, SamplingParams  # noqa: F401
from repro_torch.serving.scenario import Scenario  # noqa: F401
