"""Serving runtime of the port: the lockstep, dense-KV EAAS engine.

``ServingEngine`` (scheduler -> executor -> metrics around a clock), with
``WallClock`` for real timing on the card and ``VirtualClock`` for the
reference's deterministic cost model.
"""

from repro_torch.serving.clock import Clock, VirtualClock, WallClock  # noqa: F401
from repro_torch.serving.engine import EngineConfig, ServingEngine  # noqa: F401
from repro_torch.serving.request import Request, SamplingParams  # noqa: F401
