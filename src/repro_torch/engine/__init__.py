"""Continuous-batching slot engine (single model, contiguous or paged
slots, greedy sampling) — see ``engine.py`` and ``dispatch.py``."""
from repro_torch.engine.dispatch import (DispatchCore, EngineRequest,
                                         ExecutorBackend, RequestResult,
                                         ShardedExecutor,
                                         SingleDeviceExecutor)
from repro_torch.engine.engine import (Engine, EngineReport,
                                       reference_outputs, synthetic_requests)
from repro_torch.engine.scheduler import SlotScheduler
from repro_torch.engine.slots import (BlockPool, RequestTooLong, SlotPool,
                                      SlotState)

__all__ = ["BlockPool", "DispatchCore", "Engine", "EngineReport",
           "EngineRequest", "ExecutorBackend", "RequestResult",
           "RequestTooLong", "ShardedExecutor", "SingleDeviceExecutor",
           "SlotPool", "SlotScheduler", "SlotState", "reference_outputs",
           "synthetic_requests"]
