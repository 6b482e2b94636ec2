"""Continuous-batching slot engine (one model or several as lanes,
contiguous or paged slots, greedy or temperature sampling) — see
``engine.py`` and ``dispatch.py`` — and the replica router in front of
several engines (``router.py``).

Overload robustness (``faults`` + ``serve(preemption=...,
fault_plan=...)``): SLO-class admission with per-class slot quotas,
slot preemption with bit-for-bit exact resume, and a seeded
deterministic fault-injection harness with bounded per-slot recovery."""
from repro_torch.engine.dispatch import (DispatchCore, EngineRequest,
                                         ExecutorBackend, RequestResult,
                                         ShardedExecutor,
                                         SingleDeviceExecutor)
from repro_torch.engine.engine import (Engine, EngineReport,
                                       reference_outputs, synthetic_requests)
from repro_torch.engine.faults import FAULT_KINDS, Fault, FaultPlan
from repro_torch.engine.router import (ReplicaRouter, RouteDecision,
                                       RoutePlan, RouterReport)
from repro_torch.engine.scheduler import SlotScheduler
from repro_torch.engine.slots import (BlockPool, RequestTooLong, SlotPool,
                                      SlotState)

__all__ = ["BlockPool", "DispatchCore", "Engine", "EngineReport",
           "EngineRequest", "ExecutorBackend", "FAULT_KINDS", "Fault",
           "FaultPlan", "ReplicaRouter", "RequestResult", "RequestTooLong",
           "RouteDecision", "RoutePlan", "RouterReport", "ShardedExecutor",
           "SingleDeviceExecutor", "SlotPool", "SlotScheduler", "SlotState",
           "reference_outputs", "synthetic_requests"]
