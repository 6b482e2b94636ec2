"""Replica router: the fleet front-end over N slot engines (a copy of
``repro/engine/router.py``: host logic over ``core/batching.py``, so one
trace and one set of policies give the same plan in both packages).

The paper's serving tier is not one chip: datacenter traffic lands on a
fleet of identical accelerators behind a front-end, and the per-chip
determinism argument (Table 4) is what lets the FLEET promise a p99 —
each replica's tail is predictable, so placement is the only new source
of variance.  This module is that front-end in the repo's offline,
deterministic idiom:

- :class:`ReplicaRouter` owns N :class:`~repro_torch.engine.engine.Engine`
  replicas (each with its own device state — caches, pools, compiled
  steps; decode-contract rule 9: the router holds NO device state).
- ``route`` assigns each request, in arrival order, to the replica with
  the LOWEST projected slot occupancy — a virtual-time projection that
  admits a request only where the replica's own
  ``core.batching.AdmissionPolicy`` would admit it under the projected
  state.  The router therefore never routes an admission a replica's
  policy would reject (property-tested in ``tests/test_router.py``, and
  the port's plan held to it in ``tests/test_torch_router.py``);
  a request every replica's quotas permanently refuse is returned as
  typed ``refused``, never silently dropped.
- ``serve`` runs the plan: each replica serves its assigned sub-trace
  (sequentially here — replicas are independent, so any execution order
  yields the same bits), and the per-replica ``EngineReport``s roll up
  into one :class:`RouterReport`.

Because replicas share no state, a request's output depends only on
which replica's engine served it — and every replica is configured
identically — so routed outputs are bit-for-bit the outputs of a single
engine serving the same sub-trace (``chip_smoke.py``'s multiplex phase
holds it on the card).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import batching as bt
from repro_torch.engine.dispatch import EngineRequest, RequestResult
from repro_torch.engine.engine import Engine, EngineReport

# projected per-token slot-hold time when a replica's policy models
# service time as free (the default Engine policy): the engine's default
# virtual tick_s, so projections still spread load instead of
# degenerating to "everything fits replica 0"
_FALLBACK_EST_S = 1e-3


@dataclasses.dataclass(frozen=True)
class RouteDecision:
    """Audit record for one admission the router made: the projected
    state under which the target replica's AdmissionPolicy said yes.
    The property test replays ``policy.decide`` on exactly this state
    and asserts it launches."""
    rid: int
    replica: str
    now: float
    capacity: int
    active_by_class: Dict


@dataclasses.dataclass
class RoutePlan:
    assignments: Dict[str, List[EngineRequest]]
    refused: List[EngineRequest]
    decisions: List[RouteDecision]


@dataclasses.dataclass
class RouterReport:
    """Fleet rollup: per-replica reports plus the merged view the caller
    actually consumes (rid-sorted results spanning every replica and the
    refused set, fleet throughput over the slowest replica's clock)."""
    results: List[RequestResult]
    replicas: Dict[str, EngineReport]
    replica_names: List[str]
    refused: int
    generated_tokens: int
    duration_s: float              # slowest replica's engine clock
    tokens_per_s: float            # fleet tokens over that clock
    goodput_tokens_per_s: float
    p99_latency_s: float
    mean_ttft_s: float
    leaked_blocks: int
    replica_occupancy: Dict[str, float]   # per-replica mean occupancy
    replica_requests: Dict[str, int]      # per-replica assigned count

    def outputs(self) -> Dict[int, List[int]]:
        return {r.rid: r.tokens for r in self.results}


class _Projection:
    """One replica's virtual-time occupancy projection: a min-heap of
    (projected_finish, quota_keys) for every routed-but-unfinished
    request, plus the quota usage those requests hold."""

    def __init__(self, name: str, eng: Engine):
        self.name = name
        self.eng = eng
        self.heap: List[Tuple[float, int, Tuple]] = []
        self.active_by_class: Dict = {}
        self._push_seq = 0
        est = eng.policy.service_time(1)
        self.est_s = est if est > 0 else _FALLBACK_EST_S

    def retire_until(self, now: float) -> None:
        while self.heap and self.heap[0][0] <= now:
            _, _, keys = heapq.heappop(self.heap)
            for k in keys:
                n = self.active_by_class.get(k, 0) - 1
                if n > 0:
                    self.active_by_class[k] = n
                else:
                    self.active_by_class.pop(k, None)

    @property
    def active(self) -> int:
        return len(self.heap)

    @property
    def occupancy(self) -> float:
        return self.active / self.eng.num_slots

    def class_key(self, r: EngineRequest):
        return ((getattr(r, "model", None), r.priority)
                if self.eng.multi else r.priority)

    def admits(self, r: EngineRequest, now: float) -> Optional[RouteDecision]:
        """Would this replica's own AdmissionPolicy admit ``r`` right
        now, under the projected state?  The policy is consulted with
        the projected free-slot capacity and projected per-class usage —
        the same inputs the live engine's scheduler would hand it."""
        cap = self.eng.num_slots - self.active
        if cap <= 0:
            return None
        act = self.eng.policy.decide(
            now, [r.deadline_s], next_arrival=None, capacity=cap,
            classes=[self.class_key(r)],
            active_by_class=dict(self.active_by_class))
        if not (act.launch and act.batch >= 1):
            return None
        return RouteDecision(rid=r.rid, replica=self.name, now=now,
                             capacity=cap,
                             active_by_class=dict(self.active_by_class))

    def commit(self, r: EngineRequest, now: float) -> None:
        hold = (len(r.prompt) + r.max_new_tokens) * self.est_s
        keys = bt.AdmissionPolicy._quota_keys(self.class_key(r))
        self._push_seq += 1
        heapq.heappush(self.heap, (now + hold, self._push_seq, keys))
        for k in keys:
            self.active_by_class[k] = self.active_by_class.get(k, 0) + 1


class ReplicaRouter:
    """Load-balance a request trace across N identically-configured
    engine replicas by projected slot occupancy.

    ``engines`` must be independently-constructed :class:`Engine`
    instances (they share NO device state); ``names`` labels them for
    reports and straggler attribution (default ``replica0..N-1``).
    """

    def __init__(self, engines: Sequence[Engine],
                 names: Optional[Sequence[str]] = None):
        if not engines:
            raise ValueError("ReplicaRouter needs at least one engine")
        self.engines = list(engines)
        if names is None:
            names = [e.name or f"replica{i}"
                     for i, e in enumerate(self.engines)]
        if len(names) != len(self.engines):
            raise ValueError(f"{len(names)} names for "
                             f"{len(self.engines)} engines")
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique: {list(names)}")
        self.names = list(names)
        for e, n in zip(self.engines, self.names):
            if e.name is None:
                e.name = n
        lane_sets = {frozenset(e.lanes) for e in self.engines}
        if len(lane_sets) != 1:
            raise ValueError(
                "replicas must serve the same model lanes; got "
                f"{sorted(sorted(map(repr, s)) for s in lane_sets)}")

    def route(self, requests: Sequence[EngineRequest]) -> RoutePlan:
        """Assign every request to a replica (or refuse it), in arrival
        order, deterministically.  Each request goes to the
        lowest-projected-occupancy replica whose AdmissionPolicy admits
        it; when every replica is projected full (or quota-blocked), the
        projection clock advances to the earliest projected finish and
        the request retries — bounded, because every retry retires at
        least one projected slot.  A request refused by every replica
        with an EMPTY projection is permanently unroutable (its quota
        key is hard-capped at zero everywhere) and lands in
        ``refused``."""
        projs = [_Projection(n, e)
                 for n, e in zip(self.names, self.engines)]
        assignments: Dict[str, List[EngineRequest]] = \
            {n: [] for n in self.names}
        refused: List[EngineRequest] = []
        decisions: List[RouteDecision] = []
        reqs = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        for r in reqs:
            now = r.arrival_s
            placed = False
            while True:
                for p in projs:
                    p.retire_until(now)
                # lowest projected occupancy first; index breaks ties so
                # the plan is deterministic
                order = sorted(range(len(projs)),
                               key=lambda i: (projs[i].occupancy, i))
                for i in order:
                    dec = projs[i].admits(r, now)
                    if dec is not None:
                        projs[i].commit(r, now)
                        assignments[projs[i].name].append(r)
                        decisions.append(dec)
                        placed = True
                        break
                if placed:
                    break
                # everyone said no: advance the projection clock past
                # the earliest projected finish anywhere and retry
                pending_finishes = [p.heap[0][0] for p in projs if p.heap]
                if not pending_finishes:
                    refused.append(r)      # unroutable even when idle
                    break
                now = max(now, min(pending_finishes))
                # strict progress: retire at least the entry we jumped to
                for p in projs:
                    p.retire_until(now)
        return RoutePlan(assignments=assignments, refused=refused,
                         decisions=decisions)

    def serve(self, requests: Sequence[EngineRequest],
              **serve_kwargs) -> RouterReport:
        """Route, then serve each replica's sub-trace and roll up.

        ``serve_kwargs`` pass through to every replica's
        :meth:`Engine.serve` unchanged (clock, tick_s, preemption,
        fault_plan, ...), so the fleet runs the same discipline as a
        single engine."""
        plan = self.route(requests)
        reports: Dict[str, EngineReport] = {}
        for name, eng in zip(self.names, self.engines):
            sub = plan.assignments[name]
            if sub:
                reports[name] = eng.serve(sub, **serve_kwargs)
        results: List[RequestResult] = []
        for rep in reports.values():
            results.extend(rep.results)
        for r in plan.refused:
            results.append(RequestResult(
                rid=r.rid, tokens=[], arrival_s=r.arrival_s,
                admit_s=-1.0, first_token_s=-1.0, finish_s=r.arrival_s,
                slot=-1, status="refused", priority=r.priority,
                deadline_s=r.deadline_s,
                model=getattr(r, "model", None)))
        results.sort(key=lambda r: r.rid)
        gen = sum(rep.generated_tokens for rep in reports.values())
        dur = max((rep.duration_s for rep in reports.values()),
                  default=0.0)
        lat = [r.latency_s for r in results if r.status == "ok"]
        ttft = [r.ttft_s for r in results if r.emitted]
        refused_n = len(plan.refused) + sum(rep.refused
                                            for rep in reports.values())
        return RouterReport(
            results=results,
            replicas=reports,
            replica_names=list(self.names),
            refused=refused_n,
            generated_tokens=gen,
            duration_s=dur,
            tokens_per_s=gen / dur if dur > 0 else 0.0,
            goodput_tokens_per_s=(
                sum(rep.goodput_tokens_per_s * rep.duration_s
                    for rep in reports.values()) / dur if dur > 0 else 0.0),
            p99_latency_s=bt.p99(lat),
            mean_ttft_s=float(np.mean(ttft)) if ttft else 0.0,
            leaked_blocks=sum(rep.leaked_blocks
                              for rep in reports.values()),
            replica_occupancy={n: reports[n].mean_occupancy
                               if n in reports else 0.0
                               for n in self.names},
            replica_requests={n: len(plan.assignments[n])
                              for n in self.names})
