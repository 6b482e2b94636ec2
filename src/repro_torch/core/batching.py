"""Latency-aware batching — the paper's Table 4 discipline as a scheduler.

The paper's central serving observation: inference is 99th-percentile
response-time bound, and batch size is the lever that trades latency for
throughput.  CPUs/GPUs must drop to batch 16 to meet MLP0's 7 ms limit
(reaching only 42%/37% of their peak IPS) while the TPU still runs batch 200
(80% of peak).

This module provides:

- ``LatencyModel``: p99(B) = queue/host constant + per-batch service time,
  either calibrated from two measured points (paper platforms) or derived
  from `core.perfmodel` / measured step times (our serving runtime),
- ``choose_batch``: largest batch meeting a deadline — Table 4's policy,
- ``AdmissionPolicy``: the online form of that policy — given the clock,
  the pending deadlines and the next arrival, decide "launch a batch of B
  now" or "wait for more work".  This is the single decision procedure
  shared by BOTH serving backends: the virtual-time simulator below and
  the live continuous-batching engine (`repro_torch.engine`), which is what lets
  a property test assert the two make identical admission decisions.
- ``BatchQueue``: a deterministic virtual-time request-batching simulator
  (one backend of the policy) used by the serving example and the property
  tests: requests accumulate until either (a) the batch that *would* form
  can no longer finish by the earliest request's deadline, or (b) the
  chosen max batch is reached.  Deterministic execution (static shapes, no
  speculation) is what makes the p99 predictable — the TPU argument,
  applied to the serving runtime.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
from collections.abc import Mapping as _MappingABC
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)


@dataclasses.dataclass(frozen=True)
class LatencyModel:
    """p99 latency and throughput as a function of batch size.

    latency(B)  = fixed + per_item * B     (service + host + queue margin)
    ips(B)      = B / (service_fixed + service_per_item * B)
    """
    name: str
    fixed_s: float
    per_item_s: float
    service_fixed_s: float
    service_per_item_s: float

    def p99_latency(self, batch: int) -> float:
        return self.fixed_s + self.per_item_s * batch

    def service_time(self, batch: int) -> float:
        return self.service_fixed_s + self.service_per_item_s * batch

    def ips(self, batch: int) -> float:
        return batch / self.service_time(batch)

    @classmethod
    def from_two_points(cls, name: str,
                        p1: Tuple[int, float, float],
                        p2: Tuple[int, float, float]) -> "LatencyModel":
        """Calibrate from two (batch, p99_s, ips) measurements (Table 4)."""
        (b1, l1, i1), (b2, l2, i2) = p1, p2
        per_item = (l2 - l1) / (b2 - b1)
        fixed = l1 - per_item * b1
        s1, s2 = b1 / i1, b2 / i2
        sper = (s2 - s1) / (b2 - b1)
        sfix = s1 - sper * b1
        return cls(name, fixed, per_item, sfix, sper)


# Table 4, calibrated from the paper's two measured rows per platform.
TABLE4_CPU = LatencyModel.from_two_points(
    "Haswell", (16, 7.2e-3, 5482), (64, 21.3e-3, 13194))
TABLE4_GPU = LatencyModel.from_two_points(
    "K80", (16, 6.7e-3, 13461), (64, 8.3e-3, 36465))
TABLE4_TPU = LatencyModel.from_two_points(
    "TPU", (200, 7.0e-3, 225000), (250, 10.0e-3, 280000))


def choose_batch(model: LatencyModel, deadline_s: float,
                 max_batch: int = 4096) -> int:
    """Largest batch whose modeled p99 meets the deadline (0 if none)."""
    lo, hi, best = 1, max_batch, 0
    while lo <= hi:
        mid = (lo + hi) // 2
        if model.p99_latency(mid) <= deadline_s:
            best, lo = mid, mid + 1
        else:
            hi = mid - 1
    return best


def table4_row(model: LatencyModel, deadline_s: float = 7e-3,
               max_batch: int = 4096):
    """(chosen batch, p99, IPS at chosen batch, % of max IPS) — one Table 4
    comparison row.  Max IPS evaluated at the platform's saturating batch."""
    b = choose_batch(model, deadline_s, max_batch)
    ips = model.ips(b) if b else 0.0
    ips_max = model.ips(max_batch)
    return b, model.p99_latency(b) if b else float("inf"), ips, ips / ips_max


# ---------------------------------------------------------------------------
# Admission policy (shared by the simulator and the live engine)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    arrival_s: float
    deadline_s: float          # absolute
    rid: int = 0


# SLO classes, best first.  ``priority_rank`` is total order position:
# anything unknown sorts AFTER the known classes (conservative — an
# unrecognized class never outranks interactive traffic).
PRIORITY_CLASSES = ("interactive", "batch")


def priority_rank(cls: str) -> int:
    """Smaller is better; unknown classes rank last."""
    try:
        return PRIORITY_CLASSES.index(cls)
    except ValueError:
        return len(PRIORITY_CLASSES)


@dataclasses.dataclass(frozen=True)
class Admission:
    """One scheduler decision: launch ``batch`` requests now, or wait for
    more arrivals until ``wait_until``.  When the class-aware path ran
    (quota enforcement may skip over a quota-blocked request to admit a
    later one), ``picks`` carries the explicit pending-queue indices of
    the cohort; ``picks is None`` means the legacy prefix cohort
    ``pending[:batch]``."""
    launch: bool
    batch: int = 0
    wait_until: float = 0.0
    picks: Optional[Tuple[int, ...]] = None


class AdmissionPolicy:
    """The Table 4 trade, made online — extracted from the old BatchQueue
    inner loop so the virtual-time simulator and the live engine consume
    the *same* decision procedure.

    Given the clock and the sorted pending deadlines: form the largest
    batch B <= capacity such that now + service_time(B) meets the earliest
    pending deadline; launch immediately if waiting for one more request
    would break that bound, otherwise wait for the next arrival (at most
    ``max_wait_s`` away).

    ``class_quotas`` adds SLO-class admission (overload robustness):
    ``{"batch": k}`` caps the batch class at ``k`` concurrently active
    slots, so a flood of batch traffic can never occupy the slots an
    interactive arrival needs.  The pending queue is ordered class-first
    (see ``SlotScheduler.push``) and the cohort shrinks from its tail,
    so under pressure the lowest class is dropped first — shrink *by
    class before deadline*.  A class without a quota entry is uncapped.

    Quota keys generalize to tuples for multi-model multiplexing: a
    request classed as ``(model, cls)`` is metered against the quota
    entries for the full pair AND each component, so ``{"batch": 4}``
    still caps batch traffic across all models while ``{"moe-a": 2}``
    caps one model across all classes and ``{("moe-a", "batch"): 1}``
    pins the intersection.  String-classed requests behave exactly as
    before — the tuple path is additive.
    """

    def __init__(self, service_time: Callable[[int], float],
                 max_batch: int = 256, max_wait_s: float = 2e-3,
                 class_quotas: Optional[Mapping[Any, int]] = None):
        self.service_time = service_time
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.class_quotas = dict(class_quotas or {})

    def decide(self, now: float, deadlines: Sequence[float],
               next_arrival: Optional[float] = None,
               capacity: Optional[int] = None,
               costs: Optional[Sequence[int]] = None,
               budget: Union[int, Mapping[Optional[str], int], None] = None,
               classes: Optional[Sequence[Any]] = None,
               active_by_class: Optional[Mapping[Any, int]] = None
               ) -> Admission:
        """``deadlines``: absolute deadlines of pending requests, sorted
        ascending (an empty queue is a no-launch wait).  ``capacity``
        caps the batch below ``max_batch`` (the live engine passes its
        free-slot count).

        ``costs``/``budget`` add memory-aware admission (the paged KV
        engine): ``costs[i]`` is pending request i's worst-case resource
        claim (KV blocks not already shared) and ``budget`` what the pool
        has free — the batch shrinks until its summed cost fits, and an
        unaffordable head-of-line request waits (blocks drain at
        retirement, so waiting makes progress; "free slot exists" is no
        longer sufficient).

        ``classes``/``active_by_class`` switch on per-class slot quotas:
        ``classes[i]`` is pending request i's SLO class — a plain string
        or, for multi-model multiplexing, a ``(model, cls)`` tuple
        metered against the pair and both components — and
        ``active_by_class`` the slots each quota key already holds.  A
        request whose class quota is full is *skipped over* (not a
        barrier: later pending requests of an unblocked class still
        admit), so the cohort is returned as explicit ``picks`` indices
        rather than a prefix length.  When classes are tuples, ``budget``
        may be a per-model mapping ``{model: free}`` so one model's
        memory pressure sheds only that model's cohort tail instead of
        starving every model behind a shared number."""
        if not deadlines:
            return Admission(False, wait_until=(
                next_arrival if next_arrival is not None else now))
        cap = self.max_batch if capacity is None \
            else min(capacity, self.max_batch)
        if classes is not None:
            return self._decide_classes(now, deadlines, next_arrival, cap,
                                        costs, budget, classes,
                                        active_by_class)
        earliest = deadlines[0]
        b = min(len(deadlines), cap)
        # shrink until the batch finishes by the earliest deadline
        while b > 1 and now + self.service_time(b) > earliest:
            b -= 1
        if costs is not None and budget is not None:
            # memory-aware: shrink until the cohort's worst-case claim fits
            while b > 0 and sum(costs[:b]) > budget:
                b -= 1
            if b == 0:
                return Admission(False, wait_until=(
                    next_arrival if next_arrival is not None else now))
        # can we afford to wait for more work?
        can_wait = (
            b < cap and next_arrival is not None
            and next_arrival - now <= self.max_wait_s
            and next_arrival + self.service_time(
                min(b + 1, cap)) <= earliest)
        if can_wait:
            return Admission(False, wait_until=next_arrival)
        return Admission(True, batch=b)

    @staticmethod
    def _quota_keys(c) -> Tuple:
        """Quota keys a classed request is metered against: a string
        class meters only itself; a ``(model, cls)`` tuple meters the
        pair and each non-None component (deduplicated), so per-model
        and per-class quotas compose without cross-products in config."""
        if not isinstance(c, tuple):
            return (c,)
        keys = [c]
        for part in c:
            if part is not None and part not in keys:
                keys.append(part)
        return tuple(keys)

    def _decide_classes(self, now, deadlines, next_arrival, cap,
                        costs, budget, classes, active_by_class):
        """Class-aware cohort selection.  With no quotas configured and a
        uniform class this reduces exactly to the legacy prefix path
        (no request is ever skipped, so picks == range(b))."""
        used: Dict[Any, int] = dict(active_by_class or {})
        sel: List[int] = []
        for i, c in enumerate(classes):
            if len(sel) >= cap:
                break
            keys = self._quota_keys(c)
            if any(self.class_quotas.get(k) is not None
                   and used.get(k, 0) >= self.class_quotas[k]
                   for k in keys):
                continue                       # quota-blocked: skip, not stop
            sel.append(i)
            for k in keys:
                used[k] = used.get(k, 0) + 1
        wait = Admission(False, wait_until=(
            next_arrival if next_arrival is not None else now))
        if not sel:
            return wait
        # shrink from the TAIL — the queue is class-ordered, so pressure
        # sheds the lowest class first, then the latest deadline
        earliest = min(deadlines[i] for i in sel)
        while len(sel) > 1 and now + self.service_time(len(sel)) > earliest:
            sel.pop()
            earliest = min(deadlines[i] for i in sel)
        if costs is not None and budget is not None:
            if isinstance(budget, _MappingABC):
                # per-model budgets: each model sheds its OWN cohort
                # tail until its claim fits its pool — a starved model
                # skips, it never barriers the others
                def model_of(i):
                    c = classes[i]
                    return c[0] if isinstance(c, tuple) else None
                for m, free in budget.items():
                    mine = [i for i in sel if model_of(i) == m]
                    while mine and sum(costs[i] for i in mine) > free:
                        sel.remove(mine.pop())
            else:
                while sel and sum(costs[i] for i in sel) > budget:
                    sel.pop()
            if not sel:
                return wait
        can_wait = (
            len(sel) < cap and next_arrival is not None
            and next_arrival - now <= self.max_wait_s
            and next_arrival + self.service_time(
                min(len(sel) + 1, cap)) <= earliest)
        if can_wait:
            return Admission(False, wait_until=next_arrival)
        return Admission(True, batch=len(sel), picks=tuple(sel))


# ---------------------------------------------------------------------------
# Virtual-time batch queue (simulator backend of the admission policy)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BatchRecord:
    start_s: float
    finish_s: float
    rids: Tuple[int, ...]
    deadlines_met: bool


class BatchQueue:
    """Deterministic virtual-time batching simulator: one backend of
    :class:`AdmissionPolicy` (the live `repro_torch.engine` is the other).  The
    engine-is-busy-until-finish semantics live here; the batch-vs-deadline
    decision lives in the policy.
    """

    def __init__(self, service_time: Callable[[int], float],
                 max_batch: int = 256, max_wait_s: float = 2e-3,
                 policy: Optional[AdmissionPolicy] = None):
        self.policy = policy or AdmissionPolicy(
            service_time, max_batch=max_batch, max_wait_s=max_wait_s)
        self.service_time = self.policy.service_time
        self.max_batch = self.policy.max_batch
        self.max_wait_s = self.policy.max_wait_s

    def run(self, requests: Sequence[Request]) -> List[BatchRecord]:
        pending: List[Request] = []
        records: List[BatchRecord] = []
        reqs = sorted(requests, key=lambda r: r.arrival_s)
        i, now = 0, 0.0
        while i < len(reqs) or pending:
            # admit everything that has arrived by `now`
            while i < len(reqs) and reqs[i].arrival_s <= now:
                bisect.insort(pending, reqs[i],
                              key=lambda r: r.deadline_s)
                i += 1
            if not pending:
                now = reqs[i].arrival_s
                continue
            next_arrival = reqs[i].arrival_s if i < len(reqs) else None
            act = self.policy.decide(
                now, [r.deadline_s for r in pending], next_arrival)
            if not act.launch:
                now = act.wait_until
                continue
            batch = pending[:act.batch]
            del pending[:act.batch]
            finish = now + self.service_time(act.batch)
            records.append(BatchRecord(
                now, finish, tuple(r.rid for r in batch),
                all(finish <= r.deadline_s for r in batch)))
            now = finish
        return records


def p99(latencies: Sequence[float]) -> float:
    """Nearest-rank 99th percentile: the smallest value with at least 99%
    of the sample at or below it — the ``ceil(0.99 n)``-th order
    statistic.  The old ``int(0.99 * n)`` indexing had a nearest-rank
    off-by-one at multiples of 100: at n=100 it indexed the MAX,
    overstating the tail by a whole rank.  Integer arithmetic keeps the
    rank exact by construction, with no reasoning about float rounding
    required."""
    if not latencies:
        return 0.0
    xs = sorted(latencies)
    rank = -((-99 * len(xs)) // 100)          # ceil(0.99 n), exactly
    return xs[rank - 1]


def poisson_arrivals(rate_per_s: float, n: int, deadline_s: float,
                     seed: int = 0) -> List[Request]:
    """Deterministic pseudo-Poisson arrival process (no wall clock)."""
    import random
    rng = random.Random(seed)
    t, out = 0.0, []
    for rid in range(n):
        t += rng.expovariate(rate_per_s)
        out.append(Request(arrival_s=t, deadline_s=t + deadline_s, rid=rid))
    return out
