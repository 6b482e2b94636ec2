"""Admission frontend for the live engine.

``SlotScheduler`` owns the pending queue and consults the SAME
:class:`repro_torch.core.batching.AdmissionPolicy` the virtual-time simulator
(`BatchQueue`) uses — the refactor's point is that "which requests launch
now?" is one decision procedure with two backends.  ``run_virtual``
replays a whole arrival trace through this scheduler under the
simulator's engine-busy-until-finish semantics, which is what the
equivalence property test compares against ``BatchQueue.run`` record for
record.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Sequence

from repro_torch.core import batching as bt


class SlotScheduler:
    """Pending queue + shared admission policy.

    Works on any request object with ``arrival_s``/``deadline_s``/``rid``
    attributes (``core.batching.Request`` or the engine's
    ``EngineRequest``).
    """

    def __init__(self, policy: bt.AdmissionPolicy):
        self.policy = policy
        self.pending: List = []          # sorted by (class rank, deadline)

    def push(self, req) -> None:
        """Class-first, deadline-second ordering.  Requests without a
        ``priority`` attribute (the simulator's ``core.batching.Request``)
        rank as interactive (rank 0), so a single-class queue keeps
        today's pure-deadline order — the simulator equivalence property
        is untouched."""
        bisect.insort(self.pending, req, key=lambda r: (
            bt.priority_rank(getattr(r, "priority", bt.PRIORITY_CLASSES[0])),
            r.deadline_s))

    def admit(self, now: float, capacity: int,
              next_arrival: Optional[float] = None, *,
              cost_fn=None, budget=None,
              active_by_class=None, key_fn=None) -> List:
        """Requests to admit right now into ``capacity`` free slots
        (possibly none: the policy may prefer to wait for more work).

        ``cost_fn(req) -> int`` + ``budget`` enable memory-aware
        admission (the paged KV engine): each pending request's
        worst-case block claim is priced and the policy shrinks the
        cohort until the summed claim fits what the pool has free
        (``budget`` may be a per-model mapping when ``key_fn`` yields
        ``(model, class)`` tuples — see ``AdmissionPolicy.decide``).

        ``active_by_class`` (quota key -> slots currently held)
        activates per-class quota admission when the policy has
        ``class_quotas``; quota-blocked requests are skipped, not
        barriers, so the policy returns explicit ``picks`` indices
        instead of a prefix length.

        ``key_fn(req)`` overrides how a pending request is classed —
        the multiplexed engine passes ``lambda r: (r.model,
        r.priority)`` so quotas meter ``(model, class)`` keys.  Setting
        it forces the class-aware picks path even with no quotas
        configured (which then reduces to the legacy prefix cohort);
        leaving it ``None`` preserves the single-model path exactly."""
        if capacity <= 0 or not self.pending:
            return []
        costs = ([cost_fn(r) for r in self.pending]
                 if cost_fn is not None else None)
        use_classes = bool(self.policy.class_quotas) or key_fn is not None
        if key_fn is not None:
            classes = [key_fn(r) for r in self.pending]
        else:
            classes = ([getattr(r, "priority", bt.PRIORITY_CLASSES[0])
                        for r in self.pending] if use_classes else None)
        act = self.policy.decide(
            now, [r.deadline_s for r in self.pending], next_arrival,
            capacity=capacity, costs=costs, budget=budget,
            classes=classes,
            active_by_class=active_by_class if use_classes else None)
        if not act.launch:
            return []
        if act.picks is not None:
            cohort = [self.pending[i] for i in act.picks]
            for i in sorted(act.picks, reverse=True):
                del self.pending[i]
            return cohort
        cohort = self.pending[:act.batch]
        del self.pending[:act.batch]
        return cohort

    def run_virtual(self, requests: Sequence[bt.Request]
                    ) -> List[bt.BatchRecord]:
        """Replay a trace under virtual time with the simulator's
        engine-busy-until-finish semantics, going through this
        scheduler's own ``push``/``admit`` path.  Must produce records
        identical to ``BatchQueue.run`` on the same trace — the
        property test for the policy extraction."""
        reqs = sorted(requests, key=lambda r: r.arrival_s)
        records: List[bt.BatchRecord] = []
        service = self.policy.service_time
        i, now = 0, 0.0
        while i < len(reqs) or self.pending:
            while i < len(reqs) and reqs[i].arrival_s <= now:
                self.push(reqs[i])
                i += 1
            if not self.pending:
                now = reqs[i].arrival_s
                continue
            next_arrival = reqs[i].arrival_s if i < len(reqs) else None
            cohort = self.admit(now, self.policy.max_batch, next_arrival)
            if not cohort:                       # policy chose to wait
                if next_arrival is None or next_arrival <= now:
                    # Nothing left to wait FOR: a policy that declines a
                    # non-empty queue after the last arrival would spin
                    # forever (and `now = None` used to TypeError here).
                    # Surface it as a contract violation instead.
                    raise RuntimeError(
                        "AdmissionPolicy declined a non-empty pending queue "
                        f"with no future arrival to wait for (now={now!r}, "
                        f"next_arrival={next_arrival!r}, "
                        f"pending={len(self.pending)}); "
                        "run_virtual cannot make progress")
                now = next_arrival
                continue
            finish = now + service(len(cohort))
            records.append(bt.BatchRecord(
                now, finish, tuple(r.rid for r in cohort),
                all(finish <= r.deadline_s for r in cohort)))
            now = finish
        return records
