"""Deterministic fault injection for the slot engine (a copy of
``repro/engine/faults.py``: stdlib only, so one plan and seed give the
same faults and the same ``fired`` list in both packages).

A :class:`FaultPlan` is a *seeded, reproducible* schedule of failures the
engine consults every tick — nothing here is random at run time, so a
chaos run replays bit-for-bit and a recovered trace can be diffed against
its fault-free control arm.  Three fault kinds cover the engine's real
failure surface:

``dispatch``
    The fused slot step "fails" (in production: a CUDA runtime error, a
    device OOM, a lost graph replay).  The engine retries the
    dispatch; the plan can keep failing it until the designated culprit
    slot is evicted, modelling a poisoned input that deterministically
    kills the step.
``nan_logits``
    One slot's sampled token is replaced by the non-finite sentinel
    ``-1`` after the step, exactly what the in-graph finite guard emits
    when a slot's logits contain NaN/Inf (a corrupted cache row, an
    overflowed activation).
``torn_table``
    One slot's device block-table row is zeroed (all entries -> the
    reserved trash block 0) before dispatch — a torn/partial write.  The
    engine's table audit detects the divergence from its host mirror and
    repairs or evicts.

Faults target *ticks* (the engine's deterministic time base), not wall
clock, so plans compose with any trace.  A slot is named by its dense
global id ``lane.order * num_slots + sid`` (lane-major; a single-model
engine's ids are its slot ids), so one plan strikes across the lanes of
a multiplexed engine as it does on the JAX engine: ``FaultPlan.random(
..., num_slots=lanes * num_slots)`` spreads its victims over every lane.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Tuple

FAULT_KINDS = ("dispatch", "nan_logits", "torn_table")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled failure.

    ``tick``: engine tick (0-based, counted over dispatched fused steps)
    at which the fault fires.  ``kind``: one of :data:`FAULT_KINDS`.
    ``slot``: victim slot id; if the slot is inactive at the fault tick
    the fault targets the lowest active sid instead (a plan should not
    silently no-op because the trace shifted).  ``repeat``: for
    ``dispatch`` faults, how many consecutive retry attempts fail before
    the dispatch succeeds (a value >= the engine's ``max_retries``
    forces the culprit's eviction)."""
    tick: int
    kind: str
    slot: int = 0
    repeat: int = 1

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.tick < 0 or self.slot < 0 or self.repeat < 1:
            raise ValueError(f"bad fault {self}")


class FaultPlan:
    """A fixed schedule of :class:`Fault`\\ s, consulted by the engine.

    The plan is stateless across runs (re-serving the same plan on the
    same trace reproduces the same failures) but keeps per-run counters
    (`fired`) so a report can assert every scheduled fault actually
    fired.
    """

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: List[Fault] = sorted(faults, key=lambda f: f.tick)
        self.fired: List[Tuple[int, str, int]] = []   # (tick, kind, slot)
        self._dispatch_left: Dict[int, int] = {}      # tick -> remaining fails
        self._dispatch_victim: Dict[int, int] = {}    # tick -> bound culprit

    def __len__(self) -> int:
        return len(self.faults)

    def _victim(self, want: int, active_sids: Sequence[int]) -> Optional[int]:
        if not active_sids:
            return None
        return want if want in active_sids else min(active_sids)

    def dispatch_fault(self, tick: int, attempt: int,
                       active_sids: Sequence[int]) -> Optional[int]:
        """Should dispatch attempt ``attempt`` (0-based) at ``tick``
        fail?  Returns the culprit slot id, or None for a clean
        dispatch.  A ``repeat=r`` fault fails attempts 0..r-1; once the
        culprit slot is no longer active (the engine evicted it) the
        remaining repeats are cancelled — the poison left with the
        slot."""
        for f in self.faults:
            if f.kind != "dispatch" or f.tick != tick:
                continue
            if tick not in self._dispatch_victim:
                victim = self._victim(f.slot, active_sids)
                if victim is None:
                    return None
                self._dispatch_victim[tick] = victim
                self._dispatch_left[tick] = f.repeat
            victim = self._dispatch_victim[tick]
            if victim not in active_sids:
                return None        # culprit evicted: poison left with it
            if self._dispatch_left[tick] <= 0:
                return None
            self._dispatch_left[tick] -= 1
            self.fired.append((tick, "dispatch", victim))
            return victim
        return None

    def nonfinite_slots(self, tick: int,
                        active_sids: Sequence[int]) -> List[int]:
        """Slots whose sampled token this tick must be replaced by the
        non-finite sentinel (-1), emulating NaN/Inf logits."""
        out = []
        for f in self.faults:
            if f.kind == "nan_logits" and f.tick == tick:
                victim = self._victim(f.slot, active_sids)
                if victim is not None:
                    self.fired.append((tick, "nan_logits", victim))
                    out.append(victim)
        return out

    def torn_rows(self, tick: int,
                  active_sids: Sequence[int]) -> List[int]:
        """Slots whose device block-table row is torn (zeroed to the
        trash block) before this tick's dispatch."""
        out = []
        for f in self.faults:
            if f.kind == "torn_table" and f.tick == tick:
                victim = self._victim(f.slot, active_sids)
                if victim is not None:
                    self.fired.append((tick, "torn_table", victim))
                    out.append(victim)
        return out

    @classmethod
    def random(cls, seed: int, *, n_faults: int = 8,
               max_tick: int = 400, num_slots: int = 8,
               kinds: Sequence[str] = FAULT_KINDS,
               max_repeat: int = 2) -> "FaultPlan":
        """A seeded plan spreading ``n_faults`` failures over the run.
        Same seed -> same plan, always (``random.Random(seed)``, no
        global state)."""
        rng = random.Random(seed)
        faults = []
        for _ in range(n_faults):
            kind = rng.choice(list(kinds))
            faults.append(Fault(
                tick=rng.randrange(max_tick),
                kind=kind,
                slot=rng.randrange(num_slots),
                repeat=rng.randint(1, max_repeat) if kind == "dispatch"
                else 1))
        return cls(faults)
