"""Step watchdog: straggler detection + training-loop fault handling.

With static shapes and deterministic execution (no data-dependent
recompiles), per-step wall time is tight — the TPU paper's determinism
argument.  That makes straggler detection trivial and reliable: a step
slower than ``threshold`` x the rolling median indicates a sick host /
preemption, not workload variance.

The watchdog is pure bookkeeping (works identically under simulation in
tests): the launcher decides the response (log, checkpoint-now, or abort
for the scheduler to restart — which `--resume auto` then recovers).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import List, Optional


@dataclasses.dataclass
class StepWatchdog:
    window: int = 32
    threshold: float = 2.0
    warmup_steps: int = 3          # ignore compile-dominated first steps
    # who this watchdog watches: the engine's name, so straggler warnings
    # attribute to it instead of an anonymous "engine tick N"
    name: Optional[str] = None
    _times: List[float] = dataclasses.field(default_factory=list)
    _seen: int = 0
    slow_steps: int = 0

    def record(self, step_seconds: float) -> Optional[str]:
        """Record a step time; returns a warning string for stragglers."""
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return None
        if len(self._times) >= 8:
            med = statistics.median(self._times)
            if step_seconds > self.threshold * med:
                self.slow_steps += 1
                tag = f"[{self.name}] " if self.name else ""
                return (f"{tag}straggler: step took {step_seconds:.3f}s "
                        f"({step_seconds / med:.1f}x median {med:.3f}s)")
        self._times.append(step_seconds)
        if len(self._times) > self.window:
            self._times.pop(0)
        return None

    @property
    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0


class StepTimer:
    """Wall time of a ``with`` block, in seconds, as ``.elapsed``."""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        return False
