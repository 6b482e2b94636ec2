"""Dispatch core: the tick loop behind the Engine's policy face.

The port of ``repro/engine/dispatch.py`` for ONE model lane on contiguous
slots with greedy sampling:

- ``Engine`` (engine.py) — policy + reporting: request validation,
  admission policy configuration, and ``EngineReport`` assembly.
- ``DispatchCore`` (this module) — mechanism: the tick loop and slot
  accounting.  It returns raw counters (:class:`DispatchOutcome`).
- ``ExecutorBackend`` — the narrow seam the core runs device steps
  through; :class:`SingleDeviceExecutor` is the one-card step set.

Not ported yet, and refused with an error naming their ROADMAP item where
a caller asks for them: the paged cache (queue 1, item 11), preemption
and fault injection (item 12), prime families (item 13), speculation,
multiplexing and the sharded executor (item 14).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import QuantMode
from repro_torch.engine.scheduler import SlotScheduler
from repro_torch.engine.slots import SlotPool
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST
from repro_torch.runtime.watchdog import StepWatchdog


@dataclasses.dataclass(frozen=True)
class EngineRequest:
    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival_s: float = 0.0
    deadline_s: float = float("inf")
    # SLO class (see core.batching.PRIORITY_CLASSES): admission orders
    # cohorts class-first
    priority: str = "interactive"


@dataclasses.dataclass
class RequestResult:
    rid: int
    tokens: List[int]
    arrival_s: float
    admit_s: float
    first_token_s: float
    finish_s: float
    slot: int
    dropped: bool = False             # retired before completing (deadline)
    # typed outcome: "ok" (completed), "dropped" (deadline miss),
    # "failed" (its logits went non-finite), "unfinished" (still in
    # flight when the tick cap hit)
    status: str = "ok"
    priority: str = "interactive"
    deadline_s: float = float("inf")

    @property
    def latency_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def emitted(self) -> bool:
        """True once the request produced at least one token."""
        return self.first_token_s >= 0

    @property
    def ttft_s(self) -> float:
        """Admission-to-first-token; only defined when ``emitted``."""
        return self.first_token_s - self.admit_s


# ---------------------------------------------------------------------------
# executor backends: the step set behind the dispatch core
# ---------------------------------------------------------------------------

class ExecutorBackend:
    """The narrow interface the dispatch core runs device work through:
    step providers, each returning a callable with the signature of the
    corresponding ``runtime.steps.make_*_step``.  Backends provide STEPS,
    not state: every device buffer is owned by the core that calls them.
    The reference's prime, verify and propose providers arrive with their
    features (ROADMAP queue 1, items 13 and 14)."""

    kind: str = "abstract"

    def validate(self, eng) -> None:
        """Reject engine shapes this backend cannot serve."""

    def slot_step(self, cfg: ArchConfig, *, mode: QuantMode,
                  temperature: float) -> Callable:
        raise NotImplementedError

    def chunk_step(self, cfg: ArchConfig, *, mode: QuantMode,
                   chunk: int) -> Callable:
        raise NotImplementedError


class SingleDeviceExecutor(ExecutorBackend):
    """The one-card step set."""

    kind = "single"

    def slot_step(self, cfg, *, mode, temperature):
        return ST.make_slot_decode_step(cfg, mode=mode,
                                        temperature=temperature)

    def chunk_step(self, cfg, *, mode, chunk):
        return ST.make_prefill_chunk_step(cfg, mode=mode, chunk=chunk)


class ShardedExecutor(ExecutorBackend):
    """Slot-axis tensor-parallel step set — not ported yet."""

    kind = "sharded"

    def __init__(self, tp: Optional[int] = None):
        raise NotImplementedError(
            "ShardedExecutor is not ported yet (ROADMAP queue 1, item 14)")


@dataclasses.dataclass
class DispatchOutcome:
    """Raw counters out of one :meth:`DispatchCore.run`."""
    results: List[RequestResult]
    occupancy: List[int]
    ticks: int = 0
    gen_tokens: int = 0
    admissions_while_busy: int = 0
    dropped: int = 0
    failed: int = 0
    unfinished: int = 0
    nonfinite: int = 0
    stuck_ticks: int = 0
    kv_bytes: int = 0                 # resident KV-cache bytes (all leaves)
    now: float = 0.0                  # engine-clock duration
    wall: float = 0.0                 # measured host time


class DispatchCore:
    """The tick loop: ingest -> admit -> chunk prefill -> one fused slot
    step -> host bookkeeping, repeated until the trace drains.  One
    instance per ``serve`` call; the pool, the device cache and the host
    token / index mirrors are built fresh for every run."""

    def __init__(self, eng):
        self.eng = eng

    def run(self, reqs: List[EngineRequest], *, clock: str,
            tick_s: Union[float, Callable[[int], float]],
            max_ticks: Optional[int],
            drop_missed_deadlines: bool) -> DispatchOutcome:
        eng = self.eng
        S = eng.num_slots
        dev = eng.device
        pool = SlotPool(S, max_seq=eng.max_seq)
        cache = R.init_cache(eng.cfg, S, eng.max_seq, device=dev)
        tokens = np.zeros((S, 1), np.int32)
        index = np.zeros((S,), np.int32)
        step = eng.backend.slot_step(eng.cfg, mode=eng.mode,
                                     temperature=eng.temperature)
        chunk_steps = {}

        def chunk_step(c: int):
            if c not in chunk_steps:
                chunk_steps[c] = eng.backend.chunk_step(
                    eng.cfg, mode=eng.mode, chunk=c)
            return chunk_steps[c]

        sched = SlotScheduler(eng.policy)
        results: List[RequestResult] = []
        occupancy: List[int] = []
        admissions_while_busy = dropped = failed = unfinished = 0
        nonfinite = ticks = gen_tokens = 0
        wd = StepWatchdog(name=eng.name) if clock == "wall" else None

        def retire(st, status: str) -> None:
            results.append(RequestResult(
                rid=st.rid, tokens=list(st.generated or []),
                arrival_s=st.arrival_s, admit_s=st.admit_s,
                first_token_s=st.first_token_s, finish_s=now, slot=st.sid,
                dropped=status == "dropped", status=status,
                priority=st.priority, deadline_s=st.deadline_s))
            pool.free(st.sid)
            index[st.sid] = 0
            tokens[st.sid, 0] = 0

        i, now = 0, 0.0
        t0 = time.perf_counter()
        limit = max_ticks if max_ticks is not None else \
            (sum(len(r.prompt) + r.max_new_tokens for r in reqs) + 16) * 4

        while i < len(reqs) or sched.pending or pool.active_count:
            # 1) ingest everything that has arrived by `now`
            while i < len(reqs) and reqs[i].arrival_s <= now:
                sched.push(reqs[i])
                i += 1
            next_arrival = reqs[i].arrival_s if i < len(reqs) else None
            # 2) admit into free slots — mid-flight, no drain barrier
            generating = any(s.active and not s.in_prefill
                             for s in pool.slots)
            cohort = sched.admit(now, pool.free_count, next_arrival)
            admitted = 0
            for req in cohort:
                if drop_missed_deadlines and now > req.deadline_s:
                    # expired while queued: retire without taking a slot
                    results.append(RequestResult(
                        rid=req.rid, tokens=[], arrival_s=req.arrival_s,
                        admit_s=now, first_token_s=-1.0, finish_s=now,
                        slot=-1, dropped=True, status="dropped",
                        priority=req.priority, deadline_s=req.deadline_s))
                    dropped += 1
                    continue
                admitted += 1
                st = pool.alloc(req.rid, req.prompt, req.max_new_tokens,
                                now=now, arrival_s=req.arrival_s,
                                deadline_s=req.deadline_s,
                                priority=req.priority)
                index[st.sid] = 0
                left = len(st.prompt) - 1
                if eng.prefill_chunk and left > 0:
                    # all but the last prompt token go through chunked
                    # prefill; the last rides the fused step (its sample
                    # is the first output token)
                    st.chunk_left = left
                else:
                    tokens[st.sid, 0] = st.next_input()
            if generating:
                admissions_while_busy += admitted
            # 3) idle: nothing active -> jump to the next event
            if pool.active_count == 0:
                if next_arrival is None and not sched.pending:
                    break
                if next_arrival is None and not cohort and sched.pending:
                    raise RuntimeError(
                        "admission declined a non-empty pending queue "
                        f"({len(sched.pending)} requests) with an idle "
                        "pool and no future arrival; check the policy "
                        "configuration")
                target = next_arrival if next_arrival is not None else now
                if clock == "wall":
                    gap = target - (time.perf_counter() - t0)
                    if gap > 0:
                        time.sleep(min(gap, 0.05))
                    now = time.perf_counter() - t0
                else:
                    now = max(now, target)
                continue
            # 4) chunked prefill: each mid-prefill slot writes one bucketed
            #    chunk of teacher-forced prompt state
            for st in pool.active_slots():
                if st.chunk_left <= 0:
                    continue
                n = min(st.chunk_left, eng.prefill_chunk)
                c = ST.bucket_batch(n)
                buf = np.zeros((c,), np.int32)
                buf[:n] = st.prompt[st.pos:st.pos + n]
                cache = chunk_step(c)(eng.params, buf, cache, st.sid,
                                      st.pos, n)
                st.pos += n
                st.chunk_left -= n
                index[st.sid] = st.pos
                if st.chunk_left == 0:
                    tokens[st.sid, 0] = st.prompt[st.pos]
            # 5) one fused slot-masked step: every ready slot, one token
            active = np.array([s.active and s.chunk_left == 0
                               for s in pool.slots], bool)
            nxt = None
            if active.any():
                nxt_d, cache, new_index = step(
                    eng.params, torch.as_tensor(tokens, device=dev), cache,
                    torch.as_tensor(index, device=dev),
                    torch.as_tensor(active, device=dev))
                nxt = nxt_d.cpu().numpy()        # waits for the step
                index = new_index.cpu().numpy().copy()
            elif clock == "wall" and dev.type == "cuda":
                torch.cuda.synchronize(dev)      # charge chunk time here
            ticks += 1
            occupancy.append(pool.active_count)
            if clock == "wall":
                prev = now
                now = time.perf_counter() - t0
                msg = wd.record(now - prev)
                if msg:
                    warnings.warn(f"engine tick {ticks}: {msg}",
                                  RuntimeWarning)
            else:
                dt = tick_s(pool.active_count) if callable(tick_s) \
                    else tick_s
                now += dt
            # 6) host bookkeeping: teacher-force prefill, collect samples,
            #    retire finished slots for immediate reuse
            for st in pool.active_slots():
                if drop_missed_deadlines and now > st.deadline_s:
                    dropped += 1
                    retire(st, "dropped")
                    continue
                if st.chunk_left > 0:              # mid-chunk: no sample
                    continue
                st.pos += 1
                if st.pos < len(st.prompt):        # still prefilling
                    tokens[st.sid, 0] = st.prompt[st.pos]
                    continue
                tok = int(nxt[st.sid])
                if tok < 0:
                    # the finite guard's sentinel: this row's logits went
                    # NaN/Inf.  Rebuilding the slot needs preemption with
                    # exact resume (ROADMAP queue 1, item 12), so the
                    # request retires as failed.
                    nonfinite += 1
                    failed += 1
                    retire(st, "failed")
                    continue
                st.generated.append(tok)
                gen_tokens += 1
                if st.first_token_s < 0:
                    st.first_token_s = now
                if st.done():
                    retire(st, "ok")
                else:
                    tokens[st.sid, 0] = tok
            if ticks > limit:
                warnings.warn(
                    f"engine hit the {limit}-tick cap with "
                    f"{pool.active_count} active, {len(sched.pending)} "
                    f"pending and {len(reqs) - i} unarrived requests; "
                    "retiring them as 'unfinished'", RuntimeWarning)
                for st in pool.active_slots():
                    unfinished += 1
                    retire(st, "unfinished")
                for req in list(sched.pending) + reqs[i:]:
                    unfinished += 1
                    results.append(RequestResult(
                        rid=req.rid, tokens=[], arrival_s=req.arrival_s,
                        admit_s=-1.0, first_token_s=-1.0, finish_s=now,
                        slot=-1, status="unfinished", priority=req.priority,
                        deadline_s=req.deadline_s))
                sched.pending.clear()
                i = len(reqs)
                break

        return DispatchOutcome(
            results=results, occupancy=occupancy, ticks=ticks,
            gen_tokens=gen_tokens,
            admissions_while_busy=admissions_while_busy, dropped=dropped,
            failed=failed, unfinished=unfinished, nonfinite=nonfinite,
            stuck_ticks=wd.slow_steps if wd is not None else 0,
            kv_bytes=sum(t.numel() * t.element_size()
                         for t in cache.values()), now=now,
            wall=time.perf_counter() - t0)
