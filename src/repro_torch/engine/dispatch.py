"""Dispatch core: the tick loop behind the Engine's policy face.

The port of ``repro/engine/dispatch.py`` for ONE model lane with greedy
sampling, on contiguous slots or on the paged KV cache:

- ``Engine`` (engine.py) — policy + reporting: request validation,
  admission policy configuration, and ``EngineReport`` assembly.
- ``DispatchCore`` (this module) — mechanism: the tick loop and slot
  accounting.  It returns raw counters (:class:`DispatchOutcome`).
- ``ExecutorBackend`` — the narrow seam the core runs device steps
  through; :class:`SingleDeviceExecutor` is the one-card step set.

Paged mode (``Engine(block_size=...)``) adds a :class:`BlockPool` of
physical KV blocks behind per-slot block tables: refcounted sharing of
whole prompt-prefix blocks (a hit skips their prefill outright),
block-cost admission against the pool's free blocks, and a host mirror
of the tables pushed to the card when it changed.  Its prefix keys are
the token chain alone: the reference's prime-source and model-tag seeds
belong to families and lanes not ported yet.

Not ported yet, and refused with an error naming their ROADMAP item where
a caller asks for them: preemption and fault injection (queue 1, item
12), prime families (item 13), speculation, multiplexing and the sharded
executor (item 14).
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
from repro_torch.engine.slots import BlockPool, SlotPool
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
    shared_blocks: int = 0            # paged: prefix blocks it reused

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
    """The one-card step set: the slot tick captured as a CUDA graph and
    memoized process-wide (``runtime/steps.py::cached_slot_decode_step``),
    as the reference's executor hands out its compiled step; the chunk
    step eager."""

    kind = "single"

    def slot_step(self, cfg, *, mode, temperature):
        return ST.cached_slot_decode_step(cfg, mode=mode,
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
    # paged mode
    shared_hits: int = 0              # prefix blocks reused at admission
    skipped_tokens: int = 0           # prompt tokens those blocks held
    blocks_demanded: int = 0          # worst-case blocks of every admission
    peak_used: int = 0                # high-water mark of held blocks
    util_sum: float = 0.0             # sum over ticks of held / usable
    leaked_blocks: int = 0            # pool deficit at drain (must be 0)
    now: float = 0.0                  # engine-clock duration
    wall: float = 0.0                 # measured host time


class DispatchCore:
    """The tick loop: ingest -> admit -> chunk prefill -> one fused slot
    step -> host bookkeeping, repeated until the trace drains.  One
    instance per ``serve`` call; the pool and the host token / index
    mirrors are built fresh for every run, and the device cache is the
    engine's, zeroed in place (``Engine.zeroed_cache``), so the captured
    tick stays bound to it from run to run."""

    def __init__(self, eng):
        self.eng = eng
        self.bpool: Optional[BlockPool] = None

    # -- paged-mode admission helpers (host-side) ----------------------

    def _prefix_keys(self, req: EngineRequest) -> Tuple:
        """Exact prefix hash chain, one key per FULL prompt block:
        ``key_j = (key_{j-1}, block_j_tokens)`` — nested tuples compared
        by value, so equal keys mean equal token prefixes (no hash
        collisions by construction)."""
        bs = self.eng.block_size
        key: Tuple = ()
        keys = []
        for j in range(len(req.prompt) // bs):
            key = (key, tuple(req.prompt[j * bs:(j + 1) * bs]))
            keys.append(key)
        return tuple(keys)

    def _usable_hits(self, req: EngineRequest,
                     keys: Optional[Tuple] = None) -> int:
        """Leading prompt blocks already resident (registered by an
        earlier tenant).  Capped at ``(prompt-1) // bs``: the LAST prompt
        token always rides the fused step, and its KV write must land in
        a privately owned block, never a shared one."""
        if keys is None:
            keys = self._prefix_keys(req)
        cap = (len(req.prompt) - 1) // self.eng.block_size
        hits = 0
        for j in range(min(cap, len(keys))):
            if self.bpool.lookup(keys[j]) is None:
                break
            hits += 1
        return hits

    def _block_cost(self, req: EngineRequest) -> int:
        """Worst-case FRESH blocks this request claims if admitted now:
        ceil((prompt + max_new) / bs) minus currently shareable prefix
        blocks — what memory-aware admission prices against the pool."""
        bs = self.eng.block_size
        need = -(-(len(req.prompt) + req.max_new_tokens) // bs)
        return need - self._usable_hits(req)

    def run(self, reqs: List[EngineRequest], *, clock: str,
            tick_s: Union[float, Callable[[int], float]],
            max_ticks: Optional[int],
            drop_missed_deadlines: bool) -> DispatchOutcome:
        eng = self.eng
        S = eng.num_slots
        dev = eng.device
        pool = SlotPool(S, max_seq=eng.max_seq)
        paged = eng.block_size is not None
        cache = eng.zeroed_cache()
        if paged:
            bpool = self.bpool = BlockPool(eng.num_blocks, eng.block_size)
            tables_np = np.zeros((S, eng.max_blocks), np.int32)
        tables_dirty = False
        shared_hits = skipped_tokens = blocks_demanded = peak_used = 0
        util_sum = 0.0
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

        def register_blocks(st) -> None:
            # publish each prompt block for prefix sharing the moment the
            # slot's frontier passes its end (its KV writes are already
            # issued in stream order, so any later read sees them)
            while (st.registered < len(st.prompt_keys)
                   and st.pos >= (st.registered + 1) * eng.block_size):
                bpool.register(st.prompt_keys[st.registered],
                               st.block_table[st.registered])
                st.registered += 1

        def release_blocks(st) -> None:
            nonlocal tables_dirty
            for bid in st.block_table:
                bpool.release(bid)
            st.block_table, st.prompt_keys, st.registered = None, (), 0
            tables_np[st.sid, :] = 0          # retired row writes to trash
            tables_dirty = True

        hits_of = {}                          # rid -> shared prefix blocks

        def retire(st, status: str) -> None:
            results.append(RequestResult(
                rid=st.rid, tokens=list(st.generated or []),
                arrival_s=st.arrival_s, admit_s=st.admit_s,
                first_token_s=st.first_token_s, finish_s=now, slot=st.sid,
                dropped=status == "dropped", status=status,
                priority=st.priority, deadline_s=st.deadline_s,
                shared_blocks=hits_of.get(st.rid, 0)))
            if paged:
                release_blocks(st)
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
            cohort = sched.admit(
                now, pool.free_count, next_arrival,
                cost_fn=self._block_cost if paged else None,
                budget=bpool.free_blocks if paged else None)
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
                if paged:
                    # build the slot's block table: ref every shared
                    # prefix block (their prefill chunks are skipped
                    # entirely), alloc the rest privately — the admission
                    # decision priced exactly this claim
                    keys = self._prefix_keys(req)
                    hits = self._usable_hits(req, keys)
                    need = -(-(len(req.prompt) + req.max_new_tokens)
                             // eng.block_size)
                    table = []
                    for j in range(hits):
                        bid = bpool.lookup(keys[j])
                        bpool.ref(bid)
                        table.append(bid)
                    for _ in range(need - hits):
                        table.append(bpool.alloc())
                    st.block_table = table
                    st.prompt_keys = keys
                    st.registered = hits
                    st.pos = hits * eng.block_size
                    tables_np[st.sid, :] = 0
                    tables_np[st.sid, :len(table)] = table
                    tables_dirty = True
                    hits_of[req.rid] = hits
                    shared_hits += hits
                    skipped_tokens += hits * eng.block_size
                    blocks_demanded += need
                index[st.sid] = st.pos
                left = len(st.prompt) - 1 - st.pos
                if eng.prefill_chunk and left > 0:
                    # all but the last prompt token (less any shared
                    # prefix already resident) go through chunked
                    # prefill; the last rides the fused step (its sample
                    # is the first output token)
                    st.chunk_left = left
                else:
                    tokens[st.sid, 0] = st.next_input()
            if generating:
                admissions_while_busy += admitted
            if tables_dirty:
                # push the host table mirror before any dispatch this
                # tick writes or reads through it
                cache["block_tables"].copy_(torch.from_numpy(tables_np))
                tables_dirty = False
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
                if paged:
                    register_blocks(st)
                if st.chunk_left == 0:
                    tokens[st.sid, 0] = st.prompt[st.pos]
            # 5) one fused slot-masked step: every ready slot, one token
            active = np.array([s.active and s.chunk_left == 0
                               for s in pool.slots], bool)
            nxt = None
            if active.any():
                # the captured step's outputs are static buffers that the
                # next tick overwrites: read here, within this tick
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
            if paged:
                used = bpool.used_blocks
                peak_used = max(peak_used, used)
                util_sum += used / max(1, eng.num_blocks - 1)
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
                if paged:
                    register_blocks(st)
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
                         for t in cache.values()),
            shared_hits=shared_hits, skipped_tokens=skipped_tokens,
            blocks_demanded=blocks_demanded, peak_used=peak_used,
            util_sum=util_sum,
            leaked_blocks=((eng.num_blocks - 1) - bpool.free_blocks
                           if paged else 0), now=now,
            wall=time.perf_counter() - t0)
