"""Dispatch core: the tick loop behind the Engine's policy face.

The port of ``repro/engine/dispatch.py`` for ONE model lane, greedy or
sampled (the tick passes the engine's key to a sampled step), on
contiguous slots or on the paged KV cache, with the reference's overload
paths (SLO-class quotas, preemption with exact resume, fault injection
and recovery), its speculative decoding (a draft proposes, one verify
step scores, the host commits the accepted run and rewinds the rest) and
its prime dispatch (encdec, vlm: a request's encoder runs, or its
patches are projected, once at admission and again at every resume,
writing the slot's cross k/v row):

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
the token chain, seeded for a family that primes with the request's
source bytes (the reference's model-tag seed belongs to lanes not ported
yet).

Not ported yet, and refused with an error naming their ROADMAP item where
a caller asks for them: multiplexing and the sharded executor (queue 1,
item 14).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import batching as bt
from repro_torch.core.qlinear import QuantMode
from repro_torch.engine.faults import FaultPlan
from repro_torch.engine.scheduler import SlotScheduler
from repro_torch.engine.slots import BlockPool, SlotPool
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
    # encdec, vlm: the request's source embeddings (src_len, d_model),
    # encoder frames or patch embeddings a prime dispatch turns into the
    # slot's cross k/v row at admission.  src_len may be shorter than the
    # static source length; the pad is masked behind the row's xlen.
    source: Optional[np.ndarray] = dataclasses.field(
        default=None, compare=False, repr=False)
    # SLO class (see core.batching.PRIORITY_CLASSES): admission orders
    # cohorts class-first, per-class slot quotas cap how many slots a
    # class may hold, and preemption only ever evicts a slot of strictly
    # lower class than the request it makes room for
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
    # "failed" (retired by fault recovery after max_retries),
    # "unfinished" (still in flight when the tick cap hit)
    status: str = "ok"
    priority: str = "interactive"
    preemptions: int = 0              # times evicted + exactly resumed
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


@dataclasses.dataclass
class _Stash:
    """A preempted request's host-side progress, held between eviction
    and re-admission.  Device state is deliberately NOT kept: resume
    rebuilds every cache byte by teacher-forcing ``prompt + generated``
    through the chunk steps the engine already captured (every op
    computes a row independently of its batch, so the rebuilt run is bit
    for bit the never-preempted run)."""
    generated: List[int]
    first_token_s: float
    admit_s: float
    preemptions: int
    retries: int


# ---------------------------------------------------------------------------
# executor backends: the step set behind the dispatch core
# ---------------------------------------------------------------------------

class ExecutorBackend:
    """The narrow interface the dispatch core runs device work through:
    step providers, each returning a callable with the signature of the
    corresponding ``runtime.steps.make_*_step``.  Backends provide STEPS,
    not state: every device buffer is owned by the core that calls them."""

    kind: str = "abstract"

    def validate(self, eng) -> None:
        """Reject engine shapes this backend cannot serve."""

    def slot_step(self, cfg: ArchConfig, *, mode: QuantMode,
                  temperature: float) -> Callable:
        raise NotImplementedError

    def chunk_step(self, cfg: ArchConfig, *, mode: QuantMode,
                   chunk: int) -> Callable:
        raise NotImplementedError

    def verify_step(self, cfg: ArchConfig, *, mode: QuantMode, k: int,
                    temperature: float) -> Callable:
        raise NotImplementedError

    def propose_step(self, dcfg: ArchConfig, *, mode: QuantMode,
                     k: int) -> Callable:
        raise NotImplementedError

    def prime_step(self, cfg: ArchConfig, *, mode: QuantMode) -> Callable:
        raise NotImplementedError


class SingleDeviceExecutor(ExecutorBackend):
    """The one-card step set: the slot tick, the chunk step, the
    speculative verify and propose steps and the prime step, captured as
    CUDA graphs and
    memoized process-wide (``runtime/steps.py::cached_*``), as the
    reference's executor hands out its compiled steps."""

    kind = "single"

    def slot_step(self, cfg, *, mode, temperature):
        return ST.cached_slot_decode_step(cfg, mode=mode,
                                          temperature=temperature)

    def chunk_step(self, cfg, *, mode, chunk):
        return ST.cached_prefill_chunk_step(cfg, mode=mode, chunk=chunk)

    def verify_step(self, cfg, *, mode, k, temperature):
        return ST.cached_verify_step(cfg, mode=mode, k=k,
                                     temperature=temperature)

    def propose_step(self, dcfg, *, mode, k):
        return ST.cached_draft_propose_step(dcfg, mode=mode, k=k)

    def prime_step(self, cfg, *, mode):
        return ST.cached_prime_step(cfg, mode=mode)


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
    occ_by_class: Dict[str, List[int]]   # active slots per class, per tick
    ticks: int = 0
    gen_tokens: int = 0
    # row-ticks that committed >= 1 token: gen_tokens / emit_dispatches
    # is exactly 1.0 without speculation and the mean accepted run plus
    # its bonus sample with it
    emit_dispatches: int = 0
    admissions_while_busy: int = 0
    dropped: int = 0
    failed: int = 0
    unfinished: int = 0
    nonfinite: int = 0
    preempted: int = 0                # eviction events (exact resume each)
    dispatch_retries: int = 0         # failed fused-step dispatch attempts
    torn_repaired: int = 0            # torn table rows audited + rebuilt
    resumed_tokens: int = 0           # tokens re-prefilled by resumes
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
    """The tick loop: ingest -> (preempt) -> admit -> chunk prefill ->
    (speculating: draft catch-up and propose) -> (fault injection) -> one
    fused slot step, or one verify step -> host bookkeeping (and
    recovery), repeated until the trace drains.  One
    instance per ``serve`` call; the pool and the host token / index
    mirrors are built fresh for every run, and the device caches are the
    engine's, zeroed in place (``Engine.zeroed_cache``,
    ``zeroed_draft_cache``), so the captured steps stay bound to them from
    run to run.

    Speculation (``Engine(spec_k=k, ...)``): each generating slot's draft
    cache (contiguous: the draft never pages) is caught up to the slot's
    committed frontier by the draft's chunk steps, the draft proposes k
    greedy tokens for every such slot in one propose step, and the
    target's verify step replaces the fused tick, scoring each ready
    row's next input and its proposals.  The host commits the accepted
    run and the bonus sample, then rewinds the row's index to its
    committed frontier: the rejected tail's k/v writes are overwritten
    before any read sees them.  So the committed stream is bit for bit
    the non-speculative one, whatever the draft proposes."""

    def __init__(self, eng):
        self.eng = eng
        self.bpool: Optional[BlockPool] = None
        # id(source) -> (source, its key seed), for the run: pricing asks
        # for a pending request's keys every tick, and the seed's bytes
        # (6 MB for 1,500 frames) are copied and hashed once a source
        self._source_seeds: Dict[int, Tuple[np.ndarray, Tuple]] = {}

    # -- paged-mode admission helpers (host-side) ----------------------

    def _prefix_keys(self, req: EngineRequest) -> Tuple:
        """Exact prefix hash chain, one key per FULL prompt block:
        ``key_j = (key_{j-1}, block_j_tokens)`` — nested tuples compared
        by value, so equal keys mean equal token prefixes (no hash
        collisions by construction).  A family that primes seeds the
        chain with the request's source bytes: its self k/v at any
        position depends on the cross-attended source, so two prefixes
        share only when source and tokens match."""
        bs = self.eng.block_size
        key: Tuple = ()
        if R.needs_prime(self.eng.cfg):
            key = self._source_seed(req.source)
        keys = []
        for j in range(len(req.prompt) // bs):
            key = (key, tuple(req.prompt[j * bs:(j + 1) * bs]))
            keys.append(key)
        return tuple(keys)

    def _source_seed(self, source) -> Tuple:
        """The key chain's seed for a source: its shape and f32 bytes,
        made once a source object (the same object across a request's
        resumes, since they copy the request, not its source)."""
        hit = self._source_seeds.get(id(source))
        if hit is None:
            src = np.asarray(source, np.float32)
            hit = self._source_seeds[id(source)] = (
                source, (src.shape, src.tobytes()))
        return hit[1]

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
            drop_missed_deadlines: bool,
            preemption: bool = False,
            fault_plan: Optional[FaultPlan] = None,
            max_retries: int = 3) -> DispatchOutcome:
        eng = self.eng
        S = eng.num_slots
        dev = eng.device
        by_rid = {r.rid: r for r in reqs}
        self._source_seeds = {}
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
        prime = (eng.backend.prime_step(eng.cfg, mode=eng.mode)
                 if R.needs_prime(eng.cfg) else None)
        chunk_steps = {}

        def chunk_step(c: int, cfg: ArchConfig = eng.cfg):
            # memoized per (config, bucket): the target's, or the draft's
            if (cfg, c) not in chunk_steps:
                chunk_steps[cfg, c] = eng.backend.chunk_step(
                    cfg, mode=eng.mode, chunk=c)
            return chunk_steps[cfg, c]

        spec_k = eng.spec_k
        if spec_k:
            verify = eng.backend.verify_step(
                eng.cfg, mode=eng.mode, k=spec_k,
                temperature=eng.temperature)
            propose = eng.backend.propose_step(eng.dcfg, mode=eng.mode,
                                               k=spec_k)
            dcache = eng.zeroed_draft_cache()
            # per tick: each slot's usable proposals (0 = the slot does
            # not speculate this tick), the draft's proposals, and the
            # verify payload (the next input, then the proposals) with
            # the count of its tokens each row really feeds
            krow = np.zeros((S,), np.int32)
            props = np.zeros((S, spec_k), np.int32)
            tok_mat = np.zeros((S, spec_k + 1), np.int32)
            n_tok = np.zeros((S,), np.int32)

        sched = SlotScheduler(eng.policy)
        quotas_on = bool(eng.policy.class_quotas)
        results: List[RequestResult] = []
        occupancy: List[int] = []
        occ_by_class: Dict[str, List[int]] = {}
        admissions_while_busy = dropped = failed = unfinished = 0
        nonfinite = ticks = gen_tokens = emit_dispatches = 0
        # overload state: the stashed progress of preempted requests
        # (rid -> _Stash) and the fault / recovery counters
        stash: Dict[int, _Stash] = {}
        preempted = dispatch_retries = torn_repaired = resumed_tokens = 0
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

        def free_slot(st) -> None:
            if paged and st.block_table is not None:
                release_blocks(st)
            pool.free(st.sid)
            index[st.sid] = 0
            tokens[st.sid, 0] = 0

        hits_of = {}                          # rid -> shared prefix blocks

        def retire(st, status: str) -> None:
            results.append(RequestResult(
                rid=st.rid, tokens=list(st.generated or []),
                arrival_s=st.arrival_s, admit_s=st.admit_s,
                first_token_s=st.first_token_s, finish_s=now, slot=st.sid,
                dropped=status == "dropped", status=status,
                priority=st.priority, preemptions=st.preemptions,
                deadline_s=st.deadline_s,
                shared_blocks=hits_of.get(st.rid, 0)))
            free_slot(st)

        def retire_queued(req: EngineRequest, status: str,
                          admit_s: float) -> None:
            # a request that holds no slot: it keeps what a preemption
            # stashed (tokens, admission and first-token times)
            s_res = stash.pop(req.rid, None)
            results.append(RequestResult(
                rid=req.rid, tokens=list(s_res.generated) if s_res else [],
                arrival_s=req.arrival_s,
                admit_s=s_res.admit_s if s_res else admit_s,
                first_token_s=s_res.first_token_s if s_res else -1.0,
                finish_s=now, slot=-1, dropped=status == "dropped",
                status=status, priority=req.priority,
                preemptions=s_res.preemptions if s_res else 0,
                deadline_s=req.deadline_s))

        def eff_req(req: EngineRequest) -> EngineRequest:
            """The request as (re-)admission sees it: a preempted request
            resumes with its stashed tokens appended to the prompt
            (teacher-forced: the exact-resume mechanism) and its token
            budget reduced by the same count, so its cache claim is
            invariant under preemption."""
            s_res = stash.get(req.rid)
            if s_res is None or not s_res.generated:
                return req
            return dataclasses.replace(
                req, prompt=req.prompt + tuple(s_res.generated),
                max_new_tokens=req.max_new_tokens - len(s_res.generated))

        def block_cost(req: EngineRequest) -> int:
            return self._block_cost(eff_req(req))

        def preempt(st) -> None:
            """Evict a live slot with exact-resume semantics: release its
            blocks, stash its host progress, requeue the original
            request.  No device state survives: resume rebuilds it."""
            nonlocal preempted
            preempted += 1
            rid = st.rid                      # pool.free() scrubs it
            stash[rid] = _Stash(
                generated=list(st.generated or []),
                first_token_s=st.first_token_s, admit_s=st.admit_s,
                preemptions=st.preemptions + 1, retries=st.retries)
            free_slot(st)
            sched.push(by_rid[rid])

        def fail(st) -> None:
            """Retire a slot fault recovery gave up on."""
            nonlocal failed
            failed += 1
            retire(st, "failed")

        def scrub(st) -> None:
            # the tick that sampled non-finite logits wrote its non-finite
            # K/V at the slot's frontier: zero the slot's private rows in
            # place, so that a later tenant's reads past its own frontier
            # (masked to a zero weight, and 0 * NaN is NaN) never meet
            # them, and the slot's row of every slot-resident leaf (the
            # resume re-primes it).  Shared prefix blocks were written by
            # clean chunks.
            blocks = (R.paged_block_axes(eng.cfg, cache) if paged else {})
            axes = R.cache_batch_axes(eng.cfg, cache)
            for name, t in cache.items():
                if name == "block_tables":
                    continue
                if name in blocks:
                    axis = blocks[name]
                    rows = [b for b in st.block_table
                            if bpool.refcounts[b] == 1]
                else:
                    axis, rows = axes[name], [st.sid]
                t[(slice(None),) * axis + (rows,)] = 0

        def recover_nonfinite(st) -> None:
            # the finite guard's sentinel: this row's logits went NaN/Inf.
            # The sample is garbage and the cache row suspect: rebuild the
            # slot by preemption (a transient fault recomputes clean, bit
            # for bit); a slot that keeps faulting exhausts its retries
            # and fails
            nonlocal nonfinite
            nonfinite += 1
            scrub(st)
            st.retries += 1
            if st.retries > max_retries:
                fail(st)
            else:
                preempt(st)

        def commit_verified(st, row) -> int:
            """The speculative commit of one verified row: walk its fed
            positions, keeping the accepted proposals and the bonus
            sample after the last, then rewind the row's index to its
            committed frontier.  Returns 1 when the row committed a
            token (an emitting dispatch), else 0."""
            nonlocal gen_tokens
            nt = int(n_tok[st.sid])
            if (row[:nt] < 0).any():
                # a sentinel anywhere in the fed range poisons the whole
                # round: the proposals in flight are uncommitted state, so
                # recovery rebuilds from the last committed token, as in
                # the non-speculative engine
                recover_nonfinite(st)
                return 0
            pos0, committed = st.pos, 0
            for j in range(nt):
                st.pos += 1
                if paged:
                    register_blocks(st)
                if st.pos < len(st.prompt):        # still prefilling
                    tokens[st.sid, 0] = st.prompt[st.pos]
                    break
                tok = int(row[j])
                st.generated.append(tok)
                gen_tokens += 1
                committed += 1
                if st.first_token_s < 0:
                    st.first_token_s = now
                if st.done() or (j + 1 < nt
                                 and tok != int(tok_mat[st.sid, j + 1])):
                    break
            index[st.sid] = st.pos          # the rewind past rejections
            if committed and krow[st.sid] > 0:
                # the draft consumed [next input, d_1 .. d_{k-1}]; its
                # committed-valid prefix is 1 + the accepted count
                # (capped at k - 1)
                st.draft_pos = pos0 + 1 + min(committed - 1, spec_k - 1)
            if st.done():
                retire(st, "ok")
            elif committed:
                tokens[st.sid, 0] = st.generated[-1]
            return int(committed > 0)

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
            if preemption and sched.pending:
                # slot or block pressure and a pending head of strictly
                # higher class: evict the lowest-class slot (latest
                # deadline first) until the head fits or no victim of a
                # lower class is left; equal classes never preempt, so
                # batch cannot thrash batch
                head = sched.pending[0]
                hrank = bt.priority_rank(head.priority)
                for _ in range(S):
                    slot_pressed = pool.active_count >= S
                    block_pressed = (paged and block_cost(head)
                                     > bpool.free_blocks)
                    if not (slot_pressed or block_pressed):
                        break
                    victims = [s for s in pool.active_slots()
                               if bt.priority_rank(s.priority) > hrank]
                    if not victims:
                        break
                    preempt(max(victims, key=lambda s: (
                        bt.priority_rank(s.priority), s.deadline_s, s.sid)))
            abc = None
            if quotas_on:
                # the quotas' denominators: the slots each class holds
                abc = {}
                for s in pool.active_slots():
                    abc[s.priority] = abc.get(s.priority, 0) + 1
            cohort = sched.admit(
                now, pool.free_count, next_arrival,
                cost_fn=block_cost if paged else None,
                budget=bpool.free_blocks if paged else None,
                active_by_class=abc)
            admitted = 0
            for req in cohort:
                if drop_missed_deadlines and now > req.deadline_s:
                    # expired while queued: retire without taking a slot
                    # (a preempted request keeps what it had generated)
                    retire_queued(req, "dropped", now)
                    dropped += 1
                    continue
                admitted += 1
                s_res = stash.get(req.rid)
                eff = eff_req(req)
                st = pool.alloc(req.rid, eff.prompt, eff.max_new_tokens,
                                now=now, arrival_s=req.arrival_s,
                                deadline_s=req.deadline_s,
                                priority=req.priority)
                if s_res is not None:
                    # exact resume: the stashed tokens ride the prompt
                    # (teacher-forced), the generated list starts from
                    # them, and the admission and first-token times
                    # survive the eviction
                    st.generated = list(s_res.generated)
                    st.max_new = req.max_new_tokens
                    st.first_token_s = s_res.first_token_s
                    st.admit_s = s_res.admit_s
                    st.preemptions = s_res.preemptions
                    st.retries = s_res.retries
                    del stash[req.rid]
                if paged:
                    # build the slot's block table: ref every shared
                    # prefix block (their prefill chunks are skipped
                    # entirely), alloc the rest privately — the admission
                    # decision priced exactly this claim
                    keys = self._prefix_keys(eff)
                    hits = self._usable_hits(eff, keys)
                    need = -(-(len(eff.prompt) + eff.max_new_tokens)
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
                if prime is not None:
                    # prime dispatch: write the slot's cross k/v row and
                    # its xlen frontier once, between other slots' ticks
                    # (a resume re-primes: rebuilt, never trusted)
                    src, n_valid = padded_source(eng.cfg, req)
                    cache = prime(eng.params, src, cache, st.sid, n_valid)
                if s_res is not None:
                    resumed_tokens += len(st.prompt) - st.pos
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
                # tick writes or reads through it, in place: the captured
                # steps stay bound to the cache's tensors
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
                        "/ class_quotas configuration")
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
            if spec_k:
                # 4.5) speculative draft: catch each generating slot's
                #      draft cache up to its committed frontier (teacher-
                #      forced through the draft's chunk steps: this also
                #      rebuilds the draft after admission, a resume or a
                #      slot's reuse), then propose spec_k greedy tokens for
                #      every such slot in one propose step.  Draft steps
                #      see no fault injection: a wrong proposal can only
                #      be rejected.
                krow[:] = 0
                for st in pool.active_slots():
                    if st.chunk_left > 0 or st.pos < len(st.prompt) - 1:
                        continue
                    k_row = min(spec_k, st.max_new - len(st.generated) - 1,
                                eng.max_seq - 1 - st.pos)
                    if k_row <= 0:
                        continue
                    krow[st.sid] = k_row
                    n_prompt = len(st.prompt)
                    while st.draft_pos < st.pos:
                        n = min(st.pos - st.draft_pos, eng.draft_cap)
                        c = ST.bucket_batch(n)
                        buf = np.zeros((c,), np.int32)
                        for t in range(n):
                            # the committed history: prompt, then the
                            # tokens generated since this tenancy's
                            # admission, which end at position pos
                            p = st.draft_pos + t
                            buf[t] = (st.prompt[p] if p < n_prompt
                                      else st.generated[p - st.pos - 1])
                        dcache = chunk_step(c, eng.dcfg)(
                            eng.dparams, buf, dcache, st.sid, st.draft_pos,
                            n)
                        st.draft_pos += n
                d_active = krow > 0
                if d_active.any():
                    d_index = np.array([s.draft_pos for s in pool.slots],
                                       np.int32)
                    props_d, dcache, _ = propose(
                        eng.dparams, torch.as_tensor(tokens, device=dev),
                        dcache, torch.as_tensor(d_index, device=dev),
                        torch.as_tensor(d_active, device=dev))
                    props = props_d.cpu().numpy().copy()
            # 5) one fused slot-masked step: every ready slot, one token
            #    (speculating: one verify step, 1 + krow tokens a row)
            active = np.array([s.active and s.chunk_left == 0
                               for s in pool.slots], bool)
            ready = [int(s) for s in np.where(active)[0]]
            torn: List[int] = []
            if fault_plan is not None and paged and ready:
                # fault: tear the victims' device table rows (all-trash)
                # just before the dispatch, IN PLACE — a new tensor would
                # bind the captured tick anew.  The host mirror stays
                # clean: the audit below rebuilds from it, and the mirror
                # is pushed again before the next dispatch.
                torn = fault_plan.torn_rows(ticks, ready)
                if torn:
                    torn_np = tables_np.copy()
                    torn_np[torn, :] = 0
                    cache["block_tables"].copy_(torch.from_numpy(torn_np))
                    tables_dirty = True
            if fault_plan is not None:
                # dispatch faults resolve first, so a failed attempt
                # launches nothing: each charges the culprit's retry
                # budget, and past max_retries the culprit retires as
                # failed and the retry goes on without it — one poisoned
                # slot never takes down the cohort
                attempt = 0
                while ready:
                    culprit = fault_plan.dispatch_fault(ticks, attempt,
                                                        ready)
                    if culprit is None:
                        break
                    dispatch_retries += 1
                    attempt += 1
                    st = pool.slots[culprit]
                    st.retries += 1
                    if st.retries > max_retries:
                        fail(st)
                        active[culprit] = False
                        ready.remove(culprit)
            nxt = None
            if ready:
                # the captured step's outputs are static buffers that the
                # next tick overwrites: read here, within this tick, and
                # before the rewind below writes the host index
                if spec_k:
                    # the verify payload: each ready row's next input, then
                    # its usable proposals
                    tok_mat[:] = 0
                    tok_mat[:, 0] = tokens[:, 0]
                    for sid in ready:
                        kr = int(krow[sid])
                        tok_mat[sid, 1:1 + kr] = props[sid, :kr]
                    n_tok = np.where(active, 1 + krow, 0).astype(np.int32)
                    nxt_d, cache, new_index = verify(
                        eng.params, torch.as_tensor(tok_mat, device=dev),
                        cache, torch.as_tensor(index, device=dev),
                        torch.as_tensor(n_tok, device=dev),
                        torch.as_tensor(active, device=dev),
                        *eng.step_keys())
                else:
                    nxt_d, cache, new_index = step(
                        eng.params, torch.as_tensor(tokens, device=dev),
                        cache, torch.as_tensor(index, device=dev),
                        torch.as_tensor(active, device=dev),
                        *eng.step_keys())
                nxt = nxt_d.cpu().numpy().copy()   # waits for the step
                index = new_index.cpu().numpy().copy()
                if fault_plan is not None:
                    # fault: poison the victims' samples, at the finite
                    # guard's observable surface (its -1 sentinel; a
                    # verify row: every position)
                    for sid in fault_plan.nonfinite_slots(ticks, ready):
                        nxt[sid] = -1
            elif clock == "wall" and dev.type == "cuda":
                torch.cuda.synchronize(dev)      # charge chunk time here
            ticks += 1
            occupancy.append(pool.active_count)
            held = {}
            for s in pool.active_slots():
                held[s.priority] = held.get(s.priority, 0) + 1
                occ_by_class.setdefault(s.priority, [0] * (ticks - 1))
            for c, occ in occ_by_class.items():
                occ.append(held.get(c, 0))
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
            # 6) host bookkeeping: audit torn rows, teacher-force prefill,
            #    collect samples, retire finished slots for immediate reuse
            for sid in torn:
                # the torn row sent this tick's K/V write to trash and
                # attended garbage: the slot's device state can no longer
                # be trusted, so the tenant is rebuilt from scratch by
                # preemption (exact resume keeps its output bit for bit)
                st = pool.slots[sid]
                if st.active:                    # not retired by fail()
                    torn_repaired += 1
                    preempt(st)
            for st in pool.active_slots():
                if drop_missed_deadlines and now > st.deadline_s:
                    dropped += 1
                    retire(st, "dropped")
                    continue
                if st.chunk_left > 0:              # mid-chunk: no sample
                    continue
                if spec_k:
                    emit_dispatches += commit_verified(st, nxt[st.sid])
                    continue
                st.pos += 1
                if paged:
                    register_blocks(st)
                if st.pos < len(st.prompt):        # still prefilling
                    tokens[st.sid, 0] = st.prompt[st.pos]
                    continue
                tok = int(nxt[st.sid])
                if tok < 0:
                    recover_nonfinite(st)
                    continue
                st.generated.append(tok)
                gen_tokens += 1
                emit_dispatches += 1
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
                    retire_queued(req, "unfinished", -1.0)
                sched.pending.clear()
                i = len(reqs)
                break

        return DispatchOutcome(
            results=results, occupancy=occupancy,
            occ_by_class=occ_by_class, ticks=ticks,
            gen_tokens=gen_tokens, emit_dispatches=emit_dispatches,
            admissions_while_busy=admissions_while_busy, dropped=dropped,
            failed=failed, unfinished=unfinished, nonfinite=nonfinite,
            preempted=preempted, dispatch_retries=dispatch_retries,
            torn_repaired=torn_repaired, resumed_tokens=resumed_tokens,
            stuck_ticks=wd.slow_steps if wd is not None else 0,
            kv_bytes=sum(t.numel() * t.element_size()
                         for t in cache.values()),
            shared_hits=shared_hits, skipped_tokens=skipped_tokens,
            blocks_demanded=blocks_demanded, peak_used=peak_used,
            util_sum=util_sum,
            leaked_blocks=((eng.num_blocks - 1) - bpool.free_blocks
                           if paged else 0), now=now,
            wall=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# source-embedding validation / padding (families that prime)
# ---------------------------------------------------------------------------

def validate_source(cfg: ArchConfig, req: EngineRequest) -> np.ndarray:
    """The request's source as f32 (src_len, d_model), after the
    reference's host-side checks: present, two-dimensional of width
    d_model, and 0 < src_len <= the static source length."""
    smax = R.source_len(cfg)
    if req.source is None:
        raise ValueError(
            f"request {req.rid}: {cfg.family!r} serves against per-request "
            f"source embeddings; EngineRequest.source must be "
            f"(src_len <= {smax}, {cfg.d_model})")
    src = np.asarray(req.source, np.float32)
    if src.ndim != 2 or src.shape[1] != cfg.d_model:
        raise ValueError(
            f"request {req.rid}: source must be (src_len, {cfg.d_model}), "
            f"got {src.shape}")
    n = src.shape[0]
    if not 0 < n <= smax:
        raise ValueError(
            f"request {req.rid}: source length {n} outside (0, {smax}]")
    return src


def padded_source(cfg: ArchConfig, req: EngineRequest
                  ) -> Tuple[torch.Tensor, int]:
    """One request's source padded with zeros to the static prime shape:
    (1, source_len(cfg), d_model) bf16 on the host, and the count of real
    positions.  The engine's prime dispatch and the sequential reference
    both prime with it, so their inputs are the same bytes."""
    src = validate_source(cfg, req)
    n = src.shape[0]
    buf = np.zeros((1, R.source_len(cfg), cfg.d_model), np.float32)
    buf[0, :n] = src
    return torch.from_numpy(buf).to(torch.bfloat16), n
