"""Dispatch core: the tick loop behind the Engine's policy face.

The port of ``repro/engine/dispatch.py``: a loop over model lanes
(:class:`_Lane`; a single-model engine is one lane tagged None), greedy
or sampled (the tick passes the engine's key to a sampled step), on
contiguous slots or on the paged KV cache, with the reference's overload
paths (SLO-class quotas, preemption with exact resume, fault injection
and recovery), its speculative decoding (a draft proposes, one verify
step scores, the host commits the accepted run and rewinds the rest),
its prime dispatch (encdec, vlm: a request's encoder runs, or its
patches are projected, once at admission and again at every resume,
writing the slot's cross k/v row) and its multiplexing (several models
as lanes of one engine, sharing one lease budget of slots, each with its
own steps, caches and pools; hot-swap admits and retires lanes on a
live serve):

- ``Engine`` (engine.py) — policy + reporting: request validation,
  admission policy and lane configuration, and ``EngineReport``
  assembly.
- ``DispatchCore`` (this module) — mechanism: the tick loop and slot
  accounting.  It returns raw counters (:class:`DispatchOutcome`).
- ``ExecutorBackend`` — the narrow seam the core runs device steps
  through; :class:`SingleDeviceExecutor` is the one-card step set.

Paged mode (``Engine(block_size=...)``) adds a :class:`BlockPool` of
physical KV blocks a lane behind per-slot block tables: refcounted
sharing of whole prompt-prefix blocks (a hit skips their prefill
outright), block-cost admission against the lane's free blocks, and a
host mirror of the tables pushed to the card when it changed.  Its
prefix keys are the token chain, seeded with the request's source bytes
for a family that primes and with the lane's tag on a multiplexed
engine.

Not ported yet, and refused with an error naming its ROADMAP item where
a caller asks for it: the sharded executor (queue 1, item 14).
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

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
    # multiplexing: the tag of the lane that serves the request (a key of
    # Engine(models={...}); None on a single-model engine).  Quotas then
    # meter (model, class), model and class keys
    model: Optional[str] = None


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
    # "unfinished" (still in flight when the tick cap hit), "refused"
    # (its lane was retired, or not admitted, when admission reached it)
    status: str = "ok"
    priority: str = "interactive"
    preemptions: int = 0              # times evicted + exactly resumed
    deadline_s: float = float("inf")
    shared_blocks: int = 0            # paged: prefix blocks it reused
    model: Optional[str] = None       # the lane that served it

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


class _Lane:
    """One model on the engine: its config and weights, its device caches
    and its serve-time host state (slot pool, block pool and its table
    mirror, token and index mirrors, the tick's dispatch scratch), with
    the steps the engine's backend hands out for its config.

    A single-model engine is one lane tagged ``None``; ``Engine(models=
    {tag: (cfg, params)})`` holds one lane a tag.  No tensor of one lane
    is an input to another lane's step, and each lane's block pool is its
    own, so prefix sharing cannot cross models (its prefix keys are
    seeded with its tag as well).

    The device caches are built at their first serve and zeroed in place
    at every later one (:meth:`zeroed_cache`): the captured steps stay
    bound to those tensors from serve to serve."""

    def __init__(self, eng, tag: Optional[str], order: int,
                 cfg: ArchConfig, params, spec_k: int,
                 dcfg: Optional[ArchConfig], dparams):
        self.eng = eng
        self.tag = tag
        self.order = order                 # fault ids: order * S + sid
        self.cfg, self.params = cfg, params
        self.spec_k = spec_k               # 0 on a lane that cannot draft
        self.dcfg, self.dparams = dcfg, dparams
        # hot-swap: a retiring lane finishes its in-flight slots while
        # admission refuses new requests for it; epoch counts the
        # admissions on a live engine (0: at construction)
        self.retiring = False
        self.epoch = 0
        self._cache: Optional[dict] = None
        self._draft_cache: Optional[dict] = None

    def zeroed_cache(self) -> dict:
        """The lane's KV cache (paged: with its block tables), all zeros:
        built at the first call, zeroed in place at every later one —
        byte for byte a fresh cache, in the same tensors, which the
        captured steps stay bound to from one run to the next."""
        eng = self.eng
        with torch.inference_mode():
            if self._cache is None:
                S, dev = eng.num_slots, eng.device
                if eng.block_size:
                    self._cache = R.init_paged_cache(
                        self.cfg, S, eng.max_seq, eng.block_size,
                        eng.num_blocks, device=dev)
                else:
                    self._cache = R.init_cache(self.cfg, S, eng.max_seq,
                                               device=dev)
            else:
                for t in self._cache.values():
                    t.zero_()
        return self._cache

    def zeroed_draft_cache(self) -> dict:
        """The draft model's cache (a speculating lane), all zeros, as
        :meth:`zeroed_cache`: contiguous rows of ``draft_seq``
        positions."""
        eng = self.eng
        with torch.inference_mode():
            if self._draft_cache is None:
                self._draft_cache = R.init_cache(
                    self.dcfg, eng.num_slots, eng.draft_seq,
                    device=eng.device)
            else:
                for t in self._draft_cache.values():
                    t.zero_()
        return self._draft_cache

    def chunk_step(self, c: int, cfg: Optional[ArchConfig] = None
                   ) -> Callable:
        """The chunk step for bucket ``c``: the lane's, or its draft's."""
        cfg = cfg or self.cfg
        if (cfg, c) not in self._chunk_steps:
            self._chunk_steps[cfg, c] = self.eng.backend.chunk_step(
                cfg, mode=self.eng.mode, chunk=c)
        return self._chunk_steps[cfg, c]

    def reset(self) -> None:
        """Fresh host state for a serve, the backend's steps for the
        lane's config, and its caches zeroed in place."""
        eng = self.eng
        S, be, mode = eng.num_slots, eng.backend, eng.mode
        self.pool = SlotPool(S, max_seq=eng.max_seq, model=self.tag)
        self.cache = self.zeroed_cache()
        paged = eng.block_size is not None
        self.bpool = (BlockPool(eng.num_blocks, eng.block_size,
                                model=self.tag) if paged else None)
        self.tables_np = (np.zeros((S, eng.max_blocks), np.int32)
                          if paged else None)
        self.tables_dirty = False
        self.tokens = np.zeros((S, 1), np.int32)
        self.index = np.zeros((S,), np.int32)
        self.step = be.slot_step(self.cfg, mode=mode,
                                 temperature=eng.temperature)
        self.prime = (be.prime_step(self.cfg, mode=mode)
                      if R.needs_prime(self.cfg) else None)
        self._chunk_steps: Dict[Tuple[ArchConfig, int], Callable] = {}
        if self.spec_k:
            k = self.spec_k
            self.verify = be.verify_step(self.cfg, mode=mode, k=k,
                                         temperature=eng.temperature)
            self.propose = be.propose_step(self.dcfg, mode=mode, k=k)
            self.dcache = self.zeroed_draft_cache()
            # per tick: each slot's usable proposals (0 = the slot does
            # not speculate this tick), the draft's proposals, and the
            # verify payload (the next input, then the proposals) with
            # the count of its tokens each row really feeds
            self.krow = np.zeros((S,), np.int32)
            self.props = np.zeros((S, k), np.int32)
            self.tok_mat = np.zeros((S, k + 1), np.int32)
            self.n_tok = np.zeros((S,), np.int32)
        # the tick's dispatch scratch, rebuilt by the core every tick
        self.active = np.zeros((S,), bool)
        self.ready: List[int] = []
        self.torn: List[int] = []
        self.nxt: Optional[np.ndarray] = None


@dataclasses.dataclass
class DispatchOutcome:
    """Raw counters out of one :meth:`DispatchCore.run`."""
    results: List[RequestResult]
    lanes: List[_Lane]                   # every lane the serve ran
    occupancy: List[int]
    occ_by_class: Dict[str, List[int]]   # active slots per class, per tick
    occ_by_lane: Dict[str, List[int]]    # multiplexed: per lane, per tick
    ticks: int = 0
    gen_tokens: int = 0
    # row-ticks that committed >= 1 token: gen_tokens / emit_dispatches
    # is exactly 1.0 without speculation and the mean accepted run plus
    # its bonus sample with it
    emit_dispatches: int = 0
    admissions_while_busy: int = 0
    dropped: int = 0
    refused: int = 0                  # lane retired or never admitted
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
    """The tick loop: (hot-swap control) -> ingest -> (preempt) -> admit
    -> chunk prefill -> (speculating: draft catch-up and propose) ->
    (fault injection) -> one fused slot step, or one verify step, per
    lane with ready slots -> host bookkeeping (and recovery), repeated
    until the trace drains.  One instance per ``serve`` call; each
    lane's pools and host token / index mirrors are built fresh for every
    run, and its device caches are zeroed in place
    (:meth:`_Lane.zeroed_cache`), so the captured steps stay bound to
    them from run to run.

    ``num_slots`` is one lease budget: it caps the active slots of all
    lanes together, while each lane's pool holds ``num_slots`` rows (one
    captured batch shape a lane).  Faults address a slot by its dense
    global id ``lane.order * num_slots + sid``, lane-major, so a
    single-lane engine sees its own slot ids.

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
        # id(source) -> (source, its key seed), for the run: pricing asks
        # for a pending request's keys every tick, and the seed's bytes
        # (6 MB for 1,500 frames) are copied and hashed once a source
        self._source_seeds: Dict[int, Tuple[np.ndarray, Tuple]] = {}

    # -- paged-mode admission helpers (host-side) ----------------------

    def _prefix_keys(self, ln: _Lane, req: EngineRequest) -> Tuple:
        """Exact prefix hash chain, one key per FULL prompt block:
        ``key_j = (key_{j-1}, block_j_tokens)`` — nested tuples compared
        by value, so equal keys mean equal token prefixes (no hash
        collisions by construction).  A family that primes seeds the
        chain with the request's source bytes: its self k/v at any
        position depends on the cross-attended source, so two prefixes
        share only when source and tokens match.  A tagged lane seeds it
        with its tag too: a second wall beside its private block pool."""
        bs = self.eng.block_size
        key: Tuple = ()
        if R.needs_prime(ln.cfg):
            key = self._source_seed(req.source)
        if ln.tag is not None:
            key = (("model", ln.tag), key)
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

    def _usable_hits(self, ln: _Lane, req: EngineRequest,
                     keys: Optional[Tuple] = None) -> int:
        """Leading prompt blocks already resident in the lane's pool
        (registered by an earlier tenant).  Capped at ``(prompt-1) //
        bs``: the LAST prompt token always rides the fused step, and its
        KV write must land in a privately owned block, never a shared
        one."""
        if keys is None:
            keys = self._prefix_keys(ln, req)
        cap = (len(req.prompt) - 1) // self.eng.block_size
        hits = 0
        for j in range(min(cap, len(keys))):
            if ln.bpool.lookup(keys[j]) is None:
                break
            hits += 1
        return hits

    def _block_cost(self, ln: _Lane, req: EngineRequest) -> int:
        """Worst-case FRESH blocks this request claims if admitted now:
        ceil((prompt + max_new) / bs) minus currently shareable prefix
        blocks — what memory-aware admission prices against the pool."""
        bs = self.eng.block_size
        need = -(-(len(req.prompt) + req.max_new_tokens) // bs)
        return need - self._usable_hits(ln, req)

    def run(self, reqs: List[EngineRequest], *, clock: str,
            tick_s: Union[float, Mapping, Callable[[int], float]],
            max_ticks: Optional[int],
            drop_missed_deadlines: bool,
            preemption: bool = False,
            fault_plan: Optional[FaultPlan] = None,
            max_retries: int = 3,
            control: Sequence[Tuple[float, Callable]] = ()
            ) -> DispatchOutcome:
        eng = self.eng
        S = eng.num_slots
        dev = eng.device
        by_rid = {r.rid: r for r in reqs}
        self._source_seeds = {}
        paged = eng.block_size is not None
        lanes = list(eng.lanes.values())
        for ln in lanes:
            ln.reset()
        by_order = {ln.order: ln for ln in lanes}
        # hot-swap control: (time_s, fn(engine)) ops, each run at the
        # first tick boundary its time has passed (Engine.admit_model,
        # Engine.retire_model); lanes only join during a serve
        ctl = sorted(control, key=lambda c: c[0])
        ctl_i = 0
        # a Mapping tick_s prices a tick as the sum of the lanes it
        # dispatched (a chunk, prime, propose, fused or verify step)
        lane_priced = isinstance(tick_s, Mapping)
        shared_hits = skipped_tokens = blocks_demanded = peak_used = 0
        util_sum = 0.0

        sched = SlotScheduler(eng.policy)
        quotas_on = bool(eng.policy.class_quotas)
        key_fn = ((lambda r: (r.model, r.priority)) if eng.multi
                  else None)
        results: List[RequestResult] = []
        occupancy: List[int] = []
        occ_by_class: Dict[str, List[int]] = {}
        occ_by_lane: Dict[str, List[int]] = (
            {ln.tag: [] for ln in lanes} if eng.multi else {})
        admissions_while_busy = dropped = refused = failed = unfinished = 0
        nonfinite = ticks = gen_tokens = emit_dispatches = 0
        # overload state: the stashed progress of preempted requests
        # (rid -> _Stash) and the fault / recovery counters
        stash: Dict[int, _Stash] = {}
        preempted = dispatch_retries = torn_repaired = resumed_tokens = 0
        wd = StepWatchdog(name=eng.name) if clock == "wall" else None

        def total_active() -> int:
            return sum(ln.pool.active_count for ln in lanes)

        def lane_of(req: EngineRequest) -> Optional[_Lane]:
            return eng.lanes.get(req.model)

        def register_blocks(ln, st) -> None:
            # publish each prompt block for prefix sharing the moment the
            # slot's frontier passes its end (its KV writes are already
            # issued in stream order, so any later read sees them)
            while (st.registered < len(st.prompt_keys)
                   and st.pos >= (st.registered + 1) * eng.block_size):
                ln.bpool.register(st.prompt_keys[st.registered],
                                  st.block_table[st.registered])
                st.registered += 1

        def release_blocks(ln, st) -> None:
            for bid in st.block_table:
                ln.bpool.release(bid)
            st.block_table, st.prompt_keys, st.registered = None, (), 0
            ln.tables_np[st.sid, :] = 0      # retired row writes to trash
            ln.tables_dirty = True

        def free_slot(ln, st) -> None:
            if paged and st.block_table is not None:
                release_blocks(ln, st)
            ln.pool.free(st.sid)
            ln.index[st.sid] = 0
            ln.tokens[st.sid, 0] = 0

        hits_of = {}                          # rid -> shared prefix blocks

        def retire(ln, st, status: str) -> None:
            results.append(RequestResult(
                rid=st.rid, tokens=list(st.generated or []),
                arrival_s=st.arrival_s, admit_s=st.admit_s,
                first_token_s=st.first_token_s, finish_s=now, slot=st.sid,
                dropped=status == "dropped", status=status,
                priority=st.priority, preemptions=st.preemptions,
                deadline_s=st.deadline_s,
                shared_blocks=hits_of.get(st.rid, 0), model=ln.tag))
            free_slot(ln, st)

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
                deadline_s=req.deadline_s, model=req.model))

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
            # a request for a lane not admitted (yet) claims nothing: it
            # is refused when admission reaches it
            ln = lane_of(req)
            return self._block_cost(ln, eff_req(req)) if ln else 0

        def preempt(ln, st) -> None:
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
            free_slot(ln, st)
            sched.push(by_rid[rid])

        def fail(ln, st) -> None:
            """Retire a slot fault recovery gave up on."""
            nonlocal failed
            failed += 1
            retire(ln, st, "failed")

        def scrub(ln, st) -> None:
            # the tick that sampled non-finite logits wrote its non-finite
            # K/V at the slot's frontier: zero the slot's private rows in
            # place, so that a later tenant's reads past its own frontier
            # (masked to a zero weight, and 0 * NaN is NaN) never meet
            # them, and the slot's row of every slot-resident leaf (the
            # resume re-primes it).  Shared prefix blocks were written by
            # clean chunks.
            blocks = (R.paged_block_axes(ln.cfg, ln.cache) if paged else {})
            axes = R.cache_batch_axes(ln.cfg, ln.cache)
            for name, t in ln.cache.items():
                if name == "block_tables":
                    continue
                if name in blocks:
                    axis = blocks[name]
                    rows = [b for b in st.block_table
                            if ln.bpool.refcounts[b] == 1]
                else:
                    axis, rows = axes[name], [st.sid]
                t[(slice(None),) * axis + (rows,)] = 0

        def recover_nonfinite(ln, st) -> None:
            # the finite guard's sentinel: this row's logits went NaN/Inf.
            # The sample is garbage and the cache row suspect: rebuild the
            # slot by preemption (a transient fault recomputes clean, bit
            # for bit); a slot that keeps faulting exhausts its retries
            # and fails
            nonlocal nonfinite
            nonfinite += 1
            scrub(ln, st)
            st.retries += 1
            if st.retries > max_retries:
                fail(ln, st)
            else:
                preempt(ln, st)

        def commit_verified(ln, st, row) -> int:
            """The speculative commit of one verified row: walk its fed
            positions, keeping the accepted proposals and the bonus
            sample after the last, then rewind the row's index to its
            committed frontier.  Returns 1 when the row committed a
            token (an emitting dispatch), else 0."""
            nonlocal gen_tokens
            nt = int(ln.n_tok[st.sid])
            if (row[:nt] < 0).any():
                # a sentinel anywhere in the fed range poisons the whole
                # round: the proposals in flight are uncommitted state, so
                # recovery rebuilds from the last committed token, as in
                # the non-speculative engine
                recover_nonfinite(ln, st)
                return 0
            pos0, committed = st.pos, 0
            for j in range(nt):
                st.pos += 1
                if paged:
                    register_blocks(ln, st)
                if st.pos < len(st.prompt):        # still prefilling
                    ln.tokens[st.sid, 0] = st.prompt[st.pos]
                    break
                tok = int(row[j])
                st.generated.append(tok)
                gen_tokens += 1
                committed += 1
                if st.first_token_s < 0:
                    st.first_token_s = now
                if st.done() or (j + 1 < nt
                                 and tok != int(ln.tok_mat[st.sid, j + 1])):
                    break
            ln.index[st.sid] = st.pos        # the rewind past rejections
            if committed and ln.krow[st.sid] > 0:
                # the draft consumed [next input, d_1 .. d_{k-1}]; its
                # committed-valid prefix is 1 + the accepted count
                # (capped at k - 1)
                st.draft_pos = pos0 + 1 + min(committed - 1, ln.spec_k - 1)
            if st.done():
                retire(ln, st, "ok")
            elif committed:
                ln.tokens[st.sid, 0] = st.generated[-1]
            return int(committed > 0)

        i, now = 0, 0.0
        t0 = time.perf_counter()
        limit = max_ticks if max_ticks is not None else \
            (sum(len(r.prompt) + r.max_new_tokens for r in reqs) + 16) * 4

        while (i < len(reqs) or sched.pending or total_active()
               or ctl_i < len(ctl)):
            # 0) hot-swap control: run every op the clock has passed; a
            #    lane one admits joins the run (appended, so the global
            #    ids of the others stay as they were)
            while ctl_i < len(ctl) and ctl[ctl_i][0] <= now:
                ctl[ctl_i][1](eng)
                ctl_i += 1
                for ln in eng.lanes.values():
                    if ln.order not in by_order:
                        ln.reset()
                        by_order[ln.order] = ln
                        lanes.append(ln)
                        if eng.multi:
                            occ_by_lane.setdefault(ln.tag,
                                                   [0] * len(occupancy))
            if i >= len(reqs) and not sched.pending and not total_active():
                if ctl_i >= len(ctl):
                    break
                now = max(now, ctl[ctl_i][0])
                continue
            # 1) ingest everything that has arrived by `now`
            while i < len(reqs) and reqs[i].arrival_s <= now:
                sched.push(reqs[i])
                i += 1
            next_arrival = reqs[i].arrival_s if i < len(reqs) else None
            tick_lanes = set()                # lanes dispatched this tick
            # 2) admit into free slot leases — mid-flight, no drain barrier
            generating = any(s.active and not s.in_prefill
                             for ln in lanes for s in ln.pool.slots)
            if preemption and sched.pending:
                # slot or block pressure and a pending head of strictly
                # higher class: evict the lowest-class slot (latest
                # deadline first) until the head fits or no victim of a
                # lower class is left; equal classes never preempt, so
                # batch cannot thrash batch.  A lease freed in any lane
                # relieves slot pressure; block pressure only a victim in
                # the head's own lane (block pools are per lane)
                head = sched.pending[0]
                lane_h = lane_of(head)
                if lane_h is not None and not lane_h.retiring:
                    hrank = bt.priority_rank(head.priority)
                    for _ in range(S * len(lanes)):
                        slot_pressed = total_active() >= S
                        block_pressed = (
                            paged and self._block_cost(lane_h, eff_req(head))
                            > lane_h.bpool.free_blocks)
                        if not (slot_pressed or block_pressed):
                            break
                        victims = [(ln, s) for ln in
                                   (lanes if slot_pressed else [lane_h])
                                   for s in ln.pool.active_slots()
                                   if bt.priority_rank(s.priority) > hrank]
                        if not victims:
                            break
                        preempt(*max(victims, key=lambda v: (
                            bt.priority_rank(v[1].priority),
                            v[1].deadline_s, v[0].order, v[1].sid)))
            abc = None
            if quotas_on or eng.multi:
                # the quotas' denominators: the slots each key holds; on a
                # multiplexed engine a slot charges its (model, class)
                # key and the bare model and class keys
                abc = {}
                for ln in lanes:
                    for s in ln.pool.active_slots():
                        for k in (((ln.tag, s.priority), ln.tag, s.priority)
                                  if eng.multi else (s.priority,)):
                            abc[k] = abc.get(k, 0) + 1
            budget = None
            if paged:
                budget = ({ln.tag: ln.bpool.free_blocks for ln in lanes}
                          if eng.multi else lanes[0].bpool.free_blocks)
            cohort = sched.admit(
                now, S - total_active(), next_arrival,
                cost_fn=block_cost if paged else None, budget=budget,
                active_by_class=abc, key_fn=key_fn)
            admitted = 0
            for req in cohort:
                ln = lane_of(req)
                if ln is None or ln.retiring:
                    # hot-swap: the lane was retired, or is not admitted
                    # (yet); its in-flight slots go on, nothing new enters
                    retire_queued(req, "refused", -1.0)
                    refused += 1
                    continue
                if drop_missed_deadlines and now > req.deadline_s:
                    # expired while queued: retire without taking a slot
                    # (a preempted request keeps what it had generated)
                    retire_queued(req, "dropped", now)
                    dropped += 1
                    continue
                admitted += 1
                s_res = stash.get(req.rid)
                eff = eff_req(req)
                st = ln.pool.alloc(req.rid, eff.prompt, eff.max_new_tokens,
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
                    keys = self._prefix_keys(ln, eff)
                    hits = self._usable_hits(ln, eff, keys)
                    need = -(-(len(eff.prompt) + eff.max_new_tokens)
                             // eng.block_size)
                    table = []
                    for j in range(hits):
                        bid = ln.bpool.lookup(keys[j])
                        ln.bpool.ref(bid)
                        table.append(bid)
                    for _ in range(need - hits):
                        table.append(ln.bpool.alloc())
                    st.block_table = table
                    st.prompt_keys = keys
                    st.registered = hits
                    st.pos = hits * eng.block_size
                    ln.tables_np[st.sid, :] = 0
                    ln.tables_np[st.sid, :len(table)] = table
                    ln.tables_dirty = True
                    hits_of[req.rid] = hits
                    shared_hits += hits
                    skipped_tokens += hits * eng.block_size
                    blocks_demanded += need
                if ln.prime is not None:
                    # prime dispatch: write the slot's cross k/v row and
                    # its xlen frontier once, between other slots' ticks
                    # (a resume re-primes: rebuilt, never trusted)
                    src, n_valid = padded_source(ln.cfg, req)
                    ln.cache = ln.prime(ln.params, src, ln.cache, st.sid,
                                        n_valid)
                    tick_lanes.add(ln.tag)
                if s_res is not None:
                    resumed_tokens += len(st.prompt) - st.pos
                ln.index[st.sid] = st.pos
                left = len(st.prompt) - 1 - st.pos
                if eng.prefill_chunk and left > 0:
                    # all but the last prompt token (less any shared
                    # prefix already resident) go through chunked
                    # prefill; the last rides the fused step (its sample
                    # is the first output token)
                    st.chunk_left = left
                else:
                    ln.tokens[st.sid, 0] = st.next_input()
            if generating:
                admissions_while_busy += admitted
            for ln in lanes:
                if ln.tables_dirty:
                    # push the host table mirror before any dispatch this
                    # tick writes or reads through it, in place: the
                    # captured steps stay bound to the cache's tensors
                    ln.cache["block_tables"].copy_(
                        torch.from_numpy(ln.tables_np))
                    ln.tables_dirty = False
            # 3) idle: nothing active -> jump to the next event (an
            #    arrival or a control op)
            if total_active() == 0:
                nxt_ctl = ctl[ctl_i][0] if ctl_i < len(ctl) else None
                if (next_arrival is None and not sched.pending
                        and nxt_ctl is None):
                    break
                if (next_arrival is None and not cohort
                        and nxt_ctl is None and sched.pending):
                    raise RuntimeError(
                        "admission declined a non-empty pending queue "
                        f"({len(sched.pending)} requests) with an idle "
                        "pool and no future arrival; check the policy "
                        "/ class_quotas configuration")
                target = next_arrival if next_arrival is not None else now
                if nxt_ctl is not None:
                    target = (min(target, nxt_ctl)
                              if next_arrival is not None else nxt_ctl)
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
            for ln in lanes:
                for st in ln.pool.active_slots():
                    if st.chunk_left <= 0:
                        continue
                    n = min(st.chunk_left, eng.prefill_chunk)
                    c = ST.bucket_batch(n)
                    buf = np.zeros((c,), np.int32)
                    buf[:n] = st.prompt[st.pos:st.pos + n]
                    ln.cache = ln.chunk_step(c)(ln.params, buf, ln.cache,
                                                st.sid, st.pos, n)
                    st.pos += n
                    st.chunk_left -= n
                    ln.index[st.sid] = st.pos
                    tick_lanes.add(ln.tag)
                    if paged:
                        register_blocks(ln, st)
                    if st.chunk_left == 0:
                        ln.tokens[st.sid, 0] = st.prompt[st.pos]
            for ln in lanes:
                if not ln.spec_k:
                    continue
                # 4.5) speculative draft: catch each generating slot's
                #      draft cache up to its committed frontier (teacher-
                #      forced through the draft's chunk steps: this also
                #      rebuilds the draft after admission, a resume or a
                #      slot's reuse), then propose spec_k greedy tokens for
                #      every such slot in one propose step.  Draft steps
                #      see no fault injection: a wrong proposal can only
                #      be rejected.
                ln.krow[:] = 0
                for st in ln.pool.active_slots():
                    if st.chunk_left > 0 or st.pos < len(st.prompt) - 1:
                        continue
                    k_row = min(ln.spec_k, st.max_new - len(st.generated) - 1,
                                eng.max_seq - 1 - st.pos)
                    if k_row <= 0:
                        continue
                    ln.krow[st.sid] = k_row
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
                        ln.dcache = ln.chunk_step(c, ln.dcfg)(
                            ln.dparams, buf, ln.dcache, st.sid,
                            st.draft_pos, n)
                        st.draft_pos += n
                d_active = ln.krow > 0
                if d_active.any():
                    d_index = np.array([s.draft_pos for s in ln.pool.slots],
                                       np.int32)
                    props_d, ln.dcache, _ = ln.propose(
                        ln.dparams, torch.as_tensor(ln.tokens, device=dev),
                        ln.dcache, torch.as_tensor(d_index, device=dev),
                        torch.as_tensor(d_active, device=dev))
                    ln.props = props_d.cpu().numpy().copy()
                    tick_lanes.add(ln.tag)
            # 5) one fused slot-masked step a lane with ready slots: every
            #    ready slot, one token (speculating: one verify step,
            #    1 + krow tokens a row)
            all_ready: List[int] = []          # global ids, lane-major
            for ln in lanes:
                ln.active = np.array([s.active and s.chunk_left == 0
                                      for s in ln.pool.slots], bool)
                ln.ready = [int(s) for s in np.where(ln.active)[0]]
                ln.torn = []
                ln.nxt = None
                all_ready.extend(ln.order * S + sid for sid in ln.ready)
            if fault_plan is not None and paged and all_ready:
                # fault: tear the victims' device table rows (all-trash)
                # just before the dispatch, IN PLACE — a new tensor would
                # bind the captured tick anew.  The host mirror stays
                # clean: the audit below rebuilds from it, and the mirror
                # is pushed again before the next dispatch.
                for g in fault_plan.torn_rows(ticks, all_ready):
                    by_order[g // S].torn.append(g % S)
                for ln in lanes:
                    if ln.torn:
                        torn_np = ln.tables_np.copy()
                        torn_np[ln.torn, :] = 0
                        ln.cache["block_tables"].copy_(
                            torch.from_numpy(torn_np))
                        ln.tables_dirty = True
            if fault_plan is not None:
                # dispatch faults resolve first, over every lane's ready
                # ids, so a failed attempt launches nothing: each charges
                # the culprit's retry budget, and past max_retries the
                # culprit retires as failed and the retry goes on without
                # it — one poisoned slot never takes down the cohort
                attempt = 0
                while all_ready:
                    culprit = fault_plan.dispatch_fault(ticks, attempt,
                                                        all_ready)
                    if culprit is None:
                        break
                    dispatch_retries += 1
                    attempt += 1
                    ln, sid = by_order[culprit // S], culprit % S
                    st = ln.pool.slots[sid]
                    st.retries += 1
                    if st.retries > max_retries:
                        fail(ln, st)
                        ln.active[sid] = False
                        ln.ready.remove(sid)
                        all_ready.remove(culprit)
            for ln in lanes:
                if not ln.ready:
                    continue
                tick_lanes.add(ln.tag)
                # the captured step's outputs are static buffers that the
                # next tick overwrites: read here, within this tick, and
                # before the rewind below writes the host index
                if ln.spec_k:
                    # the verify payload: each ready row's next input, then
                    # its usable proposals
                    ln.tok_mat[:] = 0
                    ln.tok_mat[:, 0] = ln.tokens[:, 0]
                    for sid in ln.ready:
                        kr = int(ln.krow[sid])
                        ln.tok_mat[sid, 1:1 + kr] = ln.props[sid, :kr]
                    ln.n_tok = np.where(ln.active, 1 + ln.krow,
                                        0).astype(np.int32)
                    nxt_d, ln.cache, new_index = ln.verify(
                        ln.params, torch.as_tensor(ln.tok_mat, device=dev),
                        ln.cache, torch.as_tensor(ln.index, device=dev),
                        torch.as_tensor(ln.n_tok, device=dev),
                        torch.as_tensor(ln.active, device=dev),
                        *eng.step_keys())
                else:
                    nxt_d, ln.cache, new_index = ln.step(
                        ln.params, torch.as_tensor(ln.tokens, device=dev),
                        ln.cache, torch.as_tensor(ln.index, device=dev),
                        torch.as_tensor(ln.active, device=dev),
                        *eng.step_keys())
                ln.nxt = nxt_d.cpu().numpy().copy()   # waits for the step
                ln.index = new_index.cpu().numpy().copy()
            if fault_plan is not None and all_ready:
                # fault: poison the victims' samples, at the finite
                # guard's observable surface (its -1 sentinel; a verify
                # row: every position)
                for g in fault_plan.nonfinite_slots(ticks, all_ready):
                    by_order[g // S].nxt[g % S] = -1
            if not all_ready and clock == "wall" and dev.type == "cuda":
                torch.cuda.synchronize(dev)      # charge chunk time here
            ticks += 1
            tact = total_active()
            occupancy.append(tact)
            held = {}
            for ln in lanes:
                for s in ln.pool.active_slots():
                    held[s.priority] = held.get(s.priority, 0) + 1
                    occ_by_class.setdefault(s.priority, [0] * (ticks - 1))
                if eng.multi:
                    occ_by_lane[ln.tag].append(ln.pool.active_count)
            for c, occ in occ_by_class.items():
                occ.append(held.get(c, 0))
            if paged:
                used = sum(ln.bpool.used_blocks for ln in lanes)
                peak_used = max(peak_used, used)
                util_sum += used / max(1, (eng.num_blocks - 1) * len(lanes))
            if clock == "wall":
                prev = now
                now = time.perf_counter() - t0
                msg = wd.record(now - prev)
                if msg:
                    warnings.warn(f"engine tick {ticks}: {msg}",
                                  RuntimeWarning)
            elif lane_priced:
                # an admission-only tick dispatches nothing and charges
                # the cheapest lane (the clock must still advance)
                vals = [float(tick_s[t]) for t in sorted(
                    tick_lanes, key=lambda x: (x is None, x))]
                now += (sum(vals) if vals
                        else min(float(v) for v in tick_s.values()))
            else:
                now += tick_s(tact) if callable(tick_s) else tick_s
            # 6) host bookkeeping, lane by lane: audit torn rows, teacher-
            #    force prefill, collect samples, retire finished slots for
            #    immediate reuse (by any lane)
            for ln in lanes:
                for sid in ln.torn:
                    # the torn row sent this tick's K/V write to trash and
                    # attended garbage: the slot's device state can no
                    # longer be trusted, so the tenant is rebuilt from
                    # scratch by preemption (exact resume keeps its output
                    # bit for bit)
                    st = ln.pool.slots[sid]
                    if st.active:                # not retired by fail()
                        torn_repaired += 1
                        preempt(ln, st)
                for st in ln.pool.active_slots():
                    if drop_missed_deadlines and now > st.deadline_s:
                        dropped += 1
                        retire(ln, st, "dropped")
                        continue
                    if st.chunk_left > 0:          # mid-chunk: no sample
                        continue
                    if ln.spec_k:
                        emit_dispatches += commit_verified(ln, st,
                                                           ln.nxt[st.sid])
                        continue
                    st.pos += 1
                    if paged:
                        register_blocks(ln, st)
                    if st.pos < len(st.prompt):        # still prefilling
                        ln.tokens[st.sid, 0] = st.prompt[st.pos]
                        continue
                    tok = int(ln.nxt[st.sid])
                    if tok < 0:
                        recover_nonfinite(ln, st)
                        continue
                    st.generated.append(tok)
                    gen_tokens += 1
                    emit_dispatches += 1
                    if st.first_token_s < 0:
                        st.first_token_s = now
                    if st.done():
                        retire(ln, st, "ok")
                    else:
                        ln.tokens[st.sid, 0] = tok
            if ticks > limit:
                warnings.warn(
                    f"engine hit the {limit}-tick cap with "
                    f"{total_active()} active, {len(sched.pending)} "
                    f"pending and {len(reqs) - i} unarrived requests; "
                    "retiring them as 'unfinished'", RuntimeWarning)
                for ln in lanes:
                    for st in ln.pool.active_slots():
                        unfinished += 1
                        retire(ln, st, "unfinished")
                for req in list(sched.pending) + reqs[i:]:
                    unfinished += 1
                    retire_queued(req, "unfinished", -1.0)
                sched.pending.clear()
                i = len(reqs)
                break

        return DispatchOutcome(
            results=results, lanes=lanes, occupancy=occupancy,
            occ_by_class=occ_by_class, occ_by_lane=occ_by_lane,
            ticks=ticks, gen_tokens=gen_tokens,
            emit_dispatches=emit_dispatches,
            admissions_while_busy=admissions_while_busy, dropped=dropped,
            refused=refused, failed=failed, unfinished=unfinished,
            nonfinite=nonfinite, preempted=preempted,
            dispatch_retries=dispatch_retries,
            torn_repaired=torn_repaired, resumed_tokens=resumed_tokens,
            stuck_ticks=wd.slow_steps if wd is not None else 0,
            kv_bytes=sum(t.numel() * t.element_size()
                         for ln in lanes for t in ln.cache.values()),
            shared_hits=shared_hits, skipped_tokens=skipped_tokens,
            blocks_demanded=blocks_demanded, peak_used=peak_used,
            util_sum=util_sum,
            leaked_blocks=(sum((eng.num_blocks - 1) - ln.bpool.free_blocks
                               for ln in lanes) if paged else 0),
            now=now, wall=time.perf_counter() - t0)


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
