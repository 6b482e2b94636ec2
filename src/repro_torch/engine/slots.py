"""Slot pool bookkeeping for the continuous-batching engine.

Pure host-side state (no torch): which slot serves which request, how far
each request has advanced, what it has generated.  The device-side cache
row `sid` belongs to whichever request currently owns slot `sid` — its
positional KV, its recurrent state, and (encdec/vlm) its primed
cross-attention K/V row.  A freed slot is reusable immediately: per-row
masking (positional KV reads stop at the slot's own frontier, cross
reads at the row's primed ``xlen``), the recurrent families' reset-at-
position-0 rule, and the prime dispatch overwriting the whole cross row
at the next admission make stale cache contents invisible, so there is
nothing to scrub between tenants.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


class RequestTooLong(ValueError):
    """Typed admission rejection: the request cannot fit the cache
    (prompt + max_new exceeds ``max_seq``, or needs more KV blocks than
    the whole pool holds).  Raised at validation/admission time so an
    oversized request can never silently overrun a slot row."""


@dataclasses.dataclass
class SlotState:
    """One slot's tenancy: the request it serves and its progress.

    ``model`` is the slot's model-lane tag (None on a single-model
    engine): stamped at pool construction, never per-request — a pool
    belongs to exactly one lane, so a slot can never be re-tagged to
    another model's cache rows (decode-contract rule 8)."""
    sid: int
    model: Optional[str] = None
    rid: int = -1
    prompt: Tuple[int, ...] = ()
    max_new: int = 0
    pos: int = 0                      # tokens fed so far (prompt + generated)
    chunk_left: int = 0               # prompt tokens still owed to the
                                      # chunked-prefill step (0 = rides the
                                      # fused slot step)
    generated: Optional[List[int]] = None
    arrival_s: float = 0.0
    admit_s: float = 0.0
    deadline_s: float = float("inf")
    first_token_s: float = -1.0
    # paged KV cache (engine with block_size set): the physical block ids
    # this slot's logical positions map to (entry j covers positions
    # [j*block_size, (j+1)*block_size)), the request's prefix hash-chain
    # keys, and how many leading keys are registered for sharing
    block_table: Optional[List[int]] = None
    prompt_keys: Tuple = ()
    registered: int = 0
    # overload robustness: the request's SLO class, how many times this
    # tenancy's dispatch has been retried after an injected/real fault,
    # and how many times the request has been preempted so far
    priority: str = "interactive"
    retries: int = 0
    preemptions: int = 0
    # speculative decoding: how many tokens of the COMMITTED fed history
    # the draft model's cache has consumed (the draft-position frontier).
    # Always <= pos; the engine teacher-forces the gap through the draft
    # before proposing, which is also what rebuilds the draft after a
    # preemption/resume or slot reuse (alloc resets it to 0).
    draft_pos: int = 0

    @property
    def active(self) -> bool:
        return self.rid >= 0

    @property
    def in_prefill(self) -> bool:
        return self.active and self.pos < len(self.prompt)

    def next_input(self) -> int:
        """Token to feed this tick: prompt (teacher-forced) or last sample."""
        if self.pos < len(self.prompt):
            return self.prompt[self.pos]
        return self.generated[-1]

    def done(self) -> bool:
        return self.active and len(self.generated) >= self.max_new


class SlotPool:
    """Fixed pool of ``num_slots`` KV-cache slots: alloc on admission,
    free on retirement, reuse immediately.

    ``max_seq`` (when given) is the slot row's capacity in cache
    positions: ``alloc`` rejects any request whose ``prompt + max_new``
    would overrun it with the typed :class:`RequestTooLong`, so the
    admission layer cannot hand a slot to a request the device cache
    cannot hold."""

    def __init__(self, num_slots: int, max_seq: Optional[int] = None,
                 model: Optional[str] = None):
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.model = model               # lane tag; None = single-model
        self.slots = [SlotState(sid=i, model=model)
                      for i in range(num_slots)]
        self._free = list(range(num_slots - 1, -1, -1))   # pop() -> slot 0 first

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.num_slots - len(self._free)

    def active_slots(self) -> List[SlotState]:
        return [s for s in self.slots if s.active]

    def alloc(self, rid: int, prompt: Tuple[int, ...], max_new: int, *,
              now: float, arrival_s: float,
              deadline_s: float = float("inf"),
              priority: str = "interactive") -> SlotState:
        if not self._free:
            raise RuntimeError("no free slot (admission must respect "
                               "free_count)")
        if not prompt:
            raise ValueError(f"request {rid}: empty prompt")
        if self.max_seq is not None and len(prompt) + max_new > self.max_seq:
            raise RequestTooLong(
                f"request {rid} needs {len(prompt) + max_new} cache "
                f"positions > max_seq={self.max_seq}")
        st = self.slots[self._free.pop()]
        st.rid, st.prompt, st.max_new = rid, tuple(prompt), max_new
        st.pos, st.chunk_left, st.generated = 0, 0, []
        st.arrival_s, st.admit_s, st.deadline_s = arrival_s, now, deadline_s
        st.first_token_s = -1.0
        st.block_table, st.prompt_keys, st.registered = None, (), 0
        st.priority, st.retries, st.preemptions = priority, 0, 0
        st.draft_pos = 0
        return st

    def free(self, sid: int) -> None:
        st = self.slots[sid]
        assert st.active, sid
        st.rid = -1
        st.prompt, st.generated = (), None
        self._free.append(sid)


class BlockPool:
    """Fixed pool of physical KV blocks for the paged cache: a free list,
    per-block refcounts, and a prefix-hash registry for shared blocks.

    Block 0 is the reserved *trash* block: it is never allocated, every
    unallocated/inactive table entry points at it, so inactive rows'
    per-tick scatter-writes land there harmlessly, and reads never see
    it because attention masks positions past each row's own frontier.

    Sharing is copy-on-extend: a registered block is immutable (its
    logical positions hold a fully-written prompt-prefix block, keyed by
    the exact token chain that produced it), extra refs only ever read
    it, and each tenant's own writes always land in privately allocated
    blocks.  ``alloc`` therefore never hands out a block whose refcount
    is nonzero, and ``release`` drops the hash entry the moment the last
    ref goes away so a recycled block can never be found by lookup."""

    def __init__(self, num_blocks: int, block_size: int,
                 model: Optional[str] = None):
        self.model = model               # lane tag; None = single-model.
        # A BlockPool belongs to exactly one model lane: its free list,
        # refcounts, and prefix-hash registry are all lane-private, so
        # paged sharing can never cross models — no key collision or
        # refcount bug could hand one model another model's block.
        if num_blocks < 2:
            raise ValueError(f"num_blocks must be >= 2 (block 0 is the "
                             f"reserved trash block), got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.refcounts = [0] * num_blocks
        self._free = list(range(num_blocks - 1, 0, -1))   # pop() -> block 1
        self._hash_to_block: Dict[Any, int] = {}
        self._block_to_hash: Dict[int, Any] = {}

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    def alloc(self) -> int:
        """Take a private block (refcount 0 -> 1)."""
        if not self._free:
            raise RuntimeError("KV block pool exhausted (admission must "
                               "respect free_blocks)")
        bid = self._free.pop()
        assert self.refcounts[bid] == 0, bid
        self.refcounts[bid] = 1
        return bid

    def ref(self, bid: int) -> None:
        """Add a ref to a live block (shared-prefix hit)."""
        if bid <= 0 or self.refcounts[bid] <= 0:
            raise RuntimeError(f"ref on dead block {bid}")
        self.refcounts[bid] += 1

    def release(self, bid: int) -> None:
        """Drop one ref; the last ref frees the block and evicts its
        hash entry so no future lookup can alias the recycled block."""
        if bid <= 0 or self.refcounts[bid] <= 0:
            raise RuntimeError(f"release on dead block {bid} "
                               f"(refcount must never go negative)")
        self.refcounts[bid] -= 1
        if self.refcounts[bid] == 0:
            key = self._block_to_hash.pop(bid, None)
            if key is not None:
                del self._hash_to_block[key]
            self._free.append(bid)

    def register(self, key: Any, bid: int) -> None:
        """Publish a fully-written prompt block for prefix sharing."""
        if self.refcounts[bid] <= 0:
            raise RuntimeError(f"register of dead block {bid}")
        if key not in self._hash_to_block:
            self._hash_to_block[key] = bid
            self._block_to_hash[bid] = key

    def lookup(self, key: Any) -> Optional[int]:
        return self._hash_to_block.get(key)
