"""Serving steps: the prefill step (the full-sequence forward), the decode
step and the multi-token decode loop, the continuous-batching slot tick,
and chunked prefill of one slot — the serving subset of
``repro/runtime/steps.py``.

The ``make_*`` builders run eagerly: the cache is a dict of tensors
updated in place, and each step returns it to keep the reference's
signatures.  The reference's compile boundary, ``jax.jit`` with the cache
donated, is a CUDA graph here (``runtime/graphs.py``): the
``jit_slot_decode_step`` and ``jit_decode_loop`` wrappers capture the
slot tick and the decode loop once over static buffers and the caller's
cache and replay them, bit for bit the eager steps they wrap, and
``cached_slot_decode_step`` memoizes the captured tick as the reference
memoizes its compiled one.  The chunk step and the prefill step stay
eager (ROADMAP queue 1, item 6).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import FP, QuantMode
from repro_torch.models import registry as R
from repro_torch.runtime.graphs import CapturedStep


def make_prefill_step(cfg: ArchConfig, *, mode: QuantMode = FP) -> Callable:
    def prefill_step(params, batch):
        # inference: no remat needed (no backward pass)
        return R.apply_forward(params, cfg, batch, mode=mode, remat=False)
    return prefill_step


def make_decode_step(cfg: ArchConfig, *, mode: QuantMode = FP) -> Callable:
    def decode_step(params, batch, cache, logits: bool = True):
        return R.apply_decode(params, cfg, batch, cache, mode=mode,
                              logits=logits)
    return decode_step


# Static batch-shape ladder: request batches are padded up to one of these
# (the engine's slot pool and prefill chunks are bucketed on it).
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# Hard ceiling of the power-of-two extension past the ladder's end.
MAX_BUCKET = 2048


def bucket_batch(b: int, buckets=BATCH_BUCKETS,
                 max_bucket: int = MAX_BUCKET) -> int:
    """Smallest bucket >= b (powers of two beyond the ladder's end, capped
    at ``max_bucket``).  Raises ValueError past the cap."""
    if b <= 0:
        raise ValueError(f"batch must be positive, got {b}")
    for c in buckets:
        if b <= c:
            return c
    c = buckets[-1]
    while c < b and c < max_bucket:
        c *= 2
    if c < b:
        raise ValueError(
            f"batch {b} exceeds MAX_BUCKET={max_bucket}: the static shape "
            f"ladder is bounded by design — split the batch or raise "
            f"MAX_BUCKET deliberately")
    return c


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Last-position argmax (first index among ties, as ``jnp.argmax``)."""
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


def make_decode_loop(cfg: ArchConfig, *, mode: QuantMode = FP,
                     num_tokens: int, temperature: float = 0.0) -> Callable:
    """Multi-token greedy decode of a lockstep batch.

    Returns ``loop(params, tokens, cache, cache_index) -> (out, cache)``
    with ``tokens`` (B, 1) int32 seed, ``cache_index`` the position of
    the first step, and ``out`` (B, num_tokens) int32 generated tokens;
    the cache is updated in place.  The reference scans the steps inside
    one jit; here they are a Python loop over the same decode step.
    ``cache_index`` is an int, or a device tensor of one or B values (all
    equal: the batch is in lockstep), which runs the decode step's
    per-row form with every row at that place, as the captured loop does
    (:func:`jit_decode_loop`); both forms give the same bits."""
    if temperature > 0.0:
        raise NotImplementedError(
            "temperature sampling is not ported yet (ROADMAP queue 1, "
            "item 10)")
    decode = make_decode_step(cfg, mode=mode)

    def loop(params, tokens, cache, cache_index):
        if isinstance(cache_index, torch.Tensor):
            idx = cache_index.reshape(-1).expand(tokens.shape[0])
        else:
            idx = int(cache_index)
        tok, out = tokens, []
        for _ in range(num_tokens):
            logits, cache = decode(params, {"tokens": tok,
                                            "cache_index": idx}, cache)
            nxt = greedy_sample(logits)
            out.append(nxt)
            tok, idx = nxt[:, None], idx + 1
        return torch.stack(out, dim=1), cache

    return loop


def jit_decode_loop(loop: Callable) -> Callable:
    """A decode loop captured as one CUDA graph over its cache (the
    reference's ``jax.jit`` with the cache donated): ``loop(params,
    tokens, cache, cache_index) -> (out, cache)`` as
    :func:`make_decode_loop`'s, with ``cache_index`` an int or a tensor
    of one or B values.  The start position lives in a static buffer, so
    one graph serves every start; ``out`` is a static buffer that the
    next call overwrites."""
    captured = CapturedStep(
        lambda params, cache, tokens, start: loop(params, tokens, cache,
                                                  start)[:1])

    def graphed(params, tokens, cache, cache_index):
        start = torch.as_tensor(cache_index, dtype=torch.int32).reshape(-1)
        out, = captured(params, cache, tokens, start)
        return out, cache

    graphed.captured = captured
    return graphed


def make_slot_decode_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                          temperature: float = 0.0) -> Callable:
    """One tick of the continuous-batching engine: advance EVERY slot of
    the pool by one token.

    Returns ``step(params, tokens, cache, slot_index, active) ->
    (next_tokens, cache, slot_index)`` with ``tokens`` (S, 1) int32,
    ``slot_index`` (S,) int32 per-slot positions and ``active`` (S,) bool.
    Inactive rows emit 0 and keep their index; a row whose logits hold a
    NaN/Inf emits the sentinel -1.  Inactive rows still write their k/v at
    their frozen index, which no read can see (every read is masked at the
    row's own frontier); on a paged cache they write through their table,
    into trash block 0 once the row is retired."""
    if temperature > 0.0:
        raise NotImplementedError(
            "temperature sampling is not ported yet (ROADMAP queue 1, "
            "item 10)")
    decode = make_decode_step(cfg, mode=mode)

    def step(params, tokens, cache, slot_index, active):
        logits, cache = decode(
            params, {"tokens": tokens, "cache_index": slot_index}, cache)
        cache = R.mask_inactive_slots(cfg, cache, cache, active)
        nxt = greedy_sample(logits)
        finite = torch.isfinite(logits[:, -1].float()).all(dim=-1)
        nxt = torch.where(finite, nxt, torch.full_like(nxt, -1))
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        return nxt, cache, slot_index + active.to(slot_index.dtype)

    return step


def jit_slot_decode_step(step: Callable) -> Callable:
    """A slot tick captured as one CUDA graph over its cache (the
    reference's ``jax.jit`` with the cache donated): ``step(params,
    tokens, cache, slot_index, active) -> (next_tokens, cache,
    slot_index)`` as :func:`make_slot_decode_step`'s.  ``next_tokens``
    and the new ``slot_index`` are static buffers that the next call
    overwrites; a paged cache's ``block_tables`` is read where it lies, so
    the caller updates it in place."""
    def body(params, cache, tokens, slot_index, active):
        nxt, _, new_index = step(params, tokens, cache, slot_index, active)
        return nxt, new_index

    captured = CapturedStep(body)

    def graphed(params, tokens, cache, slot_index, active):
        nxt, new_index = captured(params, cache, tokens, slot_index, active)
        return nxt, cache, new_index

    graphed.captured = captured
    return graphed


def make_prefill_chunk_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                            chunk: int) -> Callable:
    """Chunked prefill for ONE slot of the pool: write up to ``chunk``
    teacher-forced prompt tokens of KV state in one step.

    Returns ``step(params, tokens, cache, sid, start, n_valid) -> cache``
    with ``tokens`` (chunk,) int32, ``sid`` the slot row, ``start`` its
    current frontier and ``n_valid`` how many of the tokens are real.  The
    step runs the SAME per-token decode step as the slot tick and the
    sequential reference (batch 1, lockstep index) on a view of the slot's
    cache row, so the written bytes are the per-token path's.  Padding
    tokens past ``n_valid`` are never run, which leaves the cache exactly
    as unpadded prefill would.

    Paged cache: the step runs on the physical pool itself with the
    slot's table row as a (1, MB) table, and writes only positions
    ``start .. start + n_valid - 1``, which lie in blocks the slot owns
    privately — a shared prefix block is never written.  (The reference
    gathers the row into a contiguous view and scatters every block back,
    which keeps its CPU path byte-identical under a functional update.)"""
    decode = make_decode_step(cfg, mode=mode)

    def step(params, tokens, cache, sid: int, start: int, n_valid: int):
        if len(tokens) != chunk:
            raise ValueError(f"chunk step of {chunk} got {len(tokens)} "
                             f"tokens")
        sid = int(sid)
        if "block_tables" in cache:
            row = dict(cache, block_tables=cache["block_tables"][sid:sid + 1])
        else:
            axes = R.cache_batch_axes(cfg, cache)
            row = {k: v.narrow(axes[k], sid, 1) for k, v in cache.items()}
        toks = torch.as_tensor(tokens, dtype=torch.int32,
                               device=cache["k"].device)
        for i in range(int(n_valid)):
            decode(params, {"tokens": toks[i:i + 1].reshape(1, 1),
                            "cache_index": int(start) + i},
                   row, logits=False)
        return cache

    return step


# Process-wide memo of the captured steps, keyed as the reference's
# (``repro/runtime/steps.py`` ``_STEP_CACHE``) on the step's
# specialization: engines over one config share one captured step.  A
# captured step holds ONE graph, bound to the params and cache it last
# ran on, so engines that take turns on one step capture anew at their
# first tick.
_STEP_CACHE: dict = {}


def cached_slot_decode_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                            temperature: float = 0.0) -> Callable:
    """Memoized ``jit_slot_decode_step(make_slot_decode_step(...))``."""
    key = ("slot_decode", cfg, mode, temperature)
    if key not in _STEP_CACHE:
        _STEP_CACHE[key] = jit_slot_decode_step(make_slot_decode_step(
            cfg, mode=mode, temperature=temperature))
    return _STEP_CACHE[key]


def clear_step_cache() -> None:
    """Drop every memoized step, its graph and the params and cache it
    holds."""
    for fn in _STEP_CACHE.values():
        fn.captured.release()
    _STEP_CACHE.clear()
