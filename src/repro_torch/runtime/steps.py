"""Serving steps: the prefill step (the full-sequence forward), the decode
step and the multi-token decode loop, the continuous-batching slot tick,
and chunked prefill of one slot — the serving subset of
``repro/runtime/steps.py``.

The ``make_*`` builders run eagerly: the cache is a dict of tensors
updated in place, and each step returns it to keep the reference's
signatures.  The reference's compile boundary, ``jax.jit`` with the cache
donated, is a CUDA graph here (``runtime/graphs.py``): the
``jit_slot_decode_step``, ``jit_decode_loop`` and ``jit_prefill_chunk_step``
wrappers capture the slot tick, the decode loop and the chunk step over
static buffers and the caller's cache and replay them, bit for bit the
eager steps they wrap, and ``cached_slot_decode_step`` and
``cached_prefill_chunk_step`` memoize the captured tick and chunk step as
the reference memoizes its compiled ones; ``jit_prefill_step`` captures
the full-sequence forward, a graph per batch shape.  Under W8A16 the
chunk step prefills a chunk in one (1, n) decode pass whose cache bytes
are the per-token path's (:func:`make_prefill_chunk_step`; the per-token
reference is :func:`make_per_token_chunk_step`).

With ``temperature > 0`` the decode loop and the slot tick sample
(:func:`temperature_sample`, :func:`temperature_sample_rows`) with the
reference's key schedule, ``fold_in(rng, position)`` on the threefry
keys of ``runtime/prng.py``; the captured forms take the key as one more
graph input.

Speculative decoding's two steps, :func:`make_verify_step` (the target
scores up to k+1 fed tokens a slot) and :func:`make_draft_propose_step`
(the draft proposes k), are the reference's scans of the one-token slot
step, unrolled into ``k + 1`` and ``k`` calls of it; each is captured as
one graph (:func:`jit_verify_step`, :func:`jit_draft_propose_step`) and
memoized (:func:`cached_verify_step`, :func:`cached_draft_propose_step`).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import FP, QuantMode
from repro_torch.core.quant import QTensor
from repro_torch.models import registry as R
from repro_torch.runtime import prng as P
from repro_torch.runtime.graphs import MAX_BINDINGS, CapturedStep


def make_prefill_step(cfg: ArchConfig, *, mode: QuantMode = FP) -> Callable:
    def prefill_step(params, batch):
        # inference: no remat needed (no backward pass)
        return R.apply_forward(params, cfg, batch, mode=mode, remat=False)
    return prefill_step


def jit_prefill_step(step: Callable) -> Callable:
    """A prefill step (:func:`make_prefill_step`) captured as CUDA graphs
    (the reference's ``jax.jit`` of it): ``step(params, batch) -> logits``
    with ``batch["tokens"]`` (B, S) on the params' device.  Each tokens
    shape has a graph of its own, captured at its first call (the service
    curve's warm-up call), so every later call of that shape replays it;
    the logits are a static buffer that the next call of that shape
    overwrites.  ``graphed.binding(params, batch)`` is the binding such a
    call replays (``CapturedStep.binding``)."""
    captured = CapturedStep(
        lambda params, cache, tokens: (step(params, {"tokens": tokens}),))

    def graphed(params, batch):
        logits, = captured(params, {}, batch["tokens"])
        return logits

    graphed.captured = captured
    graphed.binding = lambda params, batch: captured.binding(
        params, {}, batch["tokens"])
    return graphed


def make_decode_step(cfg: ArchConfig, *, mode: QuantMode = FP) -> Callable:
    def decode_step(params, batch, cache, logits: bool = True,
                    causal: bool = False):
        return R.apply_decode(params, cfg, batch, cache, mode=mode,
                              logits=logits, causal=causal)
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


def _scaled(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """The last position's f32 logits over the temperature, as the
    reference's jitted steps compute ``x / t``: XLA rewrites a division by
    a constant as a multiply by its f32 reciprocal.  Every sampler here
    multiplies so, the sequential reference's too, and the engine equals
    that reference bit for bit."""
    inv = float(np.float32(1.0) / np.float32(temperature))
    return logits[:, -1].float() * inv


def sampling_scores(logits: torch.Tensor, keys: torch.Tensor,
                    temperature: float) -> torch.Tensor:
    """The scores a sampled row takes the argmax of: ``logits[:, -1] / t``
    plus row r's Gumbel noise from ``keys[r]`` (B, V) f32 — what
    ``margins`` of a sampled reference measures the top-2 gap of."""
    last = _scaled(logits, temperature)
    return P.gumbel(keys, last.shape) + last


def temperature_sample(logits: torch.Tensor, key: torch.Tensor,
                       temperature: float = 1.0) -> torch.Tensor:
    """``jax.random.categorical(key, logits[:, -1] / t)``: ONE key for the
    whole (B, V) draw, as the reference's decode loop samples its
    lockstep batch."""
    return P.categorical(key, _scaled(logits, temperature)).to(torch.int32)


def temperature_sample_rows(logits: torch.Tensor, keys: torch.Tensor,
                            temperature: float = 1.0) -> torch.Tensor:
    """Per-row temperature sampling: row r draws with ``keys[r]`` (keys
    (B, 2)), the slot engine's schedule.  A row's draw is bitwise
    :func:`temperature_sample` of that row alone at batch 1 with the same
    key, and the same whatever rows sit beside it: every op is
    elementwise, then an argmax along the vocabulary (first index among
    ties)."""
    return torch.argmax(sampling_scores(logits, keys, temperature),
                        dim=-1).to(torch.int32)


def _needs_rng(temperature: float, rng, call: str) -> None:
    if temperature > 0.0 and rng is None:
        raise ValueError(f"temperature sampling needs an rng key: {call}")


def make_decode_loop(cfg: ArchConfig, *, mode: QuantMode = FP,
                     num_tokens: int, temperature: float = 0.0) -> Callable:
    """Multi-token decode of a lockstep batch.

    Returns ``loop(params, tokens, cache, cache_index, rng=None) -> (out,
    cache)`` with ``tokens`` (B, 1) int32 seed, ``cache_index`` the
    position of the first step, and ``out`` (B, num_tokens) int32
    generated tokens; the cache is updated in place.  With the default
    ``temperature=0.0`` sampling is greedy (``rng`` ignored);
    ``temperature > 0`` draws from :func:`temperature_sample` with the
    per-step key ``fold_in(rng, cache_index + step)``, and a missing
    ``rng`` raises ValueError.  The reference scans the steps inside one
    jit; here they are a Python loop over the same decode step.
    ``cache_index`` is an int, or a device tensor of one or B values (all
    equal: the batch is in lockstep), which runs the decode step's
    per-row form with every row at that place, as the captured loop does
    (:func:`jit_decode_loop`); both forms give the same bits."""
    decode = make_decode_step(cfg, mode=mode)

    def loop(params, tokens, cache, cache_index, rng=None):
        _needs_rng(temperature, rng,
                   "loop(params, tokens, cache, cache_index, rng)")
        if isinstance(cache_index, torch.Tensor):
            idx = cache_index.reshape(-1).expand(tokens.shape[0])
        else:
            idx = int(cache_index)
        tok, out = tokens, []
        for _ in range(num_tokens):
            logits, cache = decode(params, {"tokens": tok,
                                            "cache_index": idx}, cache)
            if temperature > 0.0:
                pos = idx[0] if isinstance(idx, torch.Tensor) else idx
                nxt = temperature_sample(logits, P.fold_in(rng, pos),
                                         temperature)
            else:
                nxt = greedy_sample(logits)
            out.append(nxt)
            tok, idx = nxt[:, None], idx + 1
        return torch.stack(out, dim=1), cache

    loop.temperature = temperature
    return loop


def jit_decode_loop(loop: Callable) -> Callable:
    """A decode loop captured as one CUDA graph over its cache (the
    reference's ``jax.jit`` with the cache donated): ``loop(params,
    tokens, cache, cache_index, rng=None) -> (out, cache)`` as
    :func:`make_decode_loop`'s, with ``cache_index`` an int or a tensor
    of one or B values.  The start position and, when the loop samples,
    the key live in static buffers, so one graph serves every start and
    every key; ``out`` is a static buffer that the next call overwrites.
    ``graphed.binding(params, tokens, cache, cache_index, rng=None)`` is
    the binding such a call replays (``CapturedStep.binding``)."""
    sampled = loop.temperature > 0.0
    captured = CapturedStep(
        lambda params, cache, tokens, start, *rng: loop(
            params, tokens, cache, start, *rng)[:1])

    def inputs(tokens, cache_index, rng):
        _needs_rng(loop.temperature, rng,
                   "loop(params, tokens, cache, cache_index, rng)")
        start = torch.as_tensor(cache_index, dtype=torch.int32).reshape(-1)
        return (tokens, start) + ((rng,) if sampled else ())

    def graphed(params, tokens, cache, cache_index, rng=None):
        out, = captured(params, cache, *inputs(tokens, cache_index, rng))
        return out, cache

    graphed.captured = captured
    graphed.binding = lambda params, tokens, cache, cache_index, rng=None: \
        captured.binding(params, cache, *inputs(tokens, cache_index, rng))
    return graphed


def make_slot_decode_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                          temperature: float = 0.0) -> Callable:
    """One tick of the continuous-batching engine: advance EVERY slot of
    the pool by one token.

    Returns ``step(params, tokens, cache, slot_index, active) ->
    (next_tokens, cache, slot_index)`` with ``tokens`` (S, 1) int32,
    ``slot_index`` (S,) int32 per-slot positions and ``active`` (S,) bool;
    with ``temperature > 0`` the step takes a trailing ``rng`` key and
    row r draws with ``fold_in(rng, slot_index[r])``
    (:func:`temperature_sample_rows`), the per-row form of
    :func:`make_decode_loop`'s schedule.  Inactive rows emit 0 and keep
    their index; a row whose logits hold a NaN/Inf emits the sentinel -1.
    Inactive rows still write their k/v at their frozen index, which no
    read can see (every read is masked at the row's own frontier); on a
    paged cache they write through their table, into trash block 0 once
    the row is retired."""
    decode = make_decode_step(cfg, mode=mode)

    def step(params, tokens, cache, slot_index, active, *rng):
        if len(rng) != (temperature > 0.0):
            raise TypeError(
                "a sampled slot step takes a trailing rng key, a greedy "
                "one none: step(params, tokens, cache, slot_index, active"
                + (", rng)" if temperature > 0.0 else ")"))
        logits, cache = decode(
            params, {"tokens": tokens, "cache_index": slot_index}, cache)
        cache = R.mask_inactive_slots(cfg, cache, cache, active)
        if temperature > 0.0:
            nxt = temperature_sample_rows(
                logits, P.fold_in(rng[0], slot_index), temperature)
        else:
            nxt = greedy_sample(logits)
        finite = torch.isfinite(logits[:, -1].float()).all(dim=-1)
        nxt = torch.where(finite, nxt, torch.full_like(nxt, -1))
        nxt = torch.where(active, nxt, torch.zeros_like(nxt))
        return nxt, cache, slot_index + active.to(slot_index.dtype)

    return step


def jit_slot_decode_step(step: Callable) -> Callable:
    """A slot tick captured as one CUDA graph over its cache (the
    reference's ``jax.jit`` with the cache donated): ``step(params,
    tokens, cache, slot_index, active[, rng]) -> (next_tokens, cache,
    slot_index)`` as :func:`make_slot_decode_step`'s.  A sampled step's
    key is a graph input like the others, copied into a static buffer at
    each call, so one graph serves any key.  ``next_tokens`` and the new
    ``slot_index`` are static buffers that the next call overwrites; a
    paged cache's ``block_tables`` is read where it lies, so the caller
    updates it in place.  ``graphed.binding(params, tokens, cache,
    slot_index, active[, rng])`` is the binding such a call replays
    (``CapturedStep.binding``)."""
    def body(params, cache, tokens, slot_index, active, *rng):
        nxt, _, new_index = step(params, tokens, cache, slot_index, active,
                                 *rng)
        return nxt, new_index

    captured = CapturedStep(body)

    def graphed(params, tokens, cache, slot_index, active, *rng):
        nxt, new_index = captured(params, cache, tokens, slot_index, active,
                                  *rng)
        return nxt, cache, new_index

    graphed.captured = captured
    graphed.binding = lambda params, tokens, cache, slot_index, active, \
        *rng: captured.binding(params, cache, tokens, slot_index, active,
                               *rng)
    return graphed


def make_verify_step(cfg: ArchConfig, *, mode: QuantMode = FP, k: int,
                     temperature: float = 0.0) -> Callable:
    """One speculative *verify* tick: teacher-force up to ``k + 1`` tokens
    a slot through the target model, sampling after every position.

    Returns ``step(params, tokens, cache, slot_index, n_tokens, active[,
    rng]) -> (samples, cache, slot_index)`` with ``tokens`` (S, k+1)
    int32 (a row's next input, then its draft's proposals), ``n_tokens``
    (S,) int32 how many leading tokens each row really feeds (1 for a row
    that does not speculate this tick, up to k+1) and ``samples`` (S,
    k+1) int32 the sample drawn after each position.  A sampled step
    (``temperature > 0``) takes a trailing ``rng`` and draws position j
    of row r with ``fold_in(rng, slot_index[r] + j)``.

    The reference scans the one-token slot step; here the scan is
    unrolled: ``k + 1`` calls of :func:`make_slot_decode_step`'s step,
    position j with ``active & (j < n_tokens)`` as its active mask.  So
    every position is an ordinary (S, 1) tick, and ``samples[r, j]`` and
    every cache byte are bit for bit those of ``j + 1`` non-speculative
    ticks fed the same tokens (every op computes a row the same whatever
    the rows beside it).  Past ``n_tokens[r]`` row r's index stays
    frozen: those positions write at the row's frozen frontier, which
    the next real feed overwrites before any read sees it (the engine's
    rewind), and emit 0.  A position whose logits hold a NaN/Inf emits
    the -1 sentinel there."""
    slot = make_slot_decode_step(cfg, mode=mode, temperature=temperature)

    def step(params, tokens, cache, slot_index, n_tokens, active, *rng):
        if len(rng) != (temperature > 0.0):
            raise TypeError(
                "a sampled verify step takes a trailing rng key, a greedy "
                "one none: step(params, tokens, cache, slot_index, "
                "n_tokens, active" + (", rng)" if temperature > 0.0
                                      else ")"))
        idx, samples = slot_index, []
        for j in range(k + 1):
            nxt, cache, idx = slot(params, tokens[:, j:j + 1], cache, idx,
                                   active & (n_tokens > j), *rng)
            samples.append(nxt)
        return torch.stack(samples, dim=1), cache, idx

    return step


def jit_verify_step(step: Callable) -> Callable:
    """A verify step captured as one CUDA graph over its cache (the
    reference's ``jax.jit`` with the cache donated): ``step(params,
    tokens, cache, slot_index, n_tokens, active[, rng]) -> (samples,
    cache, slot_index)`` as :func:`make_verify_step`'s.  ``samples`` and
    the new ``slot_index`` are static buffers that the next call
    overwrites; ``graphed.binding(...)`` (the call's arguments) is the
    binding such a call replays."""
    def body(params, cache, tokens, slot_index, n_tokens, active, *rng):
        samples, _, new_index = step(params, tokens, cache, slot_index,
                                     n_tokens, active, *rng)
        return samples, new_index

    captured = CapturedStep(body)

    def graphed(params, tokens, cache, slot_index, n_tokens, active, *rng):
        samples, new_index = captured(params, cache, tokens, slot_index,
                                      n_tokens, active, *rng)
        return samples, cache, new_index

    graphed.captured = captured
    graphed.binding = lambda params, tokens, cache, slot_index, n_tokens, \
        active, *rng: captured.binding(params, cache, tokens, slot_index,
                                       n_tokens, active, *rng)
    return graphed


def make_draft_propose_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                            k: int) -> Callable:
    """One speculative *propose* tick: the draft model extends every
    active slot by ``k`` greedy tokens.

    Returns ``step(params, tokens, cache, slot_index, active) ->
    (proposals, cache, slot_index)`` with ``tokens`` (S, 1) int32 each
    row's committed next input and ``proposals`` (S, k) int32 the draft's
    greedy continuation, each fed back as the next step's input: ``k``
    calls of the greedy one-token slot step.  The draft is greedy
    whatever the target samples with: its proposals are guesses the
    verify step scores, so they move the acceptance rate and never the
    committed output.  A row whose logits go non-finite proposes 0 in
    place of the -1 sentinel, a wrong guess that can only be rejected;
    inactive rows propose 0."""
    slot = make_slot_decode_step(cfg, mode=mode)

    def step(params, tokens, cache, slot_index, active):
        tok, idx, props = tokens, slot_index, []
        for _ in range(k):
            nxt, cache, idx = slot(params, tok, cache, idx, active)
            nxt = torch.clamp_min(nxt, 0)
            props.append(nxt)
            tok = nxt[:, None]
        return torch.stack(props, dim=1), cache, idx

    return step


def jit_draft_propose_step(step: Callable) -> Callable:
    """A propose step captured as one CUDA graph over the draft's cache:
    ``step(params, tokens, cache, slot_index, active) -> (proposals,
    cache, slot_index)`` as :func:`make_draft_propose_step`'s, its
    outputs static buffers as :func:`jit_verify_step`'s."""
    def body(params, cache, tokens, slot_index, active):
        props, _, new_index = step(params, tokens, cache, slot_index,
                                   active)
        return props, new_index

    captured = CapturedStep(body)

    def graphed(params, tokens, cache, slot_index, active):
        props, new_index = captured(params, cache, tokens, slot_index,
                                    active)
        return props, cache, new_index

    graphed.captured = captured
    graphed.binding = lambda params, tokens, cache, slot_index, active: \
        captured.binding(params, cache, tokens, slot_index, active)
    return graphed


def make_per_token_chunk_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                              chunk: int) -> Callable:
    """Chunked prefill for ONE slot, one token at a time: the reference
    path that :func:`make_prefill_chunk_step` is held to.

    Returns ``step(params, tokens, cache, sid, start, n_valid) -> cache``
    as :func:`make_prefill_chunk_step`'s.  It runs the SAME one-token
    decode step as the slot tick and the sequential reference (batch 1,
    lockstep index) once per real token on a view of the slot's cache
    row, so the written bytes are the per-token path's; padding tokens
    past ``n_valid`` are never run.  A paged cache runs on the physical
    pool with the slot's table row as a (1, MB) table."""
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


def _leaves(node):
    for child in node.values():
        if isinstance(child, dict):
            yield from _leaves(child)
        else:
            yield child


def _projections_quantized(params) -> bool:
    """True when every projection of every layer is an int8 ``QTensor``:
    every weight leaf of a layer but the 1-D norm scales and biases."""
    return all(isinstance(w, QTensor) for lp in params["layers"]
               for w in _leaves(lp)
               if isinstance(w, QTensor) or getattr(w, "ndim", 0) >= 2)


def make_prefill_chunk_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                            chunk: int) -> Callable:
    """Chunked prefill for ONE slot of the pool: write up to ``chunk``
    teacher-forced prompt tokens of KV state in one step.

    Returns ``step(params, tokens, cache, sid, start, n_valid) -> cache``
    with ``tokens`` (chunk,) int32, ``sid`` the slot row, ``start`` its
    current frontier and ``n_valid`` how many of the tokens are real.  The
    written bytes are those of the per-token path
    (:func:`make_per_token_chunk_step`).  Padding tokens past ``n_valid``
    are never run, which leaves the cache exactly as unpadded prefill
    would.

    Under W8A16, where every projection is a ``QTensor``, the chunk runs
    as ONE decode pass of tokens (1, n_valid) at ``cache_index = start``,
    causal (token i attends the slots below ``start + i + 1``): it writes
    every token's k/v, then attends each as a query row of its own
    (``layers.attention``), so the weights are read once per chunk.  Its
    bytes are still the per-token path's, because every op of that pass
    computes a row the same whatever the rows beside it: the GEMV (its
    split a function of (K, N) alone), the decode attention kernels and
    ``bf16_cache_attention`` (one frontier per row), the row-wise norms,
    ``q8`` and RoPE.  Otherwise the chunk runs the one-token decode step
    once per real token: under W8A8 one pass would quantize the n tokens'
    activations with one scale (``kernels/ops.py::qmatmul_dynamic``)
    where the reference's scan quantizes each token alone, and under FP
    ``torch.matmul`` promises no row invariance.

    The step reads the slot's row through a table, so no Python ``sid``
    narrows the cache: the paged cache's table row, or, on a contiguous
    cache, ``[sid]`` over its leaves read as blocks of one slot row each.
    On a paged cache it writes only positions ``start .. start + n_valid
    - 1``, which lie in blocks the slot owns privately — a shared prefix
    block is never written.  (The reference gathers the row into a
    contiguous view and scatters every block back, which keeps its CPU
    path byte-identical under a functional update.)

    ``step.body(params, cache, toks, sid, start)`` is the step on device
    tensors, what :func:`jit_prefill_chunk_step` captures: ``toks`` the
    n real tokens (n,), ``sid`` and ``start`` (1,) int32."""
    decode = make_decode_step(cfg, mode=mode)

    def body(params, cache, toks, sid, start):
        if "block_tables" in cache:
            table = cache["block_tables"].index_select(0, sid)
        else:
            table = sid.reshape(1, 1)
        view = dict(cache, block_tables=table)
        n = toks.shape[0]
        if mode.enabled and not mode.w8a8 and _projections_quantized(params):
            decode(params, {"tokens": toks.reshape(1, n),
                            "cache_index": start}, view, logits=False,
                   causal=True)
        else:
            for i in range(n):
                decode(params, {"tokens": toks[i:i + 1].reshape(1, 1),
                                "cache_index": start + i}, view,
                       logits=False)
        return ()

    def step(params, tokens, cache, sid: int, start: int, n_valid: int):
        if len(tokens) != chunk:
            raise ValueError(f"chunk step of {chunk} got {len(tokens)} "
                             f"tokens")
        n = int(n_valid)
        if n:
            dev = cache["k"].device
            body(params, cache,
                 torch.as_tensor(tokens[:n], dtype=torch.int32, device=dev),
                 torch.tensor([int(sid)], dtype=torch.int32, device=dev),
                 torch.tensor([int(start)], dtype=torch.int32, device=dev))
        return cache

    step.body = body
    step.chunk = chunk
    return step


def jit_prefill_chunk_step(step: Callable) -> Callable:
    """A chunk step captured as CUDA graphs over its cache (the
    reference's ``jax.jit`` with the cache donated): ``step(params,
    tokens, cache, sid, start, n_valid) -> cache`` as
    :func:`make_prefill_chunk_step`'s.  ``sid``, ``start`` and the
    ``n_valid`` real tokens go to the card in one copy into a static
    buffer (from pinned memory, so the host does not wait for the card),
    and each ``n_valid`` has a graph of its own, captured at its first
    call: the padding is never run, where the reference runs it and
    masks its writes with ``jnp.where``.  ``graphed.binding(params,
    cache, n_valid)`` is the binding that a call of ``n_valid`` real
    tokens on ``params`` and ``cache`` replays (``CapturedStep.binding``).
    """
    chunk = step.chunk

    def chunk_body(params, cache, packed):
        return step.body(params, cache, packed[2:], packed[:1], packed[1:2])

    captured = CapturedStep(chunk_body, max_bindings=MAX_BINDINGS * chunk)

    def graphed(params, tokens, cache, sid, start, n_valid):
        if len(tokens) != chunk:
            raise ValueError(f"chunk step of {chunk} got {len(tokens)} "
                             f"tokens")
        n = int(n_valid)
        if not 0 <= n <= chunk:
            raise ValueError(f"n_valid must lie in [0, {chunk}], got {n}")
        if n:
            packed = torch.tensor([int(sid), int(start)]
                                  + [int(t) for t in tokens[:n]],
                                  dtype=torch.int32)
            if cache["k"].is_cuda:
                packed = packed.pin_memory()
            captured(params, cache, packed)
        return cache

    graphed.captured = captured
    graphed.binding = lambda params, cache, n_valid: captured.binding(
        params, cache, torch.empty(2 + int(n_valid), dtype=torch.int32))
    return graphed


# Process-wide memo of the captured steps, keyed as the reference's
# (``repro/runtime/steps.py`` ``_STEP_CACHE``) on the step's
# specialization: engines over one config share one captured step, which
# keeps a graph per binding (each engine's params and cache), so engines
# that take turns each replay their own.
_STEP_CACHE: dict = {}


def _cached(key, build):
    fn = _STEP_CACHE.get(key)
    if fn is None:
        fn = _STEP_CACHE[key] = build()
    return fn


def cached_slot_decode_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                            temperature: float = 0.0) -> Callable:
    """Memoized ``jit_slot_decode_step(make_slot_decode_step(...))``."""
    return _cached(("slot_decode", cfg, mode, temperature),
                   lambda: jit_slot_decode_step(make_slot_decode_step(
                       cfg, mode=mode, temperature=temperature)))


def cached_prefill_chunk_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                              chunk: int) -> Callable:
    """Memoized ``jit_prefill_chunk_step(make_prefill_chunk_step(...))``."""
    return _cached(("prefill_chunk", cfg, mode, chunk),
                   lambda: jit_prefill_chunk_step(make_prefill_chunk_step(
                       cfg, mode=mode, chunk=chunk)))


def cached_verify_step(cfg: ArchConfig, *, mode: QuantMode = FP, k: int,
                       temperature: float = 0.0) -> Callable:
    """Memoized ``jit_verify_step(make_verify_step(...))``."""
    return _cached(("verify", cfg, mode, k, temperature),
                   lambda: jit_verify_step(make_verify_step(
                       cfg, mode=mode, k=k, temperature=temperature)))


def cached_draft_propose_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                              k: int) -> Callable:
    """Memoized ``jit_draft_propose_step(make_draft_propose_step(...))``."""
    return _cached(("draft_propose", cfg, mode, k),
                   lambda: jit_draft_propose_step(make_draft_propose_step(
                       cfg, mode=mode, k=k)))


def clear_step_cache() -> None:
    """Drop every memoized step, its graphs and the params and caches they
    hold."""
    for fn in _STEP_CACHE.values():
        fn.captured.release()
    _STEP_CACHE.clear()
