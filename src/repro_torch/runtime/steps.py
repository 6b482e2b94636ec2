"""Train and serve steps: the LM loss and the train step, the prefill
step (the full-sequence forward), the decode step and the multi-token
decode loop, the continuous-batching slot tick, and chunked prefill of
one slot — the port of ``repro/runtime/steps.py``.

Training (:func:`make_train_step`) is the reference's loss -> grads ->
clip -> optimizer on one device: the gradients come from
``torch.autograd.grad`` over the param leaves, every attention layer's
forward is the flash-attention kernel on the card and its gradient
``kernels/flash_attention.py::flash_attention_bwd``, and the optimizer
writes the params and its state in place (``optim/optimizers.py``).
Every family trains; the int8 gradient exchange, which needs several
cards, is refused (ROADMAP queue 1, item 15).

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

A family that primes (encdec, vlm) writes each request's cross k/v into
its slot's row once, at admission, through :func:`make_prime_step`,
captured as one graph for every slot (:func:`jit_prime_step`, memoized
by :func:`cached_prime_step`); the tick and the chunk step read those
rows.

Speculative decoding's two steps, :func:`make_verify_step` (the target
scores up to k+1 fed tokens a slot) and :func:`make_draft_propose_step`
(the draft proposes k), are the reference's scans of the one-token slot
step, unrolled into ``k + 1`` and ``k`` calls of it; each is captured as
one graph (:func:`jit_verify_step`, :func:`jit_draft_propose_step`) and
memoized (:func:`cached_verify_step`, :func:`cached_draft_propose_step`).

Scale-out (the reference's ``make_sharded_*`` steps): each splits the
slot pool into ``tp`` shards on one device, shard i running the memoized
captured single-device step on its views of the cache
(:class:`ShardedCache`), a single-slot step on the slot's owner alone, bit
for bit the single-device step (``make_sharded_slot_decode_step`` and
the rest, memoized by ``cached_sharded_*``).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.qlinear import FP, QuantMode
from repro_torch.core.quant import QTensor
from repro_torch.models import registry as R
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.runtime import prng as P
from repro_torch.runtime.graphs import MAX_BINDINGS, CapturedStep

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4) -> torch.Tensor:
    """Mean CE in f32 + z-loss (the logit-norm stabilizer)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    ce = torch.mean(lse - ll)
    return ce + z_loss * torch.mean(torch.square(lse))


def make_loss_fn(cfg: ArchConfig, *, mode: QuantMode = FP,
                 remat: bool = True) -> Callable:
    """``loss_fn(params, batch) -> ()`` f32: the forward
    (``registry.apply_forward``, every family) and :func:`cross_entropy`
    against ``batch["labels"]``.  The batch is ``cfg.input_specs``'s:
    ``tokens`` and ``labels``, and the encdec family's
    ``encoder_embeds`` or the vlm family's ``vision_embeds`` (bf16)."""
    def loss_fn(params, batch):
        logits = R.apply_forward(params, cfg, batch, mode=mode, remat=remat)
        return cross_entropy(logits, batch["labels"])
    return loss_fn


def make_train_step(cfg: ArchConfig, optimizer: Optimizer, *,
                    mode: QuantMode = FP, remat: bool = True,
                    max_grad_norm: float = 1.0,
                    grad_compression: Optional[str] = None) -> Callable:
    """Returns ``train_step(params, opt_state, batch, rng) -> (params,
    opt_state, metrics)``: the loss and its gradients with respect to
    every param leaf (each made to require grad at the first call), the
    gradients clipped to a global norm of ``max_grad_norm``, and the
    optimizer's update, written into ``params`` and ``opt_state`` in
    place (both returned, as the reference returns their new values).
    ``metrics``: ``loss`` and ``grad_norm``, () f32 tensors on the
    params' device (reading them syncs).  ``rng`` is the reference's
    key of the int8 exchange, which is not ported: it is not read."""
    if grad_compression is not None:
        raise NotImplementedError(
            f"grad_compression={grad_compression!r}: the int8 gradient "
            f"exchange runs across several cards and is not ported yet "
            f"(ROADMAP queue 1, item 15)")
    loss_fn = make_loss_fn(cfg, mode=mode, remat=remat)

    def train_step(params, opt_state, batch, rng=None):
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = loss_fn(params, batch)
        by_leaf = dict(zip(map(id, leaves),
                           torch.autograd.grad(loss, leaves)))
        grads = tree_map(lambda p: by_leaf[id(p)], params)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = optimizer.update(params, grads, opt_state)
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg: ArchConfig, *, mode: QuantMode = FP) -> Callable:
    def prefill_step(params, batch):
        # inference: no remat needed (no backward pass)
        return R.apply_forward(params, cfg, batch, mode=mode, remat=False)
    return prefill_step


def jit_prefill_step(step: Callable) -> Callable:
    """A prefill step (:func:`make_prefill_step`) captured as CUDA graphs
    (the reference's ``jax.jit`` of it): ``step(params, batch) -> logits``
    with ``batch["tokens"]`` (B, S) (and encdec's
    ``batch["encoder_embeds"]`` or vlm's ``batch["vision_embeds"]``) on
    the params' device.  Each set of input shapes has a graph of its own,
    captured at its first call (the service curve's warm-up call), so
    every later call of those shapes replays it; the logits are a static
    buffer that the next call of those shapes overwrites.
    ``graphed.binding(params, batch)`` is the binding such a call replays
    (``CapturedStep.binding``)."""
    names: list = []      # the batch's keys, in the inputs' order

    def body(params, cache, *inputs):
        return (step(params, dict(zip(names, inputs))),)

    captured = CapturedStep(body)

    def inputs(batch):
        names[:] = sorted(batch)
        return tuple(batch[k] for k in names)

    def graphed(params, batch):
        logits, = captured(params, {}, *inputs(batch))
        return logits

    graphed.captured = captured
    graphed.binding = lambda params, batch: captured.binding(
        params, {}, *inputs(batch))
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
    the row is retired.  Non-positional state (ssm's ``h`` and conv tail,
    the hybrid's RG-LRU state and conv tails) has no frontier to hide
    behind: the decode step sees ``active`` as the cache view's row mask
    and leaves an inactive row's state bitwise as it was (the slot
    contract's freeze, ``registry.mask_inactive_slots`` done in place);
    the dense, MoE, encdec and vlm steps ignore it."""
    decode = make_decode_step(cfg, mode=mode)

    def step(params, tokens, cache, slot_index, active, *rng):
        if len(rng) != (temperature > 0.0):
            raise TypeError(
                "a sampled slot step takes a trailing rng key, a greedy "
                "one none: step(params, tokens, cache, slot_index, active"
                + (", rng)" if temperature > 0.0 else ")"))
        logits, _ = decode(
            params, {"tokens": tokens, "cache_index": slot_index},
            dict(cache, active=active))
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
    pool with the slot's table row as a (1, MB) table (and the slot's row
    of every slot-resident leaf: encdec's and vlm's primed cross k/v)."""
    decode = make_decode_step(cfg, mode=mode)

    def step(params, tokens, cache, sid: int, start: int, n_valid: int):
        if len(tokens) != chunk:
            raise ValueError(f"chunk step of {chunk} got {len(tokens)} "
                             f"tokens")
        sid = int(sid)
        axes = R.cache_batch_axes(cfg, cache)
        if "block_tables" in cache:
            paged = R.paged_block_axes(cfg, cache)
            row = {k: v if k in paged else v.narrow(axes[k], sid, 1)
                   for k, v in cache.items() if k != "block_tables"}
            row["block_tables"] = cache["block_tables"][sid:sid + 1]
        else:
            row = {k: v.narrow(axes[k], sid, 1) for k, v in cache.items()}
        toks = torch.as_tensor(tokens, dtype=torch.int32,
                               device=_device(cache))
        for i in range(int(n_valid)):
            decode(params, {"tokens": toks[i:i + 1].reshape(1, 1),
                            "cache_index": int(start) + i},
                   row, logits=False)
        return cache

    return step


def _device(cache: dict) -> torch.device:
    """The device of a cache (any leaf's: a KV cache's or a recurrent
    state's)."""
    return next(iter(cache.values())).device


def _leaves(node):
    for child in node.values():
        if isinstance(child, dict):
            yield from _leaves(child)
        else:
            yield child


def _projections_quantized(params) -> bool:
    """True when every projection of every decoder layer (``layers``, or
    encdec's ``dec_layers``) is an int8 ``QTensor``: every weight leaf of
    a layer but the 1-D norm scales and biases (and vlm's scalar
    gates)."""
    layers = params["layers"] if "layers" in params else params["dec_layers"]
    return all(isinstance(w, QTensor) for lp in layers
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

    Under W8A16, where every projection is a ``QTensor`` and the family's
    decode step takes a row's tokens in one pass
    (``registry.decodes_chunk_in_one_pass``: the positional-KV families
    with full attention),
    the chunk runs as ONE decode pass of tokens (1, n_valid) at
    ``cache_index = start``, causal (token i attends the slots below
    ``start + i + 1``): it writes
    every token's k/v, then attends each as a query row of its own
    (``layers.attention``), so the weights are read once per chunk.  Its
    bytes are still the per-token path's, because every op of that pass
    computes a row the same whatever the rows beside it: the GEMV (its
    split a function of (K, N) alone), the decode attention kernels and
    ``bf16_cache_attention`` (one frontier per row), the row-wise norms,
    ``q8`` and RoPE.  Otherwise the chunk runs the one-token decode step
    once per real token: under W8A8 one pass would quantize the n tokens'
    activations with one scale (``kernels/ops.py::qmatmul_dynamic``)
    where the reference's scan quantizes each token alone, under FP
    ``torch.matmul`` promises no row invariance, a recurrent family
    (ssm, hybrid) steps its state one token per call, and a sliding
    window's ring (mixtral) must be read before it is written: one pass
    writes all n columns first, and once the ring has wrapped the last
    token's write at ``(start + n - 1) % window`` overwrites the position
    ``start + n - 1 - window`` that token 0 still attends, so the ring's
    chunk runs token by token as the reference's scan does.

    The step reads the slot's row through a table, so no Python ``sid``
    narrows the cache: the paged cache's table row, or, on a contiguous
    cache, ``[sid]`` over its leaves read as blocks of one slot row each;
    slot-resident leaves are read (and a recurrent state written) at
    ``slots = sid`` (``encdec.decode_step``, ``vision.decode_step``,
    ``ssm.decode_step``, ``rglru.decode_step``).
    On a paged cache it writes only positions ``start .. start + n_valid
    - 1``, which lie in blocks the slot owns privately — a shared prefix
    block is never written.  (The reference gathers the row into a
    contiguous view and scatters every block back, which keeps its CPU
    path byte-identical under a functional update.)

    ``step.body(params, cache, toks, sid, start)`` is the step on device
    tensors, what :func:`jit_prefill_chunk_step` captures: ``toks`` the
    n real tokens (n,), ``sid`` and ``start`` (1,) int32."""
    decode = make_decode_step(cfg, mode=mode)
    one_pass = (mode.enabled and not mode.w8a8
                and R.decodes_chunk_in_one_pass(cfg))

    def body(params, cache, toks, sid, start):
        if "block_tables" in cache:
            table = cache["block_tables"].index_select(0, sid)
        else:
            table = sid.reshape(1, 1)
        view = dict(cache, block_tables=table, slots=sid)
        n = toks.shape[0]
        if one_pass and _projections_quantized(params):
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
            dev = _device(cache)
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

    # a graph per n_valid of each engine, lane, replica or shard
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
            if _device(cache).type == "cuda":
                packed = packed.pin_memory()
            captured(params, cache, packed)
        return cache

    graphed.captured = captured
    graphed.binding = lambda params, cache, n_valid: captured.binding(
        params, cache, torch.empty(2 + int(n_valid), dtype=torch.int32))
    return graphed


def make_prime_step(cfg: ArchConfig, *, mode: QuantMode = FP) -> Callable:
    """Prime dispatch for ONE slot of the pool (encdec, vlm): run the
    request's encoder (encdec) or take its patch embeddings (vlm) once,
    and write the pre-projected cross k/v and the row's ``xlen``
    frontier into the slot's row of the cache, in place.

    Returns ``step(params, source, cache, sid, n_valid) -> cache`` with
    ``source`` (1, source_len(cfg), D) bf16, the request's frames or
    patches padded to the static length, ``sid`` the slot row and
    ``n_valid`` how many source positions are real: decode masks cross
    reads past it, so k/v past ``n_valid`` (pad projections, a previous
    tenant's tail) is never read.  Both the engine and the sequential
    reference prime with the same padded source, so parity is exact.
    ``step.body(params, cache, source, sid, n_valid)`` is the step on
    device tensors (``sid`` and ``n_valid`` (1,) int32), what
    :func:`jit_prime_step` captures: the row is written by an index op on
    ``sid``, so one graph serves every slot."""

    def body(params, cache, source, sid, n_valid):
        leaves = R.prime_slot(cfg, params, source, n_valid, mode=mode)
        axes = R.cache_batch_axes(cfg, cache)
        rows = sid.long()
        for k, v in leaves.items():
            cache[k].index_copy_(axes[k], rows, v.to(cache[k].dtype))
        return ()

    def step(params, source, cache, sid, n_valid):
        dev = cache["xk"].device
        body(params, cache, source.to(dev),
             torch.tensor([int(sid)], dtype=torch.int32, device=dev),
             torch.tensor([int(n_valid)], dtype=torch.int32, device=dev))
        return cache

    step.body = body
    return step


def jit_prime_step(step: Callable) -> Callable:
    """A prime step captured as one CUDA graph over its cache (the
    reference's ``jax.jit`` with the cache donated): ``step(params,
    source, cache, sid, n_valid) -> cache`` as :func:`make_prime_step`'s.
    The source and the packed ``[sid, n_valid]`` are copied into static
    buffers (from pinned memory on the card), so one graph serves every
    slot and every source; ``graphed.binding(params, source, cache)`` is
    the binding such a call replays."""
    def prime_body(params, cache, source, packed):
        return step.body(params, cache, source, packed[:1], packed[1:2])

    captured = CapturedStep(prime_body)

    def inputs(source, cache, sid=0, n_valid=0):
        source = torch.as_tensor(source, dtype=torch.bfloat16)
        packed = torch.tensor([int(sid), int(n_valid)], dtype=torch.int32)
        if cache["xk"].is_cuda:
            if not source.is_cuda:
                source = source.pin_memory()
            packed = packed.pin_memory()
        return source, packed

    def graphed(params, source, cache, sid, n_valid):
        captured(params, cache, *inputs(source, cache, sid, n_valid))
        return cache

    graphed.captured = captured
    graphed.binding = lambda params, source, cache: captured.binding(
        params, cache, *inputs(source, cache))
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


def cached_prime_step(cfg: ArchConfig, *, mode: QuantMode = FP) -> Callable:
    """Memoized ``jit_prime_step(make_prime_step(...))``."""
    return _cached(("prime", cfg, mode),
                   lambda: jit_prime_step(make_prime_step(cfg, mode=mode)))


# ---------------------------------------------------------------------------
# scale-out: the slot axis split into tp shards on the engine's device
# ---------------------------------------------------------------------------

class ShardedCache(dict):
    """An engine cache split into ``tp`` shards on one device (the
    reference's ``_sharded_cache_specs``, here as views): the cache's
    leaves by name, as a dict, and ``views[i]``, shard ``i``'s view of
    rows ``[i * n, (i + 1) * n)`` of the pool, ``n = S / tp``.  Every
    slot-resident leaf is narrowed on its slot axis
    (``registry.cache_batch_axes``) and the block table on axis 0; the
    paged block leaves (``registry.paged_block_axes``) are passed whole,
    the same tensors in every view.  Nothing is copied: a shard's step
    writes the engine's cache in place, through its views.

    The engine's lane wraps its cache once, where it allocates it
    (``ShardedExecutor.shard_cache``), and the sharded steps take it
    whole: a captured step binds a graph per set of tensors, so views
    built anew each tick would capture a new graph each tick.

    :meth:`run` calls a shard's step on its view, and checks the first
    call of each step on each shard: the same step run eagerly on a copy
    of the view's narrowed leaves must leave them with the same bytes.  A
    write path that copies a strided view (a ``.contiguous()`` or a
    ``.reshape()`` of a whole leaf) would write into a temporary and lose
    the write; the check raises instead.  The eager run takes the shared
    block leaves as they are (no copy of the pool): it writes there what
    the step writes next, the same bytes at the same positions."""

    def __init__(self, cfg: ArchConfig, cache: dict, tp: int):
        super().__init__(cache)
        paged = (R.paged_block_axes(cfg, cache)
                 if "block_tables" in cache else {})
        axes = dict(R.cache_batch_axes(cfg, cache), block_tables=0)
        narrowed = [k for k in cache if k not in paged]
        slots = cache[narrowed[0]].shape[axes[narrowed[0]]]
        if slots % tp:
            raise ValueError(f"num_slots={slots} must divide by tp={tp} "
                             f"(the pool shards along the slot axis)")
        self.tp, self.rows = tp, slots // tp
        self.narrowed = tuple(narrowed)
        self.views = [{k: (v if k in paged else
                           v.narrow(axes[k], i * self.rows, self.rows))
                       for k, v in cache.items()} for i in range(tp)]
        self._checked: set = set()

    def rows_of(self, i: int) -> slice:
        """Shard ``i``'s rows of a per-row input."""
        return slice(i * self.rows, (i + 1) * self.rows)

    def run(self, label: str, i: int, real: Callable, eager: Callable):
        """``real(view)`` on shard ``i``'s view; its first call for
        ``label`` is held to ``eager(copy)``, with ``copy`` the view's
        narrowed leaves cloned and its block leaves shared (see the
        class's docstring).  Returns what ``real`` does."""
        view = self.views[i]
        if (label, i) in self._checked:
            return real(view)
        with torch.inference_mode():
            want = {k: (v.clone() if k in self.narrowed else v)
                    for k, v in view.items()}
            eager(want)
        out = real(view)
        for k in self.narrowed:
            if not _same_bytes(view[k], want[k]):
                raise RuntimeError(
                    f"shard {i}'s {label} step did not write {k!r} in "
                    f"place: its write path copies the strided view of "
                    f"rows {self.rows_of(i)} (a .contiguous() or "
                    f".reshape() of the whole leaf), and the write would "
                    f"be lost")
        self._checked.add((label, i))
        return out


def _same_bytes(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bitwise equality (a NaN equals itself, -0.0 is not 0.0)."""
    return a.shape == b.shape and torch.equal(
        a.contiguous().reshape(-1).view(torch.uint8),
        b.contiguous().reshape(-1).view(torch.uint8))


def _shards(cache: dict, tp: int) -> ShardedCache:
    """``cache`` as the sharded steps take it: its engine's
    :class:`ShardedCache` of ``tp`` shards."""
    if not isinstance(cache, ShardedCache) or cache.tp != tp:
        raise TypeError(f"a step of {tp} shards takes a ShardedCache of "
                        f"{tp} shards (ShardedCache(cfg, cache, {tp}), as "
                        f"ShardedExecutor.shard_cache builds it), not "
                        f"{type(cache).__name__}")
    return cache


def _sharded_rows(label, tp, base, eager, params, cache, rows, rest, outs):
    """Every shard's ``base(params, *rows_i, view_i, ...)`` in order on
    the caller's stream, with ``rows`` the per-row inputs and ``rest`` the
    trailing ones; the per-row outputs at ``outs`` joined in row order.
    The shards share the split kernels' workspace (``kernels/scratch.py``),
    so they must not run on concurrent streams."""
    sv = _shards(cache, tp)
    parts = []
    for i in range(tp):
        r = sv.rows_of(i)
        lead = tuple(x[r] for x in rows)

        def call(fn, view, lead=lead):
            return fn(params, lead[0], view, *lead[1:], *rest)

        out = sv.run(label, i, lambda v: call(base, v),
                     lambda v: call(eager, v))
        parts.append([out[j] for j in outs])
    return [torch.cat([p[j] for p in parts]) for j in range(len(outs))]


def _one_row(label, tp, base, eager, params, first, cache, sid, rest):
    """A single-slot dispatch (the chunk or the prime step) on its owner
    only: shard ``sid // n`` at its local row ``sid % n``, read from the
    host-side ``sid`` (never from a device tensor, which would wait for
    the card).  The reference runs every shard on a clamped local row and
    masks or discards the others' writes; here the shards write one
    shared block pool in place, so a non-owner's clamped row would write
    real blocks of another slot."""
    sv = _shards(cache, tp)
    owner, local = divmod(int(sid), sv.rows)
    sv.run(label, owner,
           lambda v: base(params, first, v, local, *rest),
           lambda v: eager(params, first, v, local, *rest))
    return cache


def make_sharded_slot_decode_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                                  temperature: float = 0.0,
                                  tp: int = 1) -> Callable:
    """The slot tick over ``tp`` shards of the pool on one device: the
    signature of :func:`make_slot_decode_step`, each shard running the
    memoized captured tick (:func:`cached_slot_decode_step`) on its rows
    of the cache (:class:`ShardedCache`) and of ``tokens``, ``slot_index``
    and ``active``, with the same params (never copied) and the same key.
    Every op computes a row the same whatever the rows beside it, so the
    next tokens, indices and cache bytes are bit for bit the single tick's
    (as the reference's ``shard_map`` keeps each row's op order).  Each
    shard's ``active`` freezes its own rows' recurrent state.

    Paged: the block leaves are every shard's, written in place.  The
    block tables partition the real blocks among the slots, so no two
    shards write one real block in a tick, and the reference's
    who-changed-it merge (``_merge_shard_writes``) is the identity on
    every real block: no copy, no merge.  Only trash block 0 takes several
    shards' writes (retired rows'), and no read sees it."""
    base = cached_slot_decode_step(cfg, mode=mode, temperature=temperature)
    eager = make_slot_decode_step(cfg, mode=mode, temperature=temperature)

    def step(params, tokens, cache, slot_index, active, *rng):
        nxt, idx = _sharded_rows("slot", tp, base, eager, params,
                                 cache, (tokens, slot_index, active), rng,
                                 (0, 2))
        return nxt, cache, idx

    step.captured = base.captured    # the graphs its shards replay
    return step


def make_sharded_verify_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                             k: int, temperature: float = 0.0,
                             tp: int = 1) -> Callable:
    """:func:`make_verify_step` over ``tp`` shards of the pool, each the
    memoized captured verify on its rows (as
    :func:`make_sharded_slot_decode_step`)."""
    base = cached_verify_step(cfg, mode=mode, k=k, temperature=temperature)
    eager = make_verify_step(cfg, mode=mode, k=k, temperature=temperature)

    def step(params, tokens, cache, slot_index, n_tokens, active, *rng):
        samples, idx = _sharded_rows(
            "verify", tp, base, eager, params, cache,
            (tokens, slot_index, n_tokens, active), rng, (0, 2))
        return samples, cache, idx

    step.captured = base.captured    # the graphs its shards replay
    return step


def make_sharded_draft_propose_step(cfg: ArchConfig, *,
                                    mode: QuantMode = FP, k: int,
                                    tp: int = 1) -> Callable:
    """:func:`make_draft_propose_step` over ``tp`` shards of the draft's
    (contiguous) cache, each the memoized captured propose on its rows."""
    base = cached_draft_propose_step(cfg, mode=mode, k=k)
    eager = make_draft_propose_step(cfg, mode=mode, k=k)

    def step(params, tokens, cache, slot_index, active):
        props, idx = _sharded_rows("propose", tp, base, eager, params,
                                   cache, (tokens, slot_index, active), (),
                                   (0, 2))
        return props, cache, idx

    step.captured = base.captured    # the graphs its shards replay
    return step


def make_sharded_prefill_chunk_step(cfg: ArchConfig, *,
                                    mode: QuantMode = FP, chunk: int,
                                    tp: int = 1) -> Callable:
    """:func:`make_prefill_chunk_step` over ``tp`` shards: the slot's
    owning shard alone runs the memoized captured chunk step on its view,
    at its local row (:func:`_one_row`)."""
    base = cached_prefill_chunk_step(cfg, mode=mode, chunk=chunk)
    eager = make_prefill_chunk_step(cfg, mode=mode, chunk=chunk)

    def step(params, tokens, cache, sid, start, n_valid):
        return _one_row(f"chunk{chunk}", tp, base, eager, params,
                        tokens, cache, sid, (start, n_valid))

    step.captured = base.captured    # the graphs its shards replay
    return step


def make_sharded_prime_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                            tp: int = 1) -> Callable:
    """:func:`make_prime_step` over ``tp`` shards: the slot's owning shard
    alone runs the memoized captured prime on its view, at its local row
    (:func:`_one_row`); a prime writes only slot-resident leaves."""
    base = cached_prime_step(cfg, mode=mode)
    eager = make_prime_step(cfg, mode=mode)

    def step(params, source, cache, sid, n_valid):
        return _one_row("prime", tp, base, eager, params, source,
                        cache, sid, (n_valid,))

    step.captured = base.captured    # the graphs its shards replay
    return step


def cached_sharded_slot_decode_step(cfg: ArchConfig, *,
                                    mode: QuantMode = FP,
                                    temperature: float = 0.0,
                                    tp: int = 1) -> Callable:
    """Memoized :func:`make_sharded_slot_decode_step` (key includes tp)."""
    return _cached(("sharded_slot_decode", cfg, mode, temperature, tp),
                   lambda: make_sharded_slot_decode_step(
                       cfg, mode=mode, temperature=temperature, tp=tp))


def cached_sharded_prefill_chunk_step(cfg: ArchConfig, *,
                                      mode: QuantMode = FP, chunk: int,
                                      tp: int = 1) -> Callable:
    """Memoized :func:`make_sharded_prefill_chunk_step`."""
    return _cached(("sharded_prefill_chunk", cfg, mode, chunk, tp),
                   lambda: make_sharded_prefill_chunk_step(
                       cfg, mode=mode, chunk=chunk, tp=tp))


def cached_sharded_prime_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                              tp: int = 1) -> Callable:
    """Memoized :func:`make_sharded_prime_step`."""
    return _cached(("sharded_prime", cfg, mode, tp),
                   lambda: make_sharded_prime_step(cfg, mode=mode, tp=tp))


def cached_sharded_verify_step(cfg: ArchConfig, *, mode: QuantMode = FP,
                               k: int, temperature: float = 0.0,
                               tp: int = 1) -> Callable:
    """Memoized :func:`make_sharded_verify_step`."""
    return _cached(("sharded_verify", cfg, mode, k, temperature, tp),
                   lambda: make_sharded_verify_step(
                       cfg, mode=mode, k=k, temperature=temperature, tp=tp))


def cached_sharded_draft_propose_step(cfg: ArchConfig, *,
                                      mode: QuantMode = FP, k: int,
                                      tp: int = 1) -> Callable:
    """Memoized :func:`make_sharded_draft_propose_step`."""
    return _cached(("sharded_draft_propose", cfg, mode, k, tp),
                   lambda: make_sharded_draft_propose_step(
                       cfg, mode=mode, k=k, tp=tp))


def clear_step_cache() -> None:
    """Drop every memoized step, its graphs and the params and caches they
    hold."""
    for fn in _STEP_CACHE.values():
        fn.captured.release()
    _STEP_CACHE.clear()
