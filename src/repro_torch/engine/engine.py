"""The continuous-batching engine: one fused slot-masked step per tick.

Port of ``repro/engine/engine.py`` for one model, greedy or sampled at
one engine-wide temperature:

- The KV cache is a fixed pool of ``num_slots`` rows of ``max_seq``
  positions, owned by the engine and zeroed in place for each run; every
  tick advances every ready slot by one token in one call of the slot
  step (active mask folded into sampling and index advance), which on
  the card replays a CUDA graph captured over that cache
  (``runtime/steps.py::jit_slot_decode_step``).
- With ``block_size=bs`` the rows are paged (the int8 cache or the bf16
  one, as ``cfg.kv_quant`` says): ``num_blocks`` physical KV
  blocks of ``bs`` positions behind per-slot block tables, with
  refcounted sharing of whole prompt-prefix blocks (a hit skips their
  prefill) and admission priced in blocks against the pool.
- With ``prefill_chunk=c``, a newly admitted slot's prompt (all but the
  last token) is written by the chunked prefill step, ``c`` tokens per
  tick, concurrently with other slots' decoding.
- ``temperature=t, rng=key`` samples every row at ``t`` with the key
  ``fold_in(rng, position)`` (``runtime/steps.py``; the threefry keys of
  ``runtime/prng.py``): a key depends on the row's position alone, so a
  sampled request's tokens do not depend on its slot, its tick, the rows
  beside it or a preemption's resume.
- Admission consults the shared ``core.batching.AdmissionPolicy``
  (class-first, with per-class slot quotas metered against the slots
  each class holds); retired slots return to the pool the same tick they
  finish.
- Overload: ``serve(preemption=True)`` evicts a slot of strictly lower
  class under slot or block pressure and resumes it exactly, and
  ``serve(fault_plan=...)`` injects a seeded ``FaultPlan``'s failures,
  which the recovery (always on) retries, rebuilds or, past
  ``max_retries``, retires as ``failed``.
- Speculation: ``spec_k=k`` with a draft (``draft_layers=n``, the
  target's first n layers, or ``draft=(dcfg, dparams)``) turns every
  generating tick into a draft proposal of k greedy tokens and one
  verify step on the target; the committed tokens are bit for bit the
  non-speculative engine's, greedy or sampled, whatever the draft
  proposes (``engine/dispatch.py``).

``reference_outputs`` is the sequential per-token loop (batch 1, same
decode math and sampler, contiguous cache) the engine must match bit
for bit, paged or not: every kernel and plain version computes a row
independently of the batch it sits in, the paged kernel reads a row in
the very order the contiguous one does, the bf16 cache's attention
reads a row gathered through its table as the contiguous row, and the
sampler is elementwise up to its argmax along the vocabulary.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import batching as bt
from repro_torch.core.qlinear import FP, QuantMode
from repro_torch.core.quant import QTensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.dispatch import (DispatchCore, EngineRequest,
                                         ExecutorBackend, RequestResult,
                                         SingleDeviceExecutor)
from repro_torch.engine.faults import FaultPlan
from repro_torch.engine.slots import RequestTooLong
from repro_torch.models import registry as R
from repro_torch.runtime import prng as P
from repro_torch.runtime import steps as ST


@dataclasses.dataclass
class EngineReport:
    results: List[RequestResult]
    ticks: int
    generated_tokens: int
    duration_s: float                 # engine-clock time (virtual or wall)
    wall_s: float                     # measured host time, always
    p99_latency_s: float
    tokens_per_s: float
    occupancy: List[int]              # active slots per tick
    mean_occupancy: float             # fraction of the pool in use
    admissions_while_busy: int        # requests admitted while some older
                                      # request was mid-generation
    num_slots: int
    mean_ttft_s: float = 0.0          # admission-to-first-token, mean
    p99_ttft_s: float = 0.0           # admission-to-first-token, p99
    prefill_chunk: Optional[int] = None
    dropped: int = 0                  # requests retired on deadline miss
    # paged KV cache (Engine(block_size=...)) memory accounting — all
    # defaults when the engine runs contiguous rows
    block_size: Optional[int] = None
    num_blocks: int = 0               # physical blocks incl. reserved trash
    kv_hbm_bytes: int = 0             # resident KV-cache bytes (all leaves)
    peak_blocks_used: int = 0         # high-water mark of held blocks
    mean_block_util: float = 0.0      # mean held / usable blocks, per tick
    shared_block_hits: int = 0        # prefix blocks reused at admission
    shared_hit_rate: float = 0.0      # hits / worst-case blocks demanded
    prefill_tokens_skipped: int = 0   # prompt tokens served from shared blocks
    leaked_blocks: int = 0            # pool deficit at drain (must be 0)
    effective_concurrency: float = 0.0  # mean active requests per tick
    # overload robustness (serve(preemption=..., fault_plan=...)):
    preempted: int = 0                # eviction events (exact resume each)
    failed: int = 0                   # requests retired by fault recovery
    unfinished: int = 0               # requests retired by the tick cap
    dispatch_retries: int = 0         # failed fused-step dispatch attempts
    nonfinite_samples: int = 0        # sentinel tokens caught by the guard
    torn_rows_repaired: int = 0       # block-table rows audited + rebuilt
    resumed_prefill_tokens: int = 0   # tokens the resumes teacher-forced
    stuck_ticks: int = 0              # wall-clock stragglers (watchdog)
    # per-SLO-class tails; goodput counts only completed requests that
    # met their deadline
    class_p99_latency_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    class_mean_ttft_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    class_p99_ttft_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    # active slots of each class, per tick (what a class quota caps)
    class_occupancy: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)
    goodput_tokens_per_s: float = 0.0
    slo_attainment: float = 0.0       # ok-and-on-time / all requests
    # speculative decoding (Engine(spec_k=..., draft=...|draft_layers=...))
    spec_k: int = 0                   # proposal depth (0 = not speculating)
    accepted_per_dispatch: float = 0.0  # committed tokens per emitting
                                        # row-tick: exactly 1.0 without
                                        # speculation, the mean accepted
                                        # run plus its bonus with it
    latency_per_token_s: float = 0.0  # mean over ok requests of
                                      # latency_s / emitted tokens

    def outputs(self) -> Dict[int, List[int]]:
        return {r.rid: r.tokens for r in self.results}


def _check_params_device(params, device: torch.device, what: str) -> None:
    table = params["embed"]["table"]
    table_dev = (table.values if isinstance(table, QTensor)
                 else table).device
    if table_dev.type != device.type:
        raise ValueError(f"{what} lie on {table_dev}, the engine runs on "
                         f"{device}")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP queue 1, "
                               f"item {item})")


class Engine:
    """Continuous-batching serving engine over a slot-based KV cache.

    ``Engine(cfg, params, mode=W8A16, num_slots=8, max_seq=..,
    prefill_chunk=4).serve(requests)``; add ``block_size=bs`` (a power of
    two) for the paged cache, and ``num_blocks`` to size its pool (default
    ``num_slots * max_seq // bs + 1``: every slot can hold a full row,
    plus the trash block).  ``device`` defaults to the card; pass
    ``device="cpu"`` to serve on the CPU with the kernels' plain versions.
    ``params`` must already lie on that device.

    ``temperature=t`` (> 0) samples with ``rng``, a threefry key (a JAX
    key's two uint32 words: ``runtime/prng.py::PRNGKey``, or
    ``np.asarray`` of ``jax.random.PRNGKey``), which it then needs.
    ``policy=AdmissionPolicy(class_quotas={...})`` caps the slots each
    SLO class may hold; ``serve(preemption=..., fault_plan=...,
    max_retries=...)`` runs the overload paths.

    ``spec_k=k`` (> 0) speculates with exactly one draft:
    ``draft_layers=n`` (a self-draft, the target's first n layers, no
    second checkpoint) or ``draft=(dcfg, dparams)`` (another model of the
    same vocabulary, its params on the engine's device).  Target and
    draft must both keep their whole decode state as positional KV
    (``registry.supports_speculation``).  The draft's cache is contiguous
    whatever the target's, of the draft config's KV kind (a self-draft's:
    the target's).

    The JAX engine's other options — multiplexing, a sharded backend —
    raise ``NotImplementedError`` naming their ROADMAP item."""

    def __init__(self, cfg: ArchConfig, params, *,
                 mode: QuantMode = FP,
                 num_slots: int = 8, max_seq: int = 64,
                 policy: Optional[bt.AdmissionPolicy] = None,
                 prefill_chunk: Optional[int] = None,
                 device: DeviceLike = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 temperature: float = 0.0, rng=None,
                 spec_k: int = 0,
                 draft: Optional[Tuple[ArchConfig, dict]] = None,
                 draft_layers: Optional[int] = None,
                 models=None,
                 backend: Optional[ExecutorBackend] = None,
                 name: Optional[str] = None):
        if models is not None:
            raise _not_ported("multi-model multiplexing", "14")
        if temperature > 0.0 and rng is None:
            raise ValueError("temperature sampling needs an rng key: "
                             "Engine(..., temperature=t, rng=key)")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k == 0 and (draft is not None or draft_layers is not None):
            raise ValueError("a draft model needs spec_k >= 1: "
                             "Engine(..., spec_k=k, draft=... or "
                             "draft_layers=...)")
        self.device = resolve_device(device)
        _check_params_device(params, self.device, "params")
        R.module_for(cfg)
        self.spec_k = spec_k
        self.dcfg = self.dparams = None
        if spec_k:
            if (draft is None) == (draft_layers is None):
                raise ValueError(
                    "speculative decoding needs exactly one of "
                    "draft=(cfg, params) or draft_layers=n "
                    "(truncated-layer self-draft)")
            if not R.supports_speculation(cfg):
                raise ValueError(
                    f"family {cfg.family!r} (window={cfg.window}) does not "
                    f"support speculative decoding: the target's decode "
                    f"state must be rewindable positional KV")
            if draft is not None:
                dcfg, dparams = draft
                if not R.supports_speculation(dcfg):
                    raise ValueError(
                        f"draft family {dcfg.family!r} "
                        f"(window={dcfg.window}) cannot draft: its decode "
                        f"state must be rewindable positional KV")
                if dcfg.vocab != cfg.vocab:
                    raise ValueError(
                        f"draft vocab {dcfg.vocab} != target vocab "
                        f"{cfg.vocab}: proposals would not be token-"
                        f"compatible")
                _check_params_device(dparams, self.device, "draft params")
            else:
                dcfg = R.draft_config(cfg, draft_layers)
                dparams = R.draft_params(cfg, params, draft_layers)
            self.dcfg, self.dparams = dcfg, dparams
        if num_blocks is not None and block_size is None:
            raise ValueError("num_blocks needs block_size: paged mode is "
                             "enabled by Engine(..., block_size=...)")
        if block_size is not None:
            if block_size < 1 or block_size & (block_size - 1):
                raise ValueError(
                    f"block_size must be a power of two, got {block_size}")
            if not R.supports_paging(cfg):
                raise ValueError(
                    f"family {cfg.family!r} (window={cfg.window}) does "
                    f"not support the paged KV cache")
        self.cfg, self.params = cfg, params
        self.mode = mode
        self.temperature = temperature
        # the key lives on the engine's device for good: the captured tick
        # copies it from there into its static input at each call
        self.rng = (P.as_key(rng, self.device) if temperature > 0.0
                    else None)
        self.name = name
        # the pool size rounds up the bucket ladder, the cache length to 16
        # (paged: to whole blocks as well)
        self.num_slots = ST.bucket_batch(num_slots)
        align = max(16, block_size) if block_size else 16
        self.max_seq = max_seq + (-max_seq) % align
        self.block_size = block_size
        if block_size:
            self.max_blocks = self.max_seq // block_size
            self.num_blocks = (num_blocks if num_blocks is not None
                               else self.num_slots * self.max_blocks + 1)
            if self.num_blocks < 2:
                raise ValueError(f"num_blocks must be >= 2, "
                                 f"got {self.num_blocks}")
        else:
            self.max_blocks = 0
            self.num_blocks = 0
        self.prefill_chunk = (ST.bucket_batch(prefill_chunk)
                              if prefill_chunk else None)
        # the draft's catch-up chunk cap: a tick's gap is at most 1 (after
        # a full accept), but admission and a resume feed whole prompts.
        # The draft's rows are spec_k positions longer, rounded up to 16:
        # a row proposes spec_k tokens from as late as max_seq - 3, whose
        # writes run up to spec_k - 3 past the last position a request
        # can use (the reference clamps them into the row)
        self.draft_cap = (self.prefill_chunk or 16) if spec_k else 0
        self.draft_seq = self.max_seq + 16 * -(-spec_k // 16)
        self.policy = policy or bt.AdmissionPolicy(
            lambda b: 0.0, max_batch=self.num_slots, max_wait_s=0.0)
        self.backend = backend if backend is not None \
            else SingleDeviceExecutor()
        self.backend.validate(self)
        self._cache: Optional[dict] = None
        self._draft_cache: Optional[dict] = None

    def step_keys(self) -> tuple:
        """The slot step's trailing arguments: ``(rng,)`` when the engine
        samples, none when it is greedy."""
        return () if self.rng is None else (self.rng,)

    def zeroed_cache(self) -> dict:
        """The engine's KV cache (paged: with its block tables), all zeros:
        built at the first call, zeroed in place at every later one —
        byte for byte a fresh cache, in the same tensors, which the
        captured slot step stays bound to from one run to the next."""
        with torch.inference_mode():
            if self._cache is None:
                S, dev = self.num_slots, self.device
                if self.block_size:
                    self._cache = R.init_paged_cache(
                        self.cfg, S, self.max_seq, self.block_size,
                        self.num_blocks, device=dev)
                else:
                    self._cache = R.init_cache(self.cfg, S, self.max_seq,
                                               device=dev)
            else:
                for t in self._cache.values():
                    t.zero_()
        return self._cache

    def zeroed_draft_cache(self) -> dict:
        """The draft model's cache (speculating engines), all zeros, as
        :meth:`zeroed_cache`: contiguous rows of ``draft_seq``
        positions."""
        with torch.inference_mode():
            if self._draft_cache is None:
                self._draft_cache = R.init_cache(
                    self.dcfg, self.num_slots, self.draft_seq,
                    device=self.device)
            else:
                for t in self._draft_cache.values():
                    t.zero_()
        return self._draft_cache

    def warmup(self) -> None:
        """Run the slot step once (and, with chunked prefill, the chunk
        step once for every chunk length it can be given: ``n`` tokens in
        a chunk of ``bucket_batch(n)``, for n up to ``prefill_chunk``) on
        the engine's cache, so that a wall-clock ``serve`` charges its
        first tick to serving, not to building and loading the kernels,
        the libraries' first-call set-up or, on the card, the capture of
        the steps' graphs: the next ``serve`` zeroes the cache in place
        and replays those graphs.  A speculating engine never runs the
        slot step: it runs the verify step in its place, and the propose
        step and the draft's chunk step (every n up to ``draft_cap``) on
        the draft's cache."""
        S = self.num_slots
        dev = self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def chunks(cfg, params, cache, cap):
            for n in range(1, cap + 1):
                c = ST.bucket_batch(n)
                self.backend.chunk_step(cfg, mode=self.mode, chunk=c)(
                    params, [0] * c, cache, 0, 0, n)

        with torch.inference_mode():
            cache = self.zeroed_cache()
            if self.spec_k:
                k = self.spec_k
                verify = self.backend.verify_step(
                    self.cfg, mode=self.mode, k=k,
                    temperature=self.temperature)
                verify(self.params, zeros(S, k + 1), cache, zeros(S),
                       zeros(S), zeros(S, dtype=torch.bool),
                       *self.step_keys())
                dcache = self.zeroed_draft_cache()
                propose = self.backend.propose_step(self.dcfg,
                                                    mode=self.mode, k=k)
                propose(self.dparams, zeros(S, 1), dcache, zeros(S),
                        zeros(S, dtype=torch.bool))
                chunks(self.dcfg, self.dparams, dcache, self.draft_cap)
            else:
                step = self.backend.slot_step(self.cfg, mode=self.mode,
                                              temperature=self.temperature)
                step(self.params, zeros(S, 1), cache, zeros(S),
                     zeros(S, dtype=torch.bool), *self.step_keys())
            chunks(self.cfg, self.params, cache, self.prefill_chunk or 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def serve(self, requests: Sequence[EngineRequest], *,
              clock: str = "virtual",
              tick_s: Union[float, Callable[[int], float]] = 1e-3,
              max_ticks: Optional[int] = None,
              drop_missed_deadlines: bool = False,
              preemption: bool = False,
              fault_plan: Optional[FaultPlan] = None,
              max_retries: int = 3) -> EngineReport:
        """Serve a whole request trace; return per-request outputs and
        achieved latency / throughput / occupancy.

        ``clock="virtual"``: time advances ``tick_s`` per tick (or
        ``tick_s(active_count)``) — deterministic.  ``clock="wall"``: the
        measured host clock, every tick ending in a wait for the card.
        ``drop_missed_deadlines=True`` retires a slot the tick its deadline
        passes.

        ``preemption=True`` lets admission-time pressure (no free slot,
        or a paged block claim the pool cannot cover) evict the active
        slot of strictly lower SLO class than the pending head, latest
        deadline first.  The victim's blocks are released, its host
        progress stashed, and it re-enters the pending queue; on
        re-admission its ``prompt + generated-so-far`` is teacher-forced
        through the chunk steps ``warmup`` captured, so the resumed
        output is bit for bit the never-preempted output.

        ``fault_plan`` injects a :class:`FaultPlan`'s failures at their
        ticks; the recovery (always on) retries failed dispatches,
        rebuilds a slot that samples the non-finite sentinel or loses a
        torn block-table row, and retires a slot still faulting after
        ``max_retries`` recovery attempts as ``failed``."""
        if clock not in ("virtual", "wall"):
            raise ValueError(f"clock must be 'virtual' or 'wall': {clock!r}")
        for r in requests:
            if r.max_new_tokens <= 0:
                raise ValueError(
                    f"request {r.rid}: max_new_tokens must be positive "
                    f"(got {r.max_new_tokens})")
            need = len(r.prompt) + r.max_new_tokens
            if need > self.max_seq:
                raise RequestTooLong(
                    f"request {r.rid} needs {need} cache positions > "
                    f"max_seq={self.max_seq}")
            if self.block_size:
                nb = -(-need // self.block_size)
                if nb > self.num_blocks - 1:
                    # would wait forever even against an empty pool
                    raise RequestTooLong(
                        f"request {r.rid} needs {nb} KV blocks > "
                        f"{self.num_blocks - 1} usable in the pool")
        reqs = sorted(requests, key=lambda r: r.arrival_s)
        S = self.num_slots
        with torch.inference_mode():
            out = DispatchCore(self).run(
                reqs, clock=clock, tick_s=tick_s, max_ticks=max_ticks,
                drop_missed_deadlines=drop_missed_deadlines,
                preemption=preemption, fault_plan=fault_plan,
                max_retries=max_retries)
        results = sorted(out.results, key=lambda r: r.rid)
        occupancy = out.occupancy
        lat = [r.latency_s for r in results if r.status == "ok"]
        ttft = [r.ttft_s for r in results if r.emitted]
        dur = max(out.now, 1e-12)
        good = [r for r in results
                if r.status == "ok" and r.finish_s <= r.deadline_s]
        lat_tok = [r.latency_s / len(r.tokens) for r in results
                   if r.status == "ok" and r.tokens]
        by_class: Dict[str, List[RequestResult]] = {}
        for r in results:
            by_class.setdefault(r.priority, []).append(r)
        cls_ttft = {c: [r.ttft_s for r in rs if r.emitted]
                    for c, rs in sorted(by_class.items())}
        return EngineReport(
            results=results, ticks=out.ticks,
            generated_tokens=out.gen_tokens,
            duration_s=out.now, wall_s=out.wall,
            p99_latency_s=bt.p99(lat),
            tokens_per_s=out.gen_tokens / dur,
            occupancy=occupancy,
            mean_occupancy=(sum(occupancy) / (len(occupancy) * S)
                            if occupancy else 0.0),
            admissions_while_busy=out.admissions_while_busy,
            num_slots=S,
            mean_ttft_s=float(np.mean(ttft)) if ttft else 0.0,
            p99_ttft_s=bt.p99(ttft),
            prefill_chunk=self.prefill_chunk,
            dropped=out.dropped,
            block_size=self.block_size,
            num_blocks=self.num_blocks,
            kv_hbm_bytes=out.kv_bytes,
            peak_blocks_used=out.peak_used,
            mean_block_util=(out.util_sum / out.ticks
                             if self.block_size and out.ticks else 0.0),
            shared_block_hits=out.shared_hits,
            shared_hit_rate=(out.shared_hits / out.blocks_demanded
                             if out.blocks_demanded else 0.0),
            prefill_tokens_skipped=out.skipped_tokens,
            leaked_blocks=out.leaked_blocks,
            effective_concurrency=(sum(occupancy) / len(occupancy)
                                   if occupancy else 0.0),
            preempted=out.preempted, failed=out.failed,
            unfinished=out.unfinished,
            dispatch_retries=out.dispatch_retries,
            nonfinite_samples=out.nonfinite,
            torn_rows_repaired=out.torn_repaired,
            resumed_prefill_tokens=out.resumed_tokens,
            stuck_ticks=out.stuck_ticks,
            class_p99_latency_s={
                c: bt.p99([r.latency_s for r in rs if r.status == "ok"])
                for c, rs in sorted(by_class.items())},
            class_mean_ttft_s={c: (float(np.mean(ts)) if ts else 0.0)
                               for c, ts in cls_ttft.items()},
            class_p99_ttft_s={c: bt.p99(ts) for c, ts in cls_ttft.items()},
            class_occupancy=out.occ_by_class,
            goodput_tokens_per_s=sum(len(r.tokens) for r in good) / dur,
            slo_attainment=(len(good) / len(results) if results else 0.0),
            spec_k=self.spec_k,
            accepted_per_dispatch=(out.gen_tokens / out.emit_dispatches
                                   if out.emit_dispatches else 0.0),
            latency_per_token_s=(float(np.mean(lat_tok))
                                 if lat_tok else 0.0))


# ---------------------------------------------------------------------------
# sequential reference + trace synthesis
# ---------------------------------------------------------------------------

def reference_outputs(cfg: ArchConfig, params,
                      requests: Sequence[EngineRequest], *,
                      mode: QuantMode = FP, max_seq: int = 64,
                      device: DeviceLike = None,
                      temperature: float = 0.0, rng=None,
                      margins: Optional[Dict[int, List[float]]] = None
                      ) -> Dict[int, List[int]]:
    """The sequential per-token reference loop: each request alone at
    batch 1, prompt teacher-forced a token at a time, then greedy
    generation — the bit-for-bit baseline the engine must reproduce.

    With ``temperature > 0`` the token after position p is drawn with the
    key ``fold_in(rng, p)`` by the engine's own sampler
    (``steps.temperature_sample_rows`` at batch 1), the schedule the slot
    tick and the decode loop use.

    When ``margins`` is a dict, ``margins[rid]`` receives the gap between
    the two largest scores at each generated token (how near a tie the
    choice was): the logits, or when sampling the perturbed scores
    ``logits / t + gumbel``."""
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature sampling needs an rng key")
    device = resolve_device(device)
    decode = ST.make_decode_step(cfg, mode=mode)
    key = P.as_key(rng, device) if temperature > 0.0 else None
    out: Dict[int, List[int]] = {}
    with torch.inference_mode():
        for r in sorted(requests, key=lambda x: x.rid):
            cache = R.init_cache(cfg, 1, max_seq, device=device)
            tok = None
            gen: List[int] = []
            gaps: List[float] = []
            feed = list(r.prompt)
            pos = 0
            while len(gen) < r.max_new_tokens:
                cur = feed[pos] if pos < len(feed) else tok
                logits, cache = decode(
                    params,
                    {"tokens": torch.tensor([[cur]], dtype=torch.int32,
                                            device=device),
                     "cache_index": pos}, cache)
                pos += 1
                if pos >= len(feed):
                    if key is not None:
                        scores = ST.sampling_scores(
                            logits, P.fold_in(key, [pos - 1]), temperature)
                    else:
                        scores = logits[:, -1].float()
                    tok = int(torch.argmax(scores[0]))
                    gen.append(tok)
                    if margins is not None:
                        top2 = torch.topk(scores[0], 2).values
                        gaps.append(float(top2[0] - top2[1]))
            out[r.rid] = gen
            if margins is not None:
                margins[r.rid] = gaps
    return out


def synthetic_requests(n: int, *, rate_per_s: float, vocab: int,
                       prompt_len: int = 4, max_new_tokens: int = 8,
                       deadline_s: float = float("inf"),
                       seed: int = 0,
                       shared_prefix_len: int = 0,
                       priority: Union[str, Callable[[int], str]]
                       = "interactive") -> List[EngineRequest]:
    """Deterministic pseudo-Poisson request trace with synthetic prompts
    derived from the rid — byte-identical to the reference's
    ``synthetic_requests`` with the same arguments.

    ``shared_prefix_len=k`` makes the first ``k`` prompt tokens identical
    across all requests; ``priority`` tags every request with an SLO class
    (a string) or a per-request one (a ``rid -> class`` callable)."""
    if not 0 <= shared_prefix_len <= prompt_len:
        raise ValueError(
            f"shared_prefix_len must be in [0, prompt_len={prompt_len}], "
            f"got {shared_prefix_len}")
    arr = bt.poisson_arrivals(rate_per_s, n, 0.0, seed)
    cls_of = priority if callable(priority) else (lambda rid: priority)
    reqs = []
    for a in arr:
        prompt = tuple(
            (1 + (11 * j + 13 * seed) % (vocab - 1))
            if j < shared_prefix_len
            else (1 + (a.rid * 7 + 3 * j) % (vocab - 1))
            for j in range(prompt_len))
        reqs.append(EngineRequest(
            rid=a.rid, prompt=prompt, max_new_tokens=max_new_tokens,
            arrival_s=a.arrival_s,
            deadline_s=(a.arrival_s + deadline_s
                        if deadline_s != float("inf") else float("inf")),
            priority=cls_of(a.rid)))
    return reqs
