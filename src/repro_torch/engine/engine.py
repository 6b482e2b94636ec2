"""The continuous-batching engine: one fused slot-masked step per tick.

Port of ``repro/engine/engine.py``, greedy or sampled at one
engine-wide temperature, for one model or several:

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
- A family that primes (encdec, vlm) takes each request's ``source``
  (encdec's frames, vlm's patch embeddings): at admission, and again at
  a resume, a prime dispatch runs the encoder (encdec) or projects the
  patches (vlm) once and writes the slot's row of cross k/v and its
  ``xlen`` frontier (``runtime/steps.py::jit_prime_step``, one graph for
  every slot).
- A recurrent family (ssm, hybrid) keeps a fixed-size state per slot
  (the hybrid's local-attention ring beside it): a row at
  position 0 zeroes it first and a row the tick does not advance keeps
  it bitwise, so a reused, preempted or rebuilt slot re-prefills from
  position 0 into clean state; it refuses ``block_size`` and ``spec_k``
  (no positions to page or rewind).
- Scale-out: ``backend=ShardedExecutor(tp, devices=[device] * tp)``
  splits the slot pool into ``tp`` shards, each advancing its rows with
  the same weights, bit for bit the single-device engine.
- Multiplexing: ``Engine(models={tag: (cfg, params)})`` serves several
  models as lanes of one engine (``engine/dispatch.py::_Lane``): each
  lane its own steps, caches and pools, one fused step a lane a tick,
  ``num_slots`` one lease budget across lanes, quotas by model and
  class, and hot-swap (``admit_model``, ``retire_model``,
  ``serve(control=...)``).  ``engine/router.py::ReplicaRouter`` places a
  trace on several engines.

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
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import batching as bt
from repro_torch.core.qlinear import FP, QuantMode
from repro_torch.core.quant import QTensor
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.engine.dispatch import (DispatchCore, EngineRequest,
                                         ExecutorBackend, RequestResult,
                                         SingleDeviceExecutor, _Lane,
                                         padded_source, validate_source)
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
    # hot-swap (Engine.retire_model, serve(control=...)): requests whose
    # lane was retired, or not admitted, when admission reached them
    refused: int = 0
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
    # multiplexing (Engine(models={...})): per-model tails, goodput and
    # occupancy, empty on a single-model engine.  A lane's occupancy is
    # its active slots over the shared lease budget (num_slots), so the
    # lanes' fractions sum to mean_occupancy
    model_p99_latency_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    model_mean_ttft_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    model_p99_ttft_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    model_goodput_tokens_per_s: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    model_mean_occupancy: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    model_occupancy: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)        # per-tick active slots of each lane

    def outputs(self) -> Dict[int, List[int]]:
        return {r.rid: r.tokens for r in self.results}

    def outputs_for(self, model: Optional[str]) -> Dict[int, List[int]]:
        """One lane's outputs: what a dedicated engine is held to."""
        return {r.rid: r.tokens for r in self.results if r.model == model}


def _check_params_device(params, device: torch.device, what: str) -> None:
    table = params["embed"]["table"]
    table_dev = (table.values if isinstance(table, QTensor)
                 else table).device
    if table_dev.type != device.type:
        raise ValueError(f"{what} lie on {table_dev}, the engine runs on "
                         f"{device}")


def _what(tag: Optional[str], what: str) -> str:
    return what if tag is None else f"model {tag!r}'s {what}"


def _check_tag(tag) -> None:
    if not isinstance(tag, str) or not tag:
        raise ValueError(f"model tag must be a non-empty string, got {tag!r}")


def _check_paging(tag: Optional[str], cfg: ArchConfig) -> None:
    if not R.supports_paging(cfg):
        raise ValueError(
            f"family {cfg.family!r} (window={cfg.window}"
            f"{'' if tag is None else f', model {tag!r}'}) does not "
            f"support the paged KV cache")


class Engine:
    """Continuous-batching serving engine over a slot-based KV cache.

    Single-model: ``Engine(cfg, params, mode=W8A16, num_slots=8,
    max_seq=.., prefill_chunk=4).serve(requests)`` — one model lane
    tagged ``None``, every request untagged.  Add ``block_size=bs`` (a
    power of two) for the paged cache, and ``num_blocks`` to size its
    pool (default ``num_slots * max_seq // bs + 1``: every slot can hold
    a full row, plus the trash block).  ``device`` defaults to the card;
    pass ``device="cpu"`` to serve on the CPU with the kernels' plain
    versions.  ``params`` must already lie on that device.

    Multiplexed: ``Engine(models={tag: (cfg, params)}, ...)`` — one lane
    a model, each with its own steps, caches, slot pool and (paged) block
    pool, whose requests name it in ``EngineRequest.model``.  A tick runs
    one fused step a lane with ready slots, and ``num_slots`` is one
    lease budget capping the active slots of all lanes together (each
    lane's pool holds ``num_slots`` rows, so any lane may take the whole
    budget).  Admission meters ``(model, class)``, model and class quota
    keys through the same ``AdmissionPolicy``
    (``class_quotas={"tag": n}`` caps a lane).  :meth:`admit_model` and
    :meth:`retire_model` change the lanes, also on a live serve through
    ``serve(control=...)``.

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
    the target's).  A multiplexed engine takes ``draft_layers=n`` only:
    each lane that can draft self-drafts, the others serve without
    speculation.

    ``backend=ShardedExecutor(tp, devices=[device] * tp)`` splits the
    slot pool into ``tp`` shards on the engine's device, bit for bit the
    default single-device backend (``engine/dispatch.py``; shards on
    several cards raise ``NotImplementedError`` naming their ROADMAP
    item); every lane takes its steps from it.  ``name`` labels the
    engine in straggler warnings and router reports."""

    def __init__(self, cfg: Optional[ArchConfig] = None, params=None, *,
                 models: Optional[Dict[str, Tuple[ArchConfig, dict]]] = None,
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
                 backend: Optional[ExecutorBackend] = None,
                 name: Optional[str] = None):
        if (models is None) == (cfg is None):
            raise ValueError("exactly one of Engine(cfg, params) or "
                             "Engine(models={tag: (cfg, params)})")
        if temperature > 0.0 and rng is None:
            raise ValueError("temperature sampling needs an rng key: "
                             "Engine(..., temperature=t, rng=key)")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if spec_k == 0 and (draft is not None or draft_layers is not None):
            raise ValueError("a draft model needs spec_k >= 1: "
                             "Engine(..., spec_k=k, draft=... or "
                             "draft_layers=...)")
        self.multi = models is not None
        if self.multi:
            if not models:
                raise ValueError("models must name at least one "
                                 "(cfg, params) lane")
            for tag in models:
                _check_tag(tag)
            if spec_k and draft is not None:
                raise ValueError(
                    "a multiplexed engine cannot take one explicit "
                    "draft=(cfg, params) for every lane (vocabs differ); "
                    "use draft_layers=n — each supporting lane self-drafts")
            if spec_k and draft_layers is None:
                raise ValueError("multiplexed speculation needs "
                                 "draft_layers=n")
            lane_cfgs = dict(models)
        else:
            lane_cfgs = {None: (cfg, params)}
        self.device = resolve_device(device)
        for tag, (mcfg, mparams) in lane_cfgs.items():
            _check_params_device(mparams, self.device, _what(tag, "params"))
            R.module_for(mcfg)
        if spec_k and not self.multi:
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
        if num_blocks is not None and block_size is None:
            raise ValueError("num_blocks needs block_size: paged mode is "
                             "enabled by Engine(..., block_size=...)")
        if block_size is not None:
            if block_size < 1 or block_size & (block_size - 1):
                raise ValueError(
                    f"block_size must be a power of two, got {block_size}")
            for tag, (mcfg, _) in lane_cfgs.items():
                _check_paging(tag, mcfg)
        self.spec_k = spec_k
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
            # a lane's pool: every slot can hold a full row privately,
            # plus the trash block, unless num_blocks says otherwise
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
        self._draft = draft
        self._draft_layers = draft_layers
        self._epoch = 0                  # hot-swap admissions so far
        self.lanes: Dict[Optional[str], _Lane] = {
            tag: self._new_lane(tag, order, mcfg, mparams)
            for order, (tag, (mcfg, mparams)) in enumerate(lane_cfgs.items())}
        # the first lane's config, params and draft, where a caller of a
        # single-model engine expects them
        lane0 = next(iter(self.lanes.values()))
        self.cfg, self.params = lane0.cfg, lane0.params
        self.dcfg, self.dparams = lane0.dcfg, lane0.dparams

    def _new_lane(self, tag, order, cfg, params) -> _Lane:
        """A lane and its draft: the engine's draft, its self-draft of
        ``draft_layers``, or none (not speculating, or a multiplexed lane
        whose family cannot draft)."""
        spec_k, dcfg, dparams = self.spec_k, None, None
        if spec_k:
            if self.multi and not R.supports_speculation(cfg):
                spec_k = 0
            elif self._draft is not None:
                dcfg, dparams = self._draft
            else:
                dcfg = R.draft_config(cfg, self._draft_layers)
                dparams = R.draft_params(cfg, params, self._draft_layers)
        return _Lane(self, tag, order, cfg, params, spec_k, dcfg, dparams)

    @property
    def _cache(self) -> Optional[dict]:
        """The first lane's cache, None before its first serve."""
        return next(iter(self.lanes.values()))._cache

    def step_keys(self) -> tuple:
        """The slot step's trailing arguments: ``(rng,)`` when the engine
        samples, none when it is greedy."""
        return () if self.rng is None else (self.rng,)

    def zeroed_cache(self) -> dict:
        """The first lane's KV cache (a single-model engine's), all zeros:
        :meth:`_Lane.zeroed_cache` — built at the first call, zeroed in
        place at every later one, in the same tensors, which the captured
        slot step stays bound to from one run to the next."""
        return next(iter(self.lanes.values())).zeroed_cache()

    # -- hot-swap: admit / retire a lane on a live engine ---------------

    def admit_model(self, tag: str, cfg: ArchConfig, params) -> None:
        """Admit a model lane; legal mid-serve (through
        ``serve(control=...)``).  The lane's order follows the others', so
        their global fault ids stay as they were, and its pools start
        empty: no other lane drains or stalls.  Its steps are warmed up on
        its own cache here (on the card, captured), so its ticks replay
        from the first."""
        if not self.multi:
            raise ValueError("hot-swap needs a multiplexed engine: "
                             "Engine(models={...})")
        _check_tag(tag)
        if tag in self.lanes:
            raise ValueError(f"model {tag!r} is already admitted")
        _check_params_device(params, self.device, _what(tag, "params"))
        R.module_for(cfg)
        if self.block_size is not None:
            _check_paging(tag, cfg)
        order = 1 + max((ln.order for ln in self.lanes.values()),
                        default=-1)
        lane = self._new_lane(tag, order, cfg, params)
        self._epoch += 1
        lane.epoch = self._epoch
        self._warm(lane)
        self.lanes[tag] = lane

    def retire_model(self, tag: str) -> None:
        """Mark a lane retiring: its in-flight slots finish as they would
        have, and admission refuses every new request for it with the
        typed ``refused`` status.  The serve removes the drained lane
        when it ends."""
        if tag not in self.lanes:
            raise ValueError(
                f"model {tag!r} is not admitted on this engine "
                f"(lanes: {list(self.lanes)})")
        self.lanes[tag].retiring = True

    def warmup(self) -> None:
        """For every lane, run the slot step once (and, with chunked
        prefill, the chunk step once for every chunk length it can be
        given: ``n`` tokens in a chunk of ``bucket_batch(n)``, for n up to
        ``prefill_chunk``; a family that primes, the prime step once on a
        zero source) on the lane's cache, so that a wall-clock ``serve``
        charges its first tick to serving, not to building and loading
        the kernels, the libraries' first-call set-up or, on the card,
        the capture of the steps' graphs: the next ``serve`` zeroes the
        caches in place and replays those graphs.  A speculating lane
        never runs the slot step: it runs the verify step in its place,
        and the propose step and the draft's chunk step (every n up to
        ``draft_cap``) on the draft's cache."""
        for ln in self.lanes.values():
            self._warm(ln)

    def _warm(self, ln: _Lane) -> None:
        S = self.num_slots
        dev = self.device

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        # a single-slot step runs on its slot's shard alone: once a shard
        starts = self.backend.shard_starts(S)

        def chunks(cfg, params, cache, cap):
            for sid in starts:
                for n in range(1, cap + 1):
                    c = ST.bucket_batch(n)
                    self.backend.chunk_step(cfg, mode=self.mode, chunk=c)(
                        params, [0] * c, cache, sid, 0, n)

        with torch.inference_mode():
            cache = ln.zeroed_cache()
            if R.needs_prime(ln.cfg):
                prime = self.backend.prime_step(ln.cfg, mode=self.mode)
                for sid in starts:
                    prime(ln.params, torch.zeros(
                        (1, R.source_len(ln.cfg), ln.cfg.d_model),
                        dtype=torch.bfloat16), cache, sid, 0)
            if ln.spec_k:
                k = ln.spec_k
                verify = self.backend.verify_step(
                    ln.cfg, mode=self.mode, k=k,
                    temperature=self.temperature)
                verify(ln.params, zeros(S, k + 1), cache, zeros(S),
                       zeros(S), zeros(S, dtype=torch.bool),
                       *self.step_keys())
                dcache = ln.zeroed_draft_cache()
                propose = self.backend.propose_step(ln.dcfg,
                                                    mode=self.mode, k=k)
                propose(ln.dparams, zeros(S, 1), dcache, zeros(S),
                        zeros(S, dtype=torch.bool))
                chunks(ln.dcfg, ln.dparams, dcache, self.draft_cap)
            else:
                step = self.backend.slot_step(ln.cfg, mode=self.mode,
                                              temperature=self.temperature)
                step(ln.params, zeros(S, 1), cache, zeros(S),
                     zeros(S, dtype=torch.bool), *self.step_keys())
            chunks(ln.cfg, ln.params, cache, self.prefill_chunk or 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def serve(self, requests: Sequence[EngineRequest], *,
              clock: str = "virtual",
              tick_s: Union[float, Mapping,
                            Callable[[int], float]] = 1e-3,
              max_ticks: Optional[int] = None,
              drop_missed_deadlines: bool = False,
              preemption: bool = False,
              fault_plan: Optional[FaultPlan] = None,
              max_retries: int = 3,
              control: Sequence[Tuple[float, Callable]] = ()
              ) -> EngineReport:
        """Serve a whole request trace; return per-request outputs and
        achieved latency / throughput / occupancy.

        ``clock="virtual"``: time advances ``tick_s`` per tick (or
        ``tick_s(active_count)``) — deterministic; a Mapping ``tick_s``
        ({lane tag: seconds}, every lane priced) charges each tick the
        sum of the lanes it dispatched.  ``clock="wall"``: the measured
        host clock, every tick ending in a wait for the card.
        ``drop_missed_deadlines=True`` retires a slot the tick its deadline
        passes.

        ``preemption=True`` lets admission-time pressure (no free slot,
        or a paged block claim the lane's pool cannot cover) evict the
        active slot of strictly lower SLO class than the pending head,
        latest deadline first.  The victim's blocks are released, its host
        progress stashed, and it re-enters the pending queue; on
        re-admission its ``prompt + generated-so-far`` is teacher-forced
        through the chunk steps ``warmup`` captured, so the resumed
        output is bit for bit the never-preempted output.

        ``fault_plan`` injects a :class:`FaultPlan`'s failures at their
        ticks, each at a dense global slot id (``lane.order * num_slots +
        sid``); the recovery (always on) retries failed dispatches,
        rebuilds a slot that samples the non-finite sentinel or loses a
        torn block-table row, and retires a slot still faulting after
        ``max_retries`` recovery attempts as ``failed``.

        ``control`` schedules hot-swap operations on the live serve:
        ``(time_s, fn)`` pairs, each ``fn(engine)`` run at the first tick
        boundary past its time (closures over :meth:`admit_model` and
        :meth:`retire_model`).  With a control schedule a request may name
        a lane that is not admitted yet; one whose lane is retiring, or
        still unknown, when admission reaches it comes back ``refused``.

        A family that primes needs every request's ``source``; each is
        checked before anything is admitted."""
        if clock not in ("virtual", "wall"):
            raise ValueError(f"clock must be 'virtual' or 'wall': {clock!r}")
        if isinstance(tick_s, Mapping):
            if clock != "virtual":
                raise ValueError("per-lane tick_s mapping needs the "
                                 "virtual clock")
            missing = [t for t in self.lanes if t not in tick_s]
            if missing:
                raise ValueError(
                    f"per-lane tick_s must price every lane; missing "
                    f"{missing} (keys: {sorted(tick_s, key=repr)})")
        for t_ctl, fn_ctl in control:
            if not callable(fn_ctl):
                raise ValueError(
                    f"control entries must be (time_s, callable), got "
                    f"({t_ctl!r}, {fn_ctl!r})")
        for r in requests:
            lane = self.lanes.get(r.model)
            if lane is None and not control:
                raise ValueError(
                    f"request {r.rid}: model {r.model!r} is not admitted "
                    f"on this engine (lanes: {list(self.lanes)})")
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
            if lane is not None and R.needs_prime(lane.cfg):
                validate_source(lane.cfg, r)
        reqs = sorted(requests, key=lambda r: r.arrival_s)
        S = self.num_slots
        with torch.inference_mode():
            out = DispatchCore(self).run(
                reqs, clock=clock, tick_s=tick_s, max_ticks=max_ticks,
                drop_missed_deadlines=drop_missed_deadlines,
                preemption=preemption, fault_plan=fault_plan,
                max_retries=max_retries, control=control)
        # hot-swap: a retired lane that has drained leaves the engine (and
        # its caches with it); the report still covers it
        for tag in [t for t, ln in self.lanes.items()
                    if ln.retiring and ln.pool.active_count == 0]:
            del self.lanes[tag]
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
        # per-model tails, goodput and occupancy: multiplexed engines only
        # (empty on a single-model engine)
        by_model: Dict[str, List[RequestResult]] = {}
        if self.multi:
            by_model = {ln.tag: [] for ln in out.lanes}
            for r in results:
                by_model.setdefault(r.model, []).append(r)
        mdl_ttft = {m: [r.ttft_s for r in rs if r.emitted]
                    for m, rs in by_model.items()}
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
            refused=out.refused,
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
                                 if lat_tok else 0.0),
            model_p99_latency_s={
                m: bt.p99([r.latency_s for r in rs if r.status == "ok"])
                for m, rs in by_model.items()},
            model_mean_ttft_s={m: (float(np.mean(ts)) if ts else 0.0)
                               for m, ts in mdl_ttft.items()},
            model_p99_ttft_s={m: bt.p99(ts) for m, ts in mdl_ttft.items()},
            model_goodput_tokens_per_s={
                m: sum(len(r.tokens) for r in rs if r.status == "ok"
                       and r.finish_s <= r.deadline_s) / dur
                for m, rs in by_model.items()},
            model_mean_occupancy={
                t: (sum(v) / (len(v) * S) if v else 0.0)
                for t, v in out.occ_by_lane.items()},
            model_occupancy={t: list(v)
                             for t, v in out.occ_by_lane.items()})


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

    A family that primes (encdec, vlm) primes each request's cache with
    its padded source through the engine's prime computation, at a pool
    of one slot, and decodes with a (1,) index (the per-row form the
    engine's slot rows take).

    When ``margins`` is a dict, ``margins[rid]`` receives the gap between
    the two largest scores at each generated token (how near a tie the
    choice was): the logits, or when sampling the perturbed scores
    ``logits / t + gumbel``."""
    if temperature > 0.0 and rng is None:
        raise ValueError("temperature sampling needs an rng key")
    device = resolve_device(device)
    decode = ST.make_decode_step(cfg, mode=mode)
    prime = (ST.make_prime_step(cfg, mode=mode) if R.needs_prime(cfg)
             else None)
    key = P.as_key(rng, device) if temperature > 0.0 else None
    out: Dict[int, List[int]] = {}
    with torch.inference_mode():
        for r in sorted(requests, key=lambda x: x.rid):
            cache = R.init_cache(cfg, 1, max_seq, device=device)
            if prime is not None:
                src, n_valid = padded_source(cfg, r)
                cache = prime(params, src, cache, 0, n_valid)
            tok = None
            gen: List[int] = []
            gaps: List[float] = []
            feed = list(r.prompt)
            pos = 0
            while len(gen) < r.max_new_tokens:
                cur = feed[pos] if pos < len(feed) else tok
                idx = (torch.tensor([pos], dtype=torch.int32, device=device)
                       if prime is not None else pos)
                logits, cache = decode(
                    params,
                    {"tokens": torch.tensor([[cur]], dtype=torch.int32,
                                            device=device),
                     "cache_index": idx}, cache)
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
                       source_shape: Optional[Tuple[int, int]] = None,
                       priority: Union[str, Callable[[int], str]]
                       = "interactive",
                       model: Union[None, str, Callable[[int], str]]
                       = None) -> List[EngineRequest]:
    """Deterministic pseudo-Poisson request trace with synthetic prompts
    derived from the rid — byte-identical to the reference's
    ``synthetic_requests`` with the same arguments.

    ``shared_prefix_len=k`` makes the first ``k`` prompt tokens identical
    across all requests; ``source_shape=(source_len, d_model)`` attaches
    per-request source frames for a family that primes (rid-seeded
    gaussians whose length cycles through full, -1, -2, so a pool holds
    rows of different ``xlen`` at once); ``priority`` tags every request
    with an SLO class (a string) or a per-request one (a ``rid -> class``
    callable); ``model`` tags it with a multiplexed engine's lane (a
    string, or a ``rid -> tag`` callable; None leaves it untagged)."""
    if not 0 <= shared_prefix_len <= prompt_len:
        raise ValueError(
            f"shared_prefix_len must be in [0, prompt_len={prompt_len}], "
            f"got {shared_prefix_len}")
    arr = bt.poisson_arrivals(rate_per_s, n, 0.0, seed)
    cls_of = priority if callable(priority) else (lambda rid: priority)
    mdl_of = model if callable(model) else (lambda rid: model)
    reqs = []
    for a in arr:
        prompt = tuple(
            (1 + (11 * j + 13 * seed) % (vocab - 1))
            if j < shared_prefix_len
            else (1 + (a.rid * 7 + 3 * j) % (vocab - 1))
            for j in range(prompt_len))
        source = None
        if source_shape is not None:
            smax, d = source_shape
            src_len = max(1, smax - a.rid % 3)
            g = np.random.default_rng((seed + 1) * 1_000_003 + a.rid)
            source = g.standard_normal((src_len, d)).astype(np.float32)
        reqs.append(EngineRequest(
            rid=a.rid, prompt=prompt, max_new_tokens=max_new_tokens,
            arrival_s=a.arrival_s,
            deadline_s=(a.arrival_s + deadline_s
                        if deadline_s != float("inf") else float("inf")),
            source=source, priority=cls_of(a.rid), model=mdl_of(a.rid)))
    return reqs
