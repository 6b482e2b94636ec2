"""The continuous-batching engine: one fused slot-masked step per tick.

Port of ``repro/engine/engine.py`` for one model with greedy sampling:

- The KV cache is a fixed pool of ``num_slots`` rows of ``max_seq``
  positions, owned by the engine and zeroed in place for each run; every
  tick advances every ready slot by one token in one call of the slot
  step (active mask folded into sampling and index advance), which on
  the card replays a CUDA graph captured over that cache
  (``runtime/steps.py::jit_slot_decode_step``).
- With ``block_size=bs`` the rows are paged: ``num_blocks`` physical KV
  blocks of ``bs`` positions behind per-slot block tables, with
  refcounted sharing of whole prompt-prefix blocks (a hit skips their
  prefill) and admission priced in blocks against the pool.
- With ``prefill_chunk=c``, a newly admitted slot's prompt (all but the
  last token) is written by the chunked prefill step, ``c`` tokens per
  tick, concurrently with other slots' decoding.
- Admission consults the shared ``core.batching.AdmissionPolicy``;
  retired slots return to the pool the same tick they finish.

``reference_outputs`` is the sequential per-token loop (batch 1, same
decode math, contiguous cache) the engine must match bit for bit, paged
or not: every kernel and plain version computes a row independently of
the batch it sits in, and the paged kernel reads a row in the very order
the contiguous one does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Union

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
from repro_torch.engine.slots import RequestTooLong
from repro_torch.models import registry as R
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
    failed: int = 0                   # requests retired on non-finite logits
    unfinished: int = 0               # requests retired by the tick cap
    nonfinite_samples: int = 0        # sentinel tokens caught by the guard
    stuck_ticks: int = 0              # wall-clock stragglers (watchdog)
    goodput_tokens_per_s: float = 0.0
    slo_attainment: float = 0.0       # ok-and-on-time / all requests
    latency_per_token_s: float = 0.0  # mean over ok requests

    def outputs(self) -> Dict[int, List[int]]:
        return {r.rid: r.tokens for r in self.results}


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

    The JAX engine's other options — temperature sampling, speculation,
    multiplexing, a sharded backend — raise ``NotImplementedError``
    naming their ROADMAP item."""

    def __init__(self, cfg: ArchConfig, params, *,
                 mode: QuantMode = FP,
                 num_slots: int = 8, max_seq: int = 64,
                 policy: Optional[bt.AdmissionPolicy] = None,
                 prefill_chunk: Optional[int] = None,
                 device: DeviceLike = None,
                 block_size: Optional[int] = None,
                 num_blocks: Optional[int] = None,
                 temperature: float = 0.0,
                 spec_k: int = 0,
                 models=None,
                 backend: Optional[ExecutorBackend] = None,
                 name: Optional[str] = None):
        if models is not None:
            raise _not_ported("multi-model multiplexing", "14")
        if temperature > 0.0:
            raise _not_ported("temperature sampling", "10")
        if spec_k:
            raise _not_ported("speculative decoding", "14")
        self.device = resolve_device(device)
        table = params["embed"]["table"]
        table_dev = (table.values if isinstance(table, QTensor)
                     else table).device
        if table_dev.type != self.device.type:
            raise ValueError(f"params lie on {table_dev}, the engine runs "
                             f"on {self.device}")
        R.module_for(cfg)
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
            if not cfg.kv_quant:
                raise _not_ported("the paged bf16 KV cache", "17")
        self.cfg, self.params = cfg, params
        self.mode = mode
        self.temperature = temperature
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
        self.policy = policy or bt.AdmissionPolicy(
            lambda b: 0.0, max_batch=self.num_slots, max_wait_s=0.0)
        self.backend = backend if backend is not None \
            else SingleDeviceExecutor()
        self.backend.validate(self)
        self._cache: Optional[dict] = None

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

    def warmup(self) -> None:
        """Run the slot step (and, with chunked prefill, the chunk step)
        once on the engine's cache, so that a wall-clock ``serve`` charges
        its first tick to serving, not to building and loading the
        kernels, the libraries' first-call set-up or, on the card, the
        capture of the slot step's graph: the next ``serve`` zeroes the
        cache in place and replays that graph."""
        S = self.num_slots
        dev = self.device
        with torch.inference_mode():
            cache = self.zeroed_cache()
            step = self.backend.slot_step(self.cfg, mode=self.mode,
                                          temperature=self.temperature)
            step(self.params, torch.zeros((S, 1), dtype=torch.int32,
                                          device=dev), cache,
                 torch.zeros((S,), dtype=torch.int32, device=dev),
                 torch.zeros((S,), dtype=torch.bool, device=dev))
            if self.prefill_chunk:
                chunk = self.backend.chunk_step(self.cfg, mode=self.mode,
                                                chunk=self.prefill_chunk)
                chunk(self.params, [0] * self.prefill_chunk, cache, 0, 0, 1)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def serve(self, requests: Sequence[EngineRequest], *,
              clock: str = "virtual",
              tick_s: Union[float, Callable[[int], float]] = 1e-3,
              max_ticks: Optional[int] = None,
              drop_missed_deadlines: bool = False,
              preemption: bool = False,
              fault_plan=None) -> EngineReport:
        """Serve a whole request trace; return per-request outputs and
        achieved latency / throughput / occupancy.

        ``clock="virtual"``: time advances ``tick_s`` per tick (or
        ``tick_s(active_count)``) — deterministic.  ``clock="wall"``: the
        measured host clock, every tick ending in a wait for the card.
        ``drop_missed_deadlines=True`` retires a slot the tick its deadline
        passes."""
        if clock not in ("virtual", "wall"):
            raise ValueError(f"clock must be 'virtual' or 'wall': {clock!r}")
        if preemption:
            raise _not_ported("preemption with exact resume", "12")
        if fault_plan is not None:
            raise _not_ported("fault injection", "12")
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
                drop_missed_deadlines=drop_missed_deadlines)
        results = sorted(out.results, key=lambda r: r.rid)
        occupancy = out.occupancy
        lat = [r.latency_s for r in results if r.status == "ok"]
        ttft = [r.ttft_s for r in results if r.emitted]
        dur = max(out.now, 1e-12)
        good = [r for r in results
                if r.status == "ok" and r.finish_s <= r.deadline_s]
        lat_tok = [r.latency_s / len(r.tokens) for r in results
                   if r.status == "ok" and r.tokens]
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
            failed=out.failed, unfinished=out.unfinished,
            nonfinite_samples=out.nonfinite, stuck_ticks=out.stuck_ticks,
            goodput_tokens_per_s=sum(len(r.tokens) for r in good) / dur,
            slo_attainment=(len(good) / len(results) if results else 0.0),
            latency_per_token_s=(float(np.mean(lat_tok))
                                 if lat_tok else 0.0))


# ---------------------------------------------------------------------------
# sequential reference + trace synthesis
# ---------------------------------------------------------------------------

def reference_outputs(cfg: ArchConfig, params,
                      requests: Sequence[EngineRequest], *,
                      mode: QuantMode = FP, max_seq: int = 64,
                      device: DeviceLike = None,
                      margins: Optional[Dict[int, List[float]]] = None
                      ) -> Dict[int, List[int]]:
    """The sequential per-token reference loop: each request alone at
    batch 1, prompt teacher-forced a token at a time, then greedy
    generation — the bit-for-bit baseline the engine must reproduce.

    When ``margins`` is a dict, ``margins[rid]`` receives the gap between
    the two largest logits at each generated token (how near a tie the
    greedy choice was)."""
    device = resolve_device(device)
    decode = ST.make_decode_step(cfg, mode=mode)
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
                    tok = int(ST.greedy_sample(logits)[0])
                    gen.append(tok)
                    if margins is not None:
                        top2 = torch.topk(logits[0, -1].float(), 2).values
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
