#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. build: compile every kernel of the serving path from the repo's
   ``.cu`` sources with ``nvcc`` for sm_90a, one process per source,
   all started together;
2. kernels: at every shape the main paths give them (full-width
   starcoder2-3b: M = 1 and 8 rows for the decode steps, 32 to 512 for
   the service curve's forward), hold each CUDA kernel against
   its plain PyTorch version on the same inputs on the card, within the
   stated tolerance, and time kernel, plain version, one PyTorch library
   call as a yardstick, and the card's bound (bytes over 3.35 TB/s, or
   operations over the bf16 or int8 peak, whichever is larger); the paged
   attention kernel is also held bitwise against the contiguous one on
   the gathered view;
3. slice: full-width starcoder2-3b (random weights from a seeded
   generator, int8 W8A16 weights, int8 KV cache) served through
   ``Engine.serve`` — 8 slots, chunked prefill of 4, 24 requests so slots
   are reused, every tick and every chunk a replay of a step captured as
   a CUDA graph by ``Engine.warmup`` (each chunk one decode pass, its
   attention through the paged kernel on the slot's row), no capture
   inside the serve — with the kernels' launch counters zeroed just
   before and read just after (no launch of qmatmul_w8a16's mma path);
   then three requests compared with the sequential
   ``reference_outputs`` on the card;
4. paged slice: the same model served from the paged KV cache
   (``Engine(block_size=16, num_blocks=25)``, 24 requests sharing a
   16-token prompt prefix), warmed up and counted the same way (again no
   mma launch, no capture); prefix blocks must be shared, none leaked,
   and three requests (one that shared) equal the contiguous sequential
   reference; then the steady tick at a long context (``max_seq`` 4,096,
   8 rows at 2,048), contiguous and paged, with the decode attention
   kernels' share of its device time, and the steady tick under W8A8 at
   16 slots, with ``qmatmul_w8a8``'s share (these breakdowns run the
   eager step);
5. overload: the same model served through the overload paths, each
   serve warmed up (no capture inside it; no plain version, no mma
   launch) and held against a control serve of the same engine on the
   same trace without preemption or faults.  Paged:
   ``Engine(num_slots=8, block_size=16, num_blocks=13, max_seq=48)``
   (12 usable blocks against 24 worst-case), 24 requests (prompt 16, 32
   new, Poisson at 400/s, batch for odd rids, interactive for even),
   ``preemption=True``, ``max_retries=2`` and a fixed ``FaultPlan``: a
   dispatch fault retried twice, a non-finite sample, a block-table row
   torn in place and a dispatch fault that fails its culprit.  Every fault
   fires, exactly one request fails, no block leaks, every other request
   equals the control, and every preempted one (the non-finite victim
   and the torn row's tenant among them) equals the sequential
   reference.  Contiguous: the same trace at 100/s (at 400/s the
   class-ordered queue holds every interactive request before a slot
   frees, so nothing is evicted), ``class_quotas={"batch": 2}``,
   ``preemption=True``: slot pressure evicts, the batch class never holds
   more than 2 slots in a tick, and the outputs equal the control;
6. graphs: each of those five ticks eager against the captured step
   (``runtime/steps.py::jit_slot_decode_step``) on two copies of one
   randomly filled cache, over four ticks with a row retiring and one
   admitted (paged: a table row changed): next tokens, indices and every
   cache leaf ``torch.equal``, the kernel counts of a replay equal to the
   eager tick's; then the captured steady tick's wall, device busy and
   ``cudaLaunchKernel`` / ``cudaGraphLaunch`` calls beside the eager
   tick's of this run, its wall required below the eager one; the
   serve CLI's decode loop (batch 16, 16 tokens, ``max_seq`` 32, bf16
   cache) under w8a16 and w8a8, captured (``jit_decode_loop``) against
   eager at starts 0 and 5, with tok/s of both; the chunk step
   (``jit_prefill_chunk_step``) on the slice's, the paged slice's (across
   a block edge), a 4,096-slot and the serve CLI's bf16 cache, and under
   W8A8: for every n_valid up to the chunk, the one-pass eager and the
   captured chunk bitwise equal to the eager per-token step (every cache
   leaf), then a chunk's wall, device busy and launch calls three ways
   (per-token eager, one-pass eager, captured); and the workspace a
   capture holds: the 8-row tick, captured first, replays equal to the
   eager tick after the 16-row captures grew the capture stream's
   workspace, with every arrival counter back at 0;
7. sampling: the port's threefry PRNG on the card against its CPU
   results (keys of PRNGKey(0) and PRNGKey(7) and ``fold_in`` over
   positions 0 .. 4,095 bitwise; random bits and uniform draws bitwise,
   Gumbel noise within 4 ulps, at V = 49,152, 131,072 and 152,064), each
   row of ``temperature_sample_rows`` bitwise alone and in an 8-row
   batch, and the sampler's time eager and captured; full-width
   starcoder2-3b sampled at t = 0.8 with ``PRNGKey(1)``: the slice's
   trace served contiguous (equal to the sampled ``reference_outputs``
   for 8 requests) and paged, and the same requests in two classes at
   100/s served paged under block pressure with preemption (at least one
   eviction, no leak), each equal to the contiguous serve token for token
   (warmed up, counted, no capture inside); the captured sampled tick
   bitwise the eager one and timed against the captured greedy tick,
   with the sampler's share of its device time; the captured sampled
   decode loop bitwise the eager one, with tok/s; then mistral-nemo-12b
   at full width (vocabulary 131,072, bf16 cache), one contiguous sampled
   serve equal to its sampled reference, freed after;
8. spec: full-width starcoder2-3b speculating (``Engine(spec_k=3,
   ...)``: a draft proposes 3 tokens a slot, one verify step scores
   them, the host commits the accepted run and rewinds the rest), on the
   slice's trace with a full-depth self-draft (every proposal accepted:
   4 tokens an emitting dispatch) and a 1-layer one, greedy and sampled
   (t = 0.8, ``PRNGKey(1)``), and on the paged slice's geometry at 20/s
   with the 1-layer one (no leak, prefix blocks shared): each warmed up
   and counted (no capture inside, no plain version, no mma launch),
   every token equal to a non-speculative control serve of the same
   trace, three requests of each 1-layer serve held to
   ``reference_outputs``; then the captured verify and propose steps
   bitwise their eager forms and timed against the captured tick.  The
   serve phase adds a w8a16 CLI run with ``--spec-k 3 --draft-layers
   1`` equal to its non-speculative w8a16 run, and the MoE phase a
   speculative serve of qwen2-moe-a2.7b (1-layer self-draft) equal to
   its contiguous serve;
9. serve: the serve launcher (``repro_torch.launch.serve.run``) at full
   starcoder2-3b width with the bf16 KV cache, once with ``--quant w8a16``
   and once with ``--quant w8a8``: the service curve through the
   full-sequence forward captured as a CUDA graph per batch (flash
   attention; under w8a16 every qmatmul_w8a16 launch of it on the mma
   path, counted around the curve alone), the Table 4 batch choice, the
   decode loop and a wall-clock ``Engine.serve`` (no mma launch in
   either; the loop and the engine's tick and chunks captured as CUDA
   graphs), counters zeroed just before each run and read just after,
   then where one 16 x 32-token prefill spends its time, and the curve's
   forward eager against captured at each batch (logits bitwise; wall
   and device busy of each; the eager curve's Table 4 choice beside the
   run's); the w8a16 run's first three requests are compared with
   ``reference_outputs`` (bf16 cache) on the card; then one more w8a16
   run with the overload flags (``--interactive-frac 0.5 --batch-quota 4
   --preemption --fault-seed 3 --n-faults 4``), which must exit 0 and
   print its retirement and faults lines, and one with ``--temperature
   0.8``, which must exit 0 with every request equal to the sampled
   ``reference_outputs`` under ``PRNGKey(seed + 1)``;
10. dense: the other three dense configs at full width, one at a time
   (mistral-nemo-12b, internlm2-20b, qwen1.5-32b; each freed before the
   next), W8A16 weights from the streamed init
   (``registry.init_quantized``; its peak memory printed, qwen1.5-32b's
   under 45 GB), each served on the contiguous bf16 cache (8 slots, 8
   requests of a 16-token prompt whose first 8 tokens all share, 16 new
   tokens, chunked prefill of 4, Poisson at 20/s), equal to
   ``reference_outputs``, then on a paged bf16 cache of blocks of 8 (16
   usable blocks against 32) with every token equal to the contiguous
   serve's and no block leaked; the captured steady tick, contiguous and
   paged, against its floor (the int8 weights it reads at 3.35 TB/s);
   qwen1.5-32b also on the int8 cache (``kv_quant=True``: both decode
   attention kernels at G = 1), equal to ``reference_outputs``; then the
   serve CLI at full mistral-nemo-12b width with ``--block-size 16
   --num-blocks 25 --shared-prefix-len 16`` (24 usable blocks against 48),
   exit 0, its service curve on the mma path and flash attention at
   H = 32 (eager against captured as in phase 9), four of its requests
   equal to ``reference_outputs``;
11. moe: qwen2-moe-a2.7b at full width (24 layers, 60 routed experts
   top-4 and 4 shared, vocab 151,936 tied).  First ``qmatmul_w8a16``'s
   expert-stacked entry at a tick's shapes (60 experts x 8 rows: w_gate
   with the silu drain, w_up, w_down) and the serve CLI curve's (3, 12
   and 48 rows an expert) against its plain version, every row bitwise
   alone and in its batch, a stack of one bitwise the 2-D GEMV, timed at
   8 and 48 rows beside ``torch.bmm`` on bf16 experts and the bound, and
   the router's GEMV (2048 x 60, f32); the router's softmax and stable
   top-4 rows bitwise alone and in a batch; then the model from the
   streamed init (peak under 20 GB), served as the dense configs are
   (contiguous bf16 held to ``reference_outputs``, paged held to
   contiguous with no leak, the int8 cache held to
   ``reference_outputs``), the captured chunk pass bitwise the per-token
   steps (every token routed alone; bf16 contiguous and int8 paged),
   the captured steady tick on both caches against the floors of every
   expert's weights and of the experts its tokens route to, with the
   device time by part, and the serve CLI with the dense CLI's flags
   (its curve's forward routes with capacity 3 and drops tokens; the
   captured forward bitwise the eager one; four requests equal to
   ``reference_outputs``).

The kernel phase holds both of ``qmatmul_w8a16``'s kernels (the GEMV and
the ``mma.sync`` bf16 tensor-core path) at every projection and the LM
head at M = 1, 8, 32, 128 and 512 and at one ragged shape, checks the
row independence of the mma path (M = 512) and of the GEMV (M = 8 and 16
on wq, wk|wv and w_down, whose K the GEMV splits across blocks), prints
the GEMV's split plan of each projection, times both at M = 8, 32, 128
and 512 and prints the per-tick and per-forward sums on lines of their
own, beside the times before the redesign; it holds
``qmatmul_w8a8`` (every projection at M = 8 and 16, M = 512 and either
side of its path threshold, and one ragged shape: its int32 accumulate
bitwise, the tensor-core kernel's bf16 rows equal to the GEMV's) and
``flash_attention_bhsd`` (the service curve's shapes, plus a window and a
``kv_len < Skv`` case) against their plain versions, and times them;
``qmatmul_w8a8``'s GEMV split plan of each projection is printed, its
per-tick sums at M = 8 and 16 beside the times before the redesign, and
its two kernels are timed at M = 8, 16, 32, 64, 128 and 512.
The two decode attention kernels are held and timed at the slot tick's
shapes and at a long-context case (8 ragged rows of a 4,096-slot cache,
paged: blocks of 16), beside their times before the split redesign; every
row of every case is checked bitwise equal launched alone and in its
batch, in a 48- and a 4,096-slot cache (paged: through 4- and 256-entry
tables), and at valid_len on either side of the split's chunk and tile
edges.  At the dense configs' shapes it holds ``qmatmul_w8a16`` (both
kernels: w_gate with the silu drain, w_down, the untied LM heads) and
the two decode attention kernels at (KV, G) = (40, 1), (8, 4) and (8,
6), each timed beside its plain version, its library call and its bound.
Then ``rmsnorm``'s rows at d = 3072, 5120 and 6144 are checked bitwise at
B = 1, 8 and 16.  The tick breakdowns check that a tick launches 181
``qmatmul_w8a16`` GEMVs (under W8A8, at 16 slots: 180 ``qmatmul_w8a8``
launches and the LM head's GEMV) and no more ``cudaLaunchKernel`` calls
than before the redesigns.

``--only attention`` / ``--only long_tick`` / ``--only w8a8`` / ``--only
graphs`` / ``--only dense`` / ``--only sampling`` / ``--only spec`` /
``--only moe`` run just the two attention kernel phases, the
long-context ticks, ``qmatmul_w8a8``'s kernel phase and the W8A8 tick,
the five eager tick breakdowns and the graph phase, the dense family's
kernel rows, rmsnorm widths and phase 10, phase 7 and the sampled serve
CLI run, phase 8 with its CLI run and qwen2-moe-a2.7b's speculative
serve, or phase 11, and ``--src DIR``
takes the port from
another checkout's ``src/`` (so the same phases time a parent commit's
kernels); such a partial run prints no result line.

It prints the card's name and power limit, a JSON line with every
kernel's numbers (qmatmul_w8a16's with both paths under ``paths``, the
attention kernels' long-context case under ``long_context``, the rows at
the dense configs' shapes under ``dense``, qmatmul_w8a16's expert-stacked
entry under ``experts``, each kernel's MoE launches under ``moe`` and
its launches in the speculative serves under ``spec``),
the whole run's time, and,
last, ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
without the repo's ``src/repro_torch`` beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 0
NUM_SLOTS = 8
PREFILL_CHUNK = 4
N_REQUESTS = 24
PROMPT_LEN = 16
MAX_NEW = 32
N_COMPARE = 3            # requests held against the sequential reference
TIE_TOL = 1e-3           # a greedy mismatch is allowed only where the
                         # reference's top-2 logit gap is below this

# the paged slice: prompts of two 16-token blocks, the first common to all
# requests; a pool of 25 blocks (one the trash block) holds six requests'
# worth of private rows (ceil(64 / 16) = 4 blocks each), below the 33 of
# the contiguous equivalent.  Arrivals at 2/s: a prefix block is
# registered only after its tenant's first four prefill chunks, and a
# burst (400/s puts all 24 requests in the first 76 ms) has every request
# admitted or queued behind the block budget by then, so none could share
# (tests/test_torch_paged.py::test_prefix_sharing_needs_arrivals_spread_
# past_prefill holds both cases on the CPU).
PAGED_BLOCK = 16
PAGED_PROMPT_LEN = 32
PAGED_SHARED_PREFIX = 16
PAGED_NUM_BLOCKS = 1 + 6 * math.ceil((PAGED_PROMPT_LEN + MAX_NEW)
                                     / PAGED_BLOCK)
PAGED_RATE_PER_S = 2.0

# the overload phase: the paged slice's geometry on a pool of 13 blocks (12
# usable: four requests' rows of 48 positions, against 24 for 8 slots), two
# SLO classes, and this fault plan (kind, tick, slot, repeat): a dispatch
# fault retried twice, a non-finite sample, a torn table row and a dispatch
# fault that fails its culprit past OVERLOAD_MAX_RETRIES.  The contiguous
# serve caps the batch class at OVERLOAD_BATCH_QUOTA slots; its trace
# arrives at 100/s: at the paged serve's 400/s every request is queued
# before a slot frees, the queue is class-ordered, and nothing is ever
# evicted; at 100/s interactive requests keep arriving while batch ones
# hold slots
OVERLOAD_BLOCKS = 13
OVERLOAD_RATE_PER_S = 400.0
OVERLOAD_CONTIG_RATE_PER_S = 100.0
OVERLOAD_BATCH_QUOTA = 2
OVERLOAD_MAX_RETRIES = 2
OVERLOAD_FAULTS = (("dispatch", 20, 1, 2), ("nan_logits", 40, 2, 1),
                   ("torn_table", 60, 0, 1), ("dispatch", 80, 3, 99))
SERVE_OVERLOAD_FLAGS = ["--interactive-frac", "0.5", "--batch-quota", "4",
                        "--preemption", "--fault-seed", "3",
                        "--n-faults", "4"]

# the serve phase: the launcher's flags.  The deadline is chosen from the
# first full-width run's curve (PERF.md, Findings): there the modeled p99 of
# batch 16 was 244 ms (w8a16) and 215 ms (w8a8), so 500 ms leaves twice
# that for run-to-run spread and the Table 4 policy picks the largest
# measured batch, which fills the 16-slot pool.
SERVE_DEADLINE_MS = 500.0
SERVE_MAX_BATCH = 16
SERVE_SEQ = 32
SERVE_ROWS = SERVE_MAX_BATCH * SERVE_SEQ     # M of the curve's largest prefill
# qmatmul_w8a8's two kernels are timed at these M, whatever the wrapper picks
W8A8_PATH_ROWS = (NUM_SLOTS, 16, 32, 64, 128, SERVE_ROWS)
# ... and the wrapper at the rows of a slot tick: the smoke's 8 slots and
# the W8A8 serve engine's 16
W8A8_TICK_ROWS = (NUM_SLOTS, SERVE_MAX_BATCH)
# qmatmul_w8a16's two kernels are checked and timed at a slot tick's rows
# and at the service curve's batches 1, 4 and 16 of SERVE_SEQ tokens
W8A16_PATH_ROWS = (NUM_SLOTS, SERVE_SEQ, 4 * SERVE_SEQ, SERVE_ROWS)
SERVE_ARGS = ["--arch", "starcoder2-3b", "--max-batch", str(SERVE_MAX_BATCH),
              "--seq", str(SERVE_SEQ), "--decode-tokens", "16",
              "--n-requests", "16", "--prompt-len", "16",
              "--gen-tokens", "16", "--prefill-chunk", str(PREFILL_CHUNK),
              "--deadline-ms", str(SERVE_DEADLINE_MS), "--seed", str(SEED)]

HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
BF16_OPS_PER_S = 989e12          # dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12         # dense int8 tensor-core peak
L2_FLUSH_BYTES = 128 << 20       # > the 50 MB L2: every launch starts cold

# the decode attention kernels' long-context case: 8 ragged rows of a
# 4,096-slot cache (paged: blocks of 16, 256 per row), a row at each of the
# split's shapes and an empty one
LONG_SLOTS = 4096
LONG_VALID = [4096, 4095, 3000, 2048, 1024, 517, 129, 0]
# valid_len just before, at and after the split's chunk and tile edges
BOUNDARY_VALID = [15, 16, 17, 63, 64, 65, 255, 256, 257, 1023, 1024, 1025]

# the times before each kernel's redesign, printed beside this run's: the
# GEMV's and flash attention's before their split-K and tensor-core
# redesigns, the decode attention kernels' per slot tick before their
# split and qmatmul_w8a8's 8-row tick before its split-K GEMV (PERF.md
# §5-6: two chip_smoke runs of the commit before each redesign); the
# decode attention kernels' per long-context launch and the long ticks
# before the split (`chip_smoke.py --src <parent>/src --only attention
# --only long_tick` on a `git archive` of the commit before it, two runs),
# and qmatmul_w8a8's 16-row tick and the W8A8 tick's launches before its
# redesign (the same with `--only w8a8`); all on an NVIDIA H100 80GB HBM3
# at 700.00 W; and the tick's launches, which no redesign may grow
BEFORE_MS = {"gemv_tick": "6.005 / 5.968", "flash_forward": "0.853 / 0.852",
             "attention_tick": "0.650 / 0.655",
             "paged_attention_tick": "0.735 / 0.745",
             "attention_long": "0.6813 / 0.6836",
             "paged_attention_long": "0.7931 / 0.7902",
             "w8a8_tick": "5.519 / 5.593",
             "w8a8_tick16": "6.197 / 6.164"}
BEFORE_LONG_TICK = {"long tick": "10.500 / 10.495 ms of 17.670 / 17.656",
                    "long paged tick": "12.124 / 12.106 ms of 19.305 / 19.279"}
BEFORE_TICK_LAUNCH_CALLS = {"tick": 1659, "paged tick": 1665,
                            "w8a8 tick": 3279}

# the serves before their chunk step was captured and taken in one pass
# (PERF.md §5: chip_smoke runs 1 / 2 of the commit before, NVIDIA H100
# 80GB HBM3 at 700.00 W), printed beside this run's
BEFORE_CHUNK = {
    "slice": "72.7 / 108.8 tok/s, p99 10.52 / 7.01 s, mean TTFT 3.13 / "
             "2.03 s, 99.7 / 66.6 ms per tick",
    "paged": "46.2 / 48.4 tok/s, p99 5.28 / 4.45 s, mean TTFT 1.80 / "
             "1.03 s, 72.2 / 63.0 ms per tick",
    "serve w8a16": "engine 22.6 / 34.4 tok/s, p99 11.29 / 7.42 s, mean "
                   "TTFT 10.87 / 7.06 s, 565.3 / 371.7 ms per tick; decode "
                   "loop 1,669.5 / 1,690.8 tok/s",
    "serve w8a8": "engine 16.8 / 24.4 tok/s, p99 15.26 / 10.47 s, mean "
                  "TTFT 14.73 / 10.02 s, 763.9 / 524.6 ms per tick; decode "
                  "loop 1,601.9 / 1,784.6 tok/s"}

KERNELS = {
    "qmatmul_w8a16": {
        "source": "src/repro_torch/kernels/csrc/qmatmul_w8a16.cu",
        "replaces": "src/repro/kernels/qmatmul.py:195",
    },
    "decode_attention_int8": {
        "source": "src/repro_torch/kernels/csrc/decode_attention_int8.cu",
        "replaces": "src/repro/kernels/decode_attention.py:119",
    },
    "decode_attention_int8_paged": {
        "source":
            "src/repro_torch/kernels/csrc/decode_attention_int8_paged.cu",
        "replaces": "src/repro/kernels/decode_attention.py:185",
    },
    "qmatmul_w8a8": {
        "source": "src/repro_torch/kernels/csrc/qmatmul_w8a8.cu",
        "replaces": "src/repro/kernels/qmatmul.py:111",
    },
    "flash_attention_bhsd": {
        "source": "src/repro_torch/kernels/csrc/flash_attention_bhsd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:87",
    },
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int, flush) -> float:
    """Mean device time of one call of ``fn``, from CUDA events around each
    of ``iters`` calls, each after an L2 flush (the serving path streams
    3 GB of weights per tick, so every weight read is cold).  The calls
    are queued behind a sleep kernel, so the card runs them back to back
    and the events time the device, not the host's launch overhead."""
    import torch
    fn()                                          # warm up
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)                # ~0.1 s of queue head start
    for start, end in events:
        flush()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / iters


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def bf16_close(out, ref, *, f32_out: bool):
    """(max |out - ref|, worst err / tol).  Tolerance: the kernel and the
    plain version add the same f32 products in different orders, so they
    differ by f32 rounding (~1e-7 of the output's scale); rounded to bf16
    that can flip the last bit, so a bf16 output may differ by one bf16
    ulp (2^-7 relative).  tol = 2^-7 |ref| (bf16) or 1e-5 |ref| (f32),
    plus 1e-5 of the output's rms for values near zero."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    rms = r.pow(2).mean().sqrt()
    tol = (2.0 ** -7 if not f32_out else 1e-5) * r.abs() + 1e-5 * rms
    return float(err.max()), float((err / tol).max())


def w8a16_check(label, x, w, ws, bias, act, odt, ref):
    """qmatmul_w8a16 through each of its kernels on one input, held against
    the plain version's ``ref`` with bf16_close.  Returns the worst
    (max_abs_err, err / tol)."""
    import torch
    from repro_torch.kernels import qmatmul as K

    worst = (0.0, 0.0)
    for path in K.W8A16_PATHS:
        out = K.qmatmul_w8a16_on_path(path, x, w, ws, bias, activation=act,
                                      out_dtype=odt)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"qmatmul_w8a16 {label} ({path}): bad output")
        err, ratio = bf16_close(out, ref, f32_out=odt == torch.float32)
        if ratio > 1.0:
            raise AssertionError(
                f"qmatmul_w8a16 {label} ({path}): kernel disagrees with its "
                f"plain version beyond tolerance (err/tol={ratio:.3f})")
        worst = (max(worst[0], err), max(worst[1], ratio))
    return worst


def w8a16_rows_check(x, w, ws, bias, act, odt) -> None:
    """The mma path's rows do not depend on M: the rows of one launch equal
    the same rows launched alone and in slices of 17 through the same
    path."""
    import torch
    from repro_torch.kernels import qmatmul as K

    kw = dict(activation=act, out_dtype=odt)
    full = K.qmatmul_w8a16_on_path("mma", x, w, ws, bias, **kw)
    m = x.shape[0]
    for i in sorted({0, 1, 15, 16, 127, 128, m // 2, m - 1}):
        one = K.qmatmul_w8a16_on_path("mma", x[i:i + 1].contiguous(), w, ws,
                                      bias, **kw)
        if not torch.equal(one[0], full[i]):
            raise AssertionError(f"qmatmul_w8a16 (mma): row {i} of an M = "
                                 f"{m} launch differs from the row alone")
    for i in range(0, m, 17):
        part = K.qmatmul_w8a16_on_path("mma", x[i:i + 17].contiguous(), w, ws,
                                       bias, **kw)
        if not torch.equal(part, full[i:i + 17]):
            raise AssertionError(f"qmatmul_w8a16 (mma): rows {i}.. of an M = "
                                 f"{m} launch differ from the same 17 rows")


def gemv_rows_check(label, x, w, ws, bias, act, odt) -> None:
    """The GEMV's rows do not depend on M: the rows of an M = 8 and an
    M = 16 launch (one and two row slabs, K split by the plan and combined
    in the last block to arrive) equal the same rows launched alone."""
    import torch
    from repro_torch.kernels import qmatmul as K

    kw = dict(activation=act, out_dtype=odt)
    for m in (NUM_SLOTS, 2 * NUM_SLOTS):
        full = K.qmatmul_w8a16(x[:m].contiguous(), w, ws, bias, **kw)
        for i in range(m):
            one = K.qmatmul_w8a16(x[i:i + 1].contiguous(), w, ws, bias, **kw)
            if not torch.equal(one[0], full[i]):
                raise AssertionError(f"qmatmul_w8a16 (gemv) {label}: row {i} "
                                     f"of an M = {m} launch differs from the "
                                     f"row alone")


def qmatmul_phase(flush):
    """qmatmul_w8a16 at every full-width projection and the LM head, through
    both kernels (the GEMV and the mma path), at M = 1, a decode tick's
    M = 8 and the service curve's M = 32, 128 and 512 (batches 1, 4 and 16
    of SERVE_SEQ tokens), plus one ragged shape (M = 513, K = 3088,
    N = 260): each held against the plain version (bf16_close).  Row
    independence of the mma path on one projection.  Both paths timed at
    M = 8, 32, 128 and 512 against F.linear and the bound; the GEMV's
    per-tick sum (M = 8) goes to the kernels line, and both paths'
    per-forward sums are printed on their own lines."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import qmatmul as K

    d, ff, kvd, vocab = 3072, 12288, 256, 49152
    # (name, K, N, bias, activation, out dtype, launches per slot tick and
    # per forward)
    shapes = [("wq", d, d, True, "none", torch.bfloat16, 30),
              ("wk|wv", d, kvd, True, "none", torch.bfloat16, 60),
              ("wo", d, d, False, "none", torch.bfloat16, 30),
              ("w_up", d, ff, False, "gelu", torch.bfloat16, 30),
              ("w_down", ff, d, False, "none", torch.bfloat16, 30),
              ("lm_head", d, vocab, False, "none", torch.float32, 1)]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bytes_ms", "ops_ms")
    per_m = {(path, m): dict.fromkeys(keys, 0.0)
             for path in K.W8A16_PATHS for m in W8A16_PATH_ROWS}
    worst_err, worst_ratio = 0.0, 0.0
    plans = []
    for name, k, n, has_bias, act, odt, per_tick in shapes:
        wf = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        q = quantize_weight(wf)
        del wf
        w, ws = q.values, q.scale.reshape(-1).contiguous()
        bias = (torch.randn((n,), generator=gen, device="cuda") * 0.1
                if has_bias else None)
        w_lib = (w.float() * ws).to(torch.bfloat16).t()   # (N, K) view
        plan = K.gemv_split_plan(k, n)
        plans.append(f"{name} K={k} N={n}: {plan.strips} strips x "
                     f"{plan.splits} splits of {plan.split_rows} rows = "
                     f"{plan.strips * plan.splits} blocks at M = 8")
        if name in ("wq", "wk|wv", "w_down"):
            gemv_rows_check(name, torch.randn(
                (2 * NUM_SLOTS, k), generator=gen, device="cuda").to(
                torch.bfloat16), w, ws, bias, act, odt)
        for m in (1,) + W8A16_PATH_ROWS:
            x = torch.randn((m, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            ref = K.qmatmul_w8a16_ref(x, w, ws, bias, activation=act,
                                      out_dtype=odt)
            err, ratio = w8a16_check(f"{name} M={m}", x, w, ws, bias, act,
                                     odt, ref)
            worst_err, worst_ratio = max(worst_err, err), max(worst_ratio,
                                                              ratio)
            if name == "wq" and m == SERVE_ROWS:
                w8a16_rows_check(x, w, ws, bias, act, odt)
            line = (f"  qmatmul_w8a16 {name:7s} M={m:3d} K={k:5d} N={n:5d} "
                    f"act={act:4s} max_abs_err={err:.3e} err/tol={ratio:.3f}")
            if m not in W8A16_PATH_ROWS:
                print(line)
                continue
            ms = {path: time_ms(lambda: K.qmatmul_w8a16_on_path(
                path, x, w, ws, bias, activation=act, out_dtype=odt), 20,
                flush) for path in K.W8A16_PATHS}
            plain = (time_ms(lambda: K.qmatmul_w8a16_ref(
                x, w, ws, bias, activation=act, out_dtype=odt),
                3 if m < SERVE_ROWS else 1, flush)
                if m in (NUM_SLOTS, SERVE_ROWS) else float("nan"))
            lib = time_ms(lambda: F.linear(x, w_lib, None if bias is None
                                           else bias.to(torch.bfloat16)),
                          20, flush)
            nbytes = (x.numel() * 2 + w.numel() + ws.numel() * 4
                      + (n * 4 if has_bias else 0)
                      + m * n * torch.empty(0, dtype=odt).element_size())
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * m * k * n / BF16_OPS_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            print(f"{line} gemv_ms={ms['gemv']:.4f} mma_ms={ms['mma']:.4f} "
                  f"plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"bound_ms={bound:.4f}")
            for path in K.W8A16_PATHS:
                for key, val in zip(keys, (ms[path], plain, bound, lib,
                                           bytes_ms, ops_ms)):
                    per_m[path, m][key] += per_tick * val
    x = torch.randn((513, 3088), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = quantize_weight(torch.randn((3088, 260), generator=gen,
                                    device="cuda") * 3088 ** -0.5)
    w, ws = q.values, q.scale.reshape(-1).contiguous()
    bias = torch.randn((260,), generator=gen, device="cuda") * 0.1
    for odt in (torch.bfloat16, torch.float32):
        ref = K.qmatmul_w8a16_ref(x, w, ws, bias, activation="gelu",
                                  out_dtype=odt)
        err, ratio = w8a16_check("ragged", x, w, ws, bias, "gelu", odt, ref)
        worst_err, worst_ratio = max(worst_err, err), max(worst_ratio, ratio)
        print(f"  qmatmul_w8a16 ragged  M=513 K= 3088 N=  260 act=gelu "
              f"out={str(odt)[6:]} max_abs_err={err:.3e} "
              f"err/tol={ratio:.3f} (both paths)")
    print(f"  qmatmul_w8a16 both paths within bf16_close everywhere (worst "
          f"err/tol {worst_ratio:.3f}); mma rows of an M = {SERVE_ROWS} "
          f"launch equal to the same rows launched alone (wq); GEMV rows of "
          f"M = {NUM_SLOTS} and {2 * NUM_SLOTS} launches equal to the same "
          f"rows launched alone (wq, wk|wv, w_down)")
    print("  qmatmul_w8a16 GEMV split plan: " + "; ".join(plans))
    print("  qmatmul_w8a16 per 30 layers x 6 projections + the LM head, by "
          "path: " + "; ".join(
              f"M={m} gemv={per_m['gemv', m]['ms']:.4f} "
              f"mma={per_m['mma', m]['ms']:.4f} "
              f"F.linear={per_m['mma', m]['library_ms']:.4f} "
              f"bound={per_m['mma', m]['bound_ms']:.4f}"
              for m in W8A16_PATH_ROWS))
    tick = per_m["gemv", NUM_SLOTS]
    print(f"  qmatmul_w8a16 (gemv) per {NUM_SLOTS}-row slot tick (30 layers x "
          f"6 projections + the LM head): ms={tick['ms']:.4f} (before the "
          f"redesign: {BEFORE_MS['gemv_tick']}) "
          f"library_ms={tick['library_ms']:.4f} "
          f"(F.linear, bf16 weights) bound_ms={tick['bound_ms']:.4f}")
    for path in K.W8A16_PATHS:
        fwd = per_m[path, SERVE_ROWS]
        print(f"  qmatmul_w8a16 ({path}) per {SERVE_MAX_BATCH} x {SERVE_SEQ}"
              f"-token forward (M = {SERVE_ROWS}; 30 layers x 6 projections "
              f"+ the LM head): ms={fwd['ms']:.4f} "
              f"bound_ms={fwd['bound_ms']:.4f} "
              f"({'bytes' if fwd['bytes_ms'] >= fwd['ops_ms'] else 'operations'})"
              f" plain_ms={fwd['plain_ms']:.4f} library_ms="
              f"{fwd['library_ms']:.4f} (F.linear, bf16 weights)")
    zero_counts()
    return worst_err, {path: (per_m[path, NUM_SLOTS], per_m[path, SERVE_ROWS])
                       for path in K.W8A16_PATHS}


def _attn_cache(gen, shape):
    """A random int8 K/V cache of ``shape`` (..., KV, hd) and its f32
    per-(slot, head) scales (..., KV, 1)."""
    import torch
    k, v = (torch.randint(-127, 128, shape, generator=gen, device="cuda",
                          dtype=torch.int8) for _ in range(2))
    ks, vs = (torch.rand(shape[:-1] + (1,), generator=gen, device="cuda")
              * 0.02 + 1e-3 for _ in range(2))
    return k, v, ks, vs


def _attn_close(label, out, ref) -> float:
    """max |out - ref|, after checking the shape, finiteness and the
    tolerance: f32 online softmax (split into chunks, the products on the
    tensor cores with exact bf16 terms) against a dense softmax -- the
    same terms in another order and another exp per running max: 1e-4
    relative + 1e-5 absolute."""
    import torch
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: bad output")
    err = float((out - ref).abs().max())
    if not bool(((out - ref).abs() <= 1e-4 * ref.abs() + 1e-5).all()):
        raise AssertionError(f"{label}: kernel disagrees with its plain "
                             f"version beyond tolerance (max err {err})")
    return err


def _rows_alone(label, out, launch_row, b) -> None:
    """Each row of a batch launch bitwise equal to the row launched alone:
    the engine's parity with its batch-1 reference needs it."""
    import torch
    for r in range(b):
        if not torch.equal(launch_row(r), out[r:r + 1]):
            raise AssertionError(f"{label}: row {r} launched alone differs "
                                 f"from the row in the batch")


def _attn_numbers(label, b, vls, append, err, ms, plain, lib, q, extra_bytes,
                  before=None):
    """Print one case's line; return its times and bound (ms)."""
    kvh, g, hd = q.shape[1:]
    used = sum(vls)
    nbytes = (q.numel() * 2 + used * kvh * (2 * hd + 2 * 4) + b * 4
              + b * kvh * g * hd * 4 + extra_bytes
              + (2 * b * kvh * hd * 4 if append else 0))
    ops = 4 * (used + (b if append else 0)) * kvh * g * hd
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    bound = max(bytes_ms, ops_ms)
    print(f"  {label} valid_len={vls} append={append} max_abs_err={err:.3e} "
          f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
          f"bound_ms={bound:.5f}"
          + (f" (before the split redesign: {before})" if before else ""))
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "library_ms": lib, "bytes_ms": bytes_ms, "ops_ms": ops_ms}


def _sdpa_ms(flush, q, kd, vd, vl, s_slots):
    """The yardstick: SDPA over K/V dequantized to bf16 beforehand, masked
    per row."""
    import torch
    import torch.nn.functional as F
    b, kvh, g, hd = q.shape
    qd = q.reshape(b, kvh * g, 1, hd)
    mask = (torch.arange(s_slots, device="cuda")[None, :]
            < vl[:, None])[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(
        qd, kd, vd, attn_mask=mask, enable_gqa=True), 20, flush)


def _per_tick(t):
    return {key: 30 * val for key, val in t.items()}


def attention_phase(flush, s_slots: int):
    """The contiguous kernel at the slot tick's shapes (B = 8 ragged rows
    of ``s_slots``, with and without the append column, and B = 1) and at
    the long-context case (B = 8 ragged rows of LONG_SLOTS): against the
    plain version, timed beside SDPA and the bound; each multi-row
    launch's rows bitwise equal to the rows launched alone, rows bitwise
    equal in a cache of ``s_slots`` and of LONG_SLOTS slots, and rows at
    the split's chunk and tile edges (BOUNDARY_VALID)."""
    import torch
    from repro_torch.kernels import decode_attention as A

    kvh, g, hd = 2, 12, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    ragged = [0, 1, 5, 17, s_slots - 1, s_slots, s_slots // 2, 12]
    cases = [(NUM_SLOTS, s_slots, ragged[:NUM_SLOTS], False),
             (NUM_SLOTS, s_slots, ragged[:NUM_SLOTS], True),
             (1, s_slots, [s_slots // 2 + 3], False),
             (1, s_slots, [0], True),
             (NUM_SLOTS, LONG_SLOTS, LONG_VALID, False)]
    tick = long = {}
    worst = 0.0
    for b, s, vls, append in cases:
        q = torch.randn((b, kvh, g, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v, ks, vs = _attn_cache(gen, (b, s, kvh, hd))
        vl = torch.tensor(vls, dtype=torch.int32, device="cuda")
        kn = vn = None
        if append:
            kn = torch.randn((b, kvh, hd), generator=gen, device="cuda")
            vn = torch.randn((b, kvh, hd), generator=gen, device="cuda")
        label = f"decode_attention_int8 B={b} S={s}"
        out = A.decode_attention_int8(q, k, v, ks, vs, vl, k_new=kn,
                                      v_new=vn)
        ref = A.decode_attention_int8_ref(q, k, v, ks, vs, vl, k_new=kn,
                                          v_new=vn)
        err = _attn_close(label, out, ref)
        worst = max(worst, err)
        _rows_alone(label, out, lambda r: A.decode_attention_int8(
            q[r:r + 1], k[r:r + 1], v[r:r + 1], ks[r:r + 1], vs[r:r + 1],
            vl[r:r + 1], k_new=None if kn is None else kn[r:r + 1],
            v_new=None if vn is None else vn[r:r + 1]), b)
        ms = time_ms(lambda: A.decode_attention_int8(
            q, k, v, ks, vs, vl, k_new=kn, v_new=vn), 20, flush)
        plain = time_ms(lambda: A.decode_attention_int8_ref(
            q, k, v, ks, vs, vl, k_new=kn, v_new=vn), 3, flush)
        lib = _sdpa_ms(flush, q, (k.float() * ks).to(torch.bfloat16)
                       .transpose(1, 2), (v.float() * vs).to(torch.bfloat16)
                       .transpose(1, 2), vl, s)
        long_case = s == LONG_SLOTS
        before = (BEFORE_MS["attention_long"] if long_case
                  else BEFORE_MS["attention_tick"]
                  if b == NUM_SLOTS and not append else None)
        t = _attn_numbers(label, b, vls, append, err, ms, plain, lib, q, 0,
                          before)
        if long_case:
            long = t
        elif b == NUM_SLOTS and not append:      # the slot tick's form
            tick = _per_tick(t)
            # capacity: the same rows, the same data, in a LONG_SLOTS cache
            big = [torch.zeros((b, LONG_SLOTS) + c.shape[2:], dtype=c.dtype,
                               device="cuda") for c in (k, v, ks, vs)]
            for dst, src in zip(big, (k, v, ks, vs)):
                dst[:, :s] = src
            if not torch.equal(A.decode_attention_int8(q, *big, vl), out):
                raise AssertionError(f"{label}: rows differ in a "
                                     f"{LONG_SLOTS}-slot cache")
    print(f"  decode_attention_int8 per slot tick (30 launches, B={NUM_SLOTS}"
          f", S={s_slots}): ms={tick['ms']:.4f} library_ms="
          f"{tick['library_ms']:.4f} (before the split redesign: "
          f"{BEFORE_MS['attention_tick']}); long context (B={NUM_SLOTS}, "
          f"S={LONG_SLOTS}) per launch: ms={long['ms']:.4f} library_ms="
          f"{long['library_ms']:.4f} (before: {BEFORE_MS['attention_long']})")
    # the split's edges: rows ending just before, at and after a chunk or
    # tile boundary, within tolerance and each equal to itself alone
    b, s = len(BOUNDARY_VALID), max(BOUNDARY_VALID) + 11
    q = torch.randn((b, kvh, g, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v, ks, vs = _attn_cache(gen, (b, s, kvh, hd))
    vl = torch.tensor(BOUNDARY_VALID, dtype=torch.int32, device="cuda")
    label = f"decode_attention_int8 boundaries B={b} S={s}"
    out = A.decode_attention_int8(q, k, v, ks, vs, vl)
    worst = max(worst, _attn_close(
        label, out, A.decode_attention_int8_ref(q, k, v, ks, vs, vl)))
    _rows_alone(label, out, lambda r: A.decode_attention_int8(
        q[r:r + 1], k[r:r + 1], v[r:r + 1], ks[r:r + 1], vs[r:r + 1],
        vl[r:r + 1]), b)
    print(f"  {label} valid_len={BOUNDARY_VALID}: within tolerance; every "
          f"row of every case bitwise equal alone and in its batch, and in "
          f"a {LONG_SLOTS}-slot cache")
    A.decode_attention_int8.launches = 0
    A.decode_attention_int8_ref.calls = 0
    return worst, tick, long


def _paged_tables(cpu_gen, vls, mb, nb, bs):
    """Per-row tables of ``mb`` entries drawn at random from blocks 1 ..
    nb - 1 (rows may share blocks, as prefix sharing makes them), trash
    block 0 past each row's frontier."""
    import torch
    tables = torch.zeros((len(vls), mb), dtype=torch.int32)
    for r, n in enumerate(vls):
        used = -(-n // bs)
        tables[r, :used] = torch.randperm(nb - 1, generator=cpu_gen)[:used] + 1
    return tables.to("cuda")


def chunk_attention_checks(gen, cpu_gen, kvh, g, hd) -> float:
    """The paged kernel at the chunk step's shapes (``layers.attention``
    of s > 1 tokens, every int8 case of CHUNK_CASES): the chunk's n query
    rows with the slot's table repeated n times and frontiers start + 1
    .. start + n -- the contiguous slices' (B, S, KV, hd) leaves read as
    B blocks of bs = S through a one-entry table holding the slot, the
    paged slice's pool through the slot's row -- against the plain
    version within tolerance, and each row bitwise equal to the one-token
    launch the per-token step makes at its frontier (the contiguous
    kernel on the slot's row; the paged kernel through a one-row table).
    Returns the largest error."""
    import torch
    from repro_torch.kernels import decode_attention as A

    worst = 0.0
    for (label, S, max_seq, bs, _, kv_quant, sid,
         start) in CHUNK_CASES:
        if not kv_quant:
            continue
        if bs:
            mb = max_seq // bs
            k, v, ks, vs = _attn_cache(gen, (S * mb + mb + 1, bs, kvh, hd))
            row = (torch.randperm(S * mb + mb, generator=cpu_gen)[:mb]
                   + 1).to(torch.int32).reshape(1, mb).cuda()
        else:
            k, v, ks, vs = _attn_cache(gen, (S, max_seq, kvh, hd))
            row = torch.tensor([[sid]], dtype=torch.int32, device="cuda")
        for n in range(1, PREFILL_CHUNK + 1):
            q = torch.randn((n, kvh, g, hd), generator=gen,
                            device="cuda").to(torch.bfloat16)
            table = row.expand(n, row.shape[1]).contiguous()
            vl = torch.arange(start + 1, start + n + 1, dtype=torch.int32,
                              device="cuda")
            form = (f"decode_attention_int8_paged {label} form n={n} "
                    f"bs={bs or max_seq} MB={row.shape[1]}")
            out = A.decode_attention_int8_paged(q, k, v, ks, vs, vl, table)
            worst = max(worst, _attn_close(
                form, out, A.decode_attention_int8_paged_ref(
                    q, k, v, ks, vs, vl, table)))
            if bs:
                _rows_alone(form, out, lambda r: A.decode_attention_int8_paged(
                    q[r:r + 1], k, v, ks, vs, vl[r:r + 1], row), n)
            else:
                _rows_alone(form, out, lambda r: A.decode_attention_int8(
                    q[r:r + 1], k[sid:sid + 1], v[sid:sid + 1],
                    ks[sid:sid + 1], vs[sid:sid + 1], vl[r:r + 1]), n)
        print(f"  decode_attention_int8_paged in the chunk step's form "
              f"({label}: slot {sid}, frontiers {start + 1}.., "
              f"{'blocks of ' + str(bs) if bs else f'{S} blocks of {max_seq}'}"
              f", n = 1..{PREFILL_CHUNK} rows): within tolerance of the "
              f"plain version; every row bitwise the per-token step's "
              f"one-token launch")
    return worst


def paged_attention_phase(flush):
    """The paged kernel at the paged slice's shapes -- blocks of 16, 4 per
    row (64 positions), the slice's 25-block pool, tables drawn at random
    with trash entries past each row's frontier -- and at the long-context
    case (bs 16, MB 256, 2,049 blocks): against the plain version, bitwise
    against the contiguous kernel on the gathered view, timed beside SDPA
    and the bound; rows bitwise equal alone and in the batch, with 4 and
    with 256 table entries, and at the split's edges; then at the chunk
    step's shapes (:func:`chunk_attention_checks`)."""
    import torch
    from repro_torch.kernels import decode_attention as A

    kvh, g, hd, bs = 2, 12, 128, PAGED_BLOCK
    s_row = PAGED_PROMPT_LEN + MAX_NEW
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    cpu_gen = torch.Generator().manual_seed(SEED + 3)
    ragged = [0, 1, 5, 17, s_row - 1, s_row, s_row // 2, 12]
    long_mb = LONG_SLOTS // bs
    pools = {PAGED_NUM_BLOCKS: _attn_cache(gen, (PAGED_NUM_BLOCKS, bs, kvh,
                                                 hd)),
             NUM_SLOTS * long_mb + 1: _attn_cache(
                 gen, (NUM_SLOTS * long_mb + 1, bs, kvh, hd))}
    cases = [(NUM_SLOTS, s_row // bs, PAGED_NUM_BLOCKS, ragged[:NUM_SLOTS],
              False),
             (NUM_SLOTS, s_row // bs, PAGED_NUM_BLOCKS, ragged[:NUM_SLOTS],
              True),
             (1, s_row // bs, PAGED_NUM_BLOCKS, [s_row // 2 + 3], False),
             (1, s_row // bs, PAGED_NUM_BLOCKS, [0], True),
             (NUM_SLOTS, long_mb, NUM_SLOTS * long_mb + 1, LONG_VALID, False)]
    tick = long = {}
    worst = 0.0
    for b, mb, nb, vls, append in cases:
        k, v, ks, vs = pools[nb]
        q = torch.randn((b, kvh, g, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        tables = _paged_tables(cpu_gen, vls, mb, nb, bs)
        vl = torch.tensor(vls, dtype=torch.int32, device="cuda")
        kn = vn = None
        if append:
            kn = torch.randn((b, kvh, hd), generator=gen, device="cuda")
            vn = torch.randn((b, kvh, hd), generator=gen, device="cuda")
        label = f"decode_attention_int8_paged B={b} bs={bs} MB={mb} NB={nb}"
        out = A.decode_attention_int8_paged(q, k, v, ks, vs, vl, tables,
                                            k_new=kn, v_new=vn)
        ref = A.decode_attention_int8_paged_ref(q, k, v, ks, vs, vl, tables,
                                                k_new=kn, v_new=vn)
        err = _attn_close(label, out, ref)
        worst = max(worst, err)
        gk, gv, gks, gvs = (A.paged_gather(c, tables).contiguous()
                            for c in (k, v, ks, vs))
        # the contiguous kernel on the gathered view: the same bits
        if not torch.equal(out, A.decode_attention_int8(
                q, gk, gv, gks, gvs, vl, k_new=kn, v_new=vn)):
            raise AssertionError(f"{label}: not bitwise equal to the "
                                 f"contiguous kernel on the gathered view")
        _rows_alone(label, out, lambda r: A.decode_attention_int8_paged(
            q[r:r + 1], k, v, ks, vs, vl[r:r + 1], tables[r:r + 1],
            k_new=None if kn is None else kn[r:r + 1],
            v_new=None if vn is None else vn[r:r + 1]), b)
        ms = time_ms(lambda: A.decode_attention_int8_paged(
            q, k, v, ks, vs, vl, tables, k_new=kn, v_new=vn), 20, flush)
        plain = time_ms(lambda: A.decode_attention_int8_paged_ref(
            q, k, v, ks, vs, vl, tables, k_new=kn, v_new=vn), 3, flush)
        lib = _sdpa_ms(flush, q, (gk.float() * gks).to(torch.bfloat16)
                       .transpose(1, 2), (gv.float() * gvs)
                       .to(torch.bfloat16).transpose(1, 2), vl, mb * bs)
        long_case = mb == long_mb
        before = (BEFORE_MS["paged_attention_long"] if long_case
                  else BEFORE_MS["paged_attention_tick"]
                  if b == NUM_SLOTS and not append else None)
        t = _attn_numbers(label, b, vls, append, err, ms, plain, lib, q,
                          tables.numel() * 4, before)
        if long_case:
            long = t
        elif b == NUM_SLOTS and not append:      # the paged slot tick's form
            tick = _per_tick(t)
            # capacity: the same rows through tables of long_mb entries
            wide = torch.zeros((b, long_mb), dtype=torch.int32,
                               device="cuda")
            wide[:, :mb] = tables
            if not torch.equal(A.decode_attention_int8_paged(
                    q, k, v, ks, vs, vl, wide), out):
                raise AssertionError(f"{label}: rows differ through "
                                     f"{long_mb}-entry tables")
    print(f"  decode_attention_int8_paged per slot tick (30 launches, "
          f"B={NUM_SLOTS}): ms={tick['ms']:.4f} library_ms="
          f"{tick['library_ms']:.4f} (before the split redesign: "
          f"{BEFORE_MS['paged_attention_tick']}); long context (B="
          f"{NUM_SLOTS}, MB={long_mb}) per launch: ms={long['ms']:.4f} "
          f"library_ms={long['library_ms']:.4f} (before: "
          f"{BEFORE_MS['paged_attention_long']})")
    b = len(BOUNDARY_VALID)
    mb = -(-max(BOUNDARY_VALID) // bs)
    nb = b * mb + 1
    k, v, ks, vs = _attn_cache(gen, (nb, bs, kvh, hd))
    q = torch.randn((b, kvh, g, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    tables = _paged_tables(cpu_gen, BOUNDARY_VALID, mb, nb, bs)
    vl = torch.tensor(BOUNDARY_VALID, dtype=torch.int32, device="cuda")
    label = f"decode_attention_int8_paged boundaries B={b} MB={mb}"
    out = A.decode_attention_int8_paged(q, k, v, ks, vs, vl, tables)
    worst = max(worst, _attn_close(label, out, A.decode_attention_int8_paged_ref(
        q, k, v, ks, vs, vl, tables)))
    _rows_alone(label, out, lambda r: A.decode_attention_int8_paged(
        q[r:r + 1], k, v, ks, vs, vl[r:r + 1], tables[r:r + 1]), b)
    print(f"  {label} valid_len={BOUNDARY_VALID}: within tolerance; every "
          f"row of every case bitwise equal alone and in its batch, to the "
          f"contiguous kernel on the gathered view, and through "
          f"{long_mb}-entry tables")
    worst = max(worst, chunk_attention_checks(gen, cpu_gen, kvh, g, hd))
    A.decode_attention_int8.launches = 0
    A.decode_attention_int8_paged.launches = 0
    A.decode_attention_int8_paged_ref.calls = 0
    return worst, tick, long


def _w8a8_threshold(K) -> int:
    """The wrapper's path threshold (named W8A8_DP4A_MAX_ROWS before the
    GEMV took the decode tick, so a parent's kernels run under --src)."""
    return getattr(K, "W8A8_GEMV_MAX_ROWS", None) or K.W8A8_DP4A_MAX_ROWS


def w8a8_check(label, x, w, xs, ws, bias, act):
    """qmatmul_w8a8 (the wrapper's own choice of kernel) on one input:
    its int32 sums bitwise equal to the plain version's (unit scales, no
    bias, no activation), its bf16 drain within one bf16 ulp (bf16_close),
    and, where the wrapper takes the tensor-core kernel, its bf16 output
    torch.equal to the same rows launched in slices that the GEMV takes.
    Returns (max_abs_err, err / tol, drain bitwise)."""
    import torch
    from repro_torch.kernels import qmatmul as K

    m, n = x.shape[0], w.shape[1]
    one, ones = torch.ones((), device="cuda"), torch.ones((n,), device="cuda")
    acc = K.qmatmul_w8a8(x, w, one, ones)
    acc_ref = K.qmatmul_w8a8_ref(x, w, one, ones)
    kw = dict(activation=act, out_dtype=torch.bfloat16)
    out = K.qmatmul_w8a8(x, w, xs, ws, bias, **kw)
    ref = K.qmatmul_w8a8_ref(x, w, xs, ws, bias, **kw)
    torch.cuda.synchronize()
    if float(acc_ref.abs().max()) >= 2 ** 24:
        raise AssertionError("int32 check: a sum is not exact in f32")
    if not torch.equal(acc, acc_ref):
        raise AssertionError(f"qmatmul_w8a8 {label}: the int32 accumulate is "
                             f"not bitwise equal to the plain version's")
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"qmatmul_w8a8 {label}: bad output")
    err, ratio = bf16_close(out, ref, f32_out=False)
    if ratio > 1.0:
        raise AssertionError(
            f"qmatmul_w8a8 {label}: kernel disagrees with its plain version "
            f"beyond tolerance (err/tol={ratio:.3f})")
    size = _w8a8_threshold(K)
    if K.w8a8_path(m) == "mma":
        for i in range(0, m, size):
            part = K.qmatmul_w8a8(x[i:i + size].contiguous(), w, xs, ws,
                                  bias, **kw)
            if not torch.equal(part, out[i:i + size]):
                raise AssertionError(
                    f"qmatmul_w8a8 {label}: rows {i}..{i + size - 1} of the "
                    f"tensor-core launch differ from the same rows through "
                    f"the GEMV")
    return err, ratio, torch.equal(out, ref)


def qmatmul_w8a8_phase(flush):
    """Every projection of full-width starcoder2-3b under W8A8, with the
    activation each projection uses and bf16 out, at a decode tick's M = 8
    and 16, at the service curve's largest prefill (M = 512), and either
    side of the wrapper's path threshold, plus one ragged shape (M = 513,
    K = 3088, N = 260): each held by w8a8_check.  Timed at M = 8 and 16 (per tick)
    and M = 512 (per forward) through the wrapper, against the plain
    version, the bound and a yardstick: torch._int_mm and the drain in
    PyTorch, or, where the build refuses that M, F.linear on
    pre-dequantized bf16 weights.  Then both kernels are timed at every M
    of W8A8_PATH_ROWS, whatever the wrapper would pick.  Returns (worst
    error, per-forward numbers, library name, {tick rows: per-tick
    numbers})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import qmatmul as K

    d, ff, kvd = 3072, 12288, 256
    # (name, K, N, bias, activation, launches per forward)
    shapes = [("wq", d, d, True, "none", 30),
              ("wk|wv", d, kvd, True, "none", 60),
              ("wo", d, d, False, "none", 30),
              ("w_up", d, ff, False, "gelu", 30),
              ("w_down", ff, d, False, "none", 30)]
    threshold = _w8a8_threshold(K)
    few = K.W8A8_PATHS[0]      # the decode tick's kernel ("dp4a" before)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bytes_ms", "ops_ms")
    per_m = {m: dict.fromkeys(keys, 0.0)
             for m in W8A8_TICK_ROWS + (SERVE_ROWS,)}
    path_ms = {m: dict.fromkeys(K.W8A8_PATHS, 0.0) for m in W8A8_PATH_ROWS}
    worst_err, library, plans = 0.0, set(), []

    def data(m, k, n, has_bias):
        x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        xs = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
        ws = torch.rand((n,), generator=gen, device="cuda") * 2e-3 + 1e-4
        bias = (torch.randn((n,), generator=gen, device="cuda") * 0.1
                if has_bias else None)
        return x, w, xs, ws, bias

    for name, k, n, has_bias, act, per_fwd in shapes:
        x, w, xs, ws, bias = data(max(SERVE_ROWS, threshold + 1), k, n,
                                  has_bias)
        w_lib = (w.float() * ws).to(torch.bfloat16).t()   # (N, K) view
        if hasattr(K, "w8a8_split_plan"):
            plan = K.w8a8_split_plan(k, n)
            plans.append(f"{name} K={k} N={n}: {plan.strips} strips x "
                          f"{plan.splits} splits of {plan.split_rows} rows "
                          f"= {plan.strips * plan.splits} blocks at M <= "
                          f"{K.W8A8_MR}")
        for m in sorted({*W8A8_TICK_ROWS, threshold, threshold + 1,
                         SERVE_ROWS}):
            xm = x[:m].contiguous()
            label = f"{name} M={m} ({K.w8a8_path(m)})"
            err, ratio, bitwise = w8a8_check(label, xm, w, xs, ws, bias, act)
            worst_err = max(worst_err, err)
            if m not in per_m:
                print(f"  qmatmul_w8a8 {name:7s} M={m:3d} K={k:5d} N={n:5d} "
                      f"path={K.w8a8_path(m)} int32_bitwise=True "
                      f"drain_bitwise={bitwise} max_abs_err={err:.3e} "
                      f"err/tol={ratio:.3f}")
                continue
            ms = time_ms(lambda: K.qmatmul_w8a8(
                xm, w, xs, ws, bias, activation=act,
                out_dtype=torch.bfloat16), 20, flush)
            plain = time_ms(lambda: K.qmatmul_w8a8_ref(
                xm, w, xs, ws, bias, activation=act,
                out_dtype=torch.bfloat16), 3, flush)

            def int_mm():
                y = torch._int_mm(xm, w).float() * xs * ws
                if bias is not None:
                    y = y + bias
                return K.activate(y, act).to(torch.bfloat16)

            try:
                int_mm()
                lib_fn, lib_name = int_mm, "torch._int_mm + drain"
            except RuntimeError:
                lib_fn = lambda: F.linear(  # noqa: E731
                    xm.to(torch.bfloat16) * xs.to(torch.bfloat16), w_lib,
                    None if bias is None else bias.to(torch.bfloat16))
                lib_name = "F.linear, bf16 weights"
            library.add(lib_name)
            lib = time_ms(lib_fn, 20, flush)
            nbytes = (m * k + k * n + 4 + 4 * n + (4 * n if has_bias else 0)
                      + 2 * m * n)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * m * k * n / INT8_OPS_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            print(f"  qmatmul_w8a8 {name:7s} M={m:3d} K={k:5d} N={n:5d} "
                  f"act={act:4s} path={K.w8a8_path(m)} int32_bitwise=True "
                  f"drain_bitwise={bitwise} max_abs_err={err:.3e} "
                  f"err/tol={ratio:.3f} ms={ms:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} ({lib_name}) bound_ms={bound:.4f}")
            for key, val in zip(keys, (ms, plain, bound, lib, bytes_ms,
                                       ops_ms)):
                per_m[m][key] += per_fwd * val
        times = []
        for m in W8A8_PATH_ROWS:
            xm = x[:m].contiguous()
            for path in K.W8A8_PATHS:
                t = time_ms(lambda: K.qmatmul_w8a8_on_path(
                    path, xm, w, xs, ws, bias, activation=act,
                    out_dtype=torch.bfloat16), 20, flush)
                path_ms[m][path] += per_fwd * t
                times.append(f"M={m} {path}={t:.4f}")
        print(f"  qmatmul_w8a8 {name:7s} paths: {' '.join(times)}")
    x, w, xs, ws, bias = data(513, 3088, 260, True)
    err, ratio, bitwise = w8a8_check("ragged M=513 K=3088 N=260", x, w, xs,
                                     ws, bias, "gelu")
    worst_err = max(worst_err, err)
    print(f"  qmatmul_w8a8 ragged  M=513 K= 3088 N=  260 act=gelu "
          f"path={K.w8a8_path(513)} int32_bitwise=True drain_bitwise="
          f"{bitwise} max_abs_err={err:.3e} err/tol={ratio:.3f}")
    faster = [m for m in W8A8_PATH_ROWS
              if path_ms[m]["mma"] < path_ms[m][few]]
    if plans:
        print("  qmatmul_w8a8 GEMV split plan: " + "; ".join(plans))
    print("  qmatmul_w8a8 per 30 layers x 6 projections, by path: " + "; ".join(
        f"M={m} {few}={t[few]:.4f} mma={t['mma']:.4f}"
        for m, t in path_ms.items()))
    print(f"  qmatmul_w8a8 threshold: M <= {threshold} takes {few}, more "
          f"rows mma.sync; of the timed M, mma.sync was faster at "
          f"{faster or 'none'}")
    for m, before in zip(W8A8_TICK_ROWS, ("w8a8_tick", "w8a8_tick16")):
        tick = per_m[m]
        print(f"  qmatmul_w8a8 per {m}-row decode tick (30 layers x 6 "
              f"projections): ms={tick['ms']:.4f} (before the redesign: "
              f"{BEFORE_MS[before]}) bound_ms={tick['bound_ms']:.4f} "
              f"plain_ms={tick['plain_ms']:.4f} "
              f"library_ms={tick['library_ms']:.4f}")
    fwd = per_m[SERVE_ROWS]
    print(f"  qmatmul_w8a8 per {SERVE_MAX_BATCH} x {SERVE_SEQ}-token forward "
          f"(M = {SERVE_ROWS}): ms={fwd['ms']:.4f} "
          f"bound_ms={fwd['bound_ms']:.4f} plain_ms={fwd['plain_ms']:.4f} "
          f"library_ms={fwd['library_ms']:.4f}")
    K.qmatmul_w8a8.launches = 0
    K.qmatmul_w8a8_ref.calls = 0
    return (worst_err, fwd, " or ".join(sorted(library)),
            {m: per_m[m] for m in W8A8_TICK_ROWS})


def flash_phase(flush):
    """flash_attention_bhsd at the service curve's shapes (BH = 24 heads x
    batch 1, 4, 16; Sq = Skv = 32; hd 128; bf16; causal), plus a window
    case and a kv_len < Skv case, against its plain version (bf16 out: one
    bf16 ulp, bf16_close) and timed against its bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    h, s, hd = 24, SERVE_SEQ, 128
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    cases = [(h * b, None, None) for b in (1, 4, SERVE_MAX_BATCH)]
    cases += [(h * 4, 8, None), (h * 4, None, 20)]
    worst, fwd = 0.0, {}
    for bh, window, kv_len in cases:
        q, k, v = (torch.randn((bh, s, hd), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        kw = dict(causal=True, window=window, kv_len=kv_len)
        out = FA.flash_attention_bhsd(q, k, v, **kw)
        ref = FA.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"flash BH={bh}: bad output")
        err, ratio = bf16_close(out, ref, f32_out=False)
        worst = max(worst, err)
        ms = time_ms(lambda: FA.flash_attention_bhsd(q, k, v, **kw), 20,
                     flush)
        plain = time_ms(lambda: FA.flash_attention_ref(q, k, v, **kw), 3,
                        flush)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), 20, flush)
        kvl = s if kv_len is None else kv_len
        qpos = torch.arange(s)[:, None]
        kpos = torch.arange(s)[None, :]
        valid = (kpos <= qpos) & (kpos < kvl)
        if window is not None:
            valid &= kpos > qpos - window
        pairs = int(valid.sum())
        bytes_ms = 4 * bh * s * hd * 2 / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * bh * pairs * hd / BF16_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        print(f"  flash_attention_bhsd BH={bh} S={s} hd={hd} causal "
              f"window={window} kv_len={kv_len} max_abs_err={err:.3e} "
              f"err/tol={ratio:.3f} ms={ms:.4f} plain_ms={plain:.4f} "
              f"library_ms={lib:.4f} (SDPA, causal only) "
              f"bound_ms={bound:.5f}")
        if ratio > 1.0:
            raise AssertionError(
                f"flash BH={bh} window={window} kv_len={kv_len}: kernel "
                f"disagrees with its plain version beyond tolerance "
                f"(err/tol={ratio:.3f})")
        if bh == h * SERVE_MAX_BATCH:     # one forward at the largest batch
            fwd = {"ms": 30 * ms, "plain_ms": 30 * plain,
                   "bound_ms": 30 * bound, "library_ms": 30 * lib,
                   "bytes_ms": 30 * bytes_ms, "ops_ms": 30 * ops_ms}
    print(f"  flash_attention_bhsd per {SERVE_MAX_BATCH} x {SERVE_SEQ}-token "
          f"forward (30 launches, BH={h * SERVE_MAX_BATCH}): "
          f"ms={fwd['ms']:.4f} (before the redesign: "
          f"{BEFORE_MS['flash_forward']}) "
          f"library_ms={fwd['library_ms']:.4f} (SDPA) "
          f"bound_ms={fwd['bound_ms']:.4f}")
    FA.flash_attention_bhsd.launches = 0
    FA.flash_attention_ref.calls = 0
    return worst, fwd


RMSNORM_WIDTHS = (3072, 5120, 6144)    # starcoder2's d, then the RMSNorm
                                       # configs' (mistral-nemo and
                                       # qwen1.5, internlm2)


def rmsnorm_phase(widths=RMSNORM_WIDTHS) -> None:
    """layers.rmsnorm at each d of ``widths`` (f32 and bf16 x): every row of
    B = 8 and B = 16 calls bit-for-bit equal to the row normalised alone
    (B = 1); a row reduction on the card must not take its layout from
    the batch."""
    import torch
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    for d in widths:
        p = {"scale": 1 + 0.1 * torch.randn((d,), generator=gen,
                                            device="cuda")}
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((16, d), generator=gen, device="cuda")
                 * 3).to(dtype)
            full = L.rmsnorm(p, x)
            ok = torch.equal(L.rmsnorm(p, x[:8]), full[:8]) and all(
                torch.equal(L.rmsnorm(p, x[i:i + 1])[0], full[i])
                for i in range(16))
            if not ok or not torch.isfinite(full).all():
                raise AssertionError(f"rmsnorm d={d} {dtype}: rows of B = "
                                     f"8 / 16 are not bitwise equal to B = 1")
    print(f"rmsnorm: d = {', '.join(map(str, widths))}, f32 and bf16: rows "
          f"of B = 1, 8 and 16 bitwise equal")


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def build_model():
    """Full-width starcoder2-3b with random weights from SEED, quantized
    to W8A16 on the card as they are drawn (``registry.init_quantized``,
    bitwise ``quantize_tree(init(...), min_size=2048)``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import tree_weight_bytes
    from repro_torch.models import registry as R

    cfg = dataclasses.replace(get_config("starcoder2-3b"), kv_quant=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        params = R.init_quantized(gen, cfg, min_size=2048, device="cuda")
    torch.cuda.synchronize()
    print(f"slice: {cfg.name} full width ({cfg.n_layers} layers, "
          f"d={cfg.d_model}), W8A16 weights {tree_weight_bytes(params)} "
          f"bytes, init+quantize {time.perf_counter() - t0:.1f}s")
    return cfg, params


def _counted():
    """(every kernel wrapper, every plain version)."""
    from repro_torch.kernels import decode_attention as A
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import qmatmul as K
    return ((K.qmatmul_w8a16, A.decode_attention_int8,
             A.decode_attention_int8_paged, K.qmatmul_w8a8,
             FA.flash_attention_bhsd, K.qmatmul_w8a16_experts),
            (K.qmatmul_w8a16_ref, A.decode_attention_int8_ref,
             A.decode_attention_int8_paged_ref, K.qmatmul_w8a8_ref,
             FA.flash_attention_ref))


def zero_counts() -> None:
    from repro_torch.kernels import qmatmul as K
    kernels, plains = _counted()
    for fn in kernels:
        fn.launches = 0
    for path in K.qmatmul_w8a16.launches_by_path:
        K.qmatmul_w8a16.launches_by_path[path] = 0
    for fn in plains:
        fn.calls = 0


def read_counts():
    """(kernel launches, plain-version calls) since :func:`zero_counts`;
    qmatmul_w8a16's launches also by path, as ``qmatmul_w8a16[<path>]``."""
    from repro_torch.kernels import qmatmul as K
    kernels, plains = _counted()
    launches = {f.__name__: f.launches for f in kernels}
    for path, n in K.qmatmul_w8a16.launches_by_path.items():
        launches[f"qmatmul_w8a16[{path}]"] = n
    return launches, {f.__name__: f.calls for f in plains}


def mma_free(label, launches) -> None:
    """The engine's steps and the decode loop run the GEMV only: their
    rows must not depend on the batch, and the mma path's differ from the
    GEMV's by f32 rounding."""
    if launches["qmatmul_w8a16[mma]"]:
        raise AssertionError(f"{label}: a decode step took qmatmul_w8a16's "
                             f"mma path: {launches}")


def check_served(label, cfg, rep, reqs, max_new=MAX_NEW) -> None:
    outs = rep.outputs()
    if len(rep.results) != len(reqs):
        raise AssertionError(f"{label}: {len(rep.results)} results for "
                             f"{len(reqs)} requests")
    for r in rep.results:
        toks = outs[r.rid]
        if (r.status != "ok" or len(toks) != max_new
                or not all(0 <= t < cfg.vocab for t in toks)):
            raise AssertionError(f"{label}: request {r.rid}: status "
                                 f"{r.status}, tokens {toks}")


def compare_with_reference(label, cfg, params, eng, reqs, outs) -> None:
    """The engine's tokens for ``reqs`` against the sequential batch-1
    ``reference_outputs`` (contiguous cache) on the card: equal, except
    that a request may part ways where the reference's top-2 logit gap
    is below TIE_TOL."""
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16

    margins = {}
    ref = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                              max_seq=eng.max_seq, margins=margins)
    near_ties = 0
    for rid, toks in ref.items():
        got = outs[rid]
        first = next((i for i, (a, b) in enumerate(zip(got, toks))
                      if a != b), None)
        if first is None:
            continue
        gap = margins[rid][first]
        print(f"{label}: request {rid} diverges at token {first}: engine "
              f"{got[first]} reference {toks[first]}, reference top-2 gap "
              f"{gap:.3e}")
        if gap >= TIE_TOL:
            raise AssertionError(f"{label}: request {rid}: engine and "
                                 f"reference disagree at a step that is no "
                                 f"near-tie")
        near_ties += 1
    print(f"{label}: {len(ref)} requests {sorted(ref)} compared with "
          f"reference_outputs on the card: {len(ref) - near_ties} equal "
          f"token for token, {near_ties} diverging at a near-tie (top-2 gap "
          f"< {TIE_TOL}); smallest reference top-2 gap "
          f"{min(min(v) for v in margins.values()):.3e}")


def step_captures(eng):
    """The captures of the engine's memoized tick and chunk steps (every
    bucket its chunks can take) and, speculating, of its verify and
    propose steps and the draft's chunk steps."""
    from repro_torch.runtime import steps as ST

    def buckets(cap):
        return sorted({ST.bucket_batch(n) for n in range(1, cap + 1)})

    be = eng.backend
    steps = [be.slot_step(eng.cfg, mode=eng.mode,
                          temperature=eng.temperature)]
    steps += [be.chunk_step(eng.cfg, mode=eng.mode, chunk=c)
              for c in buckets(eng.prefill_chunk)]
    if eng.spec_k:
        steps += [be.verify_step(eng.cfg, mode=eng.mode, k=eng.spec_k,
                                 temperature=eng.temperature),
                  be.propose_step(eng.dcfg, mode=eng.mode, k=eng.spec_k)]
        steps += [be.chunk_step(eng.dcfg, mode=eng.mode, chunk=c)
                  for c in buckets(eng.draft_cap)]
    return [s.captured.captures for s in steps]


def warm(label, eng, reqs):
    """``Engine.warmup`` (every graph of the tick and the chunk step),
    then a short first-call serve that must capture nothing more;
    returns the steps' captures after the warm-up, which the measured
    serve must leave as they are too."""
    eng.warmup()
    bound = step_captures(eng)
    eng.serve(reqs, clock="wall")
    same_captures(f"{label} first-call serve", eng, bound)
    what = ("verify, propose and chunk graphs (one per chunk length, the "
            "draft's and the target's)" if eng.spec_k else
            "the tick and chunk graphs (one per chunk length)")
    print(f"{label}: warm-up captured {what}, {sum(bound)} captures of "
          f"their memoized steps so far; a first-call serve captured none")
    return bound


def same_captures(label, eng, bound) -> None:
    if step_captures(eng) != bound:
        raise AssertionError(f"{label}: the serve captured a graph: "
                             f"{bound} -> {step_captures(eng)}")


def slice_phase(cfg, params):
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16

    eng = E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                   max_seq=PROMPT_LEN + MAX_NEW,
                   prefill_chunk=PREFILL_CHUNK)
    reqs = E.synthetic_requests(N_REQUESTS, rate_per_s=400.0,
                                vocab=cfg.vocab, prompt_len=PROMPT_LEN,
                                max_new_tokens=MAX_NEW, seed=SEED)
    bound = warm("slice", eng, reqs[:2])

    zero_counts()
    rep = eng.serve(reqs, clock="wall")
    launches, plain_calls = read_counts()
    same_captures("slice", eng, bound)
    print(f"slice: served {len(rep.results)} requests in {rep.ticks} ticks, "
          f"{rep.generated_tokens} tokens, wall {rep.wall_s:.3f}s, "
          f"decoded tok/s {rep.generated_tokens / rep.wall_s:.1f}, "
          f"ms/tick {1e3 * rep.wall_s / rep.ticks:.2f}, "
          f"p99 latency {rep.p99_latency_s:.3f}s, "
          f"mean ttft {rep.mean_ttft_s:.3f}s, "
          f"mean occupancy {rep.mean_occupancy:.3f}, "
          f"watchdog stuck ticks {rep.stuck_ticks}")
    print(f"slice: before the captured chunk: {BEFORE_CHUNK['slice']}")
    print(f"slice: kernel launches {launches}, plain-version calls "
          f"{plain_calls}")
    # the chunks read the contiguous slot rows through the paged kernel
    path = ("qmatmul_w8a16", "decode_attention_int8",
            "decode_attention_int8_paged")
    if any(launches[k] <= 0 for k in path):
        raise AssertionError(f"a kernel of the path never launched: "
                             f"{launches}")
    mma_free("slice", launches)
    if any(plain_calls.values()):
        raise AssertionError(f"the CUDA path reached a plain version: "
                             f"{plain_calls}")
    check_served("slice", cfg, rep, reqs)
    tick_breakdown(cfg, params, eng.num_slots, eng.max_seq)
    compare_with_reference("slice", cfg, params, eng, reqs[:N_COMPARE],
                           rep.outputs())
    return launches


def paged_slice_phase(cfg, params):
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16

    eng = E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                   max_seq=PAGED_PROMPT_LEN + MAX_NEW,
                   prefill_chunk=PREFILL_CHUNK, block_size=PAGED_BLOCK,
                   num_blocks=PAGED_NUM_BLOCKS)
    reqs = E.synthetic_requests(N_REQUESTS, rate_per_s=PAGED_RATE_PER_S,
                                vocab=cfg.vocab,
                                prompt_len=PAGED_PROMPT_LEN,
                                shared_prefix_len=PAGED_SHARED_PREFIX,
                                max_new_tokens=MAX_NEW, seed=SEED)
    bound = warm("paged", eng, reqs[:1])

    zero_counts()
    rep = eng.serve(reqs, clock="wall")
    launches, plain_calls = read_counts()
    same_captures("paged", eng, bound)
    print(f"paged: served {len(rep.results)} requests in {rep.ticks} ticks, "
          f"{rep.generated_tokens} tokens, wall {rep.wall_s:.3f}s")
    print(f"paged: decoded tok/s {rep.generated_tokens / rep.wall_s:.1f}")
    print(f"paged: ms/tick {1e3 * rep.wall_s / rep.ticks:.2f}")
    print(f"paged: p99 latency {rep.p99_latency_s:.3f}s")
    print(f"paged: mean ttft {rep.mean_ttft_s:.3f}s")
    print(f"paged: before the captured chunk: {BEFORE_CHUNK['paged']}")
    print(f"paged: mean occupancy {rep.mean_occupancy:.3f}, watchdog stuck "
          f"ticks {rep.stuck_ticks}")
    print(f"paged: block_size {rep.block_size}, num_blocks {rep.num_blocks}, "
          f"kv_hbm_bytes {rep.kv_hbm_bytes}")
    print(f"paged: peak_blocks_used {rep.peak_blocks_used}, mean_block_util "
          f"{rep.mean_block_util:.3f}, leaked_blocks {rep.leaked_blocks}")
    print(f"paged: shared_block_hits {rep.shared_block_hits}, "
          f"shared_hit_rate {rep.shared_hit_rate:.3f}, "
          f"prefill_tokens_skipped {rep.prefill_tokens_skipped}")
    print(f"paged: kernel launches {launches}, plain-version calls "
          f"{plain_calls}")
    path = ("qmatmul_w8a16", "decode_attention_int8_paged")
    if any(launches[k] <= 0 for k in path):
        raise AssertionError(f"a kernel of the paged path never launched: "
                             f"{launches}")
    if launches["decode_attention_int8"]:
        raise AssertionError("the paged path reached the contiguous "
                             "attention kernel")
    mma_free("paged", launches)
    if any(plain_calls.values()):
        raise AssertionError(f"the CUDA path reached a plain version: "
                             f"{plain_calls}")
    check_served("paged", cfg, rep, reqs)
    if rep.shared_block_hits <= 0:
        raise AssertionError("no prefix block was shared")
    if rep.prefill_tokens_skipped != rep.shared_block_hits * PAGED_BLOCK:
        raise AssertionError("prefill_tokens_skipped != hits * block_size")
    if rep.peak_blocks_used > rep.num_blocks - 1 or rep.leaked_blocks:
        raise AssertionError(f"block accounting: peak "
                             f"{rep.peak_blocks_used}, leaked "
                             f"{rep.leaked_blocks}")
    tick_breakdown(cfg, params, eng.num_slots, eng.max_seq,
                   eng.block_size, label="paged tick")
    # the first request that shared a prefix block, and the first others
    sharer = min(r.rid for r in rep.results if r.shared_blocks)
    rids = [sharer] + [r.rid for r in rep.results
                       if r.rid != sharer][:N_COMPARE - 1]
    compare_with_reference("paged", cfg, params, eng,
                           [r for r in reqs if r.rid in rids],
                           rep.outputs())
    return launches


# ---------------------------------------------------------------------------
# overload phase
# ---------------------------------------------------------------------------

def overload_trace(cfg, rate):
    from repro_torch import engine as E
    return E.synthetic_requests(
        N_REQUESTS, rate_per_s=rate, vocab=cfg.vocab, prompt_len=PROMPT_LEN,
        max_new_tokens=MAX_NEW, seed=SEED,
        priority=lambda rid: "batch" if rid % 2 else "interactive")


def overload_serve(label, eng, reqs, bound, path, **kw):
    """One wall-clock serve with the counters zeroed just before and read
    just after: no capture, no plain version, no mma launch, every kernel
    of ``path`` launched, every request retired once; prints its
    numbers and returns the report."""
    zero_counts()
    rep = eng.serve(reqs, clock="wall", **kw)
    launches, plain_calls = read_counts()
    same_captures(label, eng, bound)
    mma_free(label, launches)
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: the CUDA path reached a plain "
                             f"version: {plain_calls}")
    if any(launches[k] <= 0 for k in path):
        raise AssertionError(f"{label}: a kernel of the path never "
                             f"launched: {launches}")
    if sorted(r.rid for r in rep.results) != sorted(r.rid for r in reqs):
        raise AssertionError(f"{label}: not every request retired once")

    def per_class(d, scale):
        return ", ".join(f"{c} {v * scale:.3f}" for c, v in d.items())

    print(f"{label}: {len(rep.results)} requests in {rep.ticks} ticks, "
          f"{rep.generated_tokens} tokens, wall {rep.wall_s:.3f}s, "
          f"decoded tok/s {rep.generated_tokens / rep.wall_s:.1f}, "
          f"ms/tick {1e3 * rep.wall_s / rep.ticks:.2f}, goodput "
          f"{rep.goodput_tokens_per_s:.1f} tok/s, p99 latency "
          f"{rep.p99_latency_s:.3f}s, mean ttft {rep.mean_ttft_s:.3f}s")
    print(f"{label}: class p99 latency (s) "
          f"{per_class(rep.class_p99_latency_s, 1)}; class mean ttft (s) "
          f"{per_class(rep.class_mean_ttft_s, 1)}; class p99 ttft (s) "
          f"{per_class(rep.class_p99_ttft_s, 1)}")
    print(f"{label}: preempted {rep.preempted}, dispatch_retries "
          f"{rep.dispatch_retries}, nonfinite_samples "
          f"{rep.nonfinite_samples}, torn_rows_repaired "
          f"{rep.torn_rows_repaired}, failed {rep.failed}, unfinished "
          f"{rep.unfinished}, leaked_blocks {rep.leaked_blocks}, tokens "
          f"re-prefilled by resumes {rep.resumed_prefill_tokens}, most "
          f"slots held per class "
          f"{ {c: max(v) for c, v in rep.class_occupancy.items()} }, "
          f"watchdog stuck ticks {rep.stuck_ticks}")
    print(f"{label}: kernel launches {launches}")
    return rep


def same_as_control(label, rep, control) -> None:
    """Every ok request's tokens equal the control serve's."""
    want = control.outputs()
    bad = [r.rid for r in rep.results
           if r.status == "ok" and r.tokens != want[r.rid]]
    if bad:
        raise AssertionError(f"{label}: requests {bad} differ from the "
                             f"control serve")
    print(f"{label}: {sum(r.status == 'ok' for r in rep.results)} ok "
          f"requests equal the control serve token for token")


def overload_phase(cfg, params) -> None:
    from repro_torch import engine as E
    from repro_torch.core import batching as bt
    from repro_torch.core.qlinear import W8A16

    # 1) paged: block pressure, and one fault of each kind
    label = "overload paged"
    reqs = overload_trace(cfg, OVERLOAD_RATE_PER_S)
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                   max_seq=PROMPT_LEN + MAX_NEW, prefill_chunk=PREFILL_CHUNK,
                   block_size=PAGED_BLOCK, num_blocks=OVERLOAD_BLOCKS)
    bound = warm(label, eng, reqs[:2])
    path = ("qmatmul_w8a16", "decode_attention_int8_paged")
    control = overload_serve(f"{label} control", eng, reqs, bound, path)
    check_served(f"{label} control", cfg, control, reqs)
    faults = list(OVERLOAD_FAULTS)
    last = max(t for _, t, _, _ in faults)
    if last >= control.ticks // 2:
        # the serve is shorter than the plan: spread it over its first half
        faults = [(k, (j + 1) * control.ticks // (2 * len(faults)), s, r)
                  for j, (k, _, s, r) in enumerate(faults)]
    print(f"{label}: fault plan (kind, tick, slot, repeat) {faults}; the "
          f"control serve ran {control.ticks} ticks")
    plan = E.FaultPlan([E.Fault(t, k, s, r) for k, t, s, r in faults])
    rep = overload_serve(label, eng, reqs, bound, path, preemption=True,
                         fault_plan=plan, max_retries=OVERLOAD_MAX_RETRIES)
    print(f"{label}: fired {plan.fired}")
    missing = [f for f in plan.faults
               if not any(t == f.tick and k == f.kind
                          for t, k, _ in plan.fired)]
    if missing:
        raise AssertionError(f"{label}: faults that never fired: {missing}")
    if not (rep.preempted > 0 and rep.torn_rows_repaired >= 1
            and rep.nonfinite_samples >= 1 and rep.dispatch_retries >= 2):
        raise AssertionError(f"{label}: counters {rep.preempted}, "
                             f"{rep.torn_rows_repaired}, "
                             f"{rep.nonfinite_samples}, "
                             f"{rep.dispatch_retries}")
    statuses = sorted(r.status for r in rep.results)
    if rep.failed != 1 or statuses.count("failed") != 1 or set(
            statuses) != {"ok", "failed"}:
        raise AssertionError(f"{label}: want exactly one failed request, "
                             f"the rest ok: {statuses}")
    if rep.leaked_blocks or rep.peak_blocks_used > rep.num_blocks - 1:
        raise AssertionError(f"{label}: leaked {rep.leaked_blocks} blocks, "
                             f"peak {rep.peak_blocks_used}")
    same_as_control(label, rep, control)
    # every preempted request: the non-finite victim, the torn row's
    # tenant and the evicted ones among them
    resumed = [r.rid for r in rep.results
               if r.status == "ok" and r.preemptions]
    print(f"{label}: preempted requests (rid: preemptions) "
          f"{ {r.rid: r.preemptions for r in rep.results if r.preemptions} }")
    if len(resumed) < 2:
        raise AssertionError(f"{label}: fewer than two resumed requests")
    compare_with_reference(label, cfg, params, eng,
                           [r for r in reqs if r.rid in resumed],
                           rep.outputs())
    del eng
    torch_cuda_empty()

    # 2) contiguous: slot pressure under a batch quota
    label = "overload contiguous"
    policy = bt.AdmissionPolicy(
        lambda b: 0.0, max_batch=NUM_SLOTS, max_wait_s=0.0,
        class_quotas={"batch": OVERLOAD_BATCH_QUOTA})
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                   max_seq=PROMPT_LEN + MAX_NEW, prefill_chunk=PREFILL_CHUNK,
                   policy=policy)
    bound = warm(label, eng, overload_trace(cfg, OVERLOAD_RATE_PER_S)[:2])
    path = ("qmatmul_w8a16", "decode_attention_int8",
            "decode_attention_int8_paged")
    reqs = overload_trace(cfg, OVERLOAD_CONTIG_RATE_PER_S)
    print(f"{label}: {N_REQUESTS} requests at {OVERLOAD_CONTIG_RATE_PER_S}/s"
          f", batch quota {OVERLOAD_BATCH_QUOTA}")
    control = overload_serve(f"{label} control", eng, reqs, bound, path)
    check_served(f"{label} control", cfg, control, reqs)
    rep = overload_serve(label, eng, reqs, bound, path, preemption=True)
    if rep.preempted <= 0:
        raise AssertionError(f"{label}: slot pressure evicted nothing")
    for name, r in (("control", control), ("overload", rep)):
        most = max(r.class_occupancy.get("batch", [0]))
        if most > OVERLOAD_BATCH_QUOTA:
            raise AssertionError(f"{label} {name}: the batch class held "
                                 f"{most} slots in a tick")
    check_served(label, cfg, rep, reqs)
    same_as_control(label, rep, control)
    del eng
    torch_cuda_empty()


def serve_phase():
    """The serve launcher at full width, --quant w8a16 then w8a8 (bf16 KV
    cache), counters zeroed just before each run and read just after.
    qmatmul_w8a16's launches by path are also read around the service
    curve alone: under w8a16 every one of them is on the mma path, and
    the rest of the run (the decode loop and the engine) takes none."""
    from repro_torch.launch import serve

    real_curve = serve.measure_service_curve
    curve_paths = {}
    counts = {}
    serve.measure_service_curve = counted_curve(real_curve, curve_paths)
    try:
        for quant in ("w8a16", "w8a8"):
            counts[quant], res = serve_run(quant, curve_paths)
            if quant == "w8a16":
                w8a16 = res           # compared after both runs
            del res
        torch_cuda_empty()
        serve_run("w8a16", curve_paths, SERVE_OVERLOAD_FLAGS)
        torch_cuda_empty()
        sampled_cli_run(curve_paths)
        counts["spec"] = spec_cli_run(curve_paths, w8a16.report.outputs())
    finally:
        serve.measure_service_curve = real_curve
    compare_with_reference("serve w8a16", w8a16.cfg, w8a16.params,
                           w8a16.engine, w8a16.requests[:N_COMPARE],
                           w8a16.report.outputs())
    del w8a16
    torch_cuda_empty()
    return counts


def counted_curve(real_curve, curve_paths):
    """``real_curve`` (``serve.measure_service_curve``), writing into
    ``curve_paths`` qmatmul_w8a16's launches by path during each call."""
    def curve(*args, **kwargs):
        from repro_torch.kernels import qmatmul as K
        before = dict(K.qmatmul_w8a16.launches_by_path)
        try:
            return real_curve(*args, **kwargs)
        finally:
            for path, n in K.qmatmul_w8a16.launches_by_path.items():
                curve_paths[path] = n - before[path]
    curve.__wrapped__ = real_curve
    return curve


def serve_run(quant, curve_paths, flags=(), base=SERVE_ARGS, label=None):
    """One serve launcher run of ``base`` arguments, counters zeroed just
    before and read just after, and checked: (its kernel launches, its
    ServeRun).  With the overload ``flags`` the run must print its
    retirement and faults lines, and every request retire once (a fault
    may fail one)."""
    import contextlib
    import io

    from repro_torch.launch import serve

    label = label or f"serve {quant}" + (" overload" if flags else "")
    argv = list(base) + ["--quant", quant] + list(flags)
    print(f"{label}: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    zero_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = serve.run(serve.parse_args(argv))
    launches, plain_calls = read_counts()
    print(out.getvalue(), end="")
    print(f"{label}: run {time.perf_counter() - t0:.1f}s, exit code "
          f"{res.code}, curve {res.curve}, chosen batch {res.batch}, "
          f"decode tok/s {res.decode_tokens_per_s}")
    print(f"{label}: kernel launches {launches}, plain-version calls "
          f"{plain_calls}; qmatmul_w8a16 by path in the service curve "
          f"{curve_paths}")
    if res.code != 0 or res.batch < 1:
        raise AssertionError(f"{label}: exit code {res.code}, chosen "
                             f"batch {res.batch}")
    rep = res.report
    print(f"{label}: engine {rep.num_slots} slots, {len(rep.results)} "
          f"requests in {rep.ticks} ticks, wall {rep.wall_s:.3f}s, "
          f"p99 latency {rep.p99_latency_s:.3f}s, mean ttft "
          f"{rep.mean_ttft_s:.3f}s, p99 ttft {rep.p99_ttft_s:.3f}s, "
          f"decoded tok/s {rep.tokens_per_s:.1f}, mean occupancy "
          f"{rep.mean_occupancy:.3f}, watchdog stuck ticks "
          f"{rep.stuck_ticks}")
    print(f"{label}: engine ms/tick {1e3 * rep.wall_s / rep.ticks:.1f}; "
          f"before the captured chunk: {BEFORE_CHUNK.get(label, 'not run')}")
    need = ["flash_attention_bhsd"] + (["qmatmul_w8a8"]
                                       if quant == "w8a8" else [])
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"{label}: a kernel of the path never "
                             f"launched: {launches}")
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: the CUDA path reached a plain "
                             f"version: {plain_calls}")
    outside = launches["qmatmul_w8a16[mma]"] - curve_paths["mma"]
    if outside:
        raise AssertionError(f"{label}: the decode loop or the engine took "
                             f"qmatmul_w8a16's mma path {outside} times")
    if quant == "w8a16" and (
            curve_paths["gemv"] != router_gemvs(res.cfg, curve_paths["mma"])
            or curve_paths["mma"] <= 0):
        raise AssertionError(f"{label}: the service curve's forward must "
                             f"launch only the mma path (an MoE router the "
                             f"GEMV): {curve_paths}")
    if quant == "w8a8" and curve_paths["mma"]:
        raise AssertionError(f"{label}: the W8A8 forward took qmatmul_w8a16's "
                             f"mma path: {curve_paths}")
    if "--fault-seed" in flags:
        lines = [ln for ln in out.getvalue().splitlines()
                 if ln.startswith(("[engine] retirement:",
                                   "[engine] faults:"))]
        if len(lines) != 2:
            raise AssertionError(f"{label}: want its retirement and faults "
                                 f"lines, got {lines}")
        if sorted(r.rid for r in rep.results) != sorted(
                r.rid for r in res.requests):
            raise AssertionError(f"{label}: not every request retired once")
        print(f"{label}: fault plan {res.fault_plan.faults}, fired "
              f"{res.fault_plan.fired}; classes "
              f"{ {c: max(v) for c, v in rep.class_occupancy.items()} } "
              f"most slots held; preempted {rep.preempted}, tokens "
              f"re-prefilled by resumes {rep.resumed_prefill_tokens}; "
              f"class p99 latency {rep.class_p99_latency_s}")
    elif rep.failed or rep.dropped or rep.unfinished or len(
            rep.results) != len(res.requests) or any(
            r.status != "ok" for r in rep.results):
        raise AssertionError(f"{label}: a request failed: failed "
                             f"{rep.failed}, dropped {rep.dropped}, "
                             f"unfinished {rep.unfinished}")
    launches["curve_mma"] = curve_paths["mma"]
    if not flags:
        forward_breakdown(label, res)
        curve_check(label, res, serve.parse_args(argv))
    return launches, res


def gemvs_per_layer(cfg) -> int:
    """qmatmul_w8a16's GEMV launches of one decode step per layer (every
    projection int8): the attention's four, the (shared) MLP's two or
    three, and an MoE layer's router."""
    return 4 + (3 if cfg.gated_mlp else 2) + (cfg.family == "moe")


def router_gemvs(cfg, mma: int) -> int:
    """The GEMV launches of the W8A16 forwards that made ``mma`` mma-path
    launches: an MoE layer's router runs on the GEMV (f32 x), one a layer;
    a dense forward launches none."""
    if cfg.family != "moe":
        return 0
    per_forward = (gemvs_per_layer(cfg) - 1) * cfg.n_layers + 1
    return mma // per_forward * cfg.n_layers


def torch_cuda_empty() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def device_breakdown(label: str, what: str, fn, reps: int,
                     detail: bool = True):
    """Where one call of ``fn`` spends its time: host wall clock per call
    (each ending in a wait for the card) over ``reps`` calls, then the
    device's busy time, its largest kernels and the host's largest ops
    (``detail``) from torch.profiler over ``reps`` more.  Returns, per call, ``wall``
    ms, ``busy`` ms (None where the profiler reported no device time),
    ``launch_calls`` (cudaLaunchKernel), ``graph_launches``
    (cudaGraphLaunch) and ``by_kernel`` ({kernel: device ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def call():
        fn()
        torch.cuda.synchronize()

    with torch.inference_mode():
        call()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        warnings.filterwarnings("ignore", message=".*Profiler clears")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                call()
    # device-side events (kernels, copies) only: host ops carry the device
    # time of what they launched too
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    launch_calls, graph_launches = (
        sum(e.count for e in prof.key_averages() if e.key == key) / reps
        for key in ("cudaLaunchKernel", "cudaGraphLaunch"))
    out = {"wall": wall_ms, "busy": None, "launch_calls": launch_calls,
           "graph_launches": graph_launches, "by_kernel": {}}
    if dev_us <= 0:
        print(f"{label}: {what} wall {wall_ms:.2f} ms, device busy not "
              f"measured (the profiler reported no device time)")
        return out
    busy_ms = dev_us / 1e3 / reps
    print(f"{label}: {what} wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    out["busy"] = busy_ms
    out["by_kernel"] = {e.key: e.self_device_time_total / 1e3 / reps
                        for e in events}
    if not detail:
        return out
    for us, key in sorted(((e.self_device_time_total, e.key)
                           for e in events), reverse=True)[:6]:
        print(f"  device time per call {us / 1e3 / reps:.3f} ms: "
              f"{key[:90]}")
    host = [e for e in prof.key_averages()
            if not str(e.device_type).endswith("CUDA")]
    for us, n, key in sorted(((e.self_cpu_time_total, e.count, e.key)
                              for e in host), reverse=True)[:8]:
        print(f"  host time per call {us / 1e3 / reps:.3f} ms in "
              f"{n // reps} calls: {key[:60]}")
    return out


# label -> device_breakdown of the eager steady tick, for the graph phase
EAGER_TICKS = {}


def tick_breakdown(cfg, params, num_slots: int, max_seq: int,
                   block_size: int = 0, ticks: int = 5,
                   label: str = "tick", mode: str = "w8a16") -> None:
    """Where one steady-state slot tick's time goes: all slots active at a
    mid-sequence position, through the eager step.  ``block_size``: the same tick on a paged
    cache, every slot's row on blocks of its own (a pool of
    ``num_slots * max_seq / block_size + 1`` blocks).  ``mode``: the
    projections' quantization, "w8a16" (181 qmatmul_w8a16 GEMV launches a
    tick) or "w8a8" (180 qmatmul_w8a8 launches and the LM head's GEMV)."""
    import torch
    from repro_torch.core.qlinear import W8A8, W8A16
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    S = num_slots
    step = ST.make_slot_decode_step(cfg, mode={"w8a16": W8A16,
                                               "w8a8": W8A8}[mode])
    with torch.inference_mode():
        if block_size:
            mb = max_seq // block_size
            cache = R.init_paged_cache(cfg, S, max_seq, block_size,
                                       S * mb + 1, device="cuda")
            cache["block_tables"].copy_(torch.arange(
                1, S * mb + 1, dtype=torch.int32).reshape(S, mb))
        else:
            cache = R.init_cache(cfg, S, max_seq, device="cuda")
        toks = torch.ones((S, 1), dtype=torch.int32, device="cuda")
        idx = torch.full((S,), max_seq // 2, dtype=torch.int32,
                         device="cuda")
        active = torch.ones((S,), dtype=torch.bool, device="cuda")
    zero_counts()
    with torch.inference_mode():
        step(params, toks, cache, idx, active)[0].cpu()
    launches, _ = read_counts()
    w8a8 = 6 * cfg.n_layers if mode == "w8a8" else 0
    gemv = 6 * cfg.n_layers + 1 - w8a8
    print(f"{label}: qmatmul_w8a16 launches per tick "
          f"{launches['qmatmul_w8a16']} (gemv "
          f"{launches['qmatmul_w8a16[gemv]']}, mma "
          f"{launches['qmatmul_w8a16[mma]']}; {gemv} expected), "
          f"qmatmul_w8a8 {launches['qmatmul_w8a8']} ({w8a8} expected)")
    if (launches["qmatmul_w8a16[gemv]"] != gemv
            or launches["qmatmul_w8a16[mma]"]
            or launches["qmatmul_w8a8"] != w8a8):
        raise AssertionError(f"{label}: {launches}")
    res = EAGER_TICKS[label] = device_breakdown(
        label, f"steady-state slot tick ({S} active rows at position "
        f"{max_seq // 2} of {max_seq})",
        lambda: step(params, toks, cache, idx, active)[0].cpu(), ticks)
    calls, busy, by_kernel = (res["launch_calls"], res["busy"],
                              res["by_kernel"])
    limit = BEFORE_TICK_LAUNCH_CALLS["w8a8 tick" if mode == "w8a8" else
                                     "paged tick" if block_size else "tick"]
    print(f"{label}: cudaLaunchKernel calls per tick {calls:.0f} (before "
          f"the redesigns: {limit})")
    if calls > limit:
        raise AssertionError(f"{label}: {calls} cudaLaunchKernel calls per "
                             f"tick, more than before the redesigns: "
                             f"{limit}")
    if busy is not None and mode == "w8a8":
        mm = sum(ms for key, ms in by_kernel.items() if "qmatmul_w8a8" in key)
        print(f"{label}: qmatmul_w8a8 {mm:.3f} ms of the tick's {busy:.3f} "
              f"ms of device time ({100 * mm / busy:.1f}%)")
    elif busy is not None:
        attn = sum(ms for key, ms in by_kernel.items()
                   if "decode_attention_int8" in key)
        print(f"{label}: decode attention {attn:.3f} ms of the tick's "
              f"{busy:.3f} ms of device time ({100 * attn / busy:.1f}%)"
              + (f"; before the split redesign: {BEFORE_LONG_TICK[label]}"
                 if label in BEFORE_LONG_TICK else ""))
    del cache
    torch_cuda_empty()


def w8a8_tick_phase(cfg, params) -> None:
    """The steady tick under W8A8 at the W8A8 serve engine's 16 slots (all
    at position 24 of the smoke's 48): the tick that qmatmul_w8a8's GEMV
    runs."""
    tick_breakdown(cfg, params, SERVE_MAX_BATCH, PROMPT_LEN + MAX_NEW,
                   label="w8a8 tick", mode="w8a8")


def long_tick_phase(cfg, params) -> None:
    """The steady tick at a context users run: max_seq LONG_SLOTS, all
    NUM_SLOTS rows at LONG_SLOTS / 2, contiguous and paged (blocks of
    PAGED_BLOCK).  The cache is zeroed, which does not change the
    kernels' times."""
    tick_breakdown(cfg, params, NUM_SLOTS, LONG_SLOTS, label="long tick")
    tick_breakdown(cfg, params, NUM_SLOTS, LONG_SLOTS, PAGED_BLOCK,
                   label="long paged tick")


# the graph phase: each tick tick_breakdown drives, eager against captured
# on two copies of one randomly filled cache, (label, slots, max_seq,
# block size, mode); then the serve CLI's decode loop at its shape
GRAPH_TICKS = 4
GRAPH_CASES = (
    ("tick", NUM_SLOTS, PROMPT_LEN + MAX_NEW, 0, "w8a16"),
    ("paged tick", NUM_SLOTS, PAGED_PROMPT_LEN + MAX_NEW, PAGED_BLOCK,
     "w8a16"),
    ("long tick", NUM_SLOTS, LONG_SLOTS, 0, "w8a16"),
    ("long paged tick", NUM_SLOTS, LONG_SLOTS, PAGED_BLOCK, "w8a16"),
    ("w8a8 tick", SERVE_MAX_BATCH, PROMPT_LEN + MAX_NEW, 0, "w8a8"))
LOOP_STARTS = (0, 5)
LOOP_TOKENS = 16           # the serve CLI's --decode-tokens
TIMED_LOOPS = 3


def _graph_tick_inputs(S: int, max_seq: int, mb: int, vocab: int):
    """The inputs of GRAPH_TICKS ticks over S rows, on the CPU: (tokens,
    index, active, tables or None) per tick.  Rows sit at ragged positions
    below max_seq / 2 and advance while active; row 1 retires at tick 1
    (position 0; paged: its table row pointed at the trash block) and is
    admitted again at tick 2 at position 0 (paged: on blocks no other row
    holds); the last row retires at tick 3; the tokens are random.  Paged:
    tables into a pool of S * mb + mb + 1 blocks, shuffled."""
    import torch
    g = torch.Generator().manual_seed(SEED)
    index = (max_seq // 2 - 3 * torch.arange(S, dtype=torch.int32)) \
        .clamp_min(0)
    active = torch.ones(S, dtype=torch.bool)
    perm = torch.randperm(S * mb + mb, generator=g).to(torch.int32) + 1
    tables = perm[:S * mb].reshape(S, mb).clone() if mb else None
    out = []
    for t in range(GRAPH_TICKS):
        if t == 1:
            active[1], index[1] = False, 0
            if mb:
                tables[1] = 0
        if t == 2:
            active[1] = True
            if mb:
                tables[1] = perm[S * mb:]
        if t == 3:
            active[-1] = False
        out.append((torch.randint(1, vocab, (S, 1), generator=g,
                                  dtype=torch.int32),
                    index.clone(), active.clone(),
                    None if tables is None else tables.clone()))
        index = index + active.to(torch.int32)
    return out


def _random_cache(cfg, S: int, max_seq: int, block_size: int) -> dict:
    """A cache (paged: a pool of S * mb + mb + 1 blocks, int8) filled
    with random values (and scales), so that every tick attends to a
    history."""
    import torch
    from repro_torch.models import registry as R
    g = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        if block_size:
            mb = max_seq // block_size
            cache = R.init_paged_cache(cfg, S, max_seq, block_size,
                                       S * mb + mb + 1, device="cuda")
        else:
            cache = R.init_cache(cfg, S, max_seq, device="cuda")
        for name, t in cache.items():
            if t.dtype == torch.int8:
                t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                      device="cuda", dtype=torch.int8))
            elif t.dtype == torch.float32:
                t.copy_(torch.rand(t.shape, generator=g, device="cuda")
                        * 0.04 + 0.005)
            elif t.dtype == torch.bfloat16:
                t.copy_(torch.randn(t.shape, generator=g, device="cuda")
                        * 0.5)
    return cache


def graph_tick_case(cfg, params, label, S, max_seq, block_size, mode):
    """One tick eager against captured: GRAPH_TICKS ticks of
    :func:`_graph_tick_inputs` on two copies of one random cache, next
    tokens, indices and every cache leaf ``torch.equal`` after each, the
    launch counts of each replay equal to the eager tick's (the first
    call: twice, its warm-up's and its replay's); then the captured
    steady tick's breakdown beside the eager one's of this run
    (``EAGER_TICKS``), whose wall it must beat.  Returns the case's
    (captured step, eager step, eager cache, captured cache)."""
    import torch
    from repro_torch.core.qlinear import W8A8, W8A16
    from repro_torch.runtime import steps as ST

    qm = {"w8a16": W8A16, "w8a8": W8A8}[mode]
    mb = max_seq // block_size if block_size else 0
    cache = _random_cache(cfg, S, max_seq, block_size)
    other = {k: v.clone() for k, v in cache.items()}
    eager = ST.make_slot_decode_step(cfg, mode=qm)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(cfg, mode=qm))
    w8a8 = 6 * cfg.n_layers if mode == "w8a8" else 0
    attn = ("decode_attention_int8_paged" if block_size
            else "decode_attention_int8")
    want = {"qmatmul_w8a16[gemv]": 6 * cfg.n_layers + 1 - w8a8,
            "qmatmul_w8a16[mma]": 0, "qmatmul_w8a8": w8a8,
            attn: cfg.n_layers}
    capture_s = 0.0
    for t, (toks, idx, active, tables) in enumerate(
            _graph_tick_inputs(S, max_seq, mb, cfg.vocab)):
        with torch.inference_mode():
            if tables is not None:
                for c in (cache, other):
                    c["block_tables"].copy_(tables)
            args = [x.cuda() for x in (toks, idx, active)]
            zero_counts()
            n_e, _, i_e = eager(params, args[0], cache, *args[1:])
            per_eager, _ = read_counts()
            zero_counts()
            t0 = time.perf_counter()
            n_g, _, i_g = graphed(params, args[0], other, *args[1:])
            torch.cuda.synchronize()
            capture_s = capture_s or time.perf_counter() - t0
            per_graph, plain = read_counts()
        if not (torch.equal(n_g, n_e) and torch.equal(i_g, i_e)):
            raise AssertionError(f"{label}: tick {t}: the captured tick's "
                                 f"next tokens or indices differ")
        if not torch.equal(i_e.cpu(), idx + active.to(torch.int32)):
            raise AssertionError(f"{label}: tick {t}: wrong indices")
        for name in cache:
            if not torch.equal(other[name], cache[name]):
                raise AssertionError(f"{label}: tick {t}: cache leaf "
                                     f"{name} differs")
        if any(plain.values()):
            raise AssertionError(f"{label}: a plain version ran: {plain}")
        if any(per_eager[k] != n for k, n in want.items()):
            raise AssertionError(f"{label}: eager tick launches "
                                 f"{per_eager}, expected {want}")
        if per_graph != {k: n * (2 if t == 0 else 1)
                         for k, n in per_eager.items()}:
            raise AssertionError(f"{label}: tick {t}: captured launches "
                                 f"{per_graph} against eager {per_eager}")
    reserved, allocated = graphed.binding(params, args[0], other,
                                          *args[1:]).pool_bytes
    print(f"{label} graph: {GRAPH_TICKS} ticks (a row retiring, a row "
          f"admitted{', a table row changed' if block_size else ''}) "
          f"bitwise equal to the eager tick: next tokens, indices and "
          f"{len(cache)} cache leaves; launches per replay "
          f"{ {k: per_graph[k] for k in want} } = the eager tick's; "
          f"capture {capture_s:.2f} s with its warm-up, private pool "
          f"{reserved} bytes reserved, {allocated} allocated")
    with torch.inference_mode():
        toks = torch.ones((S, 1), dtype=torch.int32, device="cuda")
        idx = torch.full((S,), max_seq // 2, dtype=torch.int32,
                         device="cuda")
        active = torch.ones((S,), dtype=torch.bool, device="cuda")
    res = device_breakdown(
        f"{label} graph", f"captured steady-state slot tick ({S} active "
        f"rows at position {max_seq // 2} of {max_seq})",
        lambda: graphed(params, toks, other, idx, active)[0].cpu(), 10)
    with torch.inference_mode():
        # the breakdown's replays all wrote the same k/v at max_seq // 2
        # into the captured copy: one eager tick writes them into the other
        eager(params, toks, cache, idx, active)
    if any(not torch.equal(other[k], cache[k]) for k in cache):
        raise AssertionError(f"{label}: the breakdown's replays left the "
                             f"cache unlike one eager tick's")
    eag = EAGER_TICKS[label]

    def ms(x):
        return "not measured" if x is None else f"{x:.3f} ms"

    print(f"{label}: eager / captured per tick: wall {eag['wall']:.2f} / "
          f"{res['wall']:.2f} ms, device busy {ms(eag['busy'])} / "
          f"{ms(res['busy'])}, cudaLaunchKernel {eag['launch_calls']:.0f} "
          f"/ {res['launch_calls']:.0f}, cudaGraphLaunch "
          f"{eag['graph_launches']:.0f} / {res['graph_launches']:.0f}"
          + (f"; captured wall / busy {res['wall'] / res['busy']:.2f}"
             if res["busy"] else ""))
    if graphed.captured.captures != 1:
        raise AssertionError(f"{label}: captured "
                             f"{graphed.captured.captures} times")
    if res["wall"] >= eag["wall"]:
        raise AssertionError(f"{label}: the captured tick's wall "
                             f"{res['wall']:.2f} ms is not below the eager "
                             f"tick's {eag['wall']:.2f} ms")
    return graphed, eager, cache, other


def graph_loop_case(cfg, params, quant: str) -> None:
    """The serve CLI's decode loop (bf16 cache, batch SERVE_MAX_BATCH,
    LOOP_TOKENS tokens, max_seq SERVE_SEQ) eager against captured: tokens
    and cache ``torch.equal`` at every start of LOOP_STARTS on one graph,
    a replay's launch counts equal to the eager loop's; then tok/s of
    both, host clock over TIMED_LOOPS loops each ending in a wait."""
    import torch
    from repro_torch.core.qlinear import W8A8, W8A16
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    qm = {"w8a16": W8A16, "w8a8": W8A8}[quant]
    bcfg = dataclasses.replace(cfg, kv_quant=False)
    b = SERVE_MAX_BATCH
    eager = ST.make_decode_loop(bcfg, mode=qm, num_tokens=LOOP_TOKENS)
    graphed = ST.jit_decode_loop(ST.make_decode_loop(
        bcfg, mode=qm, num_tokens=LOOP_TOKENS))
    g = torch.Generator(device="cuda").manual_seed(SEED)
    label = f"decode loop {quant}"
    with torch.inference_mode():
        toks = torch.randint(1, cfg.vocab, (b, 1), generator=g,
                             device="cuda", dtype=torch.int32)
        cache = R.init_cache(bcfg, b, SERVE_SEQ, device="cuda")
        other = R.init_cache(bcfg, b, SERVE_SEQ, device="cuda")
        for start in LOOP_STARTS:
            zero_counts()
            want, _ = eager(params, toks, cache, start)
            per_eager, _ = read_counts()
            zero_counts()
            got, _ = graphed(params, toks, other, start)
            per_graph, _ = read_counts()
            if not torch.equal(got, want) or any(
                    not torch.equal(other[k], cache[k]) for k in cache):
                raise AssertionError(f"{label}: start {start}: the captured "
                                     f"loop's tokens or cache differ")
            if start and per_graph != per_eager:
                raise AssertionError(f"{label}: replay launches "
                                     f"{per_graph}, eager {per_eager}")

        def tps(fn, c):
            fn(params, toks, c, 0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIMED_LOOPS):
                fn(params, toks, c, 0)
            torch.cuda.synchronize()
            return b * LOOP_TOKENS * TIMED_LOOPS / (time.perf_counter() - t0)

        eager_tps = tps(eager, cache)
        graph_tps = tps(graphed, other)
    if graphed.captured.captures != 1:
        raise AssertionError(f"{label}: captured "
                             f"{graphed.captured.captures} times")
    reserved, allocated = graphed.binding(params, toks, other,
                                          0).pool_bytes
    print(f"{label}: batch {b}, {LOOP_TOKENS} tokens, max_seq {SERVE_SEQ}: "
          f"captured loop bitwise equal to the eager loop (tokens and "
          f"cache) at starts {LOOP_STARTS} on one graph; launches per "
          f"replay {per_graph['qmatmul_w8a16']} qmatmul_w8a16, "
          f"{per_graph['qmatmul_w8a8']} qmatmul_w8a8 = the eager loop's; "
          f"tok/s eager {eager_tps:.1f}, captured {graph_tps:.1f}; private "
          f"pool {reserved} bytes reserved, {allocated} allocated")


# the chunk step: each cache the engines prefill, the per-token step
# eager against the one pass eager and captured on three copies of one
# randomly filled cache, (label, slots, max_seq, block size, mode,
# kv_quant, slot, start): the slice's contiguous rows, the paged slice's
# blocks (positions 14..17 cross a block edge), a 4,096-slot row and the
# serve CLI's bf16 rows, the last also under W8A8 (its per-token loop)
CHUNK_CASES = (
    ("chunk", NUM_SLOTS, PROMPT_LEN + MAX_NEW, 0, "w8a16", True, 3, 13),
    ("paged chunk", NUM_SLOTS, PAGED_PROMPT_LEN + MAX_NEW, PAGED_BLOCK,
     "w8a16", True, 3, 14),
    ("long chunk", NUM_SLOTS, LONG_SLOTS, 0, "w8a16", True, 3, 2046),
    ("bf16 chunk", SERVE_MAX_BATCH, SERVE_SEQ, 0, "w8a16", False, 5, 9),
    ("w8a8 chunk", SERVE_MAX_BATCH, SERVE_SEQ, 0, "w8a8", False, 5, 9))
# reps of each chunk breakdown: at 5, torch.profiler's bookkeeping of the
# per-token eager chunk's 6,000-13,500 launches a call took 197 of the
# graph phase's 300 s (PERF.md, Findings)
CHUNK_REPS = 2


def graph_chunk_case(cfg, params, label, S, max_seq, block_size, mode,
                     kv_quant, sid, start) -> dict:
    """The chunk step of slot ``sid`` from ``start`` for every n_valid up
    to PREFILL_CHUNK: the eager per-token step
    (``make_per_token_chunk_step``), the
    eager step (under W8A16 one pass) and the captured step (one graph
    per n_valid), each on its copy of one random cache, every cache leaf
    ``torch.equal`` to the per-token step's; a replay's launch counts the
    eager one pass's (under W8A16: ``gemvs_per_layer`` x layers GEMVs,
    an MoE layer's three expert stacks and one paged attention launch a
    layer, where the per-token step launches n times that); then a full
    chunk's wall, device busy and launch calls three ways.  Returns the
    breakdowns by way."""
    import torch
    from repro_torch.core.qlinear import W8A8, W8A16
    from repro_torch.runtime import steps as ST

    qm = {"w8a16": W8A16, "w8a8": W8A8}[mode]
    one_pass = mode == "w8a16"
    ccfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    cache = _random_cache(ccfg, S, max_seq, block_size)
    if block_size:
        mb = max_seq // block_size
        g = torch.Generator().manual_seed(SEED)
        with torch.inference_mode():
            cache["block_tables"].copy_(
                (torch.randperm(S * mb, generator=g).to(torch.int32) + 1)
                .reshape(S, mb))
    copies = [{k: v.clone() for k, v in cache.items()} for _ in range(3)]
    want, one, got = copies
    per_token = ST.make_per_token_chunk_step(ccfg, mode=qm,
                                             chunk=PREFILL_CHUNK)
    eager = ST.make_prefill_chunk_step(ccfg, mode=qm, chunk=PREFILL_CHUNK)
    graphed = ST.jit_prefill_chunk_step(ST.make_prefill_chunk_step(
        ccfg, mode=qm, chunk=PREFILL_CHUNK))
    g = torch.Generator().manual_seed(SEED + 1)
    toks = torch.randint(1, cfg.vocab, (PREFILL_CHUNK,), generator=g,
                         dtype=torch.int32).numpy()
    passes_of = {}
    capture_s = []
    for n in range(1, PREFILL_CHUNK + 1):
        with torch.inference_mode():
            for c in copies:
                for k, t in c.items():
                    t.copy_(cache[k])
            zero_counts()
            per_token(params, toks, want, sid, start, n)
            per_tok, _ = read_counts()
            zero_counts()
            eager(params, toks, one, sid, start, n)
            per_eager, _ = read_counts()
            t0 = time.perf_counter()
            graphed(params, toks, got, sid, start, n)        # the capture
            torch.cuda.synchronize()
            capture_s.append(time.perf_counter() - t0)
            for k, t in got.items():
                t.copy_(cache[k])
            zero_counts()
            graphed(params, toks, got, sid, start, n)
            per_graph, plain = read_counts()
        for name in cache:
            for way, c in (("eager", one), ("captured", got)):
                if not torch.equal(c[name], want[name]):
                    raise AssertionError(f"{label}: n_valid {n}: the {way} "
                                         f"chunk's cache leaf {name} differs "
                                         f"from the per-token step's")
        if any(plain.values()):
            raise AssertionError(f"{label}: a plain version ran: {plain}")
        projections = gemvs_per_layer(cfg) * cfg.n_layers
        key = "qmatmul_w8a16[gemv]" if one_pass else "qmatmul_w8a8"
        passes = 1 if one_pass else n
        stacks = 3 * cfg.n_layers if cfg.family == "moe" else 0
        if (per_graph != per_eager and one_pass) \
                or per_graph[key] != passes * projections \
                or per_tok[key] != n * projections \
                or per_graph["qmatmul_w8a16_experts"] != passes * stacks \
                or per_graph["qmatmul_w8a16[mma]"] \
                or (kv_quant and per_graph["decode_attention_int8_paged"]
                    != passes * cfg.n_layers):
            raise AssertionError(f"{label}: n_valid {n}: launches per "
                                 f"replay {per_graph}, eager {per_eager}, "
                                 f"per-token {per_tok}")
        passes_of[n] = (per_tok[key], per_graph[key])
    if graphed.captured.captures != PREFILL_CHUNK:
        raise AssertionError(f"{label}: {graphed.captured.captures} "
                             f"captures for {PREFILL_CHUNK} chunk lengths")
    reserved, allocated = graphed.binding(params, got,
                                          PREFILL_CHUNK).pool_bytes
    print(f"{label}: slot {sid} of {S}, positions {start}.. of {max_seq}"
          f"{f', blocks of {block_size}' if block_size else ''}, "
          f"{'bf16' if not kv_quant else 'int8'} cache, {mode}: for every "
          f"n_valid 1..{PREFILL_CHUNK} the "
          f"{'one-pass eager and ' if one_pass else ''}captured chunk "
          f"bitwise equal to the per-token step ({len(cache)} cache "
          f"leaves); {key} launches per-token / per replay "
          f"{passes_of}; captures {graphed.captured.captures} "
          f"({', '.join(f'{t:.2f}' for t in capture_s)} s with their "
          f"warm-ups), the n_valid {PREFILL_CHUNK} graph's private pool "
          f"{reserved} bytes reserved, {allocated} allocated")
    ways = {"per-token eager": (per_token, want)}
    if one_pass:
        ways["one-pass eager"] = (eager, one)
    ways["captured"] = (graphed, got)
    res = {}
    for way, (fn, c) in ways.items():
        res[way] = device_breakdown(
            f"{label} {way}", f"chunk of {PREFILL_CHUNK} tokens",
            lambda fn=fn, c=c: fn(params, toks, c, sid, start,
                                  PREFILL_CHUNK), CHUNK_REPS)
    for name in cache:                 # the timed calls rewrote the same bytes
        if not (torch.equal(got[name], want[name])
                and (not one_pass or torch.equal(one[name], want[name]))):
            raise AssertionError(f"{label}: after timing, cache leaf {name} "
                                 f"differs")

    def ms(x):
        return "not measured" if x is None else f"{x:.3f} ms"

    print(f"{label}: per chunk of {PREFILL_CHUNK}, "
          + "; ".join(f"{way} wall {r['wall']:.2f} ms, busy "
                      f"{ms(r['busy'])}, cudaLaunchKernel "
                      f"{r['launch_calls']:.0f}, cudaGraphLaunch "
                      f"{r['graph_launches']:.0f}"
                      for way, r in res.items()))
    if res["captured"]["wall"] >= res["per-token eager"]["wall"]:
        raise AssertionError(f"{label}: the captured chunk is not faster "
                             f"than the eager per-token step")
    return res


def graph_phase(cfg, params) -> None:
    """The captured steps against the eager ones: every tick of
    GRAPH_CASES, the decode loop under w8a16 and w8a8, the chunk step on
    every cache of CHUNK_CASES, then the workspace
    a captured step holds: the 8-row tick, captured first, replays equal
    to the eager tick after the 16-row W8A8 tick and the 16-row loops
    grew the capture stream's workspace, and every arrival counter is
    back at 0."""
    import torch
    from repro_torch.kernels import scratch
    from repro_torch.runtime import graphs as G

    kept = None
    for case in GRAPH_CASES:
        out = graph_tick_case(cfg, params, *case)
        if kept is None:
            kept = out
        del out
        torch_cuda_empty()
    for quant in ("w8a16", "w8a8"):
        graph_loop_case(cfg, params, quant)
        torch_cuda_empty()
    for case in CHUNK_CASES:
        graph_chunk_case(cfg, params, *case)
        torch_cuda_empty()
    graphed, eager, cache, other = kept
    S, max_seq = GRAPH_CASES[0][1:3]
    with torch.inference_mode():
        toks, idx, active, _ = _graph_tick_inputs(S, max_seq, 0,
                                                  cfg.vocab)[0]
        toks = (toks + 1) % cfg.vocab
        args = [x.cuda() for x in (toks, idx + GRAPH_TICKS, active)]
        held = graphed.binding(params, args[0], other, *args[1:]).scratch
        side = G.capture_stream(cache["k"].device).cuda_stream
        now = scratch.held(cache["k"].device, side)
        n_e, _, i_e = eager(params, args[0], cache, *args[1:])
        n_g, _, i_g = graphed(params, args[0], other, *args[1:])
    torch.cuda.synchronize()
    if not (torch.equal(n_g, n_e) and torch.equal(i_g, i_e)) or any(
            not torch.equal(other[k], cache[k]) for k in cache):
        raise AssertionError("graph scratch: the first captured tick, "
                             "replayed after larger captures, differs from "
                             "the eager tick")
    if graphed.captured.captures != 1:
        raise AssertionError("graph scratch: the first tick was captured "
                             "again")
    grown = now[0].data_ptr() != held[0].data_ptr()
    pairs = [held, now] + list(scratch._SCRATCH.values())
    if any(pair[1].any() for pair in pairs):
        raise AssertionError("graph scratch: an arrival counter is not 0")
    print(f"graph scratch: the {S}-row tick, captured first, replayed equal "
          f"to the eager tick after the 16-row captures; the capture "
          f"stream's workspace {'grew' if grown else 'did not grow'} "
          f"({held[0].numel()} -> {now[0].numel()} f32), the tick holds "
          f"its own; every arrival counter of {len(pairs)} pairs at 0")
    if not grown:
        raise AssertionError("graph scratch: the 16-row captures did not "
                             "grow the workspace, so the check shows "
                             "nothing")


def curve_check(label: str, res, args) -> None:
    """The service curve's forward eager against captured
    (``runtime/steps.py::jit_prefill_step``, what the launcher measured
    with) at each batch of the run's curve: the captured logits
    ``torch.equal`` to the eager ones on random tokens, each form's wall
    and device busy per call (the same method as the tick breakdowns, 3
    calls each), then the curve and the Table 4 batch the launcher's own
    measurement gives through the eager step, beside the run's captured
    curve and choice."""
    import torch
    from repro_torch.core import batching as bt
    from repro_torch.launch import serve
    from repro_torch.runtime import steps as ST

    eager = ST.make_prefill_step(res.cfg, mode=res.mode)
    graphed = ST.jit_prefill_step(eager)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for b in sorted(res.curve):
        with torch.inference_mode():
            batch = {"tokens": torch.randint(
                0, res.cfg.vocab, (b, args.seq), generator=g,
                device="cuda", dtype=torch.int32)}
            want = eager(res.params, batch)
            got = graphed(res.params, batch)
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: the captured forward's "
                                     f"logits at batch {b} differ from the "
                                     f"eager forward's")
            del want
        what = f"forward of {b} x {args.seq} tokens"
        e = device_breakdown(f"{label} curve b={b} eager", what,
                             lambda: eager(res.params, batch), 3, False)
        c = device_breakdown(f"{label} curve b={b} captured", what,
                             lambda: graphed(res.params, batch), 3, False)
        busy = ("not measured" if e["busy"] is None or c["busy"] is None
                else f"{e['busy']:.3f} / {c['busy']:.3f} ms")
        print(f"{label} curve b={b}: captured logits bitwise the eager "
              f"forward's; eager / captured wall {e['wall']:.2f} / "
              f"{c['wall']:.2f} ms, device busy {busy}, cudaLaunchKernel "
              f"{e['launch_calls']:.0f} / {c['launch_calls']:.0f}")
    if graphed.captured.captures != len(res.curve):
        raise AssertionError(f"{label}: {graphed.captured.captures} "
                             f"captures for {len(res.curve)} batches")
    graphed.captured.release()
    measure = getattr(serve.measure_service_curve, "__wrapped__",
                      serve.measure_service_curve)
    model, curve = measure(eager, res.params, res.cfg, seq=args.seq,
                           max_batch=args.max_batch, device="cuda")
    batch = min(bt.choose_batch(model, args.deadline_ms * 1e-3,
                                args.max_batch), max(curve))
    print(f"{label}: service curve eager "
          + "  ".join(f"b={b}: {t * 1e3:.2f} ms" for b, t in
                      sorted(curve.items()))
          + f" (chosen batch {batch}); captured (the run's) "
          + "  ".join(f"b={b}: {t * 1e3:.2f} ms" for b, t in
                      sorted(res.curve.items()))
          + f" (chosen batch {res.batch})")
    torch_cuda_empty()


def forward_breakdown(label: str, res) -> None:
    """Where the service curve's largest prefill spends its time: one
    full-sequence forward of SERVE_MAX_BATCH x SERVE_SEQ tokens."""
    import torch
    from repro_torch.runtime import steps as ST

    prefill = ST.make_prefill_step(res.cfg, mode=res.mode)
    batch = {"tokens": torch.zeros((SERVE_MAX_BATCH, SERVE_SEQ),
                                   dtype=torch.int32, device="cuda")}
    device_breakdown(label, f"prefill of {SERVE_MAX_BATCH} x {SERVE_SEQ} "
                     f"tokens", lambda: prefill(res.params, batch), 3)


# ---------------------------------------------------------------------------
# sampling phase
# ---------------------------------------------------------------------------

SAMPLE_TEMP = 0.8
# the vocabularies the dense family samples over: starcoder2-3b,
# mistral-nemo-12b and qwen1.5-32b
SAMPLE_VOCABS = (49152, 131072, 152064)
SAMPLE_SEEDS = (0, 7)
SAMPLE_POSITIONS = 4096     # fold_in over positions 0 .. 4,095
# the positions whose keys' draws are held against the CPU at every
# vocabulary (all 4,096 keys at V = 152,064 are 623 M draws)
SAMPLE_ROWS = (0, 1, 2, 17, 1023, 2048, 4094, 4095)
GUMBEL_ULPS = 4             # the bound of tests/test_torch_sampling.py
SAMPLE_COMPARE = 8          # requests of a serve held to its reference


def sampler_step(temperature):
    """``temperature_sample_rows`` behind a ``CapturedStep`` (no params,
    no cache), so that it can be timed captured as it runs in a tick."""
    from repro_torch.runtime import steps as ST
    from repro_torch.runtime.graphs import CapturedStep
    return CapturedStep(lambda params, cache, logits, keys: (
        ST.temperature_sample_rows(logits, keys, temperature),))


def prng_phase():
    """The port's threefry PRNG on the card against its CPU results: for
    PRNGKey(0) and PRNGKey(7), fold_in over positions 0 .. 4,095 bitwise;
    at each vocabulary of SAMPLE_VOCABS, one key over (V,) and over (8,
    V) and the 8 keys of SAMPLE_ROWS over (V,) each: random_bits and
    uniform(tiny, 1) bitwise, gumbel within GUMBEL_ULPS ulps of max(|g|,
    1); then temperature_sample_rows on 8 rows of random f32 logits, each
    row bitwise launched alone and in the batch, with the sampler's
    device time eager and captured."""
    import numpy as np
    import torch
    from repro_torch.runtime import prng as P
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    tiny = float(torch.finfo(torch.float32).tiny)
    worst = 0.0
    exact = total = 0
    rows = torch.tensor(SAMPLE_ROWS)
    with torch.inference_mode():
        for seed in SAMPLE_SEEDS:
            kc, kg = P.PRNGKey(seed), P.PRNGKey(seed, device="cuda")
            pos = torch.arange(SAMPLE_POSITIONS, dtype=torch.int32)
            keys_c, keys_g = P.fold_in(kc, pos), P.fold_in(kg, pos.cuda())
            if not torch.equal(keys_g.cpu(), keys_c):
                raise AssertionError(f"prng: fold_in(PRNGKey({seed}), 0 .. "
                                     f"{SAMPLE_POSITIONS - 1}) differs on "
                                     f"the card")
            for vocab in SAMPLE_VOCABS:
                for c, d, shape in (
                        (kc, kg, (vocab,)), (kc, kg, (len(rows), vocab)),
                        (keys_c[rows], keys_g[rows.cuda()],
                         (len(rows), vocab))):
                    case = (f"PRNGKey({seed}) {tuple(c.shape)} keys over "
                            f"{shape}")
                    if not torch.equal(P.random_bits(d, shape).cpu(),
                                       P.random_bits(c, shape)):
                        raise AssertionError(f"prng: {case}: random_bits "
                                             f"differ on the card")
                    uc = P.uniform(c, shape, tiny, 1.0)
                    ug = P.uniform(d, shape, tiny, 1.0).cpu()
                    if not torch.equal(ug.view(torch.int32),
                                       uc.view(torch.int32)):
                        raise AssertionError(f"prng: {case}: uniform "
                                             f"differs on the card")
                    gc = P.gumbel(c, shape).double()
                    gg = P.gumbel(d, shape).cpu().double()
                    unit = torch.from_numpy(np.spacing(np.maximum(
                        gc.abs().float().numpy(), np.float32(1))))
                    ulps = float(((gg - gc).abs() / unit).max())
                    worst = max(worst, ulps)
                    exact += int((gg == gc).sum())
                    total += gg.numel()
                    if not torch.isfinite(gg).all() or ulps > GUMBEL_ULPS:
                        raise AssertionError(f"prng: {case}: gumbel "
                                             f"{ulps} ulps from the CPU's")
    print(f"prng: fold_in over {SAMPLE_POSITIONS} positions of PRNGKey"
          f"{SAMPLE_SEEDS}, random_bits and uniform(tiny, 1) at V = "
          f"{SAMPLE_VOCABS} (one key over (V,) and (8, V), 8 fold_in keys "
          f"over (V,)): bitwise the CPU's; gumbel within {worst:.1f} ulps "
          f"of max(|g|, 1) (bound {GUMBEL_ULPS}), {exact} of {total} draws "
          f"bitwise")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    key = P.PRNGKey(SEED + 1, device="cuda")
    keys = P.fold_in(key, rows.cuda())
    for vocab in SAMPLE_VOCABS:
        with torch.inference_mode():
            logits = torch.randn((len(rows), 1, vocab), generator=g,
                                 device="cuda") * 3
            batch = ST.temperature_sample_rows(logits, keys, SAMPLE_TEMP)
            alone = torch.cat([ST.temperature_sample_rows(
                logits[r:r + 1], keys[r:r + 1], SAMPLE_TEMP)
                for r in range(len(rows))])
            cpu = ST.temperature_sample_rows(logits.cpu(), keys.cpu(),
                                             SAMPLE_TEMP)
        if not torch.equal(batch, alone):
            raise AssertionError(f"sampler V={vocab}: rows differ alone "
                                 f"and in the batch")
        captured = sampler_step(SAMPLE_TEMP)
        with torch.inference_mode():
            if not torch.equal(captured({}, {}, logits, keys)[0], batch):
                raise AssertionError(f"sampler V={vocab}: the captured "
                                     f"sampler differs from the eager one")
        what = f"temperature_sample_rows over ({len(rows)}, {vocab})"
        e = device_breakdown(f"sampler V={vocab} eager", what,
                             lambda: ST.temperature_sample_rows(
                                 logits, keys, SAMPLE_TEMP), 10, False)
        c = device_breakdown(f"sampler V={vocab} captured", what,
                             lambda: captured({}, {}, logits, keys), 10,
                             False)
        print(f"sampler V={vocab}: {len(rows)} rows bitwise alone and in "
              f"the batch; {int((cpu == batch.cpu()).sum())} of "
              f"{len(rows)} equal to the CPU's draw; eager / captured wall "
              f"{e['wall']:.3f} / {c['wall']:.3f} ms, "
              f"cudaLaunchKernel {e['launch_calls']:.0f} / "
              f"{c['launch_calls']:.0f}")
        SAMPLER_MS[vocab] = c["busy"]
        captured.release()
    print(f"prng: phase {time.perf_counter() - t0:.1f}s")


# vocabulary -> the captured sampler's device ms over NUM_SLOTS rows
SAMPLER_MS = {}


def sampled_engine(cfg, params, **kw):
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16
    from repro_torch.runtime import prng as P
    return E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                    prefill_chunk=PREFILL_CHUNK, temperature=SAMPLE_TEMP,
                    rng=P.PRNGKey(SEED + 1, device="cuda"), **kw)


def compare_sampled(label, cfg, params, eng, reqs, outs) -> None:
    """The engine's tokens for ``reqs`` against the sequential batch-1
    ``reference_outputs`` under the engine's temperature and key, on the
    card: equal token for token (both run the same ops on the card, so a
    difference is a fault, not a near-tie)."""
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16

    t0 = time.perf_counter()
    margins = {}
    ref = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                              max_seq=eng.max_seq,
                              temperature=eng.temperature, rng=eng.rng,
                              margins=margins)
    bad = [rid for rid, toks in ref.items() if outs[rid] != toks]
    if bad:
        raise AssertionError(f"{label}: requests {bad} differ from the "
                             f"sampled reference_outputs")
    print(f"{label}: {len(ref)} requests {sorted(ref)} equal the sampled "
          f"reference_outputs (t = {eng.temperature}, fold_in(PRNGKey("
          f"{SEED + 1}), position)) token for token on the card; smallest "
          f"perturbed top-2 gap {min(min(v) for v in margins.values()):.3e}"
          f"; reference {time.perf_counter() - t0:.1f}s")


def sampled_tick_phase(cfg, params) -> None:
    """The captured steady tick greedy against sampled (NUM_SLOTS rows at
    max_seq / 2 of the slice's cache): one sampled tick captured against
    eager on two copies of a random cache (tokens, indices, every cache
    leaf equal), the launch counts of a replay the greedy tick's, then
    wall, device busy and launch calls of each, and the sampler's share
    of the sampled tick's device time (the captured sampler alone, timed
    by the prng phase)."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.runtime import prng as P
    from repro_torch.runtime import steps as ST

    S, max_seq = NUM_SLOTS, PROMPT_LEN + MAX_NEW
    key = P.PRNGKey(SEED + 1, device="cuda")
    eager = ST.make_slot_decode_step(cfg, mode=W8A16,
                                     temperature=SAMPLE_TEMP)
    ticks = {t: ST.jit_slot_decode_step(ST.make_slot_decode_step(
        cfg, mode=W8A16, temperature=t)) for t in (0.0, SAMPLE_TEMP)}
    cache = _random_cache(cfg, S, max_seq, 0)
    other = {k: v.clone() for k, v in cache.items()}
    toks, idx, active, _ = _graph_tick_inputs(S, max_seq, 0, cfg.vocab)[0]
    with torch.inference_mode():
        args = [x.cuda() for x in (toks, idx, active)]
        want, _, i_e = eager(params, args[0], cache, *args[1:], key)
        zero_counts()
        got, _, i_g = ticks[SAMPLE_TEMP](params, args[0], other, *args[1:],
                                         key)
        torch.cuda.synchronize()
        zero_counts()
        ticks[SAMPLE_TEMP](params, args[0], other, *args[1:], key)
        sampled_launches, _ = read_counts()
    if not (torch.equal(got, want) and torch.equal(i_g, i_e)) or any(
            not torch.equal(other[k], cache[k]) for k in cache):
        raise AssertionError("sampled tick: the captured tick differs from "
                             "the eager one")
    del cache, other
    cache = _random_cache(cfg, S, max_seq, 0)
    with torch.inference_mode():
        toks = torch.ones((S, 1), dtype=torch.int32, device="cuda")
        idx = torch.full((S,), max_seq // 2, dtype=torch.int32,
                         device="cuda")
        active = torch.ones((S,), dtype=torch.bool, device="cuda")
    res = {}
    for t, graphed in ticks.items():
        extra = (key,) if t else ()
        res[t] = device_breakdown(
            f"sampled tick t={t}", f"captured steady-state slot tick ({S} "
            f"rows at position {max_seq // 2} of {max_seq})",
            lambda: graphed(params, toks, cache, idx, active, *extra)[0]
            .cpu(), 10, False)
        graphed.captured.release()
    greedy, sampled = res[0.0], res[SAMPLE_TEMP]
    share = ("not measured" if not (sampled["busy"]
                                    and SAMPLER_MS.get(cfg.vocab))
             else f"{SAMPLER_MS[cfg.vocab]:.3f} ms, "
                  f"{100 * SAMPLER_MS[cfg.vocab] / sampled['busy']:.1f}%")
    busy = ("not measured" if greedy["busy"] is None
            or sampled["busy"] is None
            else f"{greedy['busy']:.3f} / {sampled['busy']:.3f} ms")
    print(f"sampled tick: a captured sampled tick bitwise the eager one "
          f"(tokens, indices, {len(cache)} cache leaves); launches per "
          f"replay {sampled_launches}; greedy / sampled per tick: wall "
          f"{greedy['wall']:.2f} / {sampled['wall']:.2f} ms, device busy "
          f"{busy}, cudaGraphLaunch {greedy['graph_launches']:.0f} / "
          f"{sampled['graph_launches']:.0f}, cudaLaunchKernel "
          f"{greedy['launch_calls']:.0f} / {sampled['launch_calls']:.0f}; "
          f"the sampler's share of the sampled tick's device time {share}")
    del cache
    torch_cuda_empty()


def sampled_loop_phase(cfg, params) -> None:
    """The decode loop sampled (NUM_SLOTS rows, LOOP_TOKENS tokens, the
    slice's int8 cache): captured bitwise the eager loop, then tok/s of
    the captured loop greedy and sampled, host clock over TIMED_LOOPS
    loops each ending in a wait."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.models import registry as R
    from repro_torch.runtime import prng as P
    from repro_torch.runtime import steps as ST

    b, max_seq = NUM_SLOTS, PROMPT_LEN + MAX_NEW
    key = P.PRNGKey(SEED + 1, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    tps = {}
    with torch.inference_mode():
        toks = torch.randint(1, cfg.vocab, (b, 1), generator=g,
                             device="cuda", dtype=torch.int32)
        for t in (0.0, SAMPLE_TEMP):
            extra = (key,) if t else ()
            loop = ST.make_decode_loop(cfg, mode=W8A16,
                                       num_tokens=LOOP_TOKENS, temperature=t)
            graphed = ST.jit_decode_loop(loop)
            cache = R.init_cache(cfg, b, max_seq, device="cuda")
            got = graphed(params, toks, cache, 0, *extra)[0].clone()
            if t:
                want, _ = loop(params, toks, R.init_cache(
                    cfg, b, max_seq, device="cuda"), 0, key)
                if not torch.equal(got, want):
                    raise AssertionError("sampled loop: the captured loop "
                                         "differs from the eager one")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIMED_LOOPS):
                graphed(params, toks, cache, 0, *extra)
            torch.cuda.synchronize()
            tps[t] = b * LOOP_TOKENS * TIMED_LOOPS / (time.perf_counter()
                                                      - t0)
            graphed.captured.release()
    print(f"sampled loop: batch {b}, {LOOP_TOKENS} tokens, int8 cache of "
          f"{max_seq}: the captured sampled loop bitwise the eager one; "
          f"captured tok/s greedy {tps[0.0]:.1f}, sampled "
          f"{tps[SAMPLE_TEMP]:.1f}")


def sampled_serves(cfg, params) -> None:
    """Full-width starcoder2-3b sampled (W8A16, int8 cache, t =
    SAMPLE_TEMP, rng PRNGKey(SEED + 1)) on the slice's trace (24
    requests, prompt 16, 32 new, 400/s): contiguous (8 slots, chunks of
    4), held to the sampled ``reference_outputs``; paged (blocks of 16,
    every row's blocks in the pool), token for token the contiguous
    serve; then the same requests as the overload phase's two classes at
    OVERLOAD_CONTIG_RATE_PER_S (interactive ones keep arriving while batch
    ones hold blocks) served paged under block pressure (OVERLOAD_BLOCKS
    blocks) with preemption: token for token the contiguous serve (a key
    is a function of the position alone, so arrival times and evictions
    change no token), preempted > 0, no leaked block, and its preempted
    requests held to the reference too.  Each serve warmed up, counted,
    no capture inside it."""
    from repro_torch import engine as E

    max_seq = PROMPT_LEN + MAX_NEW
    slice_reqs = E.synthetic_requests(N_REQUESTS, rate_per_s=400.0,
                                      vocab=cfg.vocab, prompt_len=PROMPT_LEN,
                                      max_new_tokens=MAX_NEW, seed=SEED)
    runs = {}
    for label, reqs, kw, serve_kw, path in (
            ("sampled contiguous", slice_reqs, {}, {},
             ("qmatmul_w8a16", "decode_attention_int8")),
            ("sampled paged", slice_reqs, {"block_size": PAGED_BLOCK}, {},
             ("qmatmul_w8a16", "decode_attention_int8_paged")),
            ("sampled preempting",
             overload_trace(cfg, OVERLOAD_CONTIG_RATE_PER_S),
             {"block_size": PAGED_BLOCK, "num_blocks": OVERLOAD_BLOCKS},
             {"preemption": True},
             ("qmatmul_w8a16", "decode_attention_int8_paged"))):
        eng = sampled_engine(cfg, params, max_seq=max_seq, **kw)
        bound = warm(label, eng, reqs[:2])
        rep = overload_serve(label, eng, reqs, bound, path, **serve_kw)
        check_served(label, cfg, rep, reqs)
        runs[label] = (eng, rep)
        if label == "sampled contiguous":
            compare_sampled(label, cfg, params, eng, reqs[:SAMPLE_COMPARE],
                            rep.outputs())
            want = rep.outputs()
        elif rep.outputs() != want:
            raise AssertionError(f"{label}: tokens differ from the "
                                 f"contiguous sampled serve's")
        else:
            print(f"{label}: every token of {len(want)} requests equal to "
                  f"the contiguous sampled serve's")
    eng, rep = runs["sampled preempting"]
    if rep.preempted <= 0 or rep.leaked_blocks:
        raise AssertionError(f"sampled preempting: preempted "
                             f"{rep.preempted}, leaked {rep.leaked_blocks}")
    done = {r.rid for r in slice_reqs[:SAMPLE_COMPARE]}
    victims = [r for r in reqs if r.rid not in done and any(
        x.rid == r.rid and x.preemptions for x in rep.results)]
    print(f"sampled preempting: preempted requests (rid: preemptions) "
          f"{ {r.rid: r.preemptions for r in rep.results if r.preemptions} }")
    if victims:
        compare_sampled("sampled preempting", cfg, params, eng,
                        victims[:4], rep.outputs())
    del runs, eng
    torch_cuda_empty()


def sampled_dense_phase() -> None:
    """mistral-nemo-12b at full width (vocabulary 131,072, bf16 cache)
    sampled: one contiguous serve of the dense trace, held to its sampled
    ``reference_outputs``; freed before it returns."""
    from repro_torch import engine as E
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    arch = "mistral-nemo-12b"
    cfg, params = build_dense_model(arch)
    reqs = E.synthetic_requests(
        DENSE_REQUESTS, rate_per_s=DENSE_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=DENSE_PROMPT, max_new_tokens=DENSE_NEW,
        shared_prefix_len=DENSE_SHARED, seed=SEED)
    label = f"sampled {arch}"
    eng = sampled_engine(cfg, params, max_seq=DENSE_MAX_SEQ)
    bound = warm(label, eng, reqs[:1])
    rep = overload_serve(label, eng, reqs, bound, ("qmatmul_w8a16",))
    check_served(label, cfg, rep, reqs, max_new=DENSE_NEW)
    compare_sampled(label, cfg, params, eng, reqs, rep.outputs())
    del eng
    ST.clear_step_cache()
    del params
    torch_cuda_empty()
    print(f"{label}: phase {time.perf_counter() - t0:.1f}s")


def sampled_cli_run(curve_paths) -> None:
    """The serve CLI at full starcoder2-3b width with ``--temperature``:
    exit 0, and every request equal to the sampled ``reference_outputs``
    under the engine's key (PRNGKey(seed + 1)) on the card."""
    import torch
    from repro_torch.runtime import prng as P

    t = str(SAMPLE_TEMP)
    _, res = serve_run("w8a16", curve_paths, ["--temperature", t],
                       label="serve w8a16 sampled")
    if not (res.engine.temperature == SAMPLE_TEMP and torch.equal(
            res.engine.rng.cpu(), P.PRNGKey(SEED + 1))):
        raise AssertionError("serve w8a16 sampled: the engine does not "
                             "sample with PRNGKey(seed + 1)")
    compare_sampled("serve w8a16 sampled", res.cfg, res.params, res.engine,
                    res.requests, res.report.outputs())
    del res
    torch_cuda_empty()


def sampling_phase(cfg, params) -> None:
    """The sampling phase on the slice's model: the PRNG on the card, the
    sampled serves, the captured sampled tick and decode loop."""
    t0 = time.perf_counter()
    prng_phase()
    sampled_serves(cfg, params)
    sampled_tick_phase(cfg, params)
    sampled_loop_phase(cfg, params)
    print(f"sampling: starcoder2-3b part {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# speculation phase
# ---------------------------------------------------------------------------

SPEC_K = 3                  # proposals a slot per verify round
SPEC_DRAFT_LAYERS = 1       # the self-draft's depth, but for the full one
# the paged speculative serve: the paged slice's geometry (prompt 32
# sharing 16, blocks of 16, 24 usable blocks) at 20/s, which spreads
# arrivals past a tenant's prefill (its prefix block is registered, so
# later requests share it) without the 2/s trace's 12 s of waiting
SPEC_PAGED_RATE_PER_S = 20.0
SPEC_TIMED = 5              # captured calls a timing (host clock, profiler)


def spec_serve(label, eng, reqs, control, path):
    """A speculating engine warmed up (verify, propose, the draft's
    catch-up chunks and the target's chunks captured), then one
    wall-clock serve with the counters zeroed just before and read just
    after: no capture, no plain version, no mma launch, every kernel of
    ``path`` launched, every token equal to the ``control`` serve's.
    Returns (report, launches)."""
    bound = warm(label, eng, reqs[:2])
    zero_counts()
    rep = eng.serve(reqs, clock="wall")
    launches, plain_calls = read_counts()
    same_captures(label, eng, bound)
    mma_free(label, launches)
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: the CUDA path reached a plain "
                             f"version: {plain_calls}")
    if any(launches[k] <= 0 for k in path):
        raise AssertionError(f"{label}: a kernel of the path never "
                             f"launched: {launches}")
    check_served(label, eng.cfg, rep, reqs)
    if rep.outputs() != control.outputs():
        bad = [rid for rid, toks in rep.outputs().items()
               if toks != control.outputs()[rid]]
        raise AssertionError(f"{label}: requests {bad} differ from the "
                             f"non-speculative control serve")
    print(f"{label}: k={rep.spec_k}, {eng.dcfg.name} draft: "
          f"{len(rep.results)} requests in {rep.ticks} ticks (control "
          f"{control.ticks}), {rep.generated_tokens} tokens, "
          f"accepted_per_dispatch {rep.accepted_per_dispatch:.3f}, wall "
          f"{rep.wall_s:.3f}s (control {control.wall_s:.3f}s), decoded "
          f"tok/s {rep.generated_tokens / rep.wall_s:.1f} (control "
          f"{control.generated_tokens / control.wall_s:.1f}), ms/tick "
          f"{1e3 * rep.wall_s / rep.ticks:.2f} (control "
          f"{1e3 * control.wall_s / control.ticks:.2f}), mean ttft "
          f"{rep.mean_ttft_s:.3f}s (control {control.mean_ttft_s:.3f}s), "
          f"p99 latency {rep.p99_latency_s:.3f}s, latency per token "
          f"{1e3 * rep.latency_per_token_s:.2f} ms, leaked_blocks "
          f"{rep.leaked_blocks}, shared_block_hits {rep.shared_block_hits}")
    print(f"{label}: every token of {len(rep.results)} requests equal to "
          f"the control serve's; kernel launches {launches}")
    return rep, launches


def spec_step_times(cfg, params) -> None:
    """The captured verify (k + 1 positions of NUM_SLOTS rows at
    max_seq / 2, every row feeding all of them) and the captured propose
    (k steps of the 1-layer self-draft), each first bitwise its eager
    form on copies of one random cache (samples or proposals, indices,
    every cache leaf), then their wall, device busy and launch calls
    beside the captured tick's on the same cache."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    S, max_seq = NUM_SLOTS, PROMPT_LEN + MAX_NEW
    dcfg = R.draft_config(cfg, SPEC_DRAFT_LAYERS)
    dparams = R.draft_params(cfg, params, SPEC_DRAFT_LAYERS)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        toks = torch.randint(1, cfg.vocab, (S, SPEC_K + 1), generator=g,
                             device="cuda", dtype=torch.int32)
        idx = torch.full((S,), max_seq // 2, dtype=torch.int32,
                         device="cuda")
        n_tok = torch.full((S,), SPEC_K + 1, dtype=torch.int32,
                           device="cuda")
        active = torch.ones((S,), dtype=torch.bool, device="cuda")
    steps = {
        "tick": (cfg, params, ST.make_slot_decode_step(cfg, mode=W8A16),
                 ST.jit_slot_decode_step, (toks[:, :1].contiguous(), idx,
                                           active)),
        "verify": (cfg, params, ST.make_verify_step(cfg, mode=W8A16,
                                                    k=SPEC_K),
                   ST.jit_verify_step, (toks, idx, n_tok, active)),
        "propose": (dcfg, dparams, ST.make_draft_propose_step(
            dcfg, mode=W8A16, k=SPEC_K), ST.jit_draft_propose_step,
            (toks[:, :1].contiguous(), idx, active))}
    res = {}
    for name, (c, p, eager, jit, args) in steps.items():
        cache = _random_cache(c, S, max_seq, 0)
        other = {k: v.clone() for k, v in cache.items()}
        graphed = jit(eager)
        with torch.inference_mode():
            want, _, i_e = eager(p, args[0], cache, *args[1:])
            zero_counts()
            got, _, i_g = graphed(p, args[0], other, *args[1:])
            torch.cuda.synchronize()
            zero_counts()
            graphed(p, args[0], other, *args[1:])
            launches, _ = read_counts()
        if not (torch.equal(got, want) and torch.equal(i_g, i_e)) or any(
                not torch.equal(other[k], cache[k]) for k in cache):
            raise AssertionError(f"spec {name}: the captured step differs "
                                 f"from the eager one")
        res[name] = device_breakdown(
            f"spec {name}", f"captured {name} ({S} rows at position "
            f"{max_seq // 2} of {max_seq}, k = {SPEC_K}, {c.n_layers} "
            f"layers)", lambda: graphed(p, args[0], other, *args[1:])[0]
            .cpu(), SPEC_TIMED, False)
        res[name]["launches"] = launches
        graphed.captured.release()
        del cache, other
    tick = res["tick"]
    for name in ("verify", "propose"):
        r = res[name]
        busy = ("not measured" if r["busy"] is None or tick["busy"] is None
                else f"{r['busy']:.3f} ms ({r['busy'] / tick['busy']:.2f}x "
                     f"the tick's {tick['busy']:.3f})")
        print(f"spec {name}: captured bitwise the eager step; wall "
              f"{r['wall']:.2f} ms ({r['wall'] / tick['wall']:.2f}x the "
              f"captured tick's {tick['wall']:.2f}), device busy {busy}, "
              f"cudaGraphLaunch {r['graph_launches']:.0f}, cudaLaunchKernel "
              f"{r['launch_calls']:.0f}; launches per replay "
              f"{r['launches']}")
    torch_cuda_empty()


def spec_phase(cfg, params):
    """Full-width starcoder2-3b (W8A16, int8 cache, 8 slots, chunks of 4)
    speculating with k = 3: on the slice's trace (24 requests of 16 + 32
    tokens, 400/s) a full-depth self-draft (every proposal accepted: 32
    tokens a request in rounds of k + 1) and a 1-layer one, greedy and
    sampled (t = SAMPLE_TEMP, PRNGKey(SEED + 1)), and the 1-layer one
    paged (the paged slice's geometry at SPEC_PAGED_RATE_PER_S): each
    served warmed up and counted, equal token for token to the
    non-speculative control serve of the same trace and engine settings,
    and requests of each held to ``reference_outputs``; then the captured
    verify and propose steps timed against the captured tick.  Returns
    the launches of the contiguous and the paged 1-layer serves."""
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16
    from repro_torch.runtime import prng as P
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    reqs = E.synthetic_requests(N_REQUESTS, rate_per_s=400.0,
                                vocab=cfg.vocab, prompt_len=PROMPT_LEN,
                                max_new_tokens=MAX_NEW, seed=SEED)
    paged_reqs = E.synthetic_requests(
        N_REQUESTS, rate_per_s=SPEC_PAGED_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=PAGED_PROMPT_LEN, shared_prefix_len=PAGED_SHARED_PREFIX,
        max_new_tokens=MAX_NEW, seed=SEED)
    contig = ("qmatmul_w8a16", "decode_attention_int8",
              "decode_attention_int8_paged")
    paged = ("qmatmul_w8a16", "decode_attention_int8_paged")
    key = P.PRNGKey(SEED + 1, device="cuda")
    one = dict(draft_layers=SPEC_DRAFT_LAYERS)
    groups = (
        ("greedy", reqs, dict(max_seq=PROMPT_LEN + MAX_NEW), contig,
         (("full-depth", dict(draft_layers=cfg.n_layers)),
          ("1-layer", one))),
        ("sampled", reqs, dict(max_seq=PROMPT_LEN + MAX_NEW,
                               temperature=SAMPLE_TEMP, rng=key), contig,
         (("1-layer", one),)),
        ("paged", paged_reqs, dict(max_seq=PAGED_PROMPT_LEN + MAX_NEW,
                                   block_size=PAGED_BLOCK,
                                   num_blocks=PAGED_NUM_BLOCKS), paged,
         (("1-layer", one),)))
    out = {}
    for group, trace, kw, path, drafts in groups:
        control = E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                           prefill_chunk=PREFILL_CHUNK, **kw)
        warm(f"spec {group} control", control, trace[:2])
        ctl = control.serve(trace, clock="wall")
        check_served(f"spec {group} control", cfg, ctl, trace)
        del control
        for name, draft in drafts:
            label = f"spec {group} {name}"
            eng = E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                           prefill_chunk=PREFILL_CHUNK, spec_k=SPEC_K,
                           **draft, **kw)
            rep, launches = spec_serve(label, eng, trace, ctl, path)
            if name == "full-depth" and (
                    rep.accepted_per_dispatch != SPEC_K + 1):
                raise AssertionError(f"{label}: accepted_per_dispatch "
                                     f"{rep.accepted_per_dispatch}, not "
                                     f"{SPEC_K + 1}: a proposal of the "
                                     f"target itself was rejected")
            if group == "paged" and (rep.leaked_blocks
                                     or rep.shared_block_hits <= 0):
                raise AssertionError(f"{label}: leaked "
                                     f"{rep.leaked_blocks}, shared hits "
                                     f"{rep.shared_block_hits}")
            if name == "1-layer":
                out[group] = launches
                if group == "sampled":
                    compare_sampled(label, cfg, params, eng,
                                    trace[:N_COMPARE], rep.outputs())
                else:
                    compare_with_reference(label, cfg, params, eng,
                                           trace[:N_COMPARE], rep.outputs())
            del eng
        ST.clear_step_cache()
        torch_cuda_empty()
    spec_step_times(cfg, params)
    print(f"spec: starcoder2-3b part {time.perf_counter() - t0:.1f}s")
    return out


def spec_cli_run(curve_paths, control=None):
    """The serve CLI at full starcoder2-3b width with ``--spec-k 3
    --draft-layers 1``: exit 0, every request ok and equal to the
    non-speculative w8a16 run's tokens (``control``, the same flags
    less these two) or, without it, three of them to
    ``reference_outputs``.  Returns its launches."""
    label = "serve w8a16 speculative"
    launches, res = serve_run(
        "w8a16", curve_paths, ["--spec-k", str(SPEC_K), "--draft-layers",
                               str(SPEC_DRAFT_LAYERS)], label=label)
    rep = res.report
    if rep.spec_k != SPEC_K or not res.engine.dcfg.name.endswith(
            f"-draft{SPEC_DRAFT_LAYERS}"):
        raise AssertionError(f"{label}: spec_k {rep.spec_k}, draft "
                             f"{res.engine.dcfg}")
    print(f"{label}: accepted_per_dispatch {rep.accepted_per_dispatch:.3f}, "
          f"{rep.ticks} ticks, decoded tok/s {rep.tokens_per_s:.1f}, mean "
          f"ttft {rep.mean_ttft_s:.3f}s")
    if control is not None:
        if rep.outputs() != control:
            raise AssertionError(f"{label}: tokens differ from the "
                                 f"non-speculative w8a16 run's")
        print(f"{label}: every token of {len(control)} requests equal to "
              f"the non-speculative w8a16 run's")
    else:
        compare_with_reference(label, res.cfg, res.params, res.engine,
                               res.requests[:N_COMPARE], rep.outputs())
    del res
    torch_cuda_empty()
    return launches


def spec_moe_only() -> None:
    """``--only spec`` without the MoE phase: qwen2-moe-a2.7b from the
    streamed init, its contiguous serve as the control, then
    :func:`moe_spec_serve`."""
    from repro_torch import engine as E
    from repro_torch.runtime import steps as ST

    ST.clear_step_cache()
    torch_cuda_empty()
    cfg, params = build_dense_model(MOE_ARCH)
    reqs = E.synthetic_requests(
        DENSE_REQUESTS, rate_per_s=DENSE_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=DENSE_PROMPT, max_new_tokens=DENSE_NEW,
        shared_prefix_len=DENSE_SHARED, seed=SEED)
    label = f"moe {MOE_ARCH}"
    eng, rep, _ = dense_serve(f"{label} contiguous", cfg, params, reqs)
    del eng
    moe_spec_serve(label, cfg, params, reqs, rep.outputs())
    del params
    torch_cuda_empty()


def moe_spec_serve(label, cfg, params, reqs, control):
    """qwen2-moe-a2.7b (bf16 cache) speculating with a 1-layer self-draft
    on the dense trace, served as the dense serves are and equal token
    for token to ``control`` (the contiguous serve's outputs).  Returns
    its launches."""
    from repro_torch.runtime import steps as ST

    label = f"{label} speculative"
    eng, rep, launches = dense_serve(label, cfg, params, reqs,
                                     spec_k=SPEC_K,
                                     draft_layers=SPEC_DRAFT_LAYERS)
    if rep.outputs() != control:
        raise AssertionError(f"{label}: tokens differ from the contiguous "
                             f"serve's")
    print(f"{label}: k={rep.spec_k}, {eng.dcfg.name} draft, "
          f"accepted_per_dispatch {rep.accepted_per_dispatch:.3f}, "
          f"{rep.ticks} ticks; every token of {len(control)} requests equal "
          f"to the contiguous serve's")
    del eng
    ST.clear_step_cache()
    torch_cuda_empty()
    return launches


# ---------------------------------------------------------------------------
# the rest of the dense family
# ---------------------------------------------------------------------------

# the three other dense configs, smallest first: each is built at full
# width from the streamed init, served, timed and freed before the next
DENSE_ARCHS = ("mistral-nemo-12b", "internlm2-20b", "qwen1.5-32b")
DENSE_REQUESTS = 8
DENSE_PROMPT = 16
DENSE_NEW = 16
DENSE_MAX_SEQ = DENSE_PROMPT + DENSE_NEW
# the paged serve: blocks of 8, so the 8-token shared prefix is a whole
# block the 16-token prompts can share (the last prompt token must land in
# a private block); 16 usable blocks, four requests' rows, against 32 for
# the contiguous equivalent.  Arrivals at 20/s spread past a tenant's
# prefill (four chunk passes), so later requests find the prefix block
DENSE_BLOCK = 8
DENSE_SHARED = DENSE_BLOCK
DENSE_NUM_BLOCKS = 1 + 4 * (DENSE_MAX_SEQ // DENSE_BLOCK)
DENSE_RATE_PER_S = 20.0
# qwen1.5-32b's 35.2 GB of int8 weights must come from an init whose peak
# stays below this (its f32 tree alone is 141 GB); qwen2-moe-a2.7b's 14.0 GB
# from one under 20 GB (its f32 tree is 56 GB, one f32 layer 2.28 GB)
PEAK_BYTES = {"qwen1.5-32b": 45e9, "qwen2-moe-a2.7b": 20e9}
# the decode attention kernels' rows at the dense configs' (KV heads, G):
# qwen1.5-32b, mistral-nemo-12b, internlm2-20b
DENSE_HEADS = ((40, 1), (8, 4), (8, 6))
# the serve CLI at full mistral-nemo-12b width with the paged bf16 cache:
# 16 slots x 3 blocks of 16 = 48 blocks worst case, 24 usable; prompts of
# 32 tokens whose first block all requests share, arriving at 10/s (at the
# default 200/s all 16 arrive before the first tenant's 8 chunks have
# written its prefix block, and none shares it).  The deadline leaves the
# Table 4 policy the largest measured batch: a 12 B model's batch-16
# prefill is about 4x starcoder2-3b's, whose modeled p99 was 244 ms
DENSE_SERVE_ARGS = ["--arch", "mistral-nemo-12b", "--rate", "10",
                    "--max-batch",
                    str(SERVE_MAX_BATCH), "--seq", str(SERVE_SEQ),
                    "--decode-tokens", "16", "--n-requests", "16",
                    "--prompt-len", "32", "--gen-tokens", "16",
                    "--prefill-chunk", str(PREFILL_CHUNK), "--deadline-ms",
                    "2000", "--seed", str(SEED), "--block-size", "16",
                    "--num-blocks", "25", "--shared-prefix-len", "16"]
DENSE_CLI_COMPARE = 4       # requests of the CLI run held to the reference


def dense_qmatmul_rows(flush):
    """qmatmul_w8a16 at the dense configs' new shapes: w_gate with the silu
    drain, w_down (qwen1.5-32b's K = 27,392 split by the GEMV's plan) and
    each untied LM head (f32 out), through both kernels at M = 1 and a
    tick's 8 rows, held against the plain version (bf16_close); the GEMV's
    rows of M = 8 and 16 launches equal to the rows alone at each w_down;
    both kernels timed at M = 8 beside the plain version, F.linear on bf16
    weights and the bound.  Returns (worst error, {shape: numbers})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import qmatmul as K

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    rows, worst = {}, 0.0
    for arch in DENSE_ARCHS:
        c = get_config(arch)
        for name, k, n, act, odt in (
                ("w_gate", c.d_model, c.d_ff, "silu", torch.bfloat16),
                ("w_down", c.d_ff, c.d_model, "none", torch.bfloat16),
                ("lm_head", c.d_model, c.vocab, "none", torch.float32)):
            wf = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
            q = quantize_weight(wf)
            del wf
            w, ws = q.values, q.scale.reshape(-1).contiguous()
            label = f"{arch} {name}"
            if name == "w_down":
                gemv_rows_check(label, torch.randn(
                    (2 * NUM_SLOTS, k), generator=gen, device="cuda").to(
                    torch.bfloat16), w, ws, None, act, odt)
            errs = []
            for m in (1, NUM_SLOTS):
                x = torch.randn((m, k), generator=gen,
                                device="cuda").to(torch.bfloat16)
                ref = K.qmatmul_w8a16_ref(x, w, ws, activation=act,
                                          out_dtype=odt)
                errs.append(w8a16_check(f"{label} M={m}", x, w, ws, None,
                                        act, odt, ref))
            err = max(e for e, _ in errs)
            ratio = max(r for _, r in errs)
            worst = max(worst, err)
            ms = {path: time_ms(lambda: K.qmatmul_w8a16_on_path(
                path, x, w, ws, activation=act, out_dtype=odt), 20, flush)
                for path in K.W8A16_PATHS}
            plain = time_ms(lambda: K.qmatmul_w8a16_ref(
                x, w, ws, activation=act, out_dtype=odt), 3, flush)
            w_lib = (w.float() * ws).to(torch.bfloat16).t()
            lib = time_ms(lambda: F.linear(x, w_lib), 20, flush)
            del w_lib
            m = NUM_SLOTS
            nbytes = (x.numel() * 2 + w.numel() + ws.numel() * 4
                      + m * n * torch.empty(0, dtype=odt).element_size())
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * m * k * n / BF16_OPS_PER_S * 1e3
            plan = K.gemv_split_plan(k, n)
            rows[label] = {
                "K": k, "N": n, "activation": act, "M": m,
                "ms": ms["gemv"], "mma_ms": ms["mma"], "plain_ms": plain,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": lib, "max_abs_err": err}
            print(f"  qmatmul_w8a16 {label:24s} K={k:5d} N={n:6d} act={act:4s}"
                  f" max_abs_err={err:.3e} err/tol={ratio:.3f} (M = 1 and "
                  f"{m}, both paths) gemv_ms={ms['gemv']:.4f} "
                  f"mma_ms={ms['mma']:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={max(bytes_ms, ops_ms):.4f}"
                  f" (M = {m}; GEMV plan {plan.strips} strips x "
                  f"{plan.splits} splits)")
            del q, w, ws
    print(f"  qmatmul_w8a16 at the dense shapes: both paths within "
          f"bf16_close; GEMV rows of M = {NUM_SLOTS} and {2 * NUM_SLOTS} "
          f"launches equal to the rows alone at each w_down")
    zero_counts()
    return worst, rows


def dense_attention_rows(flush):
    """The two decode attention kernels at the dense configs' (KV heads,
    G) of DENSE_HEADS, at the dense serves' tick: B = 8 ragged rows of a
    DENSE_MAX_SEQ-slot cache (paged: blocks of DENSE_BLOCK through shuffled
    tables): against the plain version, the paged kernel bitwise equal to
    the contiguous one on the gathered view, every row bitwise equal to the
    row launched alone, timed beside SDPA and the bound.  Returns (worst
    error, {contiguous rows}, {paged rows})."""
    import torch
    from repro_torch.kernels import decode_attention as A

    hd, s, bs = 128, DENSE_MAX_SEQ, DENSE_BLOCK
    mb, b = s // bs, NUM_SLOTS
    nb = b * mb + 1
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    cpu_gen = torch.Generator().manual_seed(SEED + 8)
    vls = [0, 1, 5, 17, s - 1, s, s // 2, 12][:b]
    vl = torch.tensor(vls, dtype=torch.int32, device="cuda")
    worst, contig, paged = 0.0, {}, {}
    for kvh, g in DENSE_HEADS:
        key = f"KV={kvh} G={g}"
        q = torch.randn((b, kvh, g, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v, ks, vs = _attn_cache(gen, (b, s, kvh, hd))
        label = f"decode_attention_int8 {key} B={b} S={s}"
        out = A.decode_attention_int8(q, k, v, ks, vs, vl)
        err = _attn_close(label, out, A.decode_attention_int8_ref(
            q, k, v, ks, vs, vl))
        _rows_alone(label, out, lambda r: A.decode_attention_int8(
            q[r:r + 1], k[r:r + 1], v[r:r + 1], ks[r:r + 1], vs[r:r + 1],
            vl[r:r + 1]), b)
        contig[key] = _attn_numbers(
            label, b, vls, False, err,
            time_ms(lambda: A.decode_attention_int8(q, k, v, ks, vs, vl), 20,
                    flush),
            time_ms(lambda: A.decode_attention_int8_ref(q, k, v, ks, vs, vl),
                    3, flush),
            _sdpa_ms(flush, q, (k.float() * ks).to(torch.bfloat16)
                     .transpose(1, 2), (v.float() * vs).to(torch.bfloat16)
                     .transpose(1, 2), vl, s), q, 0)
        contig[key]["max_abs_err"] = err
        worst = max(worst, err)
        pk, pv, pks, pvs = _attn_cache(gen, (nb, bs, kvh, hd))
        tables = _paged_tables(cpu_gen, vls, mb, nb, bs)
        label = f"decode_attention_int8_paged {key} B={b} bs={bs} MB={mb}"
        out = A.decode_attention_int8_paged(q, pk, pv, pks, pvs, vl, tables)
        err = _attn_close(label, out, A.decode_attention_int8_paged_ref(
            q, pk, pv, pks, pvs, vl, tables))
        gathered = [A.paged_gather(c, tables).contiguous()
                    for c in (pk, pv, pks, pvs)]
        if not torch.equal(out, A.decode_attention_int8(q, *gathered, vl)):
            raise AssertionError(f"{label}: not bitwise equal to the "
                                 f"contiguous kernel on the gathered view")
        _rows_alone(label, out, lambda r: A.decode_attention_int8_paged(
            q[r:r + 1], pk, pv, pks, pvs, vl[r:r + 1], tables[r:r + 1]), b)
        gk, gv, gks, gvs = gathered
        paged[key] = _attn_numbers(
            label, b, vls, False, err,
            time_ms(lambda: A.decode_attention_int8_paged(
                q, pk, pv, pks, pvs, vl, tables), 20, flush),
            time_ms(lambda: A.decode_attention_int8_paged_ref(
                q, pk, pv, pks, pvs, vl, tables), 3, flush),
            _sdpa_ms(flush, q, (gk.float() * gks).to(torch.bfloat16)
                     .transpose(1, 2), (gv.float() * gvs).to(torch.bfloat16)
                     .transpose(1, 2), vl, s), q, tables.numel() * 4)
        paged[key]["max_abs_err"] = err
        worst = max(worst, err)
    print("  decode attention at the dense configs' G: "
          + "; ".join(f"{key}: ms {contig[key]['ms']:.4f} / paged "
                      f"{paged[key]['ms']:.4f} against bound "
                      f"{contig[key]['bound_ms']:.5f} / "
                      f"{paged[key]['bound_ms']:.5f}"
                      for key in contig)
          + "; every row bitwise equal alone and in its batch, the paged "
          "kernel bitwise the contiguous one on the gathered view")
    zero_counts()
    return worst, contig, paged


def build_dense_model(arch):
    """Full-width ``arch`` with random weights from SEED through the
    streamed init (``registry.init_quantized``: each layer and table
    quantized as it is drawn), on the card: (cfg, params).  Prints its
    shape, its int8 weight bytes, the init's time and the peak memory
    allocated (and what was allocated before the init), which must stay
    under PEAK_BYTES where one is set."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import tree_weight_bytes
    from repro_torch.models import registry as R

    cfg = get_config(arch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        params = R.init_quantized(gen, cfg, min_size=2048, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    nbytes = tree_weight_bytes(params)
    experts = (f"{cfg.n_experts} experts top-{cfg.top_k} + "
               f"{cfg.n_shared_experts} shared, " if cfg.n_experts else "")
    print(f"{cfg.family} {arch}: full width ({cfg.n_layers} layers, d="
          f"{cfg.d_model}, {cfg.n_heads} q-heads / {cfg.n_kv_heads} kv-heads"
          f" of {cfg.head_dim}, {experts}ff={cfg.d_ff} gated "
          f"{cfg.activation}, vocab={cfg.vocab} "
          f"{'tied' if cfg.tie_embeddings else 'untied'}, {cfg.norm}), W8A16 "
          f"weights {nbytes} bytes, streamed init+quantize {init_s:.1f}s, "
          f"torch.cuda.max_memory_allocated {peak} bytes ({peak / 1e9:.2f} "
          f"GB; {before} allocated before)")
    limit = PEAK_BYTES.get(arch)
    if limit is not None and peak >= limit:
        raise AssertionError(f"{cfg.family} {arch}: the init's peak {peak} "
                             f"bytes ({before} allocated before it) is not "
                             f"under {limit:.0f}")
    return cfg, params


def dense_serve(label, cfg, params, reqs, **kw):
    """One engine of the dense serves (NUM_SLOTS slots of DENSE_MAX_SEQ,
    chunked prefill of PREFILL_CHUNK; ``kw`` pages it), warmed up, then a
    wall-clock serve of ``reqs`` with the counters zeroed just before and
    read just after: no capture inside it, no plain version, no mma
    launch, the GEMV launched, the decode attention kernels launched
    exactly when the cache is int8 and the experts' stacked GEMV exactly
    for an MoE config.  Returns (engine, report, launches)."""
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16

    eng = E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                   max_seq=DENSE_MAX_SEQ, prefill_chunk=PREFILL_CHUNK, **kw)
    bound = warm(label, eng, reqs[:1])
    zero_counts()
    rep = eng.serve(reqs, clock="wall")
    launches, plain_calls = read_counts()
    same_captures(label, eng, bound)
    print(f"{label}: served {len(rep.results)} requests in {rep.ticks} "
          f"ticks, {rep.generated_tokens} tokens, wall {rep.wall_s:.3f}s, "
          f"decoded tok/s {rep.generated_tokens / rep.wall_s:.1f}, ms/tick "
          f"{1e3 * rep.wall_s / rep.ticks:.2f}, p99 latency "
          f"{rep.p99_latency_s:.3f}s, mean ttft {rep.mean_ttft_s:.3f}s, "
          f"kv_hbm_bytes {rep.kv_hbm_bytes}")
    print(f"{label}: kernel launches {launches}, plain-version calls "
          f"{plain_calls}")
    attn = ("decode_attention_int8", "decode_attention_int8_paged")
    if launches["qmatmul_w8a16"] <= 0 or any(
            (launches[k] > 0) != cfg.kv_quant for k in attn) or (
            (launches["qmatmul_w8a16_experts"] > 0) != (cfg.family == "moe")):
        raise AssertionError(f"{label}: launches {launches} (int8 cache: "
                             f"{cfg.kv_quant}, family {cfg.family})")
    mma_free(label, launches)
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: the CUDA path reached a plain "
                             f"version: {plain_calls}")
    check_served(label, cfg, rep, reqs, max_new=DENSE_NEW)
    return eng, rep, launches


def dense_tick(cfg, params, label, block_size=0):
    """The captured steady tick of the dense serves: NUM_SLOTS rows at
    position DENSE_MAX_SEQ / 2 of the bf16 cache (paged: every row on
    blocks of its own), its launches per replay (7 GEMVs a layer and the
    head), then wall, device busy and launch calls over replays, beside
    the floor: the int8 weights a tick reads (every layer and the head;
    the embedding table only gathers a row per slot) at 3.35 TB/s."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.core.quant import tree_weight_bytes
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    S, max_seq = NUM_SLOTS, DENSE_MAX_SEQ
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(
        cfg, mode=W8A16))
    with torch.inference_mode():
        if block_size:
            mb = max_seq // block_size
            cache = R.init_paged_cache(cfg, S, max_seq, block_size,
                                       S * mb + 1, device="cuda")
            cache["block_tables"].copy_(torch.arange(
                1, S * mb + 1, dtype=torch.int32).reshape(S, mb))
        else:
            cache = R.init_cache(cfg, S, max_seq, device="cuda")
        toks = torch.ones((S, 1), dtype=torch.int32, device="cuda")
        idx = torch.full((S,), max_seq // 2, dtype=torch.int32,
                         device="cuda")
        active = torch.ones((S,), dtype=torch.bool, device="cuda")
        t0 = time.perf_counter()
        graphed(params, toks, cache, idx, active)[0].cpu()
        capture_s = time.perf_counter() - t0
        zero_counts()
        graphed(params, toks, cache, idx, active)[0].cpu()
    launches, plain = read_counts()
    gemv = 7 * cfg.n_layers + 1
    if (launches["qmatmul_w8a16[gemv]"] != gemv or any(plain.values())
            or launches["decode_attention_int8"]
            or launches["decode_attention_int8_paged"]):
        raise AssertionError(f"{label}: a replay launched {launches} "
                             f"({gemv} GEMVs expected), plain {plain}")
    res = device_breakdown(
        label, f"captured steady-state slot tick ({S} active rows at "
        f"position {max_seq // 2} of {max_seq}, bf16 cache"
        f"{', blocks of ' + str(block_size) if block_size else ''})",
        lambda: graphed(params, toks, cache, idx, active)[0].cpu(), 10)
    read = tree_weight_bytes(params) - (
        tree_weight_bytes(params["embed"]) if "unembed" in params else 0)
    floor = read / HBM_BYTES_PER_S * 1e3
    index_ms = sum(ms for key, ms in res["by_kernel"].items()
                   if "index" in key or "gather" in key)
    busy = res["busy"]
    print(f"{label}: {launches['qmatmul_w8a16[gemv]']} GEMVs a replay; "
          f"capture {capture_s:.2f} s; wall {res['wall']:.2f} ms, device "
          f"busy {'not measured' if busy is None else f'{busy:.3f} ms'}, "
          f"cudaGraphLaunch {res['graph_launches']:.0f}, cudaLaunchKernel "
          f"{res['launch_calls']:.0f} a tick; floor {floor:.3f} ms (the "
          f"{read} bytes of int8 weights a tick reads at 3.35 TB/s): wall / "
          f"floor {res['wall'] / floor:.2f}; indexing kernels (the cache "
          f"writes{' and the per-row gathers' if block_size else ''}) "
          f"{index_ms:.3f} ms of device time")
    graphed.captured.release()


def dense_model_phase(arch):
    """One dense config at full width: built by the streamed init, then a
    contiguous bf16 serve held to ``reference_outputs``, a paged bf16
    serve of the same trace (fewer usable blocks than the contiguous
    equivalent, a shared prefix block) whose every token equals the
    contiguous serve's with no block leaked, the captured steady tick
    contiguous and paged against its floor, and for qwen1.5-32b a serve
    on the int8 cache (``kv_quant=True``: both decode attention kernels at
    G = 1) held to ``reference_outputs``.  Everything it built is freed
    before it returns its launch counts."""
    import torch
    from repro_torch import engine as E
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    cfg, params = build_dense_model(arch)
    reqs = E.synthetic_requests(
        DENSE_REQUESTS, rate_per_s=DENSE_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=DENSE_PROMPT, max_new_tokens=DENSE_NEW,
        shared_prefix_len=DENSE_SHARED, seed=SEED)
    out = {"arch": arch}
    label = f"dense {arch}"
    eng, rep, out["launches"] = dense_serve(f"{label} contiguous", cfg,
                                            params, reqs)
    compare_with_reference(f"{label} contiguous", cfg, params, eng, reqs,
                           rep.outputs())
    contig = rep.outputs()
    del eng
    eng, rep, _ = dense_serve(f"{label} paged", cfg, params, reqs,
                              block_size=DENSE_BLOCK,
                              num_blocks=DENSE_NUM_BLOCKS)
    print(f"{label} paged: block_size {rep.block_size}, num_blocks "
          f"{rep.num_blocks} ({rep.num_blocks - 1} usable against "
          f"{NUM_SLOTS * eng.max_blocks} for the contiguous equivalent), "
          f"peak_blocks_used {rep.peak_blocks_used}, leaked_blocks "
          f"{rep.leaked_blocks}, shared_block_hits {rep.shared_block_hits}, "
          f"prefill_tokens_skipped {rep.prefill_tokens_skipped}")
    if rep.outputs() != contig:
        raise AssertionError(f"{label} paged: tokens differ from the "
                             f"contiguous serve's")
    if rep.leaked_blocks or rep.peak_blocks_used > rep.num_blocks - 1:
        raise AssertionError(f"{label} paged: block accounting: peak "
                             f"{rep.peak_blocks_used}, leaked "
                             f"{rep.leaked_blocks}")
    print(f"{label} paged: every token of {len(contig)} requests equal to "
          f"the contiguous serve's")
    del eng
    ST.clear_step_cache()
    torch_cuda_empty()
    dense_tick(cfg, params, f"{label} tick")
    dense_tick(cfg, params, f"{label} paged tick", DENSE_BLOCK)
    if arch == "qwen1.5-32b":
        qcfg = dataclasses.replace(cfg, kv_quant=True)
        eng, rep, out["int8_launches"] = dense_serve(
            f"{label} int8 cache", qcfg, params, reqs)
        compare_with_reference(f"{label} int8 cache", qcfg, params, eng,
                               reqs, rep.outputs())
        del eng
    ST.clear_step_cache()
    del params
    torch_cuda_empty()
    print(f"{label}: phase {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated()} bytes left allocated")
    return out


def dense_cli_phase():
    """The serve CLI at full mistral-nemo-12b width with the paged bf16
    cache (DENSE_SERVE_ARGS): exit 0, the service curve's forward on the
    mma path and flash attention (H = 32), the decode loop and the paged
    engine, no block leaked, and DENSE_CLI_COMPARE requests (the first to
    share the prefix block among them) equal to ``reference_outputs``."""
    from repro_torch.launch import serve

    real_curve = serve.measure_service_curve
    curve_paths = {}
    serve.measure_service_curve = counted_curve(real_curve, curve_paths)
    try:
        launches, res = serve_run("w8a16", curve_paths,
                                  base=DENSE_SERVE_ARGS,
                                  label="serve mistral-nemo-12b paged")
    finally:
        serve.measure_service_curve = real_curve
    label = "serve mistral-nemo-12b paged"
    rep = res.report
    print(f"{label}: {rep.num_slots} slots, block_size {rep.block_size}, "
          f"num_blocks {rep.num_blocks}, peak_blocks_used "
          f"{rep.peak_blocks_used}, leaked_blocks {rep.leaked_blocks}, "
          f"shared_block_hits {rep.shared_block_hits}")
    worst = rep.num_slots * res.engine.max_blocks
    if (rep.block_size != 16 or rep.leaked_blocks
            or rep.num_blocks - 1 >= worst):
        raise AssertionError(f"{label}: block_size {rep.block_size}, "
                             f"{rep.num_blocks} blocks against a worst case "
                             f"of {worst}, {rep.leaked_blocks} leaked")
    sharers = [r.rid for r in rep.results if r.shared_blocks]
    rids = sharers[:1] + [r.rid for r in rep.results
                          if r.rid not in sharers[:1]]
    rids = set(rids[:DENSE_CLI_COMPARE])
    compare_with_reference(label, res.cfg, res.params, res.engine,
                           [r for r in res.requests if r.rid in rids],
                           rep.outputs())
    del res
    torch_cuda_empty()
    return launches


def dense_kernel_rows(flush):
    """The kernel rows at the dense configs' shapes (the kernel phase's
    part of the dense family): {"qmatmul": (worst error, rows),
    "attention": (worst error, contiguous rows, paged rows)}."""
    print("dense: the kernels at the dense configs' shapes")
    out = {"qmatmul": dense_qmatmul_rows(flush),
           "attention": dense_attention_rows(flush)}
    torch_cuda_empty()
    return out


def dense_phase():
    """Each dense config served at full width, one at a time, then the
    serve CLI on mistral-nemo-12b, paged: {"runs": [...], "cli":
    launches}."""
    from repro_torch.runtime import steps as ST

    ST.clear_step_cache()      # graphs of the serve phase hold its params
    torch_cuda_empty()
    t0 = time.perf_counter()
    runs = [dense_model_phase(arch) for arch in DENSE_ARCHS]
    cli = dense_cli_phase()
    print(f"dense: {len(runs)} configs and the serve CLI in "
          f"{time.perf_counter() - t0:.1f}s")
    return {"runs": runs, "cli": cli}


# ---------------------------------------------------------------------------
# the MoE family
# ---------------------------------------------------------------------------

MOE_ARCH = "qwen2-moe-a2.7b"
# the serve CLI on qwen2-moe-a2.7b: the dense CLI's flags (paged bf16
# cache, prompts of 32 sharing their first block, 10/s)
MOE_SERVE_ARGS = ["--arch", MOE_ARCH] + DENSE_SERVE_ARGS[2:]
MOE_CLI_COMPARE = 4         # requests of the CLI run held to the reference
MOE_ROUTE_ROWS = 16         # rows of the routing check's batch
# the parts of a tick's device time, by kernel name (the first that
# matches): "the rest" is the norms, elementwise ops and copies, and on the
# bf16 cache its attention, which is plain PyTorch there
MOE_TICK_PARTS = {
    "experts' GEMVs": ("qmatmul_w8a16_experts_kernel",),
    "other GEMVs": ("qmatmul_w8a16_kernel",),
    "decode attention kernels": ("decode_attention",),
    "sort, softmax, scan, index and gather (routing, cache writes)": (
        "sort", "softmax", "scan", "index", "gather", "scatter")}


def moe_curve_rows() -> tuple:
    """The experts' stacked GEMV's rows in the serve CLI's curve: each of
    the curve's b rows of SERVE_SEQ tokens gives every expert its
    capacity's rows, ceil(SERVE_SEQ * k / E * capacity_factor) = 3 at
    qwen2-moe-a2.7b, so M = 3, 12 and 48 at b = 1, 4 and 16."""
    from repro_torch.configs import get_config

    c = get_config(MOE_ARCH)
    cap = math.ceil(SERVE_SEQ * c.top_k / c.n_experts * c.capacity_factor)
    return tuple(b * cap for b in (1, 4, SERVE_MAX_BATCH))


def moe_qmatmul_rows(flush):
    """qmatmul_w8a16 at qwen2-moe-a2.7b's shapes: the experts' stacked GEMV
    over its 60 experts (w_gate with the silu drain, w_up, w_down) at a
    tick's 8 rows each and at the serve CLI curve's rows
    (``moe_curve_rows``: 3, 12 and 48, the last six 8-row slabs), and
    the 2-D GEMV for the router (2048 x 60, f32 x and out) at 8 rows.
    Each held against its plain version (bf16_close), every row bitwise
    alone and in its batch; at 8 rows a stack of one bitwise the 2-D
    GEMV on that expert; at 8 rows (the tick) and at the curve's largest
    (its b = 16 forward) timed beside the plain version, its library
    call (``torch.bmm`` on the bf16-dequantized experts; ``F.linear``
    for the router) and the bound (bytes at 3.35 TB/s).  Returns (worst
    error, {name: tick numbers}, {name: forward numbers})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import qmatmul as K

    c = get_config(MOE_ARCH)
    e, m = c.n_experts, NUM_SLOTS
    curve = moe_curve_rows()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    rows, fwd, worst = {}, {}, 0.0
    for name, k, n, act in (("w_gate", c.d_model, c.d_ff, "silu"),
                            ("w_up", c.d_model, c.d_ff, "none"),
                            ("w_down", c.d_ff, c.d_model, "none")):
        q = quantize_weight(torch.randn((e, k, n), generator=gen,
                                        device="cuda") * k ** -0.5)
        w, ws = q.values, q.scale
        kw = dict(activation=act, out_dtype=torch.bfloat16)
        wd = (w.float() * ws).to(torch.bfloat16)
        plan = K.gemv_experts_plan(e, k, n)
        for mm in (m,) + curve:
            x = torch.randn((e, mm, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            out = K.qmatmul_w8a16_experts(x, w, ws, **kw)
            ref = K.qmatmul_w8a16_experts_ref(x, w, ws, **kw)
            torch.cuda.synchronize()
            if out.shape != ref.shape or not torch.isfinite(out).all():
                raise AssertionError(f"moe experts {name} M={mm}: bad output")
            err, ratio = bf16_close(out, ref, f32_out=False)
            if ratio > 1.0:
                raise AssertionError(f"moe experts {name} M={mm}: the "
                                     f"stacked GEMV disagrees with its plain "
                                     f"version (err/tol={ratio:.3f})")
            for r in range(mm):
                one = K.qmatmul_w8a16_experts(x[:, r:r + 1].contiguous(), w,
                                              ws, **kw)
                if not torch.equal(one[:, 0], out[:, r]):
                    raise AssertionError(f"moe experts {name} M={mm}: row "
                                         f"{r} differs launched alone")
            if mm == m:
                one = K.qmatmul_w8a16_experts(x[:1], w[:1], ws[:1], **kw)
                if not torch.equal(one[0], K.qmatmul_w8a16(
                        x[0], w[0], ws[0].reshape(-1).contiguous(), **kw)):
                    raise AssertionError(f"moe experts {name}: a stack of "
                                         f"one is not the 2-D GEMV's launch")
            worst = max(worst, err)
            print(f"  qmatmul_w8a16_experts {name:6s} E={e} M={mm:2d} "
                  f"K={k:5d} N={n:5d} act={act:4s} max_abs_err={err:.3e} "
                  f"err/tol={ratio:.3f}; every row bitwise alone")
            if mm not in (m, curve[-1]):
                continue
            ms = time_ms(lambda: K.qmatmul_w8a16_experts(x, w, ws, **kw), 20,
                         flush)
            plain = time_ms(lambda: K.qmatmul_w8a16_experts_ref(x, w, ws,
                                                                **kw),
                            1, flush)
            lib = time_ms(lambda: torch.bmm(x, wd), 20, flush)
            nbytes = (x.numel() * 2 + w.numel() + ws.numel() * 4
                      + e * mm * n * 2)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * e * mm * k * n / BF16_OPS_PER_S * 1e3
            (rows if mm == m else fwd)[name] = {
                "E": e, "M": mm, "K": k, "N": n, "activation": act,
                "ms": ms, "plain_ms": plain,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": ("bytes" if bytes_ms >= ops_ms
                             else "operations"),
                "library_ms": lib, "max_abs_err": err}
            print(f"  qmatmul_w8a16_experts {name:6s} E={e} M={mm:2d} "
                  f"ms={ms:.4f} plain_ms={plain:.4f} bmm_ms={lib:.4f} "
                  f"bound_ms={max(bytes_ms, ops_ms):.4f} "
                  f"({nbytes / ms / 1e6:.0f} GB/s; plan {plan.strips} strips "
                  f"x {plan.splits} splits x {e} experts)")
            del x, out, ref
        del q, w, ws, wd
    # the router: the 2-D GEMV at N = 60 (one ragged strip), f32 x and out
    q = quantize_weight(torch.randn((c.d_model, e), generator=gen,
                                    device="cuda") * c.d_model ** -0.5)
    w, ws = q.values, q.scale.reshape(-1).contiguous()
    x = torch.randn((2 * m, c.d_model), generator=gen, device="cuda")
    gemv_rows_check("router", x, w, ws, None, "none", torch.float32)
    x = x[:m].contiguous()
    out = K.qmatmul_w8a16(x, w, ws, out_dtype=torch.float32)
    err, ratio = bf16_close(out, K.qmatmul_w8a16_ref(
        x, w, ws, out_dtype=torch.float32), f32_out=True)
    if ratio > 1.0:
        raise AssertionError(f"moe router: the GEMV disagrees with its "
                             f"plain version (err/tol={ratio:.3f})")
    worst = max(worst, err)
    ms = time_ms(lambda: K.qmatmul_w8a16(x, w, ws, out_dtype=torch.float32),
                 20, flush)
    plain = time_ms(lambda: K.qmatmul_w8a16_ref(
        x, w, ws, out_dtype=torch.float32), 3, flush)
    wf = w.float() * ws
    lib = time_ms(lambda: F.linear(x, wf.t()), 20, flush)
    nbytes = x.numel() * 4 + w.numel() + ws.numel() * 4 + m * e * 4
    rows["router"] = {"E": 1, "M": m, "K": c.d_model, "N": e,
                      "activation": "none", "ms": ms, "plain_ms": plain,
                      "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes", "library_ms": lib,
                      "max_abs_err": err}
    print(f"  qmatmul_w8a16 router K={c.d_model} N={e} f32 x/out "
          f"max_abs_err={err:.3e} err/tol={ratio:.3f} ms={ms:.4f} "
          f"plain_ms={plain:.4f} library_ms={lib:.4f} bound_ms="
          f"{rows['router']['bound_ms']:.5f}; rows of M = {m} and {2 * m} "
          f"launches equal to the rows alone")
    print(f"  qmatmul_w8a16_experts at qwen2-moe-a2.7b's shapes (M = {m} "
          f"and {', '.join(map(str, curve))}): within bf16_close, every row "
          f"bitwise alone and in its batch, a stack of one bitwise the 2-D "
          f"GEMV")
    zero_counts()
    return worst, rows, fwd


def moe_route_rows() -> None:
    """The MoE router's softmax over 60, its stable top-4 and the
    renormalisation on the card: every row of a 16-row batch bitwise the
    row routed alone; a tie goes to the lower expert index."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_weight
    from repro_torch.models import moe as M

    c = get_config(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    router = {"w": quantize_weight(torch.randn(
        (c.d_model, c.n_experts), generator=gen, device="cuda")
        * c.d_model ** -0.5)}
    x = torch.randn((MOE_ROUTE_ROWS, 1, c.d_model), generator=gen,
                    device="cuda").to(torch.bfloat16)
    top_p, top_e = M.route(router, x, c.top_k)
    for r in range(MOE_ROUTE_ROWS):
        p1, e1 = M.route(router, x[r:r + 1], c.top_k)
        if not (torch.equal(p1[0], top_p[r]) and torch.equal(e1[0],
                                                             top_e[r])):
            raise AssertionError(f"moe routing: row {r} differs routed "
                                 f"alone")
    _, ties = M.route({"w": torch.zeros((c.d_model, c.n_experts),
                                        device="cuda")}, x, c.top_k)
    if not (ties == torch.arange(c.top_k, device="cuda")).all():
        raise AssertionError(f"moe routing: ties not to the lower index: "
                             f"{ties[0].tolist()}")
    print(f"moe routing: softmax over {c.n_experts}, stable top-{c.top_k} "
          f"and the renormalisation: every row of {MOE_ROUTE_ROWS} bitwise "
          f"the row routed alone; ties to the lower index")


def moe_tick(cfg, params, label):
    """The captured steady tick of the MoE serves (NUM_SLOTS rows at
    DENSE_MAX_SEQ / 2 of the config's cache): its launches per replay (the
    GEMV 8 a layer and the head, the experts' stack 3 a layer), wall,
    device busy and torch.profiler's split (MOE_TICK_PARTS), beside two
    floors at 3.35 TB/s: the int8 weights the tick reads (every expert,
    the reference's formulation) and those its tokens route to (each
    layer's distinct experts, counted on the tick's own routing)."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.core.quant import tree_weight_bytes
    from repro_torch.models import moe as M
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    S, max_seq = NUM_SLOTS, DENSE_MAX_SEQ
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(
        cfg, mode=W8A16))
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    with torch.inference_mode():
        cache = R.init_cache(cfg, S, max_seq, device="cuda")
        toks = torch.randint(1, cfg.vocab, (S, 1), generator=g,
                             device="cuda", dtype=torch.int32)
        idx = torch.full((S,), max_seq // 2, dtype=torch.int32,
                         device="cuda")
        active = torch.ones((S,), dtype=torch.bool, device="cuda")
        # the tick's routing, from an eager step on a copy of the cache
        chosen = []
        real_route = M.route

        def route(router, x, k):
            out = real_route(router, x, k)
            chosen.append(out[1].reshape(-1))
            return out

        M.route = route
        try:
            ST.make_slot_decode_step(cfg, mode=W8A16)(
                params, toks, {k: v.clone() for k, v in cache.items()},
                idx, active)
        finally:
            M.route = real_route
        routed = [len(set(c.tolist())) for c in chosen]
        t0 = time.perf_counter()
        graphed(params, toks, cache, idx, active)[0].cpu()
        capture_s = time.perf_counter() - t0
        zero_counts()
        graphed(params, toks, cache, idx, active)[0].cpu()
    launches, plain = read_counts()
    gemv = gemvs_per_layer(cfg) * cfg.n_layers + 1
    if (launches["qmatmul_w8a16[gemv]"] != gemv
            or launches["qmatmul_w8a16_experts"] != 3 * cfg.n_layers
            or any(plain.values())):
        raise AssertionError(f"{label}: a replay launched {launches} ({gemv} "
                             f"GEMVs, {3 * cfg.n_layers} stacks expected), "
                             f"plain {plain}")
    res = device_breakdown(
        label, f"captured steady-state slot tick ({S} active rows at "
        f"position {max_seq // 2} of {max_seq}, "
        f"{'int8' if cfg.kv_quant else 'bf16'} cache)",
        lambda: graphed(params, toks, cache, idx, active)[0].cpu(), 10)
    read = tree_weight_bytes(params)
    stack = sum(tree_weight_bytes(lp["moe"]["experts"])
                for lp in params["layers"])
    per_expert = stack / cfg.n_layers / cfg.n_experts
    routed_bytes = read - stack + sum(routed) * per_expert
    floor = read / HBM_BYTES_PER_S * 1e3
    routed_floor = routed_bytes / HBM_BYTES_PER_S * 1e3
    split = dict.fromkeys(MOE_TICK_PARTS, 0.0)
    for key, ms in res["by_kernel"].items():
        part = next((p for p, names in MOE_TICK_PARTS.items()
                     if any(n in key.lower() for n in names)), "the rest")
        split[part] = split.get(part, 0.0) + ms
    busy = res["busy"]
    print(f"{label}: {launches['qmatmul_w8a16[gemv]']} GEMVs and "
          f"{launches['qmatmul_w8a16_experts']} expert stacks a replay; "
          f"capture {capture_s:.2f} s; wall {res['wall']:.2f} ms, device "
          f"busy {'not measured' if busy is None else f'{busy:.3f} ms'}, "
          f"cudaGraphLaunch {res['graph_launches']:.0f}, cudaLaunchKernel "
          f"{res['launch_calls']:.0f} a tick; device time by part: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    print(f"{label}: floors at 3.35 TB/s: {floor:.3f} ms (the {read} bytes "
          f"of int8 weights the tick reads, every expert) and "
          f"{routed_floor:.3f} ms (the {routed_bytes:.0f} bytes its tokens "
          f"route to: {sum(routed) / cfg.n_layers:.1f} of {cfg.n_experts} "
          f"experts a layer on average); wall / floor "
          f"{res['wall'] / floor:.2f} and {res['wall'] / routed_floor:.2f}")
    graphed.captured.release()
    return {"wall": res["wall"], "busy": busy, "split": split,
            "floor": floor, "routed_floor": routed_floor}


def moe_cli_phase():
    """The serve CLI at full qwen2-moe-a2.7b width (MOE_SERVE_ARGS, the
    paged bf16 cache): exit 0, the service curve's forward on the mma
    path but for each layer's router (the GEMV), the experts' stacked
    GEMV and flash attention (H = 16), the captured forward bitwise the
    eager one at each curve batch (tokens dropped at capacity 3 of 32
    tokens), no block leaked, and MOE_CLI_COMPARE requests (the first to
    share the prefix block among them) equal to ``reference_outputs``."""
    from repro_torch.launch import serve

    real_curve = serve.measure_service_curve
    curve_paths = {}
    serve.measure_service_curve = counted_curve(real_curve, curve_paths)
    label = f"serve {MOE_ARCH} paged"
    try:
        launches, res = serve_run("w8a16", curve_paths, base=MOE_SERVE_ARGS,
                                  label=label)
    finally:
        serve.measure_service_curve = real_curve
    rep = res.report
    if launches["qmatmul_w8a16_experts"] <= 0 or rep.leaked_blocks:
        raise AssertionError(f"{label}: launches {launches}, "
                             f"{rep.leaked_blocks} leaked blocks")
    sharers = [r.rid for r in rep.results if r.shared_blocks]
    rids = sharers[:1] + [r.rid for r in rep.results
                          if r.rid not in sharers[:1]]
    rids = set(rids[:MOE_CLI_COMPARE])
    compare_with_reference(label, res.cfg, res.params, res.engine,
                           [r for r in res.requests if r.rid in rids],
                           rep.outputs())
    del res
    torch_cuda_empty()
    return launches


def moe_phase(flush):
    """qwen2-moe-a2.7b at full width: the kernel rows at its shapes and
    the routing check, then the model from the streamed init (its peak
    under PEAK_BYTES), a contiguous bf16 serve held to
    ``reference_outputs``, a paged one held to it, an int8-cache serve
    held to ``reference_outputs``, the captured chunk pass bitwise the
    per-token steps (bf16 contiguous, int8 paged), the captured steady
    tick on each cache against its two floors, then the serve CLI.  Returns the kernel
    rows and the launches of each run."""
    import torch
    from repro_torch import engine as E
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    print(f"moe: the kernels at {MOE_ARCH}'s shapes")
    err, rows, fwd_rows = moe_qmatmul_rows(flush)
    moe_route_rows()
    ST.clear_step_cache()
    torch_cuda_empty()
    cfg, params = build_dense_model(MOE_ARCH)
    reqs = E.synthetic_requests(
        DENSE_REQUESTS, rate_per_s=DENSE_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=DENSE_PROMPT, max_new_tokens=DENSE_NEW,
        shared_prefix_len=DENSE_SHARED, seed=SEED)
    out = {"rows": rows, "forward_rows": fwd_rows, "max_abs_err": err}
    label = f"moe {MOE_ARCH}"
    eng, rep, out["launches"] = dense_serve(f"{label} contiguous", cfg,
                                            params, reqs)
    compare_with_reference(f"{label} contiguous", cfg, params, eng, reqs,
                           rep.outputs())
    contig = rep.outputs()
    del eng
    out["spec_launches"] = moe_spec_serve(label, cfg, params, reqs, contig)
    eng, rep, _ = dense_serve(f"{label} paged", cfg, params, reqs,
                              block_size=DENSE_BLOCK,
                              num_blocks=DENSE_NUM_BLOCKS)
    print(f"{label} paged: block_size {rep.block_size}, num_blocks "
          f"{rep.num_blocks}, peak_blocks_used {rep.peak_blocks_used}, "
          f"leaked_blocks {rep.leaked_blocks}, shared_block_hits "
          f"{rep.shared_block_hits}")
    if rep.outputs() != contig or rep.leaked_blocks:
        raise AssertionError(f"{label} paged: tokens differ from the "
                             f"contiguous serve's, or {rep.leaked_blocks} "
                             f"blocks leaked")
    print(f"{label} paged: every token of {len(contig)} requests equal to "
          f"the contiguous serve's")
    del eng
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    eng, rep, out["int8_launches"] = dense_serve(f"{label} int8 cache", qcfg,
                                                 params, reqs)
    compare_with_reference(f"{label} int8 cache", qcfg, params, eng, reqs,
                           rep.outputs())
    del eng
    ST.clear_step_cache()
    torch_cuda_empty()
    graph_chunk_case(cfg, params, f"{label} chunk", NUM_SLOTS,
                     DENSE_MAX_SEQ, 0, "w8a16", False, 3, 13)
    graph_chunk_case(cfg, params, f"{label} paged int8 chunk", NUM_SLOTS,
                     DENSE_MAX_SEQ, DENSE_BLOCK, "w8a16", True, 3, 5)
    out["tick"] = moe_tick(cfg, params, f"{label} tick")
    out["int8_tick"] = moe_tick(qcfg, params, f"{label} int8 tick")
    ST.clear_step_cache()
    del params
    torch_cuda_empty()
    out["cli"] = moe_cli_phase()
    ST.clear_step_cache()           # the CLI engine's graphs hold its params
    torch_cuda_empty()
    print(f"moe: phase {time.perf_counter() - t0:.1f}s; "
          f"{torch.cuda.memory_allocated()} bytes left allocated")
    return out


PHASES = ("attention", "long_tick", "w8a8", "graphs", "dense", "sampling",
          "spec", "moe")


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the directory holding repro_torch (default: the "
                         "checkout's src/); another checkout's src/ runs "
                         "its kernels under this script's phases")
    ap.add_argument("--only", choices=PHASES, action="append",
                    help="run only this phase (repeatable): the two decode "
                         "attention kernel phases, the long-context ticks, "
                         "qmatmul_w8a8's kernel phase and the W8A8 tick, "
                         "the five eager tick breakdowns and the graph "
                         "phase, the dense family at full width, "
                         "sampling (the PRNG, the sampled serves, tick and "
                         "loop, mistral-nemo-12b and the CLI sampled), "
                         "speculation (starcoder2-3b's speculative serves "
                         "and steps, the CLI with --spec-k, "
                         "qwen2-moe-a2.7b's speculative serve), or "
                         "the MoE family (qwen2-moe-a2.7b's kernel rows, "
                         "serves, chunk pass, tick and CLI); prints no "
                         "result line")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    t_run = time.perf_counter()
    args = parse_args(sys.argv[1:] if argv is None else argv)
    try:
        import torch
    except ImportError:
        return fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    src = args.src.resolve()
    if not (src / "repro_torch").is_dir():
        return fail(f"the port's sources are missing under {src}")
    sys.path.insert(0, str(src))
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    print(smi[0])
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {kind}")

    t0 = time.perf_counter()
    reports = _build.build(list(KERNELS))
    print(f"build: {len(reports)} kernels compiled from the repo's sources "
          f"in {time.perf_counter() - t0:.1f}s")
    for name, log in reports.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                print(f"  {name}: {line.strip()}")

    # the flush READS a buffer larger than L2: a write would leave dirty
    # lines whose write-back the next timed kernel would pay for
    flush_buf = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                           device="cuda")
    flush = flush_buf.max
    warm = torch.randn((4096, 4096), device="cuda")
    for _ in range(200):                  # bring the clocks up before timing
        warm @ warm
    torch.cuda.synchronize()
    del warm
    max_seq = PROMPT_LEN + MAX_NEW
    if args.only:
        print(f"partial run of {src}: {', '.join(args.only)}")
        if "attention" in args.only:
            attention_phase(flush, max_seq + (-max_seq) % 16)
            paged_attention_phase(flush)
        if "w8a8" in args.only:
            qmatmul_w8a8_phase(flush)
        if "dense" in args.only:
            dense_kernel_rows(flush)
        warnings.filterwarnings("ignore", message=".*straggler.*")
        if "dense" in args.only:
            rmsnorm_phase(RMSNORM_WIDTHS[1:])
            dense_phase()
        if {"long_tick", "w8a8", "graphs", "sampling", "spec"} & set(
                args.only):
            cfg, params = build_model()
        if "graphs" in args.only:
            tick_breakdown(cfg, params, NUM_SLOTS, PROMPT_LEN + MAX_NEW)
            tick_breakdown(cfg, params, NUM_SLOTS,
                           PAGED_PROMPT_LEN + MAX_NEW, PAGED_BLOCK,
                           label="paged tick")
        if {"long_tick", "graphs"} & set(args.only):
            long_tick_phase(cfg, params)
        if {"w8a8", "graphs"} & set(args.only):
            w8a8_tick_phase(cfg, params)
        if "graphs" in args.only:
            graph_phase(cfg, params)
        if "sampling" in args.only:
            sampling_phase(cfg, params)
        if "spec" in args.only:
            spec_phase(cfg, params)
        if {"sampling", "spec"} & set(args.only):
            from repro_torch.launch import serve
            from repro_torch.runtime import steps as ST
            ST.clear_step_cache()
            del params
            torch_cuda_empty()
            if "sampling" in args.only:
                sampled_dense_phase()
            real_curve, curve_paths = serve.measure_service_curve, {}
            serve.measure_service_curve = counted_curve(real_curve,
                                                        curve_paths)
            try:
                if "sampling" in args.only:
                    sampled_cli_run(curve_paths)
                if "spec" in args.only:
                    spec_cli_run(curve_paths)
            finally:
                serve.measure_service_curve = real_curve
        if "spec" in args.only and "moe" not in args.only:
            spec_moe_only()             # the MoE phase runs it otherwise
        if "moe" in args.only:          # last, as in the whole run
            from repro_torch.runtime import steps as ST
            ST.clear_step_cache()       # starcoder's graphs and weights go
            params = None               # first, as in the whole run
            torch_cuda_empty()
            moe_phase(flush)
        del flush_buf
        print(f"chip_smoke: partial run passed in "
              f"{time.perf_counter() - t_run:.1f}s; no result line")
        return 0
    print("kernels: each CUDA kernel against its plain version on the card")
    q_err, q_paths = qmatmul_phase(flush)
    a_err, a_tick, a_long = attention_phase(flush,
                                            max_seq + (-max_seq) % 16)
    p_err, p_tick, p_long = paged_attention_phase(flush)
    w8_err, w8_fwd, w8_lib, w8_ticks = qmatmul_w8a8_phase(flush)
    f_err, f_fwd = flash_phase(flush)
    dense_rows = dense_kernel_rows(flush)
    rmsnorm_phase()

    # the tick watchdog flags chunked-prefill ticks as stragglers; they
    # are counted in the report (stuck_ticks) rather than printed
    warnings.filterwarnings("ignore", message=".*straggler.*")
    cfg, params = build_model()
    launches = slice_phase(cfg, params)
    paged_launches = paged_slice_phase(cfg, params)
    overload_phase(cfg, params)
    long_tick_phase(cfg, params)
    w8a8_tick_phase(cfg, params)
    graph_phase(cfg, params)
    sampling_phase(cfg, params)
    spec = spec_phase(cfg, params)
    from repro_torch.runtime import steps as ST
    ST.clear_step_cache()           # the engines' captured tick and cache
    del params
    torch_cuda_empty()
    sampled_dense_phase()
    serve_launches = serve_phase()
    dense = dense_phase()
    moe = moe_phase(flush)
    del flush_buf

    tick_basis = (f"one {{}} of {NUM_SLOTS} rows at full width: the sum "
                  f"over that tick's launches")
    fwd_basis = (f"one full-width forward of {SERVE_MAX_BATCH} x "
                 f"{SERVE_SEQ} tokens (the service curve's largest "
                 f"prefill): the sum over its launches")
    flash_runs = sum(serve_launches[quant]["flash_attention_bhsd"]
                     for quant in ("w8a16", "w8a8"))

    def numbers(t):
        return {"ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"],
                "bound_by": ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                             else "operations"),
                "library_ms": t["library_ms"]}

    # qmatmul_w8a16's row carries both paths: the GEMV on the slot tick
    # (its main fields) and the mma path on the service curve's forward
    w8a16_paths = {
        "gemv": {**numbers(q_paths["gemv"][0]),
                 "launches": launches["qmatmul_w8a16[gemv]"],
                 "basis": tick_basis.format("slot tick")},
        "mma": {**numbers(q_paths["mma"][1]),
                "launches": serve_launches["w8a16"]["curve_mma"],
                "basis": f"{fwd_basis}; library F.linear on bf16 weights; "
                         f"launches: the w8a16 serve run's service curve"}}
    kernels = []
    for name, err, tick, n, basis in (
            ("qmatmul_w8a16", q_err, q_paths["gemv"][0],
             launches["qmatmul_w8a16"], tick_basis.format("slot tick")),
            ("decode_attention_int8", a_err, a_tick,
             launches["decode_attention_int8"],
             tick_basis.format("slot tick")),
            ("decode_attention_int8_paged", p_err, p_tick,
             paged_launches["decode_attention_int8_paged"],
             tick_basis.format("paged slot tick")),
            ("qmatmul_w8a8", w8_err, w8_fwd,
             serve_launches["w8a8"]["qmatmul_w8a8"],
             f"{fwd_basis}; library {w8_lib}; launches: the w8a8 serve "
             f"run"),
            ("flash_attention_bhsd", f_err, f_fwd, flash_runs,
             f"{fwd_basis}; library SDPA (is_causal); launches: the w8a16 "
             f"and w8a8 serve runs")):
        kernels.append({
            "name": name, "route": "cuda", **KERNELS[name],
            "launches": n, "max_abs_err": err, **numbers(tick),
            "basis": basis})
    kernels[0]["paths"] = w8a16_paths
    kernels[3]["ticks"] = {
        f"M={m}": {**numbers(t), "basis": f"one slot tick of {m} rows at "
                   f"full width (30 layers x 6 projections): the sum over "
                   f"its launches"} for m, t in w8_ticks.items()}
    for row, t in ((kernels[1], a_long), (kernels[2], p_long)):
        row["long_context"] = {
            **numbers(t), "basis": f"one launch of {NUM_SLOTS} rows of "
            f"valid_len {LONG_VALID} ({LONG_SLOTS}-slot rows)"}
    # the dense family's rows: each kernel at the other dense configs'
    # shapes, and its launches in their runs
    runs = {run["arch"]: run for run in dense["runs"]}
    qwen = runs["qwen1.5-32b"]["int8_launches"]
    q_dense_err, q_dense = dense_rows["qmatmul"]
    a_dense_err, a_dense, p_dense = dense_rows["attention"]
    kernels[0]["dense"] = {
        **q_dense, "max_abs_err": q_dense_err,
        "launches": {arch: run["launches"]["qmatmul_w8a16"]
                     for arch, run in runs.items()},
        "basis": f"one launch of {NUM_SLOTS} rows at each shape (GEMV in "
                 f"ms, the mma path in mma_ms); launches: each config's "
                 f"contiguous bf16 serve"}
    for row, dense_t, name in ((kernels[1], a_dense, "decode_attention_int8"),
                               (kernels[2], p_dense,
                                "decode_attention_int8_paged")):
        row["dense"] = {
            **{key: {**numbers(t), "max_abs_err": t["max_abs_err"]}
               for key, t in dense_t.items()},
            "max_abs_err": a_dense_err, "launches": qwen[name],
            "basis": f"one launch of {NUM_SLOTS} ragged rows of "
                     f"{DENSE_MAX_SEQ} slots at each (KV, G); launches: "
                     f"qwen1.5-32b's int8-cache serve (G = 1)"}
    kernels[4]["dense"] = {"launches": dense["cli"]["flash_attention_bhsd"],
                           "basis": "the serve CLI's run on mistral-nemo-12b "
                                    "(H = 32)"}
    # the MoE family: qmatmul_w8a16's expert-stacked entry (one layer's
    # three stacks summed), the router's 2-D GEMV among its shapes
    def layer_sum(by_name):
        stacks = [by_name[name] for name in ("w_gate", "w_up", "w_down")]
        sums = {key: sum(t[key] for t in stacks)
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
        return {**sums, "bound_by": (
            "bytes" if all(t["bound_by"] == "bytes" for t in stacks)
            else "operations")}

    fwd_m = moe_curve_rows()[-1]
    kernels[0]["experts"] = {
        **layer_sum(moe["rows"]), "max_abs_err": moe["max_abs_err"],
        "launches": moe["launches"]["qmatmul_w8a16_experts"],
        "shapes": moe["rows"],
        "forward": {**layer_sum(moe["forward_rows"]),
                    "shapes": moe["forward_rows"],
                    "basis": f"one MoE layer's three stacked launches at "
                             f"{fwd_m} rows an expert (the serve CLI "
                             f"curve's {SERVE_MAX_BATCH} x {SERVE_SEQ}-token "
                             f"forward), summed"},
        "basis": f"one MoE layer's three stacked launches over "
                 f"{MOE_ARCH}'s 60 experts x {NUM_SLOTS} rows (a tick), "
                 f"summed; library torch.bmm on bf16-dequantized experts; "
                 f"launches: the contiguous bf16 serve"}
    kernels[1]["moe"] = {
        "launches": moe["int8_launches"]["decode_attention_int8"],
        "basis": f"{MOE_ARCH}'s int8-cache serve (KV 16, G 1)"}
    kernels[2]["moe"] = {
        "launches": moe["int8_launches"]["decode_attention_int8_paged"],
        "basis": f"{MOE_ARCH}'s int8-cache serve's chunk passes"}
    kernels[4]["moe"] = {"launches": moe["cli"]["flash_attention_bhsd"],
                         "basis": f"the serve CLI's run on {MOE_ARCH} "
                                  f"(H = 16)"}
    # speculation (k = SPEC_K, the 1-layer self-draft): the launches of
    # each kernel in the speculative serves and the speculative CLI run
    spec_basis = (f"k = {SPEC_K}, {SPEC_DRAFT_LAYERS}-layer self-draft, "
                  f"starcoder2-3b")
    kernels[0]["spec"] = {
        "launches": spec["greedy"]["qmatmul_w8a16"],
        "experts_launches": moe["spec_launches"]["qmatmul_w8a16_experts"],
        "basis": f"the contiguous slice's trace served speculating "
                 f"({spec_basis}); experts: {MOE_ARCH}'s speculative "
                 f"serve"}
    kernels[1]["spec"] = {"launches": spec["greedy"]["decode_attention_int8"],
                          "basis": f"the contiguous slice's trace served "
                                   f"speculating ({spec_basis})"}
    kernels[2]["spec"] = {
        "launches": spec["paged"]["decode_attention_int8_paged"],
        "basis": f"the paged slice's geometry at {SPEC_PAGED_RATE_PER_S:g}/s "
                 f"served speculating ({spec_basis})"}
    kernels[4]["spec"] = {
        "launches": serve_launches["spec"]["flash_attention_bhsd"],
        "basis": f"the serve CLI's run with --spec-k {SPEC_K} "
                 f"--draft-layers {SPEC_DRAFT_LAYERS}"}
    if min(kernels[i]["spec"]["launches"] for i in (0, 1, 2, 4)) <= 0 or \
            kernels[0]["spec"]["experts_launches"] <= 0:
        return fail("a kernel of a speculative path never launched")
    if min(kernels[0]["experts"]["launches"], kernels[1]["moe"]["launches"],
           kernels[2]["moe"]["launches"], kernels[4]["moe"]["launches"]) <= 0:
        return fail("a kernel of the MoE path never launched")
    if any(not math.isfinite(t[key]) for t in (
            *moe["rows"].values(), *moe["forward_rows"].values())
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")):
        return fail("an MoE kernel row is not finite")
    dense_numbers = list(q_dense.values()) + [
        t for d in (a_dense, p_dense) for t in d.values()]
    if any(not math.isfinite(t[key]) for t in dense_numbers
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")):
        return fail("a dense kernel row is not finite")
    if min(qwen["decode_attention_int8"], qwen["decode_attention_int8_paged"],
           dense["cli"]["flash_attention_bhsd"]) <= 0:
        return fail("a kernel of a dense path never launched")
    for k in kernels + list(w8a16_paths.values()):
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if not math.isfinite(k[key]):
                return fail(f"{k.get('name', 'qmatmul_w8a16 path')}: {key} "
                            f"is not finite")
        if k["launches"] <= 0:
            return fail(f"{k.get('name', 'qmatmul_w8a16 path')}: no launch "
                        f"on its path")
    print(json.dumps({"kernels": kernels}))
    print(f"chip_smoke: whole run {time.perf_counter() - t_run:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
