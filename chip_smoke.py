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
   are reused, every tick a replay of the slot step captured as a CUDA
   graph — with the kernels' launch counters zeroed just before and
   read just after (no launch of qmatmul_w8a16's mma path); then three
   requests compared with the sequential ``reference_outputs`` on the
   card;
4. paged slice: the same model served from the paged KV cache
   (``Engine(block_size=16, num_blocks=25)``, 24 requests sharing a
   16-token prompt prefix), counters zeroed just before and read just
   after (again no mma launch); prefix blocks must be shared, none leaked,
   and three requests (one that shared) equal the contiguous sequential
   reference; then the steady tick at a long context (``max_seq`` 4,096,
   8 rows at 2,048), contiguous and paged, with the decode attention
   kernels' share of its device time, and the steady tick under W8A8 at
   16 slots, with ``qmatmul_w8a8``'s share (these breakdowns run the
   eager step);
5. graphs: each of those five ticks eager against the captured step
   (``runtime/steps.py::jit_slot_decode_step``) on two copies of one
   randomly filled cache, over four ticks with a row retiring and one
   admitted (paged: a table row changed): next tokens, indices and every
   cache leaf ``torch.equal``, the kernel counts of a replay equal to the
   eager tick's; then the captured steady tick's wall, device busy and
   ``cudaLaunchKernel`` / ``cudaGraphLaunch`` calls beside the eager
   tick's of this run, its wall required below the eager one; the
   serve CLI's decode loop (batch 16, 16 tokens, ``max_seq`` 32, bf16
   cache) under w8a16 and w8a8, captured (``jit_decode_loop``) against
   eager at starts 0 and 5, with tok/s of both; and the workspace a
   capture holds: the 8-row tick, captured first, replays equal to the
   eager tick after the 16-row captures grew the capture stream's
   workspace, with every arrival counter back at 0;
6. serve: the serve launcher (``repro_torch.launch.serve.run``) at full
   starcoder2-3b width with the bf16 KV cache, once with ``--quant w8a16``
   and once with ``--quant w8a8``: the service curve through the
   full-sequence forward (flash attention; under w8a16 every
   qmatmul_w8a16 launch of it on the mma path, counted around the curve
   alone), the Table 4 batch choice, the decode loop and a wall-clock
   ``Engine.serve`` (no mma launch in either; the loop and the engine's
   tick captured as CUDA graphs), counters zeroed just
   before each run and read just after, then where one 16 x 32-token
   prefill spends its time; the w8a16 run's first three requests are
   compared with ``reference_outputs`` (bf16 cache) on the card.

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
edges.  Then ``rmsnorm``'s rows at d = 3072 are checked bitwise at B = 1,
8 and 16.  The tick breakdowns check that a tick launches 181
``qmatmul_w8a16`` GEMVs (under W8A8, at 16 slots: 180 ``qmatmul_w8a8``
launches and the LM head's GEMV) and no more ``cudaLaunchKernel`` calls
than before the redesigns.

``--only attention`` / ``--only long_tick`` / ``--only w8a8`` / ``--only
graphs`` run just the two attention kernel phases, the long-context
ticks, ``qmatmul_w8a8``'s kernel phase and the W8A8 tick, or the five
eager tick breakdowns and the graph phase, and ``--src DIR`` takes the port from
another checkout's ``src/`` (so the same phases time a parent commit's
kernels); such a partial run prints no result line.

It prints the card's name and power limit, a JSON line with every
kernel's numbers (qmatmul_w8a16's with both paths under ``paths``, the
attention kernels' long-context case under ``long_context``), and,
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

# the serves before their tick and decode loop were captured as CUDA
# graphs (PERF.md §5: two chip_smoke runs of the commit before the
# capture, NVIDIA H100 80GB HBM3 at 700.00 W), printed beside this run's
BEFORE_GRAPHS = {
    "slice": "96.2 / 49.8 tok/s, p99 7.93 / 15.37 s, TTFT not recorded",
    "paged": "44.3 / 42.5 tok/s, p99 and TTFT not recorded",
    "serve w8a16": "decode loop 549 / 343 tok/s, engine 31.6 / 21.2 tok/s, "
                   "p99 and TTFT not recorded",
    "serve w8a8": "decode loop 355 / 180 tok/s, engine 16.3 / 11.8 tok/s, "
                  "p99 and TTFT not recorded"}

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


def paged_attention_phase(flush):
    """The paged kernel at the paged slice's shapes -- blocks of 16, 4 per
    row (64 positions), the slice's 25-block pool, tables drawn at random
    with trash entries past each row's frontier -- and at the long-context
    case (bs 16, MB 256, 2,049 blocks): against the plain version, bitwise
    against the contiguous kernel on the gathered view, timed beside SDPA
    and the bound; rows bitwise equal alone and in the batch, with 4 and
    with 256 table entries, and at the split's edges."""
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


def rmsnorm_phase() -> None:
    """layers.rmsnorm at d = 3072 (f32 and bf16 x): every row of B = 8 and
    B = 16 calls bit-for-bit equal to the row normalised alone (B = 1); a
    row reduction on the card must not take its layout from the batch."""
    import torch
    from repro_torch.models import layers as L

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    p = {"scale": 1 + 0.1 * torch.randn((3072,), generator=gen,
                                        device="cuda")}
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.randn((16, 3072), generator=gen, device="cuda")
             * 3).to(dtype)
        full = L.rmsnorm(p, x)
        ok = torch.equal(L.rmsnorm(p, x[:8]), full[:8]) and all(
            torch.equal(L.rmsnorm(p, x[i:i + 1])[0], full[i])
            for i in range(16))
        if not ok or not torch.isfinite(full).all():
            raise AssertionError(f"rmsnorm {dtype}: rows of B = 8 / 16 are "
                                 f"not bitwise equal to B = 1")
    print("rmsnorm: d = 3072, f32 and bf16: rows of B = 1, 8 and 16 bitwise "
          "equal")


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------

def build_model():
    """Full-width starcoder2-3b with random weights from SEED, quantized
    to W8A16 on the card."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_tree, tree_weight_bytes
    from repro_torch.models import registry as R

    cfg = dataclasses.replace(get_config("starcoder2-3b"), kv_quant=True)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        params = quantize_tree(R.init(gen, cfg, device="cuda"),
                               min_size=2048)
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
             FA.flash_attention_bhsd),
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


def check_served(label, cfg, rep, reqs) -> None:
    outs = rep.outputs()
    if len(rep.results) != len(reqs):
        raise AssertionError(f"{label}: {len(rep.results)} results for "
                             f"{len(reqs)} requests")
    for r in rep.results:
        toks = outs[r.rid]
        if (r.status != "ok" or len(toks) != MAX_NEW
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


def slice_phase(cfg, params):
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16

    eng = E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                   max_seq=PROMPT_LEN + MAX_NEW,
                   prefill_chunk=PREFILL_CHUNK)
    reqs = E.synthetic_requests(N_REQUESTS, rate_per_s=400.0,
                                vocab=cfg.vocab, prompt_len=PROMPT_LEN,
                                max_new_tokens=MAX_NEW, seed=SEED)
    eng.serve(reqs[:2], clock="wall")              # first-call warm-up

    zero_counts()
    rep = eng.serve(reqs, clock="wall")
    launches, plain_calls = read_counts()
    print(f"slice: served {len(rep.results)} requests in {rep.ticks} ticks, "
          f"{rep.generated_tokens} tokens, wall {rep.wall_s:.3f}s, "
          f"decoded tok/s {rep.generated_tokens / rep.wall_s:.1f}, "
          f"ms/tick {1e3 * rep.wall_s / rep.ticks:.2f}, "
          f"p99 latency {rep.p99_latency_s:.3f}s, "
          f"mean ttft {rep.mean_ttft_s:.3f}s, "
          f"mean occupancy {rep.mean_occupancy:.3f}, "
          f"watchdog stuck ticks {rep.stuck_ticks}")
    print(f"slice: before the captured tick: {BEFORE_GRAPHS['slice']}")
    print(f"slice: kernel launches {launches}, plain-version calls "
          f"{plain_calls}")
    path = ("qmatmul_w8a16", "decode_attention_int8")
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
    eng.serve(reqs[:1], clock="wall")              # first-call warm-up

    zero_counts()
    rep = eng.serve(reqs, clock="wall")
    launches, plain_calls = read_counts()
    print(f"paged: served {len(rep.results)} requests in {rep.ticks} ticks, "
          f"{rep.generated_tokens} tokens, wall {rep.wall_s:.3f}s")
    print(f"paged: decoded tok/s {rep.generated_tokens / rep.wall_s:.1f}")
    print(f"paged: ms/tick {1e3 * rep.wall_s / rep.ticks:.2f}")
    print(f"paged: p99 latency {rep.p99_latency_s:.3f}s")
    print(f"paged: mean ttft {rep.mean_ttft_s:.3f}s")
    print(f"paged: before the captured tick: {BEFORE_GRAPHS['paged']}")
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


def serve_phase():
    """The serve launcher at full width, --quant w8a16 then w8a8 (bf16 KV
    cache), counters zeroed just before each run and read just after.
    qmatmul_w8a16's launches by path are also read around the service
    curve alone: under w8a16 every one of them is on the mma path, and
    the rest of the run (the decode loop and the engine) takes none."""
    from repro_torch.launch import serve

    real_curve = serve.measure_service_curve
    curve_paths = {}

    def curve(*args, **kwargs):
        from repro_torch.kernels import qmatmul as K
        before = dict(K.qmatmul_w8a16.launches_by_path)
        try:
            return real_curve(*args, **kwargs)
        finally:
            for path, n in K.qmatmul_w8a16.launches_by_path.items():
                curve_paths[path] = n - before[path]

    counts = {}
    serve.measure_service_curve = curve
    try:
        for quant in ("w8a16", "w8a8"):
            counts[quant], res = serve_run(quant, curve_paths)
            if quant == "w8a16":
                w8a16 = res           # compared after both runs
            del res
    finally:
        serve.measure_service_curve = real_curve
    compare_with_reference("serve w8a16", w8a16.cfg, w8a16.params,
                           w8a16.engine, w8a16.requests[:N_COMPARE],
                           w8a16.report.outputs())
    del w8a16
    torch_cuda_empty()
    return counts


def serve_run(quant, curve_paths):
    """One serve launcher run, counters zeroed just before and read just
    after, and checked: (its kernel launches, its ServeRun)."""
    from repro_torch.launch import serve

    label = f"serve {quant}"
    print(f"{label}: python -m repro_torch.launch.serve "
          f"{' '.join(SERVE_ARGS)} --quant {quant}")
    t0 = time.perf_counter()
    zero_counts()
    res = serve.run(serve.parse_args(SERVE_ARGS + ["--quant", quant]))
    launches, plain_calls = read_counts()
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
    print(f"{label}: before the captured tick and loop: "
          f"{BEFORE_GRAPHS[label]}")
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
    if quant == "w8a16" and (curve_paths["gemv"] or curve_paths["mma"] <= 0):
        raise AssertionError(f"{label}: the service curve's forward must "
                             f"launch only the mma path: {curve_paths}")
    if quant == "w8a8" and curve_paths["mma"]:
        raise AssertionError(f"{label}: the W8A8 forward took qmatmul_w8a16's "
                             f"mma path: {curve_paths}")
    if rep.failed or rep.dropped or rep.unfinished or len(
            rep.results) != len(res.requests) or any(
            r.status != "ok" for r in rep.results):
        raise AssertionError(f"{label}: a request failed: failed "
                             f"{rep.failed}, dropped {rep.dropped}, "
                             f"unfinished {rep.unfinished}")
    launches["curve_mma"] = curve_paths["mma"]
    forward_breakdown(label, res)
    return launches, res


def torch_cuda_empty() -> None:
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()


def device_breakdown(label: str, what: str, fn, reps: int):
    """Where one call of ``fn`` spends its time: host wall clock per call
    (each ending in a wait for the card) over ``reps`` calls, then the
    device's busy time, its largest kernels and the host's largest ops
    from torch.profiler over ``reps`` more.  Returns, per call, ``wall``
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
    out["busy"] = busy_ms
    out["by_kernel"] = {e.key: e.self_device_time_total / 1e3 / reps
                        for e in events}
    return out


# label -> device_breakdown of the eager steady tick, for the graph phase
EAGER_TICKS = {}


def tick_breakdown(cfg, params, num_slots: int, max_seq: int,
                   block_size: int = 0, ticks: int = 10,
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
    """An int8 cache (paged: a pool of S * mb + mb + 1 blocks) filled with
    random values and scales, so that every tick attends to a history."""
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
    reserved, allocated = graphed.captured.pool_bytes
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
    reserved, allocated = graphed.captured.pool_bytes
    print(f"{label}: batch {b}, {LOOP_TOKENS} tokens, max_seq {SERVE_SEQ}: "
          f"captured loop bitwise equal to the eager loop (tokens and "
          f"cache) at starts {LOOP_STARTS} on one graph; launches per "
          f"replay {per_graph['qmatmul_w8a16']} qmatmul_w8a16, "
          f"{per_graph['qmatmul_w8a8']} qmatmul_w8a8 = the eager loop's; "
          f"tok/s eager {eager_tps:.1f}, captured {graph_tps:.1f}; private "
          f"pool {reserved} bytes reserved, {allocated} allocated")


def graph_phase(cfg, params) -> None:
    """The captured steps against the eager ones: every tick of
    GRAPH_CASES, the decode loop under w8a16 and w8a8, then the workspace
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
    graphed, eager, cache, other = kept
    held = graphed.captured.scratch
    side = G.capture_stream(cache["k"].device).cuda_stream
    now = scratch.held(cache["k"].device, side)
    S, max_seq = GRAPH_CASES[0][1:3]
    with torch.inference_mode():
        toks, idx, active, _ = _graph_tick_inputs(S, max_seq, 0,
                                                  cfg.vocab)[0]
        toks = (toks + 1) % cfg.vocab
        args = [x.cuda() for x in (toks, idx + GRAPH_TICKS, active)]
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


PHASES = ("attention", "long_tick", "w8a8", "graphs")


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
                         "qmatmul_w8a8's kernel phase and the W8A8 tick, or "
                         "the five eager tick breakdowns and the graph "
                         "phase; prints no result line")
    return ap.parse_args(argv)


def main(argv=None) -> int:
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
        del flush_buf
        if {"long_tick", "w8a8", "graphs"} & set(args.only):
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
        print("chip_smoke: partial run passed; no result line")
        return 0
    print("kernels: each CUDA kernel against its plain version on the card")
    q_err, q_paths = qmatmul_phase(flush)
    a_err, a_tick, a_long = attention_phase(flush,
                                            max_seq + (-max_seq) % 16)
    p_err, p_tick, p_long = paged_attention_phase(flush)
    w8_err, w8_fwd, w8_lib, w8_ticks = qmatmul_w8a8_phase(flush)
    f_err, f_fwd = flash_phase(flush)
    del flush_buf
    rmsnorm_phase()

    # the tick watchdog flags chunked-prefill ticks as stragglers; they
    # are counted in the report (stuck_ticks) rather than printed
    warnings.filterwarnings("ignore", message=".*straggler.*")
    cfg, params = build_model()
    launches = slice_phase(cfg, params)
    paged_launches = paged_slice_phase(cfg, params)
    long_tick_phase(cfg, params)
    w8a8_tick_phase(cfg, params)
    graph_phase(cfg, params)
    from repro_torch.runtime import steps as ST
    ST.clear_step_cache()           # the engines' captured tick and cache
    del params
    torch_cuda_empty()
    serve_launches = serve_phase()

    tick_basis = (f"one {{}} of {NUM_SLOTS} rows at full width: the sum "
                  f"over that tick's launches")
    fwd_basis = (f"one full-width forward of {SERVE_MAX_BATCH} x "
                 f"{SERVE_SEQ} tokens (the service curve's largest "
                 f"prefill): the sum over its launches")
    flash_runs = sum(c["flash_attention_bhsd"]
                     for c in serve_launches.values())

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
    for k in kernels + list(w8a16_paths.values()):
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if not math.isfinite(k[key]):
                return fail(f"{k.get('name', 'qmatmul_w8a16 path')}: {key} "
                            f"is not finite")
        if k["launches"] <= 0:
            return fail(f"{k.get('name', 'qmatmul_w8a16 path')}: no launch "
                        f"on its path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
