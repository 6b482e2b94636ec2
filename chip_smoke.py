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
   leaf), then a chunk's wall three ways (per-token eager, one-pass
   eager, captured) and the captured chunk's device busy and launch
   calls; and the workspace a
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
   then the curve's forward eager against captured at each batch
   (logits bitwise); the w8a16 run's first three requests are compared with
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
11. moe: qwen2-moe-a2.7b at full width (60 routed experts top-4 and 4
   shared, vocab 151,936 tied; its streamed init's peak held at all 24
   layers, the serves at 8 of them, the CLI at 24).  First ``qmatmul_w8a16``'s
   two expert-stacked entries against their plain version: the GEMV at a
   tick's shapes (60 experts x 8 rows: w_gate with the silu drain, w_up,
   w_down), all live and under the live mask of a tick's routing (8
   tokens through ``moe.route``/``dispatch``/``live_rows``; bitwise the
   all-live launch on the zero rows it skips), and the tensor-core entry
   at the serve CLI curve's 3, 12 and 48 rows an expert; every row
   bitwise alone and in its batch, a stack of one bitwise the 2-D launch
   on its path; the routed tick timed beside the all-live launch,
   ``torch.bmm`` on bf16 experts and two bounds (every expert's bytes,
   the live experts'), the curve's 48 rows on the tensor-core entry
   beside the GEMV, ``torch.bmm`` and the bound; and the router's GEMV
   (2048 x 60, f32); the router's softmax and stable top-4 rows bitwise
   alone and in a batch; then the model from the streamed init (peak
   under 20 GB), served as the dense configs are (contiguous bf16 held
   to ``reference_outputs``, greedy and sampled, paged held to
   contiguous with no leak, the int8 cache held to
   ``reference_outputs``), the captured chunk pass bitwise the per-token
   steps (every token routed alone; bf16 contiguous and int8 paged),
   the captured steady tick on both caches against the floors of every
   expert's weights and of the experts its tokens route to, with the
   device time by part, and the serve CLI with the dense CLI's flags
   (its curve's forward routes with capacity 3 and drops tokens, its
   experts on the tensor-core entry and no decode step's; the captured
   forward bitwise the eager one; four requests equal to
   ``reference_outputs``);
12. encdec: whisper-medium at full width (24 encoder and 24 decoder
   layers, d 1,024, 16 heads of 64, vocab 51,865 tied, 1,500 frames a
   source).  First the kernels at its shapes: ``flash_attention_bhsd``
   at BH = 16 (a prime) and 256 (the CLI curve's batch 16), not causal
   over 1,500 frames and at Sq 32 against Skv 1,500 (the curve's
   cross-attention), causal over 32 tokens (the curve's decoder);
   ``qmatmul_w8a16`` at the prime's M = 1,500 (both kernels; the mma
   path's rows alone and in slices of 17), the curve's M = 24,000 and
   512 (mma), a tick's M = 8, and on the LM head padded from 51,865 to
   51,868 columns (the first 51,865 against the plain version of the
   unpadded head, the padding exactly 0), each timed beside its plain
   version, its library call and its bound; then the model from the
   streamed init, served contiguous (each of 8 requests primed from its
   own frames at admission: exactly its primes' mma and flash launches,
   the GEMV otherwise) and held to ``reference_outputs``, served paged
   (the dense serves' pool, then a pool as large as the contiguous
   cache) with every token equal to the contiguous serve's and no leak,
   each serve's ticks (and, in ``--only encdec``, a profiled serve's
   device busy); the
   captured prime and the captured steady tick timed (the tick bitwise
   the eager one; the plain cross-attention's share of it; its floor:
   weights, cross k/v and self k/v it reads); then the serve CLI with
   ``--arch whisper-medium`` (its curve's forward encodes 1,500 frames a
   row; four requests equal to ``reference_outputs``).
13. ssm: mamba2-1.3b at full width (d 2,048, d_inner 4,096, 64 SSD
   heads of 64, state N 128, vocab 50,280 tied; the serves, tick and
   chunk at 16 of its 48 layers, the CLI at all 48).  First
   ``qmatmul_w8a16`` (both kernels at a tick's M = 8, the mma path at the
   curve's M = 512, rows checked alone) and ``qmatmul_w8a8`` (M = 8 and
   512, its int32 sums bitwise) at in_proj (K 2,048 x N 8,512) and
   out_proj (K 4,096 x N 2,048), and the W8A16 head over 50,280 columns,
   each timed beside its plain version, its library call and its bound;
   then the model from the streamed init, the dense trace served greedy
   and sampled, each equal to ``reference_outputs`` token for token; the
   trace at once on 4 slots with two SLO classes, as a control and with
   preemption, a non-finite sample and a failed dispatch, both equal to
   the contiguous serve; the captured tick bitwise the eager one, the
   freeze on the card (inactive rows' h and conv bitwise unchanged, one
   of them at index 0), its launches, wall, busy and floor (weights and
   the state read and written once), the freeze's masked writes timed
   alone; the chunk step captured and per-token bitwise, its busy a
   token against a token's floor; then the serve CLI with ``--arch
   mamba2-1.3b`` under w8a16 (four requests equal to the reference) and
   w8a8, each run's captured curve bitwise the eager forward at every
   batch.
14. hybrid: recurrentgemma-9b at full width (38 layers: 12 groups of two
   RG-LRU blocks and a local-attention block, 2 leftover RG-LRU blocks;
   d 4,096, 16 query heads and 1 KV head of 256, window 2,048, vocab
   256,000 tied; its streamed init's peak held at all 38 layers, the
   serves, ring tick and chunk at 14: 4 groups and the 2 leftover
   blocks; the CLI at 38).  First ``flash_attention_bhsd`` at head_dim
   256 (the
   kernel's HD = 256 instance: the CLI curve's BH = 16 x 1, 4, 16 at S =
   32, and S = 4,096 where the window bites), then ``qmatmul_w8a16`` and
   ``qmatmul_w8a8`` at its projections and the 256,000-column head, each
   timed beside its plain version, its library call and its bound; then
   the model from the streamed init, the dense trace served greedy and
   sampled, each equal to ``reference_outputs`` token for token, the
   overload serves against their control; the ring tick (8 rows at
   positions 2,045-2,052 of a 2,048-slot ring): captured bitwise eager,
   each row's logits and leaves bitwise its batch-1 step, the freeze on
   the card, its launches, wall, busy and floor; the chunk step captured
   and per-token bitwise; then the serve CLI with ``--arch
   recurrentgemma-9b`` under w8a16 (four requests equal to the
   reference) and w8a8 (the curve's RG-LRU gates and head on the mma
   path, 53 launches a forward), each run's captured curve bitwise the
   eager forward at every batch.
15. mixtral: mixtral-8x22b at full width and 8 of its 56 layers (d
   6,144, 48 query and 8 KV heads of 128, 8 experts top-2 of d_ff
   16,384, window 4,096, vocab 32,768 untied; 20.4 GB of int8, where 56
   layers would need 141 GB).  First flash with the window (the curve's
   BH = 48 x 1, 4, 16 at S = 32, and BH = 6 at S = 8,192 where it
   bites), the two decode attention kernels over 8 rows of a 4,096-slot
   int8 ring (the paged one through one-entry tables, bitwise the
   contiguous one), ``qmatmul_w8a16`` and ``qmatmul_w8a8`` at its
   projections and head, the expert stacks at a tick's routed rows and
   the curve's rows, and the router, each timed beside its plain
   version, its library call and its bound; then the model from the
   streamed init (its peak under 40 GB), the dense trace on the int8 and
   bf16 rings greedy and on the int8 ring sampled, each held to
   ``reference_outputs``; the ring tick (8 rows at positions 4,093-4,100
   of the 4,096-slot ring): captured bitwise eager, each row bitwise its
   batch-1 step, its launches, wall, busy and floors; the chunk on the
   wrapped ring from 4,090, 4,094 and 4,100, captured bitwise the
   per-token steps; then the launcher's ``measure_service_curve`` (each
   batch's captured forward bitwise the eager one) and
   ``measure_decode_tps`` under w8a16 and w8a8 (the serve CLI itself
   runs mixtral only ``--reduced``).
16. multiplex (in the whole run right after phase 8, on phase 3's
   params): starcoder2-3b and qwen2-moe-a2.7b at full width (its
   streamed init's own peak under 20 GB beside starcoder's 3 GB), W8A16
   on the int8 KV cache, as lanes of one ``Engine(models=...)``: an
   interleaved trace of 16 requests a lane (16 + 16 tokens, 400/s a lane,
   8 leased slots, chunks of 4) under a class quota of 4 slots for the
   starcoder2-3b lane, served contiguous and then paged (blocks of 16),
   each lane's outputs exactly its dedicated engine's on its sub-trace
   (and three requests a lane ``reference_outputs``'), no leak, the
   lanes' occupancies summing to the engine's in every tick and the
   quota never exceeded; the lanes' and the dedicated engines' captured
   ticks and the multiplexed tick (both lanes) timed; the same trace
   sampled (t = 0.8, ``PRNGKey(1)``), each lane exactly its dedicated
   sampled engine; a hot-swap serve (virtual clock) that admits a second
   starcoder2-3b lane (weights from seed + 1) and retires the first:
   the retired lane's admitted requests finish, its later ones come back
   refused, the new lane equals its dedicated engine, and no tick after
   the admission captures a graph; a ``ReplicaRouter`` over two
   starcoder2-3b engines sharing one weight tree (the same plan twice,
   each replica exactly a dedicated engine on its sub-trace); then the
   serve CLI with ``--models starcoder2-3b,qwen2-moe-a2.7b --model-quota
   starcoder2-3b=4`` and with ``--replicas 2``, each exit 0 with its
   per-model or per-replica lines.  Every serve is warmed up, captures
   nothing, reaches no plain version and launches no mma path.
17. sharded (in the whole run right after phase 16, on phase 3's
   params): scale-out on the one card, ``Engine(backend=
   ShardedExecutor(tp, devices=[card] * tp))``: phase 3's trace served
   at tp 2 and tp 4 beside a single-device control (alive beside them,
   so the graph budget must keep every engine's graphs), each serve's
   outputs bitwise the control's, no capture in a serve, qmatmul_w8a16's
   GEMV and both decode attention kernels launched; the captured tick
   of each tp timed against the control's and the private pools of each
   engine's graphs printed; tp 2 paged (blocks of 16, 13 blocks) with
   preemption and sampling against its single-device control (every
   request equal, 0 leaked); tp 2 speculating (k = 3, a 1-layer
   self-draft) on 8 of the requests, equal to the control; the serve
   CLI with ``--tp 2`` and with ``--replicas 2 --tp 2``, each exit 0,
   every request ok and three held to ``reference_outputs``.
18. train: the training path.  ``flash_attention_bhsd`` at the
   training shape (BH = 8 x 24, S 128, hd 128, causal; and with a window
   of 32): its forward against the plain version and the autograd
   Function's dQ, dK, dV (``kernels/ops.py::flash_attention``, whose
   backward is the plain ``flash_attention_bwd``) against autograd of the
   plain version, one bf16 ulp each; both directions timed beside their
   bounds and SDPA's.  Reduced starcoder2-3b: the loss and every grad
   leaf on the card against the port on the CPU (loss 1e-3, each leaf 3%
   in norm), 2 kernel launches and one backward call a layer.  Then the
   train CLI (``launch.train``, in this process) at full starcoder2-3b
   width and depth, f32 params, AdamW, ``--seq-len 128 --batch 8
   --steps 12 --lr 1e-5``: exit 0 (the launcher's rule: the last 5
   losses' mean below the first 5's), every loss finite, 720 flash
   launches (30 layers x 2 x 12 steps: the forward and remat's
   recompute), 360 backward calls, no plain version, no qmatmul, peak
   allocated memory under 60 GB, ms a step and tokens/s printed; and a
   reduced run killed at step 11 with ``--ckpt-every 5``, whose rerun
   with ``--resume auto`` restores step 10 and exits 0 (checkpoints in a
   temporary directory the phase removes).
19. paper (last): the paper's six apps (MLP0/1, LSTM0/1, CNN0/1 at
   Table 1 size).  Both int8 kernels at every distinct FC shape at its
   app's batch (MLP0 2,000² at M 200, MLP1 1,118² at 168, LSTM0 2,084 x
   4,168 at 64, LSTM1 1,376 x 2,752 at 96, CNN1's 3,700², 3,700 x 7,400,
   7,400 x 3,700 and 3,700 x 1,000 at 32), each weight stored padded as
   the apps store it (K to a multiple of 16, N of 4): ``ops.qmatmul`` on
   the GEMV (f32 x) and the mma path (bf16 x) and ``ops.qmatmul_dynamic``
   against the plain versions on the unpadded operands, the padded W8A8
   call also by ``w8a8_check``, each timed beside its plain version, its
   bound and a library call.  Each app built as the serve twin builds it:
   its W8A16 and W8A8 forwards of 2 rows on the card against the same
   forward on the CPU (1e-3 / 1e-2 relative L2), captured as a CUDA
   graph bitwise its eager forward, 4 forwards' launches a mode.  Then
   ``python -m repro_torch.examples.serve_quantized`` over the six apps
   in this process (exit 0, a Table 4 line an app, every FC on the GEMV,
   no plain version) and the quickstart twin (exit 0).

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
``--only moe`` / ``--only encdec`` / ``--only ssm`` / ``--only hybrid`` /
``--only mixtral`` / ``--only multiplex`` / ``--only sharded`` /
``--only train`` / ``--only paper`` run just the two
attention kernel
phases, the long-context ticks, ``qmatmul_w8a8``'s kernel phase and the
W8A8 tick, the five eager tick breakdowns and the graph phase, the dense
family's kernel rows, rmsnorm widths and phase 10, phase 7 and the
sampled serve CLI run, phase 8 with its CLI run and qwen2-moe-a2.7b's
speculative serve, phase 11, 12, 13, 14, 15, 16, 17, 18 or 19, and ``--src
DIR``
takes the port from
another checkout's ``src/`` (so the same phases time a parent commit's
kernels); such a partial run prints no result line.

It prints the card's name and power limit, a JSON line with every
kernel's numbers (qmatmul_w8a16's with both paths under ``paths``, the
attention kernels' long-context case under ``long_context``, the rows at
the dense configs' shapes under ``dense``, qmatmul_w8a16's expert-stacked
entries under ``experts`` (the routed tick's GEMV, the forward's
tensor-core entry under ``forward``), each kernel's MoE launches under
``moe`` and
its launches in the speculative serves under ``spec``, and
qmatmul_w8a16's and flash_attention_bhsd's rows at whisper-medium's
shapes, their launches in its serves and the prime's and tick's times
under ``encdec``; qmatmul_w8a16's and qmatmul_w8a8's rows at
mamba2-1.3b's shapes, their launches and the tick's and chunk's times
under ``ssm``; the three kernels' rows at recurrentgemma-9b's shapes,
flash's at head_dim 256, their launches and the ring tick's and chunk's
times under ``hybrid``; every kernel's rows at mixtral-8x22b's shapes,
their launches in its serves and launcher runs, and the ring tick's,
chunks', serves' and launcher's times under ``mixtral``; each kernel's
launches in the multiplexed, routed and ``--models`` runs under
``multiplex``; the three kernels' launches in the tp 2 and tp 4 serves
under ``sharded``, qmatmul_w8a16's with each tp's captured tick and
tok/s; flash_attention_bhsd's launches in the train CLI's run, its
gradient's calls, its rows at the training shape, the step's ms,
tokens/s and peak memory under ``train``; both int8 kernels' rows at the
paper apps' FC shapes, their launches in the serve twin's run and the
apps' forwards, and the apps' Table 4 rows under ``paper``), and beside
``kernels`` the multiplex phase's numbers
under ``multiplex`` (the serves' tok/s and occupancies, the ticks'
wall and busy, the hot-swap's and the router's counts, the phase's
seconds), the whole run's time, and,
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

# the queue head start of time_ms: at most this long (the sleep kernel
# spins SM clock cycles: SLEEP_CYCLES_PER_S at H100's ~2 GHz boost, so a
# slower clock only lengthens it)
HEAD_START_S = 0.1
# the head start of a plain version's timing (time_ms's warmup=False calls
# and timed_call): longer than the host takes to queue one plain call of a
# forward's 512 rows
PLAIN_HEAD_S = 0.05
# calls a kernel or library timing averages (CUDA events, L2 flushed)
TIMED_ITERS = 5
# what time_ms cost this run (host seconds, its heads' sleep, the timings
# it took again; "plain": the warmup=False calls), printed at the end of
# a whole run to find timing work worth cutting
TIME_MS_COST = {"calls": 0, "seconds": 0.0, "head_s": 0.0, "retaken": 0,
                "plain_calls": 0, "plain_seconds": 0.0}
SLEEP_CYCLES_PER_S = 2e9


def time_ms(fn, iters: int, flush, warmup: bool = True) -> float:
    """Mean device time of one call of ``fn``, from CUDA events around each
    of ``iters`` calls, each after an L2 flush (the serving path streams
    3 GB of weights per tick, so every weight read is cold).  The calls
    are queued behind a sleep kernel, so the card runs them back to back
    and the events time the device, not the host's launch overhead.  The
    sleep lasts 2x the host time the iters calls take to queue (the
    warm-up call's, plus 2 ms); if the card woke before the last call was
    queued, the timing is taken again behind HEAD_START_S.
    ``warmup=False`` skips the untimed first call and queues behind
    PLAIN_HEAD_S, never taken again: the plain versions, plain PyTorch
    with nothing to compile, whose one call at a forward's shapes takes
    up to seconds (a retaken timing ran it twice more)."""
    import torch
    t_call = time.perf_counter()
    cost = TIME_MS_COST
    cost["calls"] += 1
    head = PLAIN_HEAD_S
    if warmup:
        t0 = time.perf_counter()
        flush()
        fn()
        head = min(HEAD_START_S,
                   0.002 + 2 * iters * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    while True:
        cost["head_s"] += head
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(iters)]
        awake = torch.cuda.Event()
        torch.cuda._sleep(int(head * SLEEP_CYCLES_PER_S))
        awake.record()
        for start, end in events:
            flush()
            start.record()
            fn()
            end.record()
        queued_asleep = not awake.query()
        torch.cuda.synchronize()
        if queued_asleep or head >= HEAD_START_S or not warmup:
            spent = time.perf_counter() - t_call
            cost["seconds"] += spent
            if not warmup:
                cost["plain_calls"] += 1
                cost["plain_seconds"] += spent
            return sum(s.elapsed_time(e) for s, e in events) / iters
        cost["retaken"] += 1
        head = HEAD_START_S


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def timed_call(fn, flush):
    """(``fn()``, the device ms of that one call), timed as ``time_ms``
    times a plain version (an L2 flush, then CUDA events around the call,
    queued behind PLAIN_HEAD_S): so the plain version's result that a
    check compares with is also its timing, and it runs once."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(PLAIN_HEAD_S * SLEEP_CYCLES_PER_S))
    flush()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def w8a16_check(label, x, w, ws, bias, act, odt, ref, paths=None):
    """qmatmul_w8a16 through each of its kernels (or those of ``paths``)
    on one input, held against the plain version's ``ref`` with
    bf16_close.  Returns the worst (max_abs_err, err / tol)."""
    import torch
    from repro_torch.kernels import qmatmul as K

    worst = (0.0, 0.0)
    for path in paths or K.W8A16_PATHS:
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


def w8a16_numbers(x, w, ws, bias, act, odt, paths, plain_iters, flush,
                  plain_ms=None):
    """One W8A16 shape's numbers: each of ``paths`` timed (20 launches),
    the plain version (``plain_ms`` where the caller timed its check's
    call, else ``plain_iters`` calls; nan for 0), ``F.linear`` on
    the bf16-dequantized weights, and the bound: the larger of the bytes
    (x, w, its scales, the bias and the output once each) over the memory
    rate and 2 M K N over the bf16 peak."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import qmatmul as K

    (m, k), n = x.shape, w.shape[1]
    kw = dict(activation=act, out_dtype=odt)
    ms = {path: time_ms(lambda: K.qmatmul_w8a16_on_path(
        path, x, w, ws, bias, **kw), TIMED_ITERS, flush) for path in paths}
    plain = (plain_ms if plain_ms is not None else
             time_ms(lambda: K.qmatmul_w8a16_ref(x, w, ws, bias, **kw),
                     plain_iters, flush, warmup=False)
             if plain_iters else float("nan"))
    w_lib = (w.float() * ws).to(torch.bfloat16).t()      # (N, K) view
    b_lib = None if bias is None else bias.to(torch.bfloat16)
    lib = time_ms(lambda: F.linear(x, w_lib, b_lib), TIMED_ITERS, flush)
    del w_lib
    nbytes = (x.numel() * 2 + w.numel() + ws.numel() * 4
              + (0 if bias is None else n * 4)
              + m * n * torch.empty(0, dtype=odt).element_size())
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m * k * n / BF16_OPS_PER_S * 1e3
    return {"ms": ms, "plain_ms": plain, "library_ms": lib,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_ms": bytes_ms, "ops_ms": ops_ms}


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
            # at the forward's M the check's plain call is its timing
            ref, plain_ms = timed_call(lambda: K.qmatmul_w8a16_ref(
                x, w, ws, bias, activation=act, out_dtype=odt), flush) \
                if m == SERVE_ROWS else (K.qmatmul_w8a16_ref(
                    x, w, ws, bias, activation=act, out_dtype=odt), None)
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
            t = w8a16_numbers(
                x, w, ws, bias, act, odt, K.W8A16_PATHS,
                3 if m == NUM_SLOTS else 0, flush, plain_ms)
            ms, plain, lib, bound = (t["ms"], t["plain_ms"],
                                     t["library_ms"], t["bound_ms"])
            bytes_ms, ops_ms = t["bytes_ms"], t["ops_ms"]
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
        qd, kd, vd, attn_mask=mask, enable_gqa=True), TIMED_ITERS, flush)


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
            q, k, v, ks, vs, vl, k_new=kn, v_new=vn), TIMED_ITERS, flush)
        plain = time_ms(lambda: A.decode_attention_int8_ref(
            q, k, v, ks, vs, vl, k_new=kn, v_new=vn), 1, flush, warmup=False)
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
            q, k, v, ks, vs, vl, tables, k_new=kn, v_new=vn), TIMED_ITERS,
            flush)
        plain = time_ms(lambda: A.decode_attention_int8_paged_ref(
            q, k, v, ks, vs, vl, tables, k_new=kn, v_new=vn), 1, flush,
            warmup=False)
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


def w8a8_check(label, x, w, xs, ws, bias, act, flush=None):
    """qmatmul_w8a8 (the wrapper's own choice of kernel) on one input:
    its int32 sums bitwise equal to the plain version's (unit scales, no
    bias, no activation), its bf16 drain within one bf16 ulp (bf16_close),
    and, where the wrapper takes the tensor-core kernel, its bf16 output
    torch.equal to the same rows launched in slices that the GEMV takes.
    Returns (max_abs_err, err / tol, drain bitwise), and with ``flush``
    also the device ms of the plain call it compared with
    (:func:`timed_call`): the row's plain time."""
    import torch
    from repro_torch.kernels import qmatmul as K

    m, n = x.shape[0], w.shape[1]
    one, ones = torch.ones((), device="cuda"), torch.ones((n,), device="cuda")
    acc = K.qmatmul_w8a8(x, w, one, ones)
    acc_ref = K.qmatmul_w8a8_ref(x, w, one, ones)
    kw = dict(activation=act, out_dtype=torch.bfloat16)
    out = K.qmatmul_w8a8(x, w, xs, ws, bias, **kw)
    ref, plain_ms = (timed_call(lambda: K.qmatmul_w8a8_ref(
        x, w, xs, ws, bias, **kw), flush) if flush is not None else
        (K.qmatmul_w8a8_ref(x, w, xs, ws, bias, **kw), None))
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
    if flush is None:
        return err, ratio, torch.equal(out, ref)
    return err, ratio, torch.equal(out, ref), plain_ms


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
            # a timed row's plain time is its check's plain call
            err, ratio, bitwise, *plain = w8a8_check(
                label, xm, w, xs, ws, bias, act,
                flush if m in per_m else None)
            worst_err = max(worst_err, err)
            if m not in per_m:
                print(f"  qmatmul_w8a8 {name:7s} M={m:3d} K={k:5d} N={n:5d} "
                      f"path={K.w8a8_path(m)} int32_bitwise=True "
                      f"drain_bitwise={bitwise} max_abs_err={err:.3e} "
                      f"err/tol={ratio:.3f}")
                continue
            plain, = plain
            ms = time_ms(lambda: K.qmatmul_w8a8(
                xm, w, xs, ws, bias, activation=act,
                out_dtype=torch.bfloat16), TIMED_ITERS, flush)

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
            lib = time_ms(lib_fn, TIMED_ITERS, flush)
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
                    out_dtype=torch.bfloat16), TIMED_ITERS, flush)
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
        ms = time_ms(lambda: FA.flash_attention_bhsd(q, k, v, **kw),
                     TIMED_ITERS, flush)
        plain = time_ms(lambda: FA.flash_attention_ref(q, k, v, **kw), 1,
                        flush, warmup=False)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), TIMED_ITERS, flush)
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
    kernels, plains = _counted()
    for fn in kernels:
        fn.launches = 0
        for path in getattr(fn, "launches_by_path", {}):
            fn.launches_by_path[path] = 0
    for fn in plains:
        fn.calls = 0


def read_counts():
    """(kernel launches, plain-version calls) since :func:`zero_counts`;
    qmatmul_w8a16's and its experts' launches also by path, as
    ``qmatmul_w8a16[<path>]`` and ``qmatmul_w8a16_experts[<path>]``."""
    kernels, plains = _counted()
    launches = {f.__name__: f.launches for f in kernels}
    for f in kernels:
        for path, n in getattr(f, "launches_by_path", {}).items():
            launches[f"{f.__name__}[{path}]"] = n
    return launches, {f.__name__: f.calls for f in plains}


def mma_free(label, launches) -> None:
    """The engine's steps and the decode loop run the GEMV only (the
    experts' too): their rows must not depend on the batch, and the mma
    path's differ from the GEMV's by f32 rounding."""
    if launches["qmatmul_w8a16[mma]"] or \
            launches["qmatmul_w8a16_experts[mma]"]:
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


def step_objects(eng):
    """The engine's memoized steps, lane by lane: the tick and the chunk
    step (every bucket its chunks can take), the prime step (a family
    that primes) and, speculating, the verify and propose steps and the
    draft's chunk steps."""
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    def buckets(cap):
        return sorted({ST.bucket_batch(n) for n in range(1, cap + 1)})

    be, mode = eng.backend, eng.mode
    steps = []
    for ln in eng.lanes.values():
        steps.append(be.slot_step(ln.cfg, mode=mode,
                                  temperature=eng.temperature))
        if R.needs_prime(ln.cfg):
            steps.append(be.prime_step(ln.cfg, mode=mode))
        steps += [be.chunk_step(ln.cfg, mode=mode, chunk=c)
                  for c in buckets(eng.prefill_chunk)]
        if ln.spec_k:
            steps += [be.verify_step(ln.cfg, mode=mode, k=ln.spec_k,
                                     temperature=eng.temperature),
                      be.propose_step(ln.dcfg, mode=mode, k=ln.spec_k)]
            steps += [be.chunk_step(ln.dcfg, mode=mode, chunk=c)
                      for c in buckets(eng.draft_cap)]
    return steps


def step_captures(eng):
    """The captures of :func:`step_objects`' steps."""
    return [s.captured.captures for s in step_objects(eng)]


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
    if cross_layers(eng.cfg):
        what += " and the prime graph"
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
    ``curve_paths`` qmatmul_w8a16's launches by path during each call
    (``<path>``) and its experts' (``experts[<path>]``)."""
    def curve(*args, **kwargs):
        from repro_torch.kernels import qmatmul as K
        before = dict(K.qmatmul_w8a16.launches_by_path)
        experts = dict(K.qmatmul_w8a16_experts.launches_by_path)
        try:
            return real_curve(*args, **kwargs)
        finally:
            for path, n in K.qmatmul_w8a16.launches_by_path.items():
                curve_paths[path] = n - before[path]
            for path, n in K.qmatmul_w8a16_experts.launches_by_path.items():
                curve_paths[f"experts[{path}]"] = n - experts[path]
    curve.__wrapped__ = real_curve
    return curve


def serve_run(quant, curve_paths, flags=(), base=SERVE_ARGS, label=None,
              expect=()):
    """One serve launcher run of ``base`` arguments, counters zeroed just
    before and read just after, and checked: (its kernel launches, its
    ServeRun).  With the overload ``flags`` the run must print its
    retirement and faults lines, and every request retire once (a fault
    may fail one).  Without them each batch's captured forward is held to
    the eager one (``curve_check``).  Every line prefix of ``expect`` must
    open a line of the run's output."""
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
    printed = out.getvalue().splitlines()
    missing = [e for e in expect
               if not any(ln.startswith(e) for ln in printed)]
    if missing:
        raise AssertionError(f"{label}: no line opens with {missing}")
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
    need = (["flash_attention_bhsd"] if res.cfg.family != "ssm"
            else ["qmatmul_w8a16"]) + (["qmatmul_w8a8"]
                                       if quant == "w8a8" else [])
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"{label}: a kernel of the path never "
                             f"launched: {launches}")
    if any(plain_calls.values()):
        raise AssertionError(f"{label}: the CUDA path reached a plain "
                             f"version: {plain_calls}")
    # a primed family's engine primes twice in its warm-up (the capture's
    # warm-up run on a copy of the cache, then the first replay) and once
    # a request
    primes = (2 + len(res.requests)) if cross_layers(res.cfg) else 0
    prime_mma = (primes * prime_launches(res.cfg)["qmatmul_w8a16[mma]"]
                 if primes else 0)
    outside = (launches["qmatmul_w8a16[mma]"] - curve_paths["mma"]
               - prime_mma,
               launches["qmatmul_w8a16_experts[mma]"]
               - curve_paths["experts[mma]"])
    if any(outside):
        raise AssertionError(f"{label}: the decode loop or the engine took "
                             f"the mma path {outside} times (2-D, experts) "
                             f"beyond its {primes} primes' {prime_mma}")
    routers = router_gemvs(res.cfg, curve_paths["mma"])
    if quant == "w8a16" and (
            curve_paths["gemv"] != routers or curve_paths["mma"] <= 0
            or curve_paths["experts[gemv]"]
            or curve_paths["experts[mma]"] != 3 * routers):
        raise AssertionError(f"{label}: the service curve's forward must "
                             f"launch only the mma path (an MoE router the "
                             f"GEMV, its experts the stacked mma entry, 3 "
                             f"a layer): {curve_paths}")
    per_forward = w8a8_forward_mma(res.cfg)
    mma = curve_paths["mma"]
    ok = (mma > 0 and mma % per_forward == 0 and not curve_paths["gemv"]
          if per_forward else not mma)
    if quant == "w8a8" and (curve_paths["experts[mma]"] or not ok):
        raise AssertionError(f"{label}: the W8A8 forward's qmatmul_w8a16 "
                             f"launches by path {curve_paths}, want "
                             f"{per_forward} mma launches a forward and "
                             f"{'no GEMV' if per_forward else 'no mma'}")
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
    launches["curve_experts_mma"] = curve_paths["experts[mma]"]
    if not flags:
        curve_check(label, res, serve.parse_args(argv))
    return launches, res


def gemvs_per_layer(cfg) -> int:
    """qmatmul_w8a16's GEMV launches of one decode step per layer (every
    projection int8): the attention's four, the (shared) MLP's two or
    three (none for an MoE config without shared experts: mixtral), and
    an MoE layer's router; an SSD layer's in_proj and out_proj."""
    if cfg.family == "ssm":
        return 2
    mlp = 3 if cfg.gated_mlp else 2
    if cfg.family == "moe" and not cfg.n_shared_experts:
        mlp = 0
    return 4 + mlp + (cfg.family == "moe")


def step_gemvs(cfg) -> int:
    """qmatmul_w8a16's GEMV launches of one decode step's layers, the head
    not counted: ``gemvs_per_layer`` a layer and the q and o projections
    of each layer's cross-attention (``cross_layers``: its k and v were
    primed), or for the hybrid family a recurrent block's five (its two
    input projections, the RG-LRU's two gates and its output) and an
    attention block's four, each with its MLP's three."""
    if cfg.family == "hybrid":
        mlp = 3 if cfg.gated_mlp else 2
        groups, leftover = cfg.n_layers // 3, cfg.n_layers % 3
        rec, attn = 5 + mlp, 4 + mlp
        return groups * (2 * rec + attn) + leftover * rec
    return gemvs_per_layer(cfg) * cfg.n_layers + 2 * cross_layers(cfg)


def w8a8_forward_mma(cfg) -> int:
    """qmatmul_w8a16's mma launches of one W8A8 forward: the hybrid's
    RG-LRU gates (W8A16 under every mode, two a recurrent block) and its
    head; none for the other families, whose head takes the GEMV."""
    if cfg.family != "hybrid":
        return 0
    return 2 * (2 * (cfg.n_layers // 3) + cfg.n_layers % 3) + 1


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


# calls of each breakdown under torch.profiler: its bookkeeping costs
# the host seconds for an eager call's thousands of ops and launches
# (the whole run's breakdowns took minutes at 3-10 profiled calls),
# while a call's device time varies by under 1% between calls
PROFILED_CALLS = 1
# wall-clock calls of a breakdown of a captured step or of the sampler
CAPTURED_REPS = 5


def device_breakdown(label: str, what: str, fn, reps: int,
                     detail: bool = True, profiled: bool = True):
    """Where one call of ``fn`` spends its time: host wall clock per call
    (each ending in a wait for the card) over ``reps`` calls, then the
    device's busy time, its largest kernels and the host's largest ops
    (``detail``) from torch.profiler over PROFILED_CALLS more, unless not
    ``profiled`` (the wall clock alone: the profiler's bookkeeping of an
    eager call's thousands of launches takes seconds, on the host).
    Returns, per call, ``wall`` ms, ``busy`` ms (None where the profiler
    reported no device time or did not run), ``launch_calls``
    (cudaLaunchKernel), ``graph_launches`` (cudaGraphLaunch; both None
    unprofiled) and ``by_kernel`` ({kernel: device ms})."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def call():
        fn()
        torch.cuda.synchronize()

    n = PROFILED_CALLS
    if not profiled:
        # every call timed, as many as a profiled breakdown makes: a
        # recurrent state the calls advance ends where it would
        reps += n
    with torch.inference_mode():
        call()
        t0 = time.perf_counter()
        for _ in range(reps):
            call()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
        if not profiled:
            print(f"{label}: {what} wall {wall_ms:.2f} ms, device busy "
                  f"not measured (wall clock alone)")
            return {"wall": wall_ms, "busy": None, "launch_calls": None,
                    "graph_launches": None, "by_kernel": {}}
        warnings.filterwarnings("ignore", message=".*Profiler clears")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                call()
    averages = prof.key_averages()
    # device-side events (kernels, copies) only: host ops carry the device
    # time of what they launched too
    events = [e for e in averages if str(e.device_type).endswith("CUDA")]
    dev_us = sum(e.self_device_time_total for e in events)
    launch_calls, graph_launches = (
        sum(e.count for e in averages if e.key == key) / n
        for key in ("cudaLaunchKernel", "cudaGraphLaunch"))
    out = {"wall": wall_ms, "busy": None, "launch_calls": launch_calls,
           "graph_launches": graph_launches, "by_kernel": {}}
    if dev_us <= 0:
        print(f"{label}: {what} wall {wall_ms:.2f} ms, device busy not "
              f"measured (the profiler reported no device time)")
        return out
    busy_ms = dev_us / 1e3 / n
    print(f"{label}: {what} wall {wall_ms:.2f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%")
    out["busy"] = busy_ms
    out["by_kernel"] = {e.key: e.self_device_time_total / 1e3 / n
                        for e in events}
    if not detail:
        return out
    for us, key in sorted(((e.self_device_time_total, e.key)
                           for e in events), reverse=True)[:6]:
        print(f"  device time per call {us / 1e3 / n:.3f} ms: "
              f"{key[:90]}")
    host = [e for e in averages if not str(e.device_type).endswith("CUDA")]
    for us, count, key in sorted(((e.self_cpu_time_total, e.count, e.key)
                                  for e in host), reverse=True)[:8]:
        print(f"  host time per call {us / 1e3 / n:.3f} ms in "
              f"{count // n} calls: {key[:60]}")
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
TIMED_LOOPS = 1


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
        lambda: graphed(params, toks, other, idx, active)[0].cpu(),
        CAPTURED_REPS)
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
# wall-clock reps of each chunk breakdown (the profiler takes
# PROFILED_CALLS): at 5 profiled reps, its bookkeeping of the per-token
# eager chunk's 6,000-13,500 launches a call took 197 of the graph
# phase's 300 s (PERF.md, Findings)
CHUNK_REPS = 1


def graph_chunk_case(cfg, params, label, S, max_seq, block_size, mode,
                     kv_quant, sid, start) -> dict:
    """The chunk step of slot ``sid`` from ``start`` for every n_valid up
    to PREFILL_CHUNK: the eager per-token step
    (``make_per_token_chunk_step``), the
    eager step (under W8A16 one pass) and the captured step (one graph
    per n_valid), each on its copy of one random cache, every cache leaf
    ``torch.equal`` to the per-token step's; a replay's launch counts the
    eager one pass's (under W8A16: ``step_gemvs`` GEMVs,
    an MoE layer's three expert stacks and one paged attention launch a
    layer, where the per-token step launches n times that); then a full
    chunk's wall three ways, and the captured chunk's device busy and
    launch calls (an eager chunk is timed by the wall clock alone).
    Returns the breakdowns by way."""
    import torch
    from repro_torch.core.qlinear import W8A8, W8A16
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    qm = {"w8a16": W8A16, "w8a8": W8A8}[mode]
    one_pass = mode == "w8a16" and R.decodes_chunk_in_one_pass(cfg)
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
        projections = step_gemvs(cfg)
        key = "qmatmul_w8a8" if mode == "w8a8" else "qmatmul_w8a16[gemv]"
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
                                  PREFILL_CHUNK), CHUNK_REPS,
            profiled=way == "captured")
    for name in cache:                 # the timed calls rewrote the same bytes
        if not (torch.equal(got[name], want[name])
                and (not one_pass or torch.equal(one[name], want[name]))):
            raise AssertionError(f"{label}: after timing, cache leaf {name} "
                                 f"differs")

    def ms(x):
        return "not measured" if x is None else f"{x:.3f} ms"

    def calls(x):
        return "not measured" if x is None else f"{x:.0f}"

    print(f"{label}: per chunk of {PREFILL_CHUNK}, "
          + "; ".join(f"{way} wall {r['wall']:.2f} ms, busy "
                      f"{ms(r['busy'])}, cudaLaunchKernel "
                      f"{calls(r['launch_calls'])}, cudaGraphLaunch "
                      f"{calls(r['graph_launches'])}"
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


def curve_batch(cfg, b: int, seq: int, gen=None) -> dict:
    """A prefill batch of ``cfg.input_specs``: (b, seq) tokens and the
    config's other inputs (encdec's frames), random from ``gen``, or
    zeros without one."""
    import torch
    from repro_torch.configs.base import ShapeSpec

    batch = {}
    for name, (shape, dtype) in cfg.input_specs(
            ShapeSpec("serve_curve", seq, b, "prefill")).items():
        if gen is None:
            batch[name] = torch.zeros(shape, dtype=dtype, device="cuda")
        elif dtype == torch.int32:
            batch[name] = torch.randint(0, cfg.vocab, shape, generator=gen,
                                        device="cuda", dtype=dtype)
        else:
            batch[name] = torch.randn(shape, generator=gen,
                                      device="cuda").to(dtype)
    return batch


def curve_check(label: str, res, args) -> None:
    """The service curve's forward eager against captured
    (``runtime/steps.py::jit_prefill_step``, what the launcher measured
    with) at each batch of the run's curve: the captured logits
    ``torch.equal`` to the eager ones on random tokens, one capture a
    batch."""
    import torch
    from repro_torch.runtime import steps as ST

    eager = ST.make_prefill_step(res.cfg, mode=res.mode)
    graphed = ST.jit_prefill_step(eager)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for b in sorted(res.curve):
        with torch.inference_mode():
            batch = curve_batch(res.cfg, b, args.seq, g)
            want = eager(res.params, batch)
            got = graphed(res.params, batch)
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: the captured forward's "
                                     f"logits at batch {b} differ from the "
                                     f"eager forward's")
            del want
        print(f"{label} curve b={b}: captured logits bitwise the eager "
              f"forward's")
    if graphed.captured.captures != len(res.curve):
        raise AssertionError(f"{label}: {graphed.captured.captures} "
                             f"captures for {len(res.curve)} batches")
    graphed.captured.release()
    torch_cuda_empty()


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
                                 logits, keys, SAMPLE_TEMP), CAPTURED_REPS,
                             False)
        c = device_breakdown(f"sampler V={vocab} captured", what,
                             lambda: captured({}, {}, logits, keys),
                             CAPTURED_REPS, False)
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
    ``reference_outputs`` under the engine's temperature and key (greedy
    at temperature 0), on the card: equal token for token (both run the
    same ops on the card, so a difference is a fault, not a near-tie)."""
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
    how = (f"sampled reference_outputs (t = {eng.temperature}, fold_in("
           f"PRNGKey({SEED + 1}), position))" if eng.temperature else
           "greedy reference_outputs")
    print(f"{label}: {len(ref)} requests {sorted(ref)} equal the {how} "
          f"token for token on the card; smallest "
          f"{'perturbed ' if eng.temperature else ''}top-2 gap "
          f"{min(min(v) for v in margins.values()):.3e}"
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
            .cpu(), CAPTURED_REPS, False)
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
# the depth that the MoE, ssm and hybrid phases serve, tick and hold to
# their references at (widths are never cut): 8 of qwen2-moe-a2.7b's 24
# layers, 16 of mamba2-1.3b's 48, and 14 of recurrentgemma-9b's 38 (4 of
# its 12 groups and its 2 leftover blocks).  At full depth the whole run
# took 1,311.7 s on an NVIDIA H100 80GB HBM3 at 700 W, over its 1,200 s
# limit; these cuts save 39-64 s each there (PERF.md, Findings).  A config with a PEAK_BYTES limit has its full-depth
# streamed init held to it first (``build_family_model``); the dense
# configs, and every family's serve CLI run, keep their full depth
FAMILY_LAYERS = {"qwen2-moe-a2.7b": 8, "mamba2-1.3b": 16,
                 "recurrentgemma-9b": 14}
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
# from one under 20 GB (its f32 tree is 56 GB, one f32 layer 2.28 GB);
# mixtral-8x22b's 8 layers, 20.4 GB of int8, from one under 40 GB (one f32
# layer is 9.7 GB); llama-3.2-vision-90b's 10 layers, 10.96 GB of int8,
# from one under 25 GB (one f32 cross layer is 4.0 GB, one f32 table
# 4.2 GB)
PEAK_BYTES = {"qwen1.5-32b": 45e9, "qwen2-moe-a2.7b": 20e9,
              "recurrentgemma-9b": 16e9, "mixtral-8x22b": 40e9,
              "llama-3.2-vision-90b": 25e9}
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
            t = w8a16_numbers(x, w, ws, None, act, odt, K.W8A16_PATHS, 3,
                              flush)
            ms, plain, lib = t["ms"], t["plain_ms"], t["library_ms"]
            m = NUM_SLOTS
            plan = K.gemv_split_plan(k, n)
            rows[label] = {
                "K": k, "N": n, "activation": act, "M": m,
                "ms": ms["gemv"], "mma_ms": ms["mma"], "plain_ms": plain,
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": lib, "max_abs_err": err}
            print(f"  qmatmul_w8a16 {label:24s} K={k:5d} N={n:6d} act={act:4s}"
                  f" max_abs_err={err:.3e} err/tol={ratio:.3f} (M = 1 and "
                  f"{m}, both paths) gemv_ms={ms['gemv']:.4f} "
                  f"mma_ms={ms['mma']:.4f} plain_ms={plain:.4f} "
                  f"library_ms={lib:.4f} bound_ms={t['bound_ms']:.4f}"
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
            time_ms(lambda: A.decode_attention_int8(q, k, v, ks, vs, vl),
                    TIMED_ITERS, flush),
            time_ms(lambda: A.decode_attention_int8_ref(q, k, v, ks, vs, vl),
                    1, flush, warmup=False),
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
                q, pk, pv, pks, pvs, vl, tables), TIMED_ITERS, flush),
            time_ms(lambda: A.decode_attention_int8_paged_ref(
                q, pk, pv, pks, pvs, vl, tables), 1, flush, warmup=False),
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


def build_dense_model(arch, n_layers=None, beside=False):
    """Full-width ``arch`` with random weights from SEED through the
    streamed init (``registry.init_quantized``: each layer and table
    quantized as it is drawn), on the card: (cfg, params); ``n_layers``
    cuts the depth (``dataclasses.replace``), never a width.  Prints its
    shape, its int8 weight bytes, the init's time and the peak memory
    allocated (and what was allocated before the init), which must stay
    under PEAK_BYTES where one is set; ``beside`` (a model the caller
    keeps on the card beside this one) holds the peak over what was
    allocated before the init to it instead."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import tree_weight_bytes
    from repro_torch.models import registry as R

    full = get_config(arch)
    cfg = full if n_layers is None else dataclasses.replace(
        full, n_layers=n_layers)
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
    widths = (f"d_inner={cfg.d_inner}, {cfg.ssm_heads} SSD heads of "
              f"{cfg.ssm_headdim}, state N={cfg.ssm_state}, conv width "
              f"{cfg.conv_width}, chunk {cfg.ssm_chunk}"
              if cfg.family == "ssm" else
              f"{cfg.n_heads} q-heads / {cfg.n_kv_heads} kv-heads of "
              f"{cfg.head_dim}, {experts}ff={cfg.d_ff} gated "
              f"{cfg.activation}")
    if cfg.family == "hybrid":
        widths += (f", blocks {'/'.join(cfg.block_pattern)} repeated and "
                   f"{cfg.n_layers % 3} leftover rec, RG-LRU width "
                   f"{cfg.rnn_width}, conv width {cfg.conv_width}, local "
                   f"window {cfg.local_window}")
    depth = (f"{cfg.n_layers} layers" if n_layers is None else
             f"{cfg.n_layers} of {full.n_layers} layers")
    if cfg.window:
        widths += f", sliding window {cfg.window}"
    if cfg.family == "vlm":
        widths += (f", a gated cross-attention over {cfg.n_patches} patches "
                   f"in every {cfg.xattn_every}th layer ("
                   f"{cfg.n_layers // cfg.xattn_every} of them)")
    print(f"{cfg.family} {arch}: full width ({depth}, d="
          f"{cfg.d_model}, {widths}, vocab={cfg.vocab} "
          f"{'tied' if cfg.tie_embeddings else 'untied'}, {cfg.norm}), W8A16 "
          f"weights {nbytes} bytes, streamed init+quantize {init_s:.1f}s, "
          f"torch.cuda.max_memory_allocated {peak} bytes ({peak / 1e9:.2f} "
          f"GB; {before} allocated before, {peak - before} over it)")
    limit = PEAK_BYTES.get(arch)
    if limit is not None and peak - (before if beside else 0) >= limit:
        raise AssertionError(f"{cfg.family} {arch}: the init's peak {peak} "
                             f"bytes ({before} allocated before it) is not "
                             f"under {limit:.0f}")
    return cfg, params


def build_family_model(arch):
    """``arch`` at full width and FAMILY_LAYERS depth from the streamed
    init, for a family phase's serves, ticks and references; where
    PEAK_BYTES sets a limit, the full-depth init is built first, its peak
    held to the limit, and freed at once."""
    if arch in PEAK_BYTES:
        params = build_dense_model(arch)[1]
        del params
        torch_cuda_empty()
    return build_dense_model(arch, FAMILY_LAYERS[arch])


def dense_serve(label, cfg, params, reqs, **kw):
    """One engine of the dense serves (NUM_SLOTS slots of DENSE_MAX_SEQ,
    chunked prefill of PREFILL_CHUNK; ``kw`` pages it), warmed up, then a
    wall-clock serve of ``reqs`` with the counters zeroed just before and
    read just after: no capture inside it, no plain version, no mma
    launch (a primed config: exactly its primes' mma and flash
    launches), the GEMV launched, the decode attention kernels launched
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
    if cross_layers(cfg):
        # one prime a request (none resumed): its encoder's and cross
        # k/v's mma launches and flash launches, and no other
        want = {k: n * len(reqs) for k, n in prime_launches(cfg).items()}
        if any(launches[k] != n for k, n in want.items()):
            raise AssertionError(f"{label}: launches {launches}, the primes "
                                 f"of {len(reqs)} requests make {want}")
        mma_free(label, dict(launches, **{"qmatmul_w8a16[mma]": 0}))
    else:
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
        lambda: graphed(params, toks, cache, idx, active)[0].cpu(),
        CAPTURED_REPS)
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


def moe_curve_rows(arch=MOE_ARCH) -> tuple:
    """The experts' stacked GEMV's rows in the serve CLI's curve: each of
    the curve's b rows of SERVE_SEQ tokens gives every expert its
    capacity's rows, ceil(SERVE_SEQ * k / E * capacity_factor) = 3 at
    qwen2-moe-a2.7b, so M = 3, 12 and 48 at b = 1, 4 and 16 (mixtral's 8
    give M = 8, 32 and 128)."""
    from repro_torch.configs import get_config

    c = get_config(arch)
    cap = math.ceil(SERVE_SEQ * c.top_k / c.n_experts * c.capacity_factor)
    return tuple(b * cap for b in (1, 4, SERVE_MAX_BATCH))


def moe_tick_live(c, gen):
    """The live mask of one MoE layer at a tick: NUM_SLOTS tokens routed
    by a random int8 router through ``moe.route`` and ``moe.dispatch``
    (capacity 1 a token), ``moe.live_rows`` of the (E, NUM_SLOTS) stack,
    as ``moe_ffn`` builds it."""
    import torch
    from repro_torch.core.quant import quantize_weight
    from repro_torch.models import moe as M

    e = c.n_experts
    router = {"w": quantize_weight(torch.randn(
        (c.d_model, e), generator=gen, device="cuda") * c.d_model ** -0.5)}
    toks = torch.randn((NUM_SLOTS, 1, c.d_model), generator=gen,
                       device="cuda").to(torch.bfloat16)
    _, top_e = M.route(router, toks, c.top_k)
    cap = math.ceil(c.top_k / e * c.capacity_factor)
    place, keep = M.dispatch(top_e, cap, e)
    return M.live_rows(place, keep, e, NUM_SLOTS * cap)


def moe_stack_check(label, path, x, w, ws, kw, flush=None):
    """One expert-stacked entry (``path``) against its plain version
    (bf16_close), every row bitwise alone and in its batch, a stack of
    one bitwise the 2-D launch on the same path.  Returns (output, error,
    err / tol), and with ``flush`` also the device ms of the plain call
    it compared with (:func:`timed_call`)."""
    import torch
    from repro_torch.kernels import qmatmul as K

    out = K.qmatmul_w8a16_experts(x, w, ws, path=path, **kw)
    ref, plain_ms = (timed_call(lambda: K.qmatmul_w8a16_experts_ref(
        x, w, ws, **kw), flush) if flush is not None else
        (K.qmatmul_w8a16_experts_ref(x, w, ws, **kw), None))
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"{label}: bad output")
    err, ratio = bf16_close(out, ref, f32_out=False)
    if ratio > 1.0:
        raise AssertionError(f"{label}: disagrees with its plain version "
                             f"(err/tol={ratio:.3f})")
    for r in range(x.shape[1]):
        one = K.qmatmul_w8a16_experts(x[:, r:r + 1].contiguous(), w, ws,
                                      path=path, **kw)
        if not torch.equal(one[:, 0], out[:, r]):
            raise AssertionError(f"{label}: row {r} differs launched alone")
    one = K.qmatmul_w8a16_experts(x[:1], w[:1], ws[:1], path=path, **kw)
    if not torch.equal(one[0], K.qmatmul_w8a16_on_path(
            path, x[0], w[0], ws[0].reshape(-1).contiguous(), **kw)):
        raise AssertionError(f"{label}: a stack of one is not the 2-D "
                             f"launch on its path")
    if flush is None:
        return out, err, ratio
    return out, err, ratio, plain_ms


def moe_qmatmul_rows(flush, arch=MOE_ARCH, seed=SEED + 11):
    """qmatmul_w8a16 at ``arch``'s shapes (qwen2-moe-a2.7b's 60 experts,
    mixtral-8x22b's 8), over its experts
    (w_gate with the silu drain, w_up, w_down): the GEMV entry at a
    tick's 8 rows each, all live and under the live mask of a tick's
    routing (``moe_tick_live``: the masked launch bitwise the all-live
    one on the routed stack, whose dead rows are zero), and the
    tensor-core entry at the serve CLI curve's rows (``moe_curve_rows``:
    3, 12 and 48); each held to its plain version, every row bitwise
    alone and in its batch, a stack of one bitwise the 2-D launch on its
    path.  Timed beside the plain version and the library call
    (``torch.bmm`` on the bf16-dequantized experts; ``F.linear`` for the
    router): the tick's routed launch beside the all-live one, bound by
    the live experts' bytes and by every expert's; the curve's largest
    (its b = 16 forward) on the tensor-core entry beside the GEMV's.
    Then the 2-D GEMV for the router (d_model x E, f32 x and out) at 8
    rows.  Returns (worst error, {name: tick numbers}, {name: forward
    numbers})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import qmatmul as K

    c = get_config(arch)
    e, m = c.n_experts, NUM_SLOTS
    curve = moe_curve_rows(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    live = moe_tick_live(c, gen)
    n_live = int(live.any(1).sum())
    rows, fwd, worst = {}, {}, 0.0
    print(f"  a tick's routing ({m} tokens, top-{c.top_k}): {n_live} of {e} "
          f"experts live, {int(live.sum())} live rows of {live.numel()}")
    for name, k, n, act in (("w_gate", c.d_model, c.d_ff, "silu"),
                            ("w_up", c.d_model, c.d_ff, "none"),
                            ("w_down", c.d_ff, c.d_model, "none")):
        q = quantize_weight(torch.randn((e, k, n), generator=gen,
                                        device="cuda") * k ** -0.5)
        w, ws = q.values, q.scale
        kw = dict(activation=act, out_dtype=torch.bfloat16)
        wd = (w.float() * ws).to(torch.bfloat16)
        plan = K.gemv_experts_plan(e, k, n)
        w_bytes = w.numel() + ws.numel() * 4
        # the tick: the GEMV, all live, then the routed stack under its mask
        x = torch.randn((e, m, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        _, err, ratio = moe_stack_check(f"moe experts {name} M={m} gemv",
                                        "gemv", x, w, ws, kw)
        xr = torch.where(live.bool()[..., None], x, torch.zeros(
            (), dtype=x.dtype, device="cuda"))
        routed = K.qmatmul_w8a16_experts(xr, w, ws, live=live, **kw)
        if not torch.equal(routed, K.qmatmul_w8a16_experts(xr, w, ws, **kw)):
            raise AssertionError(f"moe experts {name}: the masked GEMV is not "
                                 f"the all-live launch on the routed stack")
        # the check's plain call is the row's plain time
        routed_ref, plain = timed_call(lambda: K.qmatmul_w8a16_experts_ref(
            xr, w, ws, live=live, **kw), flush)
        r_err, r_ratio = bf16_close(routed, routed_ref, f32_out=False)
        del routed_ref
        if r_ratio > 1.0:
            raise AssertionError(f"moe experts {name}: the masked GEMV "
                                 f"disagrees with its plain version "
                                 f"(err/tol={r_ratio:.3f})")
        worst = max(worst, err, r_err)
        print(f"  qmatmul_w8a16_experts {name:6s} gemv E={e} M={m:2d} "
              f"K={k:5d} N={n:5d} act={act:4s} max_abs_err={err:.3e} "
              f"err/tol={ratio:.3f}, routed {r_err:.3e} / {r_ratio:.3f}; "
              f"every row bitwise alone; the masked launch bitwise the "
              f"all-live one")
        ms = time_ms(lambda: K.qmatmul_w8a16_experts(xr, w, ws, live=live,
                                                     **kw), TIMED_ITERS, flush)
        all_ms = time_ms(lambda: K.qmatmul_w8a16_experts(xr, w, ws, **kw),
                         TIMED_ITERS, flush)
        lib = time_ms(lambda: torch.bmm(xr, wd), TIMED_ITERS, flush)
        out_bytes = e * m * n * 2
        every_ms = max((x.numel() * 2 + w_bytes + out_bytes)
                       / HBM_BYTES_PER_S * 1e3,
                       2 * e * m * k * n / BF16_OPS_PER_S * 1e3)
        live_bytes = n_live * (m * k * 2 + w_bytes // e) + out_bytes
        bytes_ms = live_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n_live * m * k * n / BF16_OPS_PER_S * 1e3
        rows[name] = {
            "E": e, "M": m, "K": k, "N": n, "activation": act,
            "live_experts": n_live, "ms": ms, "all_live_ms": all_ms,
            "plain_ms": plain, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "every_expert_bound_ms": every_ms, "library_ms": lib,
            "max_abs_err": max(err, r_err)}
        print(f"  qmatmul_w8a16_experts {name:6s} gemv E={e} M={m:2d} "
              f"routed ms={ms:.4f} (all live {all_ms:.4f}) plain_ms="
              f"{plain:.4f} bmm_ms={lib:.4f} bound_ms={max(bytes_ms, ops_ms):.4f}"
              f" ({n_live} live experts; every expert {every_ms:.4f}; "
              f"{live_bytes / ms / 1e6:.0f} GB/s of the live bytes; plan "
              f"{plan.strips} strips x {plan.splits} splits x {e} experts)")
        del x, xr, routed
        # the forward: the tensor-core entry at the curve's rows
        for mm in curve:
            x = torch.randn((e, mm, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            # at the curve's last M the check's plain call is the timing
            _, err, ratio, *plain = moe_stack_check(
                f"moe experts {name} M={mm} mma", "mma", x, w, ws, kw,
                flush if mm == curve[-1] else None)
            worst = max(worst, err)
            print(f"  qmatmul_w8a16_experts {name:6s} mma  E={e} M={mm:2d} "
                  f"K={k:5d} N={n:5d} act={act:4s} max_abs_err={err:.3e} "
                  f"err/tol={ratio:.3f}; every row bitwise alone, a stack "
                  f"of one bitwise the 2-D mma path")
            if mm != curve[-1]:
                continue
            ms = time_ms(lambda: K.qmatmul_w8a16_experts(x, w, ws, path="mma",
                                                         **kw), TIMED_ITERS,
                         flush)
            gemv_ms = time_ms(lambda: K.qmatmul_w8a16_experts(x, w, ws, **kw),
                              TIMED_ITERS, flush)
            plain, = plain
            lib = time_ms(lambda: torch.bmm(x, wd), TIMED_ITERS, flush)
            bytes_ms = ((x.numel() * 2 + w_bytes + e * mm * n * 2)
                        / HBM_BYTES_PER_S * 1e3)
            ops_ms = 2 * e * mm * k * n / BF16_OPS_PER_S * 1e3
            fwd[name] = {
                "E": e, "M": mm, "K": k, "N": n, "activation": act,
                "ms": ms, "gemv_ms": gemv_ms, "plain_ms": plain,
                "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                "library_ms": lib, "max_abs_err": err}
            print(f"  qmatmul_w8a16_experts {name:6s} mma  E={e} M={mm:2d} "
                  f"ms={ms:.4f} (the GEMV {gemv_ms:.4f}) plain_ms="
                  f"{plain:.4f} bmm_ms={lib:.4f} bound_ms="
                  f"{max(bytes_ms, ops_ms):.4f}")
            del x
        del q, w, ws, wd
    # the router: the 2-D GEMV at N = E (one ragged strip), f32 x and out
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
                 TIMED_ITERS, flush)
    plain = time_ms(lambda: K.qmatmul_w8a16_ref(
        x, w, ws, out_dtype=torch.float32), 1, flush, warmup=False)
    wf = w.float() * ws
    lib = time_ms(lambda: F.linear(x, wf.t()), TIMED_ITERS, flush)
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
    print(f"  qmatmul_w8a16_experts at {arch}'s shapes (the GEMV "
          f"at M = {m}, all live and routed; the mma entry at M = "
          f"{', '.join(map(str, curve))}): within bf16_close, every row "
          f"bitwise alone and in its batch, a stack of one bitwise the 2-D "
          f"launch on its path")
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
    GEMV 8 a layer and the head, the experts' stacked GEMV 3 a layer, each
    under the layer's live mask, which skips the experts no token routed
    to), wall,
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
            or launches["qmatmul_w8a16_experts[gemv]"] != 3 * cfg.n_layers
            or launches["qmatmul_w8a16_experts[mma]"]
            or any(plain.values())):
        raise AssertionError(f"{label}: a replay launched {launches} ({gemv} "
                             f"GEMVs, {3 * cfg.n_layers} stacks expected), "
                             f"plain {plain}")
    res = device_breakdown(
        label, f"captured steady-state slot tick ({S} active rows at "
        f"position {max_seq // 2} of {max_seq}, "
        f"{'int8' if cfg.kv_quant else 'bf16'} cache)",
        lambda: graphed(params, toks, cache, idx, active)[0].cpu(),
        CAPTURED_REPS)
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
    ``reference_outputs``, the same sampled (t = SAMPLE_TEMP) held to the
    sampled reference on MOE_CLI_COMPARE requests, the speculative serve
    held to the greedy one, a paged one held to it, an int8-cache serve
    held to ``reference_outputs``, the captured chunk pass bitwise the
    per-token steps (bf16 contiguous, int8 paged), the captured steady
    tick on each cache against its two floors, then the serve CLI.  Returns the kernel
    rows and the launches of each run."""
    import torch
    from repro_torch import engine as E
    from repro_torch.runtime import prng as P
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    print(f"moe: the kernels at {MOE_ARCH}'s shapes")
    err, rows, fwd_rows = moe_qmatmul_rows(flush)
    moe_route_rows()
    print(f"moe: kernel rows and routing {time.perf_counter() - t0:.1f}s")
    ST.clear_step_cache()
    torch_cuda_empty()
    cfg, params = build_family_model(MOE_ARCH)
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
    eng, rep, _ = dense_serve(f"{label} sampled", cfg, params, reqs,
                              temperature=SAMPLE_TEMP,
                              rng=P.PRNGKey(SEED + 1, device="cuda"))
    compare_sampled(f"{label} sampled", cfg, params, eng,
                    reqs[:MOE_CLI_COMPARE], rep.outputs())
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


# ---------------------------------------------------------------------------
# the encdec family
# ---------------------------------------------------------------------------

ENC_ARCH = "whisper-medium"
# the serve CLI at full whisper-medium width, contiguous bf16 cache: the
# curve's forward encodes SERVE_MAX_BATCH x 1,500 frames beside its
# tokens; 16 requests at 10/s, each primed from its own frames
ENC_SERVE_ARGS = ["--arch", ENC_ARCH, "--rate", "10", "--max-batch",
                  str(SERVE_MAX_BATCH), "--seq", str(SERVE_SEQ),
                  "--decode-tokens", "16", "--n-requests", "16",
                  "--prompt-len", "16", "--gen-tokens", "16",
                  "--prefill-chunk", str(PREFILL_CHUNK), "--deadline-ms",
                  "2000", "--seed", str(SEED)]
ENC_CLI_COMPARE = 4         # requests of the CLI run held to the reference
TIMED_PRIMES = 10           # captured primes a wall timing (host clock)


def cross_layers(cfg) -> int:
    """The layers of a config that cross-attend a primed source: every
    decoder layer of an encdec config, a vlm config's last layer of each
    group of ``xattn_every``; none elsewhere."""
    if cfg.family == "encdec":
        return cfg.n_layers
    return cfg.n_layers // cfg.xattn_every if cfg.family == "vlm" else 0


def prime_launches(cfg) -> dict:
    """The kernel launches of one prime, all on the tensor-core W8A16
    kernel: each cross layer's k and v, and for an encdec config its
    encoder's six projections and flash attention a layer (a vlm
    config's patches are the source: no attention)."""
    enc = cfg.n_enc_layers if cfg.family == "encdec" else 0
    return {"qmatmul_w8a16[mma]": 6 * enc + 2 * cross_layers(cfg),
            "flash_attention_bhsd": enc}


def enc_flash_rows(flush):
    """flash_attention_bhsd at whisper-medium's shapes, hd 64: the encoder
    over 1,500 frames, not causal (BH = 16, one prime; BH = 256, the
    serve CLI curve's batch 16), and the curve's decoder at the same BH:
    its cross-attention (Sq 32 against Skv 1,500, not causal) and its
    causal self-attention over 32 tokens (``source_flash_rows``).
    Returns (worst error, {case: numbers})."""
    from repro_torch.configs import get_config

    c = get_config(ENC_ARCH)
    h, se = c.n_heads, c.enc_seq
    cases = []
    for bh in (h, h * SERVE_MAX_BATCH):
        cases += [(f"encoder BH={bh}", bh, se, se, False),
                  (f"cross BH={bh}", bh, SERVE_SEQ, se, False),
                  (f"self BH={bh}", bh, SERVE_SEQ, SERVE_SEQ, True)]
    return source_flash_rows(flush, c.head_dim, cases, SEED + 17)


def source_flash_rows(flush, hd, cases, seed):
    """flash_attention_bhsd at ``cases`` ((label, BH, Sq, Skv, causal)) of
    head_dim ``hd``, without a window: a primed family's attention over
    its source, not causal, and its causal self-attention; each against
    its plain version (bf16_close) and timed beside SDPA and the bound
    (the score pairs the mask keeps at the bf16 peak, or q, k, v and the
    output over the memory rate).  Returns (worst error, {case:
    numbers})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA

    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst, rows = 0.0, {}
    for label, bh, sq, skv, causal in cases:
        q = torch.randn((bh, sq, hd), generator=gen,
                        device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((bh, skv, hd), generator=gen, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        kw = dict(causal=causal)
        out = FA.flash_attention_bhsd(q, k, v, **kw)
        ref = FA.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"flash {label}: bad output")
        err, ratio = bf16_close(out, ref, f32_out=False)
        del ref
        if ratio > 1.0:
            raise AssertionError(f"flash {label}: kernel disagrees with its "
                                 f"plain version beyond tolerance "
                                 f"(err/tol={ratio:.3f})")
        worst = max(worst, err)
        ms = time_ms(lambda: FA.flash_attention_bhsd(q, k, v, **kw),
                     TIMED_ITERS, flush)
        plain = time_ms(lambda: FA.flash_attention_ref(q, k, v, **kw), 1,
                        flush, warmup=False)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=causal), TIMED_ITERS, flush)
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        bytes_ms = (2 * sq + 2 * skv) * bh * hd * 2 / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * bh * pairs * hd / BF16_OPS_PER_S * 1e3
        rows[label] = {"BH": bh, "Sq": sq, "Skv": skv, "hd": hd,
                       "causal": causal, "ms": ms, "plain_ms": plain,
                       "bound_ms": max(bytes_ms, ops_ms),
                       "bound_by": ("bytes" if bytes_ms >= ops_ms
                                    else "operations"),
                       "library_ms": lib, "max_abs_err": err}
        print(f"  flash_attention_bhsd {label:14s} Sq={sq:4d} Skv={skv:4d} "
              f"hd={hd} {'causal' if causal else 'not causal'} "
              f"max_abs_err={err:.3e} err/tol={ratio:.3f} ms={ms:.4f} "
              f"plain_ms={plain:.4f} library_ms={lib:.4f} (SDPA) bound_ms="
              f"{max(bytes_ms, ops_ms):.5f} "
              f"({rows[label]['bound_by']}; ms / bound "
              f"{ms / max(bytes_ms, ops_ms):.1f})")
        del q, k, v, out
    FA.flash_attention_bhsd.launches = 0
    FA.flash_attention_ref.calls = 0
    return worst, rows


def enc_qmatmul_rows(flush):
    """qmatmul_w8a16 at whisper-medium's shapes (K 1,024 with N 1,024 and
    4,096, K 4,096 with N 1,024), at every M its paths run: a prime's
    1,500 rows (the encoder and the cross k/v) through both kernels, the
    mma path's rows equal alone and in slices of 17; the serve CLI
    curve's b = 16 forward on the mma path at its encoder's 16 x 1,500 =
    24,000 rows and its decoder's 16 x 32 = 512; a tick's M = 8 through
    both kernels; each against the plain version and timed on the path
    that runs it.  Then the tied LM head, whose 51,865 columns the head
    pads to 51,868: both kernels at M = 8 (a tick) and the mma path at M
    = 512 (the curve's decoder), the first 51,865 columns of each against
    the plain version of the unpadded head and the padding columns
    exactly 0.  Returns (worst error, {shape: numbers})."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_embedding
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import qmatmul as K
    from repro_torch.models import layers as L

    c = get_config(ENC_ARCH)
    d, ff, se = c.d_model, c.d_ff, c.enc_seq
    gen = torch.Generator(device="cuda").manual_seed(SEED + 19)
    rows, worst = {}, 0.0

    def numbers(x, w, ws, act, odt, path, plain_iters, plain_ms=None):
        t = w8a16_numbers(x, w, ws, None, act, odt, (path,), plain_iters,
                          flush, plain_ms)
        return {"K": x.shape[1], "N": w.shape[1], "M": x.shape[0],
                "path": path, "activation": act, "ms": t["ms"][path],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"]}

    # (M, the paths held to the plain version, the path timed)
    ms_rows = ((se, K.W8A16_PATHS, "mma"),
               (SERVE_MAX_BATCH * se, ("mma",), "mma"),
               (SERVE_ROWS, ("mma",), "mma"),
               (NUM_SLOTS, K.W8A16_PATHS, "gemv"))
    for name, k, n, act in (("wq|wk|wv|wo", d, d, "none"),
                            ("w_up", d, ff, "gelu"),
                            ("w_down", ff, d, "none")):
        q = quantize_weight(torch.randn((k, n), generator=gen,
                                        device="cuda") * k ** -0.5)
        w, ws = q.values, q.scale.reshape(-1).contiguous()
        odt = torch.bfloat16
        for m, paths, path in ms_rows:
            x = torch.randn((m, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            # away from a tick's M the check's plain call is its timing
            ref, plain_ms = timed_call(lambda: K.qmatmul_w8a16_ref(
                x, w, ws, activation=act, out_dtype=odt), flush) \
                if m != NUM_SLOTS else (K.qmatmul_w8a16_ref(
                    x, w, ws, activation=act, out_dtype=odt), None)
            err, ratio = w8a16_check(f"{name} M={m}", x, w, ws, None, act,
                                     odt, ref, paths)
            del ref
            if m == se:
                w8a16_rows_check(x, w, ws, None, act, odt)
            worst = max(worst, err)
            row = numbers(x, w, ws, act, odt, path, 3, plain_ms)
            row["max_abs_err"] = err
            rows[f"{name} M={m}"] = row
            print(f"  qmatmul_w8a16 {name:11s} M={m:5d} K={k:4d} N={n:4d} "
                  f"act={act:4s} max_abs_err={err:.3e} err/tol={ratio:.3f} "
                  f"({', '.join(paths)}) {path}_ms={row['ms']:.4f} plain_ms="
                  f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f}"
                  f" bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
            del x
        del q, w, ws
    # the tied LM head: a (V, D) int8 table, its padded (D, Vp) head
    v = c.vocab
    table = quantize_embedding(torch.randn((v, d), generator=gen,
                                           device="cuda") * d ** -0.5)
    head = L.lm_head(table)
    w, ws = head.values, head.scale
    if w.shape != (d, v + (-v) % 4) or w[:, v:].any() or ws[v:].any():
        raise AssertionError(f"lm_head: padded head {tuple(w.shape)} with "
                             f"non-zero padding")
    w_plain = table.values.t().contiguous()
    s_plain = table.scale.reshape(-1).contiguous()
    for m, paths in ((NUM_SLOTS, K.W8A16_PATHS), (SERVE_ROWS, ("mma",))):
        x = torch.randn((m, d), generator=gen,
                        device="cuda").to(torch.bfloat16)
        ref = K.qmatmul_w8a16_ref(x, w_plain, s_plain,
                                  out_dtype=torch.float32)
        for path in paths:
            out = K.qmatmul_w8a16_on_path(path, x, w, ws,
                                          out_dtype=torch.float32)
            torch.cuda.synchronize()
            if out[:, v:].any() or not torch.isfinite(out).all():
                raise AssertionError(f"lm_head M={m} ({path}): padding "
                                     f"columns not 0, or not finite")
            err, ratio = bf16_close(out[:, :v], ref, f32_out=True)
            if ratio > 1.0:
                raise AssertionError(f"lm_head M={m} ({path}): kernel "
                                     f"disagrees with the unpadded head's "
                                     f"plain version (err/tol={ratio:.3f})")
            worst = max(worst, err)
        path = "gemv" if m == NUM_SLOTS else "mma"
        row = numbers(x, w, ws, "none", torch.float32, path, 1)
        row.update(max_abs_err=err, vocab=v)
        rows[f"lm_head M={m}"] = row
        print(f"  qmatmul_w8a16 lm_head     M={m:4d} K={d:4d} N={v} (padded "
              f"to {w.shape[1]}) max_abs_err={err:.3e} err/tol={ratio:.3f} "
              f"({', '.join(paths)}) {path}_ms={row['ms']:.4f} plain_ms="
              f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
        del ref
    zero_counts()
    return worst, rows


def prime_time(cfg, params, label):
    """The captured prime (``runtime/steps.py::jit_prime_step``) into a
    NUM_SLOTS-row cache: its launches a replay (prime_launches), then
    wall, device busy and the device time of its flash attention, its
    W8A16 projections and the rest, over TIMED_PRIMES replays into
    rotating slots."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    graphed = ST.jit_prime_step(ST.make_prime_step(cfg, mode=W8A16))
    g = torch.Generator(device="cuda").manual_seed(SEED + 21)
    src_len = R.source_len(cfg)
    with torch.inference_mode():
        cache = R.init_cache(cfg, NUM_SLOTS, DENSE_MAX_SEQ, device="cuda")
        src = torch.randn((1, src_len, cfg.d_model), generator=g,
                          device="cuda").to(torch.bfloat16)
        t0 = time.perf_counter()
        graphed(params, src, cache, 0, src_len)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        zero_counts()
        graphed(params, src, cache, 1, src_len - 2)
        torch.cuda.synchronize()
    launches, plain = read_counts()
    want = prime_launches(cfg)
    if any(launches[k] != n for k, n in want.items()) or \
            launches["qmatmul_w8a16[gemv]"] or any(plain.values()):
        raise AssertionError(f"{label}: a replay launched {launches} "
                             f"({want} expected), plain {plain}")
    if cache["xlen"][:2].tolist() != [src_len, src_len - 2]:
        raise AssertionError(f"{label}: xlen {cache['xlen'].tolist()}")
    turn = iter(range(10 ** 6))
    what = (f"{cfg.n_enc_layers} encoder layers and {cfg.n_layers} layers'"
            f" cross k/v" if cfg.family == "encdec" else
            f"{cross_layers(cfg)} cross layers' k/v")
    res = device_breakdown(
        label, f"captured prime (1 x {src_len} source rows: {what})",
        lambda: graphed(params, src, cache, next(turn) % NUM_SLOTS,
                        src_len), TIMED_PRIMES)
    split = {"flash attention": 0.0, "qmatmul_w8a16 mma": 0.0,
             "the rest": 0.0}
    for key, ms in res["by_kernel"].items():
        part = ("flash attention" if "flash" in key else
                "qmatmul_w8a16 mma" if "qmatmul" in key else "the rest")
        split[part] += ms
    print(f"{label}: {launches['qmatmul_w8a16[mma]']} mma launches and "
          f"{launches['flash_attention_bhsd']} flash launches a replay; "
          f"capture {capture_s:.2f} s; device time by part: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    graphed.captured.release()
    return {"wall": res["wall"], "busy": res["busy"], "split": split}


def primed_tick_time(cfg, params, label):
    """The captured steady tick of a primed family's serves: NUM_SLOTS
    rows at DENSE_MAX_SEQ / 2, each primed (xlen the whole source, one
    and two rows less in turn): its launches a replay (``step_gemvs`` and
    the head), wall, device busy and the device time of its GEMVs against
    the rest, and the cross-attention alone
    (``layers.cross_cache_attention``, plain PyTorch, at the tick's
    shapes, times the cross layers) beside the tick's busy time, against
    the floor of what it must read at 3.35 TB/s: the layers' int8 weights
    but the cross wk / wv, the head, each row's cross k/v up to its xlen
    and its self k/v."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.core.quant import tree_weight_bytes
    from repro_torch.models import layers as L
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    S, max_seq = NUM_SLOTS, DENSE_MAX_SEQ
    src_len, n_cross = R.source_len(cfg), cross_layers(cfg)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(
        cfg, mode=W8A16))
    prime = ST.make_prime_step(cfg, mode=W8A16)
    g = torch.Generator(device="cuda").manual_seed(SEED + 23)
    with torch.inference_mode():
        cache = R.init_cache(cfg, S, max_seq, device="cuda")
        for sid in range(S):
            prime(params, torch.randn((1, src_len, cfg.d_model),
                                      generator=g, device="cuda").to(
                torch.bfloat16), cache, sid, src_len - sid % 3)
        toks = torch.randint(1, cfg.vocab, (S, 1), generator=g,
                             device="cuda", dtype=torch.int32)
        idx = torch.full((S,), max_seq // 2, dtype=torch.int32,
                         device="cuda")
        active = torch.ones((S,), dtype=torch.bool, device="cuda")
        eager = ST.make_slot_decode_step(cfg, mode=W8A16)(
            params, toks, {k: v.clone() for k, v in cache.items()}, idx,
            active)[0].cpu()
        t0 = time.perf_counter()
        got = graphed(params, toks, cache, idx, active)[0].cpu()
        capture_s = time.perf_counter() - t0
        if not torch.equal(got, eager):
            raise AssertionError(f"{label}: the captured tick's tokens "
                                 f"differ from the eager tick's")
        zero_counts()
        graphed(params, toks, cache, idx, active)[0].cpu()
    launches, plain = read_counts()
    gemv = step_gemvs(cfg) + 1
    if (launches["qmatmul_w8a16[gemv]"] != gemv
            or launches["qmatmul_w8a16[mma]"] or any(plain.values())
            or launches["flash_attention_bhsd"]):
        raise AssertionError(f"{label}: a replay launched {launches} "
                             f"({gemv} GEMVs expected), plain {plain}")
    res = device_breakdown(
        label, f"captured steady-state slot tick ({S} active rows at "
        f"position {max_seq // 2} of {max_seq}, bf16 cache, cross k/v of "
        f"{src_len} source rows a row)",
        lambda: graphed(params, toks, cache, idx, active)[0].cpu(),
        CAPTURED_REPS)
    gemv_ms = sum(ms for key, ms in res["by_kernel"].items()
                  if "qmatmul" in key)
    q = torch.randn((S, 1, cfg.n_heads, cfg.head_dim), generator=g,
                    device="cuda").to(torch.bfloat16)
    cross_ms = n_cross * time_ms(lambda: L.cross_cache_attention(
        q, cache["xk"][0], cache["xv"][0], cache["xlen"]), 10,
        lambda: None)
    # what a tick must read: the layers' weights less the cross wk / wv
    # (a prime projected the source already), the head, each row's
    # cross k/v up to its xlen and its self k/v up to its position
    layers = params.get("dec_layers", params.get("layers"))
    cross_key = "cross_attn" if cfg.family == "encdec" else "xattn"
    weights = tree_weight_bytes(params.get("unembed", params["embed"])) + sum(
        tree_weight_bytes(lp) - (
            tree_weight_bytes(lp[cross_key]["wk"])
            + tree_weight_bytes(lp[cross_key]["wv"]) if cross_key in lp
            else 0) for lp in layers)
    kv_row = cfg.n_kv_heads * cfg.head_dim * 2 * 2
    cross_bytes = int(cache["xlen"].sum()) * kv_row * n_cross
    self_bytes = int((idx + 1).sum()) * kv_row * cfg.n_layers
    read = weights + cross_bytes + self_bytes
    floor = read / HBM_BYTES_PER_S * 1e3
    busy = res["busy"]
    share = ("not measured" if busy is None
             else f"{100 * cross_ms / busy:.1f}% of the busy time")
    print(f"{label}: {launches['qmatmul_w8a16[gemv]']} GEMVs a replay; "
          f"capture {capture_s:.2f} s; wall {res['wall']:.2f} ms, device "
          f"busy {'not measured' if busy is None else f'{busy:.3f} ms'}, "
          f"cudaGraphLaunch {res['graph_launches']:.0f} a tick; the GEMVs "
          f"{gemv_ms:.3f} ms of device time; the cross-attention alone "
          f"(plain PyTorch, {n_cross} layers x {S} rows x "
          f"{src_len} source rows) {cross_ms:.3f} ms, {share}; floor "
          f"{floor:.3f} ms (the {read} bytes a tick reads at 3.35 TB/s: "
          f"{weights} of int8 weights and head, {cross_bytes} of cross k/v "
          f"to each row's xlen, {self_bytes} of self k/v): wall / floor "
          f"{res['wall'] / floor:.2f}, busy / floor "
          f"{'not measured' if busy is None else f'{busy / floor:.2f}'}")
    graphed.captured.release()
    return {"wall": res["wall"], "busy": busy, "gemv_ms": gemv_ms,
            "cross_ms": cross_ms, "floor": floor, "read_bytes": read,
            "weight_bytes": weights, "cross_kv_bytes": cross_bytes}


def enc_cli_phase():
    """The serve CLI at full whisper-medium width (ENC_SERVE_ARGS): exit 0,
    the service curve's forward (1,500 zero frames a row beside the
    tokens) on the mma path and flash attention, the decode loop on a
    zero cross k/v, the engine priming every request, and ENC_CLI_COMPARE
    requests equal to ``reference_outputs``."""
    from repro_torch.launch import serve

    real_curve = serve.measure_service_curve
    curve_paths = {}
    serve.measure_service_curve = counted_curve(real_curve, curve_paths)
    label = f"serve {ENC_ARCH}"
    try:
        launches, res = serve_run("w8a16", curve_paths, base=ENC_SERVE_ARGS,
                                  label=label)
    finally:
        serve.measure_service_curve = real_curve
    rep = res.report
    if any(r.source is None for r in res.requests):
        raise AssertionError(f"{label}: a request carries no source")
    rids = {r.rid for r in res.requests[:ENC_CLI_COMPARE]}
    compare_with_reference(label, res.cfg, res.params, res.engine,
                           [r for r in res.requests if r.rid in rids],
                           rep.outputs())
    del res
    torch_cuda_empty()
    return launches


def serve_busy(eng, reqs) -> float:
    """Device busy ms of one more wall-clock serve of ``reqs`` on a warm
    engine, from torch.profiler (None where it reports no device time)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.serve(reqs, clock="wall")
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA"))
    return us / 1e3 if us > 0 else None


def enc_serve_line(label, rep, busy) -> dict:
    """A serve's ticks, wall, tok/s and device busy share, printed."""
    wall = rep.wall_s * 1e3
    out = {"ticks": rep.ticks, "wall_ms": wall,
           "tok_s": rep.generated_tokens / rep.wall_s, "busy_ms": busy,
           "peak_blocks_used": rep.peak_blocks_used}
    print(f"{label}: {rep.ticks} ticks, wall {wall:.1f} ms, "
          f"{out['tok_s']:.1f} tok/s, {wall / rep.ticks:.2f} ms a tick; a "
          f"profiled serve's device busy "
          + ("not measured (profiled in a --only run)" if busy is None
             else f"{busy:.1f} ms ({busy / rep.ticks:.2f} ms a tick)")
          + f"; peak blocks {rep.peak_blocks_used}")
    return out


def encdec_phase(flush, profile_serves=False):
    """whisper-medium at full width (24 encoder and 24 decoder layers, d
    1,024, 16 heads of 64, vocab 51,865 tied): the kernel rows at its
    shapes, then the model from the streamed init, served contiguous
    (every request primed at admission; launches counted, no capture
    inside) and held to ``reference_outputs``, served paged (blocks of
    DENSE_BLOCK, fewer than the contiguous equivalent) with every token
    equal to the contiguous serve's and no block leaked, the captured
    prime and the captured tick timed, then the serve CLI.  Returns the
    kernel rows, the launches of each run and the times."""
    import numpy as np
    import torch
    from repro_torch import engine as E
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    print(f"encdec: the kernels at {ENC_ARCH}'s shapes")
    f_err, f_rows = enc_flash_rows(flush)
    q_err, q_rows = enc_qmatmul_rows(flush)
    print(f"encdec: kernel rows {time.perf_counter() - t0:.1f}s")
    torch_cuda_empty()
    cfg, params = build_dense_model(ENC_ARCH)
    reqs = E.synthetic_requests(
        DENSE_REQUESTS, rate_per_s=DENSE_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=DENSE_PROMPT, max_new_tokens=DENSE_NEW,
        shared_prefix_len=DENSE_SHARED, seed=SEED,
        source_shape=R.source_shape(cfg))
    out = {"flash_rows": f_rows, "flash_err": f_err, "qmatmul_rows": q_rows,
           "qmatmul_err": q_err}
    label = f"encdec {ENC_ARCH}"
    eng, rep, out["launches"] = dense_serve(f"{label} contiguous", cfg,
                                            params, reqs)
    print(f"{label} contiguous: the cross k/v of {eng.num_slots} slots "
          f"{eng._cache['xk'].numel() * 4} bytes "
          f"({eng._cache['xk'].numel() * 4 / eng.num_slots / 1e6:.1f} MB a "
          f"slot); torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes")
    compare_with_reference(f"{label} contiguous", cfg, params, eng, reqs,
                           rep.outputs())
    contig = rep.outputs()
    # where the paged serve's time goes: each serve's ticks (and, where
    # ``profile_serves``, its device busy over one more serve), the paged
    # one on the dense serves' pool and on a pool as large as the
    # contiguous cache
    def busy(eng):
        return serve_busy(eng, reqs) if profile_serves else None

    out["serves"] = {"contiguous": enc_serve_line(
        f"{label} contiguous", rep, busy(eng))}
    del eng
    full_pool = 1 + NUM_SLOTS * (DENSE_MAX_SEQ // DENSE_BLOCK)
    for key, nb in (("paged", DENSE_NUM_BLOCKS),
                    ("paged, full pool", full_pool)):
        eng, rep, launches = dense_serve(
            f"{label} {key}", cfg, params, reqs, block_size=DENSE_BLOCK,
            num_blocks=nb)
        if key == "paged":
            out["paged_launches"] = launches
        print(f"{label} {key}: block_size {rep.block_size}, num_blocks "
              f"{rep.num_blocks}, peak_blocks_used {rep.peak_blocks_used}, "
              f"leaked_blocks {rep.leaked_blocks}, shared_block_hits "
              f"{rep.shared_block_hits} (each request's own frames seed "
              f"its prefix keys)")
        if rep.outputs() != contig or rep.leaked_blocks:
            raise AssertionError(f"{label} {key}: tokens differ from the "
                                 f"contiguous serve's, or "
                                 f"{rep.leaked_blocks} blocks leaked")
        print(f"{label} {key}: every token of {len(contig)} requests equal "
              f"to the contiguous serve's")
        out["serves"][key] = enc_serve_line(f"{label} {key}", rep,
                                            busy(eng))
        del eng
    src = reqs[0].source
    t1 = time.perf_counter()
    for _ in range(5):
        hash((src.shape, np.asarray(src, np.float32).tobytes()))
    out["seed_ms"] = (time.perf_counter() - t1) * 1e3 / 5
    print(f"{label}: a source's prefix-key seed ({src.shape[0]} frames: "
          f"its bytes copied and hashed) {out['seed_ms']:.2f} ms on the "
          f"host, made once a source")
    ST.clear_step_cache()
    torch_cuda_empty()
    print(f"encdec: serves {time.perf_counter() - t0:.1f}s")
    out["prime"] = prime_time(cfg, params, f"{label} prime")
    out["tick"] = primed_tick_time(cfg, params, f"{label} tick")
    print(f"encdec: prime and tick {time.perf_counter() - t0:.1f}s")
    ST.clear_step_cache()
    del params
    torch_cuda_empty()
    out["cli"] = enc_cli_phase()
    ST.clear_step_cache()
    torch_cuda_empty()
    out["seconds"] = time.perf_counter() - t0
    print(f"encdec: phase {out['seconds']:.1f}s; "
          f"{torch.cuda.memory_allocated()} bytes left allocated")
    return out


# ---------------------------------------------------------------------------
# the ssm family
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-1.3b"
# the serve CLI at full mamba2-1.3b width, contiguous (the family does not
# page): the dense CLI's curve and engine geometry, 16 requests of 16 + 16
# tokens at 10/s
SSM_SERVE_ARGS = ["--arch", SSM_ARCH, "--rate", "10", "--max-batch",
                  str(SERVE_MAX_BATCH), "--seq", str(SERVE_SEQ),
                  "--decode-tokens", "16", "--n-requests", "16",
                  "--prompt-len", "16", "--gen-tokens", "16",
                  "--prefill-chunk", str(PREFILL_CHUNK), "--deadline-ms",
                  "2000", "--seed", str(SEED)]
SSM_CLI_COMPARE = 4         # requests of the CLI run held to the reference
# the overload serve: the dense trace on 4 slots, its odd rids in the
# batch class arriving at once, its even rids interactive SSM_LATE_S
# later (while the batch class holds every slot), with preemption, a
# non-finite sample and a failed dispatch: (kind, tick, slot)
SSM_OVERLOAD_SLOTS = 4
SSM_LATE_S = 0.05
SSM_OVERLOAD_FAULTS = (("nan_logits", 6, 1), ("dispatch", 9, 2))
# the W8A16 and W8A8 kernels at mamba2-1.3b's projections: (name, K, N,
# launches of a decode step)
SSM_SHAPES = (("in_proj", 2048, 8512, 48), ("out_proj", 4096, 2048, 48))


def family_qmatmul_rows(flush, arch, shapes, seed):
    """qmatmul_w8a16 and qmatmul_w8a8 at ``arch``'s ``shapes`` ((name, K,
    N, launches a decode step)): W8A16 at a tick's M = NUM_SLOTS through
    both kernels (the GEMV timed, its rows equal alone) and at the CLI
    curve's M = SERVE_ROWS on the mma path (its rows equal alone and in
    slices of 17), then the tied head the same way; W8A8 at M = NUM_SLOTS
    (its GEMV) and SERVE_ROWS (mma.sync), the int32 sums bitwise.  Each
    against its plain version and timed beside the bound and a library
    call (``F.linear`` on bf16 weights; W8A8: ``torch._int_mm`` + drain
    where the build takes the shape).  Returns (worst W8A16 error, {shape:
    numbers}, worst W8A8 error, {shape: numbers}, {M: one tick's or
    forward's W8A16 launches summed})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_embedding
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import qmatmul as K
    from repro_torch.models import layers as L

    c = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, worst = {}, 0.0
    keys = ("ms", "plain_ms", "bound_ms", "library_ms", "bytes_ms", "ops_ms")
    # a tick's GEMVs (every layer's two and the head) and the curve's
    # forward on the mma path, summed
    per_m = {m: dict.fromkeys(keys, 0.0) for m in (NUM_SLOTS, SERVE_ROWS)}

    def numbers(label, x, w, ws, odt, path, plain_iters, times, err,
                ratio, paths, plain_ms=None):
        t = w8a16_numbers(x, w, ws, None, "none", odt, (path,), plain_iters,
                          flush, plain_ms)
        row = {"K": x.shape[1], "N": w.shape[1], "M": x.shape[0],
               "path": path, "ms": t["ms"][path], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
               "library_ms": t["library_ms"], "bytes_ms": t["bytes_ms"],
               "ops_ms": t["ops_ms"], "max_abs_err": err, "err_tol": ratio}
        for key in keys:
            per_m[x.shape[0]][key] += times * row[key]
        print(f"  qmatmul_w8a16 {label:9s} M={x.shape[0]:4d} K={x.shape[1]:4d}"
              f" N={w.shape[1]:5d} max_abs_err={err:.3e} err/tol="
              f"{ratio:.3f} ({', '.join(paths)}) {path}_ms={row['ms']:.4f} "
              f"plain_ms={row['plain_ms']:.4f} library_ms="
              f"{row['library_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']})")
        return row

    for name, k, n, count in shapes:
        q = quantize_weight(torch.randn((k, n), generator=gen,
                                        device="cuda") * k ** -0.5)
        w, ws = q.values, q.scale.reshape(-1).contiguous()
        odt = torch.bfloat16
        for m, paths, path in ((NUM_SLOTS, K.W8A16_PATHS, "gemv"),
                               (SERVE_ROWS, ("mma",), "mma")):
            x = torch.randn((m, k), generator=gen,
                            device="cuda").to(torch.bfloat16)
            # at the forward's M the check's plain call is its timing
            ref, plain_ms = timed_call(lambda: K.qmatmul_w8a16_ref(
                x, w, ws, out_dtype=odt), flush) if m == SERVE_ROWS else (
                K.qmatmul_w8a16_ref(x, w, ws, out_dtype=odt), None)
            err, ratio = w8a16_check(f"{name} M={m}", x, w, ws, None, "none",
                                     odt, ref, paths)
            del ref
            if m == NUM_SLOTS:
                gemv_rows_check(name, torch.randn(
                    (2 * NUM_SLOTS, k), generator=gen, device="cuda").to(
                    torch.bfloat16), w, ws, None, "none", odt)
            else:
                w8a16_rows_check(x, w, ws, None, "none", odt)
            worst = max(worst, err)
            rows[f"{name} M={m}"] = numbers(
                name, x, w, ws, odt, path, 3, count, err, ratio, paths,
                plain_ms)
        del q, w, ws
    table = quantize_embedding(torch.randn((c.vocab, c.d_model),
                                           generator=gen, device="cuda")
                               * c.d_model ** -0.5)
    head = L.lm_head(table)
    w, ws = head.values, head.scale
    if w.shape != (c.d_model, c.vocab):
        raise AssertionError(f"lm_head: {tuple(w.shape)} for vocab "
                             f"{c.vocab} (N % 4 == 0 needs no padding)")
    for m, paths, path in ((NUM_SLOTS, K.W8A16_PATHS, "gemv"),
                           (SERVE_ROWS, ("mma",), "mma")):
        x = torch.randn((m, c.d_model), generator=gen,
                        device="cuda").to(torch.bfloat16)
        ref, plain_ms = timed_call(lambda: K.qmatmul_w8a16_ref(
            x, w, ws, out_dtype=torch.float32), flush)
        err, ratio = w8a16_check(f"lm_head M={m}", x, w, ws, None, "none",
                                 torch.float32, ref, paths)
        del ref
        worst = max(worst, err)
        rows[f"lm_head M={m}"] = numbers("lm_head", x, w, ws, torch.float32,
                                         path, 1, 1, err, ratio, paths,
                                         plain_ms)
    del table, head, w, ws
    for m, what in ((NUM_SLOTS, "tick"), (SERVE_ROWS, "forward")):
        t = per_m[m]
        print(f"  qmatmul_w8a16 per {arch} {what} (M = {m}: "
              + ", ".join(f"{count} x {name}" for name, _, _, count in shapes)
              + " and the head): "
              f"ms={t['ms']:.4f} bound_ms={t['bound_ms']:.4f} plain_ms="
              f"{t['plain_ms']:.4f} library_ms={t['library_ms']:.4f}")
    # qmatmul_w8a8 at the same projections (the head stays weight-only
    # int8 under --quant w8a8)
    w8_rows, w8_worst = {}, 0.0
    for name, k, n, _ in shapes:
        x = torch.randint(-127, 128, (SERVE_ROWS, k), generator=gen,
                          device="cuda", dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                          dtype=torch.int8)
        xs = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-3
        ws = torch.rand((n,), generator=gen, device="cuda") * 2e-3 + 1e-4
        w_lib = (w.float() * ws).to(torch.bfloat16).t()
        for m in (NUM_SLOTS, SERVE_ROWS):
            xm = x[:m].contiguous()
            label = f"{name} M={m} ({K.w8a8_path(m)})"
            err, ratio, bitwise, plain = w8a8_check(label, xm, w, xs, ws,
                                                    None, "none", flush)
            w8_worst = max(w8_worst, err)
            kw = dict(out_dtype=torch.bfloat16)
            ms = time_ms(lambda: K.qmatmul_w8a8(xm, w, xs, ws, **kw),
                         TIMED_ITERS, flush)

            def int_mm():
                return (torch._int_mm(xm, w).float() * xs * ws).to(
                    torch.bfloat16)

            try:
                int_mm()
                lib_fn, lib_name = int_mm, "torch._int_mm + drain"
            except RuntimeError:
                lib_fn = lambda: F.linear(  # noqa: E731
                    xm.to(torch.bfloat16) * xs.to(torch.bfloat16), w_lib)
                lib_name = "F.linear, bf16 weights"
            lib = time_ms(lib_fn, TIMED_ITERS, flush)
            bytes_ms = ((m * k + k * n + 4 + 4 * n + 2 * m * n)
                        / HBM_BYTES_PER_S * 1e3)
            ops_ms = 2 * m * k * n / INT8_OPS_PER_S * 1e3
            row = {"K": k, "N": n, "M": m, "path": K.w8a8_path(m), "ms": ms,
                   "plain_ms": plain, "bound_ms": max(bytes_ms, ops_ms),
                   "bound_by": ("bytes" if bytes_ms >= ops_ms
                                else "operations"),
                   "library_ms": lib, "library": lib_name,
                   "max_abs_err": err, "err_tol": ratio,
                   "drain_bitwise": bitwise}
            w8_rows[f"{name} M={m}"] = row
            print(f"  qmatmul_w8a8 {name:9s} M={m:4d} K={k:4d} N={n:5d} "
                  f"path={row['path']} int32_bitwise=True drain_bitwise="
                  f"{bitwise} max_abs_err={err:.3e} err/tol={ratio:.3f} "
                  f"ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
                  f"({lib_name}) bound_ms={row['bound_ms']:.4f} "
                  f"({row['bound_by']})")
        del x, w, w_lib
    zero_counts()
    return worst, rows, w8_worst, w8_rows, per_m


def ssm_state_bytes(cfg, rows: int) -> int:
    """Bytes of ``rows`` slots' decode state: h (f32) and the conv tail
    (bf16) of every layer."""
    return rows * cfg.n_layers * (
        cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4
        + (cfg.conv_width - 1) * (cfg.d_inner + 2 * cfg.ssm_state) * 2)


def recurrent_tick(cfg, params, label, *, max_seq, positions, seed,
                   state_bytes, ring_bytes=0, per_row=False, extra=None):
    """The captured tick of a recurrent family on the card: NUM_SLOTS rows
    of a ``max_seq`` cache with every leaf random, at ``positions``.  The
    captured tick's tokens and every cache leaf bitwise the eager tick's;
    with ``per_row``, the eager decode step's logits and leaves, row by
    row, bitwise the row's batch-1 step (a lockstep index on the row
    alone); the freeze (rows 1, 3, 5, 7 inactive, row 1 at index 0: their
    recurrent state bitwise unchanged, the active rows as in the
    all-active tick; a ring is positional and not frozen); a replay's
    launches (every projection's GEMV and the head, nothing else
    counted); then wall, device busy and the GEMVs' share beside the
    floor: the int8 weights and head, ``state_bytes`` read and written
    once and ``ring_bytes`` read once, at 3.35 TB/s.  ``extra(cache,
    active)`` adds the family's own measurements to the result."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.core.quant import tree_weight_bytes
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    S = NUM_SLOTS
    eager = ST.make_slot_decode_step(cfg, mode=W8A16)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(
        cfg, mode=W8A16))
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache = _random_cache(cfg, S, max_seq, 0)
    axes = R.cache_batch_axes(cfg, cache)
    state = [k for k in cache if k not in ("k", "v")]
    with torch.inference_mode():
        toks = torch.randint(1, cfg.vocab, (S, 1), generator=g,
                             device="cuda", dtype=torch.int32)
        idx = torch.tensor(positions, dtype=torch.int32, device="cuda")
        active = torch.ones((S,), dtype=torch.bool, device="cuda")
        start = {k: v.clone() for k, v in cache.items()}
        want = {k: v.clone() for k, v in cache.items()}
        nxt_e = eager(params, toks, want, idx, active)[0].cpu()
        t0 = time.perf_counter()
        nxt_g = graphed(params, toks, cache, idx, active)[0].cpu()
        capture_s = time.perf_counter() - t0
        if not torch.equal(nxt_g, nxt_e) or any(
                not torch.equal(cache[k], want[k]) for k in cache):
            raise AssertionError(f"{label}: the captured tick differs from "
                                 f"the eager tick")
        if per_row:
            decode = ST.make_decode_step(cfg, mode=W8A16)
            full = {k: v.clone() for k, v in start.items()}
            logits, _ = decode(params, {"tokens": toks, "cache_index": idx},
                               full)
            if any(not torch.equal(full[k], want[k]) for k in full) or \
                    not torch.equal(logits[:, -1].argmax(-1).int().cpu(),
                                    nxt_e):
                raise AssertionError(f"{label}: the decode step differs "
                                     f"from the all-active tick")
            for r in range(S):
                row = {k: v.narrow(axes[k], r, 1).clone()
                       for k, v in start.items()}
                one, _ = decode(params, {"tokens": toks[r:r + 1],
                                         "cache_index": positions[r]}, row)
                if not torch.equal(one[0], logits[r]) or any(
                        not torch.equal(row[k],
                                        full[k].narrow(axes[k], r, 1))
                        for k in row):
                    raise AssertionError(f"{label}: row {r} at position "
                                         f"{positions[r]} differs from its "
                                         f"batch-1 step")
                del row, one
            del full, logits
        # the freeze and the scrub: rows 1, 3, 5, 7 inactive, row 1 at 0
        half = torch.tensor([r % 2 == 0 for r in range(S)], device="cuda")
        on, off = half.nonzero()[:, 0], (~half).nonzero()[:, 0]
        idx2 = idx.clone()
        idx2[1] = 0
        masked = {k: v.clone() for k, v in start.items()}
        nxt_m = graphed(params, toks, masked, idx2, half)[0].cpu()
        for k in masked:
            m = masked[k]
            if not torch.equal(m.index_select(axes[k], on),
                               want[k].index_select(axes[k], on)) or (
                    k in state and not torch.equal(
                        m.index_select(axes[k], off),
                        start[k].index_select(axes[k], off))):
                raise AssertionError(f"{label}: {k}: an inactive row's state "
                                     f"changed, or an active row differs "
                                     f"from the all-active tick")
        if not torch.equal(nxt_m[half.cpu()], nxt_e[half.cpu()]) or \
                nxt_m[~half.cpu()].any():
            raise AssertionError(f"{label}: the masked tick's tokens")
        del masked, start, want
        zero_counts()
        graphed(params, toks, cache, idx, active)[0].cpu()
    launches, plain = read_counts()
    gemv = step_gemvs(cfg) + 1
    if (launches["qmatmul_w8a16[gemv]"] != gemv
            or launches["qmatmul_w8a16"] != gemv or any(plain.values())
            or sum(launches.values()) != 2 * gemv):
        raise AssertionError(f"{label}: a replay launched {launches} "
                             f"({gemv} GEMVs and nothing else expected), "
                             f"plain {plain}")
    where = (f"positions {positions[0]}-{positions[-1]}"
             if len(set(positions)) > 1 else f"position {positions[0]}")
    print(f"{label}: {S} rows at {where}: the captured tick bitwise the "
          f"eager one (tokens and {len(cache)} cache leaves)"
          + ("; each row's logits and leaves bitwise its batch-1 step"
             if per_row else "")
          + f"; with rows 1, 3, 5, 7 inactive (row 1 at index 0) their "
          f"{', '.join(state)} bitwise unchanged and the active rows as in "
          f"the all-active tick; capture {capture_s:.2f} s")
    res = device_breakdown(
        label, f"captured slot tick ({S} active rows at {where}, random "
        f"state)", lambda: graphed(params, toks, cache, idx, active)[0].cpu(),
        10)
    gemv_ms = sum(ms for key, ms in res["by_kernel"].items()
                  if "qmatmul" in key)
    out = extra(cache, active) if extra else {}
    # every layer and the head (the table's bytes, read as its (D, V)
    # head); the embedding gathers only a row a slot
    weights = tree_weight_bytes(params)
    read = weights + 2 * state_bytes + ring_bytes
    floor = read / HBM_BYTES_PER_S * 1e3
    weights_floor = weights / HBM_BYTES_PER_S * 1e3
    busy = res["busy"]
    print(f"{label}: {launches['qmatmul_w8a16[gemv]']} GEMVs a replay; wall "
          f"{res['wall']:.2f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.3f} ms'}, "
          f"cudaGraphLaunch {res['graph_launches']:.0f}, cudaLaunchKernel "
          f"{res['launch_calls']:.0f} a tick; the GEMVs {gemv_ms:.3f} ms of "
          f"device time"
          + ("" if busy is None else
             f" ({100 * gemv_ms / busy:.1f}%), the plain state update"
             + (", ring attention" if ring_bytes else "")
             + f" and the rest {busy - gemv_ms:.3f} ms"))
    print(f"{label}: floor {floor:.3f} ms (the {read} bytes a tick must "
          f"move at 3.35 TB/s: {weights} of int8 weights and head alone "
          f"{weights_floor:.3f} ms, {state_bytes} of state ("
          f"{state_bytes // S} a slot) read and written once"
          + (f", {ring_bytes} of ring k/v read once" if ring_bytes else "")
          + f"): wall / floor {res['wall'] / floor:.2f}, busy / floor "
          f"{'not measured' if busy is None else f'{busy / floor:.2f}'}")
    graphed.captured.release()
    out.update({"wall": res["wall"], "busy": busy, "gemv_ms": gemv_ms,
                "floor": floor, "weights_floor": weights_floor,
                "read_bytes": read, "weight_bytes": weights,
                "state_bytes": state_bytes, "ring_bytes": ring_bytes,
                "launches": launches})
    return out


def ssm_freeze_time(cfg, label, cache, active) -> dict:
    """The ssm tick's freeze alone: each layer's masked writes into h and
    conv at the tick's shapes, timed beside plain copies."""
    import torch

    with torch.inference_mode():
        h, conv = cache["h"][0], cache["conv"][0]
        new_h, new_conv = h.clone(), conv.clone()
        rows_h = active.reshape(-1, 1, 1, 1)
        rows_c = active.reshape(-1, 1, 1)
        freeze_ms = cfg.n_layers * time_ms(lambda: (
            torch.where(rows_h, new_h, h, out=h),
            torch.where(rows_c, new_conv, conv, out=conv)), 10, lambda: None)
        copy_ms = cfg.n_layers * time_ms(lambda: (
            h.copy_(new_h), conv.copy_(new_conv)), 10, lambda: None)
    print(f"{label}: the freeze's masked writes alone ({cfg.n_layers} "
          f"layers x where(active, new, old) into h and conv) "
          f"{freeze_ms:.3f} ms against {copy_ms:.3f} ms for plain copies")
    return {"freeze_ms": freeze_ms, "copy_ms": copy_ms}


def ssm_tick(cfg, params, label):
    """The captured steady tick of the ssm serves (``recurrent_tick``):
    NUM_SLOTS rows at DENSE_MAX_SEQ / 2, its launches 2 GEMVs a layer and
    the head, and the freeze's masked writes timed alone."""
    return recurrent_tick(
        cfg, params, label, max_seq=DENSE_MAX_SEQ,
        positions=(DENSE_MAX_SEQ // 2,) * NUM_SLOTS, seed=SEED + 31,
        state_bytes=ssm_state_bytes(cfg, NUM_SLOTS),
        extra=lambda cache, active: ssm_freeze_time(cfg, label, cache, active))


def recurrent_chunk(cfg, params, label, state_bytes: int):
    """The chunk step of one slot (slot 3 from position 5, every n_valid
    up to PREFILL_CHUNK): per-token eager and captured bitwise equal
    (``graph_chunk_case``: under W8A16 too a recurrent chunk runs token by
    token, ``step_gemvs`` GEMVs a token), then a full chunk's captured
    busy a token against the floor of one token: the int8 weights but the
    head (the chunk discards its logits) and ``state_bytes``, what a token
    reads and writes of the slot's state (and ring)."""
    from repro_torch.core.quant import tree_weight_bytes

    res = graph_chunk_case(cfg, params, label, NUM_SLOTS, DENSE_MAX_SEQ, 0,
                           "w8a16", False, 3, 5)
    weights = tree_weight_bytes(params) - tree_weight_bytes(params["embed"])
    read = weights + state_bytes
    floor = read / HBM_BYTES_PER_S * 1e3
    cap = res["captured"]
    busy = cap["busy"]
    per_token = None if busy is None else busy / PREFILL_CHUNK
    print(f"{label}: a token's floor {floor:.3f} ms ({read} bytes: "
          f"{weights} of int8 weights less the head, {state_bytes} of the "
          f"slot's state); captured chunk of {PREFILL_CHUNK}: wall "
          f"{cap['wall']:.2f} ms, busy "
          + ("not measured" if busy is None else
             f"{busy:.3f} ms, {per_token:.3f} ms a token, "
             f"{per_token / floor:.2f}x the floor"))
    return {"wall": cap["wall"], "busy": busy, "floor": floor,
            "read_bytes": read, "per_token_busy": per_token,
            "eager_wall": res["per-token eager"]["wall"]}


def recurrent_overload(cfg, params, reqs, label, want):
    """Preemption and fault recovery on a recurrent state: the trace on
    SSM_OVERLOAD_SLOTS slots, its odd rids in the batch class at 0 s, its
    even rids interactive at SSM_LATE_S, served as a control (no
    preemption, no fault), then with preemption and the
    SSM_OVERLOAD_FAULTS (a non-finite sample scrubs the slot and resumes
    it from position 0; a failed dispatch launches nothing): every
    request of both equal to ``want`` (the contiguous serve's tokens),
    preemptions and re-prefilled tokens above 0, every fault fired."""
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16

    reqs = [dataclasses.replace(
        r, arrival_s=0.0 if r.rid % 2 else SSM_LATE_S,
        priority="batch" if r.rid % 2 else "interactive") for r in reqs]
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=SSM_OVERLOAD_SLOTS,
                   max_seq=DENSE_MAX_SEQ, prefill_chunk=PREFILL_CHUNK)
    bound = warm(label, eng, reqs[:1])
    control = overload_serve(f"{label} control", eng, reqs, bound,
                             ("qmatmul_w8a16",))
    plan = E.FaultPlan([E.Fault(tick=t, kind=k, slot=s)
                        for k, t, s in SSM_OVERLOAD_FAULTS])
    rep = overload_serve(f"{label} preemption + faults", eng, reqs, bound,
                         ("qmatmul_w8a16",), preemption=True,
                         fault_plan=plan, max_retries=OVERLOAD_MAX_RETRIES)
    for name, r in (("control", control), ("preemption + faults", rep)):
        if r.outputs() != {rid: want[rid] for rid in r.outputs()} or len(
                r.results) != len(reqs) or r.failed:
            raise AssertionError(f"{label} {name}: tokens differ from the "
                                 f"contiguous serve's, or a request failed")
    if (rep.preempted < 2 or rep.nonfinite_samples != 1
            or rep.dispatch_retries != 1 or rep.resumed_prefill_tokens <= 0
            or len(plan.fired) != len(SSM_OVERLOAD_FAULTS)):
        raise AssertionError(f"{label}: preempted {rep.preempted}, "
                             f"nonfinite {rep.nonfinite_samples}, retries "
                             f"{rep.dispatch_retries}, fired {plan.fired}")
    same_as_control(f"{label} preemption + faults", rep, control)
    print(f"{label}: control and the preempted, faulted serve both equal "
          f"the contiguous serve token for token ({rep.preempted} "
          f"preemptions, {rep.resumed_prefill_tokens} tokens re-prefilled "
          f"from position 0, fired {plan.fired})")
    return {"preempted": rep.preempted, "ticks": rep.ticks,
            "control_ticks": control.ticks}


def family_cli_phase(arch, base, compare):
    """The serve CLI at full ``arch`` width (``base`` arguments): under
    --quant w8a16, exit 0, the service curve's forward on the mma path
    only, the decode loop and the engine on the GEMV, and ``compare``
    requests equal to ``reference_outputs`` token for token; then under
    --quant w8a8 (every projection on qmatmul_w8a8; the W8A16 head, and
    the hybrid's RG-LRU gates, on the mma path in the curve's forward
    and on the GEMV in the decode loop).  Each run's captured curve is
    held to the eager one bitwise at every batch.  Returns each run's
    launches."""
    from repro_torch.launch import serve

    real_curve = serve.measure_service_curve
    curve_paths = {}
    serve.measure_service_curve = counted_curve(real_curve, curve_paths)
    out = {}
    try:
        for quant in ("w8a16", "w8a8"):
            label = f"serve {arch} {quant}"
            out[quant], res = serve_run(quant, curve_paths, base=base,
                                        label=label)
            if quant == "w8a16":
                rep = res.report
                reqs = res.requests[:compare]
                compare_sampled(label, res.cfg, res.params, res.engine,
                                reqs, rep.outputs())
            del res
            torch_cuda_empty()
    finally:
        serve.measure_service_curve = real_curve
    return out


def ssm_phase(flush):
    """mamba2-1.3b at full width (48 layers, d 2,048, d_inner 4,096, 64
    SSD heads of 64, state N 128, conv width 4, vocab 50,280 tied): the
    kernel rows at its shapes, then the model from the streamed init,
    the dense trace served greedy and sampled (t = SAMPLE_TEMP), each
    equal to ``reference_outputs`` token for token (no near-tie rule:
    every op of the decode computes a row the same whatever the batch),
    the overload serves against their control, the captured tick (with
    the freeze and the scrub checked on the card) and the chunk step
    against their floors, then the serve CLI under w8a16 and w8a8.
    Returns the kernel rows, the launches of each run and the times."""
    import torch
    from repro_torch import engine as E
    from repro_torch.runtime import prng as P
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    print(f"ssm: the kernels at {SSM_ARCH}'s shapes")
    q_err, q_rows, w8_err, w8_rows, per_m = family_qmatmul_rows(
        flush, SSM_ARCH, SSM_SHAPES, SEED + 29)
    print(f"ssm: kernel rows {time.perf_counter() - t0:.1f}s")
    torch_cuda_empty()
    cfg, params = build_family_model(SSM_ARCH)
    reqs = E.synthetic_requests(
        DENSE_REQUESTS, rate_per_s=DENSE_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=DENSE_PROMPT, max_new_tokens=DENSE_NEW,
        shared_prefix_len=DENSE_SHARED, seed=SEED)
    out = {"qmatmul_rows": q_rows, "qmatmul_err": q_err,
           "w8a8_rows": w8_rows, "w8a8_err": w8_err, "per_m": per_m}
    label = f"ssm {SSM_ARCH}"
    eng, rep, out["launches"] = dense_serve(f"{label} contiguous", cfg,
                                            params, reqs)
    print(f"{label} contiguous: the state of {eng.num_slots} slots "
          f"{ssm_state_bytes(cfg, eng.num_slots)} bytes; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes")
    compare_sampled(f"{label} contiguous", cfg, params, eng, reqs,
                    rep.outputs())
    contig = rep.outputs()
    out["serves"] = {"greedy": {"ticks": rep.ticks, "tok_s":
                                rep.generated_tokens / rep.wall_s}}
    del eng
    eng, rep, _ = dense_serve(f"{label} sampled", cfg, params, reqs,
                              temperature=SAMPLE_TEMP,
                              rng=P.PRNGKey(SEED + 1, device="cuda"))
    compare_sampled(f"{label} sampled", cfg, params, eng, reqs,
                    rep.outputs())
    out["serves"]["sampled"] = {"ticks": rep.ticks, "tok_s":
                                rep.generated_tokens / rep.wall_s}
    del eng
    out["overload"] = recurrent_overload(cfg, params, reqs,
                                         f"{label} overload", contig)
    ST.clear_step_cache()
    torch_cuda_empty()
    print(f"ssm: serves {time.perf_counter() - t0:.1f}s")
    out["tick"] = ssm_tick(cfg, params, f"{label} tick")
    out["chunk"] = recurrent_chunk(cfg, params, f"{label} chunk",
                                   2 * ssm_state_bytes(cfg, 1))
    print(f"ssm: tick and chunk {time.perf_counter() - t0:.1f}s")
    ST.clear_step_cache()
    del params
    torch_cuda_empty()
    out["cli"] = family_cli_phase(SSM_ARCH, SSM_SERVE_ARGS, SSM_CLI_COMPARE)
    ST.clear_step_cache()
    torch_cuda_empty()
    out["seconds"] = time.perf_counter() - t0
    print(f"ssm: phase {out['seconds']:.1f}s; "
          f"{torch.cuda.memory_allocated()} bytes left allocated")
    return out


# ---------------------------------------------------------------------------
# the hybrid family
# ---------------------------------------------------------------------------

HYB_ARCH = "recurrentgemma-9b"
# the serve CLI at full recurrentgemma-9b width, contiguous (the family does
# not page): the ssm CLI's geometry
HYB_SERVE_ARGS = ["--arch", HYB_ARCH] + SSM_SERVE_ARGS[2:]
HYB_CLI_COMPARE = 4
# the W8A16 and W8A8 kernels at recurrentgemma-9b's projections: (name, K,
# N, launches of a decode step): 26 recurrent blocks' w_in_a, w_in_b, the
# RG-LRU's two gates and w_out, and 12 attention blocks' wq and wo; their
# wk and wv (one KV head of 256); 38 MLPs' w_gate and w_up, and w_down
HYB_SHAPES = (("proj", 4096, 4096, 154), ("kv", 4096, 256, 24),
              ("mlp_up", 4096, 12288, 76), ("mlp_down", 12288, 4096, 38))
# flash_attention_bhsd at head_dim 256, causal, window 2,048: (BH, S) of
# the CLI curve's forward (16 heads x b = 1, 4, 16 at S = 32) and of a
# prompt where the window bites
HYB_FLASH = ((16, SERVE_SEQ), (64, SERVE_SEQ), (256, SERVE_SEQ), (16, 4096))
# the ring tick: NUM_SLOTS rows of a max_seq 4,096 cache (a 2,048-slot
# ring) at positions straddling the window
HYB_RING_SEQ = 4096
HYB_RING_POS = (2045, 2046, 2047, 2048, 2049, 2050, 2051, 2052)


def flash_rows(flush, arch, cases, window, seed):
    """flash_attention_bhsd at ``arch``'s head_dim, causal with the
    model's ``window``, at ``cases`` ((BH, S): the CLI curve's shapes and
    one where the window masks the keys of the later queries); each
    against its plain version (bf16 out: bf16_close), timed beside its
    bound (the pairs the window and the causal mask leave) and SDPA (an
    explicit boolean mask where the window bites).  Returns (worst error,
    {case: numbers})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA

    hd = get_config(arch).head_dim
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows, worst = {}, 0.0
    for bh, s in cases:
        q, k, v = (torch.randn((bh, s, hd), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        kw = dict(causal=True, window=window)
        out = FA.flash_attention_bhsd(q, k, v, **kw)
        ref = FA.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out).all():
            raise AssertionError(f"flash hd {hd} BH={bh} S={s}: bad output")
        err, ratio = bf16_close(out, ref, f32_out=False)
        del out, ref
        if ratio > 1.0:
            raise AssertionError(
                f"flash hd {hd} BH={bh} S={s}: kernel disagrees with its "
                f"plain version beyond tolerance (err/tol={ratio:.3f})")
        worst = max(worst, err)
        pos = torch.arange(s, device="cuda")
        valid = ((pos[None, :] <= pos[:, None])
                 & (pos[None, :] > pos[:, None] - window))
        pairs = int(valid.sum())
        mask = valid if s > window else None
        ms = time_ms(lambda: FA.flash_attention_bhsd(q, k, v, **kw),
                     TIMED_ITERS, flush)
        plain = time_ms(lambda: FA.flash_attention_ref(q, k, v, **kw),
                        1, flush, warmup=False)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], attn_mask=mask,
            is_causal=mask is None), TIMED_ITERS, flush)
        bytes_ms = 4 * bh * s * hd * 2 / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * bh * pairs * hd / BF16_OPS_PER_S * 1e3
        row = {"BH": bh, "S": s, "hd": hd, "window": window, "ms": ms,
               "plain_ms": plain, "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "library_ms": lib, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
               "max_abs_err": err, "err_tol": ratio}
        rows[f"BH={bh} S={s}"] = row
        print(f"  flash_attention_bhsd BH={bh} S={s} hd={hd} causal "
              f"window={window} ({pairs} pairs a head) max_abs_err="
              f"{err:.3e} err/tol={ratio:.3f} ms={ms:.4f} plain_ms="
              f"{plain:.4f} library_ms={lib:.4f} (SDPA"
              f"{', boolean mask' if mask is not None else ', is_causal'}) "
              f"bound_ms={row['bound_ms']:.5f} ({row['bound_by']})")
        del q, k, v, valid, mask
    zero_counts()
    return worst, rows


def hybrid_state_bytes(cfg, rows: int) -> int:
    """Bytes of ``rows`` slots' recurrent state: every recurrent block's
    RG-LRU h (f32) and conv tail (bf16)."""
    w = cfg.rnn_width or cfg.d_model
    blocks = 2 * (cfg.n_layers // 3) + cfg.n_layers % 3
    return rows * blocks * w * (4 + 2 * (cfg.conv_width - 1))


def hybrid_ring_bytes(cfg, positions, win: int) -> int:
    """Bytes of ring k and v that one decode step reads for rows at
    ``positions``: each row's valid slots, min(p + 1, win), in every
    attention block."""
    per_slot = 2 * cfg.n_kv_heads * cfg.head_dim * 2
    return (cfg.n_layers // 3) * per_slot * sum(min(p + 1, win)
                                                for p in positions)


def hybrid_ring_tick(cfg, params, label):
    """The ring on the card (``recurrent_tick``): NUM_SLOTS rows of a
    max_seq HYB_RING_SEQ cache (a 2,048-slot ring) at HYB_RING_POS,
    straddling the window, each row also held to its batch-1 step; the
    floor counts the ring's valid slots read once."""
    win = min(cfg.local_window, HYB_RING_SEQ)
    return recurrent_tick(
        cfg, params, label, max_seq=HYB_RING_SEQ, positions=HYB_RING_POS,
        seed=SEED + 41, state_bytes=hybrid_state_bytes(cfg, NUM_SLOTS),
        ring_bytes=hybrid_ring_bytes(cfg, HYB_RING_POS, win), per_row=True)


def hybrid_phase(flush):
    """recurrentgemma-9b at full width (38 layers: 12 groups of (rec, rec,
    attn) and 2 leftover rec blocks; d 4,096, RG-LRU width 4,096, 16
    query heads and 1 KV head of 256, window 2,048, d_ff 12,288, vocab
    256,000 tied): flash attention at head_dim 256 and the matmul kernels
    at its shapes, then the model from the streamed init, the dense trace
    served greedy and sampled, each equal to ``reference_outputs`` token
    for token, the overload serves against their control, the ring tick
    (captured == eager, each row == its batch-1 step, the freeze) against
    its floor, the chunk step, then the serve CLI under w8a16 and w8a8.
    Returns the kernel rows, the launches of each run and the times."""
    import torch
    from repro_torch import engine as E
    from repro_torch.configs import get_config
    from repro_torch.runtime import prng as P
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    print(f"hybrid: the kernels at {HYB_ARCH}'s shapes")
    # flash at head_dim 256 (the kernel's HD = 256 instance) with the
    # 2,048 window: the curve's BH = 16 x b at S = 32, and S = 4,096
    f_err, f_rows = flash_rows(flush, HYB_ARCH, HYB_FLASH,
                               get_config(HYB_ARCH).local_window, SEED + 37)
    q_err, q_rows, w8_err, w8_rows, per_m = family_qmatmul_rows(
        flush, HYB_ARCH, HYB_SHAPES, SEED + 43)
    print(f"hybrid: kernel rows {time.perf_counter() - t0:.1f}s")
    torch_cuda_empty()
    cfg, params = build_family_model(HYB_ARCH)
    reqs = E.synthetic_requests(
        DENSE_REQUESTS, rate_per_s=DENSE_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=DENSE_PROMPT, max_new_tokens=DENSE_NEW,
        shared_prefix_len=DENSE_SHARED, seed=SEED)
    out = {"flash_rows": f_rows, "flash_err": f_err, "qmatmul_rows": q_rows,
           "qmatmul_err": q_err, "w8a8_rows": w8_rows, "w8a8_err": w8_err,
           "per_m": per_m}
    label = f"hybrid {HYB_ARCH}"
    eng, rep, out["launches"] = dense_serve(f"{label} contiguous", cfg,
                                            params, reqs)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in eng._cache.values())
    print(f"{label} contiguous: the state and {eng.max_seq}-slot ring of "
          f"{eng.num_slots} slots {cache_bytes} bytes; "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes")
    compare_sampled(f"{label} contiguous", cfg, params, eng, reqs,
                    rep.outputs())
    contig = rep.outputs()
    out["serves"] = {"greedy": {"ticks": rep.ticks, "tok_s":
                                rep.generated_tokens / rep.wall_s}}
    del eng
    eng, rep, _ = dense_serve(f"{label} sampled", cfg, params, reqs,
                              temperature=SAMPLE_TEMP,
                              rng=P.PRNGKey(SEED + 1, device="cuda"))
    compare_sampled(f"{label} sampled", cfg, params, eng, reqs,
                    rep.outputs())
    out["serves"]["sampled"] = {"ticks": rep.ticks, "tok_s":
                                rep.generated_tokens / rep.wall_s}
    del eng
    out["overload"] = recurrent_overload(cfg, params, reqs,
                                         f"{label} overload", contig)
    ST.clear_step_cache()
    torch_cuda_empty()
    print(f"hybrid: serves {time.perf_counter() - t0:.1f}s")
    out["tick"] = hybrid_ring_tick(cfg, params, f"{label} ring tick")
    torch_cuda_empty()
    # a token of the chunk (positions 5-8) reads its ring below it
    out["chunk"] = recurrent_chunk(
        cfg, params, f"{label} chunk", 2 * hybrid_state_bytes(cfg, 1)
        + hybrid_ring_bytes(cfg, (5 + PREFILL_CHUNK // 2,), DENSE_MAX_SEQ))
    print(f"hybrid: tick and chunk {time.perf_counter() - t0:.1f}s")
    ST.clear_step_cache()
    del params
    torch_cuda_empty()
    out["cli"] = family_cli_phase(HYB_ARCH, HYB_SERVE_ARGS, HYB_CLI_COMPARE)
    ST.clear_step_cache()
    torch_cuda_empty()
    out["seconds"] = time.perf_counter() - t0
    print(f"hybrid: phase {out['seconds']:.1f}s; "
          f"{torch.cuda.memory_allocated()} bytes left allocated")
    return out


# ---------------------------------------------------------------------------
# mixtral-8x22b: the MoE family over a sliding-window KV ring
# ---------------------------------------------------------------------------

MIX_ARCH = "mixtral-8x22b"
# the depth the card holds: 8 of 56 layers at full width, 20.4 GB of int8
# (56 layers would be 141 GB)
MIX_LAYERS = 8
# the W8A16 and W8A8 kernels at mixtral-8x22b's projections: (name, K, N,
# launches of an 8-layer decode step): wq and wo, and wk and wv (8 KV
# heads of 128); the experts and the router through moe_qmatmul_rows
MIX_SHAPES = (("proj", 6144, 6144, 2 * MIX_LAYERS),
              ("kv", 6144, 1024, 2 * MIX_LAYERS))
# flash_attention_bhsd at head_dim 128, causal, window 4,096: (BH, S) of
# the curve's forward (48 heads x b = 1, 4, 16 at S = 32) and of a prompt
# where the window bites
MIX_FLASH = ((48, SERVE_SEQ), (192, SERVE_SEQ), (768, SERVE_SEQ), (6, 8192))
# the ring tick: NUM_SLOTS rows of a max_seq 8,192 cache (a 4,096-slot
# ring) at positions straddling the ring's end; the chunk from positions
# before, across and past it
MIX_RING_SEQ = 8192
MIX_RING_POS = tuple(range(4093, 4093 + NUM_SLOTS))
MIX_CHUNK_STARTS = (4090, 4094, 4100)
LAUNCHER_DECODE_TOKENS = 16     # the launcher's decode loop (the CLI's
                                # default)


def mixtral_attention_rows(flush):
    """decode_attention_int8 at mixtral-8x22b's (KV 8, G 6, hd 128) over
    NUM_SLOTS rows of a 4,096-slot int8 ring at the ring tick's valid
    lengths (min(p + 1, 4,096) for p in MIX_RING_POS), and
    decode_attention_int8_paged at the chunk step's read of it (each row
    through a one-entry table over the contiguous rows read as blocks of
    4,096 slots): each against its plain version, the paged launch
    bitwise the contiguous one, every row bitwise launched alone, timed
    beside SDPA and the bound.  Returns (worst error, contiguous numbers,
    paged numbers)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as A

    c = get_config(MIX_ARCH)
    kvh, g, hd = c.n_kv_heads, c.n_heads // c.n_kv_heads, c.head_dim
    s, b = c.window, NUM_SLOTS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 53)
    vls = [min(p + 1, s) for p in MIX_RING_POS]
    vl = torch.tensor(vls, dtype=torch.int32, device="cuda")
    q = torch.randn((b, kvh, g, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    k, v, ks, vs = _attn_cache(gen, (b, s, kvh, hd))
    label = f"decode_attention_int8 {MIX_ARCH} KV={kvh} G={g} B={b} S={s}"
    out = A.decode_attention_int8(q, k, v, ks, vs, vl)
    err = _attn_close(label, out, A.decode_attention_int8_ref(
        q, k, v, ks, vs, vl))
    _rows_alone(label, out, lambda r: A.decode_attention_int8(
        q[r:r + 1], k[r:r + 1], v[r:r + 1], ks[r:r + 1], vs[r:r + 1],
        vl[r:r + 1]), b)
    kd = (k.float() * ks).to(torch.bfloat16).transpose(1, 2)
    vd = (v.float() * vs).to(torch.bfloat16).transpose(1, 2)
    lib = _sdpa_ms(flush, q, kd, vd, vl, s)
    contig = _attn_numbers(
        label, b, vls, False, err,
        time_ms(lambda: A.decode_attention_int8(q, k, v, ks, vs, vl),
                TIMED_ITERS, flush),
        time_ms(lambda: A.decode_attention_int8_ref(q, k, v, ks, vs, vl), 1,
                flush, warmup=False), lib, q, 0)
    contig["max_abs_err"] = err
    tables = torch.arange(b, dtype=torch.int32, device="cuda")[:, None]
    plabel = f"decode_attention_int8_paged {MIX_ARCH} one-entry tables"
    pout = A.decode_attention_int8_paged(q, k, v, ks, vs, vl, tables)
    perr = _attn_close(plabel, pout, A.decode_attention_int8_paged_ref(
        q, k, v, ks, vs, vl, tables))
    if not torch.equal(pout, out):
        raise AssertionError(f"{plabel}: not bitwise the contiguous kernel")
    _rows_alone(plabel, pout, lambda r: A.decode_attention_int8_paged(
        q[r:r + 1], k, v, ks, vs, vl[r:r + 1], tables[r:r + 1]), b)
    paged = _attn_numbers(
        plabel, b, vls, False, perr,
        time_ms(lambda: A.decode_attention_int8_paged(
            q, k, v, ks, vs, vl, tables), TIMED_ITERS, flush),
        time_ms(lambda: A.decode_attention_int8_paged_ref(
            q, k, v, ks, vs, vl, tables), 1, flush, warmup=False),
        lib, q, b * 4)
    paged["max_abs_err"] = perr
    print(f"  decode attention on {MIX_ARCH}'s ring: every row bitwise "
          f"alone and in its batch, the paged kernel through one-entry "
          f"tables bitwise the contiguous one")
    del q, k, v, ks, vs, kd, vd, out, pout
    zero_counts()
    return max(err, perr), contig, paged


def ring_bytes(cfg, positions, win: int) -> int:
    """Bytes of int8 ring k and v and their f32 scales that one decode
    step reads for rows at ``positions``: each row's valid slots, min(p +
    1, win), in every layer."""
    per_slot = 2 * cfg.n_kv_heads * (cfg.head_dim + 4)
    return cfg.n_layers * per_slot * sum(min(p + 1, win) for p in positions)


def mixtral_ring_tick(cfg, params, label):
    """The captured tick on the int8 ring at full width: NUM_SLOTS rows at
    MIX_RING_POS of a MIX_RING_SEQ cache (a 4,096-slot ring) filled at
    random, straddling the ring's end.  The captured tick's tokens and
    every cache leaf bitwise the eager tick's; the decode step's logits
    and leaves row by row bitwise the row's batch-1 step (a lockstep
    index on the row alone); a replay's launches (the attention's four
    and the router's GEMV a layer and the head, three expert stacks and a
    decode attention launch a layer, nothing else counted); then wall,
    busy and torch.profiler's split (MOE_TICK_PARTS) beside two floors at
    3.35 TB/s: every int8 weight the tick reads (the embedding table only
    gathers), and with the experts only those its tokens route to (the
    tick's own routing), each plus the ring's valid slots."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.core.quant import tree_weight_bytes
    from repro_torch.models import moe as M
    from repro_torch.runtime import steps as ST

    S, L = NUM_SLOTS, cfg.n_layers
    eager = ST.make_slot_decode_step(cfg, mode=W8A16)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(
        cfg, mode=W8A16))
    decode = ST.make_decode_step(cfg, mode=W8A16)
    g = torch.Generator(device="cuda").manual_seed(SEED + 47)
    cache = _random_cache(cfg, S, MIX_RING_SEQ, 0)
    win = cache["k"].shape[2]
    if win != min(MIX_RING_SEQ, cfg.window):
        raise AssertionError(f"{label}: a ring of {win} slots")
    chosen = []
    with torch.inference_mode():
        toks = torch.randint(1, cfg.vocab, (S, 1), generator=g,
                             device="cuda", dtype=torch.int32)
        idx = torch.tensor(MIX_RING_POS, dtype=torch.int32, device="cuda")
        active = torch.ones((S,), dtype=torch.bool, device="cuda")
        start = {k: v.clone() for k, v in cache.items()}
        want = {k: v.clone() for k, v in cache.items()}
        real_route = M.route

        def route(router, x, k):
            out = real_route(router, x, k)
            chosen.append(out[1].reshape(-1))
            return out

        M.route = route
        try:
            nxt_e = eager(params, toks, want, idx, active)[0].cpu()
        finally:
            M.route = real_route
        routed = [len(set(c.tolist())) for c in chosen]
        t0 = time.perf_counter()
        nxt_g = graphed(params, toks, cache, idx, active)[0].cpu()
        capture_s = time.perf_counter() - t0
        if not torch.equal(nxt_g, nxt_e) or any(
                not torch.equal(cache[k], want[k]) for k in cache):
            raise AssertionError(f"{label}: the captured tick differs from "
                                 f"the eager tick")
        full = {k: v.clone() for k, v in start.items()}
        logits, _ = decode(params, {"tokens": toks, "cache_index": idx},
                           full)
        if any(not torch.equal(full[k], want[k]) for k in full) or \
                not torch.equal(logits[:, -1].argmax(-1).int().cpu(), nxt_e):
            raise AssertionError(f"{label}: the decode step differs from "
                                 f"the tick")
        for r, p in enumerate(MIX_RING_POS):
            row = {k: v[:, r:r + 1].clone() for k, v in start.items()}
            one, _ = decode(params, {"tokens": toks[r:r + 1],
                                     "cache_index": p}, row)
            if not torch.equal(one[0], logits[r]) or any(
                    not torch.equal(row[k], full[k][:, r:r + 1])
                    for k in row):
                raise AssertionError(f"{label}: row {r} at position {p} "
                                     f"differs from its batch-1 step")
            del row, one
        written = [p % win for p in MIX_RING_POS]
        for r, slot in enumerate(written):
            if torch.equal(full["k"][:, r, slot], start["k"][:, r, slot]):
                raise AssertionError(f"{label}: row {r} did not write its "
                                     f"ring slot {slot}")
        del full, logits, start, want
        zero_counts()
        graphed(params, toks, cache, idx, active)[0].cpu()
    launches, plain = read_counts()
    gemv = gemvs_per_layer(cfg) * L + 1
    if (launches["qmatmul_w8a16[gemv]"] != gemv
            or launches["qmatmul_w8a16_experts[gemv]"] != 3 * L
            or launches["decode_attention_int8"] != L
            or launches["qmatmul_w8a16[mma]"]
            or launches["qmatmul_w8a16_experts[mma]"]
            or launches["decode_attention_int8_paged"]
            or any(plain.values())):
        raise AssertionError(f"{label}: a replay launched {launches} ({gemv} "
                             f"GEMVs, {3 * L} stacks, {L} attention "
                             f"launches expected), plain {plain}")
    print(f"{label}: {S} rows at positions {MIX_RING_POS[0]}-"
          f"{MIX_RING_POS[-1]} of a {win}-slot int8 ring (written at slots "
          f"{written}): the captured tick bitwise the eager one (tokens and "
          f"{len(cache)} cache leaves), each row's logits and leaves bitwise "
          f"its batch-1 step; capture {capture_s:.2f} s; a replay launches "
          f"{launches}")
    res = device_breakdown(
        label, f"captured slot tick ({S} active rows across the ring's end, "
        f"random ring)", lambda: graphed(params, toks, cache, idx,
                                         active)[0].cpu(), 10)
    read = tree_weight_bytes(params) - tree_weight_bytes(params["embed"])
    stack = sum(tree_weight_bytes(lp["moe"]["experts"])
                for lp in params["layers"])
    per_expert = stack / L / cfg.n_experts
    routed_bytes = read - stack + sum(routed) * per_expert
    ring = ring_bytes(cfg, MIX_RING_POS, win)
    floor = (read + ring) / HBM_BYTES_PER_S * 1e3
    routed_floor = (routed_bytes + ring) / HBM_BYTES_PER_S * 1e3
    split = dict.fromkeys(MOE_TICK_PARTS, 0.0)
    for key, ms in res["by_kernel"].items():
        part = next((p for p, names in MOE_TICK_PARTS.items()
                     if any(n in key.lower() for n in names)), "the rest")
        split[part] = split.get(part, 0.0) + ms
    busy = res["busy"]
    print(f"{label}: wall {res['wall']:.2f} ms, device busy "
          f"{'not measured' if busy is None else f'{busy:.3f} ms'}, "
          f"cudaGraphLaunch {res['graph_launches']:.0f}, cudaLaunchKernel "
          f"{res['launch_calls']:.0f} a tick; device time by part: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split.items()))
    print(f"{label}: floors at 3.35 TB/s: {routed_floor:.3f} ms (the "
          f"{routed_bytes:.0f} bytes of int8 weights its tokens route to, "
          f"{sum(routed) / L:.2f} of {cfg.n_experts} experts a layer, and "
          f"the ring's {ring} bytes) and {floor:.3f} ms (every expert: "
          f"{read} bytes); wall / floor {res['wall'] / routed_floor:.2f} "
          f"and {res['wall'] / floor:.2f}, busy / floor "
          + ("not measured" if busy is None else
             f"{busy / routed_floor:.2f}"))
    graphed.captured.release()
    return {"wall": res["wall"], "busy": busy, "split": split,
            "floor": routed_floor, "every_expert_floor": floor,
            "live_experts": sum(routed) / L, "ring_bytes": ring,
            "launches": launches}


def launcher_run(cfg, params, name):
    """The serve launcher's own measurements on a model cut in depth (the
    CLI at full depth would not fit the card): under w8a16 and w8a8,
    ``serve.measure_service_curve`` through the captured forward
    (``jit_prefill_step``: a graph per batch, b = 1, 4 and 16 of
    SERVE_SEQ tokens), its launches counted (flash attention; w8a16: the
    projections and the head on the mma path, and an MoE config's
    experts on their tensor-core entry and its routers on the GEMV; w8a8:
    qmatmul_w8a8 for the attention, the GEMV for an MoE config's rest),
    each batch's captured logits bitwise the eager forward's
    (``curve_check``), then ``serve.measure_decode_tps`` (the captured
    decode loop, no mma launch) at the Table 4 batch.  Returns {quant:
    launches and times}."""
    import torch
    from repro_torch.core import batching as bt
    from repro_torch.core.qlinear import W8A8, W8A16
    from repro_torch.launch import serve
    from repro_torch.runtime import steps as ST

    args = serve.parse_args(["--seq", str(SERVE_SEQ), "--max-batch",
                             str(SERVE_MAX_BATCH), "--deadline-ms", "2000"])
    out = {}
    moe = cfg.family == "moe"
    for quant, mode in (("w8a16", W8A16), ("w8a8", W8A8)):
        label = f"{name} launcher {quant}"
        prefill = ST.jit_prefill_step(ST.make_prefill_step(cfg, mode=mode))
        zero_counts()
        model, curve = serve.measure_service_curve(
            prefill, params, cfg, seq=SERVE_SEQ, max_batch=SERVE_MAX_BATCH,
            device="cuda")
        torch.cuda.synchronize()
        curve_launches, plain = read_counts()
        captures = prefill.captured.captures
        prefill.captured.release()
        batch = min(bt.choose_batch(model, args.deadline_ms * 1e-3,
                                    args.max_batch), max(curve))
        want_mma = mode is W8A16
        if (captures != len(curve) or any(plain.values())
                or curve_launches["flash_attention_bhsd"] <= 0
                or (curve_launches["qmatmul_w8a16[mma]"] > 0) != want_mma
                or (curve_launches["qmatmul_w8a16_experts[mma]"] > 0)
                != (want_mma and moe)
                or (curve_launches["qmatmul_w8a8"] > 0) == want_mma
                or batch < 1):
            raise AssertionError(f"{label}: {captures} captures for "
                                 f"{len(curve)} batches, chosen batch "
                                 f"{batch}, curve launches "
                                 f"{curve_launches}, plain {plain}")
        curve_check(label, serve.ServeRun(code=0, cfg=cfg, params=params,
                                          mode=mode, curve=curve), args)
        zero_counts()
        bb, tps, dt = serve.measure_decode_tps(
            cfg, params, mode, batch, s_max=max(SERVE_SEQ * 2, 64),
            num_tokens=LAUNCHER_DECODE_TOKENS, device="cuda")
        loop_launches, plain = read_counts()
        mma_free(label, loop_launches)
        if any(plain.values()) or loop_launches["qmatmul_w8a16[gemv]"] \
                <= 0 or (loop_launches["qmatmul_w8a16_experts[gemv]"] > 0) \
                != moe:
            raise AssertionError(f"{label}: decode loop launches "
                                 f"{loop_launches}, plain {plain}")
        print(f"{label}: service curve "
              + "  ".join(f"b={b}: {t * 1e3:.2f} ms" for b, t in
                          sorted(curve.items()))
              + f" (captured forwards; chosen batch {batch} at a 2,000 ms "
              f"deadline); curve launches {curve_launches}; decode loop "
              f"batch {batch} (bucket {bb}) {LAUNCHER_DECODE_TOKENS} steps in "
              f"{dt * 1e3:.1f} ms -> {tps:.1f} tok/s; its launches "
              f"{loop_launches}")
        out[quant] = {"curve_ms": {b: t * 1e3 for b, t in curve.items()},
                      "batch": batch, "decode_tok_s": tps,
                      "curve_launches": curve_launches,
                      "loop_launches": loop_launches}
        torch_cuda_empty()
    return out


def mixtral_phase(flush):
    """mixtral-8x22b at full width and 8 of 56 layers (d 6,144, 48 query
    and 8 KV heads of 128, 8 experts top-2 of d_ff 16,384, no shared
    expert, window 4,096, vocab 32,768 untied): the kernels at its shapes
    (qmatmul_w8a16's GEMV and mma paths at its projections and head, the
    expert stacks at a tick's routed rows and the curve's forward rows,
    the router; qmatmul_w8a8; the decode attention kernels over a
    4,096-slot ring; flash with the window), then the model from the
    streamed init (its peak under PEAK_BYTES), the dense trace served on
    the int8 ring and the bf16 ring greedy (``compare_with_reference``:
    the MoE near-tie rule) and on the int8 ring sampled
    (``compare_sampled``), the ring tick across the ring's end, the
    captured chunk on the wrapped ring (starts MIX_CHUNK_STARTS, token by
    token, bitwise the per-token steps), then the launcher's curve and
    decode loop under w8a16 and w8a8.  Returns the kernel rows, the
    launches of each run and the times."""
    import torch
    from repro_torch import engine as E
    from repro_torch.configs import get_config
    from repro_torch.runtime import prng as P
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    cut = f"{MIX_LAYERS} of 56 layers"
    print(f"mixtral: the kernels at {MIX_ARCH}'s shapes (full width)")
    f_err, f_rows = flash_rows(flush, MIX_ARCH, MIX_FLASH,
                               get_config(MIX_ARCH).window, SEED + 51)
    a_err, a_row, p_row = mixtral_attention_rows(flush)
    q_err, q_rows, w8_err, w8_rows, per_m = family_qmatmul_rows(
        flush, MIX_ARCH, MIX_SHAPES, SEED + 49)
    e_err, e_rows, e_fwd = moe_qmatmul_rows(flush, MIX_ARCH, SEED + 55)
    print(f"mixtral: kernel rows {time.perf_counter() - t0:.1f}s")
    torch_cuda_empty()
    cfg, params = build_dense_model(MIX_ARCH, MIX_LAYERS)
    qcfg = dataclasses.replace(cfg, kv_quant=True)
    reqs = E.synthetic_requests(
        DENSE_REQUESTS, rate_per_s=DENSE_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=DENSE_PROMPT, max_new_tokens=DENSE_NEW,
        shared_prefix_len=DENSE_SHARED, seed=SEED)
    out = {"flash_rows": f_rows, "flash_err": f_err, "attention": a_row,
           "paged_attention": p_row, "attention_err": a_err,
           "qmatmul_rows": q_rows, "qmatmul_err": q_err,
           "w8a8_rows": w8_rows, "w8a8_err": w8_err, "per_m": per_m,
           "expert_rows": e_rows, "expert_forward_rows": e_fwd,
           "experts_err": e_err, "serves": {}}
    label = f"mixtral {MIX_ARCH} ({cut})"
    for name, c, kw in (("int8", qcfg, {}), ("bf16", cfg, {}),
                        ("sampled", qcfg, dict(
                            temperature=SAMPLE_TEMP,
                            rng=P.PRNGKey(SEED + 1, device="cuda")))):
        eng, rep, launches = dense_serve(f"{label} {name} ring", c, params,
                                         reqs, **kw)
        if name == "sampled":
            compare_sampled(f"{label} {name} ring", c, params, eng, reqs,
                            rep.outputs())
        else:
            compare_with_reference(f"{label} {name} ring", c, params, eng,
                                   reqs, rep.outputs())
        out["serves"][name] = {"ticks": rep.ticks, "wall_s": rep.wall_s,
                               "tok_s": rep.generated_tokens / rep.wall_s,
                               "launches": launches}
        del eng
    ST.clear_step_cache()
    torch_cuda_empty()
    print(f"mixtral: serves {time.perf_counter() - t0:.1f}s")
    out["tick"] = mixtral_ring_tick(qcfg, params, f"{label} ring tick")
    torch_cuda_empty()
    out["chunk"] = {}
    for start in MIX_CHUNK_STARTS:
        res = graph_chunk_case(cfg, params, f"{label} ring chunk from "
                               f"{start}", NUM_SLOTS, MIX_RING_SEQ, 0,
                               "w8a16", True, 3, start)
        out["chunk"][start] = {way: {"wall": r["wall"], "busy": r["busy"]}
                               for way, r in res.items()}
        torch_cuda_empty()
    print(f"mixtral: tick and chunk {time.perf_counter() - t0:.1f}s")
    ST.clear_step_cache()
    out["launcher"] = launcher_run(cfg, params, "mixtral")
    ST.clear_step_cache()
    del params
    torch_cuda_empty()
    out["seconds"] = time.perf_counter() - t0
    print(f"mixtral: phase {out['seconds']:.1f}s ({cut}); "
          f"{torch.cuda.memory_allocated()} bytes left allocated")
    return out


# ---------------------------------------------------------------------------
# the vlm family
# ---------------------------------------------------------------------------

VLM_ARCH = "llama-3.2-vision-90b"
# the depth the card holds: 10 of 100 layers at full width, two groups of
# five each ending in a cross layer, 10.96 GB of int8 (100 layers would be
# 90.7 GB)
VLM_LAYERS = 10
# every x_gate, set in place of the reference's zero init (which would
# keep the patches from every logit)
VLM_GATE = 0.5
# the W8A16 and W8A8 kernels at llama-3.2-vision-90b's projections: (name,
# K, N, launches of a 10-layer decode step): wq and wo of every layer and
# of each cross layer's cross-attention, wk and wv (8 KV heads of 128;
# the cross layers' ran at the prime), the gated MLP's gate and up, down
VLM_SHAPES = (("proj", 8192, 8192, 2 * VLM_LAYERS + 2 * VLM_LAYERS // 5),
              ("kv", 8192, 1024, 2 * VLM_LAYERS),
              ("gate|up", 8192, 28672, 2 * VLM_LAYERS),
              ("down", 28672, 8192, VLM_LAYERS))


def vlm_prime_rows(flush):
    """qmatmul_w8a16 at a prime's M = 1,601 patches through a cross layer's
    wk or wv (K 8,192 x N 1,024): both kernels against the plain version,
    the mma path's rows equal alone and in slices of 17 (its last M tile
    holds 65 rows past 12 of 128), timed on the mma path (the prime's)
    beside the plain version, F.linear and the bound.  Returns (worst
    error, numbers)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.quant import quantize_weight
    from repro_torch.kernels import qmatmul as K

    c = get_config(VLM_ARCH)
    m, k, n = c.n_patches, c.d_model, c.n_kv_heads * c.head_dim
    gen = torch.Generator(device="cuda").manual_seed(SEED + 65)
    q = quantize_weight(torch.randn((k, n), generator=gen, device="cuda")
                        * k ** -0.5)
    w, ws = q.values, q.scale.reshape(-1).contiguous()
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    odt = torch.bfloat16
    ref = K.qmatmul_w8a16_ref(x, w, ws, out_dtype=odt)
    err, ratio = w8a16_check(f"kv M={m}", x, w, ws, None, "none", odt, ref)
    del ref
    w8a16_rows_check(x, w, ws, None, "none", odt)
    t = w8a16_numbers(x, w, ws, None, "none", odt, ("mma",), 1, flush)
    row = {"K": k, "N": n, "M": m, "path": "mma", "ms": t["ms"]["mma"],
           "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
           "bound_by": t["bound_by"], "library_ms": t["library_ms"],
           "max_abs_err": err, "err_tol": ratio}
    print(f"  qmatmul_w8a16 prime kv M={m} K={k} N={n} max_abs_err="
          f"{err:.3e} err/tol={ratio:.3f} (gemv, mma; mma rows alone and "
          f"in slices of 17 equal) mma_ms={row['ms']:.4f} plain_ms="
          f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
          f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']})")
    zero_counts()
    return err, row


def sources_reach_logits(cfg, params, label) -> None:
    """Two slots primed with different patches, fed the same token at the
    same place: their logits differ (the open gate carries the patches),
    while a slot primed again with the first slot's patches gives the
    first slot's logits bitwise."""
    import torch
    from repro_torch.core.qlinear import W8A16
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    prime = ST.make_prime_step(cfg, mode=W8A16)
    decode = ST.make_decode_step(cfg, mode=W8A16)
    g = torch.Generator(device="cuda").manual_seed(SEED + 67)
    p = R.source_len(cfg)
    with torch.inference_mode():
        cache = R.init_cache(cfg, 3, DENSE_MAX_SEQ, device="cuda")
        a, b = (torch.randn((1, p, cfg.d_model), generator=g,
                            device="cuda").to(torch.bfloat16)
                for _ in range(2))
        for sid, src in ((0, a), (1, b), (2, a)):
            prime(params, src, cache, sid, p)
        toks = torch.full((3, 1), 7, dtype=torch.int32, device="cuda")
        idx = torch.zeros((3,), dtype=torch.int32, device="cuda")
        logits = decode(params, {"tokens": toks, "cache_index": idx},
                        cache)[0].float()
    gap = float((logits[0] - logits[1]).abs().max())
    if gap == 0.0 or not torch.equal(logits[0], logits[2]):
        raise AssertionError(f"{label}: two sources' logits differ by "
                             f"{gap} (want > 0), or one source's rows "
                             f"differ")
    print(f"{label}: two sources' logits differ by up to {gap:.4f} at "
          f"x_gate {VLM_GATE}; the same source's rows are bitwise equal")


def vlm_phase(flush, profile_serves=False):
    """llama-3.2-vision-90b at full width and 10 of 100 layers (d 8,192, 64
    query and 8 KV heads of 128, gated SiLU MLP of 28,672, vocab 128,256
    untied, a tanh-gated cross-attention over 1,601 patches in every 5th
    layer): the kernels at its shapes (flash over the curve's tokens and,
    not causal, over the patches; qmatmul_w8a16's GEMV and mma path at
    its projections and head, and the mma path at a prime's 1,601 rows;
    qmatmul_w8a8), then the model from the streamed init (its peak under
    PEAK_BYTES) with every x_gate set to VLM_GATE, the patches shown to
    reach the logits, the dense trace with sources served contiguous and
    held to ``reference_outputs``, served paged with every token equal to
    the contiguous serve's and no block leaked, the captured prime and
    the captured tick timed against their floors, then the launcher's
    curve and decode loop under w8a16 and w8a8.  Returns the kernel rows,
    the launches of each run and the times."""
    import torch
    from repro_torch import engine as E
    from repro_torch.configs import get_config
    from repro_torch.models import registry as R
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    full = get_config(VLM_ARCH)
    cut = f"{VLM_LAYERS} of {full.n_layers} layers"
    print(f"vlm: the kernels at {VLM_ARCH}'s shapes (full width)")
    cases = []
    for b in (1, 4, SERVE_MAX_BATCH):
        bh = full.n_heads * b
        cases += [(f"self BH={bh}", bh, SERVE_SEQ, SERVE_SEQ, True),
                  (f"cross BH={bh}", bh, SERVE_SEQ, full.n_patches, False)]
    f_err, f_rows = source_flash_rows(flush, full.head_dim, cases, SEED + 61)
    q_err, q_rows, w8_err, w8_rows, per_m = family_qmatmul_rows(
        flush, VLM_ARCH, VLM_SHAPES, SEED + 63)
    p_err, p_row = vlm_prime_rows(flush)
    print(f"vlm: kernel rows {time.perf_counter() - t0:.1f}s")
    torch_cuda_empty()
    cfg, params = build_dense_model(VLM_ARCH, VLM_LAYERS)
    with torch.inference_mode():
        gates = [lp["x_gate"].fill_(VLM_GATE) for lp in params["layers"]
                 if "x_gate" in lp]
    print(f"vlm {VLM_ARCH}: {len(gates)} cross layers, every x_gate set to "
          f"{VLM_GATE} (tanh {math.tanh(VLM_GATE):.4f}) in place of its zero "
          f"init")
    label = f"vlm {VLM_ARCH} ({cut})"
    sources_reach_logits(cfg, params, label)
    reqs = E.synthetic_requests(
        DENSE_REQUESTS, rate_per_s=DENSE_RATE_PER_S, vocab=cfg.vocab,
        prompt_len=DENSE_PROMPT, max_new_tokens=DENSE_NEW,
        shared_prefix_len=DENSE_SHARED, seed=SEED,
        source_shape=R.source_shape(cfg))
    out = {"flash_rows": f_rows, "flash_err": f_err, "qmatmul_rows": q_rows,
           "qmatmul_err": max(q_err, p_err), "prime_row": p_row,
           "w8a8_rows": w8_rows, "w8a8_err": w8_err, "per_m": per_m}

    def busy(eng):
        return serve_busy(eng, reqs) if profile_serves else None

    eng, rep, out["launches"] = dense_serve(f"{label} contiguous", cfg,
                                            params, reqs)
    slot_bytes = (eng._cache["xk"].numel() + eng._cache["xv"].numel()) * 2 \
        // eng.num_slots
    print(f"{label} contiguous: the cross k/v of one slot {slot_bytes} "
          f"bytes ({slot_bytes / 1e6:.1f} MB); torch.cuda."
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes")
    compare_with_reference(f"{label} contiguous", cfg, params, eng, reqs,
                           rep.outputs())
    contig = rep.outputs()
    out["slot_cross_bytes"] = slot_bytes
    out["serves"] = {"contiguous": enc_serve_line(
        f"{label} contiguous", rep, busy(eng))}
    del eng
    eng, rep, out["paged_launches"] = dense_serve(
        f"{label} paged", cfg, params, reqs, block_size=DENSE_BLOCK,
        num_blocks=DENSE_NUM_BLOCKS)
    print(f"{label} paged: block_size {rep.block_size}, num_blocks "
          f"{rep.num_blocks}, peak_blocks_used {rep.peak_blocks_used}, "
          f"leaked_blocks {rep.leaked_blocks}, shared_block_hits "
          f"{rep.shared_block_hits} (each request's own patches seed its "
          f"prefix keys)")
    if rep.outputs() != contig or rep.leaked_blocks:
        raise AssertionError(f"{label} paged: tokens differ from the "
                             f"contiguous serve's, or {rep.leaked_blocks} "
                             f"blocks leaked")
    print(f"{label} paged: every token of {len(contig)} requests equal to "
          f"the contiguous serve's")
    out["serves"]["paged"] = enc_serve_line(f"{label} paged", rep,
                                            busy(eng))
    del eng
    ST.clear_step_cache()
    torch_cuda_empty()
    print(f"vlm: serves {time.perf_counter() - t0:.1f}s")
    out["prime"] = prime_time(cfg, params, f"{label} prime")
    out["tick"] = primed_tick_time(cfg, params, f"{label} tick")
    print(f"vlm: prime and tick {time.perf_counter() - t0:.1f}s")
    ST.clear_step_cache()
    torch_cuda_empty()
    out["launcher"] = launcher_run(cfg, params, "vlm")
    ST.clear_step_cache()
    del params
    torch_cuda_empty()
    out["seconds"] = time.perf_counter() - t0
    print(f"vlm: phase {out['seconds']:.1f}s ({cut}); "
          f"{torch.cuda.memory_allocated()} bytes left allocated")
    return out


# ---------------------------------------------------------------------------
# multiplexing and the replica router
# ---------------------------------------------------------------------------

MUX_LANES = ("starcoder2-3b", MOE_ARCH)    # the lane tags, first the slice's
MUX_REQUESTS = 16          # a lane
MUX_PROMPT = 16
MUX_NEW = 16
MUX_MAX_SEQ = MUX_PROMPT + MUX_NEW
MUX_RATE_PER_S = 400.0     # a lane (the contiguous slice's rate)
MUX_BLOCK = 16
MUX_QUOTA = 4              # the starcoder2-3b lane's class_quotas entry
MUX_COMPARE = 3            # requests a lane held to reference_outputs
MUX_TIMED_TICKS = 5        # captured ticks a wall timing
# hot-swap, on the virtual clock (1 ms a tick): a second starcoder2-3b
# lane (weights from SEED + 1) is admitted at MUX_ADMIT_S and the first
# lane retired at MUX_RETIRE_S; MUX_LATE requests arrive for it after
MUX_SWAP_TAG = "starcoder2-3b-swap"
MUX_ADMIT_S = 0.010
MUX_RETIRE_S = 0.020
MUX_SWAP_REQUESTS = 12     # each of the first two lanes
MUX_SWAP_NEW_LANE = 8
MUX_LATE = 4
MUX_REPLICAS = 2
MUX_SERVE_ARGS = (["--models", ",".join(MUX_LANES), "--model-quota",
                   f"{MUX_LANES[0]}={MUX_QUOTA}"] + SERVE_ARGS[2:])
# the router's CLI run: its decode loop is the serve phase's w8a16 run's,
# timed there
ROUTER_SERVE_ARGS = SERVE_ARGS + ["--replicas", str(MUX_REPLICAS),
                                  "--decode-tokens", "0"]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def mux_requests(lanes, n, seed_of, *, rid_base=0, shift=0.0,
                 rate=MUX_RATE_PER_S):
    """``n`` requests for each (tag, cfg) of ``lanes``, in the lane's
    vocabulary, prompts from ``seed_of(i)`` for lane i, rids offset by
    ``rid_base + i * n`` and arrivals by ``shift``; merged by arrival."""
    from repro_torch import engine as E

    reqs = []
    for i, (tag, cfg) in enumerate(lanes):
        reqs += [dataclasses.replace(r, rid=r.rid + rid_base + i * n,
                                     arrival_s=r.arrival_s + shift)
                 for r in E.synthetic_requests(
                     n, rate_per_s=rate, vocab=cfg.vocab,
                     prompt_len=MUX_PROMPT, max_new_tokens=MUX_NEW,
                     seed=seed_of(i), model=tag)]
    return sorted(reqs, key=lambda r: r.arrival_s)


def lane_requests(reqs, tag):
    """A lane's requests, untagged: what its dedicated engine serves."""
    return [dataclasses.replace(r, model=None) for r in reqs
            if r.model == tag]


def mux_engine(lanes=None, cfg=None, params=None, **kw):
    """The phase's engine geometry, multiplexed (``lanes``) or for one
    model."""
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16

    geometry = dict(mode=W8A16, num_slots=NUM_SLOTS, max_seq=MUX_MAX_SEQ,
                    prefill_chunk=PREFILL_CHUNK, **kw)
    if lanes is not None:
        return E.Engine(models=lanes, **geometry)
    return E.Engine(cfg, params, **geometry)


def mux_checked(label, lanes, rep, reqs) -> None:
    """Every request ok, MUX_NEW tokens in its lane's vocabulary."""
    if sorted(r.rid for r in rep.results) != sorted(r.rid for r in reqs):
        raise AssertionError(f"{label}: {len(rep.results)} results for "
                             f"{len(reqs)} requests")
    for r in rep.results:
        vocab = lanes[r.model][0].vocab if r.model else None
        if (r.status != "ok" or len(r.tokens) != MUX_NEW
                or not all(0 <= t < (vocab or 1 << 30) for t in r.tokens)):
            raise AssertionError(f"{label}: request {r.rid} ({r.model}): "
                                 f"status {r.status}, tokens {r.tokens}")


def mux_serve(label, eng, reqs, need, **kw):
    """``eng`` warmed up, then ``reqs`` served under the wall clock with
    the counters zeroed just before and read just after: no capture
    inside the serve, no plain version, no mma launch, every kernel of
    ``need`` launched.  Returns (report, launches)."""
    eng.warmup()
    bound = step_captures(eng)
    zero_counts()
    rep = eng.serve(reqs, clock="wall", **kw)
    launches, plain = read_counts()
    same_captures(label, eng, bound)
    mma_free(label, launches)
    if any(plain.values()) or any(launches[k] <= 0 for k in need):
        raise AssertionError(f"{label}: launches {launches} (need {need}), "
                             f"plain-version calls {plain}")
    print(f"{label}: {len(rep.results)} requests in {rep.ticks} ticks, "
          f"{rep.generated_tokens} tokens, wall {rep.wall_s:.3f}s, decoded "
          f"tok/s {rep.generated_tokens / rep.wall_s:.1f}, ms/tick "
          f"{1e3 * rep.wall_s / rep.ticks:.2f}, mean occupancy "
          f"{rep.mean_occupancy:.3f}; kernel launches {launches}")
    return rep, launches


def mux_tick_times(label, eng, deds, card):
    """The captured steady tick of every lane (NUM_SLOTS rows at position
    MUX_MAX_SEQ / 2 of its cache), alone and both lanes back to back (a
    multiplexed tick), against each dedicated engine's captured tick on
    its own cache: wall over MUX_TIMED_TICKS calls and device busy from
    torch.profiler.  The steps are the engines' own bindings (no capture)."""
    import torch

    S = NUM_SLOTS
    toks = torch.ones((S, 1), dtype=torch.int32, device="cuda")
    idx = torch.full((S,), MUX_MAX_SEQ // 2, dtype=torch.int32,
                     device="cuda")
    active = torch.ones((S,), dtype=torch.bool, device="cuda")

    def tick(*lanes):
        def fn():
            for ln in lanes:
                out = ln.step(ln.params, toks, ln.cache, idx, active)[0]
            out.cpu()
        return fn

    bound = step_captures(eng) + [c for d in deds.values()
                                  for c in step_captures(d)]
    what = f"captured tick ({S} rows at {MUX_MAX_SEQ // 2} of {MUX_MAX_SEQ})"
    out = {"multiplexed": device_breakdown(
        f"{label} both lanes", what, tick(*eng.lanes.values()),
        MUX_TIMED_TICKS, False)}
    for tag, ln in eng.lanes.items():
        lane = device_breakdown(f"{label} lane {tag}", what, tick(ln),
                                MUX_TIMED_TICKS, False)
        ded = device_breakdown(f"{label} dedicated {tag}", what,
                               tick(deds[tag].lanes[None]), MUX_TIMED_TICKS,
                               False)
        out[tag] = {"lane": lane, "dedicated": ded}
    after = step_captures(eng) + [c for d in deds.values()
                                  for c in step_captures(d)]
    if after != bound:
        raise AssertionError(f"{label}: timing the ticks captured a graph")

    def ms(t):
        busy = ("not measured" if t["busy"] is None
                else f"{t['busy']:.3f} ms")
        return f"wall {t['wall']:.2f} ms, busy {busy}"

    tags = list(eng.lanes)
    print(f"{label} ({card}): multiplexed tick (both lanes) "
          f"{ms(out['multiplexed'])}; "
          + "; ".join(f"{t}: lane {ms(out[t]['lane'])}, dedicated "
                      f"{ms(out[t]['dedicated'])}" for t in tags))
    return {k: ({kk: {"wall_ms": vv["wall"], "busy_ms": vv["busy"]}
                 for kk, vv in v.items()} if k in tags else
                {"wall_ms": v["wall"], "busy_ms": v["busy"]})
            for k, v in out.items()}


def mux_greedy(label, lanes, reqs, card, **kw):
    """(a) for one cache kind (``kw``: paging): the interleaved trace
    multiplexed under a class quota of MUX_QUOTA for the starcoder2-3b
    lane, then each lane's sub-trace on a dedicated engine; each lane's
    outputs exactly its dedicated engine's, no leak, the lanes'
    occupancies summing to the engine's tick by tick and the quota never
    exceeded.  Returns (numbers, the engines, the report)."""
    from repro_torch.core import batching as bt

    policy = bt.AdmissionPolicy(lambda b: 0.0, max_batch=NUM_SLOTS,
                                max_wait_s=0.0,
                                class_quotas={MUX_LANES[0]: MUX_QUOTA})
    paged = bool(kw)
    attn = "decode_attention_int8_paged" if paged else "decode_attention_int8"
    need = ("qmatmul_w8a16[gemv]", "qmatmul_w8a16_experts[gemv]", attn,
            "decode_attention_int8_paged")
    eng = mux_engine(lanes, policy=policy, **kw)
    rep, launches = mux_serve(label, eng, reqs, need)
    mux_checked(label, lanes, rep, reqs)
    occ = rep.model_occupancy
    if any(n != sum(v[t] for v in occ.values())
           for t, n in enumerate(rep.occupancy)) or rep.leaked_blocks:
        raise AssertionError(f"{label}: the lanes' occupancies do not sum "
                             f"to the engine's, or {rep.leaked_blocks} "
                             f"blocks leaked")
    if max(occ[MUX_LANES[0]]) > MUX_QUOTA:
        raise AssertionError(f"{label}: the {MUX_LANES[0]} lane held "
                             f"{max(occ[MUX_LANES[0]])} slots, quota "
                             f"{MUX_QUOTA}")
    deds, ded_tok_s = {}, {}
    for tag, (cfg, params) in lanes.items():
        ded = deds[tag] = mux_engine(cfg=cfg, params=params, **kw)
        sub = lane_requests(reqs, tag)
        drep, _ = mux_serve(f"{label} dedicated {tag}", ded, sub,
                            need[:1] + (attn,))
        ded_tok_s[tag] = drep.generated_tokens / drep.wall_s
        if rep.outputs_for(tag) != drep.outputs():
            raise AssertionError(f"{label}: lane {tag}'s outputs differ "
                                 f"from its dedicated engine's")
    tok_s = rep.generated_tokens / rep.wall_s
    print(f"{label} ({card}): each lane's {MUX_REQUESTS} outputs equal its "
          f"dedicated engine's token for token; 0 leaked blocks; per-model "
          f"mean occupancy {rep.model_mean_occupancy} (sum "
          f"{sum(rep.model_mean_occupancy.values()):.4f}, the engine's "
          f"{rep.mean_occupancy:.4f}); {MUX_LANES[0]} at most "
          f"{max(occ[MUX_LANES[0]])} slots (quota {MUX_QUOTA}); multiplexed "
          f"{tok_s:.1f} tok/s against dedicated "
          + ", ".join(f"{t} {v:.1f}" for t, v in ded_tok_s.items())
          + " tok/s")
    return {"tok_s": tok_s, "dedicated_tok_s": ded_tok_s,
            "ticks": rep.ticks, "wall_s": rep.wall_s,
            "mean_occupancy": rep.mean_occupancy,
            "model_mean_occupancy": rep.model_mean_occupancy,
            "model_peak": {t: max(v) for t, v in occ.items()},
            "launches": launches}, eng, deds, rep


def mux_sampled(label, lanes, reqs, card) -> dict:
    """(b): the trace multiplexed at t = SAMPLE_TEMP with PRNGKey(SEED +
    1), each lane exactly its dedicated sampled engine."""
    from repro_torch.runtime import prng as P

    kw = dict(temperature=SAMPLE_TEMP,
              rng=P.PRNGKey(SEED + 1, device="cuda"))
    need = ("qmatmul_w8a16[gemv]", "decode_attention_int8")
    rep, _ = mux_serve(label, mux_engine(lanes, **kw), reqs, need)
    mux_checked(label, lanes, rep, reqs)
    for tag, (cfg, params) in lanes.items():
        drep, _ = mux_serve(f"{label} dedicated {tag}",
                            mux_engine(cfg=cfg, params=params, **kw),
                            lane_requests(reqs, tag), need)
        if rep.outputs_for(tag) != drep.outputs():
            raise AssertionError(f"{label}: lane {tag}'s sampled outputs "
                                 f"differ from its dedicated engine's")
    print(f"{label} ({card}): t = {SAMPLE_TEMP}, PRNGKey({SEED + 1}): each "
          f"lane's outputs equal its dedicated sampled engine's token for "
          f"token; {rep.generated_tokens / rep.wall_s:.1f} tok/s")
    return {"tok_s": rep.generated_tokens / rep.wall_s}


def mux_hot_swap(label, lanes, contig, card) -> dict:
    """(c): a live serve (virtual clock) admits a second starcoder2-3b
    lane (weights from SEED + 1) at MUX_ADMIT_S and retires the first at
    MUX_RETIRE_S.  The first lane's admitted requests finish with the
    outputs ``contig`` (the contiguous multiplexed serve, same prompts)
    gave them, every one of its requests that arrives after the
    retirement comes back refused (no token, slot -1), the MoE lane's
    equal ``contig``'s, the new lane's its dedicated engine's; the ticks
    after the admission capture nothing."""
    import torch
    from repro_torch.models import registry as R

    first, moe = MUX_LANES
    cfg = lanes[first][0]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    with torch.inference_mode():
        swap_params = R.init_quantized(gen, cfg, min_size=2048,
                                       device="cuda")
    both = [(first, cfg), (moe, lanes[moe][0])]
    reqs = (mux_requests(both, MUX_SWAP_REQUESTS, lambda i: SEED + i)
            + mux_requests([(MUX_SWAP_TAG, cfg)], MUX_SWAP_NEW_LANE,
                           lambda i: SEED + 2, rid_base=1000,
                           shift=MUX_ADMIT_S)
            + mux_requests([(first, cfg)], MUX_LATE, lambda i: SEED + 3,
                           rid_base=2000, shift=MUX_RETIRE_S + 1e-3))
    reqs.sort(key=lambda r: r.arrival_s)
    eng = mux_engine(lanes)
    eng.warmup()
    after_admit = []

    def admit(e):
        e.admit_model(MUX_SWAP_TAG, cfg, swap_params)
        steps = step_objects(e)
        after_admit.append((steps, [s.captured.captures for s in steps]))

    rep = eng.serve(reqs, clock="virtual", control=[
        (MUX_ADMIT_S, admit),
        (MUX_RETIRE_S, lambda e: e.retire_model(first))])
    steps, bound = after_admit[0]
    if [s.captured.captures for s in steps] != bound:
        raise AssertionError(f"{label}: a tick after the admission "
                             f"captured a graph")
    by = {r.rid: r for r in rep.results}
    if sorted(by) != sorted(r.rid for r in reqs):
        raise AssertionError(f"{label}: not every request retired once")
    # the multiplexed serve's rids for the same prompts: lane i's rid r
    # there is i * MUX_REQUESTS + r, here i * MUX_SWAP_REQUESTS + r
    want = contig.outputs()
    done = refused = 0
    for r in reqs:
        got = by[r.rid]
        if r.model == first:
            if got.status == "refused":
                refused += 1
                if got.tokens or got.slot != -1:
                    raise AssertionError(f"{label}: refused request {r.rid} "
                                         f"has tokens or a slot")
                continue
            if got.status != "ok" or r.arrival_s > MUX_RETIRE_S or \
                    got.tokens != want[r.rid]:
                raise AssertionError(f"{label}: request {r.rid} of the "
                                     f"retired lane: {got.status}")
            done += 1
        elif r.model == moe:
            base = r.rid - MUX_SWAP_REQUESTS + MUX_REQUESTS
            if got.status != "ok" or got.tokens != want[base]:
                raise AssertionError(f"{label}: {moe} request {r.rid} "
                                     f"differs from the multiplexed serve")
    if not done or refused < MUX_LATE or rep.refused != refused:
        raise AssertionError(f"{label}: {done} in-flight requests of the "
                             f"retired lane finished, {refused} refused")
    ded = mux_engine(cfg=cfg, params=swap_params)
    dref = ded.serve(lane_requests(reqs, MUX_SWAP_TAG)).outputs()
    if rep.outputs_for(MUX_SWAP_TAG) != dref or MUX_SWAP_TAG not in \
            eng.lanes or first in eng.lanes:
        raise AssertionError(f"{label}: the admitted lane's outputs differ "
                             f"from its dedicated engine's, or the lanes "
                             f"are {list(eng.lanes)}")
    print(f"{label} ({card}): {MUX_SWAP_TAG} admitted at {MUX_ADMIT_S} s "
          f"(warmed up at its admission; the later ticks captured "
          f"nothing), {first} retired at {MUX_RETIRE_S} s: {done} of its "
          f"requests finished as in the multiplexed serve, {refused} "
          f"refused (no tokens, slot -1); the new lane's "
          f"{MUX_SWAP_NEW_LANE} outputs equal its dedicated engine's; "
          f"{rep.ticks} ticks; lanes now {list(eng.lanes)}")
    return {"finished": done, "refused": refused, "ticks": rep.ticks}


def mux_router(label, cfg, params, card) -> dict:
    """(d): a ReplicaRouter over MUX_REPLICAS starcoder2-3b engines sharing
    one weight tree: the same plan on two calls, the serve (wall clock,
    each replica warmed up) placing requests as planned, each replica's
    outputs exactly a dedicated engine's on its sub-trace."""
    from repro_torch import engine as E

    reqs = lane_requests(mux_requests([(MUX_LANES[0], cfg)], MUX_REQUESTS,
                                      lambda i: SEED), MUX_LANES[0])
    fleet = [mux_engine(cfg=cfg, params=params)
             for _ in range(MUX_REPLICAS)]
    router = E.ReplicaRouter(fleet)
    plans = [router.route(reqs) for _ in range(2)]
    seen = [({n: [r.rid for r in sub] for n, sub in p.assignments.items()},
             [r.rid for r in p.refused],
             [(d.rid, d.replica, d.now, d.capacity) for d in p.decisions])
            for p in plans]
    if seen[0] != seen[1] or seen[0][1]:
        raise AssertionError(f"{label}: two route() calls disagree, or "
                             f"refused {seen[0][1]}")
    for eng in fleet:
        eng.warmup()
    bound = [step_captures(e) for e in fleet]
    zero_counts()
    rrep = router.serve(reqs, clock="wall")
    launches, plain = read_counts()
    if [step_captures(e) for e in fleet] != bound:
        raise AssertionError(f"{label}: the routed serve captured a graph")
    mma_free(label, launches)
    need = ("qmatmul_w8a16[gemv]", "decode_attention_int8")
    if any(plain.values()) or any(launches[k] <= 0 for k in need):
        raise AssertionError(f"{label}: launches {launches}, plain-version "
                             f"calls {plain}")
    ded = mux_engine(cfg=cfg, params=params)
    for name, sub in plans[0].assignments.items():
        got = rrep.replicas[name].outputs()
        if sorted(got) != sorted(r.rid for r in sub) or \
                got != ded.serve(sub).outputs():
            raise AssertionError(f"{label}: {name}'s outputs differ from a "
                                 f"dedicated engine's on its sub-trace")
    if rrep.leaked_blocks or any(r.status != "ok" for r in rrep.results):
        raise AssertionError(f"{label}: a request failed or a block leaked")
    print(f"{label} ({card}): {MUX_REPLICAS} replicas sharing one weight "
          f"tree; the same plan on two route() calls; each replica's "
          f"outputs equal a dedicated engine's on its sub-trace; fleet "
          f"{rrep.tokens_per_s:.1f} tok/s over the slowest replica's "
          f"{rrep.duration_s:.3f} s; per replica: "
          + ", ".join(f"{n} {rrep.replica_requests[n]} requests, "
                      f"occupancy {rrep.replica_occupancy[n]:.3f}, "
                      f"{rrep.replicas[n].tokens_per_s:.1f} tok/s"
                      for n in rrep.replica_names)
          + f"; kernel launches {launches}")
    return {"tok_s": rrep.tokens_per_s,
            "replica_occupancy": rrep.replica_occupancy,
            "replica_requests": rrep.replica_requests,
            "launches": launches}


def router_cli_run(card) -> dict:
    """(e), second run: the serve CLI with ``--replicas 2`` at full
    starcoder2-3b width: exit 0, its three router lines, every request
    ok, no plain version."""
    import contextlib
    import io

    from repro_torch.launch import serve

    label = "serve replicas"
    argv = ROUTER_SERVE_ARGS + ["--quant", "w8a16"]
    print(f"{label}: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    zero_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = serve.run(serve.parse_args(argv))
    launches, plain = read_counts()
    print(out.getvalue(), end="")
    lines = [ln for ln in out.getvalue().splitlines()
             if ln.startswith("[router]")]
    rrep = res.router_report
    if res.code != 0 or rrep is None or len(lines) != 3 or \
            "per-replica occupancy" not in lines[-1]:
        raise AssertionError(f"{label}: exit code {res.code}, router lines "
                             f"{lines}")
    if any(plain.values()) or launches["qmatmul_w8a16[gemv]"] <= 0 or \
            launches["flash_attention_bhsd"] <= 0 or \
            any(r.status != "ok" for r in rrep.results) or \
            len(rrep.results) != len(res.requests):
        raise AssertionError(f"{label}: launches {launches}, plain "
                             f"{plain}, statuses "
                             f"{[r.status for r in rrep.results]}")
    print(f"{label} ({card}): run {time.perf_counter() - t0:.1f}s, exit 0, "
          f"{len(res.fleet)} replicas; kernel launches {launches}")
    return launches


def multiplex_phase(cfg, params):
    """Multiplexing and the replica router at full width: starcoder2-3b
    (the slice's params) and qwen2-moe-a2.7b (the streamed init, its
    init's own peak under PEAK_BYTES), both W8A16 on the int8 KV cache,
    as lanes of one engine: (a) greedy, contiguous then paged, each lane
    exactly its dedicated engine and MUX_COMPARE requests a lane
    ``reference_outputs`` (contiguous), with the lanes' and the dedicated
    engines' captured ticks timed; (b) sampled; (c) hot-swap; (d) the
    router; (e) the serve CLI with ``--models`` and ``--model-quota``,
    then with ``--replicas``.  Everything it allocates is freed before
    it returns.  Returns its numbers."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    card = card_line()
    ST.clear_step_cache()          # earlier phases' graphs and bindings
    torch_cuda_empty()
    mcfg, mparams = build_dense_model(MOE_ARCH, beside=True)
    mcfg = dataclasses.replace(mcfg, kv_quant=True)
    first, moe = MUX_LANES
    lanes = {first: (cfg, params), moe: (mcfg, mparams)}
    reqs = mux_requests([(first, cfg), (moe, mcfg)], MUX_REQUESTS,
                        lambda i: SEED + i)
    out = {"card": card, "lanes": list(MUX_LANES)}
    label = "multiplex"
    out["contiguous"], eng, deds, contig = mux_greedy(
        f"{label} contiguous", lanes, reqs, card)
    out["tick"] = mux_tick_times(f"{label} tick", eng, deds, card)
    for tag in lanes:
        compare_with_reference(f"{label} {tag}", *lanes[tag], eng,
                               lane_requests(reqs, tag)[:MUX_COMPARE],
                               contig.outputs_for(tag))
    del eng, deds
    out["paged"], eng, deds, paged = mux_greedy(
        f"{label} paged", lanes, reqs, card, block_size=MUX_BLOCK)
    if paged.outputs() != contig.outputs():
        raise AssertionError(f"{label} paged: outputs differ from the "
                             f"contiguous serve's")
    del eng, deds, paged
    out["sampled"] = mux_sampled(f"{label} sampled", lanes, reqs, card)
    out["hot_swap"] = mux_hot_swap(f"{label} hot-swap", lanes, contig, card)
    out["router"] = mux_router(f"{label} router", cfg, params, card)
    ST.clear_step_cache()
    del lanes, mparams, contig
    torch_cuda_empty()
    real_curve, curve_paths = serve.measure_service_curve, {}
    serve.measure_service_curve = counted_curve(real_curve, curve_paths)
    try:
        launches, res = serve_run(
            "w8a16", curve_paths, base=MUX_SERVE_ARGS,
            label="serve multiplexed",
            expect=[f"[engine]   model {t}: p99" for t in MUX_LANES])
        rep = res.report
        peak = {t: max(v) for t, v in rep.model_occupancy.items()}
        if peak[first] > MUX_QUOTA or \
                launches["qmatmul_w8a16_experts[gemv]"] <= 0:
            raise AssertionError(f"serve multiplexed: peak slots {peak} "
                                 f"(quota {MUX_QUOTA}), launches "
                                 f"{launches}")
        print(f"serve multiplexed ({card}): exit 0, a report line a "
              f"model, peak slots {peak} (quota {MUX_QUOTA} for {first})")
        out["cli"] = {"launches": launches,
                      "tok_s": rep.tokens_per_s,
                      "model_mean_occupancy": rep.model_mean_occupancy}
        del res, rep
        ST.clear_step_cache()
        torch_cuda_empty()
        out["router_cli"] = {"launches": router_cli_run(card)}
    finally:
        serve.measure_service_curve = real_curve
    ST.clear_step_cache()
    torch_cuda_empty()
    out["seconds"] = time.perf_counter() - t0
    print(f"multiplex ({card}): phase {out['seconds']:.1f}s; "
          f"{torch.cuda.memory_allocated()} bytes left allocated")
    return out


SHARD_TPS = (2, 4)          # shards of the NUM_SLOTS pool on the one card
SHARD_BLOCKS = OVERLOAD_BLOCKS   # the paged serve's pool: preemption bites
SHARD_TIMED_TICKS = 5       # captured ticks a wall timing
SHARD_CLI_ARGS = SERVE_ARGS + ["--decode-tokens", "0"]
SHARD_NEED = ("qmatmul_w8a16[gemv]", "decode_attention_int8",
              "decode_attention_int8_paged")
SHARD_SPEC_REQUESTS = 8     # the speculating serve's share of the trace


def graph_pool_bytes(eng):
    """(reserved, allocated) bytes of the private pools that the graphs
    bound to ``eng``'s caches hold (its steps' bindings on its cache or
    on its shards' views of it)."""
    ptrs = {t.untyped_storage().data_ptr() for ln in eng.lanes.values()
            for c in (ln._cache, ln._draft_cache) if c for t in c.values()}
    caps = {id(s.captured): s.captured for s in step_objects(eng)}
    held = [b.pool_bytes for cap in caps.values()
            for b in cap._bindings.values() if b.cache_leaves and
            b.cache_leaves[0].untyped_storage().data_ptr() in ptrs]
    return tuple(sum(p[i] for p in held) for i in (0, 1))


def shard_engine(cfg, params, tp=1, **kw):
    """The contiguous slice's engine geometry, its slot pool split into
    ``tp`` shards on the card (``tp`` 1: the single-device executor)."""
    from repro_torch import engine as E
    from repro_torch.core.qlinear import W8A16

    if tp > 1:
        kw["backend"] = E.ShardedExecutor(
            tp, devices=[torch_device()] * tp)
    kw.setdefault("prefill_chunk", PREFILL_CHUNK)
    return E.Engine(cfg, params, mode=W8A16, num_slots=NUM_SLOTS,
                    max_seq=PROMPT_LEN + MAX_NEW, **kw)


def torch_device():
    import torch
    return torch.device("cuda", torch.cuda.current_device())


def shard_tick_times(label, engines, card) -> dict:
    """The captured steady tick (NUM_SLOTS rows at position (PROMPT_LEN +
    MAX_NEW) / 2, all active) of each engine of ``engines`` ({tp: engine},
    tp 1 the single-device control) on its own cache: wall over
    SHARD_TIMED_TICKS calls and device busy from torch.profiler.  The
    steps are the engines' own bindings: no capture."""
    import torch

    S, pos = NUM_SLOTS, (PROMPT_LEN + MAX_NEW) // 2
    toks = torch.ones((S, 1), dtype=torch.int32, device="cuda")
    idx = torch.full((S,), pos, dtype=torch.int32, device="cuda")
    active = torch.ones((S,), dtype=torch.bool, device="cuda")
    bound = [step_captures(e) for e in engines.values()]
    out = {}
    for tp, eng in engines.items():
        ln = eng.lanes[None]

        def fn(ln=ln):
            ln.step(ln.params, toks, ln.cache, idx, active)[0].cpu()

        t = device_breakdown(f"{label} tp={tp}",
                             f"captured tick ({S} rows at {pos})", fn,
                             SHARD_TIMED_TICKS, False)
        out[tp] = {"wall_ms": t["wall"], "busy_ms": t["busy"],
                   "graph_launches": t["graph_launches"]}
    if [step_captures(e) for e in engines.values()] != bound:
        raise AssertionError(f"{label}: timing the ticks captured a graph")
    one = out[1]
    print(f"{label} ({card}): captured tick wall / busy ms: "
          + "; ".join(f"tp={tp} {t['wall_ms']:.2f} / "
                      + ("not measured" if t["busy_ms"] is None
                         else f"{t['busy_ms']:.3f}")
                      + f" ({t['wall_ms'] / one['wall_ms']:.2f}x tp=1)"
                      for tp, t in out.items()))
    return out


def shard_cli_run(card, tp_args, control_cfg=None) -> dict:
    """The serve CLI at full starcoder2-3b width with ``tp_args`` (``--tp
    2``, with or without ``--replicas 2``): exit 0, its "sharded
    executor" line, every request ok, kernels 1-3 launched and no plain
    version; N_COMPARE requests held to ``reference_outputs``."""
    import contextlib
    import io

    from repro_torch.launch import serve

    argv = SHARD_CLI_ARGS + ["--quant", "w8a16"] + tp_args
    label = f"serve {' '.join(tp_args)}"
    print(f"{label}: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    zero_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = serve.run(serve.parse_args(argv))
    launches, plain = read_counts()
    print(out.getvalue(), end="")
    rep = res.router_report or res.report
    if res.code != 0 or rep is None or \
            "[serve] sharded executor: tp=2 " not in out.getvalue():
        raise AssertionError(f"{label}: exit code {res.code}")
    if any(plain.values()) or any(launches[k] <= 0 for k in SHARD_NEED[:1]) \
            or any(r.status != "ok" for r in rep.results) or \
            len(rep.results) != len(res.requests):
        raise AssertionError(f"{label}: launches {launches}, plain "
                             f"{plain}, statuses "
                             f"{[r.status for r in rep.results]}")
    reqs = sorted(res.requests, key=lambda r: r.rid)[:N_COMPARE]
    compare_with_reference(label, res.cfg, res.params, res.engine, reqs,
                           rep.outputs())
    print(f"{label} ({card}): run {time.perf_counter() - t0:.1f}s, exit 0, "
          f"{len(rep.results)} requests ok, {rep.tokens_per_s:.1f} tok/s; "
          f"kernel launches {launches}")
    return {"launches": launches, "tok_s": rep.tokens_per_s}


def sharded_phase(cfg, params):
    """Scale-out at full width on the one card: starcoder2-3b (the slice's
    params, W8A16, int8 cache) on the contiguous slice's trace through
    ``ShardedExecutor(tp, devices=[card] * tp)`` for tp in SHARD_TPS,
    each serve's outputs bitwise the single-device control serve's (the
    control alive beside it: the graph budget must keep every engine's
    graphs), no capture in a serve, kernels 1-3 launched; the captured
    tick of each tp against the control's; tp 2 paged (blocks of
    PAGED_BLOCK, SHARD_BLOCKS of them) with preemption and sampling
    against its single-device control; tp 2 speculating (k = SPEC_K, a
    1-layer self-draft) on SHARD_SPEC_REQUESTS of the requests against
    the control; the serve CLI with ``--tp
    2`` and with ``--replicas 2 --tp 2``.  Everything it allocates is
    freed before it returns.  Returns its numbers."""
    from repro_torch import engine as E
    from repro_torch.runtime import prng as P
    from repro_torch.runtime import steps as ST

    t0 = time.perf_counter()
    card = card_line()
    ST.clear_step_cache()
    torch_cuda_empty()
    reqs = E.synthetic_requests(N_REQUESTS, rate_per_s=400.0,
                                vocab=cfg.vocab, prompt_len=PROMPT_LEN,
                                max_new_tokens=MAX_NEW, seed=SEED)
    out = {"card": card}
    label = "sharded"
    control = shard_engine(cfg, params)
    crep, _ = mux_serve(f"{label} control", control, reqs, SHARD_NEED)
    check_served(f"{label} control", cfg, crep, reqs)
    out["control"] = {"tok_s": crep.generated_tokens / crep.wall_s,
                      "ticks": crep.ticks}
    engines = {1: control}
    for tp in SHARD_TPS:
        eng = engines[tp] = shard_engine(cfg, params, tp)
        rep, launches = mux_serve(f"{label} tp={tp}", eng, reqs, SHARD_NEED)
        if rep.outputs() != crep.outputs():
            raise AssertionError(f"{label} tp={tp}: outputs differ from "
                                 f"the single-device control's")
        check_served(f"{label} tp={tp}", cfg, rep, reqs)
        out[f"tp{tp}"] = {"tok_s": rep.generated_tokens / rep.wall_s,
                          "ticks": rep.ticks, "launches": launches}
        print(f"{label} tp={tp} ({card}): {len(reqs)} outputs bitwise the "
              f"control's; {out[f'tp{tp}']['tok_s']:.1f} tok/s against the "
              f"control's {out['control']['tok_s']:.1f}")
    out["tick"] = shard_tick_times(f"{label} tick", engines, card)
    out["pool_bytes"] = {tp: graph_pool_bytes(e) for tp, e in
                         engines.items()}
    print(f"{label} ({card}): the private pools of each engine's graphs "
          f"(tick and chunks), reserved / allocated bytes: "
          + "; ".join(f"tp={tp} {r} / {a}" for tp, (r, a) in
                      out["pool_bytes"].items()))
    del engines, eng
    ST.clear_step_cache()
    torch_cuda_empty()
    # tp 2 paged, preempting, sampled, against its own control
    preqs = overload_trace(cfg, OVERLOAD_RATE_PER_S)
    kw = dict(block_size=PAGED_BLOCK, num_blocks=SHARD_BLOCKS,
              temperature=SAMPLE_TEMP,
              rng=P.PRNGKey(SEED + 1, device="cuda"))
    reps = {}
    for tp in (1, 2):
        eng = shard_engine(cfg, params, tp, **kw)
        reps[tp], _ = mux_serve(f"{label} paged tp={tp}", eng, preqs,
                                SHARD_NEED[:1] + SHARD_NEED[2:],
                                preemption=True)
    same_as_control(f"{label} paged tp=2", reps[2], reps[1])
    if reps[2].preempted <= 0 or reps[1].leaked_blocks or \
            reps[2].leaked_blocks or \
            any(r.status != "ok" for r in reps[2].results):
        raise AssertionError(f"{label} paged tp=2: preempted "
                             f"{reps[2].preempted}, leaked "
                             f"{reps[2].leaked_blocks}")
    out["paged"] = {"preempted": reps[2].preempted,
                    "control_preempted": reps[1].preempted,
                    "tok_s": reps[2].generated_tokens / reps[2].wall_s,
                    "control_tok_s": reps[1].generated_tokens
                    / reps[1].wall_s}
    print(f"{label} paged tp=2 ({card}): {reps[2].preempted} preemptions "
          f"(control {reps[1].preempted}), 0 leaked blocks, every request "
          f"ok and equal to the control's")
    del reps, eng
    ST.clear_step_cache()
    torch_cuda_empty()
    # tp 2 speculating: the control's greedy tokens, whatever the draft
    eng = shard_engine(cfg, params, 2, spec_k=SPEC_K,
                       draft_layers=SPEC_DRAFT_LAYERS)
    sreqs = reqs[:SHARD_SPEC_REQUESTS]
    rep, _ = mux_serve(f"{label} spec tp=2", eng, sreqs, SHARD_NEED)
    if rep.outputs() != {r.rid: crep.outputs()[r.rid] for r in sreqs}:
        raise AssertionError(f"{label} spec tp=2: outputs differ from the "
                             f"control's")
    out["spec"] = {"tok_s": rep.generated_tokens / rep.wall_s,
                   "accepted_per_dispatch": rep.accepted_per_dispatch}
    print(f"{label} spec tp=2 ({card}): outputs bitwise the control's; "
          f"{rep.accepted_per_dispatch:.3f} tokens a dispatch")
    del eng, rep
    ST.clear_step_cache()
    torch_cuda_empty()
    out["cli"] = shard_cli_run(card, ["--tp", "2"])
    ST.clear_step_cache()
    torch_cuda_empty()
    out["router_cli"] = shard_cli_run(card, ["--replicas", "2", "--tp", "2"])
    ST.clear_step_cache()
    torch_cuda_empty()
    out["seconds"] = time.perf_counter() - t0
    print(f"sharded ({card}): phase {out['seconds']:.1f}s")
    return out


# ---------------------------------------------------------------------------
# train phase: the training path on the card
# ---------------------------------------------------------------------------

TRAIN_ARCH = "starcoder2-3b"
TRAIN_SEQ = 128
TRAIN_BATCH = 8
TRAIN_STEPS = 12            # the CLI run at full width and depth
TRAIN_LR = 1e-5             # (20 warm-up steps: 5e-7 .. 6e-6 over the run)
TRAIN_PEAK_BYTES = 60e9     # params, grads, AdamW's m and v: 48.5 GB in f32
# (BH, window) of the kernel rows at the training shape: 8 rows x 24
# heads, S 128, hd 128, causal; and with a window of 32
TRAIN_FLASH = ((TRAIN_BATCH * 24, None), (TRAIN_BATCH * 24, 32))
# the model-level check at reduced size: the card's loss and every grad
# leaf against the port's on the CPU (plain versions).  Both round the
# bf16 activations and weight grads at the same places; f32 sums in other
# orders part them by a bf16 ulp here and there, as against the JAX
# package (tests/test_torch_train.py: loss 3e-4, grads 0.09-1.34%)
TRAIN_LOSS_ATOL = 1e-3
TRAIN_GRAD_RTOL = 0.03
TRAIN_RESUME_STEPS = 12     # the reduced kill-and-resume run
TRAIN_CKPT_EVERY = 5


def train_flash_rows(flush):
    """flash_attention_bhsd at the training shape and a windowed case: the
    forward against its plain version (bf16_close), the autograd
    Function's dQ, dK, dV (``ops.flash_attention``, whose backward is
    ``flash_attention_bwd``) against autograd of the plain version
    (bf16_close each), and the times of both directions against their
    bounds and SDPA's (forward; forward + backward's backward half)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    s, hd = TRAIN_SEQ, 128
    scale = hd ** -0.5
    gen = torch.Generator(device="cuda").manual_seed(SEED + 36)
    rows, worst = {}, 0.0
    for bh, window in TRAIN_FLASH:
        # (1, S, BH, hd): ops.flash_attention's layout, one row of BH heads
        q4, k4, v4, do4 = (torch.randn((1, s, bh, hd), generator=gen,
                                       device="cuda").to(torch.bfloat16)
                           for _ in range(4))
        q, k, v, do = (t[0].transpose(0, 1).contiguous()
                       for t in (q4, k4, v4, do4))
        kw = dict(causal=True, window=window)
        out = FA.flash_attention_bhsd(q, k, v, **kw)
        ref = FA.flash_attention_ref(q, k, v, **kw)
        err, ratio = bf16_close(out, ref, f32_out=False)
        leaves = [t.clone().requires_grad_(True) for t in (q4, k4, v4)]
        got = torch.autograd.grad(ops.flash_attention(*leaves, **kw),
                                  leaves, do4)
        got = [g[0].transpose(0, 1) for g in got]
        plain_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        plain_out = FA.flash_attention_ref(*plain_leaves, **kw)
        want = torch.autograd.grad(plain_out, plain_leaves, do,
                                   retain_graph=True)
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or not torch.isfinite(g).all():
                raise AssertionError(f"train flash BH={bh}: bad {name}")
            e, r = bf16_close(g, w, f32_out=False)
            err, ratio = max(err, e), max(ratio, r)
        worst = max(worst, err)
        if ratio > 1.0:
            raise AssertionError(
                f"train flash BH={bh} window={window}: the forward or the "
                f"gradient disagrees with the plain version beyond "
                f"tolerance (err/tol={ratio:.3f})")
        qpos = torch.arange(s)[:, None]
        kpos = torch.arange(s)[None, :]
        valid = kpos <= qpos
        if window is not None:
            valid &= kpos > qpos - window
        pairs = int(valid.sum())
        mask = valid.to("cuda") if window is not None else None
        sq, sk, sv = (t[0].transpose(0, 1)[None].contiguous()
                      .requires_grad_(True) for t in (q4, k4, v4))
        sdo = do[None]
        sdpa_out = F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=mask, is_causal=mask is None)
        fwd = {
            "ms": time_ms(lambda: FA.flash_attention_bhsd(q, k, v, **kw),
                          TIMED_ITERS, flush),
            "plain_ms": time_ms(lambda: FA.flash_attention_ref(q, k, v,
                                                               **kw),
                                1, flush, warmup=False),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                sq, sk, sv, attn_mask=mask, is_causal=mask is None),
                TIMED_ITERS, flush),
            "bytes_ms": 4 * bh * s * hd * 2 / HBM_BYTES_PER_S * 1e3,
            "ops_ms": 4 * bh * pairs * hd / BF16_OPS_PER_S * 1e3}
        # backward: q, k, v and dO read, dQ, dK, dV written (bf16); five
        # products over the valid (query, key) pairs: S again, dV, dP,
        # dQ, dK
        bwd = {
            "ms": time_ms(lambda: FA.flash_attention_bwd(q, k, v, do, **kw),
                          TIMED_ITERS, flush),
            "plain_ms": time_ms(lambda: torch.autograd.grad(
                plain_out, plain_leaves, do, retain_graph=True), 1, flush,
                warmup=False),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                sdpa_out, (sq, sk, sv), sdo, retain_graph=True),
                TIMED_ITERS, flush),
            "bytes_ms": 7 * bh * s * hd * 2 / HBM_BYTES_PER_S * 1e3,
            "ops_ms": 10 * bh * pairs * hd / BF16_OPS_PER_S * 1e3}
        for t in (fwd, bwd):
            t["bound_ms"] = max(t["bytes_ms"], t["ops_ms"])
            t["bound_by"] = ("bytes" if t["bytes_ms"] >= t["ops_ms"]
                             else "operations")
        label = f"BH={bh} S={s} hd={hd} causal window={window}"
        rows[label] = {"forward": fwd, "backward": bwd, "max_abs_err": err}
        for what, t in (("forward (kernel)", fwd),
                        ("backward (flash_attention_bwd)", bwd)):
            print(f"  train flash {label} {what}: ms={t['ms']:.4f} "
                  f"plain_ms={t['plain_ms']:.4f} library_ms="
                  f"{t['library_ms']:.4f} (SDPA) bound_ms="
                  f"{t['bound_ms']:.5f} ({t['bound_by']})")
        print(f"  train flash {label}: max_abs_err={err:.3e} (forward, dQ, "
              f"dK, dV) err/tol={ratio:.3f}")
    return worst, rows


def train_model_check():
    """Reduced starcoder2-3b: the loss and every grad leaf on the card
    (the kernel's forward, the Function's gradient, remat) against the
    port on the CPU (plain versions) on the same weights and batch; on the
    card 2 kernel launches a layer (forward and remat recompute), one
    backward call a layer, no plain forward."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMData
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import registry as R
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.runtime import steps as ST

    cfg = get_config(TRAIN_ARCH).reduced()
    cpu = R.init(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    card = tree_map(lambda t: t.to("cuda"), cpu)
    tokens, labels = SyntheticLMData(cfg.vocab, 32, 4,
                                     seed=SEED).batch_at(0)
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = {"tokens": torch.from_numpy(tokens).to(dev),
                 "labels": torch.from_numpy(labels).to(dev)}
        zero_counts()
        FA.flash_attention_bwd.calls = 0
        loss = ST.make_loss_fn(cfg)(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        launches, plain = read_counts()
        out[dev] = (float(loss.detach()), [g.float().cpu() for g in grads],
                    launches["flash_attention_bhsd"],
                    plain["flash_attention_ref"], FA.flash_attention_bwd.calls)
    loss, grads, n, ref_calls, bwd = out["cuda"]
    if (n, ref_calls, bwd) != (2 * cfg.n_layers, 0, cfg.n_layers):
        raise AssertionError(f"train model: kernel launches {n}, plain "
                             f"calls {ref_calls}, backward calls {bwd}; want "
                             f"{2 * cfg.n_layers}, 0, {cfg.n_layers}")
    dloss = abs(loss - out["cpu"][0])
    worst = max(float((g - w).norm() / w.norm())
                for g, w in zip(grads, out["cpu"][1]))
    print(f"train model: reduced {TRAIN_ARCH} ({cfg.n_layers} layers, d="
          f"{cfg.d_model}), loss card {loss:.6f} cpu {out['cpu'][0]:.6f} "
          f"(|diff| {dloss:.2e}, tol {TRAIN_LOSS_ATOL}); {len(grads)} grad "
          f"leaves, worst ||g_card - g_cpu|| / ||g_cpu|| {worst:.4f} (tol "
          f"{TRAIN_GRAD_RTOL}); {n} kernel launches, {bwd} backward calls, "
          f"0 plain forwards")
    if dloss > TRAIN_LOSS_ATOL or worst > TRAIN_GRAD_RTOL or not all(
            torch.isfinite(g).all() for g in grads):
        raise AssertionError("train model: the card's loss or gradients "
                             "disagree with the CPU's beyond tolerance")
    return {"loss_diff": dloss, "grad_rel_err": worst}


def train_cli_run():
    """The train launcher at full width and depth (30 layers, d 3,072, f32
    params, AdamW), in this process so that the counts are read around
    it: exit 0, every loss finite, 2 flash launches a layer a step (the
    forward and remat's recompute), one backward call a layer a step, no
    plain version and no qmatmul, peak memory under TRAIN_PEAK_BYTES."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as TR

    argv = ["--arch", TRAIN_ARCH, "--seq-len", str(TRAIN_SEQ), "--batch",
            str(TRAIN_BATCH), "--steps", str(TRAIN_STEPS), "--lr",
            str(TRAIN_LR), "--log-every", "1"]
    print(f"train: python -m repro_torch.launch.train {' '.join(argv)}")
    torch_cuda_empty()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    FA.flash_attention_bwd.calls = 0
    t0 = time.perf_counter()
    run = TR.train(argv)
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    bwd = FA.flash_attention_bwd.calls
    peak = torch.cuda.max_memory_allocated()
    layers = get_config(TRAIN_ARCH).n_layers
    step_ms = 1e3 * statistics.median(run.step_seconds[1:])
    tok_s = TRAIN_BATCH * TRAIN_SEQ / (step_ms / 1e3)
    print(f"train: exit code {run.rc}, {len(run.losses)} steps in "
          f"{wall:.1f}s (init included), losses "
          f"{[round(x, 4) for x in run.losses]}; step ms (median of steps "
          f"1-{TRAIN_STEPS - 1}) {step_ms:.1f}, first step "
          f"{1e3 * run.step_seconds[0]:.1f}; tokens/s {tok_s:.1f}; peak "
          f"allocated {peak} bytes (limit {TRAIN_PEAK_BYTES:.0f}); "
          f"flash_attention_bhsd launches {launches['flash_attention_bhsd']}"
          f" (want {2 * layers * TRAIN_STEPS}), flash_attention_bwd calls "
          f"{bwd} (want {layers * TRAIN_STEPS}), plain-version calls "
          f"{plain}")
    others = {k: n for k, n in launches.items()
              if n and k != "flash_attention_bhsd"}
    if run.rc != 0 or not all(math.isfinite(x) for x in run.losses) or \
            len(run.losses) != TRAIN_STEPS:
        raise AssertionError(f"train: exit code {run.rc}, losses "
                             f"{run.losses}")
    if (launches["flash_attention_bhsd"] != 2 * layers * TRAIN_STEPS
            or bwd != layers * TRAIN_STEPS or any(plain.values())
            or others):
        raise AssertionError(f"train: launches {launches}, backward calls "
                             f"{bwd}, plain calls {plain}")
    if peak >= TRAIN_PEAK_BYTES:
        raise AssertionError(f"train: peak allocated {peak} bytes, limit "
                             f"{TRAIN_PEAK_BYTES:.0f}")
    torch_cuda_empty()
    return {"rc": run.rc, "losses": run.losses, "step_ms": step_ms,
            "first_step_ms": 1e3 * run.step_seconds[0], "tok_s": tok_s,
            "peak_bytes": peak, "wall_s": wall,
            "launches": launches["flash_attention_bhsd"],
            "backward_calls": bwd}


class _Killed(Exception):
    """The train loop's stand-in for a killed process."""


def train_resume_check():
    """Kill and resume through the launcher at --reduced on the card: a
    run of TRAIN_RESUME_STEPS steps with a checkpoint every
    TRAIN_CKPT_EVERY, killed when it asks for step 11's batch, leaves
    step 10 committed; the rerun with --resume auto restores step 10,
    runs steps 10-11 and exits 0.  The checkpoints go into a temporary
    directory the phase removes."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train as TR

    base = TR.SyntheticLMData

    class Dying(base):
        def batch_at(self, step, **kw):
            if step == 11:
                raise _Killed
            return super().batch_at(step, **kw)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        args = ["--arch", TRAIN_ARCH, "--reduced", "--steps",
                str(TRAIN_RESUME_STEPS), "--seq-len", "32", "--batch", "4",
                "--ckpt-dir", tmp, "--ckpt-every", str(TRAIN_CKPT_EVERY),
                "--log-every", "50"]
        TR.SyntheticLMData = Dying
        try:
            TR.train(args)
        except _Killed:
            pass
        else:
            raise AssertionError("train resume: the run was not killed")
        finally:
            TR.SyntheticLMData = base
        committed = latest_step(tmp)
        run = TR.train(args + ["--resume", "auto"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"train resume: killed at step 11 with step {committed} "
          f"committed; the resumed run started at data step "
          f"{run.start_step}, exit code {run.rc}, losses {run.losses}")
    if committed != 10 or run.start_step != 10 or run.rc != 0 or len(
            run.losses) != 2 or not all(math.isfinite(x)
                                        for x in run.losses):
        raise AssertionError("train resume: want step 10 restored, two "
                             "finite losses and exit code 0")
    return {"restored_step": run.start_step, "losses": run.losses}


def train_phase(flush):
    """The training path: the kernel rows at the training shape, the
    model-level check at reduced size, the CLI at full width and depth,
    and the reduced kill and resume."""
    err, rows = train_flash_rows(flush)
    model = train_model_check()
    cli = train_cli_run()
    resume = train_resume_check()
    return {"max_abs_err": err, "rows": rows, "model": model, "cli": cli,
            "resume": resume}


# ---------------------------------------------------------------------------
# the paper's six apps (MLP0/1, LSTM0/1, CNN0/1 at Table 1 size)
# ---------------------------------------------------------------------------

PAPER_APPS = ("MLP0", "MLP1", "LSTM0", "LSTM1", "CNN0", "CNN1")
# every distinct FC shape of the six apps at its app's Table 1 batch:
# (label, K, N, M, activation, launches a forward); MLP1 (K and N), LSTM0
# (K) and CNN1 (K) are widths the kernels take only padded
PAPER_SHAPES = (("MLP0", 2000, 2000, 200, "relu", 5),
                ("MLP1", 1118, 1118, 168, "relu", 4),
                ("LSTM0", 2084, 4168, 64, "none", 48),
                ("LSTM1", 1376, 2752, 96, "none", 72),
                ("CNN1 fc0", 3700, 3700, 32, "relu", 1),
                ("CNN1 fc1", 3700, 7400, 32, "relu", 1),
                ("CNN1 fc2", 7400, 3700, 32, "relu", 1),
                ("CNN1 fc3", 3700, 1000, 32, "none", 1))
PAPER_BATCH = 2            # rows of the apps' card-against-CPU forwards
# card against CPU, relative L2 over an app's output: W8A16 adds the same
# f32 products in other orders (the GEMV's split of K, cuDNN's f32 conv
# algorithms, 72 deep in CNN1); W8A8 also requantizes every FC's input
# with one scale a tensor, where a last-bit difference can move an int8
# step (1/127 of the tensor's largest magnitude)
PAPER_W8A16_RTOL = 1e-3
PAPER_W8A8_RTOL = 1e-2
PAPER_REQUESTS = 150       # the serve twin's default trace
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores


def paper_qmatmul_rows(flush):
    """Every distinct FC shape of the six apps at its app's batch, each
    weight quantized and stored padded as the apps store it: through
    ``ops.qmatmul`` on the GEMV (f32 x, the apps' path) and the mma path
    (x cast to bf16), and ``ops.qmatmul_dynamic`` (W8A8), each against
    its plain version on the card on the unpadded operands (f32 out:
    bf16_close's 1e-5; W8A8 also by w8a8_check on the padded operands,
    its int32 sums bitwise).  Each kernel timed on the padded operands
    (the call adds x's pad and the output's slice), beside its plain
    version, its bound (the logical shape's bytes, or its operations
    over f32's peak for the GEMV's f32 products, bf16's for mma, int8's
    for W8A8) and a library call (``F.linear`` on f32- or bf16-dequantized
    weights; ``torch._int_mm`` + drain where the build takes the shape).
    Returns (worst W8A16 error, worst W8A8 error, {label: rows}, {app:
    W8A16 GEMV ms of one Table 1 batch's forward's FCs})."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.quant import quantize, quantize_weight
    from repro_torch.kernels import ops
    from repro_torch.kernels import qmatmul as K

    gen = torch.Generator(device="cuda").manual_seed(SEED + 37)
    rows, worst16, worst8 = {}, 0.0, 0.0
    f32 = torch.float32
    for label, k, n, m, act, count in PAPER_SHAPES:
        q = quantize_weight(torch.randn((k, n), generator=gen,
                                        device="cuda") * k ** -0.5)
        u = q.unpadded()
        kp, np_ = q.values.shape
        if (kp % 16, np_ % 4, tuple(q.shape)) != (0, 0, (k, n)):
            raise AssertionError(f"paper {label}: stored {kp} x {np_}")
        b = torch.randn(n, generator=gen, device="cuda") * 0.1
        bp = F.pad(b, (0, np_ - n))
        ws = q.scale.reshape(-1)
        x = torch.randn((m, k), generator=gen, device="cuda")
        kw = dict(activation=act, out_dtype=f32)
        row = {"K": k, "N": n, "M": m, "stored": [kp, np_],
               "activation": act, "launches_a_forward": count}
        for path, xd in (("gemv", x), ("mma", x.to(torch.bfloat16))):
            out = ops.qmatmul(xd, q, b, path=path, **kw)
            # the check's plain call is the row's plain time
            ref, plain = timed_call(lambda: K.qmatmul_w8a16_ref(
                xd, u.values, u.scale, b, **kw), flush)
            if out.shape != (m, n) or not torch.isfinite(out).all():
                raise AssertionError(f"paper {label} ({path}): bad output")
            err, ratio = bf16_close(out, ref, f32_out=True)
            if ratio > 1.0:
                raise AssertionError(
                    f"paper {label} ({path}): kernel disagrees with its "
                    f"plain version beyond tolerance (err/tol={ratio:.3f})")
            worst16 = max(worst16, err)
            xp = F.pad(xd, (0, kp - k))
            ms = time_ms(lambda: K.qmatmul_w8a16_on_path(
                path, xp, q.values, ws, bp, **kw), TIMED_ITERS, flush)
            w_lib = u.dequantize(xd.dtype).t()
            lib = time_ms(lambda: F.linear(xd, w_lib, b.to(xd.dtype)),
                          TIMED_ITERS, flush)
            del w_lib
            nbytes = (x.numel() * xd.element_size() + k * n + 8 * n
                      + 4 * m * n)
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * m * k * n / (F32_OPS_PER_S if path == "gemv"
                                      else BF16_OPS_PER_S) * 1e3
            row[path] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                         "bound_ms": max(bytes_ms, ops_ms),
                         "bound_by": ("bytes" if bytes_ms >= ops_ms
                                      else "operations"),
                         "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                         "max_abs_err": err, "err_tol": ratio}
        xq = quantize(x, bits=8, axis=None)
        xqp = F.pad(xq.values, (0, kp - k))
        xs = xq.scale.reshape(())
        out = ops.qmatmul_dynamic(x, q, b, **kw)
        ref, plain = timed_call(lambda: K.qmatmul_w8a8_ref(
            xq.values, u.values, xs, u.scale, b, **kw), flush)
        err8, ratio8 = bf16_close(out, ref, f32_out=True)
        if out.shape != (m, n) or ratio8 > 1.0:
            raise AssertionError(f"paper {label} (w8a8): kernel disagrees "
                                 f"with its plain version (err/tol="
                                 f"{ratio8:.3f})")
        _, _, drain_bitwise = w8a8_check(f"paper {label}", xqp, q.values, xs,
                                         ws, bp, act)
        worst8 = max(worst8, err8)
        ms = time_ms(lambda: K.qmatmul_w8a8(xqp, q.values, xs, ws, bp, **kw),
                     TIMED_ITERS, flush)

        def int_mm():
            return K.activate((torch._int_mm(xqp, q.values).float() * xs
                               * ws + bp), act)

        try:
            int_mm()
            lib_fn, lib_name = int_mm, "torch._int_mm + drain"
        except RuntimeError:
            w_lib = u.dequantize(torch.bfloat16).t()
            lib_fn = lambda: F.linear(  # noqa: E731
                (xq.values.to(torch.bfloat16) * xs.to(torch.bfloat16)),
                w_lib, b.to(torch.bfloat16))
            lib_name = "F.linear, bf16 weights"
        lib = time_ms(lib_fn, TIMED_ITERS, flush)
        bytes_ms = (m * k + k * n + 4 + 8 * n + 4 * m * n) \
            / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * m * k * n / INT8_OPS_PER_S * 1e3
        row["w8a8"] = {"ms": ms, "plain_ms": plain, "library_ms": lib,
                       "library": lib_name, "path": K.w8a8_path(m),
                       "bound_ms": max(bytes_ms, ops_ms),
                       "bound_by": ("bytes" if bytes_ms >= ops_ms
                                    else "operations"),
                       "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                       "max_abs_err": err8, "err_tol": ratio8,
                       "drain_bitwise": drain_bitwise}
        rows[label] = row
        print(f"  paper {label:8s} M={m:3d} K={k:4d} N={n:4d} stored "
              f"{kp} x {np_}: "
              + "; ".join(f"{p} ms={row[p]['ms']:.4f} plain_ms="
                          f"{row[p]['plain_ms']:.3f} library_ms="
                          f"{row[p]['library_ms']:.4f} bound_ms="
                          f"{row[p]['bound_ms']:.4f} ({row[p]['bound_by']})"
                          f" err/tol={row[p]['err_tol']:.3f}"
                          for p in ("gemv", "mma", "w8a8"))
              + f" (w8a8 {row['w8a8']['path']}, library {lib_name})")
        del q, u, x, xq, xqp
    per_app = {}
    for label, *_, count in PAPER_SHAPES:
        app = label.split()[0]
        per_app[app] = per_app.get(app, 0.0) + count * rows[label]["gemv"][
            "ms"]
    print(f"  paper: W8A16 GEMV ms of one Table 1 batch's FCs a forward: "
          + ", ".join(f"{a} {v:.3f}" for a, v in per_app.items()))
    zero_counts()
    return worst16, worst8, rows, per_app


def paper_fcs(cfg) -> int:
    """The int8 FC launches of one forward of a paper app."""
    return {"mlp": len(cfg.widths), "lstm": 8 * cfg.n_cells,
            "cnn": len(cfg.fc_tail)}[cfg.kind]


def tree_cpu(node):
    """A param tree (dicts, lists, QTensors with their padding) copied to
    the CPU."""
    import dataclasses

    import torch
    from repro_torch.core.quant import QTensor
    if isinstance(node, dict):
        return {k: tree_cpu(v) for k, v in node.items()}
    if isinstance(node, list):
        return [tree_cpu(v) for v in node]
    if isinstance(node, QTensor):
        return dataclasses.replace(node, values=node.values.cpu(),
                                   scale=node.scale.cpu())
    assert isinstance(node, torch.Tensor)
    return node.cpu()


def paper_app_check(name) -> dict:
    """One app at Table 1 size, built as the serve twin builds it (seed 0,
    quantized at ``min_size=1024``, every 2-D weight stored padded): its
    W8A16 and W8A8 forwards of PAPER_BATCH rows on the card, eager and
    captured (the replays bitwise the eager forward), against the same
    forward on the CPU (the plain versions) on the same weights, within
    PAPER_W8A16_RTOL / PAPER_W8A8_RTOL relative L2."""
    import torch
    from repro_torch.core.qlinear import W8A8, W8A16
    from repro_torch.examples import serve_quantized as S
    from repro_torch.models import paper_nets as PN

    t0 = time.perf_counter()
    cfg, params, _ = S.build(name, "cuda")
    cpu = tree_cpu(params)
    x = PN.app_input(cfg, PAPER_BATCH, device="cuda")
    out = {"weights": PN.weight_count(params)}
    for label, mode, tol in (("w8a16", W8A16, PAPER_W8A16_RTOL),
                             ("w8a8", W8A8, PAPER_W8A8_RTOL)):
        with torch.inference_mode():
            eager = PN.apply_app(params, cfg, x, mode=mode).clone()
            fwd = S.make_forward(cfg, mode)
            first = fwd(params, x).clone()
            second = fwd(params, x).clone()
            torch.cuda.synchronize()
            fwd.captured.release()
            want = PN.apply_app(cpu, cfg, x.cpu(), mode=mode)
        got = eager.cpu()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise AssertionError(f"paper {name} {label}: bad output "
                                 f"{tuple(got.shape)}")
        if not (torch.equal(first, eager) and torch.equal(second, eager)):
            raise AssertionError(f"paper {name} {label}: the captured "
                                 f"forward differs from the eager one")
        rel = float((got - want).norm() / want.norm())
        if not rel <= tol:
            raise AssertionError(f"paper {name} {label}: card against CPU "
                                 f"{rel:.3e} relative L2 (limit {tol})")
        out[label] = rel
    del params, cpu
    torch_cuda_empty()
    print(f"paper {name}: {out['weights']:,} weights, W8A16 and W8A8 "
          f"forwards of {PAPER_BATCH} rows on the card against the CPU: "
          f"{out['w8a16']:.3e} / {out['w8a8']:.3e} relative L2 (limits "
          f"{PAPER_W8A16_RTOL} / {PAPER_W8A8_RTOL}); captured bitwise eager "
          f"(two replays each); {time.perf_counter() - t0:.1f}s")
    return out


def paper_serve_run():
    """``python -m repro_torch.examples.serve_quantized`` over the six
    apps, in this process so that the counts are read around it (and each
    app's numbers recorded from ``serve``): exit 0, a line per app, a
    chosen batch of at least 1, every int8 FC on the W8A16 GEMV (no mma, no W8A8, no plain version),
    its launches a whole number of forwards."""
    from repro_torch.configs.paper_apps import PAPER_APP_CONFIGS
    from repro_torch.examples import serve_quantized as S

    argv = ["--apps", ",".join(PAPER_APPS), "--n-requests",
            str(PAPER_REQUESTS)]
    print(f"paper: python -m repro_torch.examples.serve_quantized "
          f"{' '.join(argv)}")
    real, results = S.serve, {}

    def recorded(cfg, *a, **kw):
        results[cfg.name] = r = real(cfg, *a, **kw)
        return r

    S.serve = recorded
    zero_counts()
    try:
        t0 = time.perf_counter()
        rc = S.main(argv)
        wall = time.perf_counter() - t0
    finally:
        S.serve = real
    launches, plain = read_counts()
    fcs = sum(paper_fcs(PAPER_APP_CONFIGS[a]) for a in PAPER_APPS)
    print(f"paper: serve twin exit code {rc} in {wall:.1f}s; launches "
          f"{ {k: v for k, v in launches.items() if v} }, plain calls "
          f"{plain}")
    if rc != 0 or list(results) != list(PAPER_APPS):
        raise AssertionError(f"paper: the serve twin gave {rc}, apps "
                             f"{list(results)}")
    if (launches["qmatmul_w8a16[gemv]"] <= 0
            or launches["qmatmul_w8a16[gemv]"] % fcs
            or launches["qmatmul_w8a16[mma]"] or launches["qmatmul_w8a8"]
            or any(plain.values())):
        raise AssertionError(f"paper: the serve twin's launches {launches} "
                             f"({fcs} FCs a forward of each app), plain "
                             f"{plain}")
    for name, r in results.items():
        print(f"paper {name}: Table 4 row on this card: curve "
              + ", ".join(f"b={b} {1e3 * t:.4f} ms" for b, t in
                          r["curve"].items())
              + f"; batch {r['batch']} (paper {r['paper_batch']}), p99 "
              f"{1e3 * r['p99']:.3f} ms (deadline "
              f"{1e3 * r['deadline']:.1f} ms), {r['rps']:.1f} req/s, "
              f"deadlines met {r['met']:.0%}")
        if r["batch"] < 1 or not 0.0 <= r["met"] <= 1.0:
            raise AssertionError(f"paper {name}: {r}")
    return {"rc": rc, "wall_s": wall, "launches": launches,
            "apps": {name: {"curve_ms": {str(b): 1e3 * t
                                         for b, t in r["curve"].items()},
                            "batch": r["batch"], "p99_ms": 1e3 * r["p99"],
                            "deadline_ms": 1e3 * r["deadline"],
                            "rps": r["rps"], "met": r["met"]}
                     for name, r in results.items()}}


def paper_quickstart_run():
    """``python -m repro_torch.examples.quickstart`` on the card, in this
    process: exit 0, with the reduced model's W8A16 forward on the mma
    path."""
    from repro_torch.examples import quickstart as Q

    zero_counts()
    t0 = time.perf_counter()
    rc = Q.main([])
    launches, plain = read_counts()
    print(f"paper: quickstart twin exit code {rc} in "
          f"{time.perf_counter() - t0:.1f}s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    if rc != 0 or launches["qmatmul_w8a16[mma]"] <= 0 or any(plain.values()):
        raise AssertionError(f"paper: quickstart exit code {rc}, launches "
                             f"{launches}, plain {plain}")
    return {"rc": rc, "launches": launches}


def paper_phase(flush):
    """The paper's six apps: the kernel rows at every FC shape, each app
    on the card against the CPU and captured against eager (the W8A16
    and W8A8 launches of those forwards counted), the serve twin over the
    six, the quickstart twin."""
    from repro_torch.configs.paper_apps import PAPER_APP_CONFIGS

    err16, err8, rows, per_app = paper_qmatmul_rows(flush)
    zero_counts()
    checks = {name: paper_app_check(name) for name in PAPER_APPS}
    launches, plain = read_counts()
    fcs = sum(paper_fcs(PAPER_APP_CONFIGS[a]) for a in PAPER_APPS)
    print(f"paper: the apps' forwards on the card launched "
          f"{ {k: v for k, v in launches.items() if v} }; the plain "
          f"versions ran {plain['qmatmul_w8a16_ref']} / "
          f"{plain['qmatmul_w8a8_ref']} times (W8A16 / W8A8) in their CPU "
          f"forwards ({fcs} FCs a forward of the six)")
    # each mode: the eager forward, the capture's warm-up and two replays
    # on the card, one forward on the CPU
    if (launches["qmatmul_w8a16[gemv]"] != 4 * fcs
            or launches["qmatmul_w8a8"] != 4 * fcs
            or launches["qmatmul_w8a16[mma]"]
            or plain["qmatmul_w8a16_ref"] != fcs
            or plain["qmatmul_w8a8_ref"] != fcs):
        raise AssertionError(f"paper: the apps' launches {launches}, plain "
                             f"calls {plain} ({fcs} FCs a forward of the "
                             f"six)")
    serve = paper_serve_run()
    quick = paper_quickstart_run()
    return {"w8a16_err": err16, "w8a8_err": err8, "rows": rows,
            "per_app_gemv_ms": per_app, "checks": checks,
            "check_launches": launches, "serve": serve,
            "quickstart": quick}


PHASES = ("attention", "long_tick", "w8a8", "graphs", "dense", "sampling",
          "spec", "multiplex", "sharded", "moe", "encdec", "ssm", "hybrid", "mixtral",
          "vlm", "train", "paper")


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
                         "qwen2-moe-a2.7b's speculative serve), "
                         "the MoE family (qwen2-moe-a2.7b's kernel rows, "
                         "serves, chunk pass, tick and CLI), or the encdec "
                         "family (whisper-medium's kernel rows, serves, "
                         "prime, tick and CLI), the ssm family "
                         "(mamba2-1.3b's kernel rows, serves, overload, "
                         "tick, chunk and CLI), or the hybrid family "
                         "(recurrentgemma-9b's flash rows at head_dim "
                         "256, matmul rows, serves, overload, ring tick, "
                         "chunk and CLI), or mixtral-8x22b at full width "
                         "and 8 of 56 layers (kernel rows, serves on the "
                         "int8 and bf16 rings, ring tick, wrapped chunk, "
                         "the launcher's curve and decode loop), or "
                         "llama-3.2-vision-90b at full width and 10 of 100 "
                         "layers (kernel rows, serves contiguous and paged, "
                         "prime, tick, the launcher's curve and decode "
                         "loop), or multiplexing (starcoder2-3b and "
                         "qwen2-moe-a2.7b as lanes of one engine: greedy, "
                         "sampled, hot-swap, the replica router, the CLI "
                         "with --models and --replicas), or scale-out (tp 2 "
                         "and 4 shards on the card against a control, "
                         "paged, speculating, the CLI with --tp), or "
                         "training (flash's forward and gradient at the "
                         "training shape, the reduced model against the "
                         "CPU, the train CLI at full starcoder2-3b width "
                         "and depth, the reduced kill and resume), or the "
                         "paper's six apps (the int8 kernels at every FC "
                         "shape, each app on the card against the CPU and "
                         "captured, the serve and quickstart twins); "
                         "prints no result line")
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
        if {"long_tick", "w8a8", "graphs", "sampling", "spec",
                "multiplex", "sharded"} & set(args.only):
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
        if "multiplex" in args.only:
            multiplex_phase(cfg, params)
        if "sharded" in args.only:
            sharded_phase(cfg, params)
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
        if {"moe", "encdec", "ssm", "hybrid", "mixtral", "vlm"} & set(
                args.only):             # last, as in the whole run
            from repro_torch.runtime import steps as ST
            ST.clear_step_cache()       # starcoder's graphs and weights go
            params = None               # first, as in the whole run
            torch_cuda_empty()
        if "moe" in args.only:
            moe_phase(flush)
        if "encdec" in args.only:
            ST.clear_step_cache()
            torch_cuda_empty()
            encdec_phase(flush, profile_serves=True)
        if "ssm" in args.only:
            ST.clear_step_cache()
            torch_cuda_empty()
            ssm_phase(flush)
        if "hybrid" in args.only:
            ST.clear_step_cache()
            torch_cuda_empty()
            hybrid_phase(flush)
        if "mixtral" in args.only:
            ST.clear_step_cache()
            torch_cuda_empty()
            mixtral_phase(flush)
        if "vlm" in args.only:
            ST.clear_step_cache()
            torch_cuda_empty()
            vlm_phase(flush, profile_serves=True)
        if "train" in args.only:            # last, as in the whole run
            from repro_torch.runtime import steps as ST
            ST.clear_step_cache()
            params = None
            torch_cuda_empty()
            train_phase(flush)
        if "paper" in args.only:            # after train, as in the whole run
            from repro_torch.runtime import steps as ST
            ST.clear_step_cache()
            params = None
            torch_cuda_empty()
            paper_phase(flush)
        del flush_buf
        print(f"chip_smoke: partial run passed in "
              f"{time.perf_counter() - t_run:.1f}s; no result line")
        return 0
    def timed(fn, *a):
        t = time.perf_counter()
        out = fn(*a)
        print(f"chip_smoke: {fn.__name__} {time.perf_counter() - t:.1f}s "
              f"(run {time.perf_counter() - t_run:.1f}s)")
        return out

    print("kernels: each CUDA kernel against its plain version on the card")
    q_err, q_paths = timed(qmatmul_phase, flush)
    a_err, a_tick, a_long = timed(attention_phase, flush,
                                  max_seq + (-max_seq) % 16)
    p_err, p_tick, p_long = timed(paged_attention_phase, flush)
    w8_err, w8_fwd, w8_lib, w8_ticks = timed(qmatmul_w8a8_phase, flush)
    f_err, f_fwd = timed(flash_phase, flush)
    dense_rows = timed(dense_kernel_rows, flush)
    timed(rmsnorm_phase)

    # the tick watchdog flags chunked-prefill ticks as stragglers; they
    # are counted in the report (stuck_ticks) rather than printed
    warnings.filterwarnings("ignore", message=".*straggler.*")
    cfg, params = timed(build_model)
    launches = timed(slice_phase, cfg, params)
    paged_launches = timed(paged_slice_phase, cfg, params)
    timed(overload_phase, cfg, params)
    timed(long_tick_phase, cfg, params)
    timed(w8a8_tick_phase, cfg, params)
    timed(graph_phase, cfg, params)
    timed(sampling_phase, cfg, params)
    spec = timed(spec_phase, cfg, params)
    mux = timed(multiplex_phase, cfg, params)
    shard = timed(sharded_phase, cfg, params)
    from repro_torch.runtime import steps as ST
    ST.clear_step_cache()           # the engines' captured tick and cache
    del params
    torch_cuda_empty()
    timed(sampled_dense_phase)
    serve_launches = timed(serve_phase)
    dense = timed(dense_phase)
    moe = timed(moe_phase, flush)
    ST.clear_step_cache()
    torch_cuda_empty()
    enc = timed(encdec_phase, flush)
    ST.clear_step_cache()
    torch_cuda_empty()
    ssm = timed(ssm_phase, flush)
    ST.clear_step_cache()
    torch_cuda_empty()
    hyb = timed(hybrid_phase, flush)
    ST.clear_step_cache()
    torch_cuda_empty()
    mix = timed(mixtral_phase, flush)
    ST.clear_step_cache()
    torch_cuda_empty()
    vlm = timed(vlm_phase, flush)
    ST.clear_step_cache()
    torch_cuda_empty()
    train = timed(train_phase, flush)
    ST.clear_step_cache()
    torch_cuda_empty()
    paper = timed(paper_phase, flush)
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
    def layer_sum(by_name, extra=()):
        stacks = [by_name[name] for name in ("w_gate", "w_up", "w_down")]
        sums = {key: sum(t[key] for t in stacks)
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")
                + tuple(extra)}
        return {**sums, "bound_by": (
            "bytes" if all(t["bound_by"] == "bytes" for t in stacks)
            else "operations")}

    fwd_m = moe_curve_rows()[-1]
    live = moe["rows"]["w_gate"]["live_experts"]
    kernels[0]["experts"] = {
        **layer_sum(moe["rows"], ("all_live_ms", "every_expert_bound_ms")),
        "max_abs_err": moe["max_abs_err"], "live_experts": live,
        "launches": moe["launches"]["qmatmul_w8a16_experts"],
        "launches_by_path": {
            "gemv": moe["launches"]["qmatmul_w8a16_experts[gemv]"],
            "mma": moe["cli"]["curve_experts_mma"]},
        "shapes": moe["rows"],
        "forward": {**layer_sum(moe["forward_rows"], ("gemv_ms",)),
                    "entry": "qmatmul_w8a16_experts_mma",
                    "launches": moe["cli"]["curve_experts_mma"],
                    "shapes": moe["forward_rows"],
                    "basis": f"one MoE layer's three stacked launches on "
                             f"the tensor-core entry at {fwd_m} rows an "
                             f"expert (the serve CLI curve's "
                             f"{SERVE_MAX_BATCH} x {SERVE_SEQ}-token "
                             f"forward), summed; gemv_ms: the GEMV entry "
                             f"at the same rows; launches: the CLI run's "
                             f"service curve"},
        "basis": f"one MoE layer's three stacked GEMV launches over "
                 f"{MOE_ARCH}'s 60 experts x {NUM_SLOTS} rows (a tick) "
                 f"under the live mask of a tick's routing ({live} experts "
                 f"live), summed; all_live_ms: the same launches without "
                 f"the mask; bound_ms: the live experts' bytes, "
                 f"every_expert_bound_ms: every expert's; library torch.bmm "
                 f"on bf16-dequantized experts; launches: the contiguous "
                 f"bf16 serve (launches_by_path: its GEMV stacks, the CLI "
                 f"curve's mma stacks)"}
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
    # the encdec family: both kernels at whisper-medium's shapes, and
    # their launches in its serves (each request primed: the encoder's
    # flash attention and mma projections) and its CLI run
    enc_serve = enc["launches"]
    kernels[0]["encdec"] = {
        "rows": enc["qmatmul_rows"], "max_abs_err": enc["qmatmul_err"],
        "launches": enc_serve["qmatmul_w8a16"],
        "launches_by_path": {"gemv": enc_serve["qmatmul_w8a16[gemv]"],
                             "mma": enc_serve["qmatmul_w8a16[mma]"]},
        "paged_launches": enc["paged_launches"]["qmatmul_w8a16"],
        "cli_launches": enc["cli"]["qmatmul_w8a16"],
        "prime": enc["prime"], "tick": enc["tick"],
        "serves": enc["serves"],
        "basis": f"one launch at each {ENC_ARCH} shape (M = 1,500: a "
                 f"prime's encoder and cross k/v on the mma path; M = "
                 f"{SERVE_MAX_BATCH * 1500} and {SERVE_ROWS}: the CLI "
                 f"curve's b = {SERVE_MAX_BATCH} encoder and decoder on the "
                 f"mma path; M = {NUM_SLOTS}: a tick's GEMV; the LM head "
                 f"padded from 51,865 to 51,868 columns); serves: ticks, "
                 f"wall and tok/s, contiguous, paged and paged on a full "
                 f"pool (a profiled serve's device busy in --only encdec "
                 f"only); launches: "
                 f"the contiguous "
                 f"serve of {DENSE_REQUESTS} primed requests (by path: the "
                 f"ticks' and chunks' GEMV, the primes' mma), the paged "
                 f"serve and the serve CLI's run; prime and tick: the "
                 f"captured steps' wall, busy and split, in ms"}
    kernels[4]["encdec"] = {
        "rows": enc["flash_rows"], "max_abs_err": enc["flash_err"],
        "launches": enc_serve["flash_attention_bhsd"],
        "paged_launches": enc["paged_launches"]["flash_attention_bhsd"],
        "cli_launches": enc["cli"]["flash_attention_bhsd"],
        "basis": f"one launch at each {ENC_ARCH} shape, hd 64, at a "
                 f"prime's BH = 16 and the CLI curve's BH = 256: the "
                 f"encoder over 1,500 frames and the curve's "
                 f"cross-attention (Sq {SERVE_SEQ} against Skv 1,500), not "
                 f"causal, and its decoder's self-attention over "
                 f"{SERVE_SEQ} tokens, causal; library SDPA; "
                 f"launches: the contiguous serve's primes, the paged "
                 f"serve's and the serve CLI's run"}
    # the ssm family: both matmul kernels at mamba2-1.3b's shapes, and
    # their launches in its serves (the GEMV) and CLI runs (the curve's
    # mma path; every projection on qmatmul_w8a8 under --quant w8a8)
    ssm_tick_t = ssm["per_m"][NUM_SLOTS]
    kernels[0]["ssm"] = {
        **numbers(ssm_tick_t), "rows": ssm["qmatmul_rows"],
        "max_abs_err": ssm["qmatmul_err"],
        "forward": {**numbers(ssm["per_m"][SERVE_ROWS]),
                    "basis": f"one {SSM_ARCH} forward of {SERVE_MAX_BATCH} "
                             f"x {SERVE_SEQ} tokens on the mma path: 48 x "
                             f"(in_proj, out_proj) and the head, summed"},
        "launches": ssm["launches"]["qmatmul_w8a16"],
        "launches_by_path": {"gemv": ssm["launches"]["qmatmul_w8a16[gemv]"],
                             "mma": ssm["cli"]["w8a16"]["curve_mma"]},
        "cli_launches": ssm["cli"]["w8a16"]["qmatmul_w8a16"],
        "tick": ssm["tick"], "chunk": ssm["chunk"],
        "serves": ssm["serves"], "overload": ssm["overload"],
        "basis": f"one {SSM_ARCH} tick of {NUM_SLOTS} rows on the GEMV: "
                 f"48 x (in_proj K 2,048 x N 8,512, out_proj K 4,096 x N "
                 f"2,048) and the head (N 50,280), summed; rows: each "
                 f"shape at M = {NUM_SLOTS} (GEMV) and {SERVE_ROWS} (mma); "
                 f"launches: the contiguous greedy serve of "
                 f"{DENSE_REQUESTS} requests (by path: its GEMVs, the CLI "
                 f"curve's mma), the w8a16 CLI run; tick and chunk: the "
                 f"captured steps' wall, busy and floor, in ms"}
    w8_ssm = ssm["w8a8_rows"]
    kernels[3]["ssm"] = {
        "rows": w8_ssm, "max_abs_err": ssm["w8a8_err"],
        "launches": ssm["cli"]["w8a8"]["qmatmul_w8a8"],
        "basis": f"one launch at each {SSM_ARCH} projection, M = "
                 f"{NUM_SLOTS} (the GEMV) and {SERVE_ROWS} (mma.sync); "
                 f"launches: the serve CLI's --quant w8a8 run"}
    if min(kernels[0]["ssm"]["launches"], kernels[0]["ssm"]["cli_launches"],
           *kernels[0]["ssm"]["launches_by_path"].values(),
           kernels[3]["ssm"]["launches"]) <= 0:
        return fail("a kernel of the ssm path never launched")
    if any(not math.isfinite(t[key]) for t in (
            *ssm["qmatmul_rows"].values(), *w8_ssm.values(),
            ssm_tick_t, ssm["per_m"][SERVE_ROWS])
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")):
        return fail("an ssm kernel row is not finite")
    # the hybrid family: flash attention at head_dim 256 and both matmul
    # kernels at recurrentgemma-9b's shapes, their launches in its serves
    # (the GEMV) and CLI runs (the curve's flash and mma path; every
    # projection but the RG-LRU gates on qmatmul_w8a8 under --quant w8a8)
    hyb_tick_t = hyb["per_m"][NUM_SLOTS]
    kernels[0]["hybrid"] = {
        **numbers(hyb_tick_t), "rows": hyb["qmatmul_rows"],
        "max_abs_err": hyb["qmatmul_err"],
        "forward": {**numbers(hyb["per_m"][SERVE_ROWS]),
                    "basis": f"one {HYB_ARCH} forward of {SERVE_MAX_BATCH} "
                             f"x {SERVE_SEQ} tokens on the mma path: every "
                             f"projection, the RG-LRU gates and the head, "
                             f"summed"},
        "launches": hyb["launches"]["qmatmul_w8a16"],
        "launches_by_path": {"gemv": hyb["launches"]["qmatmul_w8a16[gemv]"],
                             "mma": hyb["cli"]["w8a16"]["curve_mma"]},
        "cli_launches": hyb["cli"]["w8a16"]["qmatmul_w8a16"],
        "tick": hyb["tick"], "chunk": hyb["chunk"],
        "serves": hyb["serves"], "overload": hyb["overload"],
        "basis": f"one {HYB_ARCH} tick of {NUM_SLOTS} rows on the GEMV: "
                 f"{', '.join(f'{c} x {n} (K {k:,} x N {m:,})' for n, k, m, c in HYB_SHAPES)} "
                 f"and the head (N 256,000), summed; rows: each shape at M "
                 f"= {NUM_SLOTS} (GEMV) and {SERVE_ROWS} (mma); launches: "
                 f"the contiguous greedy serve of {DENSE_REQUESTS} requests "
                 f"(by path: its GEMVs, the CLI curve's mma), the w8a16 CLI "
                 f"run; tick (the ring tick at {HYB_RING_SEQ} positions) and "
                 f"chunk: the captured steps' wall, busy and floor, in ms"}
    kernels[3]["hybrid"] = {
        "rows": hyb["w8a8_rows"], "max_abs_err": hyb["w8a8_err"],
        "launches": hyb["cli"]["w8a8"]["qmatmul_w8a8"],
        "basis": f"one launch at each {HYB_ARCH} projection, M = "
                 f"{NUM_SLOTS} (the GEMV) and {SERVE_ROWS} (mma.sync); "
                 f"launches: the serve CLI's --quant w8a8 run"}
    kernels[4]["hybrid"] = {
        "rows": hyb["flash_rows"], "max_abs_err": hyb["flash_err"],
        "launches": sum(hyb["cli"][q]["flash_attention_bhsd"]
                        for q in ("w8a16", "w8a8")),
        "basis": f"one launch at each {HYB_ARCH} shape, head_dim 256 (the "
                 f"kernel's HD = 256 instance), causal, window 2,048: the "
                 f"CLI curve's BH = 16 x b at S = {SERVE_SEQ} and BH = 16 at "
                 f"S = 4,096 (the window bites); library SDPA (a boolean "
                 f"mask at S = 4,096); launches: the serve CLI's w8a16 and "
                 f"w8a8 runs"}
    if min(kernels[0]["hybrid"]["launches"],
           kernels[0]["hybrid"]["cli_launches"],
           *kernels[0]["hybrid"]["launches_by_path"].values(),
           kernels[3]["hybrid"]["launches"],
           kernels[4]["hybrid"]["launches"]) <= 0:
        return fail("a kernel of the hybrid path never launched")
    if any(not math.isfinite(t[key]) for t in (
            *hyb["qmatmul_rows"].values(), *hyb["w8a8_rows"].values(),
            *hyb["flash_rows"].values(), hyb_tick_t,
            hyb["per_m"][SERVE_ROWS])
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")):
        return fail("a hybrid kernel row is not finite")
    # mixtral-8x22b (full width, 8 of 56 layers): every kernel at its
    # shapes, their launches in its serves (the GEMV, the experts' GEMV,
    # the int8 ring's decode attention and the chunks' one-entry-table
    # reads) and in the launcher's curves and decode loops
    mix_basis = f"{MIX_ARCH} at full width, {MIX_LAYERS} of 56 layers"
    mix_serve = mix["serves"]["int8"]["launches"]
    mix_l = mix["launcher"]
    kernels[0]["mixtral"] = {
        **numbers(mix["per_m"][NUM_SLOTS]), "rows": mix["qmatmul_rows"],
        "max_abs_err": max(mix["qmatmul_err"], mix["experts_err"]),
        "forward": {**numbers(mix["per_m"][SERVE_ROWS]),
                    "basis": f"one forward of {SERVE_MAX_BATCH} x "
                             f"{SERVE_SEQ} tokens on the mma path: "
                             f"{MIX_LAYERS} x (wq, wk, wv, wo) and the "
                             f"head, summed"},
        "experts": {**layer_sum(mix["expert_rows"],
                                ("all_live_ms", "every_expert_bound_ms")),
                    "live_experts": mix["expert_rows"]["w_gate"][
                        "live_experts"],
                    "shapes": mix["expert_rows"],
                    "forward": {**layer_sum(mix["expert_forward_rows"],
                                            ("gemv_ms",)),
                                "shapes": mix["expert_forward_rows"]},
                    "launches": mix_serve["qmatmul_w8a16_experts"]},
        "launches": mix_serve["qmatmul_w8a16"],
        "launches_by_path": {
            "gemv": mix_serve["qmatmul_w8a16[gemv]"],
            "mma": mix_l["w8a16"]["curve_launches"]["qmatmul_w8a16[mma]"]},
        "tick": {k: v for k, v in mix["tick"].items() if k != "launches"},
        "chunk": mix["chunk"],
        "serves": {k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                   for k, v in mix["serves"].items()},
        "launcher": {q: {k: v for k, v in r.items()
                         if k in ("curve_ms", "batch", "decode_tok_s")}
                     for q, r in mix_l.items()},
        "basis": f"one {MIX_ARCH} tick of {NUM_SLOTS} rows on the GEMV: "
                 f"{', '.join(f'{c} x {n} (K {k:,} x N {m:,})' for n, k, m, c in MIX_SHAPES)} "
                 f"and the head (N 32,768), summed ({mix_basis}); experts: "
                 f"one layer's three stacked launches over 8 experts at a "
                 f"tick's routed rows (GEMV) and the curve's b = "
                 f"{SERVE_MAX_BATCH} forward rows (mma), summed; launches: "
                 f"the int8-ring greedy serve of {DENSE_REQUESTS} requests "
                 f"(by path: its GEMVs, the launcher's w8a16 curve's mma); "
                 f"tick (the ring tick at positions {MIX_RING_POS[0]}-"
                 f"{MIX_RING_POS[-1]} of a 4,096-slot ring) and chunk: the "
                 f"captured steps' wall, busy and floor, in ms"}
    kernels[1]["mixtral"] = {
        **numbers(mix["attention"]), "max_abs_err": mix["attention_err"],
        "launches": mix_serve["decode_attention_int8"],
        "basis": f"one launch of {NUM_SLOTS} rows of a 4,096-slot int8 ring "
                 f"(KV 8, G 6, hd 128) at the ring tick's valid lengths; "
                 f"library SDPA on the dequantized ring; launches: the "
                 f"int8-ring greedy serve ({mix_basis})"}
    kernels[2]["mixtral"] = {
        **numbers(mix["paged_attention"]),
        "max_abs_err": mix["attention_err"],
        "launches": mix_serve["decode_attention_int8_paged"],
        "basis": f"the chunk step's read of the ring: one launch of "
                 f"{NUM_SLOTS} rows, each through a one-entry table over "
                 f"the contiguous 4,096-slot rows; launches: the int8-ring "
                 f"greedy serve's chunks ({mix_basis})"}
    kernels[3]["mixtral"] = {
        "rows": mix["w8a8_rows"], "max_abs_err": mix["w8a8_err"],
        "launches": (mix_l["w8a8"]["curve_launches"]["qmatmul_w8a8"]
                     + mix_l["w8a8"]["loop_launches"]["qmatmul_w8a8"]),
        "basis": f"one launch at each {MIX_ARCH} attention projection, M = "
                 f"{NUM_SLOTS} (the GEMV) and {SERVE_ROWS} (mma.sync); "
                 f"launches: the launcher's w8a8 curve and decode loop "
                 f"({mix_basis})"}
    kernels[4]["mixtral"] = {
        "rows": mix["flash_rows"], "max_abs_err": mix["flash_err"],
        "launches": sum(mix_l[q]["curve_launches"]["flash_attention_bhsd"]
                        for q in ("w8a16", "w8a8")),
        "basis": f"one launch at each {MIX_ARCH} shape, head_dim 128, "
                 f"causal, window 4,096: the curve's BH = 48 x b at S = "
                 f"{SERVE_SEQ} and BH = 6 at S = 8,192 (the window bites); "
                 f"library SDPA (a boolean mask at S = 8,192); launches: "
                 f"the launcher's w8a16 and w8a8 curves ({mix_basis})"}
    if min(kernels[0]["mixtral"]["launches"],
           kernels[0]["mixtral"]["experts"]["launches"],
           *kernels[0]["mixtral"]["launches_by_path"].values(),
           *(kernels[i]["mixtral"]["launches"] for i in range(1, 5))) <= 0:
        return fail("a kernel of the mixtral path never launched")
    if any(not math.isfinite(t[key]) for t in (
            *mix["qmatmul_rows"].values(), *mix["w8a8_rows"].values(),
            *mix["flash_rows"].values(), *mix["expert_rows"].values(),
            *mix["expert_forward_rows"].values(), mix["attention"],
            mix["paged_attention"], mix["per_m"][NUM_SLOTS],
            mix["per_m"][SERVE_ROWS])
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")):
        return fail("a mixtral kernel row is not finite")
    # llama-3.2-vision-90b (full width, 10 of 100 layers): qmatmul_w8a16
    # at its projections, head and prime, qmatmul_w8a8, and flash over the
    # curve's tokens and patches; their launches in its serves (the
    # ticks' and chunks' GEMV, the primes' mma) and the launcher's curves
    # and decode loops
    vlm_basis = f"{VLM_ARCH} at full width, {VLM_LAYERS} of 100 layers"
    vlm_l = vlm["launcher"]
    vlm_serve = vlm["launches"]
    kernels[0]["vlm"] = {
        **numbers(vlm["per_m"][NUM_SLOTS]), "rows": vlm["qmatmul_rows"],
        "prime": vlm["prime_row"], "max_abs_err": vlm["qmatmul_err"],
        "forward": {**numbers(vlm["per_m"][SERVE_ROWS]),
                    "basis": f"one forward of {SERVE_MAX_BATCH} x "
                             f"{SERVE_SEQ} tokens on the mma path: every "
                             f"projection of {VLM_LAYERS} layers and the "
                             f"head, summed (the cross k/v over the patches "
                             f"not counted)"},
        "launches": vlm_serve["qmatmul_w8a16"],
        "launches_by_path": {"gemv": vlm_serve["qmatmul_w8a16[gemv]"],
                             "mma": vlm_serve["qmatmul_w8a16[mma]"]},
        "paged_launches": vlm["paged_launches"]["qmatmul_w8a16"],
        "launcher_launches": {q: vlm_l[q]["curve_launches"]["qmatmul_w8a16"]
                              + vlm_l[q]["loop_launches"]["qmatmul_w8a16"]
                              for q in ("w8a16", "w8a8")},
        "prime_step": vlm["prime"], "tick": vlm["tick"],
        "serves": vlm["serves"], "slot_cross_bytes": vlm["slot_cross_bytes"],
        "launcher": {q: {k: v for k, v in r.items()
                         if k in ("curve_ms", "batch", "decode_tok_s")}
                     for q, r in vlm_l.items()},
        "basis": f"one {VLM_ARCH} tick of {NUM_SLOTS} rows on the GEMV: "
                 f"{', '.join(f'{c} x {n} (K {k:,} x N {m:,})' for n, k, m, c in VLM_SHAPES)} "
                 f"and the head (N 128,256), summed ({vlm_basis}); prime: "
                 f"one wk / wv launch on the mma path at the prime's 1,601 "
                 f"rows; launches: the contiguous serve of {DENSE_REQUESTS} "
                 f"primed requests (by path: the ticks' and chunks' GEMV, "
                 f"the primes' mma), the paged serve, the launcher's curves "
                 f"and decode loops; prime_step and tick: the captured "
                 f"steps' wall, busy, split and floor, in ms"}
    kernels[3]["vlm"] = {
        "rows": vlm["w8a8_rows"], "max_abs_err": vlm["w8a8_err"],
        "launches": (vlm_l["w8a8"]["curve_launches"]["qmatmul_w8a8"]
                     + vlm_l["w8a8"]["loop_launches"]["qmatmul_w8a8"]),
        "basis": f"one launch at each {VLM_ARCH} projection, M = "
                 f"{NUM_SLOTS} (the GEMV) and {SERVE_ROWS} (mma.sync); "
                 f"launches: the launcher's w8a8 curve and decode loop "
                 f"({vlm_basis})"}
    kernels[4]["vlm"] = {
        "rows": vlm["flash_rows"], "max_abs_err": vlm["flash_err"],
        "launches": sum(vlm_l[q]["curve_launches"]["flash_attention_bhsd"]
                        for q in ("w8a16", "w8a8")),
        "basis": f"one launch at each {VLM_ARCH} shape, head_dim 128: the "
                 f"curve's self-attention (Sq = Skv = {SERVE_SEQ}, causal) "
                 f"and cross-attention (Sq {SERVE_SEQ} over Skv 1,601 "
                 f"patches, not causal) at BH = 64 x b for b = 1, 4, "
                 f"{SERVE_MAX_BATCH}; library SDPA; launches: the launcher's "
                 f"w8a16 and w8a8 curves ({vlm_basis})"}
    if min(kernels[0]["vlm"]["launches"],
           *kernels[0]["vlm"]["launches_by_path"].values(),
           kernels[0]["vlm"]["paged_launches"],
           *kernels[0]["vlm"]["launcher_launches"].values(),
           kernels[3]["vlm"]["launches"], kernels[4]["vlm"]["launches"]) <= 0:
        return fail("a kernel of the vlm path never launched")
    if any(not math.isfinite(t[key]) for t in (
            *vlm["qmatmul_rows"].values(), *vlm["w8a8_rows"].values(),
            *vlm["flash_rows"].values(), vlm["prime_row"],
            vlm["per_m"][NUM_SLOTS], vlm["per_m"][SERVE_ROWS])
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")):
        return fail("a vlm kernel row is not finite")
    # training (full-width starcoder2-3b, AdamW): flash's launches in the
    # train CLI's run (the forward and remat's recompute, 2 a layer a
    # step), its gradient's calls, and its rows at the training shape
    tcli = train["cli"]
    kernels[4]["train"] = {
        "launches": tcli["launches"], "backward_calls": tcli["backward_calls"],
        "max_abs_err": train["max_abs_err"], "rows": train["rows"],
        "step_ms": tcli["step_ms"], "tok_s": tcli["tok_s"],
        "peak_bytes": tcli["peak_bytes"], "losses": tcli["losses"],
        "model": train["model"], "resume": train["resume"],
        "basis": f"rows: one launch (forward) and one flash_attention_bwd "
                 f"call (backward, plain PyTorch) at BH = {TRAIN_BATCH} x 24, "
                 f"S = {TRAIN_SEQ}, hd 128, causal, and with a window of 32; "
                 f"library SDPA (its backward half timed alone); launches: "
                 f"the train CLI's {TRAIN_STEPS} steps at full width and "
                 f"depth (30 layers x 2 a step), backward_calls its "
                 f"gradient's; step_ms: the median step, host clock"}
    if min(tcli["launches"], tcli["backward_calls"]) <= 0:
        return fail("a kernel of the train path never launched")
    if any(not math.isfinite(t[key]) for row in train["rows"].values()
           for t in (row["forward"], row["backward"])
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")):
        return fail("a train kernel row is not finite")
    # the paper's six apps: both int8 kernels at every FC shape of the apps
    # (at the app's Table 1 batch, each weight stored padded), their
    # launches in the serve twin's run (the GEMV) and in the apps' W8A16
    # and W8A8 forwards held against the CPU
    paper_shapes = ", ".join(f"{label} M {m} (K {k:,} x N {n:,})"
                             for label, k, n, m, _, _ in PAPER_SHAPES)
    kernels[0]["paper"] = {
        "rows": {label: {p: r[p] for p in ("gemv", "mma")}
                 for label, r in paper["rows"].items()},
        "max_abs_err": paper["w8a16_err"],
        "launches": paper["serve"]["launches"]["qmatmul_w8a16"],
        "check_launches": paper["check_launches"]["qmatmul_w8a16"],
        "forward_gemv_ms": paper["per_app_gemv_ms"],
        "apps": paper["serve"]["apps"],
        "app_checks": paper["checks"],
        "basis": f"one launch at each FC shape of the paper's six apps: "
                 f"{paper_shapes}; GEMV on f32 x (the apps' path; bound by "
                 f"f32's 67 TFLOP/s), mma on x cast to bf16, f32 out, on "
                 f"the padded operands; library F.linear on f32 / bf16 "
                 f"dequantized weights; launches: the serve twin's run over "
                 f"the six apps (its curves' captured forwards), "
                 f"check_launches: the apps' W8A16 forwards against the CPU; "
                 f"apps: the serve twin's Table 4 rows (curve ms by batch, "
                 f"chosen batch, p99, req/s, deadlines met)"}
    kernels[3]["paper"] = {
        "rows": {label: r["w8a8"] for label, r in paper["rows"].items()},
        "max_abs_err": paper["w8a8_err"],
        "launches": paper["check_launches"]["qmatmul_w8a8"],
        "basis": f"one launch at each FC shape of the paper's six apps "
                 f"({paper_shapes}), x quantized on the fly (one scale), "
                 f"padded, f32 out; launches: the apps' W8A8 forwards (eager "
                 f"and captured) against the CPU"}
    if min(kernels[0]["paper"]["launches"], kernels[0]["paper"][
            "check_launches"], kernels[3]["paper"]["launches"]) <= 0:
        return fail("a kernel of the paper apps' path never launched")
    if any(not math.isfinite(t[key]) for r in paper["rows"].values()
           for t in (r["gemv"], r["mma"], r["w8a8"])
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")):
        return fail("a paper kernel row is not finite")
    if min(kernels[0]["encdec"]["launches_by_path"].values()) <= 0 or min(
            kernels[4]["encdec"][key]
            for key in ("launches", "paged_launches", "cli_launches")) <= 0:
        return fail("a kernel of the encdec path never launched")
    if any(not math.isfinite(t[key]) for t in (
            *enc["qmatmul_rows"].values(), *enc["flash_rows"].values())
           for key in ("ms", "plain_ms", "bound_ms", "library_ms")):
        return fail("an encdec kernel row is not finite")
    if min(kernels[i]["spec"]["launches"] for i in (0, 1, 2, 4)) <= 0 or \
            kernels[0]["spec"]["experts_launches"] <= 0:
        return fail("a kernel of a speculative path never launched")
    if min(kernels[0]["experts"]["launches"],
           *kernels[0]["experts"]["launches_by_path"].values(),
           kernels[1]["moe"]["launches"], kernels[2]["moe"]["launches"],
           kernels[4]["moe"]["launches"]) <= 0:
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
    # multiplexing: the launches of each kernel on its path in the
    # multiplexed serves (lanes starcoder2-3b and qwen2-moe-a2.7b), the
    # routed serve and the serve CLI's --models run
    mux_basis = (f"lanes {' and '.join(MUX_LANES)} of one engine, "
                 f"{MUX_REQUESTS} requests a lane, {NUM_SLOTS} leased slots")
    mux_c, mux_p = mux["contiguous"]["launches"], mux["paged"]["launches"]
    router_l, cli_l = mux["router"]["launches"], mux["cli"]["launches"]
    kernels[0]["multiplex"] = {
        "launches": mux_c["qmatmul_w8a16"],
        "experts_launches": mux_c["qmatmul_w8a16_experts"],
        "paged_launches": mux_p["qmatmul_w8a16"],
        "router_launches": router_l["qmatmul_w8a16"],
        "cli_launches": cli_l["qmatmul_w8a16"],
        "basis": f"the contiguous and the paged multiplexed serves "
                 f"({mux_basis}; experts: the {MOE_ARCH} lane's stacks), "
                 f"the routed serve ({MUX_REPLICAS} starcoder2-3b replicas) "
                 f"and the serve CLI's --models run"}
    kernels[1]["multiplex"] = {
        "launches": mux_c["decode_attention_int8"],
        "router_launches": router_l["decode_attention_int8"],
        "basis": f"the contiguous multiplexed serve's ticks ({mux_basis}) "
                 f"and the routed serve's"}
    kernels[2]["multiplex"] = {
        "launches": mux_p["decode_attention_int8_paged"],
        "contiguous_launches": mux_c["decode_attention_int8_paged"],
        "basis": f"the paged multiplexed serve ({mux_basis}); "
                 f"contiguous_launches: the contiguous one's chunks"}
    kernels[4]["multiplex"] = {
        "launches": cli_l["flash_attention_bhsd"],
        "basis": "the serve CLI's --models run (its service curve, on the "
                 "first lane)"}
    if min(kernels[0]["multiplex"]["launches"],
           kernels[0]["multiplex"]["experts_launches"],
           kernels[0]["multiplex"]["paged_launches"],
           kernels[0]["multiplex"]["router_launches"],
           *(kernels[i]["multiplex"]["launches"] for i in (1, 2, 4)),
           kernels[1]["multiplex"]["router_launches"]) <= 0:
        return fail("a kernel of the multiplexed path never launched")
    # scale-out: each kernel's launches in the tp 2 and tp 4 serves of the
    # contiguous slice's trace on the one card, with the captured tick of
    # each tp against the single-device control's
    shard_basis = (f"the contiguous slice's trace ({N_REQUESTS} requests, "
                   f"{NUM_SLOTS} slots) through ShardedExecutor(tp) on the "
                   f"one card; tick: the captured steady tick of "
                   f"{NUM_SLOTS} rows, wall and busy ms, tp 1 the "
                   f"single-device control")
    for i, name in enumerate(SHARD_NEED):
        kernels[i]["sharded"] = {
            "launches": {f"tp{tp}": shard[f"tp{tp}"]["launches"][name]
                         for tp in SHARD_TPS},
            "basis": shard_basis}
    kernels[0]["sharded"]["tick"] = {f"tp{tp}": t for tp, t in
                                     shard["tick"].items()}
    kernels[0]["sharded"]["tok_s"] = {
        "control": shard["control"]["tok_s"],
        **{f"tp{tp}": shard[f"tp{tp}"]["tok_s"] for tp in SHARD_TPS}}
    if min(n for i in range(3)
           for n in kernels[i]["sharded"]["launches"].values()) <= 0:
        return fail("a kernel of the sharded path never launched")
    multiplex = {k: v for k, v in mux.items()
                 if k not in ("cli", "router_cli")}
    for k in ("contiguous", "paged", "router"):
        multiplex[k] = {kk: vv for kk, vv in mux[k].items()
                        if kk != "launches"}
    multiplex["cli_tok_s"] = mux["cli"]["tok_s"]
    for k in kernels + list(w8a16_paths.values()):
        for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
            if not math.isfinite(k[key]):
                return fail(f"{k.get('name', 'qmatmul_w8a16 path')}: {key} "
                            f"is not finite")
        if k["launches"] <= 0:
            return fail(f"{k.get('name', 'qmatmul_w8a16 path')}: no launch "
                        f"on its path")
    print(json.dumps({"kernels": kernels, "multiplex": multiplex}))
    c = TIME_MS_COST
    print(f"chip_smoke: time_ms {c['calls']} calls, {c['seconds']:.1f}s "
          f"(heads {c['head_s']:.1f}s, {c['retaken']} retaken; the plain "
          f"versions' {c['plain_calls']} calls {c['plain_seconds']:.1f}s)")
    print(f"chip_smoke: whole run {time.perf_counter() - t_run:.1f}s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
