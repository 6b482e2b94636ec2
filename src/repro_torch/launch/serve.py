"""Serving launcher: the port of ``repro/launch/serve.py`` (all but
``--arrival``), end to end on one card.

Init a model from a seed, post-training int8 quantization, measure the
prefill service-time curve through the full-sequence ``forward`` (every
attention layer through the flash-attention kernel), captured as a CUDA
graph per measured batch (``runtime/steps.py::jit_prefill_step``, the
reference's jitted prefill; ``--max-batch`` joins the measured set, so
batch selection interpolates), pick the largest batch
meeting the p99 deadline (the paper's Table 4 policy), time the multi-token
decode loop at that batch (captured as a CUDA graph), then size a slot
pool at that batch and drive the continuous-batching ``Engine`` (its tick
captured likewise) against a pseudo-Poisson request stream under the wall
clock — or, with ``--sim``, the virtual-time ``BatchQueue``
simulator (same admission policy, no model execution).
``--temperature t`` makes the engine sample every row at ``t`` with the
key ``PRNGKey(seed + 1)`` and the reference's ``fold_in(rng, position)``
schedule (the decode loop's tok/s stays greedy, as the reference's).
The overload flags work as the reference's: ``--interactive-frac``
splits the trace into two SLO classes by a hash of the rid,
``--batch-quota`` caps the slots the batch class holds, ``--preemption``
evicts batch slots for interactive requests with exact resume, and
``--fault-seed`` / ``--n-faults`` inject a seeded ``FaultPlan``.
``--spec-k k`` speculates with a draft: ``--draft-layers n`` (the
target's first n layers) or ``--draft ARCH`` (another registered arch of
the same vocabulary, drawn from ``seed + 2`` in the target's mode,
reduced with ``--reduced``); the engine then prints how many tokens each
dispatch committed.  The KV cache is
bf16 (the dense configs leave ``kv_quant`` off, as the reference's CLI
does); ``--block-size`` pages it (``--num-blocks`` sizes the pool) and
``--shared-prefix-len`` gives every request the same leading prompt
tokens, whose full blocks the paged engine shares.  ``--quant w8a16``
and ``w8a8`` draw the weights layer by layer, each quantized as it is
drawn (``registry.init_quantized``: the int8 tree of
``quantize_tree(init(...))`` without the f32 one, so qwen1.5-32b fits
the card); ``--quant w8a8`` runs every projection through the int8 x
int8 kernel, the LM head staying weight-only int8.  ``--arch
whisper-medium`` serves the encdec family: the curve's forward encodes
zero frames of the config's ``input_specs`` beside its tokens, the decode
loop attends a zero cross k/v over the whole source, and every engine
request carries its own source frames, primed into its slot at admission.
``--arch mamba2-1.3b`` serves the ssm family: the curve's forward runs
the chunked SSD scan, the decode loop and the engine the one-token state
update (``--block-size`` and ``--spec-k`` are rejected for it).
``--arch recurrentgemma-9b`` serves the hybrid family: the curve's forward
runs the RG-LRU scan and flash attention at head_dim 256 with the
2,048-token window, the decode loop and the engine the one-token state
update and the local-attention ring (``--block-size`` and ``--spec-k``
are rejected for it too).  ``--arch mixtral-8x22b`` serves the MoE family
over a sliding-window KV ring of min(4,096, the engine's ``max_seq``)
slots: the curve's forward runs flash attention with the window, the
decode loop and the engine write each position at its ring slot
(``--block-size`` and ``--spec-k`` are rejected for it, as in the
reference); at full depth its 141 GB of int8 weights do not fit one
80 GB card, so the CLI serves it ``--reduced``.  ``--arch
llama-3.2-vision-90b`` serves the vlm family: the curve's forward runs
flash attention causal over the tokens and, every 5th layer, not causal
over the zero patch embeddings of the config's ``input_specs``; the
decode loop attends a zero cross k/v over every patch; every engine
request carries its own patch embeddings, projected into its slot's
cross k/v at admission (``--block-size`` pages the self-attention
cache); at full depth its 90.7 GB of int8 weights do not fit one card
either, so the CLI serves it ``--reduced``.
``--models a,b`` serves several registered archs as lanes of one engine
(each arch name is its lane tag, its weights drawn from ``seed + i``):
every lane gets its own ``--n-requests`` at ``--rate``, the service curve
and the batch choice are measured on the first lane, and ``--model-quota
TAG=N`` caps a lane's slots through the (model, class) quota keys
``--batch-quota`` also uses; the report adds a line a model.
``--replicas N`` serves the trace through ``engine/router.py``'s
``ReplicaRouter`` over N engines that share the weights, and prints the
fleet's and each replica's lines.  ``--tp N`` serves each engine through
``ShardedExecutor(tp=N, devices=[device] * N)``: N shards of its slot
pool on the one ``--device``, bit for bit ``--tp 1`` (the single-device
executor); it composes with ``--replicas`` (each replica its own sharded
engine) and ``--models``.  Shards on several cards are not ported.

  python -m repro_torch.launch.serve --arch starcoder2-3b --reduced \\
      --deadline-ms 50 --rate 200                  # on the card
  python -m repro_torch.launch.serve --arch starcoder2-3b --reduced \\
      --device cpu                                 # plain versions, CPU
  python -m repro_torch.launch.serve --arch qwen1.5-32b --reduced \\
      --device cpu --block-size 4 --shared-prefix-len 4   # paged, CPU
  python -m repro_torch.launch.serve --arch starcoder2-3b --reduced \\
      --device cpu --temperature 0.8                 # sampled, CPU
  python -m repro_torch.launch.serve --arch starcoder2-3b --reduced \\
      --device cpu --spec-k 3 --draft-layers 1       # speculative, CPU
  python -m repro_torch.launch.serve --arch whisper-medium --reduced \\
      --device cpu --block-size 4                    # encdec, paged, CPU
  python -m repro_torch.launch.serve --arch llama-3.2-vision-90b \\
      --reduced --device cpu --block-size 4          # vlm, paged, CPU
  python -m repro_torch.launch.serve --arch mixtral-8x22b --reduced \\
      --device cpu --prompt-len 72                   # the ring wraps, CPU
  python -m repro_torch.launch.serve --models starcoder2-3b,qwen2-moe-a2.7b \\
      --reduced --device cpu --model-quota starcoder2-3b=2   # two lanes, CPU
  python -m repro_torch.launch.serve --arch starcoder2-3b --reduced \\
      --device cpu --replicas 2                      # the router, CPU
  python -m repro_torch.launch.serve --arch starcoder2-3b --reduced \\
      --device cpu --max-batch 4 --tp 2              # 2 shards, CPU

The reference's other serving options stay in the parser; given a value
other than their default, each prints which ROADMAP item will port it and
exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core import batching as bt
from repro_torch.core.qlinear import FP, W8A8, W8A16, QuantMode
from repro_torch.core.quant import QTensor, tree_weight_bytes
from repro_torch.device import resolve_device
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST
from repro_torch.runtime.prng import PRNGKey

# flag -> ROADMAP queue 1 item that will port it
UNPORTED = {"arrival": 12}
CURVE_BATCHES = (1, 4, 16)    # measured batch sizes, with --max-batch
TIMED_CALLS = 3               # timed calls per measurement, after one warm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_service_curve(step_fn, params, cfg: ArchConfig, *, seq: int,
                          max_batch: int, device=None):
    """Measured service time at several batch sizes -> (LatencyModel,
    {batch: seconds}).

    ``max_batch`` joins the measured set: the model is an interpolation
    over the whole batch range ``choose_batch`` searches, never an
    extrapolation beyond what was measured.  Each time is host clock
    around TIMED_CALLS calls, each ending in a wait for the card, after
    one warm-up call: for a captured step (:func:`jit_prefill_step`)
    that call captures the batch's graph, so the timed calls are
    replays."""
    device = resolve_device(device)
    batches = sorted(set(CURVE_BATCHES) | {int(max_batch)})
    times = {}
    with torch.inference_mode():
        for b in batches:
            spec = ShapeSpec("serve_curve", seq, b, "prefill")
            batch = {k: torch.zeros(shape, dtype=dtype, device=device)
                     for k, (shape, dtype) in cfg.input_specs(spec).items()}
            step_fn(params, batch)          # one warmup call
            _sync(device)
            t0 = time.perf_counter()
            for _ in range(TIMED_CALLS):
                step_fn(params, batch)
                _sync(device)
            times[b] = (time.perf_counter() - t0) / TIMED_CALLS
    bs = sorted(times)
    b1, b2 = bs[0], bs[-1]
    per_item = max((times[b2] - times[b1]) / (b2 - b1), 1e-9)
    fixed = max(times[b1] - b1 * per_item, 1e-9)
    model = bt.LatencyModel("measured", fixed * 2.0, per_item * 1.5,
                            fixed, per_item)
    return model, times


def measure_decode_tps(cfg: ArchConfig, params, mode: QuantMode, batch: int,
                       *, s_max: int, num_tokens: int, device=None):
    """Tokens/s of the multi-token decode loop for ``batch`` useful
    requests, as it runs when served: captured once as a CUDA graph over
    its cache (``runtime/steps.py::jit_decode_loop``, the reference's
    jitted loop with the cache donated) and replayed.  The loop runs at
    the *bucketed* batch (requests padded up to the static ladder), but
    throughput counts only the ``batch`` real requests' tokens.  Returns
    (bucketed_batch, tokens_per_s, seconds_per_loop)."""
    device = resolve_device(device)
    b = ST.bucket_batch(batch)
    loop = ST.jit_decode_loop(
        ST.make_decode_loop(cfg, mode=mode, num_tokens=num_tokens))
    tokens = torch.ones((b, 1), dtype=torch.int32, device=device)
    with torch.inference_mode():
        cache = R.init_cache(cfg, b, s_max, device=device)
        loop(params, tokens, cache, 0)                 # capture + warm
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            # the cache is rewritten from step 0 on every run
            loop(params, tokens, cache, 0)
        _sync(device)
    dt = (time.perf_counter() - t0) / TIMED_CALLS
    return b, batch * num_tokens / dt, dt


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default=None,
                    help="single-model serving: one registry arch")
    ap.add_argument("--models", default=None, metavar="A,B",
                    help="multiplexing: comma-separated registry archs "
                         "served as lanes of one engine (each arch name is "
                         "its lane tag; instead of --arch); every lane "
                         "gets its own --n-requests at --rate, and the "
                         "service curve is measured on the first lane")
    ap.add_argument("--model-quota", action="append", default=[],
                    metavar="TAG=N",
                    help="engine: cap one lane at N slots at once "
                         "(repeatable; the (model, class) quota keys "
                         "--batch-quota also uses)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="fleet: serve through a ReplicaRouter over N "
                         "engines sharing the weights (1 = one engine)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--quant", default="w8a16",
                    choices=["fp", "w8a16", "w8a8"])
    ap.add_argument("--deadline-ms", type=float, default=50.0)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="requests/s for the simulated stream")
    ap.add_argument("--n-requests", type=int, default=200)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--decode-tokens", type=int, default=16,
                    help="steps of the decode loop to time (0 disables "
                         "the decode measurement)")
    ap.add_argument("--prompt-len", type=int, default=4,
                    help="engine: synthetic prompt tokens per request")
    ap.add_argument("--gen-tokens", type=int, default=8,
                    help="engine: tokens to generate per request")
    ap.add_argument("--sim", action="store_true",
                    help="run the virtual-time BatchQueue simulator "
                         "backend instead of the live engine")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="engine: chunked-prefill bucket cap (0 = "
                         "per-token prefill)")
    ap.add_argument("--block-size", type=int, default=0,
                    help="engine: paged KV cache block size in positions "
                         "(power of two; 0 = contiguous slot rows)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="engine: physical KV blocks incl. the reserved "
                         "trash block (0 = every slot can hold a full "
                         "row privately)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="engine: identical leading prompt tokens across "
                         "requests (paged mode shares their KV blocks)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="engine: per-row sampling temperature (0 = "
                         "greedy), keys from PRNGKey(seed + 1)")
    ap.add_argument("--interactive-frac", type=float, default=1.0,
                    help="engine: share of requests in the interactive "
                         "SLO class (the rest are batch), split by a "
                         "hash of the rid")
    ap.add_argument("--batch-quota", type=int, default=0,
                    help="engine: most slots the batch class may hold at "
                         "once (0 = no quota)")
    ap.add_argument("--preemption", action="store_true",
                    help="engine: evict a lower-class slot for a "
                         "higher-class request, resumed exactly")
    ap.add_argument("--fault-seed", type=int, default=None,
                    help="engine: inject FaultPlan.random(seed) failures")
    ap.add_argument("--n-faults", type=int, default=8,
                    help="engine: faults in the --fault-seed plan")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="engine: speculative decoding proposal depth "
                         "(0 = off); needs --draft or --draft-layers")
    ap.add_argument("--draft", default=None,
                    help="engine: draft arch name (e.g. starcoder2-3b) "
                         "for cross-model speculative decoding; "
                         "inherits --reduced, drawn from --seed + 2")
    ap.add_argument("--draft-layers", type=int, default=0,
                    help="engine: truncated-layer self-draft depth (the "
                         "target's own first n layers, no second "
                         "checkpoint; 0 = off)")
    ap.add_argument("--tp", type=int, default=1,
                    help="engine: serve through N shards of the slot pool "
                         "on --device (ShardedExecutor, bit-identical to "
                         "tp=1; the pool must divide by N)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    unported = ap.add_argument_group(
        "not ported yet (each exits 1 when given a non-default value)")
    unported.add_argument("--arrival", default="poisson",
                          choices=["poisson", "mmpp", "diurnal"])
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)


def _parse_model_quotas(pairs) -> Dict[str, int]:
    """``--model-quota TAG=N`` occurrences -> ``{tag: n}`` quota keys."""
    quotas = {}
    for p in pairs:
        tag, _, n = p.partition("=")
        if not tag or not n or not n.isdigit() or int(n) < 1:
            raise ValueError(
                f"--model-quota wants TAG=N with N >= 1, got {p!r}")
        quotas[tag] = int(n)
    return quotas


def _f32_bytes(params) -> int:
    """Bytes of the f32 tree an int8 one was quantized from."""
    if isinstance(params, dict):
        return sum(_f32_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(_f32_bytes(v) for v in params)
    if isinstance(params, QTensor):
        return params.values.numel() * 4
    return params.numel() * params.element_size()


def _init_params(cfg: ArchConfig, mode: QuantMode, seed: int, device):
    """Random weights from ``seed``: int8, drawn layer by layer, under a
    quantized mode (``registry.init_quantized``), else f32."""
    with torch.inference_mode():
        gen = torch.Generator(device=device).manual_seed(seed)
        if mode.enabled:
            return R.init_quantized(gen, cfg, min_size=2048, device=device)
        return R.init(gen, cfg, device=device)


@dataclasses.dataclass
class ServeRun:
    """What :func:`run` built, for callers that check it further."""
    code: int                                 # main's exit code
    cfg: Optional[ArchConfig] = None
    params: Optional[dict] = None
    mode: QuantMode = FP
    curve: Dict[int, float] = dataclasses.field(default_factory=dict)
    batch: int = 0                            # the Table 4 choice
    decode_tokens_per_s: Optional[float] = None
    engine: Optional[E.Engine] = None
    report: Optional[E.EngineReport] = None
    requests: List[E.EngineRequest] = dataclasses.field(default_factory=list)
    fault_plan: Optional[E.FaultPlan] = None
    # --models: every lane's (cfg, params), the first lane's also above
    lanes: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    # --replicas N > 1: the fleet (engine above is its first) and its report
    fleet: List[E.Engine] = dataclasses.field(default_factory=list)
    router_report: Optional[E.RouterReport] = None


def run(args: argparse.Namespace) -> ServeRun:
    """The launcher's work for parsed ``args``; ``ServeRun.code`` is 0 on
    success and 1 on a rejected configuration."""
    defaults = build_parser().parse_args([])
    for flag, item in UNPORTED.items():
        if getattr(args, flag) != getattr(defaults, flag):
            print(f"[serve] --{flag.replace('_', '-')}: not ported yet "
                  f"(ROADMAP queue 1, item {item})")
            return ServeRun(code=1)
    if (args.models is None) == (args.arch is None):
        print("[serve] need --arch or --models (exactly one)")
        return ServeRun(code=1)
    tags = ([t.strip() for t in args.models.split(",") if t.strip()]
            if args.models else [args.arch])
    if len(set(tags)) != len(tags):
        print(f"[serve] --models tags must be unique: {args.models}")
        return ServeRun(code=1)
    try:
        model_quotas = _parse_model_quotas(args.model_quota)
    except ValueError as e:
        print(f"[serve] {e}")
        return ServeRun(code=1)
    if unknown := set(model_quotas) - set(tags):
        print(f"[serve] --model-quota names unknown lanes: "
              f"{sorted(unknown)} (lanes: {tags})")
        return ServeRun(code=1)
    if args.replicas < 1:
        print(f"[serve] --replicas must be >= 1 (got {args.replicas})")
        return ServeRun(code=1)
    if args.tp < 1:
        print(f"[serve] --replicas and --tp must be >= 1 "
              f"(got {args.replicas}, {args.tp})")
        return ServeRun(code=1)
    if args.replicas > 1 and args.fault_seed is not None:
        print("[serve] --fault-seed wants a single engine (--replicas 1): "
              "a shared FaultPlan would replay the same fired list on "
              "every replica")
        return ServeRun(code=1)
    frac = args.interactive_frac
    if not 0.0 <= frac <= 1.0:
        print(f"[engine] --interactive-frac must be in [0, 1]: {frac}")
        return ServeRun(code=1)
    if not 0 <= args.shared_prefix_len <= args.prompt_len:
        print(f"[engine] --shared-prefix-len must be in [0, --prompt-len="
              f"{args.prompt_len}]: {args.shared_prefix_len}")
        return ServeRun(code=1)
    device = resolve_device(args.device)
    mode = {"fp": FP, "w8a16": W8A16, "w8a8": W8A8}[args.quant]
    lanes = {}
    for i, tag in enumerate(tags):
        lcfg = get_config(tag)
        if args.reduced:
            lcfg = lcfg.reduced()
        lparams = _init_params(lcfg, mode, args.seed + i, device)
        if mode.enabled:
            print(f"[quant] {tag} weights "
                  f"{_f32_bytes(lparams) / 1e6:.1f} MB -> "
                  f"{tree_weight_bytes(lparams) / 1e6:.1f} MB "
                  f"({args.quant})")
        lanes[tag] = (lcfg, lparams)
    # the Table 4 curve and batch choice are measured on the first lane
    cfg, params = lanes[tags[0]]
    out = ServeRun(code=1, cfg=cfg, params=params, mode=mode,
                   lanes=lanes if args.models else {})

    prefill = ST.jit_prefill_step(ST.make_prefill_step(cfg, mode=mode))
    model, curve = measure_service_curve(prefill, params, cfg, seq=args.seq,
                                         max_batch=args.max_batch,
                                         device=device)
    out.curve = curve
    print("[serve] service curve (s per prefill of "
          f"{args.seq} tokens): "
          + "  ".join(f"b={b}: {t:.6f}" for b, t in sorted(curve.items())))
    deadline = args.deadline_ms * 1e-3
    # the chosen batch stays inside the measured range: max_batch is in
    # the measured set, so the Table 4 policy never extrapolates.
    batch = min(bt.choose_batch(model, deadline, args.max_batch),
                max(curve))
    out.batch = batch
    if batch == 0:
        print(f"[serve] deadline {args.deadline_ms} ms unattainable "
              f"(p99(1) = {model.p99_latency(1) * 1e3:.1f} ms)")
        return out
    print(f"[serve] service(1)={model.service_time(1)*1e3:.2f} ms  "
          f"chosen batch={batch}  modeled p99="
          f"{model.p99_latency(batch)*1e3:.2f} ms"
          f"  modeled IPS={model.ips(batch):,.0f}")

    if args.decode_tokens > 0:
        bb, tps, dt = measure_decode_tps(
            cfg, params, mode, batch, s_max=max(args.seq * 2, 64),
            num_tokens=args.decode_tokens, device=device)
        out.decode_tokens_per_s = tps
        print(f"[decode] loop batch={batch} (shape bucket {bb}) "
              f"{args.decode_tokens} steps in {dt*1e3:.1f} ms -> "
              f"{tps:,.0f} tok/s")

    if args.sim:
        reqs = bt.poisson_arrivals(args.rate, args.n_requests, deadline,
                                   args.seed)
        q = bt.BatchQueue(model.service_time, max_batch=batch)
        recs = q.run(reqs)
        lat = []
        arrival = {r.rid: r.arrival_s for r in reqs}
        for rec in recs:
            for rid in rec.rids:
                lat.append(rec.finish_s - arrival[rid])
        met = np.mean([rec.deadlines_met for rec in recs])
        print(f"[sim] {len(recs)} batches, mean size "
              f"{np.mean([len(r.rids) for r in recs]):.1f}; "
              f"p99 latency {bt.p99(lat)*1e3:.2f} ms "
              f"(deadline {args.deadline_ms} ms); "
              f"batches meeting deadline: {met:.1%}; "
              f"throughput {len(lat)/max(r.finish_s for r in recs):,.0f} "
              f"req/s")
        out.code = 0
        return out

    # ---- the live continuous-batching engine -------------------------
    num_slots = ST.bucket_batch(max(batch, 1))
    quotas = dict(model_quotas)
    if args.batch_quota:
        quotas["batch"] = args.batch_quota
    policy = bt.AdmissionPolicy(model.service_time, max_batch=num_slots,
                                class_quotas=quotas or None)
    draft = None
    if args.draft:
        # a cross-model draft: a checkpoint of its own, in the target's
        # mode, so that both serve alike
        try:
            dcfg = get_config(args.draft)
        except KeyError as e:
            print(f"[engine] config rejected: --draft: {e}")
            return out
        if args.reduced:
            dcfg = dcfg.reduced()
        draft = (dcfg, _init_params(dcfg, mode, args.seed + 2, device))
    backend = None
    if args.tp > 1:
        backend = E.ShardedExecutor(tp=args.tp, devices=[device] * args.tp)
        print(f"[serve] sharded executor: tp={args.tp} on {device} "
              f"({args.tp} shards of a {num_slots}-slot pool), "
              f"slot-axis sharding (bit-identical to tp=1)")
    eng_kw = dict(mode=mode, num_slots=num_slots,
                  max_seq=args.prompt_len + args.gen_tokens,
                  policy=policy,
                  prefill_chunk=args.prefill_chunk or None,
                  block_size=args.block_size or None,
                  num_blocks=args.num_blocks or None,
                  temperature=args.temperature,
                  rng=(PRNGKey(args.seed + 1)
                       if args.temperature > 0 else None),
                  spec_k=args.spec_k, draft=draft,
                  draft_layers=args.draft_layers or None,
                  device=device, backend=backend)

    def build_engine(name=None):
        if args.models:
            return E.Engine(models=lanes, name=name, **eng_kw)
        return E.Engine(cfg, params, name=name, **eng_kw)

    try:
        fleet = [build_engine(f"replica{i}" if args.replicas > 1 else None)
                 for i in range(args.replicas)]
    except ValueError as e:
        print(f"[engine] config rejected: {e}")
        return out
    eng = out.engine = fleet[0]
    # rid-hash class split, stable under any n (the reference's rule)
    priority = ("interactive" if frac >= 1.0 else
                (lambda rid: "interactive"
                 if (rid * 2654435761) % 1000 < frac * 1000 else "batch"))
    # one sub-trace a lane, each in its lane's vocabulary and tagged with
    # it, rids offset by lane so that the merged trace keys uniquely; the
    # single-model trace is the one-lane case, as before
    reqs = []
    for i, tag in enumerate(tags):
        lcfg = lanes[tag][0]
        sub = E.synthetic_requests(
            args.n_requests, rate_per_s=args.rate, vocab=lcfg.vocab,
            prompt_len=args.prompt_len, max_new_tokens=args.gen_tokens,
            deadline_s=deadline, seed=args.seed + i,
            shared_prefix_len=args.shared_prefix_len,
            source_shape=R.source_shape(lcfg), priority=priority,
            model=tag if args.models else None)
        reqs.extend(dataclasses.replace(r, rid=r.rid + i * args.n_requests)
                    for r in sub)
    reqs.sort(key=lambda r: r.arrival_s)
    out.requests = reqs
    if args.replicas > 1:
        out.fleet = fleet
        return _serve_fleet(out, args, fleet, reqs, num_slots)
    plan = (E.FaultPlan.random(args.fault_seed, n_faults=args.n_faults,
                               num_slots=num_slots)
            if args.fault_seed is not None else None)
    out.fault_plan = plan
    eng.warmup()         # build and load before the clock starts: the
    try:                 # measured p99 is serving, not set-up
        rep = eng.serve(reqs, clock="wall", preemption=args.preemption,
                        fault_plan=plan)
    except E.RequestTooLong as e:
        print(f"[engine] request rejected at admission: {e}")
        return out
    out.report = rep
    deadline_of = {r.rid: r.deadline_s for r in reqs}
    met = np.mean([r.finish_s <= deadline_of[r.rid]
                   for r in rep.results]) if rep.results else 0.0
    print(f"[engine] {rep.num_slots} slots x {eng.max_seq} positions; "
          f"{len(rep.results)} requests in {rep.ticks} ticks "
          f"({rep.wall_s:.2f} s wall)")
    print(f"[engine] achieved p99 {rep.p99_latency_s*1e3:.2f} ms "
          f"(deadline {args.deadline_ms} ms, met {met:.1%}); "
          f"{rep.tokens_per_s:,.0f} tok/s decoded; "
          f"slot occupancy {rep.mean_occupancy:.1%} mean / "
          f"{max(rep.occupancy) if rep.occupancy else 0} peak; "
          f"{rep.admissions_while_busy} admissions while mid-generation "
          f"(no drain barrier)")
    print(f"[engine] time-to-first-token {rep.mean_ttft_s*1e3:.2f} ms mean "
          f"/ {rep.p99_ttft_s*1e3:.2f} ms p99 "
          f"(prefill chunk {rep.prefill_chunk or 'off'})")
    if rep.spec_k:
        print(f"[engine] speculative: k={rep.spec_k} "
              f"({eng.dcfg.name} draft), "
              f"{rep.accepted_per_dispatch:.2f} tokens committed per "
              f"dispatch, {rep.latency_per_token_s*1e3:.2f} ms/token "
              f"mean (outputs bit-for-bit the non-speculative stream)")
    if rep.block_size:
        print(f"[engine] paged KV: {rep.num_blocks} blocks x "
              f"{rep.block_size} positions, {rep.kv_hbm_bytes/1e6:.2f} MB "
              f"resident; peak {rep.peak_blocks_used} blocks used "
              f"({rep.mean_block_util:.1%} mean util); "
              f"{rep.shared_block_hits} shared-prefix block hits "
              f"({rep.shared_hit_rate:.1%} of demand, "
              f"{rep.prefill_tokens_skipped} prefill tokens skipped); "
              f"{rep.leaked_blocks} leaked blocks; effective concurrency "
              f"{rep.effective_concurrency:.1f}")
    if len(rep.class_p99_latency_s) > 1:
        print(f"[engine] goodput {rep.goodput_tokens_per_s:,.0f} tok/s "
              f"({rep.slo_attainment:.1%} of requests made their "
              f"deadline)")
        for cls in bt.PRIORITY_CLASSES:
            if cls not in rep.class_p99_latency_s:
                continue
            print(f"[engine]   {cls:11s} "
                  f"p99 {rep.class_p99_latency_s[cls]*1e3:8.2f} ms, "
                  f"ttft {rep.class_mean_ttft_s[cls]*1e3:.2f} ms mean / "
                  f"{rep.class_p99_ttft_s[cls]*1e3:.2f} ms p99")
    for tag in rep.model_p99_latency_s:
        print(f"[engine]   model {tag}: "
              f"p99 {rep.model_p99_latency_s[tag]*1e3:8.2f} ms, "
              f"ttft {rep.model_mean_ttft_s[tag]*1e3:.2f} ms mean / "
              f"{rep.model_p99_ttft_s[tag]*1e3:.2f} ms p99, "
              f"goodput {rep.model_goodput_tokens_per_s[tag]:,.0f} tok/s, "
              f"occupancy {rep.model_mean_occupancy[tag]:.1%} of the "
              f"shared lease / {max(rep.model_occupancy[tag], default=0)} "
              f"peak"
              + (f" (quota {quotas[tag]})" if tag in quotas else ""))
    if (rep.preempted or rep.dropped or rep.failed or rep.unfinished
            or args.preemption or plan is not None):
        print(f"[engine] retirement: {rep.preempted} preemptions "
              f"(exact resume), {rep.dropped} dropped, {rep.failed} "
              f"failed, {rep.unfinished} unfinished")
    if plan is not None:
        print(f"[engine] faults: {len(plan.fired)} fired "
              f"({rep.dispatch_retries} dispatch retries, "
              f"{rep.nonfinite_samples} non-finite samples caught, "
              f"{rep.torn_rows_repaired} torn rows repaired, "
              f"{rep.leaked_blocks} leaked blocks, "
              f"{rep.stuck_ticks} stuck ticks)")
    out.code = 0
    return out


def _serve_fleet(out: ServeRun, args, fleet, reqs, num_slots) -> ServeRun:
    """``--replicas N``: the trace through a ``ReplicaRouter`` over the
    fleet (each engine warmed up before the wall clock starts)."""
    router = E.ReplicaRouter(fleet)
    for member in fleet:
        member.warmup()
    try:
        rrep = router.serve(reqs, clock="wall", preemption=args.preemption)
    except E.RequestTooLong as e:
        print(f"[engine] request rejected at admission: {e}")
        return out
    out.router_report = rrep
    print(f"[router] {len(fleet)} replicas x {num_slots} slots x "
          f"{fleet[0].max_seq} positions; {len(rrep.results)} requests, "
          f"{rrep.refused} refused")
    print(f"[router] fleet p99 {rrep.p99_latency_s*1e3:.2f} ms "
          f"(deadline {args.deadline_ms} ms); "
          f"{rrep.tokens_per_s:,.0f} tok/s decoded, goodput "
          f"{rrep.goodput_tokens_per_s:,.0f} tok/s; "
          f"ttft {rrep.mean_ttft_s*1e3:.2f} ms mean; "
          f"{rrep.leaked_blocks} leaked blocks")
    print("[router] per-replica occupancy: " + "  ".join(
        f"{n}={rrep.replica_occupancy[n]:.1%}"
        f"({rrep.replica_requests[n]} reqs)" for n in rrep.replica_names))
    out.code = 0
    return out


def main(argv=None) -> int:
    return run(parse_args(argv)).code


if __name__ == "__main__":
    sys.exit(main())
