"""The port's scale-out (``engine/dispatch.py::ShardedExecutor``, the
``runtime/steps.py::make_sharded_*`` steps) on the CPU at reduced size:
tests/test_sharded.py's parity gates and tests/test_dispatch.py's
validation, with every shard on one device (``devices=["cpu"] * tp``, as
the reference forces a host mesh of tp devices).

Every parity check serves one trace through the sharded engine and the
single-device engine in the same process and holds them equal: every
request's tokens, the ticks, the generated tokens, the preemptions and
the leaked blocks (and, paged, every byte of the block pool outside trash
block 0).  A reassociated add, a lost write of a shard or a write into
another shard's rows would flip a bit.  The port's tp 2 dense serve is
also held to the JAX engine under ``ShardedExecutor(tp=1)`` on bridged
weights, up to a reference near-tie.  The weights of the parity checks
are the port's own (``registry.init_quantized``, W8A16)."""
import dataclasses
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import get_config as jget_config
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import registry as JR
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import W8A8, W8A16
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST
from repro_torch.runtime.prng import PRNGKey

from test_torch_engine import _jax_reference_with_margins
from test_torch_model import LOGIT_ATOL, to_numpy

SAMPLE_T = 0.8
KW = dict(mode=W8A16, device="cpu", num_slots=8, max_seq=16)

# family -> (arch, int8 KV cache, config changes at reduced size): the
# hybrid with its leftover blocks (8 layers) and a ring of 4 slots,
# mixtral with a ring of 4 slots, so that the trace's 9 positions wrap
# both rings
FAMILIES = {
    "dense": ("starcoder2-3b", True, {}),
    "moe": ("qwen2-moe-a2.7b", True, {}),
    "encdec": ("whisper-medium", False, {}),
    "ssm": ("mamba2-1.3b", False, {}),
    "hybrid": ("recurrentgemma-9b", False, dict(n_layers=8,
                                                 local_window=4)),
    "mixtral": ("mixtral-8x22b", True, dict(window=4)),
    "vlm": ("llama-3.2-vision-90b", False, {}),
}
# requests a trace: the reference's 200 for dense greedy, 32 elsewhere
# (4 tenants a slot; the file stays near a minute and a half on the CPU)
N_DENSE, N_OTHER = 200, 32


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(fam):
    arch, kv, changes = FAMILIES[fam]
    cfg = dataclasses.replace(get_config(arch).reduced(), kv_quant=kv,
                              **changes)
    with torch.inference_mode():
        params = R.init_quantized(torch.Generator().manual_seed(0), cfg,
                                  min_size=2048, device="cpu")
        for lp in params.get("layers", ()):
            if "x_gate" in lp:           # vlm: a zero gate hides patches
                lp["x_gate"].fill_(0.5)
    return cfg, params


_MODELS = {}


def model(fam):
    if fam not in _MODELS:
        _MODELS[fam] = _model(fam)
    return _MODELS[fam]


def _trace(cfg, n, **kw):
    return E.synthetic_requests(n, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=kw.pop("prompt_len", 4),
                                max_new_tokens=kw.pop("max_new_tokens", 5),
                                source_shape=R.source_shape(cfg), **kw)


def sharded(tp):
    return E.ShardedExecutor(tp, devices=["cpu"] * tp)


def _serve(eng, reqs, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return eng.serve(reqs, **kw)


def assert_parity(r1, r2, n):
    assert len(r1.results) == len(r2.results) == n
    assert r2.outputs() == r1.outputs()
    assert (r2.ticks, r2.generated_tokens, r2.preempted, r2.leaked_blocks) \
        == (r1.ticks, r1.generated_tokens, r1.preempted, r1.leaked_blocks)
    assert r1.leaked_blocks == 0
    assert all(r.status == "ok" for r in r2.results)


def assert_same_pool(e1, e2):
    """Every byte of the paged pool outside trash block 0 (axis 1 of each
    block leaf), and the block tables, equal."""
    c1, c2 = e1.lanes[None]._cache, e2.lanes[None]._cache
    blocks = R.paged_block_axes(e1.cfg, c1)
    for k, v in c1.items():
        a, b = (v, c2[k]) if k not in blocks else (v[:, 1:], c2[k][:, 1:])
        assert torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8)), k


# (family, temperature) -> (trace, the single-device engine's report)
_CONTROL = {}


def _family_kw(temperature):
    # greedy: the reference's recipe (per-token prefill through the
    # tick); sampled: chunks of 2 as well, so every family's chunk step
    # (and a primed family's prime) runs on its owning shard
    if temperature:
        return dict(temperature=temperature, rng=PRNGKey(7),
                    prefill_chunk=2)
    return {}


def control(fam, temperature):
    if (fam, temperature) not in _CONTROL:
        cfg, params = model(fam)
        n = N_DENSE if fam == "dense" and not temperature else N_OTHER
        reqs = _trace(cfg, n)
        rep = _serve(E.Engine(cfg, params, **KW, **_family_kw(temperature)),
                     reqs)
        _CONTROL[fam, temperature] = reqs, rep
    return _CONTROL[fam, temperature]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("temperature", [0.0, SAMPLE_T],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_sharded_is_bit_identical(fam, temperature, tp):
    """tp shards of the 8-slot pool serve the trace bit for bit as the
    single-device engine: every request's tokens, ticks, tokens and
    preemptions, in every family (the recurrent state's freeze per
    shard, the rings wrapped, the primed cross k/v in the owner's rows)."""
    cfg, params = model(fam)
    reqs, want = control(fam, temperature)
    eng = E.Engine(cfg, params, backend=sharded(tp), **KW,
                   **_family_kw(temperature))
    assert eng.backend.kind == "sharded" and eng.backend.tp == tp
    assert_parity(want, _serve(eng, reqs), len(reqs))


# tests/test_sharded.py's two paged recipes, on 200-request traces
PAGED = {
    "paged_preempt_sampled": (
        dict(prompt_len=3, max_new_tokens=4,
             priority=lambda rid: "batch" if rid % 2 else "interactive"),
        dict(num_slots=4, prefill_chunk=2, block_size=4, num_blocks=9,
             temperature=SAMPLE_T, rng=PRNGKey(7)),
        dict(preemption=True)),
    "paged_chunked": (
        dict(prompt_len=6, max_new_tokens=5, shared_prefix_len=4),
        dict(prefill_chunk=4, block_size=4), {}),
}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("case", list(PAGED))
def test_sharded_paged_is_bit_identical(case, tp):
    """The paged pool shared by every shard, written in place (the block
    tables partition the real blocks): outputs, ticks, preemptions and
    every byte of the pool outside block 0 equal the single-device
    engine's, under preemption at block pressure and with shared prefix
    blocks."""
    cfg, params = model("dense")
    trace_kw, eng_kw, serve_kw = PAGED[case]
    reqs = _trace(cfg, 200, **trace_kw)
    kw = dict(KW, **eng_kw)
    e1 = E.Engine(cfg, params, **kw)
    e2 = E.Engine(cfg, params, backend=sharded(tp), **kw)
    r1, r2 = _serve(e1, reqs, **serve_kw), _serve(e2, reqs, **serve_kw)
    assert_parity(r1, r2, 200)
    if case == "paged_preempt_sampled":
        assert r1.preempted > 0
    else:
        assert r1.shared_block_hits > 0
    assert_same_pool(e1, e2)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                     "paged"])
@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_speculation_is_bit_identical(tp, paged):
    """spec_k = 3 with a 1-layer self-draft: the draft's cache, its chunk
    steps and its propose split like the target's; the verify on each
    shard's rows.  Equal to the single-device speculating engine, and to
    the non-speculative one."""
    cfg, params = model("dense")
    reqs, plain = control("dense", 0.0)
    reqs = reqs[:N_OTHER]
    kw = dict(KW, spec_k=3, draft_layers=1, prefill_chunk=2,
              block_size=4 if paged else None)
    r1 = _serve(E.Engine(cfg, params, **kw), reqs)
    eng = E.Engine(cfg, params, backend=sharded(tp), **kw)
    assert_parity(r1, _serve(eng, reqs), len(reqs))
    assert r1.spec_k == 3
    assert r1.outputs() == {r: t for r, t in plain.outputs().items()
                            if r in r1.outputs()}


@pytest.mark.parametrize("temperature", [0.0, SAMPLE_T],
                         ids=["greedy", "sampled"])
def test_sharded_lanes_are_bit_identical(temperature):
    """``Engine(models={...}, backend=ShardedExecutor(2))``: each lane
    takes its steps from the sharded backend and serves as on the
    single-device multiplexed engine (paged when sampled)."""
    lanes = {"dense": model("dense"), "moe": model("moe")}
    reqs = []
    for i, (tag, (cfg, _)) in enumerate(lanes.items()):
        reqs += [dataclasses.replace(r, rid=r.rid + 100 * i, model=tag)
                 for r in _trace(cfg, 24, seed=i)]
    reqs.sort(key=lambda r: r.arrival_s)
    kw = dict(KW, **_family_kw(temperature))
    if temperature:
        kw["block_size"] = 4
    single = E.Engine(models=lanes, **kw)
    eng = E.Engine(models=lanes, backend=sharded(2), **kw)
    assert_parity(_serve(single, reqs), _serve(eng, reqs), len(reqs))


def test_sharded_w8a8_finishes_every_request():
    """W8A8 quantizes a tick's activations with one scale over its rows
    (ROADMAP section 3), so a shard's rows differ from the single tick's
    in both packages: held only to every request finished, 0 leaked."""
    cfg, params = model("dense")
    reqs = _trace(cfg, N_OTHER)
    eng = E.Engine(cfg, params, backend=sharded(2),
                   **dict(KW, mode=W8A8, prefill_chunk=2, block_size=4))
    rep = _serve(eng, reqs)
    assert len(rep.results) == len(reqs) and rep.leaked_blocks == 0
    assert all(r.status == "ok" and len(r.tokens) == 5 for r in rep.results)


def test_sharded_dense_matches_the_jax_engine():
    """The port's tp 2 serve (W8A16, int8 cache) and the JAX engine under
    ``repro.engine.ShardedExecutor(tp=1)`` on the same bridged weights and
    trace: greedy tokens equal, except that a request may part ways at a
    step where the JAX reference's top-2 logit gap is within LOGIT_ATOL
    (``tests/test_torch_engine.py``'s rule)."""
    jcfg = dataclasses.replace(jget_config("starcoder2-3b").reduced(),
                               kv_quant=True)
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    jq = jquantize_tree(JR.init(jax.random.PRNGKey(0), jcfg), min_size=2048)
    params = bridge.params_from_numpy(to_numpy(jq), device="cpu")
    reqs = _trace(cfg, 24)
    jreqs = JE.synthetic_requests(24, rate_per_s=2000.0, vocab=cfg.vocab,
                                  prompt_len=4, max_new_tokens=5)
    assert [(r.rid, r.prompt) for r in jreqs] == \
        [(r.rid, r.prompt) for r in reqs]
    got = _serve(E.Engine(cfg, params, backend=sharded(2), **KW),
                 reqs).outputs()
    jeng = JE.Engine(jcfg, jq, mode=JW8A16, num_slots=8, max_seq=16,
                     backend=JE.ShardedExecutor(tp=1))
    jout = jeng.serve(jreqs, tick_s=1e-3).outputs()
    want, gaps = _jax_reference_with_margins(jcfg, jq, jreqs, 16)
    assert jout == want
    parted = 0
    for rid, toks in want.items():
        first = next((i for i, (a, b) in enumerate(zip(got[rid], toks))
                      if a != b), None)
        if first is None:
            continue
        assert gaps[rid][first] <= LOGIT_ATOL, (rid, first, gaps[rid])
        parted += 1
    assert parted <= len(want) // 4, parted


# -- validation (tests/test_dispatch.py's cases) -----------------------

def test_sharded_executor_rejects_bad_tp():
    with pytest.raises(ValueError, match="tp must be >= 1"):
        sharded(0)
    with pytest.raises(ValueError, match=r"exceeds.*devices=\[device\] \* tp"):
        E.ShardedExecutor(3, devices=["cpu"] * 2)


def test_sharded_executor_validates_slot_divisibility():
    """A pool that does not divide into tp shards is refused at Engine
    construction, before any cache or step is built."""
    cfg, params = model("dense")
    with pytest.raises(ValueError, match="must divide"):
        E.Engine(cfg, params, backend=sharded(3), **dict(KW, num_slots=4))


def test_sharded_executor_needs_a_card_or_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="devices="):
        E.ShardedExecutor(2)


def test_sharded_executor_refuses_shards_off_the_engines_device():
    """Shards named on a device other than the engine's are cross-device
    placement: refused naming the ROADMAP item, before anything is
    allocated (``torch.device("cuda:0")`` needs no card)."""
    cfg, params = model("dense")
    be = E.ShardedExecutor(2, devices=["cuda:0"] * 2)
    assert be.tp == 2 and be.devices == [torch.device("cuda", 0)] * 2
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 14"):
        E.Engine(cfg, params, backend=be, **KW)
    with pytest.raises(NotImplementedError, match="item 14"):
        E.ShardedExecutor(devices=["cpu", "cuda:0"])


def test_sharded_tp1_is_the_single_device_engine():
    """``ShardedExecutor(tp=1)``: one shard of the whole pool, bitwise the
    single-device executor (tests/test_dispatch.py's conformance gate)."""
    cfg, params = model("dense")
    reqs = _trace(cfg, 16)
    kw = dict(KW, num_slots=4, prefill_chunk=2, block_size=4)
    r1 = _serve(E.Engine(cfg, params, backend=E.SingleDeviceExecutor(),
                         **kw), reqs)
    assert E.ShardedExecutor(1, devices=["cpu"]).shard_starts(4) == (0,)
    assert_parity(r1, _serve(E.Engine(cfg, params, backend=sharded(1),
                                      **kw), reqs), 16)


# -- the hazards: graph bindings, views, in-place writes ----------------

def _captures(eng):
    be, ln = eng.backend, eng.lanes[None]
    steps = [be.slot_step(ln.cfg, mode=eng.mode,
                          temperature=eng.temperature)]
    steps += [be.chunk_step(ln.cfg, mode=eng.mode, chunk=c)
              for c in (1, 2, 4)]
    return [s.captured.captures for s in steps]


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                     "paged"])
def test_serves_after_warmup_capture_nothing(paged):
    """A tp 4 engine, its single-device control and two more tp 4
    engines of one config share the memoized steps: after each one's
    ``warmup()`` their serves, in turn, bind (on the card: capture) no
    graph, since the budget keeps every shard's graphs."""
    cfg, params = model("dense")
    reqs = _trace(cfg, 16)
    kw = dict(KW, prefill_chunk=4, block_size=4 if paged else None)
    engines = [E.Engine(cfg, params, **kw)] + [
        E.Engine(cfg, params, backend=sharded(4), **kw) for _ in range(3)]
    for eng in engines:
        eng.warmup()
    bound = [_captures(e) for e in engines]
    outs = [_serve(e, reqs).outputs() for e in engines + engines[::-1]]
    assert [_captures(e) for e in engines] == bound
    assert all(o == outs[0] for o in outs)


def test_shard_views_are_views_built_once():
    """A cache's shard views are built once, where the lane allocates it
    (the same objects at every serve, or the captured steps would bind
    anew each tick), and are views of the cache's own storage: the
    slot-resident leaves narrowed on their slot axis, the block table on
    axis 0, the block leaves whole."""
    cfg, params = model("encdec")
    eng = E.Engine(cfg, params, backend=sharded(4),
                   **dict(KW, block_size=4, num_blocks=9))
    reqs = _trace(cfg, 4)
    _serve(eng, reqs)
    cache = eng.lanes[None]._cache
    views = [dict(v) for v in cache.views]
    _serve(eng, reqs)
    assert eng.lanes[None]._cache is cache and cache.rows == 2
    blocks = R.paged_block_axes(cfg, cache)
    axes = dict(R.cache_batch_axes(cfg, cache), block_tables=0)
    for i, view in enumerate(cache.views):
        assert view.keys() == cache.keys()
        for k, v in view.items():
            assert v is views[i][k]
            if k in blocks:
                assert v is cache[k]
                continue
            t = cache[k]
            assert v.shape[axes[k]] == 2
            assert v.data_ptr() == t.data_ptr() + \
                2 * i * t.stride(axes[k]) * t.element_size()
    with pytest.raises(ValueError, match="must divide"):
        ST.ShardedCache(cfg, dict(cache), 3)
    with pytest.raises(TypeError, match="ShardedCache"):
        ST.make_sharded_prime_step(cfg, mode=W8A16, tp=4)(
            params, None, dict(cache), 0, 1)


def test_the_in_place_check_shares_the_block_pool():
    """The first call of a step on a shard runs it eagerly on a copy of
    the view's narrowed leaves and on the shared block leaves as they are:
    the check never copies the block pool."""
    cfg, _ = model("dense")
    cache = ST.ShardedCache(
        cfg, R.init_paged_cache(cfg, 8, 16, 4, 9, device="cpu"), 2)
    blocks = R.paged_block_axes(cfg, cache)
    seen = {}
    cache.run("probe", 1, lambda v: None, seen.update)
    assert blocks and seen.keys() == cache.keys()
    for k, v in seen.items():
        if k in blocks:
            assert v is cache[k]
        else:
            assert v.data_ptr() != cache.views[1][k].data_ptr()
            assert torch.equal(v, cache.views[1][k])


def test_a_write_path_that_copies_a_shard_view_raises(monkeypatch):
    """A decode step that copied a strided view before writing it (here a
    ``.contiguous()`` of every leaf, a no-op on the whole cache) would
    lose a shard's writes: the first call of a step on a shard raises."""
    cfg, params = model("dense")
    real = R.apply_decode

    def copying(params, cfg, batch, cache, **kw):
        return real(params, cfg, batch,
                    {k: v.contiguous() for k, v in cache.items()}, **kw)

    monkeypatch.setattr(R, "apply_decode", copying)
    reqs = _trace(cfg, 4)
    single = _serve(E.Engine(cfg, params, **KW), reqs)
    assert len(single.results) == 4          # in place on the whole cache
    with pytest.raises(RuntimeError, match="in place"):
        _serve(E.Engine(cfg, params, backend=sharded(2), **KW), reqs)


def test_single_slot_steps_run_on_the_owner_only():
    """The chunk and the prime of slot ``sid`` run on shard ``sid // n``
    at its local row: every other row of every slot-resident leaf stays
    bitwise as it was."""
    cfg, params = model("encdec")
    cache = ST.ShardedCache(cfg, R.init_cache(cfg, 8, 16, device="cpu"), 4)
    g = torch.Generator().manual_seed(3)
    for v in cache.values():
        v.copy_(torch.randint(0, 100, v.shape, generator=g).to(v.dtype))
    before = {k: v.clone() for k, v in cache.items()}
    axes = R.cache_batch_axes(cfg, cache)
    src = torch.randn((1, R.source_len(cfg), cfg.d_model),
                      generator=g).to(torch.bfloat16)
    sid = 5
    with torch.inference_mode():
        ST.make_sharded_prime_step(cfg, mode=W8A16, tp=4)(
            params, src, cache, sid, 7)
        ST.make_sharded_prefill_chunk_step(cfg, mode=W8A16, chunk=2, tp=4)(
            params, np.array([3, 4], np.int32), cache, sid, 0, 2)
    want = {k: v.clone() for k, v in before.items()}
    with torch.inference_mode():
        ST.make_prime_step(cfg, mode=W8A16)(params, src, want, sid, 7)
        ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=2)(
            params, np.array([3, 4], np.int32), want, sid, 0, 2)
    for k, v in cache.items():
        assert torch.equal(v, want[k]), k
        others = [r for r in range(8) if r != sid]
        assert torch.equal(v.index_select(axes[k], torch.tensor(others)),
                           before[k].index_select(axes[k],
                                                  torch.tensor(others))), k
