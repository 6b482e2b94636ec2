"""The compiled chunk step on the CPU at reduced size: chunked prefill as
one (1, n) decode pass under W8A16, bitwise the per-token path
(``runtime/steps.py::make_prefill_chunk_step``), captured per ``n_valid``
(``jit_prefill_chunk_step``, through the static-buffer path the CPU runs
eagerly) and memoized (``cached_prefill_chunk_step``); attention of
several tokens against a cache (``models/layers.py::attention``) against
the JAX package's einsum path; one graph per binding
(``runtime/graphs.py::CapturedStep``), so engines taking turns capture
once each.

The same weights go into both packages (the reference's ``init`` and
``quantize_tree``, copied through numpy by ``models/bridge.py``); inputs
come from numpy with a seed.  On the CPU the JAX decode attention is its
einsum fallback and the port's each kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import layers as JL
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.runtime import steps as JST
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import FP, W8A8, W8A16
from repro_torch.kernels import qmatmul as K
from repro_torch.models import bridge
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.runtime import graphs as G
from repro_torch.runtime import steps as ST

from test_torch_model import LOGIT_ATOL, to_numpy

SLOTS, MAX_SEQ, BS, CHUNK = 3, 16, 4, 4
SID, START = 1, 6              # the chunk's slot and frontier
# paged: slot 1 shares block 1 (its positions 0..3) with slot 0; its
# chunk at positions 6..9 crosses from block 5 into block 6
TABLES = [[1, 2, 3, 4], [1, 5, 6, 7], [8, 9, 10, 11]]
NUM_BLOCKS = 12
# name -> (paged, kv_quant)
CACHES = {"int8": (False, True), "paged": (True, True), "bf16": (False, False),
          "paged_bf16": (True, False)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kv_quant):
    return (dataclasses.replace(jget_config("starcoder2-3b").reduced(),
                                kv_quant=kv_quant),
            dataclasses.replace(get_config("starcoder2-3b").reduced(),
                                kv_quant=kv_quant))


@pytest.fixture(scope="module")
def setup():
    """Reduced starcoder2-3b in both packages: f32 and int8 weights."""
    jcfg, _ = _cfgs(True)
    jfp = JR.init(jax.random.PRNGKey(0), jcfg)
    jq = jquantize_tree(jfp, min_size=2048)
    return (jq, bridge.params_from_numpy(to_numpy(jq), device="cpu"),
            bridge.params_from_numpy(to_numpy(jfp), device="cpu"))


def _cache(cfg, kind):
    if CACHES[kind][0]:
        cache = R.init_paged_cache(cfg, SLOTS, MAX_SEQ, BS, NUM_BLOCKS,
                                   device="cpu")
        cache["block_tables"].copy_(torch.tensor(TABLES, dtype=torch.int32))
        return cache
    return R.init_cache(cfg, SLOTS, MAX_SEQ, device="cpu")


def _random_cache(cfg, kind, seed=0):
    """A cache whose every slot holds random bytes: a history to attend
    to, and bytes a wrong write would change."""
    g = torch.Generator().manual_seed(seed)
    cache = _cache(cfg, kind)
    for name, t in cache.items():
        if name == "block_tables":
            continue
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  dtype=torch.int8))
        elif t.dtype == torch.float32:
            t.copy_(torch.rand(t.shape, generator=g) * 0.04 + 0.005)
        else:
            t.copy_(torch.randn(t.shape, generator=g) * 0.5)
    return cache


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _tokens(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab, (CHUNK,)).astype(np.int32)


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _written(kind, n):
    """(block or slot row, offsets) of the positions START .. START+n-1."""
    pos = np.arange(START, START + n)
    if CACHES[kind][0]:
        return np.asarray(TABLES[SID])[pos // BS], pos % BS
    return np.full(n, SID), pos


# ---------------------------------------------------------------------------
# the one pass: bitwise the per-token path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", list(CACHES))
def test_one_pass_chunk_equals_per_token(setup, kind, n):
    """Under W8A16, the chunk step eager (one pass) and captured (the
    static-buffer path) write every cache leaf ``torch.equal`` to the
    per-token step's (``make_per_token_chunk_step``), on a randomly
    filled cache;
    the pass runs each projection once for all n tokens where the
    per-token step runs it n times; only positions START .. START+n-1 of
    the slot change (paged: the chunk crosses a block edge, and the block
    the slot shares with slot 0 keeps its bytes)."""
    _, tq, _ = setup
    _, cfg = _cfgs(CACHES[kind][1])
    cache = _random_cache(cfg, kind)
    per_tok, one, graphed_c = _clone(cache), _clone(cache), _clone(cache)
    toks = _tokens(cfg)
    projections = 6 * cfg.n_layers
    calls = K.qmatmul_w8a16_ref.calls
    ST.make_per_token_chunk_step(cfg, mode=W8A16, chunk=CHUNK)(
        tq, toks, per_tok, SID, START, n)
    assert K.qmatmul_w8a16_ref.calls - calls == n * projections
    calls = K.qmatmul_w8a16_ref.calls
    ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=CHUNK)(
        tq, toks, one, SID, START, n)
    assert K.qmatmul_w8a16_ref.calls - calls == projections
    graphed = ST.jit_prefill_chunk_step(ST.make_prefill_chunk_step(
        cfg, mode=W8A16, chunk=CHUNK))
    graphed(tq, toks, graphed_c, SID, START, n)
    assert _equal(one, per_tok) and _equal(graphed_c, per_tok)
    rows, offs = _written(kind, n)
    for name, t in per_tok.items():
        if name == "block_tables":
            assert torch.equal(t, cache[name])
            continue
        before, after = cache[name].clone(), t.clone()
        assert not torch.equal(after[:, rows, offs], before[:, rows, offs])
        before[:, rows, offs] = after[:, rows, offs]
        assert torch.equal(after, before), name      # nothing else moved
        if CACHES[kind][0]:
            assert torch.equal(t[:, 1], cache[name][:, 1])   # shared block


@pytest.mark.parametrize("mode", ["w8a8", "fp"])
def test_w8a8_and_fp_keep_the_per_token_loop(setup, mode, monkeypatch):
    """Under W8A8 (one activation scale would span the chunk's tokens)
    and FP (``torch.matmul`` promises no row invariance) the chunk step
    runs one one-token decode pass per real token, eager and captured;
    both, which read the slot through a table and step a tensor
    position, write the bytes of the per-token reference
    (``make_per_token_chunk_step``: the slot's row narrowed, an int
    position)."""
    _, tq, tfp = setup
    _, cfg = _cfgs(True)
    qm, params = (W8A8, tq) if mode == "w8a8" else (FP, tfp)
    shapes = []
    real = T.decode_step

    def spy(params, tokens, *a, **kw):
        shapes.append(tuple(tokens.shape))
        return real(params, tokens, *a, **kw)

    monkeypatch.setattr(T, "decode_step", spy)
    cache = _random_cache(cfg, "int8")
    eager_c, graphed_c, want = _clone(cache), _clone(cache), _clone(cache)
    toks = _tokens(cfg)
    ST.make_prefill_chunk_step(cfg, mode=qm, chunk=CHUNK)(
        params, toks, eager_c, SID, START, 3)
    assert shapes == [(1, 1)] * 3
    graphed = ST.jit_prefill_chunk_step(ST.make_prefill_chunk_step(
        cfg, mode=qm, chunk=CHUNK))
    graphed(params, toks, graphed_c, SID, START, 3)
    assert shapes == [(1, 1)] * 6
    ST.make_per_token_chunk_step(cfg, mode=qm, chunk=CHUNK)(
        params, toks, want, SID, START, 3)
    assert _equal(eager_c, want) and _equal(graphed_c, want)
    assert not _equal(want, cache)


def test_w8a16_mode_on_float_weights_keeps_the_loop(setup, monkeypatch):
    """The one pass needs every projection to be a QTensor: W8A16 asked
    of float weights keeps the per-token loop."""
    _, _, tfp = setup
    _, cfg = _cfgs(True)
    shapes = []
    real = T.decode_step
    monkeypatch.setattr(T, "decode_step", lambda p, t, *a, **kw: (
        shapes.append(tuple(t.shape)), real(p, t, *a, **kw))[1])
    ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=CHUNK)(
        tfp, _tokens(cfg), _random_cache(cfg, "int8"), SID, START, 2)
    assert shapes == [(1, 1)] * 2


# ---------------------------------------------------------------------------
# several tokens against a cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8", "bf16"])
def test_multi_token_attention_matches_jax(setup, kv_quant):
    """``layers.attention`` of s = 3 tokens against a cache with a (B,)
    ``valid_len`` (every query row at its row's frontier, the reference's
    s > 1 form) against the JAX ``layers.attention`` einsum path under
    jit on the same numpy inputs: the cache bytes written equal, the
    outputs within LOGIT_ATOL (tests/test_torch_model.py)."""
    jq, tq, _ = setup
    jcfg, cfg = _cfgs(kv_quant)
    b, s, ci = 2, 3, 5
    rng = np.random.default_rng(3)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    full = _random_cache(cfg, "int8" if kv_quant else "bf16", seed=4)
    cache = {k: v[0, :b].clone() for k, v in full.items()}
    names = ("k", "v", "k_scale", "v_scale") if kv_quant else ("k", "v")
    jkv = tuple(jnp.asarray(cache[n].float().numpy()).astype(
        jnp.bfloat16) if cache[n].dtype == torch.bfloat16
        else jnp.asarray(cache[n].numpy()) for n in names)
    jp = jax.tree_util.tree_map(lambda a: a[0], jq["layers"])["attn"]
    pos = ci + np.arange(s)[None, :]
    jout, jnew = jax.jit(lambda p, xx, kv: JL.attention(
        p, xx, JT.attn_config(jcfg), mode=JW8A16,
        positions=jnp.asarray(pos), kv_cache=kv,
        cache_index=jnp.asarray(ci, jnp.int32)))(
        jp, jnp.asarray(x).astype(jnp.bfloat16), jkv)
    kv = tuple(cache[n].clone() for n in names)
    rope = L.rope_cos_sin(torch.from_numpy(np.repeat(pos, b, axis=0)),
                          cfg.head_dim, cfg.rope_theta)
    out = L.attention(tq["layers"][0]["attn"],
                      torch.from_numpy(x).to(torch.bfloat16),
                      T.attn_config(cfg), mode=W8A16, rope=rope,
                      kv_cache=kv, cache_index=ci,
                      valid_len=torch.full((b,), ci + s, dtype=torch.int32))
    for mine, ref in zip(kv, jnew):
        np.testing.assert_array_equal(mine.float().numpy(),
                                      np.asarray(ref.astype(jnp.float32)))
    diff = np.abs(out.float().numpy() - np.asarray(jout.astype(jnp.float32)))
    assert diff.max() <= LOGIT_ATOL, diff.max()


@pytest.mark.parametrize("kind", list(CACHES))
def test_per_row_frontiers_equal_one_token_steps(setup, kind):
    """``decode_step`` of s = 3 tokens with ``causal=True`` (``valid_len``
    (B, s), one frontier per query row) on two rows at their own places
    gives, bit for bit, the logits and cache bytes of three one-token
    steps."""
    _, tq, _ = setup
    _, cfg = _cfgs(CACHES[kind][1])
    cache = _random_cache(cfg, kind)
    if CACHES[kind][0]:          # rows 1 and 2 of the pool
        cache["block_tables"] = cache["block_tables"][1:].clone()
    else:
        cache = {k: v[:, 1:].clone() for k, v in cache.items()}
    steps = _clone(cache)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab, (2, 3)).astype(
        np.int32))
    idx = torch.tensor([6, 2], dtype=torch.int32)
    got, _ = T.decode_step(tq, toks, cache, idx, cfg, mode=W8A16,
                           causal=True)
    for j in range(3):
        want, _ = T.decode_step(tq, toks[:, j:j + 1], steps, idx + j, cfg,
                                mode=W8A16)
        assert torch.equal(got[:, j:j + 1], want), j
    assert _equal(cache, steps)


# ---------------------------------------------------------------------------
# the captured chunk step against the JAX package's jitted one
# ---------------------------------------------------------------------------

def _jax_cache(cache):
    return {k: (jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
                if v.dtype == torch.bfloat16 else jnp.asarray(v.numpy()))
            for k, v in cache.items()}


@pytest.mark.parametrize("kind", list(CACHES))
def test_captured_chunks_match_jax_chunk_step(setup, kind):
    """Seven prompt tokens of slot 1 as a chunk of 4 and a chunk of 3
    (padded to 4) through the memoized captured chunk step and through
    the JAX ``jit_prefill_chunk_step`` on the same cache bytes: the first
    layer's k/v bytes equal (they precede any attention), and the next
    token's logits agree within LOGIT_ATOL (tests/test_torch_model.py)."""
    jq, tq, _ = setup
    jcfg, cfg = _cfgs(CACHES[kind][1])
    cache = _cache(cfg, kind)
    jcache = _jax_cache(cache)
    prompt = np.random.default_rng(6).integers(1, cfg.vocab, 8).astype(
        np.int32)
    step = ST.cached_prefill_chunk_step(cfg, mode=W8A16, chunk=CHUNK)
    jstep = JST.jit_prefill_chunk_step(JST.make_prefill_chunk_step(
        jcfg, mode=JW8A16, chunk=CHUNK))
    for start, n in ((0, 4), (4, 3)):
        buf = np.zeros(CHUNK, np.int32)
        buf[:n] = prompt[start:start + n]
        step(tq, buf, cache, SID, start, n)
        jcache = jstep(jq, jnp.asarray(buf), jcache, jnp.int32(SID),
                       jnp.int32(start), jnp.int32(n))
    for name in ("k", "v"):
        mine = cache[name][0].float().numpy()
        ref = np.asarray(jcache[name][0].astype(jnp.float32))
        if CACHES[kind][0]:
            for blk in TABLES[SID][:2]:
                np.testing.assert_array_equal(mine[blk], ref[blk])
        else:
            np.testing.assert_array_equal(mine[SID, :7], ref[SID, :7])
    # the next token, slot 1 alone (batch 1 through its row or table row)
    if CACHES[kind][0]:
        row = dict(cache, block_tables=cache["block_tables"][SID:SID + 1])
        jrow = dict(jcache, block_tables=jcache["block_tables"][SID:SID + 1])
    else:
        row = {k: v[:, SID:SID + 1] for k, v in cache.items()}
        jrow = {k: v[:, SID:SID + 1] for k, v in jcache.items()}
    toks, idx = np.array([[prompt[7]]], np.int32), np.array([7], np.int32)
    jl = np.asarray(jax.jit(lambda p, t, c, i: JR.apply_decode(
        p, jcfg, {"tokens": t, "cache_index": i}, c, mode=JW8A16)[0])(
        jq, jnp.asarray(toks), jrow, jnp.asarray(idx)))
    tl, _ = R.apply_decode(tq, cfg, {"tokens": torch.from_numpy(toks),
                                     "cache_index": torch.from_numpy(idx)},
                           row, mode=W8A16)
    diff = np.abs(tl.numpy() - jl)
    assert diff.max() <= LOGIT_ATOL, diff.max()


# ---------------------------------------------------------------------------
# one graph per binding; the memo; the warm-up
# ---------------------------------------------------------------------------

def test_captured_step_keeps_a_bounded_graph_per_binding():
    """Three caches through a step that keeps two bindings: each binds
    once; back on a kept one nothing binds; the least recently called is
    evicted and binds anew when called again."""
    step = G.CapturedStep(lambda p, c, x: (x + c["k"],), max_bindings=2)
    caches = [{"k": torch.full((3,), float(i))} for i in range(3)]
    for i in (0, 1, 0):
        assert torch.equal(step({}, caches[i], torch.ones(3))[0],
                           torch.full((3,), 1. + i))
    assert step.captures == 2 and step.bindings == 2
    step({}, caches[2], torch.ones(3))          # evicts cache 1
    assert step.captures == 3 and step.bindings == 2
    step({}, caches[0], torch.ones(3))
    assert step.captures == 3
    step({}, caches[1], torch.ones(3))
    assert step.captures == 4 and step.bindings == 2
    with pytest.raises(ValueError):
        G.CapturedStep(lambda p, c: (), max_bindings=0)


def test_captured_chunk_step_has_a_binding_per_n_valid(setup):
    """The captured chunk step binds once for each n_valid it is called
    with on one params and cache; ``graphed.binding`` returns that
    n_valid's binding (its static packed input holds sid, start and the
    n real tokens), None for an n_valid not yet called or another
    cache."""
    _, tq, _ = setup
    _, cfg = _cfgs(True)
    cache = _random_cache(cfg, "int8")
    toks = _tokens(cfg)
    graphed = ST.jit_prefill_chunk_step(ST.make_prefill_chunk_step(
        cfg, mode=W8A16, chunk=CHUNK))
    for n in (1, 3, 3):
        graphed(tq, toks, cache, SID, START, n)
    assert graphed.captured.captures == 2 and graphed.captured.bindings == 2
    for n in (1, 3):
        b = graphed.binding(tq, cache, n)
        assert b.graph is None
        assert b.inputs[0].tolist() == [SID, START] + toks[:n].tolist()
    assert graphed.binding(tq, cache, 2) is None
    assert graphed.binding(tq, _clone(cache), 1) is None


def test_single_device_executor_hands_out_the_captured_chunk_step():
    _, cfg = _cfgs(True)
    ex = E.SingleDeviceExecutor()
    step = ex.chunk_step(cfg, mode=W8A16, chunk=4)
    assert isinstance(step.captured, G.CapturedStep)
    assert ex.chunk_step(cfg, mode=W8A16, chunk=4) is step
    assert step is ST.cached_prefill_chunk_step(cfg, mode=W8A16, chunk=4)
    assert ex.chunk_step(cfg, mode=W8A16, chunk=2) is not step
    assert ex.chunk_step(cfg, mode=W8A8, chunk=4) is not step


def _captures(eng):
    cfg, mode = eng.cfg, eng.mode
    chunks = {c: eng.backend.chunk_step(cfg, mode=mode, chunk=c)
              for c in (1, 2, 4)}
    return (eng.backend.slot_step(cfg, mode=mode,
                                  temperature=0.0).captured.captures,
            {c: s.captured.captures for c, s in chunks.items()})


def test_warmup_binds_every_chunk_graph(setup):
    """``Engine.warmup`` with chunks of 4 binds the tick once and the
    chunk step once for every (bucket, n_valid) pair the dispatch can
    ask for: (1, 1), (2, 2), (4, 3), (4, 4); a serve then binds
    nothing."""
    _, tq, _ = setup
    _, cfg = _cfgs(True)
    eng = E.Engine(cfg, tq, mode=W8A16, num_slots=4, max_seq=16,
                   prefill_chunk=4, device="cpu")
    tick0, chunks0 = _captures(eng)
    eng.warmup()
    tick1, chunks1 = _captures(eng)
    assert tick1 - tick0 == 1
    assert {c: chunks1[c] - chunks0[c] for c in chunks1} == {1: 1, 2: 1,
                                                             4: 2}
    reqs = E.synthetic_requests(8, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=9, max_new_tokens=3, seed=2)
    eng.serve(reqs)
    assert _captures(eng) == (tick1, chunks1)


def test_two_engines_serving_in_turn_capture_once_each(setup):
    """A contiguous and a paged engine of one config share the memoized
    tick and chunk steps; after their warm-ups, serving in turn binds
    nothing anew (each replays its own graphs), and both equal the
    sequential reference."""
    _, tq, _ = setup
    _, cfg = _cfgs(True)
    reqs = E.synthetic_requests(8, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=3, seed=3)
    engines = [E.Engine(cfg, tq, mode=W8A16, num_slots=4, max_seq=12,
                        prefill_chunk=4, block_size=bs, device="cpu")
               for bs in (None, 4)]
    for eng in engines:
        eng.warmup()
    bound = _captures(engines[0])
    want = E.reference_outputs(cfg, tq, reqs, mode=W8A16, max_seq=12,
                               device="cpu")
    for eng in engines + engines[:1]:
        assert eng.serve(reqs).outputs() == want
    assert _captures(engines[0]) == bound
