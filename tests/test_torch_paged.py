"""The port's paged KV cache, on the CPU at reduced size: the block pool's
invariants, the paged attention's plain version and decode step against
the JAX package, stale and shared blocks that must never leak into a
result, and the paged engine bit for bit against its own contiguous
batch-1 reference, against the port's contiguous engine, and token for
token against the JAX paged engine."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import get_config as jget_config
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as JL
from repro.models import registry as JR
from repro.models import transformer as JT
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import W8A16
from repro_torch.kernels import decode_attention as A
from repro_torch.kernels import ops
from repro_torch.models import bridge
from repro_torch.models import layers as TL
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST

from test_torch_engine import _jax_reference_with_margins
from test_torch_model import LOGIT_ATOL, to_numpy

BS, MAX_SEQ = 4, 16


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_config("starcoder2-3b").reduced(),
                               kv_quant=True)
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    jq = jquantize_tree(JR.init(jax.random.PRNGKey(0), jcfg), min_size=2048)
    params = bridge.params_from_numpy(to_numpy(jq), device="cpu")
    return jcfg, cfg, jq, params


def _shared_trace(vocab):
    """test_paged.py's shared-prefix trace: 24 requests whose first prompt
    block is common, so later ones share it while earlier ones decode."""
    return dict(n=24, rate_per_s=2000.0, vocab=vocab, prompt_len=6,
                max_new_tokens=5, shared_prefix_len=4)


def _paged_engine(cfg, params, **kw):
    kw = {"num_slots": 4, "max_seq": MAX_SEQ, "prefill_chunk": 4,
          "block_size": BS, **kw}
    return E.Engine(cfg, params, mode=W8A16, device="cpu", **kw)


@pytest.fixture(scope="module")
def shared_run(setup):
    """The port's paged engine and its batch-1 reference on the shared
    trace, served once for the tests that read them."""
    _, cfg, _, params = setup
    t = _shared_trace(cfg.vocab)
    reqs = E.synthetic_requests(t.pop("n"), **t)
    eng = _paged_engine(cfg, params)
    rep = eng.serve(reqs)
    ref = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                              max_seq=eng.max_seq, device="cpu")
    return reqs, eng, rep, ref


# ---------------------------------------------------------------------------
# (a) BlockPool invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_blocks", [2, 3, 5, 9])
def test_block_pool_trash_reserved_and_roundtrip(num_blocks):
    """Block 0 is never handed out; allocating the whole pool and
    releasing it restores the free list, and a fresh alloc succeeds."""
    pool = E.BlockPool(num_blocks, 4)
    bids = [pool.alloc() for _ in range(num_blocks - 1)]
    assert sorted(bids) == list(range(1, num_blocks))
    assert pool.free_blocks == 0 and pool.used_blocks == num_blocks - 1
    for b in bids:
        pool.release(b)
    assert pool.free_blocks == num_blocks - 1
    assert all(rc == 0 for rc in pool.refcounts)
    assert pool.alloc() > 0


@pytest.mark.parametrize("num_blocks", [2, 4, 6])
def test_block_pool_exhaustion_raises_without_corrupting(num_blocks):
    pool = E.BlockPool(num_blocks, 4)
    bids = [pool.alloc() for _ in range(num_blocks - 1)]
    before = list(pool.refcounts)
    with pytest.raises(RuntimeError, match="exhausted"):
        pool.alloc()
    assert pool.refcounts == before
    for b in bids:
        pool.release(b)
    assert pool.free_blocks == num_blocks - 1


@pytest.mark.parametrize("misuse", ["double_release", "release_trash",
                                    "ref_dead", "too_small"])
def test_block_pool_refcount_floor(misuse):
    pool = E.BlockPool(4, 2)
    b = pool.alloc()
    pool.release(b)
    if misuse == "double_release":
        with pytest.raises(RuntimeError, match="never go negative"):
            pool.release(b)
    elif misuse == "release_trash":
        with pytest.raises(RuntimeError):
            pool.release(0)
    elif misuse == "ref_dead":
        with pytest.raises(RuntimeError):
            pool.ref(b)
    else:
        with pytest.raises(ValueError, match="trash"):
            E.BlockPool(1, 2)


def test_block_pool_sharing_lifecycle():
    """register -> lookup -> ref; the LAST release evicts the hash entry,
    so a recycled block can never be found by lookup."""
    pool = E.BlockPool(4, 2)
    b = pool.alloc()
    key = ((), (5, 6))
    pool.register(key, b)
    assert pool.lookup(key) == b
    pool.ref(b)
    pool.release(b)
    assert pool.lookup(key) == b
    pool.release(b)
    assert pool.lookup(key) is None
    with pytest.raises(RuntimeError, match="dead"):
        pool.register(key, b)
    assert pool.refcounts[pool.alloc()] == 1


@pytest.mark.parametrize("seed", range(4))
def test_block_pool_random_ops_keep_invariants(seed):
    """Any interleaving of alloc/ref/release keeps refcounts >= 0 and
    held + free == usable blocks, as the JAX package's pool does on the
    same operations."""
    rng = np.random.default_rng(seed)
    pool, jpool = E.BlockPool(6, 4), JE.BlockPool(6, 4)
    live = []                         # one entry per outstanding ref
    for _ in range(60):
        op = rng.integers(0, 3)
        if op == 0 and pool.free_blocks:
            bid = pool.alloc()
            assert jpool.alloc() == bid
            live.append(bid)
        elif op == 1 and live:
            bid = live[rng.integers(len(live))]
            pool.ref(bid)
            jpool.ref(bid)
            live.append(bid)
        elif op == 2 and live:
            bid = live.pop(rng.integers(len(live)))
            pool.release(bid)
            jpool.release(bid)
        assert all(rc >= 0 for rc in pool.refcounts)
        held = sum(1 for rc in pool.refcounts if rc > 0)
        assert held + pool.free_blocks == pool.num_blocks - 1
        assert pool.refcounts == jpool.refcounts


# ---------------------------------------------------------------------------
# (b) the paged plain version against the JAX package
# ---------------------------------------------------------------------------

def _paged_inputs(rng, b, nb, bs, mb, kvh, g, hd):
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    k = rng.integers(-127, 128, (nb, bs, kvh, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (nb, bs, kvh, hd)).astype(np.int8)
    ks = (rng.random((nb, bs, kvh, 1)) * 0.02 + 1e-3).astype(np.float32)
    vs = (rng.random((nb, bs, kvh, 1)) * 0.02 + 1e-3).astype(np.float32)
    # shuffled, non-contiguous tables; entries past each row's frontier
    # point at trash block 0
    vl = np.array([0, 1, 6, mb * bs][:b], np.int32)
    tables = np.zeros((b, mb), np.int32)
    perm = rng.permutation(np.arange(1, nb))
    for r in range(b):
        used = -(-int(vl[r]) // bs)
        tables[r, :used] = perm[:used]
        perm = np.roll(perm, -used)
    return q, k, v, ks, vs, vl, tables


@pytest.mark.parametrize("append", [False, True])
@pytest.mark.parametrize("g", [1, 12])
def test_paged_plain_matches_jax(g, append):
    """Plain paged attention, through ``ops.decode_attention(...,
    block_tables=)``, vs the JAX package's oracle
    ``ref.decode_attention_paged_ref`` and its Pallas kernel under the
    interpreter, ragged valid_len including 0 and a full row, with and
    without the append column.  All are f32 softmax attention over the
    same dequantized terms, summed in other orders: rtol = atol = 2e-5."""
    rng = np.random.default_rng(10 * g + append)
    b, nb, bs, mb, kvh, hd = 4, 14, 4, 4, 2, 32
    q, k, v, ks, vs, vl, tables = _paged_inputs(rng, b, nb, bs, mb, kvh, g,
                                                hd)
    kn = vn = None
    if append:
        kn = rng.standard_normal((b, 1, kvh, hd)).astype(np.float32)
        vn = rng.standard_normal((b, 1, kvh, hd)).astype(np.float32)
    j = jnp.asarray
    jargs = (j(q), j(k), j(v), j(ks), j(vs), j(vl))
    jkw = dict(k_new=None if kn is None else j(kn),
               v_new=None if vn is None else j(vn))
    oracle = jref.decode_attention_paged_ref(*jargs, j(tables),
                                             sm_scale=hd ** -0.5, **jkw)
    kernel = jops.decode_attention(*jargs, block_tables=j(tables),
                                   interpret=True, **jkw)
    t = torch.from_numpy
    calls = A.decode_attention_int8_paged_ref.calls
    got = ops.decode_attention(
        t(q), t(k), t(v), t(ks), t(vs), t(vl), block_tables=t(tables),
        k_new=None if kn is None else t(kn),
        v_new=None if vn is None else t(vn)).numpy()
    assert A.decode_attention_int8_paged_ref.calls == calls + 1
    for want in (oracle, kernel):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_paged_plain_equals_contiguous_on_gathered_view():
    """The paged plain version is the contiguous one on the gathered view,
    bitwise — the CPU half of the engine's bit parity."""
    rng = np.random.default_rng(3)
    q, k, v, ks, vs, vl, tables = _paged_inputs(rng, 4, 14, 4, 4, 2, 12, 32)
    t = torch.from_numpy
    tb = t(tables)
    got = A.decode_attention_int8_paged_ref(t(q), t(k), t(v), t(ks), t(vs),
                                            t(vl), tb)
    g = TL.paged_gather
    want = A.decode_attention_int8_ref(t(q), g(t(k), tb), g(t(v), tb),
                                       g(t(ks), tb), g(t(vs), tb), t(vl))
    assert torch.equal(got, want)
    np.testing.assert_array_equal(
        g(t(k), tb).numpy(), np.asarray(JL.paged_gather(jnp.asarray(k),
                                                        jnp.asarray(tables))))


def test_paged_cuda_wrapper_refuses_cpu_tensors():
    z8 = torch.zeros((3, 4, 1, 16), dtype=torch.int8)
    zs = torch.ones((3, 4, 1))
    with pytest.raises(ValueError, match="CUDA"):
        A.decode_attention_int8_paged(
            torch.zeros((1, 1, 2, 16)), z8, z8, zs, zs,
            torch.ones(1, dtype=torch.int32),
            torch.zeros((1, 2), dtype=torch.int32))
    assert A.decode_attention_int8_paged.launches == 0


# ---------------------------------------------------------------------------
# (c) the paged decode step against the JAX paged decode step
# ---------------------------------------------------------------------------

def _tables(b, nb, mb, seed):
    """Each row's blocks, drawn without replacement from 1..nb-1."""
    perm = np.random.default_rng(seed).permutation(np.arange(1, nb))
    return perm[:b * mb].reshape(b, mb).astype(np.int32)


def test_paged_decode_step_matches_jax(setup):
    """Eight decode steps, four rows at ragged per-row positions, each row
    on shuffled physical blocks: the port's logits track the JAX paged
    decode step's within LOGIT_ATOL (tests/test_torch_model.py: the JAX
    CPU path rounds q, the cache and the probabilities to bf16 in its
    einsum fallback, where the port keeps f32 as the TPU kernel does), and
    greedy tokens agree wherever the JAX top-2 gap is outside it."""
    jcfg, cfg, jq, params = setup
    b, steps, nb = 4, 8, 4 * (MAX_SEQ // BS) + 1
    tables = _tables(b, nb, MAX_SEQ // BS, 0)
    rng = np.random.default_rng(0)
    tokens = rng.integers(1, jcfg.vocab, (steps, b, 1)).astype(np.int32)
    start = np.array([0, 3, 7, 1], np.int32)
    jdecode = jax.jit(lambda p, t, c, i: JT.decode_step(p, t, c, i, jcfg,
                                                         mode=JW8A16))
    jcache = dict(JR.init_paged_cache(jcfg, b, MAX_SEQ, BS, nb),
                  block_tables=jnp.asarray(tables))
    tcache = R.init_paged_cache(cfg, b, MAX_SEQ, BS, nb, device="cpu")
    tcache["block_tables"].copy_(torch.from_numpy(tables))
    decode = ST.make_decode_step(cfg, mode=W8A16)
    worst = 0.0
    for s in range(steps):
        idx = start + s
        jl, jcache = jdecode(jq, jnp.asarray(tokens[s]), jcache,
                             jnp.asarray(idx))
        tl, tcache = decode(params, {"tokens": torch.from_numpy(tokens[s]),
                                     "cache_index": torch.from_numpy(idx)},
                            tcache)
        jl = np.asarray(jl)
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        worst = max(worst, float(np.abs(tl.numpy() - jl).max()))
        top2 = np.sort(jl[:, -1], axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > LOGIT_ATOL
        np.testing.assert_array_equal(
            tl.numpy()[:, -1].argmax(-1)[clear], jl[:, -1].argmax(-1)[clear])
    assert worst <= LOGIT_ATOL, worst
    # every entry was written through the tables to the same physical
    # places as the reference's (a scale is > 0 exactly where written)
    for key in ("k_scale", "v_scale"):
        np.testing.assert_array_equal(tcache[key].numpy() > 0,
                                      np.asarray(jcache[key]) > 0)


def test_paged_decode_step_equals_contiguous_bitwise(setup):
    """The same history decoded into a paged cache and into contiguous
    rows: bit-identical logits at every step, and the gathered paged rows
    equal the contiguous rows byte for byte up to each frontier."""
    _, cfg, _, params = setup
    b, steps, nb = 3, 6, 3 * (MAX_SEQ // BS) + 2
    tables = _tables(b, nb, MAX_SEQ // BS, 1)
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, cfg.vocab, (steps, b, 1)).astype(np.int32)
    start = np.array([0, 5, 2], np.int32)
    paged = R.init_paged_cache(cfg, b, MAX_SEQ, BS, nb, device="cpu")
    paged["block_tables"].copy_(torch.from_numpy(tables))
    contig = R.init_cache(cfg, b, MAX_SEQ, device="cpu")
    decode = ST.make_decode_step(cfg, mode=W8A16)
    for s in range(steps):
        batch = {"tokens": torch.from_numpy(tokens[s]),
                 "cache_index": torch.from_numpy(start + s)}
        lp, paged = decode(params, batch, paged)
        lc, contig = decode(params, batch, contig)
        assert torch.equal(lp, lc)
    for key in ("k", "v", "k_scale", "v_scale"):
        got = TL.paged_gather(paged[key][1], paged["block_tables"])
        for r in range(b):
            n = int(start[r]) + steps
            assert torch.equal(got[r, :n], contig[key][1][r, :n])


# ---------------------------------------------------------------------------
# (d) stale block bytes are never read; (g) shared blocks never change
# ---------------------------------------------------------------------------

def _poison(cache):
    for k, c in cache.items():
        if k != "block_tables":
            c.fill_(77 if c.dtype == torch.int8 else 3.5)


def test_new_tenant_never_reads_stale_block_bytes(setup):
    """Every physical block (trash included) filled with finite garbage —
    a previous tenant's worst-case leftovers — then one request served
    through freshly allocated blocks with the raw paged steps: its greedy
    tokens equal the sequential reference's."""
    _, cfg, _, params = setup
    prompt, gen = (3, 1, 4, 1, 5), 4
    req = E.EngineRequest(rid=0, prompt=prompt, max_new_tokens=gen)
    want = E.reference_outputs(cfg, params, [req], mode=W8A16,
                               max_seq=MAX_SEQ, device="cpu")[0]
    cache = R.init_paged_cache(cfg, 2, MAX_SEQ, BS, 9, device="cpu")
    _poison(cache)
    cache["block_tables"][0] = torch.tensor([1, 2, 3, 4])
    chunk = ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=4)
    step = ST.make_slot_decode_step(cfg, mode=W8A16)
    cache = chunk(params, np.asarray(prompt[:4], np.int32), cache, 0, 0, 4)
    tokens = torch.tensor([[prompt[4]], [0]], dtype=torch.int32)
    index = torch.tensor([4, 0], dtype=torch.int32)
    active = torch.tensor([True, False])
    got = []
    for _ in range(gen):
        nxt, cache, index = step(params, tokens, cache, index, active)
        got.append(int(nxt[0]))
        tokens[0, 0] = nxt[0]
    assert got == want


def test_shared_block_bytes_survive_sharers(setup):
    """Slot 0 prefills a prompt whose first block slot 1 then shares (its
    table points at the same physical block, and it starts past it, as an
    admission with one prefix hit does).  Slot 1's chunk steps and both
    slots' ticks leave every byte of the shared block as slot 0 wrote it,
    and both requests still equal the sequential reference."""
    _, cfg, _, params = setup
    p0 = (5, 9, 2, 7, 11, 4, 6, 8, 1)
    p1 = p0[:4] + (13, 3, 10, 12, 2)
    gen = 4
    reqs = [E.EngineRequest(rid=i, prompt=p, max_new_tokens=gen)
            for i, p in enumerate((p0, p1))]
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                               max_seq=MAX_SEQ, device="cpu")
    cache = R.init_paged_cache(cfg, 2, MAX_SEQ, BS, 9, device="cpu")
    _poison(cache)
    cache["block_tables"].copy_(torch.tensor([[1, 2, 3, 4], [1, 5, 6, 7]]))
    chunk = ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=4)
    step = ST.make_slot_decode_step(cfg, mode=W8A16)
    cache = chunk(params, np.asarray(p0[:4], np.int32), cache, 0, 0, 4)
    shared = {k: c[:, 1].clone() for k, c in cache.items()
              if k != "block_tables"}
    cache = chunk(params, np.asarray(p0[4:8], np.int32), cache, 0, 4, 4)
    cache = chunk(params, np.asarray(p1[4:8], np.int32), cache, 1, 4, 4)
    tokens = torch.tensor([[p0[8]], [p1[8]]], dtype=torch.int32)
    index = torch.tensor([8, 8], dtype=torch.int32)
    active = torch.tensor([True, True])
    got = {0: [], 1: []}
    for _ in range(gen):
        nxt, cache, index = step(params, tokens, cache, index, active)
        for r in (0, 1):
            got[r].append(int(nxt[r]))
        tokens[:, 0] = nxt
        for k, c in shared.items():
            assert torch.equal(cache[k][:, 1], c), k
    assert got == want


# ---------------------------------------------------------------------------
# (e), (f), (i): the paged engine, bit for bit
# ---------------------------------------------------------------------------

def test_paged_engine_shared_prefix_bit_for_bit(shared_run):
    """Paged engine vs the sequential contiguous reference, bit for bit,
    on a trace where later requests share the earlier ones' prefix block
    while those still decode; and the report's paged fields hang
    together."""
    reqs, eng, rep, ref = shared_run
    assert rep.outputs() == ref
    assert all(r.status == "ok" for r in rep.results)
    assert rep.shared_block_hits > 0
    assert rep.prefill_tokens_skipped == rep.shared_block_hits * BS
    assert rep.block_size == BS and rep.kv_hbm_bytes > 0
    assert rep.num_blocks == eng.num_slots * (MAX_SEQ // BS) + 1
    assert 0.0 < rep.mean_block_util <= 1.0
    assert 0.0 < rep.shared_hit_rate < 1.0
    assert 0 < rep.peak_blocks_used <= rep.num_blocks - 1
    assert rep.leaked_blocks == 0
    assert sum(r.shared_blocks for r in rep.results) == rep.shared_block_hits


def test_paged_engine_blocks_limited_admission(setup):
    """More slots than the block budget can fill: block-cost admission
    holds requests until blocks drain, never overruns the pool, runs more
    than four rows at once, and still finishes bit for bit."""
    _, cfg, _, params = setup
    reqs = E.synthetic_requests(12, rate_per_s=5000.0, vocab=cfg.vocab,
                                prompt_len=6, max_new_tokens=5)
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                               max_seq=MAX_SEQ, device="cpu")
    rep = _paged_engine(cfg, params, num_slots=8,
                        num_blocks=17).serve(reqs)
    assert rep.outputs() == want and len(rep.results) == 12
    assert rep.peak_blocks_used <= 16
    assert max(rep.occupancy) > 4
    assert rep.leaked_blocks == 0


def test_paged_engine_equals_contiguous_engine(setup, shared_run):
    """The same trace through the contiguous engine gives the same tokens
    as the paged one."""
    _, cfg, _, params = setup
    reqs, eng, rep, _ = shared_run
    contig = E.Engine(cfg, params, mode=W8A16, num_slots=4,
                      max_seq=MAX_SEQ, prefill_chunk=4,
                      device="cpu").serve(reqs)
    assert contig.outputs() == rep.outputs()
    assert contig.block_size is None and contig.shared_block_hits == 0


def test_paged_engine_per_token_prefill(setup):
    """Without chunked prefill a prefix hit still skips its block: the
    remaining prompt is teacher-forced through the fused tick.  Arrivals
    are spread (300/s against 1 ms ticks) so that later requests find the
    prefix registered by a tenant still decoding."""
    _, cfg, _, params = setup
    t = dict(_shared_trace(cfg.vocab), rate_per_s=300.0)
    reqs = E.synthetic_requests(t.pop("n") // 2, **t)
    rep = _paged_engine(cfg, params, prefill_chunk=None).serve(reqs)
    assert rep.outputs() == E.reference_outputs(
        cfg, params, reqs, mode=W8A16, max_seq=MAX_SEQ, device="cpu")
    assert rep.shared_block_hits > 0 and rep.leaked_blocks == 0


@pytest.mark.parametrize("rate_per_s, tick_s, shares", [
    (400.0, 5e-3, False), (2.0, 0.04, True)])
def test_prefix_sharing_needs_arrivals_spread_past_prefill(
        setup, rate_per_s, tick_s, shares):
    """The shared-prefix trace of the full-width chip run (24 requests,
    prompt 32 with a 16-token common prefix, 32 new tokens, 8 slots,
    blocks of 16, a 25-block pool, prefill chunks of 4) under ticks that
    last as long as the card's do.  A prefix block is registered only
    once its tenant's chunks have written it (four ticks), and it lives
    only as long as some holder of it does.  A burst of 400/s has every
    request admitted or queued behind the block budget before that, and
    the registrant retires together with the peers it was admitted
    with: no request ever shares.  At 2/s later arrivals find the block
    registered and keep it alive for the next ones."""
    _, cfg, _, params = setup
    reqs = E.synthetic_requests(24, rate_per_s=rate_per_s, vocab=cfg.vocab,
                                prompt_len=32, max_new_tokens=32,
                                shared_prefix_len=16)
    rep = _paged_engine(cfg, params, num_slots=8, max_seq=64, block_size=16,
                        num_blocks=25).serve(reqs, tick_s=tick_s)
    assert all(r.status == "ok" for r in rep.results)
    assert (rep.shared_block_hits > 0) == shares
    assert rep.peak_blocks_used <= 24 and rep.leaked_blocks == 0


# ---------------------------------------------------------------------------
# (h) the port's paged engine against the JAX paged engine
# ---------------------------------------------------------------------------

def test_paged_engine_tokens_match_jax_paged_engine(setup, shared_run):
    """Same weights, same trace: the port's paged engine and the JAX
    package's paged engine give equal greedy tokens, except that a
    request may part ways at a step where the JAX top-2 logit gap is
    within LOGIT_ATOL — after which the two decode different inputs.
    (The JAX paged engine equals its own sequential reference, whose
    gaps are recorded.)  Both report the same prefix sharing."""
    jcfg, cfg, jq, _ = setup
    reqs, eng, rep, _ = shared_run
    t = _shared_trace(cfg.vocab)
    jreqs = JE.synthetic_requests(t.pop("n"), **t)
    jrep = JE.Engine(jcfg, jq, mode=JW8A16, num_slots=4, max_seq=MAX_SEQ,
                     prefill_chunk=4, block_size=BS).serve(jreqs)
    want = jrep.outputs()
    jref_toks, gaps = _jax_reference_with_margins(jcfg, jq, jreqs,
                                                  eng.max_seq)
    assert want == jref_toks
    assert (jrep.shared_block_hits, jrep.prefill_tokens_skipped) == \
        (rep.shared_block_hits, rep.prefill_tokens_skipped)
    got = rep.outputs()
    parted = 0
    for rid, toks in want.items():
        first = next((i for i, (a, b) in enumerate(zip(got[rid], toks))
                      if a != b), None)
        if first is None:
            continue
        assert gaps[rid][first] <= LOGIT_ATOL, (rid, first, gaps[rid])
        parted += 1
    assert parted <= len(want) // 4, parted


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw, match", [
    ({"block_size": 3}, "power of two"),
    ({"num_blocks": 8}, "block_size"),
    ({"block_size": 4, "num_blocks": 1}, "num_blocks"),
])
def test_paged_engine_config_validation(setup, kw, match):
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match=match):
        E.Engine(cfg, params, mode=W8A16, max_seq=MAX_SEQ, device="cpu",
                 **kw)


def test_paged_engine_rejects_unservable_block_demand(setup):
    """A request needing more blocks than the whole pool holds could never
    be admitted: typed rejection up front, not a hang."""
    _, cfg, _, params = setup
    eng = _paged_engine(cfg, params, num_slots=2, num_blocks=3)
    bad = [E.EngineRequest(rid=0, prompt=(1, 2, 3, 4, 5, 6),
                           max_new_tokens=6)]
    with pytest.raises(E.RequestTooLong, match="KV blocks"):
        eng.serve(bad)


def test_paged_cache_layout_and_checks(setup):
    _, cfg, _, _ = setup
    cache = R.init_paged_cache(cfg, 4, MAX_SEQ, BS, 9, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 9, BS, cfg.n_kv_heads,
                                cfg.head_dim)
    assert cache["k_scale"].shape == cache["k"].shape[:-1] + (1,)
    assert cache["block_tables"].shape == (4, MAX_SEQ // BS)
    assert cache["block_tables"].dtype == torch.int32
    assert R.paged_block_axes(cfg, cache) == {
        "k": 1, "v": 1, "k_scale": 1, "v_scale": 1}
    assert R.supports_paging(cfg)
    assert not R.supports_paging(dataclasses.replace(cfg, window=8))
    with pytest.raises(ValueError, match="whole blocks"):
        R.init_paged_cache(cfg, 4, 18, BS, 9, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        R.init_paged_cache(dataclasses.replace(cfg, window=8), 4, MAX_SEQ,
                           BS, 9, device="cpu")
