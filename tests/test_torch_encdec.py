"""The port's encdec family (whisper-medium) against the JAX package, on
the CPU at reduced size (2 encoder and 2 decoder layers, d 128, 4 query
heads over 2 KV heads of 32, enc_seq 16, vocab 512), and its engine
against its own sequential reference.

The same weights go into both packages (the reference's ``init`` and
``quantize_tree``, copied through numpy by ``models/bridge.py``); frames
and tokens come from numpy with a seed.  On the CPU the JAX attention is
its chunked einsum path and the port's each kernel's plain version.

The port's engine is held to the port's ``reference_outputs`` bit for
bit, not to the JAX engine: the JAX whisper engine does not equal its
own reference (``tests/test_engine.py``'s 200-request test fails on
every run).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import get_config as jget_config
from repro.core.qlinear import FP as JFP
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.engine import dispatch as JD
from repro.models import encdec as JEnc
from repro.models import registry as JR
from repro.runtime import steps as JST
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import FP, W8A16
from repro_torch.core.quant import QTensor, quantize_tree
from repro_torch.engine import dispatch as D
from repro_torch.kernels import qmatmul as K
from repro_torch.models import bridge
from repro_torch.models import encdec as Enc
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST
from repro_torch.runtime.prng import PRNGKey

from test_torch_forward import _check_logits
from test_torch_model import LOGIT_ATOL, to_numpy

ARCH = "whisper-medium"
MODES = {"fp": (FP, JFP), "w8a16": (W8A16, JW8A16)}
# Encoder output and cross k/v tolerance (bf16 values up to about 3.6, the
# layernormed encoder output and its projections): the two packages
# compute every stage in f32 and round it to bf16, but sum in different
# orders, so a value may land one bf16 ulp apart (0.0156 in [2, 4)) and
# the flip carries through the residual stream of the next layer (three
# ulps seen).  0.0625, four ulps in [2, 4), bounds that; a wrong mask,
# scale, position table or projection moves values by O(1).
ENC_ATOL = 0.0625
MAX_SEQ = 16
PROMPT, GEN = 6, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return jget_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def setup():
    """(jcfg, cfg, {mode: (JAX params, the port's bridged copy)})."""
    jcfg, cfg = _cfgs()
    jfp = JR.init(jax.random.PRNGKey(0), jcfg)
    jq = jquantize_tree(jfp, min_size=2048)
    return jcfg, cfg, {
        "fp": (jfp, bridge.params_from_numpy(to_numpy(jfp), device="cpu")),
        "w8a16": (jq, bridge.params_from_numpy(to_numpy(jq), device="cpu"))}


def _frames(seed, b, s, d):
    """Seeded frames as bf16: the JAX array and the port's tensor."""
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# config, params, input specs
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    j, t = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())


def test_bridge_splits_both_layer_stacks(setup):
    jcfg, cfg, params = setup
    _, tq = params["w8a16"]
    assert len(tq["enc_layers"]) == cfg.n_enc_layers
    assert len(tq["dec_layers"]) == cfg.n_layers
    assert isinstance(tq["dec_layers"][1]["cross_attn"]["wk"]["w"], QTensor)
    # the decoder positions stay f32, as the reference's quantize_tree
    # leaves them
    assert tq["dec_pos"].dtype == torch.float32


def test_init_quantized_is_quantize_tree_of_init():
    """The streamed init quantizes the leaves the whole-tree quantizer
    would, bit for bit, from the same draws."""
    _, cfg = _cfgs()
    whole = quantize_tree(Enc.init(torch.Generator().manual_seed(3), cfg,
                                   device="cpu"), min_size=2048)
    streamed = R.init_quantized(torch.Generator().manual_seed(3), cfg,
                                min_size=2048, device="cpu")

    def leaves(node):
        if isinstance(node, dict):
            for k in sorted(node):
                yield from leaves(node[k])
        elif isinstance(node, list):
            for v in node:
                yield from leaves(v)
        elif isinstance(node, QTensor):
            yield node.values
            yield node.scale
        else:
            yield node

    a, b = list(leaves(whole)), list(leaves(streamed))
    assert len(a) == len(b)
    assert all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_encode_matches_reference(setup, mode):
    """The encoder (sinusoidal positions, bidirectional flash attention,
    GeLU MLP) over two rows of frames: within ENC_ATOL of the JAX
    encoder's."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    jx, tx = _frames(1, 2, cfg.enc_seq, cfg.d_model)
    want = _np(JEnc.encode(jp, jx, jcfg, mode=jm, remat=False))
    got = _np(Enc.encode(tp, tx, cfg, mode=tm))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= ENC_ATOL


@pytest.mark.parametrize("n_valid", [16, 13])
@pytest.mark.parametrize("mode", list(MODES))
def test_prime_slot_matches_reference(setup, mode, n_valid):
    """One request's prime: the pre-projected cross k/v of every decoder
    layer within ENC_ATOL of the reference's, and its xlen frontier."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    jx, tx = _frames(2, 1, cfg.enc_seq, cfg.d_model)
    want = JR.prime_slot(jcfg, jp, jx, jnp.asarray(n_valid, jnp.int32),
                         mode=jm)
    got = R.prime_slot(cfg, tp, tx, n_valid, mode=tm)
    assert set(got) == set(want) == {"xk", "xv", "xlen"}
    for k in ("xk", "xv"):
        assert tuple(got[k].shape) == tuple(want[k].shape)
        assert float(np.abs(_np(got[k]) - _np(want[k])).max()) <= ENC_ATOL
    assert got["xlen"].dtype == torch.int32
    assert got["xlen"].tolist() == np.asarray(want["xlen"]).tolist()


@pytest.mark.parametrize("mode", list(MODES))
def test_prime_cache_matches_reference(setup, mode):
    """The batchwide prime of a lockstep cache: every row's cross k/v
    within ENC_ATOL of the reference's, every frontier at the whole
    source, the self cache untouched; the contiguous cache's leaves have
    the reference's shapes and dtypes."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    jx, tx = _frames(6, 2, cfg.enc_seq, cfg.d_model)
    jcache = JR.init_cache(jcfg, 2, MAX_SEQ)
    cache = R.init_cache(cfg, 2, MAX_SEQ, device="cpu")
    for k, v in jcache.items():
        assert tuple(cache[k].shape) == v.shape
        assert str(cache[k].dtype).split(".")[-1] == str(v.dtype)
    want = JEnc.prime_cache(jp, jcache, jx, jcfg, mode=jm)
    got = Enc.prime_cache(tp, cache, tx, cfg, mode=tm)
    assert got is cache
    for k in ("xk", "xv"):
        assert float(np.abs(_np(got[k]) - _np(want[k])).max()) <= ENC_ATOL
    assert got["xlen"].tolist() == np.asarray(want["xlen"]).tolist() == \
        [cfg.enc_seq] * 2
    assert not got["k"].any() and not got["v"].any()


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_reference(setup, mode):
    """The full-sequence forward (the service curve's prefill): (2, 8)
    tokens against two rows of frames, logits within LOGIT_ATOL and
    greedy tokens equal wherever the reference's top-2 gap is outside
    it."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 8),
                                             dtype=np.int32)
    jx, tx = _frames(4, 2, cfg.enc_seq, cfg.d_model)
    want = np.asarray(jax.jit(lambda p, t, e: JR.apply_forward(
        p, jcfg, {"tokens": t, "encoder_embeds": e}, mode=jm,
        remat=False))(jp, jnp.asarray(toks), jx))
    got = ST.make_prefill_step(cfg, mode=tm)(
        tp, {"tokens": torch.from_numpy(toks), "encoder_embeds": tx})
    _check_logits(got.numpy(), want, LOGIT_ATOL)


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_step_matches_reference_per_row(setup, mode, paged):
    """The per-row decode path of the slot engine: two slots primed with
    sources of 16 and 11 real frames (xlen < enc_seq on row 1), six
    steps at per-row positions (B,) with the same tokens fed to both
    packages; logits within LOGIT_ATOL at every step, greedy tokens equal
    where the reference's top-2 gap is outside it.  ``paged`` runs the
    port on the paged bf16 cache (blocks of 4) against the JAX
    contiguous cache."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    jprime = jax.jit(JST.make_prime_step(jcfg, mode=jm))
    jdecode = jax.jit(JST.make_decode_step(jcfg, mode=jm))
    prime = ST.make_prime_step(cfg, mode=tm)
    decode = ST.make_decode_step(cfg, mode=tm)
    jcache = JR.init_cache(jcfg, 2, MAX_SEQ)
    if paged:
        cache = R.init_paged_cache(cfg, 2, MAX_SEQ, 4, 9, device="cpu")
        cache["block_tables"].copy_(torch.arange(1, 9, dtype=torch.int32)
                                    .reshape(2, 4))
    else:
        cache = R.init_cache(cfg, 2, MAX_SEQ, device="cpu")
    for sid, n in ((0, 16), (1, 11)):
        jx, tx = _frames(10 + sid, 1, cfg.enc_seq, cfg.d_model)
        tx[:, n:] = 0
        jx = jx.at[:, n:].set(0)
        jcache = jprime(jp, jx, jcache, jnp.asarray(sid, jnp.int32),
                        jnp.asarray(n, jnp.int32))
        cache = prime(tp, tx, cache, sid, n)
    assert cache["xlen"].tolist() == [16, 11]
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (6, 2),
                                             dtype=np.int32)
    idx = np.array([0, 3], np.int32)
    for t in range(6):
        tok = toks[t][:, None]
        want, jcache = jdecode(jp, {"tokens": jnp.asarray(tok),
                                    "cache_index": jnp.asarray(idx + t)},
                               jcache)
        got, cache = decode(tp, {"tokens": torch.from_numpy(tok),
                                 "cache_index": torch.from_numpy(idx + t)},
                            cache)
        _check_logits(got.numpy(), np.asarray(want), LOGIT_ATOL)


def test_cross_attention_rows_do_not_depend_on_the_batch(setup):
    """The decode form of cross-attention computes each row on its own:
    a row alone equals the row in a batch of three, bitwise."""
    gen = torch.Generator().manual_seed(7)
    b, s, h, kvh, hd, se = 3, 2, 4, 2, 32, 16
    q = torch.randn((b, s, h, hd), generator=gen).to(torch.bfloat16)
    xk, xv = (torch.randn((b, se, kvh, hd), generator=gen)
              .to(torch.bfloat16) for _ in range(2))
    xlen = torch.tensor([16, 5, 1], dtype=torch.int32)
    full = L.cross_cache_attention(q, xk, xv, xlen)
    for r in range(b):
        one = L.cross_cache_attention(q[r:r + 1], xk[r:r + 1], xv[r:r + 1],
                                      xlen[r:r + 1])
        assert torch.equal(one[0], full[r])
    # a row reads nothing past its frontier
    poisoned = xk.clone()
    poisoned[1, 5:] = 100.0
    again = L.cross_cache_attention(q, poisoned, xv, xlen)
    assert torch.equal(again[1], full[1])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 16, 17, 513, 1500])
def test_tree_sum_over_any_dim_is_the_padded_pairwise_sum(n):
    """``tree_sum`` is the pairwise sum of the input zero-padded to a power
    of two, bit for bit and sign of zero included, over the last dim or
    any other, whatever the layout (the ragged first level adds the
    padding without making it)."""
    x = torch.randn((3, 4, n), generator=torch.Generator().manual_seed(n))
    x[x.abs() < 0.3] = -0.0
    want = torch.nn.functional.pad(x, (0, (1 << (n - 1).bit_length()) - n))
    while want.shape[-1] > 1:
        h = want.shape[-1] // 2
        want = want[..., :h] + want[..., h:]
    want = want[..., 0]
    for got in (L.tree_sum(x), L.tree_sum(x.permute(2, 0, 1).contiguous(),
                                          dim=0),
                L.tree_sum(x.transpose(1, 2), dim=1)):
        assert torch.equal(got, want)
        assert torch.equal(torch.signbit(got), torch.signbit(want))


# ---------------------------------------------------------------------------
# the odd-N LM head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab", [515, 513, 514, 512])
def test_lm_head_pads_to_a_multiple_of_four(vocab):
    """A table of any vocabulary gets a head whose N is a multiple of 4
    (the W8A16 kernels' N % 4 == 0): the padded columns hold zero values
    and zero scales, and the logits come back (..., V), each bitwise the
    unpadded head's plain version."""
    d = 128
    gen = torch.Generator().manual_seed(vocab)
    table = quantize_tree({"embed": {"table": torch.randn(
        (vocab, d), generator=gen)}}, min_size=2048)["embed"]
    head = L.lm_head(table["table"])
    assert head.values.shape == (d, vocab + (-vocab) % 4)
    assert head.values.shape[1] % 4 == 0 and head.scale.numel() == \
        head.values.shape[1]
    assert not head.values[:, vocab:].any() and not head.scale[vocab:].any()
    assert L.lm_head(table["table"]) is head       # made once per table
    x = torch.randn((3, 2, d), generator=gen).to(torch.bfloat16)
    got = L.unembed(table, x)
    want = K.qmatmul_w8a16_ref(
        x.reshape(-1, d), table["table"].values.t().contiguous(),
        table["table"].scale.reshape(-1),
        out_dtype=torch.float32).reshape(3, 2, vocab)
    assert got.shape == (3, 2, vocab)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the prime step and the chunk step
# ---------------------------------------------------------------------------

def test_captured_prime_step_equals_the_eager_one(setup):
    """The captured prime step's static-buffer code (run eagerly on the
    CPU) writes what the eager step writes, into the named row only, for
    every slot through one binding."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    eager = ST.make_prime_step(cfg, mode=W8A16)
    graphed = ST.jit_prime_step(eager)
    a = R.init_cache(cfg, 4, MAX_SEQ, device="cpu")
    b = R.init_cache(cfg, 4, MAX_SEQ, device="cpu")
    for sid, n in ((2, 16), (0, 9)):
        _, tx = _frames(20 + sid, 1, cfg.enc_seq, cfg.d_model)
        eager(tp, tx, a, sid, n)
        graphed(tp, tx, b, sid, n)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert graphed.captured.captures == 1
    assert a["xlen"].tolist() == [9, 16, 16, 16]
    assert not a["xk"][:, 1].any() and not a["xk"][:, 3].any()
    assert a["xk"][:, 2].any()


@pytest.mark.parametrize("paged", [False, True])
def test_chunk_pass_equals_the_per_token_steps(setup, paged):
    """The one-pass chunk step of a primed slot (its cross rows read at
    ``slots = sid``) writes the bytes of the per-token chunk step, every
    leaf, for every chunk length."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    prime = ST.make_prime_step(cfg, mode=W8A16)

    def fresh():
        if paged:
            c = R.init_paged_cache(cfg, 3, MAX_SEQ, 4, 13, device="cpu")
            c["block_tables"].copy_(torch.arange(1, 13, dtype=torch.int32)
                                    .reshape(3, 4))
        else:
            c = R.init_cache(cfg, 3, MAX_SEQ, device="cpu")
        for sid, n in ((0, 16), (1, 12), (2, 7)):
            _, tx = _frames(30 + sid, 1, cfg.enc_seq, cfg.d_model)
            prime(tp, tx, c, sid, n)
        return c

    for n in range(1, 5):
        one = ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=4)
        ref = ST.make_per_token_chunk_step(cfg, mode=W8A16, chunk=4)
        toks = [3, 7, 11, 2]
        a, b = fresh(), fresh()
        one(tp, toks, a, 1, 2, n)
        ref(tp, toks, b, 1, 2, n)
        for k in a:
            assert torch.equal(a[k], b[k]), (n, k)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _requests(cfg, n, **kw):
    kw.setdefault("rate_per_s", 2000.0)
    return E.synthetic_requests(n, vocab=cfg.vocab, prompt_len=PROMPT,
                                max_new_tokens=GEN,
                                source_shape=R.source_shape(cfg), **kw)


def test_synthetic_sources_equal_the_reference_generator():
    """``synthetic_requests(source_shape=...)`` draws the reference's
    bytes: lengths full, -1, -2 by rid, the same gaussians."""
    _, cfg = _cfgs()
    shape = R.source_shape(cfg)
    mine = E.synthetic_requests(7, rate_per_s=50.0, vocab=cfg.vocab,
                                seed=3, source_shape=shape)
    ref = JE.synthetic_requests(7, rate_per_s=50.0, vocab=cfg.vocab,
                                seed=3, source_shape=shape)
    assert shape == JR.source_shape(_cfgs()[0]) == (16, cfg.d_model)
    for a, b in zip(mine, ref):
        assert (a.rid, a.prompt, a.arrival_s) == (b.rid, b.prompt,
                                                  b.arrival_s)
        assert a.source.dtype == b.source.dtype
        assert a.source.tobytes() == b.source.tobytes()
    assert [r.source.shape[0] for r in mine] == [16, 15, 14, 16, 15, 14, 16]


def test_registry_answers_as_the_reference():
    jcfg, cfg = _cfgs()
    assert R.needs_prime(cfg) and JR.needs_prime(jcfg)
    assert R.source_len(cfg) == JR.source_len(jcfg) == 16
    assert R.supports_paging(cfg) == JR.supports_paging(jcfg) is True
    assert R.supports_speculation(cfg) == JR.supports_speculation(jcfg) \
        is False
    cache = R.init_paged_cache(cfg, 2, 8, 4, 5, device="cpu")
    jcache = JR.init_paged_cache(jcfg, 2, 8, 4, 5)
    assert R.cache_batch_axes(cfg, cache) == JR.cache_batch_axes(jcfg,
                                                                 jcache)
    assert R.paged_block_axes(cfg, cache) == JR.paged_block_axes(jcfg,
                                                                 jcache)
    for k, v in jcache.items():
        assert tuple(cache[k].shape) == v.shape
        assert str(cache[k].dtype).split(".")[-1] == str(v.dtype)


@pytest.mark.parametrize("case", [
    "missing", "wrong_width", "too_long", "empty", "flat"])
def test_source_validation_matches_the_reference(setup, case):
    """The engine checks every request's source before admitting anything,
    with the reference's messages."""
    jcfg, cfg, params = setup
    _, tp = params["w8a16"]
    d = cfg.d_model
    source = {"missing": None,
              "wrong_width": np.zeros((4, d + 1), np.float32),
              "too_long": np.zeros((cfg.enc_seq + 1, d), np.float32),
              "empty": np.zeros((0, d), np.float32),
              "flat": np.zeros((d,), np.float32)}[case]
    good = _requests(cfg, 1)[0]
    req = dataclasses.replace(good, rid=5, source=source)
    jreq = JD.EngineRequest(rid=5, prompt=req.prompt, max_new_tokens=GEN,
                            source=source)
    with pytest.raises(ValueError) as want:
        JD._validate_source(jcfg, jreq)
    eng = E.Engine(cfg, tp, mode=W8A16, num_slots=2, max_seq=MAX_SEQ,
                   device="cpu")
    with pytest.raises(ValueError) as got:
        eng.serve([good, req])
    assert str(got.value) == str(want.value)
    assert eng._cache is None       # nothing was admitted


# (paged, temperature)
SERVES = {"contiguous": (False, 0.0), "paged": (True, 0.0),
          "contiguous_sampled": (False, 0.8), "paged_sampled": (True, 0.8)}


@pytest.fixture(scope="module")
def trace(setup):
    """Ten requests through four slots (slot reuse), their sources 16,
    15 or 14 frames long, and the port's sequential reference, greedy
    and sampled."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs = _requests(cfg, 10)
    want = {t: E.reference_outputs(
        cfg, tp, reqs, mode=W8A16, max_seq=MAX_SEQ, device="cpu",
        temperature=t, rng=PRNGKey(3) if t else None) for t in (0.0, 0.8)}
    return reqs, want


def _engine(cfg, params, paged=False, temperature=0.0, **kw):
    kw.setdefault("num_slots", 4)
    if paged:
        kw.setdefault("block_size", 4)
    return E.Engine(cfg, params, mode=W8A16, max_seq=MAX_SEQ,
                    prefill_chunk=4, device="cpu", temperature=temperature,
                    rng=PRNGKey(3) if temperature else None, **kw)


@pytest.mark.parametrize("case", list(SERVES))
def test_engine_equals_reference_bit_for_bit(setup, trace, case):
    """``Engine.serve`` with chunked prefill of 4 (each admission primes
    the slot's cross row first): every request's tokens equal the
    sequential batch-1 reference's, contiguous and paged, greedy and
    sampled, through slot reuse; the warmed-up engine serves the same."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs, want = trace
    paged, t = SERVES[case]
    eng = _engine(cfg, tp, paged, t)
    rep = eng.serve(reqs)
    assert rep.outputs() == want[t]
    assert {r.slot for r in rep.results} == set(range(4))
    assert rep.leaked_blocks == 0
    eng.warmup()
    assert eng.serve(reqs).outputs() == want[t]


@pytest.mark.parametrize("paged", [False, True])
def test_preemption_resume_reprimes(setup, trace, paged):
    """Interactive heads evict batch slots from a two-slot pool; every
    resumed request, re-primed from its own source over a slot another
    tenant primed since, equals the reference."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs, want = trace
    reqs = [dataclasses.replace(
        r, priority="batch" if r.rid % 3 == 0 else "interactive")
        for r in reqs]
    rep = _engine(cfg, tp, paged, num_slots=2).serve(reqs, preemption=True)
    assert rep.preempted > 0
    assert rep.outputs() == want[0.0]
    assert rep.leaked_blocks == 0


def test_nonfinite_recovery_scrubs_and_reprimes(setup, trace):
    """A non-finite sample scrubs the slot (its self rows and its cross
    row, xlen included) and resumes it by preemption: the victim is
    re-primed and its tokens still equal the reference."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs, want = trace
    plan = E.FaultPlan([E.Fault(tick=6, kind="nan_logits", slot=1)])
    rep = _engine(cfg, tp, True).serve(reqs, fault_plan=plan)
    assert rep.nonfinite_samples == 1 and rep.preempted == 1
    assert rep.outputs() == want[0.0]


def test_sources_seed_the_prefix_keys(setup):
    """Two requests with equal prompts share no prefix block when their
    sources differ (the self k/v depends on the source), and share when
    the sources are equal."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    base = _requests(cfg, 2, shared_prefix_len=PROMPT)
    assert base[0].prompt == base[1].prompt
    # the second arrives once the first's chunk has written (and
    # registered) its first block, while the first still holds it
    base = [dataclasses.replace(r, arrival_s=0.003 * r.rid) for r in base]
    same = [base[0], dataclasses.replace(base[1], source=base[0].source)]
    for reqs, shared in ((base, 0), (same, 1)):
        eng = _engine(cfg, tp, True)
        rep = eng.serve(reqs)
        assert sum(r.shared_blocks for r in rep.results) == shared
        assert rep.outputs() == E.reference_outputs(
            cfg, tp, reqs, mode=W8A16, max_seq=MAX_SEQ, device="cpu")


def test_source_seed_is_made_once_a_source(setup, trace, monkeypatch):
    """Admission prices every pending request's prefix keys each tick; a
    source's seed (its shape and bytes) is made once however often it is
    priced, and the serve still equals the reference."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs, want = trace
    made, real = [], D.DispatchCore._source_seed

    def spy(self, source):
        before = len(self._source_seeds)
        seed = real(self, source)
        made.append(len(self._source_seeds) > before)
        assert real(self, source) is seed
        return seed

    monkeypatch.setattr(D.DispatchCore, "_source_seed", spy)
    # 6 usable blocks of 4: two requests of 6 + 4 tokens at a time
    rep = _engine(cfg, tp, True, num_blocks=7).serve(reqs)
    assert rep.outputs() == want[0.0]
    assert sum(made) == len(reqs) < len(made)


def test_engine_refuses_speculation():
    _, cfg = _cfgs()
    params = R.init_quantized(torch.Generator().manual_seed(0), cfg,
                              device="cpu")
    with pytest.raises(ValueError, match="speculative"):
        E.Engine(cfg, params, mode=W8A16, spec_k=2, draft_layers=1,
                 device="cpu")


def test_primed_cross_kv_isolated_and_scrubbed_on_reuse(setup):
    """The prime contract (the reference's test of the same name):
    (a) poisoned cross k/v in inactive rows never changes the active
    rows' samples or self-cache writes; (b) poison past an active row's
    own xlen is never read; (c) decode never writes xk, xv or xlen (the
    poison comes back bitwise); (d) re-priming a poisoned row overwrites
    it whole: the new tenant decodes as in a fresh pool."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    step = ST.jit_slot_decode_step(ST.make_slot_decode_step(cfg, mode=W8A16))
    prime = ST.jit_prime_step(ST.make_prime_step(cfg, mode=W8A16))
    S, smax, src_max = 4, 32, R.source_len(cfg)

    def src_for(seed, n):
        buf = np.zeros((1, src_max, cfg.d_model), np.float32)
        buf[0, :n] = np.random.default_rng(seed).standard_normal(
            (n, cfg.d_model))
        return torch.from_numpy(buf).to(torch.bfloat16)

    n0, n2 = src_max, src_max - 2
    cache = R.init_cache(cfg, S, smax, device="cpu")
    prime(tp, src_for(7, n0), cache, 0, n0)
    prime(tp, src_for(8, n2), cache, 2, n2)
    idx = torch.tensor([1, 0, 2, 1], dtype=torch.int32)
    active = torch.tensor([True, False, True, False])
    tokens = torch.tensor([[5], [1], [9], [2]], dtype=torch.int32)

    def run(c):
        c = {k: v.clone() for k, v in c.items()}
        nxt, c, i = step(tp, tokens, c, idx, active)
        return nxt.clone(), c, i.clone()

    n1, c1, i1 = run(cache)
    poisoned = {k: v.clone() for k, v in cache.items()}
    for leaf in ("xk", "xv"):
        poisoned[leaf][:, 1] = 107.0          # dead rows: the whole row
        poisoned[leaf][:, 3] = -9.0
        poisoned[leaf][:, 2, n2:] = 55.0      # active short row: its tail
    poisoned["xlen"][1] = 9999
    poisoned["xlen"][3] = -5
    n2_, c2, i2 = run(poisoned)
    assert torch.equal(n1[active], n2_[active])
    assert torch.equal(i1, i2)
    for k in c1:
        if k in ("xk", "xv", "xlen"):
            assert torch.equal(c2[k], poisoned[k]), k
        else:
            assert torch.equal(c1[k][:, active], c2[k][:, active]), k

    nB = src_max - 1
    reused = {k: v.clone() for k, v in c2.items()}
    prime(tp, src_for(9, nB), reused, 1, nB)
    fresh = R.init_cache(cfg, S, smax, device="cpu")
    prime(tp, src_for(9, nB), fresh, 1, nB)
    for k in ("xk", "xv", "xlen"):
        assert torch.equal(reused[k][(slice(None),) * (k != "xlen") + (1,)],
                           fresh[k][(slice(None),) * (k != "xlen") + (1,)])
    tok2 = torch.tensor([[5], [7], [9], [2]], dtype=torch.int32)
    only1 = torch.tensor([False, True, False, False])
    zero = torch.zeros((S,), dtype=torch.int32)
    nr = step(tp, tok2, reused, zero, only1)[0].clone()
    nf = step(tp, tok2, fresh, zero, only1)[0].clone()
    assert int(nr[1]) == int(nf[1])


def test_serve_cli_runs_whisper(capsys):
    """``python -m repro_torch.launch.serve --arch whisper-medium`` on the
    CPU, paged: the curve's forward takes the frames of ``input_specs``,
    the decode loop runs, the engine serves every request."""
    from repro_torch.launch import serve

    res = serve.run(serve.parse_args([
        "--arch", ARCH, "--reduced", "--device", "cpu", "--max-batch", "4",
        "--seq", "8", "--deadline-ms", "60000", "--n-requests", "6",
        "--prefill-chunk", "4", "--prompt-len", "8", "--block-size", "4",
        "--decode-tokens", "4"]))
    out = capsys.readouterr().out
    assert res.code == 0, out
    assert res.decode_tokens_per_s and res.decode_tokens_per_s > 0
    rep = res.report
    assert len(rep.results) == 6 and all(r.status == "ok"
                                         for r in rep.results)
    assert all(r.source is not None for r in res.requests)
    assert rep.outputs() == E.reference_outputs(
        res.cfg, res.params, res.requests, mode=W8A16,
        max_seq=res.engine.max_seq, device="cpu")
