"""The port's full-sequence forward (flash attention), its bf16 KV cache
and the serve launcher's steps against the JAX package, on the CPU at
reduced size.

The same weights go into both packages (the reference's ``init`` and
``quantize_tree``, copied through numpy by ``models/bridge.py``); inputs
come from numpy with a seed.  Where the JAX function reaches a Pallas
kernel it runs in interpret mode, or through its oracle as the model does
on the CPU; the port's CPU path is each kernel's plain version.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.core.qlinear import FP as JFP
from repro.core.qlinear import W8A8 as JW8A8
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.kernels import flash_attention as JFA
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import registry as JR
from repro.runtime import steps as JST
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.core.qlinear import FP, W8A8, W8A16
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST

from test_torch_model import LOGIT_ATOL, to_numpy

# W8A8 logits against the JAX forward.  The bf16 activations of the two
# frameworks differ by an ulp here and there (f32 sums in other orders,
# see LOGIT_ATOL); under W8A8 such an ulp can move an activation across an
# int8 rounding boundary, a step of amax/127 of the whole tensor, so the
# logits (range about +-4.3 at this size) part by more: 0.08 measured.
# 0.2 bounds that; a wrong scale, mask or head mapping moves them by O(1).
W8A8_LOGIT_ATOL = 0.2
MODES = {"fp": (FP, JFP), "w8a16": (W8A16, JW8A16), "w8a8": (W8A8, JW8A8)}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the flash-attention kernel's plain version
# ---------------------------------------------------------------------------

# (BH, Sq, Skv, hd, causal, window, kv_len)
FLASH_CASES = [
    (3, 64, 64, 32, True, None, None),       # causal, the forward's form
    (2, 48, 48, 64, True, 16, None),         # sliding window
    (2, 40, 64, 32, True, None, 50),         # kv_len < Skv, ragged Sq
    (1, 37, 90, 128, False, None, 77),       # non-causal, all ragged
    (2, 33, 33, 16, True, 5, 20),            # window and kv_len together
]
BLK = 16


def _pad(a, mult, axis):
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, (-a.shape[axis]) % mult)
    return np.pad(a, pad)


@pytest.mark.parametrize("bh,sq,skv,hd,causal,window,kv_len", FLASH_CASES)
def test_flash_plain_matches_jax(bh, sq, skv, hd, causal, window, kv_len):
    """f32 in and out.  Against the JAX oracle (the same dense f32 softmax,
    other summation orders) to 1e-5; against the Pallas kernel in
    interpret mode (online softmax over 16-key blocks, padded to block
    multiples with the padding masked by kv_len) to 2e-5, as
    tests/test_kernels.py holds the kernel to its oracle."""
    rng = np.random.default_rng(bh * 100 + sq + skv)
    q = rng.normal(size=(bh, sq, hd)).astype(np.float32)
    k = rng.normal(size=(bh, skv, hd)).astype(np.float32)
    v = rng.normal(size=(bh, skv, hd)).astype(np.float32)
    kvl = skv if kv_len is None else kv_len
    got = FA.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, kv_len=kv_len,
        out_dtype=torch.float32).numpy()
    oracle = np.asarray(JREF.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, kv_len=kvl, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-5)
    interp = np.asarray(JFA.flash_attention_bhsd(
        jnp.asarray(_pad(q, BLK, 1)), jnp.asarray(_pad(k, BLK, 1)),
        jnp.asarray(_pad(v, BLK, 1)), blk_q=BLK, blk_k=BLK, causal=causal,
        window=window, kv_len=kvl, sm_scale=hd ** -0.5,
        out_dtype=jnp.float32, interpret=True))[:, :sq]
    np.testing.assert_allclose(got, interp, rtol=2e-5, atol=2e-5)
    if kv_len is not None and kv_len < sq and causal and window is None:
        assert (got[:, kv_len:] != 0).any()      # rows past kv_len see keys


def test_flash_plain_row_without_keys_is_zero():
    q = torch.randn(1, 4, 32)
    k = torch.randn(1, 4, 32)
    out = FA.flash_attention_ref(q, k, k, causal=True, kv_len=0,
                                 out_dtype=torch.float32)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("window", [None, 8])
def test_ops_flash_attention_matches_jax(window):
    """(B, S, H, hd) bf16 in and out through ops.flash_attention, against
    the JAX entry point on the CPU (its oracle): f32 inside both, so the
    bf16 outputs differ by at most one bf16 ulp (2^-8 relative)."""
    rng = np.random.default_rng(2)
    b, s, h, hd = 2, 24, 4, 32
    q, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(JOPS.flash_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
        causal=True, window=window)).astype(np.float32)
    got = ops.flash_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=True, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == (b, s, h, hd)
    got = got.float().numpy()
    assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want) + 1e-6).all()


def test_flash_kernel_wrapper_takes_only_cuda_tensors():
    q = torch.zeros(1, 4, 32, dtype=torch.bfloat16)
    calls = FA.flash_attention_ref.calls
    with pytest.raises(ValueError, match="CUDA"):
        FA.flash_attention_bhsd(q, q, q)
    assert FA.flash_attention_ref.calls == calls


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    return (dataclasses.replace(jget_config("starcoder2-3b").reduced(), **kw),
            dataclasses.replace(get_config("starcoder2-3b").reduced(), **kw))


@pytest.fixture(scope="module")
def setup():
    """Reduced starcoder2-3b with the bf16 KV cache (kv_quant off, as the
    serve CLI runs it): f32 and int8 params, in both packages."""
    jcfg, cfg = _cfgs()
    jfp = JR.init(jax.random.PRNGKey(0), jcfg)
    jq = jquantize_tree(jfp, min_size=2048)
    tfp = bridge.params_from_numpy(to_numpy(jfp), device="cpu")
    tq = bridge.params_from_numpy(to_numpy(jq), device="cpu")
    return jcfg, cfg, {"fp": (jfp, tfp), "w8a16": (jq, tq),
                       "w8a8": (jq, tq)}


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(
        1, vocab, (b, s)).astype(np.int32)


def _check_logits(got, want, atol):
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= atol
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > atol
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])


@pytest.mark.parametrize("window", [None, 8])
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_jitted_reference(setup, mode, window):
    """The port's forward against the JAX forward under jax.jit (the serve
    CLI's prefill step), same weights, (2, 16) tokens: logits within
    LOGIT_ATOL (W8A8: W8A8_LOGIT_ATOL) and greedy tokens equal wherever
    the reference's top-2 gap is outside it.  ``window`` runs the
    sliding-window mask through the same forward."""
    _, _, params = setup
    jcfg, cfg = _cfgs(window=window)
    tm, jm = MODES[mode]
    jp, tp = params[mode]
    toks = _tokens(0, 2, 16, jcfg.vocab)
    want = np.asarray(jax.jit(lambda p, t: JR.apply_forward(
        p, jcfg, {"tokens": t}, mode=jm, remat=False))(
            jp, jnp.asarray(toks)))
    got = ST.make_prefill_step(cfg, mode=tm)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _check_logits(got.numpy(), want,
                  W8A8_LOGIT_ATOL if mode == "w8a8" else LOGIT_ATOL)


def test_forward_runs_the_flash_entry_point(setup, monkeypatch):
    """Every attention layer of the forward goes through
    ops.flash_attention, causal, with the config's window."""
    _, cfg, params = setup
    seen = []
    real = ops.flash_attention

    def spy(*a, **kw):
        seen.append((kw["causal"], kw["window"]))
        return real(*a, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    calls = FA.flash_attention_ref.calls
    R.apply_forward(params["w8a16"][1], cfg,
                    {"tokens": torch.ones((1, 4), dtype=torch.int32)},
                    mode=W8A16)
    assert seen == [(True, None)] * cfg.n_layers
    assert FA.flash_attention_ref.calls == calls + cfg.n_layers


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_bf16_cache_decode_step_matches_reference(setup, mode):
    """Eight decode steps from the bf16 cache, four rows at ragged per-row
    positions: logits within the forward's tolerance of the JAX
    decode_step (its CPU path is the same bf16-rounded einsum the port
    writes; they differ in f32 summation order, and under W8A8 through
    the int8 rounding of activations), greedy tokens equal where the
    reference's top-2 gap is outside it, and the caches' bytes equal."""
    jcfg, cfg, params = setup
    tm, jm = MODES[mode]
    jp, tp = params[mode]
    b, smax, steps = 4, 16, 8
    rng = np.random.default_rng(1)
    tokens = rng.integers(1, jcfg.vocab, (steps, b, 1)).astype(np.int32)
    start = np.array([0, 3, 7, 1], np.int32)
    jdecode = jax.jit(JST.make_decode_step(jcfg, mode=jm))
    jcache = JR.init_cache(jcfg, b, smax)
    tcache = R.init_cache(cfg, b, smax, device="cpu")
    assert set(tcache) == set(jcache) == {"k", "v"}
    assert tcache["k"].dtype == torch.bfloat16
    decode = ST.make_decode_step(cfg, mode=tm)
    atol = W8A8_LOGIT_ATOL if mode == "w8a8" else LOGIT_ATOL
    for s in range(steps):
        idx = start + s
        jl, jcache = jdecode(jp, {"tokens": jnp.asarray(tokens[s]),
                                  "cache_index": jnp.asarray(idx)}, jcache)
        tl, tcache = decode(tp, {"tokens": torch.from_numpy(tokens[s]),
                                 "cache_index": torch.from_numpy(idx)},
                            tcache)
        _check_logits(tl.numpy(), np.asarray(jl), atol)
    # both wrote the same positions; the first layer's k and v (one
    # projection of the same embeddings) agree to a bf16 ulp
    for name in ("k", "v"):
        jc = np.asarray(jcache[name]).astype(np.float32)
        tc = tcache[name].float().numpy()
        assert ((jc == 0) == (tc == 0)).all()
        assert (np.abs(tc[0] - jc[0]) <= 2.0 ** -7 * np.abs(jc[0])
                + 1e-6).all()


@pytest.mark.parametrize("mode", ["fp", "w8a16"])
def test_decode_matches_forward(setup, mode):
    """Stepwise decode from the bf16 cache reproduces the teacher-forced
    forward's logits, as tests/test_models.py asks of the reference: the
    relative gap stays under 0.05 of the logits' scale."""
    _, cfg, params = setup
    tm, _ = MODES[mode]
    tp = params[mode][1]
    toks = torch.from_numpy(_tokens(3, 2, 8, cfg.vocab))
    ref = R.apply_forward(tp, cfg, {"tokens": toks}, mode=tm)
    cache = R.init_cache(cfg, 2, 32, device="cpu")
    outs = []
    for i in range(8):
        lg, cache = R.apply_decode(tp, cfg, {"tokens": toks[:, i:i + 1],
                                             "cache_index": i}, cache,
                                   mode=tm)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    scale = float(ref.abs().max()) + 1e-9
    assert float((dec - ref).abs().max()) / scale < 0.05


@pytest.mark.parametrize("mode", ["w8a16", "w8a8"])
def test_decode_loop_equals_per_token_loop(setup, mode):
    """make_decode_loop is the per-token greedy loop at the same batch:
    the same tokens and the same cache bytes."""
    _, cfg, params = setup
    tm, _ = MODES[mode]
    tp = params[mode][1]
    b, n = 3, 6
    seed = torch.from_numpy(_tokens(4, b, 1, cfg.vocab))
    cache_a = R.init_cache(cfg, b, 16, device="cpu")
    out, cache_a = ST.make_decode_loop(cfg, mode=tm, num_tokens=n)(
        tp, seed, cache_a, 2)
    assert out.shape == (b, n) and out.dtype == torch.int32
    cache_b = R.init_cache(cfg, b, 16, device="cpu")
    decode = ST.make_decode_step(cfg, mode=tm)
    tok, toks = seed, []
    for i in range(n):
        logits, cache_b = decode(tp, {"tokens": tok, "cache_index": 2 + i},
                                 cache_b)
        tok = ST.greedy_sample(logits)[:, None]
        toks.append(tok[:, 0])
    assert torch.equal(out, torch.stack(toks, dim=1))
    for name in cache_a:
        assert torch.equal(cache_a[name], cache_b[name])


def test_input_specs_match_reference():
    jcfg, cfg = _cfgs()
    for kind in ("train", "prefill", "decode"):
        mine = cfg.input_specs(ShapeSpec("s", 32, 4, kind))
        ref = jcfg.input_specs(JShapeSpec("s", 32, 4, kind))
        assert mine.keys() == ref.keys()
        for name, (shape, dtype) in mine.items():
            assert shape == ref[name].shape
            assert str(dtype).split(".")[-1] == str(ref[name].dtype)
    # encdec adds its stub frame embeddings, vlm its stub patch embeddings
    for family, extra in (("encdec", "encoder_embeds"),
                          ("vlm", "vision_embeds")):
        for kind in ("train", "prefill", "decode"):
            mine = dataclasses.replace(cfg, family=family).input_specs(
                ShapeSpec("s", 32, 4, kind))
            ref = dataclasses.replace(jcfg, family=family).input_specs(
                JShapeSpec("s", 32, 4, kind))
            assert mine.keys() == ref.keys() and extra in mine
            for name, (shape, dtype) in mine.items():
                assert shape == ref[name].shape
                assert str(dtype).split(".")[-1] == str(ref[name].dtype)


# ---------------------------------------------------------------------------
# the engine on the bf16 cache
# ---------------------------------------------------------------------------

PROMPT, GEN = 5, 6


@pytest.mark.parametrize("chunk", [4, None])
def test_bf16_engine_equals_reference_bit_for_bit(setup, chunk):
    """24 requests through 4 slots on the bf16 cache, with chunked or
    per-token prefill: every request's tokens equal the sequential batch-1
    reference exactly."""
    _, cfg, params = setup
    tp = params["w8a16"][1]
    reqs = E.synthetic_requests(24, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=PROMPT, max_new_tokens=GEN)
    eng = E.Engine(cfg, tp, mode=W8A16, num_slots=4, max_seq=PROMPT + GEN,
                   prefill_chunk=chunk, device="cpu")
    rep = eng.serve(reqs)
    assert rep.outputs() == E.reference_outputs(
        cfg, tp, reqs, mode=W8A16, max_seq=eng.max_seq, device="cpu")
    assert all(r.status == "ok" and len(r.tokens) == GEN
               for r in rep.results)
    assert rep.admissions_while_busy > 0
    assert rep.kv_hbm_bytes == 2 * cfg.n_layers * 4 * eng.max_seq \
        * cfg.n_kv_heads * cfg.head_dim * 2


def test_bf16_engine_matches_jax_engine(setup):
    """The port's engine and the JAX engine on the bf16 cache, same
    weights and trace: greedy tokens equal, except that a request may part
    ways at a step where the JAX reference's top-2 gap is within
    LOGIT_ATOL, after which the two decode different inputs."""
    jcfg, cfg, params = setup
    jq, tq = params["w8a16"]
    reqs = E.synthetic_requests(16, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=PROMPT, max_new_tokens=GEN)
    jreqs = JE.synthetic_requests(16, rate_per_s=2000.0, vocab=cfg.vocab,
                                  prompt_len=PROMPT, max_new_tokens=GEN)
    got = E.Engine(cfg, tq, mode=W8A16, num_slots=4, max_seq=16,
                   prefill_chunk=4, device="cpu").serve(reqs).outputs()
    jeng = JE.Engine(jcfg, jq, mode=JW8A16, num_slots=4, max_seq=16,
                     prefill_chunk=4)
    want = jeng.serve(jreqs).outputs()
    margins = {}
    E.reference_outputs(cfg, tq, reqs, mode=W8A16, max_seq=16,
                        device="cpu", margins=margins)
    parted = 0
    for rid, toks in want.items():
        first = next((i for i, (a, b) in enumerate(zip(got[rid], toks))
                      if a != b), None)
        if first is None:
            continue
        assert margins[rid][first] <= LOGIT_ATOL, (rid, first)
        parted += 1
    assert parted <= len(want) // 4, parted


def test_engine_warmup_leaves_serving_unchanged(setup):
    _, cfg, params = setup
    tp = params["w8a16"][1]
    reqs = E.synthetic_requests(6, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=PROMPT, max_new_tokens=3)
    eng = E.Engine(cfg, tp, mode=W8A16, num_slots=2, max_seq=8,
                   prefill_chunk=4, device="cpu")
    before = eng.serve(reqs).outputs()
    eng.warmup()
    assert eng.serve(reqs).outputs() == before


def test_paged_bf16_decode_step_equals_contiguous_bitwise(setup):
    """The paged bf16 cache: the same tokens decoded into shuffled physical
    blocks and into contiguous rows, one token a step and then causal
    passes of three (as the chunk step runs), give bit-identical logits,
    and the rows gathered through the tables equal the contiguous rows
    byte for byte up to each frontier."""
    _, cfg, params = setup
    tp = params["w8a16"][1]
    b, smax, bs = 3, 16, 4
    nb = b * (smax // bs) + 2
    tables = np.random.default_rng(2).permutation(np.arange(1, nb))[
        :b * (smax // bs)].reshape(b, smax // bs).astype(np.int32)
    paged = R.init_paged_cache(cfg, b, smax, bs, nb, device="cpu")
    assert set(paged) == {"k", "v", "block_tables"}
    assert paged["k"].dtype == torch.bfloat16
    assert paged["k"].shape == (cfg.n_layers, nb, bs, cfg.n_kv_heads,
                                cfg.head_dim)
    paged["block_tables"].copy_(torch.from_numpy(tables))
    contig = R.init_cache(cfg, b, smax, device="cpu")
    rng = np.random.default_rng(3)
    pos = torch.tensor([0, 5, 2], dtype=torch.int32)
    for s in (1, 1, 3, 1, 3):
        toks = torch.from_numpy(_tokens(int(rng.integers(1 << 30)), b, s,
                                        cfg.vocab))
        lp, _ = R.apply_decode(tp, cfg, {"tokens": toks, "cache_index": pos},
                               paged, mode=W8A16, causal=True)
        lc, _ = R.apply_decode(tp, cfg, {"tokens": toks, "cache_index": pos},
                               contig, mode=W8A16, causal=True)
        assert torch.equal(lp, lc)
        pos = pos + s
    for key in ("k", "v"):
        for layer in range(cfg.n_layers):
            got = paged[key][layer][torch.from_numpy(tables).long()].reshape(
                b, smax, cfg.n_kv_heads, cfg.head_dim)
            for r in range(b):
                n = int(pos[r])
                assert torch.equal(got[r, :n], contig[key][layer][r, :n])


def test_paged_bf16_engine_equals_contiguous_bitwise(setup):
    """The engine on the paged bf16 cache — 24 requests sharing a prompt
    block, through 4 slots and a pool below the worst case — gives every
    request the tokens of the contiguous bf16 engine and of the sequential
    reference, bit for bit; it shares prefix blocks, leaks none, and
    counts the bf16 leaves in its resident bytes."""
    _, cfg, params = setup
    tp = params["w8a16"][1]
    reqs = E.synthetic_requests(24, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=PROMPT, max_new_tokens=GEN,
                                shared_prefix_len=4)
    kw = dict(mode=W8A16, num_slots=4, max_seq=PROMPT + GEN,
              prefill_chunk=4, device="cpu")
    contig = E.Engine(cfg, tp, **kw).serve(reqs)
    eng = E.Engine(cfg, tp, block_size=4, num_blocks=9, **kw)
    rep = eng.serve(reqs)
    assert rep.outputs() == contig.outputs() == E.reference_outputs(
        cfg, tp, reqs, mode=W8A16, max_seq=eng.max_seq, device="cpu")
    assert rep.shared_block_hits > 0 and rep.leaked_blocks == 0
    assert rep.peak_blocks_used <= 8
    assert rep.kv_hbm_bytes == 2 * cfg.n_layers * 9 * 4 * cfg.n_kv_heads \
        * cfg.head_dim * 2 + 4 * (eng.max_seq // 4) * 4
