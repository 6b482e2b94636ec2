"""The port's ssm family (mamba2-1.3b) against the JAX package, on the CPU
at reduced size (2 layers, d 128, d_inner 256, 8 SSD heads of 32, state
N 16, chunk 16, conv width 4, vocab 512), and its engine against its own
sequential reference.

The same weights go into both packages (the reference's ``init`` and
``quantize_tree``, copied through numpy by ``models/bridge.py``); tokens
come from numpy with a seed.  Sequences are 20 tokens long, past the
reduced chunk of 16, so the chunked forward runs its inter-chunk
recurrence and pads its last chunk.

The port's engine is held to the port's ``reference_outputs`` bit for
bit, and to the JAX engine token for token up to the first step where a
reference top-2 gap is within the logit tolerance.
"""
import dataclasses
import warnings

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
from repro.models import registry as JR
from repro.runtime import steps as JST
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import FP, W8A16
from repro_torch.core.quant import QTensor, quantize_tree
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.models import ssm as S
from repro_torch.runtime import steps as ST
from repro_torch.runtime.prng import PRNGKey

from test_torch_engine import _jax_reference_with_margins
from test_torch_forward import _check_logits
from test_torch_model import LOGIT_ATOL, to_numpy

ARCH = "mamba2-1.3b"
MODES = {"fp": (FP, JFP), "w8a16": (W8A16, JW8A16)}
SEQ = 20                 # past the reduced ssm_chunk of 16: a padded chunk
MAX_SEQ = 16
PROMPT, GEN = 6, 4
# State tolerance against the JAX package, after 20 steps: h (f32, |h|
# up to about 0.7 here) and the conv tail (bf16, up to about 3).  Both
# packages compute from the same bf16 projections, but a projection or a
# conv output may land one bf16 ulp apart (another summation order in the
# matmul, or an XLA fusion that skips a bf16 rounding): the conv tail then
# differs by one ulp (0.0156 in [2, 4)) and h by under 0.005 (seen:
# 0.0046).  0.02 bounds both; a wrong decay, scrub or conv tap moves them
# by O(0.1) or more.
STATE_ATOL = 0.02


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


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# config, params, cache
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    j, t = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert (t.d_inner, t.ssm_heads, t.param_count()) == \
        (j.d_inner, j.ssm_heads, j.param_count())


def test_bridge_splits_the_layer_stack(setup):
    """The reference's stacked layers become a list; in_proj and out_proj
    and the table are int8, conv_w and the per-head vectors stay f32 (the
    quantizer's path rule takes ``.w``, not ``_w``)."""
    _, cfg, params = setup
    _, tq = params["w8a16"]
    assert len(tq["layers"]) == cfg.n_layers
    lp = tq["layers"][1]
    assert isinstance(lp["in_proj"]["w"], QTensor)
    assert isinstance(lp["out_proj"]["w"], QTensor)
    assert isinstance(tq["embed"]["table"], QTensor)
    assert lp["in_proj"]["w"].values.shape == (
        cfg.d_model, 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads)
    for k in ("conv_w", "conv_b", "a_log", "dt_bias", "D"):
        assert lp[k].dtype == torch.float32, k
    # at full width conv_w passes min_size and is still left f32
    full = get_config(ARCH)
    w = torch.zeros((full.conv_width, full.d_inner + 2 * full.ssm_state))
    assert w.numel() >= 2048
    assert not isinstance(quantize_tree({"layers": [{"conv_w": w}]},
                                        min_size=2048)["layers"][0]["conv_w"],
                          QTensor)


def test_init_quantized_is_quantize_tree_of_init():
    """The streamed init quantizes the leaves the whole-tree quantizer
    would, bit for bit, from the same draws."""
    _, cfg = _cfgs()
    whole = quantize_tree(S.init(torch.Generator().manual_seed(3), cfg,
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


def test_cache_and_registry_answer_as_the_reference():
    """The cache's leaves have the reference's shapes and dtypes; the
    registry refuses paging and speculation as the reference's does, keeps
    the slot axis at 1, and steps a chunk token by token."""
    jcfg, cfg = _cfgs()
    jc = JR.init_cache(jcfg, 3, MAX_SEQ)
    tc = R.init_cache(cfg, 3, MAX_SEQ, device="cpu")
    assert set(tc) == set(jc) == {"h", "conv"}
    for k, v in jc.items():
        assert tuple(tc[k].shape) == v.shape
        assert str(tc[k].dtype).split(".")[-1] == str(v.dtype)
        assert not tc[k].any()
    assert R.cache_batch_axes(cfg, tc) == JR.cache_batch_axes(jcfg, jc) == \
        {"h": 1, "conv": 1}
    assert R.supports_paging(cfg) is JR.supports_paging(jcfg) is False
    assert R.supports_speculation(cfg) is JR.supports_speculation(jcfg) \
        is False
    assert not R.supports_self_draft(cfg)
    assert not R.needs_prime(cfg) and R.source_shape(cfg) is None
    assert not R.decodes_chunk_in_one_pass(cfg)
    with pytest.raises(ValueError, match="paged KV cache"):
        R.init_paged_cache(cfg, 2, MAX_SEQ, 4, 9, device="cpu")


def test_mask_inactive_slots_matches_reference():
    """The out-of-place freeze hook: inactive rows of ``new`` replaced by
    ``old``'s, bitwise the reference's."""
    jcfg, cfg = _cfgs()
    shapes = {k: v.shape for k, v in JR.init_cache(jcfg, 4, 8).items()}
    rng = np.random.default_rng(2)
    old = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    new = {k: rng.standard_normal(s).astype(np.float32)
           for k, s in shapes.items()}
    active = np.array([True, False, True, False])
    want = JR.mask_inactive_slots(
        jcfg, {k: jnp.asarray(v) for k, v in old.items()},
        {k: jnp.asarray(v) for k, v in new.items()}, jnp.asarray(active))
    got = R.mask_inactive_slots(
        cfg, {k: torch.from_numpy(v) for k, v in old.items()},
        {k: torch.from_numpy(v) for k, v in new.items()},
        torch.from_numpy(active))
    for k in shapes:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got[k].numpy()[:, 1], old[k][:, 1])


def test_softplus_is_jax_softplus():
    """``ssm.softplus`` is logaddexp(x, 0), as ``jax.nn.softplus``: the
    same f32 values to a few ulps across the range (past F.softplus's
    threshold of 20 too)."""
    x = np.linspace(-60.0, 60.0, 4001, dtype=np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = S.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=4e-7, atol=1e-30)
    assert (got >= 0).all() and np.array_equal(got[x > 20], x[x > 20])


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_reference(setup, mode):
    """The chunked full-sequence forward (the service curve's prefill),
    (2, 20) tokens: two chunks of 16, the second padded, and the state
    carried between them; logits within LOGIT_ATOL and greedy tokens
    equal wherever the reference's top-2 gap is outside it."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    toks = _tokens(3, 2, SEQ, cfg.vocab)
    want = np.asarray(jax.jit(lambda p, t: JR.apply_forward(
        p, jcfg, {"tokens": t}, mode=jm, remat=False))(jp, jnp.asarray(toks)))
    got = ST.make_prefill_step(cfg, mode=tm)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _check_logits(got.numpy(), want, LOGIT_ATOL)


@pytest.mark.parametrize("mode", list(MODES))
def test_decode_step_matches_reference_per_row(setup, mode):
    """The slot engine's per-row decode: two rows at positions (B,) 0 and
    3 (row 0 scrubs its zero state, row 1 carries random state at once),
    20 steps of the same tokens in both packages; logits within
    LOGIT_ATOL at every step, greedy tokens equal where the reference's
    top-2 gap is outside it, and the state within STATE_ATOL at the
    end."""
    jcfg, cfg, params = setup
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    jdecode = jax.jit(JST.make_decode_step(jcfg, mode=jm))
    decode = ST.make_decode_step(cfg, mode=tm)
    rng = np.random.default_rng(4)
    start = {k: (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in JR.init_cache(jcfg, 2, MAX_SEQ).items()}
    jcache = {k: jnp.asarray(v).astype(jnp.bfloat16 if k == "conv"
                                      else jnp.float32)
              for k, v in start.items()}
    cache = {k: torch.from_numpy(np.array(_np(v))).to(
        torch.bfloat16 if k == "conv" else torch.float32)
        for k, v in jcache.items()}
    toks = _tokens(5, SEQ, 2, cfg.vocab)
    idx = np.array([0, 3], np.int32)
    for t in range(SEQ):
        tok = toks[t][:, None]
        want, jcache = jdecode(jp, {"tokens": jnp.asarray(tok),
                                    "cache_index": jnp.asarray(idx + t)},
                               jcache)
        got, cache = decode(tp, {"tokens": torch.from_numpy(tok),
                                 "cache_index": torch.from_numpy(idx + t)},
                            cache)
        _check_logits(got.numpy(), np.asarray(want), LOGIT_ATOL)
    for k in ("h", "conv"):
        assert float(np.abs(_np(cache[k]) - _np(jcache[k])).max()) \
            <= STATE_ATOL, k


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_equals_the_decode_chain(setup, mode):
    """The chunked forward and 20 one-token decode steps from a zero state
    compute the same logits within LOGIT_ATOL (the chunked scan sums in
    another order than the recurrence, and under W8A16 the forward takes
    the tensor-core kernel where decode takes the GEMV)."""
    _, cfg, params = setup
    _, tp = params[mode]
    tm, _ = MODES[mode]
    toks = _tokens(6, 2, SEQ, cfg.vocab)
    full = ST.make_prefill_step(cfg, mode=tm)(
        tp, {"tokens": torch.from_numpy(toks)}).numpy()
    decode = ST.make_decode_step(cfg, mode=tm)
    cache = R.init_cache(cfg, 2, MAX_SEQ, device="cpu")
    for t in range(SEQ):
        got, cache = decode(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                 "cache_index": t}, cache)
        _check_logits(got.numpy()[:, 0], full[:, t], LOGIT_ATOL)


def test_decode_rows_do_not_depend_on_the_batch(setup):
    """A row decoded alone (batch 1, lockstep index) equals the same row in
    a batch of three at per-row positions, bitwise: logits and state (the
    engine's parity with its batch-1 reference rests on it)."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    decode = ST.make_decode_step(cfg, mode=W8A16)
    gen = torch.Generator().manual_seed(8)
    cache = R.init_cache(cfg, 3, MAX_SEQ, device="cpu")
    cache["h"].normal_(generator=gen)
    cache["conv"].copy_(torch.randn(cache["conv"].shape, generator=gen))
    rows = [{k: v[:, r:r + 1].clone() for k, v in cache.items()}
            for r in range(3)]
    toks = torch.tensor([[5], [77], [301]], dtype=torch.int32)
    idx = torch.tensor([0, 2, 9], dtype=torch.int32)
    full, cache = decode(tp, {"tokens": toks, "cache_index": idx}, cache)
    for r in range(3):
        one, rows[r] = decode(tp, {"tokens": toks[r:r + 1],
                                   "cache_index": int(idx[r])}, rows[r])
        assert torch.equal(one[0], full[r])
        for k in cache:
            assert torch.equal(rows[r][k][:, 0], cache[k][:, r])
    with pytest.raises(ValueError, match="one token a row"):
        decode(tp, {"tokens": toks.reshape(1, 3), "cache_index": 0}, cache)


# ---------------------------------------------------------------------------
# the slot contract: the freeze and the scrub
# ---------------------------------------------------------------------------

def test_recurrent_state_isolated_from_inactive_rows(setup):
    """The reference's test of the same name: poisoned state in inactive
    rows never leaks into active rows, inactive rows' state is frozen
    bitwise (row 1 sits at index 0 and is not scrubbed while inactive),
    and a reused row is scrubbed by the reset-at-position-0 rule, so the
    poison cannot survive into a new tenancy either."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    step = ST.jit_slot_decode_step(ST.make_slot_decode_step(cfg, mode=W8A16))
    nslots = 4
    idx = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    active = torch.tensor([True, False, True, False])
    tokens = torch.tensor([[5], [1], [9], [2]], dtype=torch.int32)

    def run(c):
        c = {k: v.clone() for k, v in c.items()}
        nxt, c, i = step(tp, tokens, c, idx, active)
        return nxt.clone(), c, i.clone()

    # warm the state so rows differ from zeros (the freeze check means
    # something)
    cache0 = R.init_cache(cfg, nslots, 32, device="cpu")
    step(tp, tokens, cache0, torch.zeros((nslots,), dtype=torch.int32),
         torch.ones((nslots,), dtype=torch.bool))
    n1, c1, i1 = run(cache0)
    poisoned = {k: v.clone() for k, v in cache0.items()}
    for k in poisoned:
        poisoned[k][:, 1] = 107.0
        poisoned[k][:, 3] = -9.0
    n2, c2, i2 = run(poisoned)
    assert torch.equal(n1[active], n2[active])
    assert torch.equal(i1, i2)
    for k in c1:
        assert torch.equal(c1[k][:, active], c2[k][:, active]), k
        assert torch.equal(c2[k][:, ~active], poisoned[k][:, ~active]), k
        # the unpoisoned inactive rows are frozen too
        assert torch.equal(c1[k][:, ~active], cache0[k][:, ~active]), k
    assert n1[1] == 0 and n1[3] == 0
    assert torch.equal(i1, idx + active.int())
    # a new tenant of poisoned row 1 (position 0) decodes as in a fresh
    # pool: the scrub zeroes the poison before the update
    only1 = torch.tensor([False, True, False, False])
    zero = torch.zeros((nslots,), dtype=torch.int32)
    tok2 = torch.tensor([[5], [7], [9], [2]], dtype=torch.int32)
    reused = {k: v.clone() for k, v in c2.items()}
    fresh = R.init_cache(cfg, nslots, 32, device="cpu")
    nr = step(tp, tok2, reused, zero, only1)[0].clone()
    nf = step(tp, tok2, fresh, zero, only1)[0].clone()
    assert int(nr[1]) == int(nf[1])
    for k in reused:
        assert torch.equal(reused[k][:, 1], fresh[k][:, 1]), k


def test_reference_mask_hook_agrees_with_the_in_place_freeze(setup):
    """The tick's in-place freeze is the registry hook's rule: a tick on
    one copy equals an unmasked tick on another with the inactive rows
    put back by ``registry.mask_inactive_slots``."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    tick = ST.make_slot_decode_step(cfg, mode=W8A16)
    decode = ST.make_decode_step(cfg, mode=W8A16)
    gen = torch.Generator().manual_seed(9)
    old = R.init_cache(cfg, 4, MAX_SEQ, device="cpu")
    old["h"].normal_(generator=gen)
    old["conv"].copy_(torch.randn(old["conv"].shape, generator=gen))
    idx = torch.tensor([4, 0, 1, 0], dtype=torch.int32)
    active = torch.tensor([True, True, False, False])
    toks = torch.tensor([[3], [4], [5], [6]], dtype=torch.int32)
    masked = {k: v.clone() for k, v in old.items()}
    tick(tp, toks, masked, idx, active)
    new = {k: v.clone() for k, v in old.items()}
    decode(tp, {"tokens": toks, "cache_index": idx}, new)
    want = R.mask_inactive_slots(cfg, old, new, active)
    for k in old:
        assert torch.equal(masked[k], want[k]), k


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["w8a16", "fp"])
def test_chunk_step_equals_the_per_token_decode(setup, mode):
    """The chunk step of slot 2 of a four-slot pool (eager and captured,
    every n_valid up to 4, from position 0 and from 5) writes the bytes
    that n one-token decode steps of that row alone write: under W8A16
    too the ssm chunk runs token by token (one token a decode call); the
    other slots are untouched."""
    _, cfg, params = setup
    _, tp = params[mode]
    qm = MODES[mode][0]
    eager = ST.make_prefill_chunk_step(cfg, mode=qm, chunk=4)
    per_token = ST.make_per_token_chunk_step(cfg, mode=qm, chunk=4)
    graphed = ST.jit_prefill_chunk_step(
        ST.make_prefill_chunk_step(cfg, mode=qm, chunk=4))
    decode = ST.make_decode_step(cfg, mode=qm)
    gen = torch.Generator().manual_seed(11)
    base = R.init_cache(cfg, 4, MAX_SEQ, device="cpu")
    base["h"].normal_(generator=gen)
    base["conv"].copy_(torch.randn(base["conv"].shape, generator=gen))
    toks = [17, 250, 3, 99]
    for start in (0, 5):
        for n in range(1, 5):
            row = {k: v[:, 2:3].clone() for k, v in base.items()}
            for i in range(n):
                decode(tp, {"tokens": torch.tensor([[toks[i]]],
                                                   dtype=torch.int32),
                            "cache_index": start + i}, row, logits=False)
            for fn in (eager, per_token, graphed):
                c = {k: v.clone() for k, v in base.items()}
                fn(tp, toks, c, 2, start, n)
                for k in c:
                    assert torch.equal(c[k][:, 2], row[k][:, 0]), (k, n)
                    others = [0, 1, 3]
                    assert torch.equal(c[k][:, others], base[k][:, others])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _requests(cfg, n=16, **kw):
    return E.synthetic_requests(n, rate_per_s=3000.0, vocab=cfg.vocab,
                                prompt_len=PROMPT, max_new_tokens=GEN, **kw)


@pytest.fixture(scope="module")
def trace(setup):
    """Sixteen requests through four slots (slot reuse) and the port's
    sequential reference, greedy and sampled."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs = _requests(cfg)
    want = {t: E.reference_outputs(
        cfg, tp, reqs, mode=W8A16, max_seq=MAX_SEQ, device="cpu",
        temperature=t, rng=PRNGKey(3) if t else None) for t in (0.0, 0.8)}
    return reqs, want


def _engine(cfg, params, temperature=0.0, **kw):
    kw.setdefault("num_slots", 4)
    kw.setdefault("prefill_chunk", 4)
    return E.Engine(cfg, params, mode=W8A16, max_seq=MAX_SEQ, device="cpu",
                    temperature=temperature,
                    rng=PRNGKey(3) if temperature else None, **kw)


# (prefill_chunk, temperature)
SERVES = {"chunked": (4, 0.0), "per_token": (None, 0.0),
          "chunked_sampled": (4, 0.8), "per_token_sampled": (None, 0.8)}


@pytest.mark.parametrize("case", list(SERVES))
def test_engine_equals_reference_bit_for_bit(setup, trace, case):
    """``Engine.serve`` with and without chunked prefill, greedy and
    sampled: every request's tokens equal the sequential batch-1
    reference's, through slot reuse (16 requests on 4 slots, admissions
    while others generate); the warmed-up engine serves the same."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs, want = trace
    chunk, t = SERVES[case]
    eng = _engine(cfg, tp, t, prefill_chunk=chunk)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rep = eng.serve(reqs)
        assert rep.outputs() == want[t]
        assert len(rep.results) == 16
        assert rep.admissions_while_busy > 0
        assert {r.slot for r in rep.results} == set(range(4))
        eng.warmup()
        assert eng.serve(reqs).outputs() == want[t]


def test_engine_matches_the_jax_engine(setup, trace):
    """The port's engine and the JAX engine on the same weights and trace:
    greedy tokens equal up to the first step where either parts from the
    JAX sequential reference, and that step is one where the reference's
    top-2 logit gap is within LOGIT_ATOL (after it the two decode
    different inputs)."""
    jcfg, cfg, params = setup
    jq, _ = params["w8a16"]
    reqs, want = trace
    jreqs = JE.synthetic_requests(16, rate_per_s=3000.0, vocab=cfg.vocab,
                                  prompt_len=PROMPT, max_new_tokens=GEN)
    assert [(r.rid, r.prompt, r.arrival_s) for r in jreqs] == \
        [(r.rid, r.prompt, r.arrival_s) for r in reqs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jrep = JE.Engine(jcfg, jq, mode=JW8A16, num_slots=4, max_seq=MAX_SEQ,
                         prefill_chunk=4).serve(jreqs)
    jout = jrep.outputs()
    jref, gaps = _jax_reference_with_margins(jcfg, jq, jreqs, MAX_SEQ)
    got = want[0.0]
    assert got.keys() == jout.keys()

    def first_difference(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    len(a))

    for rid, toks in jout.items():
        assert len(got[rid]) == len(toks) == GEN
        first = min(first_difference(got[rid], toks),
                    first_difference(toks, jref[rid]))
        assert got[rid][:first] == toks[:first]
        if first < GEN:
            assert gaps[rid][first] <= LOGIT_ATOL, (rid, first, gaps[rid])


def test_preemption_resume_equals_reference(setup, trace):
    """Interactive heads evict batch slots from a two-slot pool; every
    resumed request, its state rebuilt from position 0 through the chunk
    steps over a slot another tenant held since, equals the reference."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs, want = trace
    reqs = [dataclasses.replace(
        r, priority="batch" if r.rid % 3 == 0 else "interactive")
        for r in reqs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rep = _engine(cfg, tp, num_slots=2).serve(reqs, preemption=True)
    assert rep.preempted > 0
    assert rep.resumed_prefill_tokens > 0
    assert rep.outputs() == want[0.0]


@pytest.mark.parametrize("chunk", [4, None])
def test_nonfinite_recovery_equals_reference(setup, trace, chunk):
    """A non-finite sample scrubs the slot's state and resumes it by
    preemption from position 0, and a failed dispatch launches nothing
    (a retry cannot advance h twice): every token still equals the
    reference."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs, want = trace
    plan = E.FaultPlan([E.Fault(tick=6, kind="nan_logits", slot=1),
                        E.Fault(tick=9, kind="dispatch", slot=2)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rep = _engine(cfg, tp, prefill_chunk=chunk).serve(reqs,
                                                         fault_plan=plan)
    assert rep.nonfinite_samples == 1 and rep.preempted == 1
    assert rep.dispatch_retries == 1 and rep.failed == 0
    assert rep.outputs() == want[0.0]


def test_engine_refuses_paging_and_speculation(setup):
    """The reference's refusals: no paged cache (the state has no
    positional axis to page) and no speculation (a recurrent state cannot
    be rewound), as target or as draft."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    with pytest.raises(ValueError, match="does not support the paged KV"):
        _engine(cfg, tp, block_size=4)
    with pytest.raises(ValueError, match="rewindable positional KV"):
        _engine(cfg, tp, spec_k=2, draft_layers=1)
    dense = get_config("starcoder2-3b").reduced()
    dp = R.init_quantized(torch.Generator().manual_seed(0), dense,
                          device="cpu")
    with pytest.raises(ValueError, match="rewindable positional KV"):
        E.Engine(dense, dp, mode=W8A16, max_seq=MAX_SEQ, device="cpu",
                 spec_k=2, draft=(cfg, tp))


def test_serve_cli_runs_mamba2(capsys):
    """``python -m repro_torch.launch.serve --arch mamba2-1.3b`` on the CPU:
    the curve's chunked forward, the decode loop and the engine serve
    every request, equal to the reference; ``--block-size`` and
    ``--spec-k`` are rejected."""
    from repro_torch.launch import serve

    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--max-batch",
            "4", "--seq", str(SEQ), "--deadline-ms", "60000",
            "--n-requests", "6", "--prefill-chunk", "4", "--prompt-len", "8",
            "--decode-tokens", "4"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = serve.run(serve.parse_args(base))
    out = capsys.readouterr().out
    assert res.code == 0, out
    assert res.decode_tokens_per_s and res.decode_tokens_per_s > 0
    rep = res.report
    assert len(rep.results) == 6 and all(r.status == "ok"
                                         for r in rep.results)
    assert rep.outputs() == E.reference_outputs(
        res.cfg, res.params, res.requests, mode=W8A16,
        max_seq=res.engine.max_seq, device="cpu")
    for flags, words in ((["--block-size", "4"], "paged KV cache"),
                         (["--spec-k", "2", "--draft-layers", "1"],
                          "speculative decoding")):
        res = serve.run(serve.parse_args(base + flags + ["--decode-tokens",
                                                         "0"]))
        out = capsys.readouterr().out
        assert res.code == 1 and "config rejected" in out and words in out
