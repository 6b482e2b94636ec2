"""The port's hybrid family (recurrentgemma-9b) against the JAX package, on
the CPU at reduced size (d 128, RG-LRU width 128, conv width 4, 4 query
heads and 1 KV head of 32, local window 32, d_ff 256, vocab 512), and its
engine against its own sequential reference.  ``reduced()`` keeps 6
layers: 2 groups of (rec, rec, attn) and no leftover block; full width
has 2 leftover blocks, so the model tests run 8 layers too (2 groups and
2 leftover blocks).

The same weights go into both packages (the reference's ``init`` and
``quantize_tree``, copied through numpy by ``models/bridge.py``); tokens
come from numpy with a seed.  Sequences are 40 tokens long, past the
local window of 32, so the forward's window masks and the decode ring
wraps (a 32-slot ring at ``max_seq`` 64).

Tolerances against the JAX package (HYBRID_LOGIT_ATOL, STATE_ATOL).  On
the same input every block lands within one bf16 ulp of the reference's
jitted block (seen: 0.0156-0.031 at values up to 4.3): the matmuls sum in
another order, and the conv's ``silu`` rounds once where XLA's expansion
rounds three times.  The RG-LRU gates are held bitwise (``rglru.sigmoid``
is XLA's expansion), the recurrence to f32 rounding.  Those ulps compound
over 6-8 blocks and 40 steps to up to 0.16 in logits of range +-4.6 (seen)
and to a few bf16 ulps in the cache; 0.25 bounds the logits, while a wrong
window, ring read or decay constant moves them by 0.46-3.2 (checked by
mutation).

The port's engine is held to the port's ``reference_outputs`` bit for
bit, and to the JAX engine token for token up to the first step where a
reference top-2 gap is within HYBRID_LOGIT_ATOL.
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
from repro.kernels import ref as JREF
from repro.models import registry as JR
from repro.runtime import steps as JST
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import FP, W8A8, W8A16
from repro_torch.core.quant import QTensor, quantize_tree
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.models import rglru as G
from repro_torch.runtime import steps as ST
from repro_torch.runtime.prng import PRNGKey

from test_torch_engine import _jax_reference_with_margins
from test_torch_forward import _check_logits
from test_torch_model import to_numpy

ARCH = "recurrentgemma-9b"
MODES = {"fp": (FP, JFP), "w8a16": (W8A16, JW8A16)}
DEPTHS = (6, 8)          # 8: two leftover recurrent blocks, as full width
SEQ = 40                 # past the reduced local window of 32
RING_SEQ = 64            # max_seq of the decode tests: a 32-slot ring
HYBRID_LOGIT_ATOL = 0.25
STATE_ATOL = {"rnn_h": 0.05, "lo_rnn_h": 0.05, "conv": 0.2, "lo_conv": 0.2,
              "k": 0.2, "v": 0.2}
# the engine's trace: 24 + 12 tokens a request wrap the 32-slot ring
MAX_SEQ = 48
PROMPT, GEN = 24, 12


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(n_layers=6):
    return (dataclasses.replace(jget_config(ARCH).reduced(),
                                n_layers=n_layers),
            dataclasses.replace(get_config(ARCH).reduced(),
                                n_layers=n_layers))


@pytest.fixture(scope="module")
def models():
    """{depth: (jcfg, cfg, {mode: (JAX params, the port's bridged copy)})}."""
    out = {}
    for depth in DEPTHS:
        jcfg, cfg = _cfgs(depth)
        jfp = JR.init(jax.random.PRNGKey(depth), jcfg)
        jq = jquantize_tree(jfp, min_size=2048)
        out[depth] = (jcfg, cfg, {
            "fp": (jfp, bridge.params_from_numpy(to_numpy(jfp),
                                                 device="cpu")),
            "w8a16": (jq, bridge.params_from_numpy(to_numpy(jq),
                                                   device="cpu"))})
    return out


@pytest.fixture(scope="module")
def setup(models):
    """The 6-layer model the engine tests serve."""
    return models[6]


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s),
                                                dtype=np.int32)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(jnp.asarray(t, jnp.float32))


def _random_cache(cfg, b, s_max, seed):
    """A cache with every leaf drawn at random (the state and the ring)."""
    gen = torch.Generator().manual_seed(seed)
    cache = R.init_cache(cfg, b, s_max, device="cpu")
    for v in cache.values():
        v.copy_(0.5 * torch.randn(v.shape, generator=gen))
    return cache


# ---------------------------------------------------------------------------
# config, params, cache
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    j, t = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert t.param_count() == j.param_count()
    assert G._layout(t) == (12, 2) and G._layout(t.reduced()) == (2, 0)


def test_bridge_splits_groups_and_leftover(models):
    """The reference's stacked groups and leftover blocks become lists; the
    projections, the gates' f32 linears and the table are int8; conv_w,
    Lambda, the biases and the norms stay f32 (the path rule takes
    ``.w``)."""
    _, cfg, params = models[8]
    _, tq = params["w8a16"]
    assert len(tq["groups"]) == 2 and len(tq["leftover"]) == 2
    assert set(tq["groups"][1]) == {"rec0", "rec1", "attn"}
    for rec in (tq["groups"][1]["rec1"], tq["leftover"][1]):
        for path in (("w_in_a",), ("w_in_b",), ("w_out",), ("lru", "w_a"),
                     ("lru", "w_x"), ("mlp", "w_gate"), ("mlp", "w_down")):
            node = rec
            for k in path:
                node = node[k]
            assert isinstance(node["w"], QTensor), path
        assert rec["lru"]["w_a"]["w"].values.shape == (cfg.rnn_width,) * 2
        for leaf in (rec["conv_w"], rec["conv_b"], rec["lru"]["Lambda"],
                     rec["lru"]["w_a"]["b"], rec["ln"]["scale"]):
            assert leaf.dtype == torch.float32
    assert isinstance(tq["groups"][0]["attn"]["attn"]["wk"]["w"], QTensor)
    assert isinstance(tq["embed"]["table"], QTensor)


@pytest.mark.parametrize("depth", DEPTHS)
def test_init_quantized_is_quantize_tree_of_init(depth):
    """The streamed init quantizes the leaves the whole-tree quantizer
    would, bit for bit, from the same draws (groups and leftover
    blocks)."""
    _, cfg = _cfgs(depth)
    whole = quantize_tree(G.init(torch.Generator().manual_seed(3), cfg,
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
    assert isinstance(streamed["groups"][0]["rec0"]["lru"]["w_x"]["w"],
                      QTensor)
    assert ("leftover" in streamed) == (depth == 8)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("kv_quant", [False, True])
def test_cache_and_registry_answer_as_the_reference(depth, kv_quant):
    """The cache's leaves have the reference's shapes and dtypes (a bf16
    ring whatever ``kv_quant`` says, of min(window, s_max) slots); the
    registry refuses paging and speculation as the reference's does, puts
    the grouped state's slot axis at 2, and steps a chunk token by
    token."""
    jcfg, cfg = _cfgs(depth)
    jcfg = dataclasses.replace(jcfg, kv_quant=kv_quant)
    cfg = dataclasses.replace(cfg, kv_quant=kv_quant)
    for s_max in (16, RING_SEQ):
        jc = JR.init_cache(jcfg, 3, s_max)
        tc = R.init_cache(cfg, 3, s_max, device="cpu")
        assert set(tc) == set(jc)
        for k, v in jc.items():
            assert tuple(tc[k].shape) == v.shape, k
            assert str(tc[k].dtype).split(".")[-1] == str(v.dtype), k
            assert not tc[k].any()
        assert tc["k"].dtype == torch.bfloat16
        assert tc["k"].shape[2] == min(cfg.local_window, s_max)
        assert R.cache_batch_axes(cfg, tc) == JR.cache_batch_axes(jcfg, jc)
    assert R.cache_batch_axes(cfg, tc)["rnn_h"] == 2
    assert R.supports_paging(cfg) is JR.supports_paging(jcfg) is False
    assert R.supports_speculation(cfg) is JR.supports_speculation(jcfg) \
        is False
    assert not R.supports_self_draft(cfg)
    assert not R.needs_prime(cfg) and R.source_shape(cfg) is None
    assert not R.decodes_chunk_in_one_pass(cfg)
    with pytest.raises(ValueError, match="paged KV cache"):
        R.init_paged_cache(cfg, 2, RING_SEQ, 4, 9, device="cpu")


def test_mask_inactive_slots_matches_reference():
    """The out-of-place freeze hook: inactive rows of ``new``'s recurrent
    state and conv tails replaced by ``old``'s, the ring left as ``new``
    has it, bitwise the reference's."""
    jcfg, cfg = _cfgs(8)
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
    assert set(got) == set(shapes)
    for k in shapes:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["rnn_h"].numpy()[:, :, 1],
                                  old["rnn_h"][:, :, 1])
    np.testing.assert_array_equal(got["k"].numpy(), new["k"])


def test_sigmoid_is_the_jitted_jax_sigmoid():
    """``rglru.sigmoid`` of bf16 inputs equals ``jax.nn.sigmoid`` as the
    jitted gates compute it (XLA's expansion, the quotient left f32),
    bitwise across the range."""
    x = np.linspace(-12.0, 12.0, 20001, dtype=np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(jax.jit(
        lambda v: jax.nn.sigmoid(v) * jnp.float32(1.0))(xb))
    got = G.sigmoid(torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_linear_scan_is_the_recurrence():
    """The doubling scan equals h_t = a_t h_{t-1} + b_t stepped one token at
    a time, to f32 rounding (it multiplies in another order), at lengths
    that are and are not powers of two."""
    gen = torch.Generator().manual_seed(5)
    for s in (1, 7, 32, 40):
        a = torch.rand((2, s, 16), generator=gen)
        b = torch.randn((2, s, 16), generator=gen)
        h, want = torch.zeros((2, 16)), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(G.linear_scan(a, b),
                                   torch.stack(want, dim=1),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("mode", list(MODES))
def test_forward_matches_reference(models, mode, depth):
    """The full-sequence forward (the service curve's prefill), (2, 40)
    tokens: the scan, the windowed attention past the window; logits
    within HYBRID_LOGIT_ATOL and greedy tokens equal wherever the
    reference's top-2 gap is outside it."""
    jcfg, cfg, params = models[depth]
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    toks = _tokens(3, 2, SEQ, cfg.vocab)
    want = np.asarray(jax.jit(lambda p, t: JR.apply_forward(
        p, jcfg, {"tokens": t}, mode=jm, remat=False))(jp, jnp.asarray(toks)))
    got = ST.make_prefill_step(cfg, mode=tm)(
        tp, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32
    _check_logits(got.numpy(), want, HYBRID_LOGIT_ATOL)


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("mode", list(MODES))
def test_decode_step_matches_reference_per_row(models, mode, depth):
    """The slot engine's per-row decode on a 32-slot ring: two rows at
    positions (B,) 0 and 3, 40 steps of the same tokens in both packages
    (both rows wrap the ring); logits within HYBRID_LOGIT_ATOL at every
    step, greedy tokens equal where the reference's top-2 gap is outside
    it, and every cache leaf (the state, the conv tails, the ring's k and
    v) within STATE_ATOL at the end."""
    jcfg, cfg, params = models[depth]
    jp, tp = params[mode]
    tm, jm = MODES[mode]
    jdecode = jax.jit(JST.make_decode_step(jcfg, mode=jm))
    decode = ST.make_decode_step(cfg, mode=tm)
    jcache = JR.init_cache(jcfg, 2, RING_SEQ)
    cache = R.init_cache(cfg, 2, RING_SEQ, device="cpu")
    assert cache["k"].shape[2] == cfg.local_window
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
        _check_logits(got.numpy(), np.asarray(want), HYBRID_LOGIT_ATOL)
    assert set(cache) == set(jcache)
    for k in cache:
        assert float(np.abs(_np(cache[k]) - _np(jcache[k])).max()) \
            <= STATE_ATOL[k], k


def test_ring_row_past_the_window_matches_reference(models):
    """One row decoded alone (a lockstep int index) from position 0 to 40
    on the 32-slot ring: position p lies at slot p % 32, so the ring ends
    holding positions 9 .. 40 (slot 8 overwritten by position 40), and the
    row's logits at positions 32-40, which read the window's 32 newest
    positions, stay within HYBRID_LOGIT_ATOL of JAX's."""
    jcfg, cfg, params = models[8]
    jp, tp = params["w8a16"]
    jdecode = jax.jit(JST.make_decode_step(jcfg, mode=JW8A16))
    decode = ST.make_decode_step(cfg, mode=W8A16)
    jcache = JR.init_cache(jcfg, 1, RING_SEQ)
    cache = R.init_cache(cfg, 1, RING_SEQ, device="cpu")
    toks = _tokens(9, 1, SEQ + 1, cfg.vocab)
    ring_k = {}
    for t in range(SEQ + 1):
        tok = toks[:, t:t + 1]
        want, jcache = jdecode(jp, {"tokens": jnp.asarray(tok),
                                    "cache_index": jnp.asarray(t, jnp.int32)},
                               jcache)
        got, cache = decode(tp, {"tokens": torch.from_numpy(tok),
                                 "cache_index": t}, cache)
        ring_k[t] = cache["k"][:, 0, t % cfg.local_window].clone()
        if t >= cfg.local_window:
            _check_logits(got.numpy(), np.asarray(want), HYBRID_LOGIT_ATOL)
    # the ring holds positions 9 .. 40, each at its slot p % 32
    for p in range(SEQ + 1 - cfg.local_window, SEQ + 1):
        assert torch.equal(cache["k"][:, 0, p % cfg.local_window], ring_k[p])
    assert not torch.equal(ring_k[8], ring_k[SEQ])
    assert float(np.abs(_np(cache["k"]) - _np(jcache["k"])).max()) \
        <= STATE_ATOL["k"]


@pytest.mark.parametrize("mode", list(MODES))
def test_forward_equals_the_decode_chain(models, mode):
    """The forward (the scan and the windowed flash attention) and 40
    one-token decode steps on the 32-slot ring compute the same logits
    within HYBRID_LOGIT_ATOL (other summation orders; under W8A16 the
    forward takes the tensor-core kernel where decode takes the GEMV)."""
    _, cfg, params = models[8]
    _, tp = params[mode]
    tm, _ = MODES[mode]
    toks = _tokens(6, 2, SEQ, cfg.vocab)
    full = ST.make_prefill_step(cfg, mode=tm)(
        tp, {"tokens": torch.from_numpy(toks)}).numpy()
    decode = ST.make_decode_step(cfg, mode=tm)
    cache = R.init_cache(cfg, 2, RING_SEQ, device="cpu")
    for t in range(SEQ):
        got, cache = decode(tp, {"tokens": torch.from_numpy(toks[:, t:t + 1]),
                                 "cache_index": t}, cache)
        _check_logits(got.numpy()[:, 0], full[:, t], HYBRID_LOGIT_ATOL)


@pytest.mark.parametrize("caller,mode", [("forward", "w8a16"),
                                         ("forward", "w8a8"),
                                         ("decode_step", "w8a16"),
                                         ("decode_step", "w8a8")])
def test_w8a16_path_by_caller(models, monkeypatch, caller, mode):
    """The full-sequence ``forward`` asks for qmatmul_w8a16's tensor-core
    kernel (``"mma"``) under either mode: under W8A16 for every
    projection, under W8A8 for the two RG-LRU gates of every recurrent
    block and the head, the rest on qmatmul_w8a8.  The decode step takes
    the GEMV for the same calls."""
    _, cfg, params = models[8]
    _, tp = params["w8a16"]
    tm = W8A8 if mode == "w8a8" else W8A16
    paths, w8a8 = [], []
    real = ops.qmatmul

    def spy(x, w, bias=None, **kw):
        (paths if kw.get("x_q") is None else w8a8).append(
            kw.get("path", "gemv"))
        return real(x, w, bias, **kw)

    monkeypatch.setattr(ops, "qmatmul", spy)
    toks = torch.from_numpy(_tokens(7, 2, 5, cfg.vocab))
    if caller == "forward":
        ST.make_prefill_step(cfg, mode=tm)(tp, {"tokens": toks})
    else:
        ST.make_decode_step(cfg, mode=tm)(
            tp, {"tokens": toks[:, :1], "cache_index": 3},
            R.init_cache(cfg, 2, RING_SEQ, device="cpu"))
    n_groups, leftover = G._layout(cfg)
    rec, attn = 2 * n_groups + leftover, n_groups
    mlp = 3 if cfg.gated_mlp else 2
    every = rec * (5 + mlp) + attn * (4 + mlp) + 1
    gates_and_head = 2 * rec + 1
    want_n = gates_and_head if mode == "w8a8" else every
    assert len(paths) == want_n
    assert len(w8a8) == (every - gates_and_head if mode == "w8a8" else 0)
    assert set(paths) == {"mma" if caller == "forward" else "gemv"}


def test_decode_rows_do_not_depend_on_the_batch(models):
    """A row decoded alone (batch 1, lockstep index) equals the same row in
    a batch of four at per-row positions straddling the window (0, 31, 32,
    45), bitwise: logits and every cache leaf (the engine's parity with its
    batch-1 reference rests on it)."""
    _, cfg, params = models[8]
    _, tp = params["w8a16"]
    decode = ST.make_decode_step(cfg, mode=W8A16)
    cache = _random_cache(cfg, 4, RING_SEQ, 8)
    axes = R.cache_batch_axes(cfg, cache)
    rows = [{k: v.narrow(axes[k], r, 1).clone() for k, v in cache.items()}
            for r in range(4)]
    toks = torch.tensor([[5], [77], [301], [9]], dtype=torch.int32)
    idx = torch.tensor([0, 31, 32, 45], dtype=torch.int32)
    full, cache = decode(tp, {"tokens": toks, "cache_index": idx}, cache)
    for r in range(4):
        one, rows[r] = decode(tp, {"tokens": toks[r:r + 1],
                                   "cache_index": int(idx[r])}, rows[r])
        assert torch.equal(one[0], full[r])
        for k in cache:
            assert torch.equal(rows[r][k], cache[k].narrow(axes[k], r, 1)), k
    with pytest.raises(ValueError, match="one token a row"):
        decode(tp, {"tokens": toks.reshape(1, 4), "cache_index": 0}, cache)


# ---------------------------------------------------------------------------
# flash attention's plain version at head_dim 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,window", [(48, 16), (40, 32)])
def test_flash_plain_at_head_dim_256(sq, window):
    """The flash kernel's plain version at recurrentgemma's head_dim 256,
    causal with a window shorter than S, against the JAX oracle
    (``ref.flash_attention_ref``): f32 in and out, 1e-5 (other summation
    orders of the same dense softmax)."""
    rng = np.random.default_rng(sq + window)
    q, k, v = (rng.normal(size=(3, sq, 256)).astype(np.float32)
               for _ in range(3))
    got = FA.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, out_dtype=torch.float32).numpy()
    want = np.asarray(JREF.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=window, out_dtype=jnp.float32))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert FA.MAX_HD == 256


# ---------------------------------------------------------------------------
# the slot contract: the freeze and the scrub
# ---------------------------------------------------------------------------

def test_recurrent_state_isolated_from_inactive_rows(setup):
    """Poisoned state in inactive rows never leaks into active rows,
    inactive rows' state and conv tails are frozen bitwise (row 1 sits at
    index 0 and is not scrubbed while inactive), and a reused row is
    scrubbed by the reset-at-position-0 rule, so the poison cannot survive
    into a new tenancy either."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    step = ST.jit_slot_decode_step(ST.make_slot_decode_step(cfg, mode=W8A16))
    nslots = 4
    idx = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    active = torch.tensor([True, False, True, False])
    tokens = torch.tensor([[5], [1], [9], [2]], dtype=torch.int32)
    state = ("rnn_h", "conv")

    def run(c):
        c = {k: v.clone() for k, v in c.items()}
        nxt, c, i = step(tp, tokens, c, idx, active)
        return nxt.clone(), c, i.clone()

    cache0 = R.init_cache(cfg, nslots, MAX_SEQ, device="cpu")
    step(tp, tokens, cache0, torch.zeros((nslots,), dtype=torch.int32),
         torch.ones((nslots,), dtype=torch.bool))
    n1, c1, i1 = run(cache0)
    poisoned = {k: v.clone() for k, v in cache0.items()}
    for k in state:
        poisoned[k][:, :, 1] = 107.0
        poisoned[k][:, :, 3] = -9.0
    n2, c2, i2 = run(poisoned)
    assert torch.equal(n1[active], n2[active])
    assert torch.equal(i1, idx + active.int())
    for k in state:
        assert torch.equal(c1[k][:, :, active], c2[k][:, :, active]), k
        assert torch.equal(c2[k][:, :, ~active], poisoned[k][:, :, ~active])
        assert torch.equal(c1[k][:, :, ~active], cache0[k][:, :, ~active])
    assert n1[1] == 0 and n1[3] == 0
    # a new tenant of poisoned row 1 (position 0) decodes as in a fresh pool
    only1 = torch.tensor([False, True, False, False])
    zero = torch.zeros((nslots,), dtype=torch.int32)
    tok2 = torch.tensor([[5], [7], [9], [2]], dtype=torch.int32)
    reused = {k: v.clone() for k, v in c2.items()}
    fresh = R.init_cache(cfg, nslots, MAX_SEQ, device="cpu")
    nr = step(tp, tok2, reused, zero, only1)[0].clone()
    nf = step(tp, tok2, fresh, zero, only1)[0].clone()
    assert int(nr[1]) == int(nf[1])
    for k in state:
        assert torch.equal(reused[k][:, :, 1], fresh[k][:, :, 1]), k


def test_frozen_past_the_window_then_resumed_equals_never_frozen(models):
    """Row 0 at position 35 (its ring wrapped) sits inactive through three
    ticks while row 1 advances, then resumes: its next three tokens,
    state, conv tails and ring row equal those of the same row never
    frozen, bitwise; the inactive ticks wrote its ring only at slot 35 %
    32, which its first real step overwrites."""
    _, cfg, params = models[8]
    _, tp = params["w8a16"]
    tick = ST.make_slot_decode_step(cfg, mode=W8A16)
    start = _random_cache(cfg, 2, RING_SEQ, 12)
    axes = R.cache_batch_axes(cfg, start)
    idx0 = torch.tensor([35, 40], dtype=torch.int32)
    tok = torch.tensor([[11], [23]], dtype=torch.int32)
    both = torch.tensor([True, True])
    frozen = {k: v.clone() for k, v in start.items()}
    never = {k: v.clone() for k, v in start.items()}
    idx, t = idx0.clone(), tok.clone()
    for _ in range(3):
        nxt, _, idx = tick(tp, t, frozen, idx, torch.tensor([False, True]))
        t = torch.stack([tok[0], nxt[1:2]]).reshape(2, 1).int()
    assert int(idx[0]) == 35
    outs = {}
    for name, cache, i in (("frozen", frozen, idx), ("never", never,
                                                     idx0.clone())):
        t, got = torch.tensor([[11], [1]], dtype=torch.int32), []
        for _ in range(3):
            nxt, _, i = tick(tp, t, cache, i, both)
            got.append(int(nxt[0]))
            t = nxt.reshape(2, 1).int()
        outs[name] = got
    assert outs["frozen"] == outs["never"]
    for k in start:
        assert torch.equal(frozen[k].narrow(axes[k], 0, 1),
                           never[k].narrow(axes[k], 0, 1)), k


def test_reference_mask_hook_agrees_with_the_in_place_freeze(models):
    """The tick's in-place freeze is the registry hook's rule: a tick on
    one copy equals an unmasked tick on another with the inactive rows put
    back by ``registry.mask_inactive_slots`` (leftover blocks too)."""
    _, cfg, params = models[8]
    _, tp = params["w8a16"]
    tick = ST.make_slot_decode_step(cfg, mode=W8A16)
    decode = ST.make_decode_step(cfg, mode=W8A16)
    old = _random_cache(cfg, 4, RING_SEQ, 9)
    idx = torch.tensor([4, 0, 33, 0], dtype=torch.int32)
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
def test_chunk_step_equals_the_per_token_decode(models, mode):
    """The chunk step of slot 2 of a four-slot pool (eager, per-token and
    captured, every n_valid up to 4, from position 0 and from 30, across
    the ring's wrap) writes the bytes that n one-token decode steps of
    that row alone write, state and ring; the other slots are
    untouched."""
    _, cfg, params = models[8]
    _, tp = params[mode]
    qm = MODES[mode][0]
    eager = ST.make_prefill_chunk_step(cfg, mode=qm, chunk=4)
    per_token = ST.make_per_token_chunk_step(cfg, mode=qm, chunk=4)
    graphed = ST.jit_prefill_chunk_step(
        ST.make_prefill_chunk_step(cfg, mode=qm, chunk=4))
    decode = ST.make_decode_step(cfg, mode=qm)
    base = _random_cache(cfg, 4, RING_SEQ, 11)
    axes = R.cache_batch_axes(cfg, base)
    others = torch.tensor([0, 1, 3])
    toks = [17, 250, 3, 99]
    for start in (0, 30):
        for n in range(1, 5):
            row = {k: v.narrow(axes[k], 2, 1).clone() for k, v in base.items()}
            for i in range(n):
                decode(tp, {"tokens": torch.tensor([[toks[i]]],
                                                   dtype=torch.int32),
                            "cache_index": start + i}, row, logits=False)
            for fn in (eager, per_token, graphed):
                c = {k: v.clone() for k, v in base.items()}
                fn(tp, toks, c, 2, start, n)
                for k in c:
                    assert torch.equal(c[k].narrow(axes[k], 2, 1),
                                       row[k]), (k, n, start)
                    assert torch.equal(c[k].index_select(axes[k], others),
                                       base[k].index_select(axes[k], others))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _requests(cfg, n=16, **kw):
    return E.synthetic_requests(n, rate_per_s=3000.0, vocab=cfg.vocab,
                                prompt_len=PROMPT, max_new_tokens=GEN, **kw)


@pytest.fixture(scope="module")
def trace(setup):
    """Sixteen requests through four slots (slot reuse; each wraps the
    ring) and the port's sequential reference, greedy and sampled."""
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
    while others generate, every request past the window); the warmed-up
    engine serves the same."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs, want = trace
    chunk, t = SERVES[case]
    eng = _engine(cfg, tp, t, prefill_chunk=chunk)
    assert eng.max_seq == MAX_SEQ
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
    top-2 logit gap is within HYBRID_LOGIT_ATOL (after it the two decode
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
            assert gaps[rid][first] <= HYBRID_LOGIT_ATOL, \
                (rid, first, gaps[rid])


def test_preemption_resume_equals_reference(setup, trace):
    """Interactive heads evict batch slots from a two-slot pool; every
    resumed request, its state and ring rebuilt from position 0 through
    the chunk steps over a slot another tenant held since, equals the
    reference."""
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
    """A non-finite sample scrubs the slot and resumes it by preemption
    from position 0, and a failed dispatch launches nothing (a retry
    cannot advance the state twice): every token still equals the
    reference."""
    _, cfg, params = setup
    _, tp = params["w8a16"]
    reqs, want = trace
    # ticks past the 24-token prompts' per-token prefill
    plan = E.FaultPlan([E.Fault(tick=30, kind="nan_logits", slot=1),
                        E.Fault(tick=33, kind="dispatch", slot=2)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rep = _engine(cfg, tp, prefill_chunk=chunk).serve(reqs,
                                                         fault_plan=plan)
    assert rep.nonfinite_samples == 1 and rep.preempted == 1
    assert rep.dispatch_retries == 1 and rep.failed == 0
    assert rep.outputs() == want[0.0]


def test_engine_refuses_paging_and_speculation(setup):
    """The reference's refusals: no paged cache (a ring has no stable
    position to block mapping) and no speculation (a recurrent state and
    a ring cannot be rewound), as target or as draft."""
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


@pytest.mark.parametrize("quant", ["w8a16", "w8a8"])
def test_serve_cli_runs_recurrentgemma(quant, capsys):
    """``python -m repro_torch.launch.serve --arch recurrentgemma-9b`` on
    the CPU, each quant mode: the curve's forward (prompts past the
    window), the decode loop and the engine serve every request (W8A16:
    equal to the reference); ``--block-size`` and ``--spec-k`` are
    rejected."""
    from repro_torch.launch import serve

    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--max-batch",
            "4", "--seq", str(SEQ), "--deadline-ms", "60000",
            "--n-requests", "6", "--prefill-chunk", "4", "--prompt-len", "8",
            "--decode-tokens", "4", "--quant", quant]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = serve.run(serve.parse_args(base))
    out = capsys.readouterr().out
    assert res.code == 0, out
    assert res.batch >= 1
    assert res.decode_tokens_per_s and res.decode_tokens_per_s > 0
    rep = res.report
    assert len(rep.results) == 6 and all(r.status == "ok"
                                         for r in rep.results)
    if quant == "w8a16":
        assert rep.outputs() == E.reference_outputs(
            res.cfg, res.params, res.requests, mode=W8A16,
            max_seq=res.engine.max_seq, device="cpu")
        return
    for flags, words in ((["--block-size", "4"], "paged KV cache"),
                         (["--spec-k", "2", "--draft-layers", "1"],
                          "speculative decoding")):
        res = serve.run(serve.parse_args(base + flags + ["--decode-tokens",
                                                         "0"]))
        out = capsys.readouterr().out
        assert res.code == 1 and "config rejected" in out and words in out
