"""mixtral-8x22b — the MoE family over a sliding-window KV ring — against the
JAX package on the CPU at reduced size (2 layers, d 128, 4 experts top-2,
no shared expert, 4 query and 2 KV heads of 32, window 64, an untied
vocabulary of 512), and its engine against its own sequential reference.

The ring: ``init_cache`` keeps ``min(s_max, window)`` slots, position p is
written at slot ``p % 64`` and a row reads the slots below ``min(p + 1,
64)``, as the reference's ``transformer.py:122-126, :204``.  Sequences
here run past 64 positions, so the ring wraps: the decode tests start
rows before, across and past the ring's end on caches filled at random
(every slot of a wrapped row valid), the forward runs 80 tokens with the
window masking, and the engine serves prompts of 48-80 tokens.

The same weights go into both packages (the reference's ``init`` and
``quantize_tree``, copied through numpy by ``models/bridge.py``); inputs
come from numpy with a seed.  ``reduced()`` leaves a (128, 4) f32 router
(below ``quantize_tree``'s ``min_size``), so routing runs through
``torch.matmul`` here.  Logits are held to the reference within
LOGIT_ATOL (W8A8: W8A8_LOGIT_ATOL) on every row routed as the reference
routes it; a row whose experts differ must part at a reference near-tie
(ROUTE_TIE), the MoE rule of ``tests/test_torch_moe.py``.  The
engine is held to the port's ``reference_outputs`` bit for bit, and to
the JAX engine token for token up to the first step where a reference
top-2 gap is within LOGIT_ATOL.
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
from repro.core.qlinear import W8A8 as JW8A8, W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import moe as JM
from repro.models import registry as JR
from repro.runtime import steps as JST
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import W8A8, W8A16
from repro_torch.core.quant import QTensor, quantize_tree
from repro_torch.launch import serve
from repro_torch.models import bridge
from repro_torch.models import moe as M
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST
from repro_torch.runtime.prng import PRNGKey

from test_torch_forward import W8A8_LOGIT_ATOL, _check_logits
from test_torch_model import LOGIT_ATOL, to_numpy
from test_torch_moe import _parted_rows, _record_routes

ARCH = "mixtral-8x22b"
WIN = 64                  # the reduced window: the ring's slots
MODES = {"w8a16": (W8A16, JW8A16), "w8a8": (W8A8, JW8A8)}
KV = {"bf16": False, "int8": True}
# the engine's trace: prompts of 48-80 tokens and 8 new ones wrap the ring
N_REQ, GEN, MAX_SEQ = 6, 8, 88
PROMPTS = (48, 56, 64, 72, 80)
# a near-tie of the reference's k-th and (k+1)-th router probabilities
# through a whole model.  With 4 experts and histories of up to 88
# positions the two packages' bf16 roundings (the JAX CPU path rounds its
# attention to bf16 where the port keeps f32) move the probabilities by
# up to 0.0070 (int8 ring) and 0.0055 (bf16 ring) at steps whose routing
# and logits still agree (measured on this file's trace); qwen2-moe's
# 16 experts over 16 positions stay within MODEL_ROUTE_TIE's 3e-3
ROUTE_TIE = 1e-2


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(kv_quant=False):
    return tuple(dataclasses.replace(get(ARCH).reduced(), kv_quant=kv_quant)
                 for get in (jget_config, get_config))


@pytest.fixture(scope="module")
def params():
    """(JAX int8 params, the port's bridged copy)."""
    jcfg, _ = _cfgs()
    jq = jquantize_tree(JR.init(jax.random.PRNGKey(0), jcfg), min_size=2048)
    return jq, bridge.params_from_numpy(to_numpy(jq), device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape,
                                                dtype=np.int32)


def _random_ring(cfg, b, s_max, seed):
    """(numpy leaves, the port's cache) of a ring filled at random: int8
    values and positive scales, or bf16 values, as if every slot had been
    written."""
    rng = np.random.default_rng(seed)
    cache = R.init_cache(cfg, b, s_max, device="cpu")
    leaves = {}
    for k, v in cache.items():
        if v.dtype == torch.int8:
            a = rng.integers(-127, 128, v.shape).astype(np.int8)
        elif k.endswith("scale"):
            a = rng.uniform(0.005, 0.02, v.shape).astype(np.float32)
        else:
            a = torch.from_numpy(0.5 * rng.standard_normal(v.shape).astype(
                np.float32)).bfloat16().float().numpy()
        v.copy_(torch.from_numpy(a))
        leaves[k] = a
    return leaves, cache


def _jax_cache(jcfg, leaves):
    dtypes = {k: v.dtype for k, v in JR.init_cache(jcfg, 1, 1).items()}
    return {k: jnp.asarray(a).astype(dtypes[k]) for k, a in leaves.items()}


def _clean_positions(port, ref, b, s):
    """(B, S) bool, the positions of a forward whose logits took the
    reference's experts in every layer, from the recorders' entries
    (emptied here).  A token routed otherwise in a layer taints its own
    position, and, through the next layers' attention, every later
    position of its row; each such difference on a position not tainted
    before that layer must sit at a reference near-tie (ROUTE_TIE)."""
    assert len(port) == len(ref) > 0
    tainted = np.zeros((b, s), bool)
    for layer, (got, (want, margin)) in enumerate(zip(port, ref)):
        differ = (np.sort(got, axis=1) != np.sort(want, axis=1)).any(
            axis=1).reshape(b, s)
        fresh = differ & ~tainted
        assert (margin.reshape(b, s)[fresh] <= ROUTE_TIE).all()
        tainted |= differ
        if layer < len(port) - 1:
            tainted |= np.maximum.accumulate(differ, axis=1)
    port.clear()
    ref.clear()
    return ~tainted


def _requests(make, vocab, **kw):
    """N_REQ requests whose prompts cycle through PROMPTS lengths."""
    reqs = make(N_REQ, rate_per_s=3000.0, vocab=vocab,
                prompt_len=max(PROMPTS), max_new_tokens=GEN, **kw)
    return [dataclasses.replace(r, prompt=r.prompt[:PROMPTS[r.rid %
                                                            len(PROMPTS)]])
            for r in reqs]


# ---------------------------------------------------------------------------
# the config, the registry, the ring and the params
# ---------------------------------------------------------------------------

def test_arch_file_matches_reference():
    """The port's arch file holds the JAX one's values field by field, at
    full width and reduced: 8 experts top-2 and no shared expert, window
    4,096, G = 6 of hd 128, an untied vocabulary of 32,768."""
    j, t = jget_config(ARCH), get_config(ARCH)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert t.param_count() == j.param_count()
    assert R.module_for(t) is M
    assert (t.n_experts, t.top_k, t.n_shared_experts, t.window) == \
        (8, 2, 0, 4096)
    assert (t.n_heads // t.n_kv_heads, t.head_dim, t.vocab) == (6, 128, 32768)
    assert not t.tie_embeddings and t.reduced().window == WIN


def test_registry_refuses_paging_speculation_and_the_one_pass_chunk():
    """A window refuses the paged cache and speculation, as the
    reference's registry does, and its chunk runs token by token."""
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      _cfgs()[::-1]):
        assert R.supports_paging(cfg) is JR.supports_paging(jcfg) is False
        assert R.supports_speculation(cfg) is \
            JR.supports_speculation(jcfg) is False
        assert not R.supports_self_draft(cfg)
        assert not R.decodes_chunk_in_one_pass(cfg)
        assert not R.needs_prime(cfg)
    assert R.decodes_chunk_in_one_pass(get_config("qwen2-moe-a2.7b"))
    with pytest.raises(ValueError, match="paged KV cache"):
        R.init_paged_cache(_cfgs()[1], 2, 2 * WIN, 4, 33, device="cpu")


@pytest.mark.parametrize("kv", list(KV))
def test_ring_has_min_of_s_max_and_window_slots(kv):
    """``init_cache`` allocates min(s_max, window) slots, the reference's
    leaves, shapes and dtypes; at full width min(s_max, 4,096)."""
    jcfg, cfg = _cfgs(KV[kv])
    for s_max in (16, WIN, 100):
        jc = JR.init_cache(jcfg, 3, s_max)
        tc = R.init_cache(cfg, 3, s_max, device="cpu")
        assert set(tc) == set(jc)
        for k, v in jc.items():
            assert tuple(tc[k].shape) == v.shape, k
            assert str(tc[k].dtype).split(".")[-1] == str(v.dtype), k
        assert tc["k"].shape[2] == min(s_max, WIN)
    full = dataclasses.replace(get_config(ARCH), n_layers=1, kv_quant=KV[kv])
    for s_max in (1000, 8192):
        c = R.init_cache(full, 1, s_max, device="cpu")
        assert tuple(c["k"].shape) == (1, 1, min(s_max, 4096), 8, 128)


def test_bridge_and_streamed_init_carry_the_tree(params):
    """The JAX tree reaches the port as it is: no shared expert, an untied
    int8 head beside the embedding, int8 expert stacks and an f32 router
    (512 elements, below min_size); the streamed init quantizes the
    leaves ``quantize_tree(init(...))`` does, bit for bit."""
    jq, tq = params
    _, cfg = _cfgs()
    assert set(tq) == {"embed", "layers", "ln_f", "unembed"}
    lp = tq["layers"][1]
    assert set(lp["moe"]) == {"router", "experts"}
    assert isinstance(tq["unembed"]["table"], QTensor)
    np.testing.assert_array_equal(tq["unembed"]["table"].values.numpy(),
                                  np.asarray(jq["unembed"]["table"].values))
    assert lp["moe"]["router"]["w"].dtype == torch.float32
    assert tuple(lp["moe"]["experts"]["w_down"].values.shape) == (4, 256, 128)
    whole = quantize_tree(M.init(torch.Generator().manual_seed(3), cfg,
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
def test_forward_matches_reference_with_the_window(params, mode,
                                                   monkeypatch):
    """The full-sequence forward against the JAX forward under jax.jit,
    (2, 80) tokens: past 64 the window masks the oldest keys.  At every
    position routed as the reference routes it (``_clean_positions``),
    logits within LOGIT_ATOL (W8A8: W8A8_LOGIT_ATOL), greedy tokens
    equal where the reference's top-2 gap is outside it; at least a
    row's positions past the window among them."""
    tm, jm = MODES[mode]
    jcfg, cfg = _cfgs()
    jq, tq = params
    port, ref = _record_routes(monkeypatch)
    toks = _tokens(0, (2, 80), cfg.vocab)
    want = np.asarray(jax.jit(lambda p, t: JR.apply_forward(
        p, jcfg, {"tokens": t}, mode=jm, remat=False))(jq, jnp.asarray(toks)))
    jax.effects_barrier()
    got = ST.make_prefill_step(cfg, mode=tm)(
        tq, {"tokens": torch.from_numpy(toks)})
    clean = _clean_positions(port, ref, 2, 80)
    assert clean[:, WIN:].sum() >= 16, clean
    _check_logits(got.numpy()[clean], want[clean],
                  W8A8_LOGIT_ATOL if mode == "w8a8" else LOGIT_ATOL)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kv", list(KV))
def test_decode_step_matches_reference_per_row(params, kv, mode,
                                               monkeypatch):
    """Eight decode steps of four rows at per-row positions on a random
    64-slot ring, in both packages: rows from 56 (before the ring's end),
    62 and 63 (across it) and 120 (a ring long wrapped, every slot
    valid).  Logits within LOGIT_ATOL (W8A8: W8A8_LOGIT_ATOL) on every row
    routed as the reference routes it, a row left out from the step it
    parts on; both rings hold the same slots written at the end."""
    tm, jm = MODES[mode]
    jcfg, cfg = _cfgs(KV[kv])
    jq, tq = params
    port, ref = _record_routes(monkeypatch)
    leaves, tcache = _random_ring(cfg, 4, 2 * WIN, 1)
    jcache = _jax_cache(jcfg, leaves)
    assert tcache["k"].shape[2] == WIN
    jdecode = jax.jit(lambda p, t, c, i: JM.decode_step(p, t, c, i, jcfg,
                                                         mode=jm))
    decode = ST.make_decode_step(cfg, mode=tm)
    toks = _tokens(2, (8, 4, 1), cfg.vocab)
    start = np.array([56, 62, 63, 120], np.int32)
    parted, compared = np.zeros(4, bool), 0
    for s in range(8):
        jl, jcache = jdecode(jq, jnp.asarray(toks[s]), jcache,
                             jnp.asarray(start + s))
        jax.effects_barrier()
        tl, tcache = decode(tq, {"tokens": torch.from_numpy(toks[s]),
                                 "cache_index": torch.from_numpy(start + s)},
                            tcache)
        _parted_rows(port, ref, parted, ROUTE_TIE)
        _check_logits(tl.numpy()[~parted], np.asarray(jl)[~parted],
                      W8A8_LOGIT_ATOL if mode == "w8a8" else LOGIT_ATOL)
        compared += int((~parted).sum())
    assert compared >= 16, compared
    # the written slots: 56-63, 62-63 and 0-5, 63 and 0-6, 56-63
    for name in ("k", "v"):
        got = (tcache[name].float().numpy()
               != leaves[name].astype(np.float32)).any(-1).any(-1)[0]
        want = (np.asarray(jcache[name]).astype(np.float32)
                != leaves[name].astype(np.float32)).any(-1).any(-1)[0]
        np.testing.assert_array_equal(got, want)
        assert got[1].nonzero()[0].tolist() == [0, 1, 2, 3, 4, 5, 62, 63]


def test_lockstep_row_past_the_window_matches_reference(params,
                                                        monkeypatch):
    """One row decoded alone (a lockstep int index) from position 0 to 70
    on the int8 64-slot ring in both packages: position p lies at slot p %
    64, so the ring ends holding positions 7 .. 70; the logits past the
    wrap read the window's 64 newest positions and stay within LOGIT_ATOL
    of JAX's while the row routes as the reference's."""
    jcfg, cfg = _cfgs(True)
    jq, tq = params
    port, ref = _record_routes(monkeypatch)
    jdecode = jax.jit(JST.make_decode_step(jcfg, mode=JW8A16))
    decode = ST.make_decode_step(cfg, mode=W8A16)
    jcache = JR.init_cache(jcfg, 1, 2 * WIN)
    cache = R.init_cache(cfg, 1, 2 * WIN, device="cpu")
    toks = _tokens(9, (1, 71), cfg.vocab)
    parted, ring_k = np.zeros(1, bool), {}
    for t in range(71):
        tok = toks[:, t:t + 1]
        want, jcache = jdecode(jq, {"tokens": jnp.asarray(tok),
                                    "cache_index": jnp.asarray(t, jnp.int32)},
                               jcache)
        jax.effects_barrier()
        got, cache = decode(tq, {"tokens": torch.from_numpy(tok),
                                 "cache_index": t}, cache)
        _parted_rows(port, ref, parted, ROUTE_TIE)
        ring_k[t] = cache["k"][:, 0, t % WIN].clone()
        if not parted[0]:
            _check_logits(got.numpy(), np.asarray(want), LOGIT_ATOL)
    for p in range(71 - WIN, 71):
        assert torch.equal(cache["k"][:, 0, p % WIN], ring_k[p])
    assert not torch.equal(ring_k[6], ring_k[70])


def test_lockstep_tokens_across_the_ring_end_clamp_as_the_reference(
        params, monkeypatch):
    """Four tokens of a row fed at once (an int index, and the per-row
    form) from position 62 of the 64-slot ring: the reference's
    ``dynamic_update_slice`` clamps their start to slot 60, and the port
    writes them there too (positions 62-65 at slots 60-63; RoPE at the
    positions), with the reference's logits; a causal pass across a ring
    raises."""
    jcfg, cfg = _cfgs(True)
    jq, tq = params
    port, ref = _record_routes(monkeypatch)
    leaves, cache = _random_ring(cfg, 1, 2 * WIN, 4)
    jcache = _jax_cache(jcfg, leaves)
    toks = _tokens(5, (1, 4), cfg.vocab)
    want, jcache = jax.jit(lambda p, t, c: JM.decode_step(
        p, t, c, 62, jcfg, mode=JW8A16))(jq, jnp.asarray(toks), jcache)
    jax.effects_barrier()
    per_row = {k: v.clone() for k, v in cache.items()}
    got, _ = M.decode_step(tq, torch.from_numpy(toks), cache, 62, cfg,
                           mode=W8A16)
    if not _parted_rows(port, ref, np.zeros(1, bool), ROUTE_TIE)[0]:
        _check_logits(got.numpy(), np.asarray(want), LOGIT_ATOL)
    rows, _ = M.decode_step(tq, torch.from_numpy(toks), per_row,
                            torch.tensor([62], dtype=torch.int32), cfg,
                            mode=W8A16)
    assert torch.equal(got, rows)
    for name in cache:
        assert torch.equal(cache[name], per_row[name]), name
        changed = (cache[name].float().numpy()
                   != leaves[name].astype(np.float32)).reshape(
                       cfg.n_layers, WIN, -1).any(-1).any(0)
        assert changed.nonzero()[0].tolist() == [60, 61, 62, 63], name
        np.testing.assert_array_equal(
            changed, (np.asarray(jcache[name]).astype(np.float32)
                      != leaves[name].astype(np.float32)).reshape(
                          cfg.n_layers, WIN, -1).any(-1).any(0))
    with pytest.raises(ValueError, match="one causal pass"):
        M.decode_step(tq, torch.from_numpy(toks), cache,
                      torch.tensor([62], dtype=torch.int32), cfg,
                      mode=W8A16, causal=True)


# ---------------------------------------------------------------------------
# the slot tick and the chunk step on the ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv", list(KV))
def test_chunk_step_equals_per_token_steps_on_a_wrapped_ring(kv):
    """The W8A16 chunk step of slot 2 of a four-slot pool (eager and
    captured) writes the bytes that ``make_per_token_chunk_step`` writes,
    for every n_valid up to 4, from positions before (56), across (62)
    and past (66, 125) the ring's end; the other slots are untouched.
    The router is quantized too (``min_size`` 512), as at full width,
    where every projection is int8 and a full-attention chunk would take
    the one causal pass: on a ring it runs token by token."""
    _, cfg = _cfgs(KV[kv])
    tq = quantize_tree(M.init(torch.Generator().manual_seed(5), cfg,
                              device="cpu"), min_size=512)
    assert ST._projections_quantized(tq)
    eager = ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=4)
    graphed = ST.jit_prefill_chunk_step(
        ST.make_prefill_chunk_step(cfg, mode=W8A16, chunk=4))
    per_token = ST.make_per_token_chunk_step(cfg, mode=W8A16, chunk=4)
    _, base = _random_ring(cfg, 4, 2 * WIN, 11)
    others = torch.tensor([0, 1, 3])
    toks = [17, 250, 3, 99]
    for start in (56, 62, 66, 125):
        for n in range(1, 5):
            want = {k: v.clone() for k, v in base.items()}
            per_token(tq, toks, want, 2, start, n)
            for fn in (eager, graphed):
                c = {k: v.clone() for k, v in base.items()}
                fn(tq, toks, c, 2, start, n)
                for k in c:
                    assert torch.equal(c[k], want[k]), (k, n, start)
                    assert torch.equal(c[k].index_select(1, others),
                                       base[k].index_select(1, others))


def test_row_held_inactive_across_the_wrap_resumes_as_never_held(params):
    """Row 0 at position 66 (its ring wrapped) sits inactive through three
    ticks while row 1 advances, then resumes: its next three tokens and
    its ring row equal those of the same row never held, bitwise.  The
    inactive ticks wrote only slot 66 % 64, which holds position 2 (out
    of the window) and which the row's first real step overwrites before
    any read."""
    _, cfg = _cfgs(True)
    _, tq = params
    tick = ST.make_slot_decode_step(cfg, mode=W8A16)
    _, start = _random_ring(cfg, 2, 2 * WIN, 12)
    idx0 = torch.tensor([66, 40], dtype=torch.int32)
    tok = torch.tensor([[11], [23]], dtype=torch.int32)
    held = {k: v.clone() for k, v in start.items()}
    never = {k: v.clone() for k, v in start.items()}
    idx, t = idx0.clone(), tok.clone()
    for _ in range(3):
        nxt, _, idx = tick(tq, t, held, idx, torch.tensor([False, True]))
        t = torch.stack([tok[0], nxt[1:2]]).reshape(2, 1).int()
    assert int(idx[0]) == 66
    assert not torch.equal(held["k"][:, 0, 2], start["k"][:, 0, 2])
    outs = {}
    both = torch.tensor([True, True])
    for name, cache, i in (("held", held, idx), ("never", never,
                                                 idx0.clone())):
        t, got = torch.tensor([[11], [1]], dtype=torch.int32), []
        for _ in range(3):
            nxt, _, i = tick(tq, t, cache, i, both)
            got.append(int(nxt[0]))
            t = nxt.reshape(2, 1).int()
        outs[name] = got
    assert outs["held"] == outs["never"]
    for k in start:
        assert torch.equal(held[k][:, 0], never[k][:, 0]), k


def test_decode_rows_do_not_depend_on_the_batch(params):
    """A row decoded alone (batch 1, lockstep index) equals the same row in
    a batch of four at per-row positions straddling the ring's end (0, 63,
    64, 100), bitwise: logits and every cache leaf."""
    _, cfg = _cfgs(True)
    _, tq = params
    decode = ST.make_decode_step(cfg, mode=W8A16)
    _, cache = _random_ring(cfg, 4, 2 * WIN, 8)
    rows = [{k: v[:, r:r + 1].clone() for k, v in cache.items()}
            for r in range(4)]
    toks = torch.tensor([[5], [77], [301], [9]], dtype=torch.int32)
    idx = torch.tensor([0, 63, 64, 100], dtype=torch.int32)
    full, cache = decode(tq, {"tokens": toks, "cache_index": idx}, cache)
    for r in range(4):
        one, rows[r] = decode(tq, {"tokens": toks[r:r + 1],
                                   "cache_index": int(idx[r])}, rows[r])
        assert torch.equal(one[0], full[r])
        for k in cache:
            assert torch.equal(rows[r][k], cache[k][:, r:r + 1]), k


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def _engine(cfg, tq, temperature=0.0, **kw):
    kw.setdefault("num_slots", 4)
    return E.Engine(cfg, tq, mode=W8A16, max_seq=MAX_SEQ, prefill_chunk=4,
                    device="cpu", temperature=temperature,
                    rng=PRNGKey(3) if temperature else None, **kw)


_REF = {}


def _reference(kv, tq, t):
    if (kv, t) not in _REF:
        _, cfg = _cfgs(KV[kv])
        reqs = _requests(E.synthetic_requests, cfg.vocab)
        _REF[kv, t] = reqs, E.reference_outputs(
            cfg, tq, reqs, mode=W8A16, max_seq=MAX_SEQ, device="cpu",
            temperature=t, rng=PRNGKey(3) if t else None)
    return _REF[kv, t]


@pytest.mark.parametrize("temperature", [0.0, 0.8],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("kv", list(KV))
def test_engine_equals_reference_bit_for_bit(params, kv, temperature):
    """``Engine.serve`` on the int8 and the bf16 ring, greedy and sampled:
    6 requests of 48-80 prompt tokens and 8 new ones through 4 slots
    (every row past the 64-slot ring's end, slots reused, chunks of 4 run
    token by token), every token equal to the sequential batch-1
    reference's."""
    _, cfg = _cfgs(KV[kv])
    _, tq = params
    reqs, want = _reference(kv, tq, temperature)
    eng = _engine(cfg, tq, temperature)
    assert eng.zeroed_cache()["k"].shape[2] == WIN
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rep = eng.serve(reqs)
    assert rep.outputs() == want
    assert {r.slot for r in rep.results} == set(range(4))
    assert rep.admissions_while_busy > 0
    assert all(len(r.tokens) == GEN and r.status == "ok"
               for r in rep.results)


def _teacher_forced(jcfg, cfg, jq, tq, reqs, toks, monkeypatch):
    """Both packages' batch-1 decode steps fed each request's prompt, then
    ``toks[rid]`` (the port's greedy tokens): ({rid: the JAX step's greedy
    token after each fed token of ``toks``}, {rid: the JAX top-2 logit gap
    there}, {rid: the first position at which the two packages route a
    token to other experts in some layer, the length fed if none}).
    Each such position is a reference near-tie (``_parted_rows``).  Up to
    the first index where the JAX token differs from ``toks``, the JAX
    tokens and gaps are those of the JAX sequential reference."""
    port, ref = _record_routes(monkeypatch)
    jdecode = jax.jit(JST.make_decode_step(jcfg, mode=JW8A16))
    decode = ST.make_decode_step(cfg, mode=W8A16)
    jtoks, gaps, parts = {}, {}, {}
    for r in reqs:
        seq = list(r.prompt) + toks[r.rid][:-1]
        jcache = JR.init_cache(jcfg, 1, MAX_SEQ)
        cache = R.init_cache(cfg, 1, MAX_SEQ, device="cpu")
        jtoks[r.rid], gaps[r.rid], parts[r.rid] = [], [], len(seq)
        for p, tok in enumerate(seq):
            t = np.array([[tok]], np.int32)
            logits, jcache = jdecode(
                jq, {"tokens": jnp.asarray(t),
                     "cache_index": jnp.asarray(p, jnp.int32)}, jcache)
            jax.effects_barrier()
            if parts[r.rid] == len(seq):
                decode(tq, {"tokens": torch.from_numpy(t),
                            "cache_index": p}, cache)
                if _parted_rows(port, ref, np.zeros(1, bool), ROUTE_TIE)[0]:
                    parts[r.rid] = p
            else:
                port.clear()
                ref.clear()
            if p >= len(r.prompt) - 1:
                row = np.asarray(logits[0, -1])
                top2 = np.sort(row)[-2:]
                jtoks[r.rid].append(int(row.argmax()))
                gaps[r.rid].append(float(top2[1] - top2[0]))
    return jtoks, gaps, parts


@pytest.mark.parametrize("kv", list(KV))
def test_engine_matches_the_jax_engine(params, kv, monkeypatch):
    """The port's engine and the JAX engine on the same weights and trace:
    greedy tokens equal up to the first step where either parts from the
    JAX sequential reference, and that step is one where the reference's
    top-2 logit gap is within LOGIT_ATOL; or up to the first position at
    which the two packages route a token otherwise, which must be a
    routing near-tie (``_teacher_forced``): from there on the histories
    the logits read differ."""
    jcfg, cfg = _cfgs(KV[kv])
    jq, tq = params
    reqs, want = _reference(kv, tq, 0.0)
    jreqs = _requests(JE.synthetic_requests, jcfg.vocab)
    assert [(r.rid, r.prompt) for r in jreqs] == \
        [(r.rid, r.prompt) for r in reqs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jout = JE.Engine(jcfg, jq, mode=JW8A16, num_slots=4, max_seq=MAX_SEQ,
                         prefill_chunk=4).serve(jreqs).outputs()
    jref, gaps, parts = _teacher_forced(jcfg, cfg, jq, tq, jreqs, want,
                                        monkeypatch)
    assert want.keys() == jout.keys()

    def first_difference(a, b):
        return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                    len(a))

    compared = 0
    for r in jreqs:
        rid, toks = r.rid, jout[r.rid]
        assert len(want[rid]) == len(toks) == GEN
        # token i is read from the logits at position len(prompt) - 1 + i
        routed = max(0, parts[rid] - len(r.prompt) + 1)
        first = min(first_difference(want[rid], toks),
                    first_difference(toks, jref[rid]))
        upto = min(first, routed)
        assert want[rid][:upto] == toks[:upto], (rid, upto)
        compared += upto
        if first < routed and first < GEN:
            assert gaps[rid][first] <= LOGIT_ATOL, (rid, first, gaps[rid])
    assert compared >= GEN, (compared, parts)


def test_preemption_resume_past_the_wrap_equals_reference(params):
    """The batch class (rids 0, 3, 6) arrives first and fills a two-slot
    pool; the interactive requests arrive 20 virtual ticks later and evict
    batch rows, more than 64 re-prefilled tokens a resume on average, so
    at least one resume rebuilds its ring from position 0 past the ring's
    end (through the chunk steps, over a slot another tenant wrapped
    since).  Every request equals the reference."""
    _, cfg = _cfgs(True)
    _, tq = params
    reqs, want = _reference("int8", tq, 0.0)
    reqs = [dataclasses.replace(
        r, arrival_s=0.0 if r.rid % 3 == 0 else 0.02,
        priority="batch" if r.rid % 3 == 0 else "interactive")
        for r in reqs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rep = _engine(cfg, tq, num_slots=2).serve(reqs, preemption=True)
    assert rep.preempted > 0
    assert rep.resumed_prefill_tokens > rep.preempted * WIN
    assert rep.outputs() == want


def test_engine_refuses_paging_and_speculation(params):
    """The reference's refusals, in its words: no paged cache and no
    speculation on a window."""
    _, cfg = _cfgs()
    _, tq = params
    with pytest.raises(ValueError, match="does not support the paged KV"):
        _engine(cfg, tq, block_size=4)
    with pytest.raises(ValueError, match="rewindable positional KV"):
        _engine(cfg, tq, spec_k=2, draft_layers=1)


# ---------------------------------------------------------------------------
# the serve CLI
# ---------------------------------------------------------------------------

def test_serve_cli_runs_mixtral_past_the_wrap(capsys):
    """``--arch mixtral-8x22b --reduced --device cpu --prompt-len 72``
    through the serve CLI: the curve's forward, the decode loop and the
    engine (every prompt past the 64-slot ring), every request equal to
    ``reference_outputs``; ``--block-size`` and ``--spec-k`` are rejected
    as in the reference."""
    base = ["--arch", ARCH, "--reduced", "--device", "cpu", "--max-batch",
            "4", "--seq", "8", "--deadline-ms", "60000", "--n-requests", "4",
            "--prefill-chunk", "4", "--prompt-len", "72", "--gen-tokens",
            "4", "--decode-tokens", "4"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = serve.run(serve.parse_args(base))
    out = capsys.readouterr().out
    assert res.code == 0, out
    assert f"[quant] {ARCH} weights" in out and "[decode]" in out
    assert res.engine._cache["k"].shape[2] == WIN
    rep = res.report
    assert len(rep.results) == 4 and all(r.status == "ok"
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
