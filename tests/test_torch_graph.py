"""The compiled-step boundary on the CPU at reduced size: the captured slot
tick and decode loop (``runtime/steps.py`` ``jit_*``, ``runtime/graphs.py``)
through their static-buffer path, which the CPU runs eagerly, against the
eager steps (bitwise) and against the JAX package's jitted steps; the
launch-count bookkeeping of a capture; the hoisted LM head; the engine's
own cache; and the multi-token positions of ``decode_step``.

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
from repro.core.qlinear import W8A8 as JW8A8
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import registry as JR
from repro.runtime import steps as JST
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import W8A8, W8A16
from repro_torch.core.quant import QTensor
from repro_torch.kernels import counts
from repro_torch.kernels import decode_attention as A
from repro_torch.kernels import ops
from repro_torch.kernels import qmatmul as K
from repro_torch.models import bridge
from repro_torch.models import layers as L
from repro_torch.models import registry as R
from repro_torch.models import transformer as T
from repro_torch.runtime import graphs as G
from repro_torch.runtime import steps as ST

from test_torch_cuda import GRAPH_BS, fill_history, tick_args, tick_schedule
from test_torch_forward import W8A8_LOGIT_ATOL
from test_torch_model import LOGIT_ATOL, to_numpy

MODES = {"w8a16": (W8A16, JW8A16, LOGIT_ATOL),
         "w8a8": (W8A8, JW8A8, W8A8_LOGIT_ATOL)}
SLOTS, MAX_SEQ, TICKS = 4, 16, 6


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
    """Reduced starcoder2-3b, int8 weights, in both packages (the int8
    and the bf16 cache differ only in the config's kv_quant)."""
    jcfg, _ = _cfgs(True)
    jq = jquantize_tree(JR.init(jax.random.PRNGKey(0), jcfg), min_size=2048)
    return jq, bridge.params_from_numpy(to_numpy(jq), device="cpu")


def _jax_cache(cache):
    """The port's cache as the reference's: the same bytes, as jnp."""
    out = {}
    for k, v in cache.items():
        if v.dtype == torch.bfloat16:
            out[k] = jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
        else:
            out[k] = jnp.asarray(v.numpy())
    return out


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _gap(logits):
    """The top-2 gap of each row's last-position logits."""
    top2 = np.sort(np.asarray(logits, np.float32)[:, -1], axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


# ---------------------------------------------------------------------------
# the captured slot tick
# ---------------------------------------------------------------------------

# name -> (paged, kv_quant)
CACHES = {"int8": (False, True), "paged": (True, True), "bf16": (False, False)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", list(CACHES))
def test_captured_tick_equals_eager_and_jax(setup, kind, mode):
    """Six ticks with rows retiring and admitted between them (paged: a
    table row changed in place): the captured tick, through the static
    buffers the CPU runs eagerly, is bitwise the eager
    ``make_slot_decode_step`` (next tokens, indices, every cache leaf) and
    binds once; against the JAX ``jit_slot_decode_step`` on the same
    cache bytes and inputs, the indices are equal and the next tokens
    equal wherever the reference's top-2 gap is outside the logit
    tolerance (tests/test_torch_model.py; W8A8:
    tests/test_torch_forward.py)."""
    jq, tq = setup
    paged, kv_quant = CACHES[kind]
    jcfg, cfg = _cfgs(kv_quant)
    tm, jm, atol = MODES[mode]
    mb = MAX_SEQ // GRAPH_BS if paged else 0
    sched = tick_schedule(SLOTS, MAX_SEQ, TICKS, cfg.vocab, 0, mb)
    if paged:
        cache = R.init_paged_cache(cfg, SLOTS, MAX_SEQ, GRAPH_BS,
                                   SLOTS * mb + mb + 1, device="cpu")
        cache["block_tables"].copy_(torch.from_numpy(sched[0]["tables"]))
    else:
        cache = R.init_cache(cfg, SLOTS, MAX_SEQ, device="cpu")
    fill_history(cfg, tq, tm, cache, MAX_SEQ - TICKS, 0)
    jcache = _jax_cache(cache)
    other = _clone(cache)
    eager = ST.make_slot_decode_step(cfg, mode=tm)
    graphed = ST.jit_slot_decode_step(ST.make_slot_decode_step(cfg,
                                                               mode=tm))
    jstep = JST.jit_slot_decode_step(JST.make_slot_decode_step(jcfg,
                                                               mode=jm))
    jlogits = jax.jit(lambda p, t, c, i: JR.apply_decode(
        p, jcfg, {"tokens": t, "cache_index": i}, c, mode=jm)[0])
    compared = 0
    for t, tick in enumerate(sched):
        if paged:
            for c in (cache, other):
                c["block_tables"].copy_(torch.from_numpy(tick["tables"]))
            jcache["block_tables"] = jnp.asarray(tick["tables"])
        args = tick_args(tick, "cpu")
        n_e, _, i_e = eager(tq, args[0], cache, *args[1:])
        n_g, _, i_g = graphed(tq, args[0], other, *args[1:])
        assert torch.equal(n_g, n_e) and torch.equal(i_g, i_e), t
        for name in cache:
            assert torch.equal(other[name], cache[name]), (t, name)
        jargs = [jnp.asarray(tick[k]) for k in ("tokens", "index", "active")]
        gap = _gap(jlogits(jq, jargs[0], jcache, jargs[1]))
        jn, jcache, ji = jstep(jq, jargs[0], jcache, *jargs[1:])
        np.testing.assert_array_equal(i_g.numpy(), np.asarray(ji))
        clear = tick["active"] & (gap > atol)
        np.testing.assert_array_equal(n_g.numpy()[clear],
                                      np.asarray(jn)[clear])
        assert (n_g.numpy()[~tick["active"]] == 0).all()
        compared += int(clear.sum())
    assert graphed.captured.captures == 1
    assert compared >= TICKS * (SLOTS - 1) // 2, compared


# ---------------------------------------------------------------------------
# the captured decode loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", list(MODES))
def test_captured_decode_loop_equals_eager_and_jax(setup, mode):
    """The serve CLI's loop (bf16 cache), 5 tokens from start 0 on a zero
    cache, then from start 3 on what the first run left: the captured loop
    (one binding, the start in a static buffer) is bitwise the eager loop,
    which steps an int position; against the JAX ``jit_decode_loop`` on
    the same cache bytes, a row's greedy tokens equal the reference's up
    to a step where its top-2 gap is within the logit tolerance, after
    which the two decode different inputs."""
    jq, tq = setup
    jcfg, cfg = _cfgs(False)
    tm, jm, atol = MODES[mode]
    b, n = 3, 5
    rng = np.random.default_rng(5)
    eager = ST.make_decode_loop(cfg, mode=tm, num_tokens=n)
    graphed = ST.jit_decode_loop(ST.make_decode_loop(cfg, mode=tm,
                                                     num_tokens=n))
    jloop = JST.jit_decode_loop(JST.make_decode_loop(jcfg, mode=jm,
                                                     num_tokens=n))
    jdecode = jax.jit(lambda p, t, c, i: JR.apply_decode(
        p, jcfg, {"tokens": t, "cache_index": i}, c, mode=jm))
    cache = R.init_cache(cfg, b, MAX_SEQ, device="cpu")
    other = R.init_cache(cfg, b, MAX_SEQ, device="cpu")
    for start in (0, 3):
        seed = rng.integers(1, cfg.vocab, (b, 1)).astype(np.int32)
        before = _clone(cache)
        want, _ = eager(tq, torch.from_numpy(seed), cache, start)
        got, _ = graphed(tq, torch.from_numpy(seed), other, start)
        assert torch.equal(got, want), start
        for name in cache:
            assert torch.equal(other[name], cache[name]), start
        # the reference: its loop, and its steps one by one for the gaps
        jout = np.asarray(jloop(jq, jnp.asarray(seed), _jax_cache(before),
                                start)[0])
        jcache = _jax_cache(before)
        tok, gaps = jnp.asarray(seed), []
        for i in range(n):
            logits, jcache = jdecode(jq, tok, jcache, start + i)
            gaps.append(_gap(logits))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:,
                                                                       None]
        for r in range(b):
            first = next((i for i in range(n)
                          if got[r, i] != jout[r, i]), None)
            if first is not None:
                assert gaps[first][r] <= atol, (start, r, first)
    assert graphed.captured.captures == 1


# ---------------------------------------------------------------------------
# the pieces under the capture
# ---------------------------------------------------------------------------

def test_hoisted_lm_head_is_bitwise_the_per_call_transpose(setup):
    """``unembed`` through the head made once per table gives bitwise the
    logits of a transposed copy made at the call, and every call reads
    the same head."""
    _, tq = setup
    table = tq["embed"]["table"]
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(5, table.shape[1])).astype(np.float32)).to(torch.bfloat16)
    per_call = QTensor(values=table.values.t().contiguous(),
                       scale=table.scale.reshape(-1))
    want = ops.qmatmul(x, per_call, out_dtype=torch.float32)
    got = L.unembed(tq["embed"], x)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    head = L.lm_head(table)
    assert L.lm_head(table) is head
    assert torch.equal(head.values, per_call.values)
    L.unembed(tq["embed"], x)
    assert L.lm_head(table).values.data_ptr() == head.values.data_ptr()


def test_capture_takes_back_its_counts_and_replays_add_them():
    """The bookkeeping a capture runs its step under, with a stub step
    that bumps the counters as the kernel wrappers do: the capture's
    counts are recorded and taken back (nothing ran), and each replay
    adds them once."""
    def stub():
        K.qmatmul_w8a16.launches += 3
        K.qmatmul_w8a16.launches_by_path["gemv"] += 3
        A.decode_attention_int8.launches += 2

    before = counts.snapshot()
    with counts.recorded() as rec:
        stub()
    assert counts.snapshot() == before
    assert rec == {"qmatmul_w8a16": 3, "qmatmul_w8a16[gemv]": 3,
                   "decode_attention_int8": 2}
    for _ in range(2):
        counts.add(rec)
    assert counts.difference(counts.snapshot(), before) == {
        "qmatmul_w8a16": 6, "qmatmul_w8a16[gemv]": 6,
        "decode_attention_int8": 4}
    counts.add(rec, -2)
    with pytest.raises(ZeroDivisionError):
        with counts.recorded() as rec:
            stub()
            1 / 0
    assert counts.snapshot() == before and rec["decode_attention_int8"] == 2


def test_captured_step_binds_anew_on_other_tensors():
    """A captured step rebinds (on the card: captures) when the cache or a
    param leaf is not the tensor it was bound to, or an input's shape
    changes, and returns the same static outputs otherwise."""
    step = G.CapturedStep(lambda p, c, x: (x + p["w"].sum() + c["k"],))
    params, cache = {"w": torch.ones(2)}, {"k": torch.zeros(3)}
    out = step(params, cache, torch.ones(3))
    assert step.captures == 1 and torch.equal(out[0], torch.full((3,), 3.))
    again = step(params, cache, torch.full((3,), 2.))
    assert again[0] is out[0] and step.captures == 1
    assert torch.equal(out[0], torch.full((3,), 4.))
    step(params, {"k": torch.zeros(3)}, torch.ones(3))
    assert step.captures == 2
    step({"w": torch.ones(2)}, cache, torch.ones(3))
    assert step.captures == 3
    step(params, cache, torch.ones((2, 3)))
    assert step.captures == 4 and step.outputs[0].shape == (2, 3)
    step.release()
    assert step.outputs == () and step.graph is None


def test_single_device_executor_hands_out_the_captured_tick():
    _, cfg = _cfgs(True)
    ex = E.SingleDeviceExecutor()
    step = ex.slot_step(cfg, mode=W8A16, temperature=0.0)
    assert isinstance(step.captured, G.CapturedStep)
    assert ex.slot_step(cfg, mode=W8A16, temperature=0.0) is step
    assert step is ST.cached_slot_decode_step(cfg, mode=W8A16)
    assert ex.slot_step(cfg, mode=W8A8, temperature=0.0) is not step


@pytest.mark.parametrize("block_size", [None, 4])
def test_two_serves_on_one_engine_give_the_same_tokens(setup, block_size):
    """The engine keeps one cache (zeroed in place for each run) and the
    captured tick stays bound to it: after warmup, two serves bind
    nothing anew and give the same tokens, equal to the reference."""
    _, tq = setup
    _, cfg = _cfgs(True)
    reqs = E.synthetic_requests(8, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=5, max_new_tokens=4)
    eng = E.Engine(cfg, tq, mode=W8A16, num_slots=4, max_seq=12,
                   prefill_chunk=4, block_size=block_size, device="cpu")
    eng.warmup()
    step = eng.backend.slot_step(cfg, mode=W8A16, temperature=0.0)
    captures, cache = step.captured.captures, eng.zeroed_cache()
    first = eng.serve(reqs).outputs()
    assert eng.serve(reqs).outputs() == first
    assert step.captured.captures == captures
    assert eng.zeroed_cache() is cache
    assert all(not t.any() for t in cache.values())
    assert first == E.reference_outputs(cfg, tq, reqs, mode=W8A16,
                                        max_seq=eng.max_seq, device="cpu")


# ---------------------------------------------------------------------------
# multi-token positions (decode_step, cache_write)
# ---------------------------------------------------------------------------

def test_decode_step_positions_are_the_references(setup, monkeypatch):
    """``decode_step`` of s = 3 tokens gives token j the position
    ``cache_index + j`` in both forms, as the JAX formula
    (``repro/models/transformer.py`` decode_step) computes it; attention
    against a cache still takes one token a step and raises."""
    _, tq = setup
    _, cfg = _cfgs(True)
    seen = []
    real = L.rope_cos_sin

    def spy(positions, *a, **kw):
        seen.append(positions.clone())
        return real(positions, *a, **kw)

    monkeypatch.setattr(T.L, "rope_cos_sin", spy)
    toks = torch.ones((2, 3), dtype=torch.int32)
    for ci, want in ((5, 5 + jnp.arange(3)[None, :]),
                     (torch.tensor([4, 9], dtype=torch.int32),
                      jnp.asarray([4, 9])[:, None] + jnp.arange(3)[None, :])):
        cache = R.init_cache(cfg, 2, 16, device="cpu")
        with pytest.raises(NotImplementedError, match="item 14"):
            T.decode_step(tq, toks, cache, ci, cfg, mode=W8A16)
        got = seen.pop()
        assert got.dtype == torch.int32 and got.shape == (2, 3)
        np.testing.assert_array_equal(
            got.numpy(), np.broadcast_to(np.asarray(want), (2, 3)))


def test_cache_write_writes_every_column():
    """``cache_write`` of 3 columns, in each form, equals a numpy write at
    the same places."""
    rng = np.random.default_rng(7)
    new = rng.integers(-127, 128, (2, 3, 2, 4)).astype(np.int8)
    c = torch.zeros((2, 10, 2, 4), dtype=torch.int8)
    L.cache_write(c, torch.from_numpy(new), 4)
    want = np.zeros((2, 10, 2, 4), np.int8)
    want[:, 4:7] = new
    np.testing.assert_array_equal(c.numpy(), want)
    pos = np.array([[1, 2, 3], [6, 7, 8]])
    c = torch.zeros((2, 10, 2, 4), dtype=torch.int8)
    L.cache_write(c, torch.from_numpy(new), (torch.arange(2)[:, None],
                                             torch.from_numpy(pos)))
    want = np.zeros((2, 10, 2, 4), np.int8)
    for r in range(2):
        want[r, pos[r]] = new[r]
    np.testing.assert_array_equal(c.numpy(), want)
    blocks, offs = np.array([[3, 3, 1], [2, 2, 2]]), np.array(
        [[2, 3, 0], [0, 1, 2]])
    c = torch.zeros((4, 4, 2, 4), dtype=torch.int8)
    L.cache_write(c, torch.from_numpy(new), (torch.from_numpy(blocks),
                                             torch.from_numpy(offs)))
    want = np.zeros((4, 4, 2, 4), np.int8)
    want[blocks, offs] = new
    np.testing.assert_array_equal(c.numpy(), want)


@pytest.mark.parametrize("kv_quant", [True, False], ids=["int8", "bf16"])
def test_lockstep_per_row_form_is_bitwise_the_int_form(setup, kv_quant):
    """Four lockstep steps with the position as an int and as a (B,)
    tensor of one value (the captured loop's form): the same rope angles,
    the same cache bytes and the same logits, bit for bit."""
    _, tq = setup
    _, cfg = _cfgs(kv_quant)
    rng = np.random.default_rng(8)
    a = R.init_cache(cfg, 3, 16, device="cpu")
    b = R.init_cache(cfg, 3, 16, device="cpu")
    for i in range(4):
        toks = torch.from_numpy(rng.integers(1, cfg.vocab, (3, 1)).astype(
            np.int32))
        idx = torch.full((3,), 2 + i, dtype=torch.int32)
        pa = T.decode_positions(2 + i, 3, 1, "cpu")
        pb = T.decode_positions(idx, 3, 1, "cpu")
        for x, y in zip(L.rope_cos_sin(pa, cfg.head_dim, cfg.rope_theta),
                        L.rope_cos_sin(pb, cfg.head_dim, cfg.rope_theta)):
            assert torch.equal(x, y)
        la, _ = T.decode_step(tq, toks, a, 2 + i, cfg, mode=W8A16)
        lb, _ = T.decode_step(tq, toks, b, idx, cfg, mode=W8A16)
        assert torch.equal(la, lb), i
        for name in a:
            assert torch.equal(a[name], b[name]), (i, name)
