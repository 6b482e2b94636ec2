"""Temperature sampling in the port, on the CPU, against the JAX package:
the threefry keys and draws of ``repro_torch/runtime/prng.py`` against
installed JAX's (``jax.random``, threefry2x32, partitionable), the
samplers of ``runtime/steps.py``, the sampled decode loop and slot tick
(eager and through ``CapturedStep``), and the sampled engine against its
own sequential reference (bit for bit) and the JAX engine (token for
token, but at near-ties).

The bounds:

- keys, random bits and uniform draws: bitwise;
- Gumbel noise: within ``GUMBEL_ULPS`` units in the last place of
  ``max(|g|, 1)``: ``log`` differs between XLA's CPU and torch's CPU by
  an ulp here and there, and ``-log(-log(u))`` carries the inner
  error as an absolute one;
- a sampled token may part from JAX's only where the perturbed scores'
  top-2 gap (``logits / t + gumbel``) lies within the score error:
  ``SCORE_TOL`` from the noise alone, plus ``LOGIT_ATOL / t`` where the
  logits come from two models (tests/test_torch_model.py).

JAX keys reach the port through numpy: ``np.asarray(jax_key)`` is the
key's two uint32 words."""
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.configs import get_config as jget_config
from repro.core.qlinear import W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import registry as JR
from repro.runtime import steps as JST
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core.qlinear import W8A16
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.runtime import prng as P
from repro_torch.runtime import steps as ST

from test_torch_model import LOGIT_ATOL, to_numpy

GUMBEL_ULPS = 4
# the perturbed scores' error from the noise alone: GUMBEL_ULPS ulps of
# the largest Gumbel draw f32 makes from 2^32 words (-log(-log(tiny))
# is about 4.5, -log(-log(1 - 2^-24)) about 16.6)
SCORE_TOL = 2 * GUMBEL_ULPS * float(np.spacing(np.float32(16.6)))
SEEDS = (0, 1, 7, 2 ** 31 - 1)
VOCABS = (1, 7, 4096, 49152, 152064)
TEMP = 0.8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _words(x) -> np.ndarray:
    """A JAX uint32 array's words as int64, the port's form."""
    return np.asarray(x).astype(np.int64)


def _key(seed: int):
    """(the JAX key, the port's key through numpy)."""
    jk = jax.random.PRNGKey(seed)
    return jk, P.as_key(np.asarray(jk))


def _row_keys(jk, n: int):
    return jax.vmap(lambda p: jax.random.fold_in(jk, p))(
        jnp.arange(n, dtype=jnp.int32))


def _gumbel_ulps(want: np.ndarray, got: np.ndarray) -> float:
    unit = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    return float((np.abs(want.astype(np.float64) - got) / unit).max())


# ---------------------------------------------------------------------------
# the PRNG against jax.random
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    jk, tk = _key(seed)
    assert np.array_equal(_words(jk), P.PRNGKey(seed).numpy())
    assert np.array_equal(_words(jk), tk.numpy())
    pos = np.arange(4096, dtype=np.int32)
    want = _words(jax.vmap(lambda p: jax.random.fold_in(jk, p))(pos))
    assert np.array_equal(want, P.fold_in(tk, torch.from_numpy(pos)).numpy())
    for p in (0, 17, 4095, 2 ** 31 - 1):
        assert np.array_equal(_words(jax.random.fold_in(jk, p)),
                              P.fold_in(tk, p).numpy())


@pytest.mark.parametrize("vocab", VOCABS)
def test_random_bits_and_uniform_match_jax(vocab):
    """One key over (V,) and over (3, V) (a flat counter), and three
    fold_in row keys over (V,) each (the engine's rows): the words and
    ``uniform(minval=tiny)`` bitwise."""
    jk, tk = _key(7)
    tiny = float(np.finfo(np.float32).tiny)
    for shape in ((vocab,), (3, vocab)):
        want = _words(jax.random.bits(jk, shape, jnp.uint32))
        assert np.array_equal(want, P.random_bits(tk, shape).numpy())
        ju = np.asarray(jax.random.uniform(jk, shape, minval=tiny,
                                           maxval=1.0))
        tu = P.uniform(tk, shape, tiny, 1.0).numpy()
        assert np.array_equal(ju.view(np.int32), tu.view(np.int32))
    jkeys = _row_keys(jk, 3)
    tkeys = P.fold_in(tk, torch.arange(3))
    want = _words(jax.vmap(lambda k: jax.random.bits(k, (vocab,),
                                                     jnp.uint32))(jkeys))
    assert np.array_equal(want, P.random_bits(tkeys, (3, vocab)).numpy())
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (vocab,), minval=tiny, maxval=1.0))(jkeys))
    assert np.array_equal(ju.view(np.int32),
                          P.uniform(tkeys, (3, vocab), tiny,
                                    1.0).numpy().view(np.int32))


@pytest.mark.parametrize("vocab", VOCABS)
def test_gumbel_within_ulp_bound(vocab):
    for seed in (0, 123):
        jk, tk = _key(seed)
        want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
            k, (vocab,)))(_row_keys(jk, 8)))
        got = P.gumbel(P.fold_in(tk, torch.arange(8)), (8, vocab)).numpy()
        assert np.isfinite(got).all()
        assert _gumbel_ulps(want, got) <= GUMBEL_ULPS


def _near_tie_only(want_tok, got_tok, scores, tol):
    """Every index where the tokens differ has a top-2 gap of the
    reference's perturbed scores within ``tol``."""
    top2 = np.sort(scores, axis=-1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    bad = (want_tok != got_tok) & (gap > tol)
    assert not bad.any(), (np.nonzero(want_tok != got_tok), gap[bad])


@pytest.mark.parametrize("vocab", [4096, 49152])
def test_categorical_and_sample_rows_match_jax(vocab):
    """``categorical`` (one key over (B, V)) and ``temperature_sample_rows``
    (a key per row) on the same f32 logits: JAX's tokens, except where the
    perturbed scores' top-2 gap is within SCORE_TOL."""
    rng = np.random.default_rng(vocab)
    logits = (rng.standard_normal((16, 1, vocab)) * 3).astype(np.float32)
    jk, tk = _key(5)
    want = np.asarray(jax.random.categorical(jk, logits[:, -1]))
    scores = np.asarray(jax.random.gumbel(jk, (16, vocab))) + logits[:, -1]
    got = P.categorical(tk, torch.from_numpy(logits[:, -1])).numpy()
    _near_tie_only(want, got, scores, SCORE_TOL)
    jkeys = _row_keys(jk, 16)
    want = np.asarray(JST.temperature_sample_rows(logits, jkeys, TEMP))
    got = ST.temperature_sample_rows(torch.from_numpy(logits),
                                     P.fold_in(tk, torch.arange(16)),
                                     TEMP).numpy()
    assert got.dtype == np.int32
    scaled = np.asarray(jax.jit(lambda x: x / TEMP)(logits[:, -1]))
    scores = np.asarray(jax.vmap(lambda k: jax.random.gumbel(
        k, (vocab,)))(jkeys)) + scaled
    _near_tie_only(want, got, scores, SCORE_TOL)
    # and at batch 1, with one key, each row draws what it draws in the
    # batch: temperature_sample at B = 1 is the row alone
    one = [int(ST.temperature_sample(torch.from_numpy(logits[r:r + 1]),
                                     P.fold_in(tk, r), TEMP)[0])
           for r in range(16)]
    assert one == got.tolist()


def test_temperature_scaling_is_the_jitted_references():
    """``logits / t`` as the reference's jitted steps compute it: XLA
    multiplies by the f32 reciprocal (an eager JAX division rounds
    differently in some elements); the port multiplies so everywhere."""
    x = (np.random.default_rng(0).standard_normal((8, 1, 4096))
         * 10).astype(np.float32)
    for t in (0.8, 0.9, 1.3):
        jitted = np.asarray(jax.jit(lambda a: a[:, -1] / t)(x))
        mine = ST._scaled(torch.from_numpy(x), t).numpy()
        assert np.array_equal(jitted.view(np.int32), mine.view(np.int32))
    eager = np.asarray(jnp.asarray(x[:, -1]) / 0.8)
    assert not np.array_equal(eager, ST._scaled(torch.from_numpy(x),
                                                0.8).numpy())


def test_prng_runs_on_the_keys_device_without_a_host_value():
    """Every draw is a tensor op on the key's device: fold_in over a
    tensor of positions takes no Python int from it, and the draws are
    the same whichever form the positions come in."""
    _, tk = _key(3)
    pos = torch.tensor([5, 9, 0], dtype=torch.int32)
    keys = P.fold_in(tk, pos)
    assert keys.dtype == torch.int64 and keys.shape == (3, 2)
    for r, p in enumerate(pos.tolist()):
        assert torch.equal(keys[r], P.fold_in(tk, p))
    with pytest.raises(ValueError, match="one per row"):
        P.random_bits(keys, (2, 7))
    with pytest.raises(ValueError, match="uint32 words"):
        P.as_key([1, 2, 3])


# ---------------------------------------------------------------------------
# the sampled decode loop and slot tick (reduced starcoder2-3b)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jget_config("starcoder2-3b").reduced(),
                               kv_quant=True)
    cfg = dataclasses.replace(get_config("starcoder2-3b").reduced(),
                              kv_quant=True)
    jq = jquantize_tree(JR.init(jax.random.PRNGKey(0), jcfg), min_size=2048)
    params = bridge.params_from_numpy(to_numpy(jq), device="cpu")
    return jcfg, cfg, jq, params


def _python_loop(cfg, params, tok0, n_tok, key, start=0):
    """The per-token loop with the reference's key schedule."""
    decode = ST.make_decode_step(cfg, mode=W8A16)
    cache = R.init_cache(cfg, tok0.shape[0], 32, device="cpu")
    tok, toks = tok0, []
    for i in range(start, start + n_tok):
        logits, cache = decode(params, {"tokens": tok, "cache_index": i},
                               cache)
        nxt = ST.temperature_sample(logits, P.fold_in(key, i), TEMP)
        tok = nxt[:, None]
        toks.append(nxt)
    return torch.stack(toks, dim=1), cache


def test_decode_loop_temperature_matches_python_loop(setup):
    """The sampled loop (eager, and through ``jit_decode_loop``) is bitwise
    the per-token loop with ``fold_in(rng, position)`` keys; the same key
    draws the same tokens, another key others; and the tokens are the
    JAX jitted loop's but at near-ties of its perturbed scores."""
    jcfg, cfg, jq, params = setup
    n_tok = 5
    jk, tk = _key(123)
    tok0 = torch.tensor([[1], [2]], dtype=torch.int32)
    want, want_cache = _python_loop(cfg, params, tok0, n_tok, tk)
    loop = ST.make_decode_loop(cfg, mode=W8A16, num_tokens=n_tok,
                               temperature=TEMP)
    cache = R.init_cache(cfg, 2, 32, device="cpu")
    got, cache = loop(params, tok0, cache, 0, tk)
    assert torch.equal(got, want)
    for name in cache:
        assert torch.equal(cache[name], want_cache[name])
    graphed = ST.jit_decode_loop(loop)
    cache = R.init_cache(cfg, 2, 32, device="cpu")
    got_g, _ = graphed(params, tok0, cache, 0, tk)
    assert torch.equal(got_g, want)
    # the loop rewrites its cache from step 0: one binding, any key
    other = graphed(params, tok0, cache, 0, P.PRNGKey(7))[0].clone()
    assert graphed.captured.captures == 1
    assert torch.equal(graphed(params, tok0, cache, 0, tk)[0], want)
    assert not torch.equal(other, want)
    # the JAX package's jitted loop on the same weights
    jloop = JST.jit_decode_loop(JST.make_decode_loop(
        jcfg, mode=JW8A16, num_tokens=n_tok, temperature=TEMP))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")     # CPU: donation not usable
        jgot, _ = jloop(jq, jnp.asarray(tok0.numpy()),
                        JR.init_cache(jcfg, 2, 32), jnp.zeros((), jnp.int32),
                        jk)
    jgot = np.asarray(jgot)
    if not np.array_equal(jgot, want.numpy()):
        # part only at a near-tie of JAX's perturbed scores, at the first
        # step where a row parts (the rows decode different inputs after)
        jdecode = jax.jit(JST.make_decode_step(jcfg, mode=JW8A16))
        jcache, tok = JR.init_cache(jcfg, 2, 32), jnp.asarray(tok0.numpy())
        for i in range(n_tok):
            logits, jcache = jdecode(jq, {"tokens": tok, "cache_index":
                                          jnp.asarray(i, jnp.int32)}, jcache)
            scores = (np.asarray(jax.jit(lambda x: x[:, -1] / TEMP)(logits))
                      + np.asarray(jax.random.gumbel(
                          jax.random.fold_in(jk, i),
                          (2, jcfg.vocab))))
            if not np.array_equal(jgot[:, i], want.numpy()[:, i]):
                _near_tie_only(jgot[:, i], want.numpy()[:, i], scores,
                               LOGIT_ATOL / TEMP + SCORE_TOL)
                break
            tok = jnp.asarray(jgot[:, i:i + 1])


def test_decode_loop_temperature_requires_rng(setup):
    _, cfg, _, params = setup
    loop = ST.make_decode_loop(cfg, mode=W8A16, num_tokens=2,
                               temperature=1.0)
    for fn in (loop, ST.jit_decode_loop(loop)):
        with pytest.raises(ValueError, match="rng"):
            fn(params, torch.ones((1, 1), dtype=torch.int32),
               R.init_cache(cfg, 1, 16, device="cpu"), 0)


def test_sampled_slot_step_rows_and_capture(setup):
    """The sampled tick: row r draws with fold_in(rng, slot_index[r])
    (each row equal to that row's tick alone, at batch 1), inactive rows
    emit 0 and a non-finite row -1, and the tick through
    ``jit_slot_decode_step`` is bitwise the eager one on two copies of a
    cache, any key through one binding; a missing key raises."""
    _, cfg, _, params = setup
    key = P.PRNGKey(11)
    step = ST.make_slot_decode_step(cfg, mode=W8A16, temperature=TEMP)
    toks = torch.tensor([[5], [1], [9], [2]], dtype=torch.int32)
    idx = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    active = torch.tensor([True, False, True, True])

    def cache():
        c = R.init_cache(cfg, 4, 16, device="cpu")
        g = torch.Generator().manual_seed(2)
        for t in c.values():
            t.copy_(torch.randint(-127, 128, t.shape, generator=g).to(t.dtype)
                    if t.dtype == torch.int8
                    else torch.rand(t.shape, generator=g) * 0.04)
        return c

    ca, cb = cache(), cache()
    nxt, _, new_idx = step(params, toks, ca, idx.clone(), active, key)
    assert nxt[1] == 0 and torch.equal(new_idx, idx + active.int())
    for r in (0, 2, 3):
        one = ST.make_slot_decode_step(cfg, mode=W8A16, temperature=TEMP)
        row = {k: v[:, r:r + 1].clone() for k, v in cache().items()}
        alone, _, _ = one(params, toks[r:r + 1], row, idx[r:r + 1].clone(),
                          active[r:r + 1], key)
        assert alone[0] == nxt[r]
    graphed = ST.jit_slot_decode_step(step)
    got, _, got_idx = graphed(params, toks, cb, idx.clone(), active, key)
    assert torch.equal(got, nxt) and torch.equal(got_idx, new_idx)
    for name in ca:
        assert torch.equal(ca[name], cb[name])
    graphed(params, toks, cb, idx.clone(), active, P.PRNGKey(12))
    assert graphed.captured.captures == 1
    with pytest.raises(TypeError, match="rng"):
        step(params, toks, cache(), idx.clone(), active)
    bad = dict(params, ln_f={k: v * float("nan")
                             for k, v in params["ln_f"].items()})
    poisoned, _, _ = step(bad, toks, cache(), idx.clone(), active, key)
    assert poisoned.tolist() == [-1, 0, -1, -1]


# ---------------------------------------------------------------------------
# the sampled engine
# ---------------------------------------------------------------------------

def _engine(cfg, params, **kw):
    kw.setdefault("num_slots", 4)
    return E.Engine(cfg, params, mode=W8A16, max_seq=16, device="cpu", **kw)


def test_engine_temperature_requires_rng(setup):
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match="rng"):
        _engine(cfg, params, temperature=0.5)
    with pytest.raises(ValueError, match="rng"):
        E.reference_outputs(cfg, params, [], mode=W8A16, device="cpu",
                            temperature=0.5)


def test_engine_temperature_matches_decode_loop(setup):
    """A single request through the engine at temperature t reproduces
    the sampled decode loop's draws bit for bit — the ported key
    schedule, not a lookalike."""
    _, cfg, _, params = setup
    n_tok = 6
    _, tk = _key(123)
    loop = ST.make_decode_loop(cfg, mode=W8A16, num_tokens=n_tok,
                               temperature=TEMP)
    want, _ = loop(params, torch.tensor([[7]], dtype=torch.int32),
                   R.init_cache(cfg, 1, 16, device="cpu"), 0, tk)
    reqs = [E.EngineRequest(rid=0, prompt=(7,), max_new_tokens=n_tok)]
    rep = _engine(cfg, params, temperature=TEMP, rng=tk).serve(reqs)
    assert rep.outputs()[0] == want[0].tolist()


@pytest.mark.parametrize("kind", ["contiguous", "paged", "chunked",
                                  "paged_chunked"])
def test_engine_temperature_multi_request_reference_parity(setup, kind):
    """Interleaved sampled requests, contiguous or paged, per-token or
    chunked prefill: the engine equals its sequential reference bit for
    bit; the same key gives the same stream, another key another."""
    _, cfg, _, params = setup
    jk, tk = _key(5)
    reqs = E.synthetic_requests(12, rate_per_s=3000.0, vocab=cfg.vocab,
                                prompt_len=4, max_new_tokens=4)
    kw = {"contiguous": {}, "paged": {"block_size": 4},
          "chunked": {"prefill_chunk": 2},
          "paged_chunked": {"block_size": 4, "prefill_chunk": 4}}[kind]
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16, max_seq=16,
                               device="cpu", temperature=0.9, rng=jk)
    eng = _engine(cfg, params, temperature=0.9, rng=np.asarray(jk), **kw)
    assert eng.serve(reqs).outputs() == want
    assert eng.serve(reqs).outputs() == want
    other = _engine(cfg, params, temperature=0.9, rng=P.PRNGKey(99), **kw)
    assert other.serve(reqs).outputs() != want
    greedy = E.reference_outputs(cfg, params, reqs, mode=W8A16, max_seq=16,
                                 device="cpu")
    assert greedy != want


def _jax_sampled_reference_scores(jcfg, jq, reqs, rng, max_seq):
    """The JAX package's per-token loop, sampling as its jitted slot tick
    does, recording the perturbed scores' top-2 gap at every generated
    token: (tokens, gaps) per rid."""
    decode = jax.jit(JST.make_decode_step(jcfg, mode=JW8A16))
    scale = jax.jit(lambda x: x[:, -1].astype(jnp.float32) / TEMP)
    toks, gaps = {}, {}
    for r in reqs:
        cache = JR.init_cache(jcfg, 1, max_seq)
        gen, gap, tok, pos = [], [], None, 0
        while len(gen) < r.max_new_tokens:
            cur = r.prompt[pos] if pos < len(r.prompt) else tok
            logits, cache = decode(
                jq, {"tokens": jnp.asarray([[cur]], jnp.int32),
                     "cache_index": jnp.asarray(pos, jnp.int32)}, cache)
            key = jax.random.fold_in(rng, jnp.asarray(pos, jnp.int32))
            pos += 1
            if pos >= len(r.prompt):
                scores = np.asarray(
                    jax.random.gumbel(key, (jcfg.vocab,)) + scale(logits)[0])
                tok = int(scores.argmax())
                top2 = np.sort(scores)[-2:]
                gen.append(tok)
                gap.append(float(top2[1] - top2[0]))
        toks[r.rid], gaps[r.rid] = gen, gap
    return toks, gaps


def test_engine_temperature_matches_jax_engine(setup):
    """The port's sampled engine and the JAX package's, same weights, same
    key, same trace (chunked prefill of 4, 4 slots): tokens equal, except
    that a request may part at a step where JAX's perturbed scores have a
    top-2 gap within LOGIT_ATOL / t + SCORE_TOL; after it the two decode
    different inputs and are not compared further."""
    jcfg, cfg, jq, params = setup
    jk, tk = _key(5)
    reqs = E.synthetic_requests(12, rate_per_s=3000.0, vocab=cfg.vocab,
                                prompt_len=5, max_new_tokens=6)
    jreqs = JE.synthetic_requests(12, rate_per_s=3000.0, vocab=cfg.vocab,
                                  prompt_len=5, max_new_tokens=6)
    got = _engine(cfg, params, prefill_chunk=4, temperature=TEMP,
                  rng=tk).serve(reqs).outputs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = JE.Engine(jcfg, jq, mode=JW8A16, num_slots=4, max_seq=16,
                         prefill_chunk=4, temperature=TEMP, rng=jk)
        want = jeng.serve(jreqs, clock="virtual", tick_s=1e-3).outputs()
    ref, gaps = _jax_sampled_reference_scores(jcfg, jq, jreqs, jk, 16)
    parted = 0
    for rid, toks in want.items():
        first = next((i for i, (a, b) in enumerate(zip(got[rid], toks))
                      if a != b), None)
        if first is None:
            continue
        # the JAX engine follows the reference loop up to that step
        assert ref[rid][:first + 1] == toks[:first + 1], rid
        assert gaps[rid][first] <= LOGIT_ATOL / TEMP + SCORE_TOL, \
            (rid, first, gaps[rid])
        parted += 1
    assert parted <= len(want) // 4, parted
