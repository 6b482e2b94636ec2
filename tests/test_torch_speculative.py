"""Speculative decoding in the port, on the CPU at reduced width, held to
the JAX package's contract (``tests/test_speculative.py``): with
``spec_k > 0`` the engine's committed tokens are byte-identical to the
non-speculative engine's, greedy or sampled, whatever the draft proposes.

- the registry's hooks: which families speculate, the self-draft's
  config and its shared-view params, and the engine's refusals;
- the steps: the verify step bit for bit ``k + 1`` one-token slot steps
  and the propose step ``k`` greedy ones (samples, returned index, every
  cache byte; eager and through the captured form's static buffers), and
  both against the JAX package's ``make_verify_step`` /
  ``make_draft_propose_step`` on the same bridged weights and numpy
  inputs: tokens equal, except where the reference's top-2 gap lies
  within the logit tolerance (tests/test_torch_model.py; sampled: of its
  perturbed scores, tests/test_torch_sampling.py);
- the engine: starcoder2-3b (int8 cache, the main path) and
  qwen2-moe-a2.7b (bf16 cache, an int8 router as at full width: the
  fields of tests/test_torch_moe.py) under W8A16 and FP, contiguous and
  paged, greedy and sampled, equal to the non-speculative engine and
  (W8A16) to ``reference_outputs``; a full-depth self-draft accepting
  every proposal; a cross-model draft; a garbage draft; preemption
  mid-speculation and seeded fault plans; the JAX speculative engine on
  the same trace; the accounting.

The traces are 40 requests where the reference's are 200: the same
mixes of arrivals, prompts and budgets, cut to keep the file within
about two minutes on one CPU worker.
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
from repro.core.qlinear import FP as JFP, W8A16 as JW8A16
from repro.core.quant import quantize_tree as jquantize_tree
from repro.models import registry as JR
from repro.runtime import steps as JST
from repro_torch import engine as E
from repro_torch.configs import get_config
from repro_torch.core import batching as bt
from repro_torch.core.qlinear import FP, W8A16
from repro_torch.models import bridge
from repro_torch.models import registry as R
from repro_torch.runtime import prng as P
from repro_torch.runtime import steps as ST

from test_torch_cuda import fill_history
from test_torch_graph import _jax_cache
from test_torch_model import LOGIT_ATOL, to_numpy
from test_torch_moe import QUIRKS
from test_torch_sampling import SCORE_TOL

ARCHES = ("starcoder2-3b", "qwen2-moe-a2.7b")
MODES = {"w8a16": (W8A16, JW8A16), "fp": (FP, JFP)}
SLOTS, MAX_SEQ, K = 4, 16, 3
TEMP = 0.7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch):
    """(the JAX config, the port's): starcoder2-3b on the int8 cache;
    qwen2-moe-a2.7b on the bf16 cache with an int8 router; mamba2-1.3b
    (the refusals' recurrent family) as ``reduced()`` makes it."""
    fields = {"starcoder2-3b": dict(kv_quant=True),
              "mamba2-1.3b": {}}.get(arch, dict(QUIRKS, kv_quant=False))
    return tuple(dataclasses.replace(get(arch).reduced(), **fields)
                 for get in (jget_config, get_config))


_SETUPS = {}


def _setup(arch="starcoder2-3b", mode="w8a16", seed=0):
    """(jcfg, cfg, JAX params, the port's bridged copy), made once."""
    key = (arch, mode, seed)
    if key not in _SETUPS:
        jcfg, cfg = _cfgs(arch)
        jp = JR.init(jax.random.PRNGKey(seed), jcfg)
        if mode == "w8a16":
            jp = jquantize_tree(jp, min_size=2048)
        _SETUPS[key] = (jcfg, cfg, jp,
                        bridge.params_from_numpy(to_numpy(jp), device="cpu"))
    return _SETUPS[key]


def _trace(cfg, n=40, rate=3000.0, prompt_len=4, max_new=6, seed=0, **kw):
    return E.synthetic_requests(n, rate_per_s=rate, vocab=cfg.vocab,
                                prompt_len=prompt_len,
                                max_new_tokens=max_new, seed=seed, **kw)


def _engine(cfg, params, mode=W8A16, **kw):
    kw.setdefault("num_slots", SLOTS)
    return E.Engine(cfg, params, mode=mode, max_seq=MAX_SEQ, device="cpu",
                    **kw)


class _Spy(E.SingleDeviceExecutor):
    """The one-card step set, recording every verify call's fed tokens,
    their counts and the samples (host copies)."""

    def __init__(self):
        self.rounds = []

    def verify_step(self, cfg, *, mode, k, temperature):
        step = super().verify_step(cfg, mode=mode, k=k,
                                   temperature=temperature)

        def spied(params, tokens, cache, index, n_tokens, active, *rng):
            out = step(params, tokens, cache, index, n_tokens, active, *rng)
            self.rounds.append((tokens.numpy().copy(),
                                n_tokens.numpy().copy(),
                                out[0].numpy().copy()))
            return out

        return spied

    def rejections(self) -> int:
        """Proposals the verify step rejected: a fed proposal after
        which the sample differs from the next fed token."""
        bad = 0
        for toks, n_tok, samples in self.rounds:
            for r in np.nonzero(n_tok > 1)[0]:
                n = n_tok[r]
                bad += int((samples[r, :n - 1] != toks[r, 1:n]).any())
        return bad


# ---------------------------------------------------------------------------
# the registry's hooks and the engine's refusals
# ---------------------------------------------------------------------------

SUPPORT = {"starcoder2-3b": ("starcoder2-3b", {}, True),
           "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}, True),
           "windowed-dense": ("starcoder2-3b", dict(window=8), False),
           "windowed-moe": ("qwen2-moe-a2.7b", dict(window=8), False),
           "ssm": ("mamba2-1.3b", {}, False),
           "hybrid": ("recurrentgemma-9b", {}, False),
           "encdec": ("whisper-medium", {}, False),
           "vlm": ("starcoder2-3b", dict(family="vlm"), False)}


@pytest.mark.parametrize("case", list(SUPPORT))
def test_speculation_support_is_positional_kv_only(case):
    """Exactly the families whose decode state is rewindable positional
    KV speculate, as the JAX registry answers for the same config: the
    recurrent, primed and windowed ones do not (answered without the
    refusal of an unported family)."""
    arch, fields, ok = SUPPORT[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **fields)
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **fields)
    assert R.supports_speculation(cfg) == ok
    assert R.supports_self_draft(cfg) == ok
    if "family" not in fields:
        assert JR.supports_speculation(jcfg) == ok


def test_draft_config_truncates_and_renames():
    cfg = get_config("starcoder2-3b").reduced()
    d = R.draft_config(cfg, 1)
    assert d.n_layers == 1 and d.vocab == cfg.vocab
    assert d.name == cfg.name + "-draft1"
    assert d == dataclasses.replace(cfg, name=d.name, n_layers=1)
    assert d.name == JR.draft_config(jget_config("starcoder2-3b").reduced(),
                                     1).name
    for bad in (0, cfg.n_layers + 1):
        with pytest.raises(ValueError, match="draft_layers"):
            R.draft_config(cfg, bad)


@pytest.mark.parametrize("arch", ARCHES)
def test_draft_params_is_a_shared_view(arch):
    """The self-draft's tree is the target's first layers and its embed,
    final norm and head by reference: every tensor is the target's
    object, none is copied."""
    _, cfg, _, params = _setup(arch)
    dp = R.draft_params(cfg, params, 1)
    assert dp["embed"] is params["embed"] and dp["ln_f"] is params["ln_f"]
    assert len(dp["layers"]) == 1 and dp["layers"][0] is params["layers"][0]
    assert len(params["layers"]) == cfg.n_layers
    full = R.draft_params(cfg, params, cfg.n_layers)
    assert all(a is b for a, b in zip(full["layers"], params["layers"]))


def test_draft_params_refuses_non_speculative_families():
    _, cfg, _, params = _setup("mamba2-1.3b")
    with pytest.raises(ValueError, match="self-draft"):
        R.draft_params(cfg, params, 1)


def test_spec_needs_exactly_one_draft_source():
    _, cfg, _, params = _setup()
    with pytest.raises(ValueError, match="exactly one"):
        _engine(cfg, params, spec_k=2)
    with pytest.raises(ValueError, match="exactly one"):
        _engine(cfg, params, spec_k=2, draft_layers=1, draft=(cfg, params))
    with pytest.raises(ValueError, match="spec_k"):
        _engine(cfg, params, spec_k=-1)
    with pytest.raises(ValueError, match="spec_k >= 1"):
        _engine(cfg, params, draft_layers=1)
    with pytest.raises(ValueError, match="spec_k >= 1"):
        _engine(cfg, params, draft=(cfg, params))
    with pytest.raises(ValueError, match="draft_layers"):
        _engine(cfg, params, spec_k=2, draft_layers=cfg.n_layers + 1)


def test_rejects_unrewindable_targets_and_drafts():
    """A windowed target or draft is refused as not rewindable; so are a
    recurrent draft and a recurrent target (mamba2-1.3b with its own
    params)."""
    _, cfg, _, params = _setup()
    _, scfg, _, sparams = _setup("mamba2-1.3b")
    windowed = dataclasses.replace(cfg, window=8)
    with pytest.raises(ValueError, match="rewindable"):
        _engine(windowed, params, spec_k=2, draft_layers=1)
    for bad, bad_params in ((windowed, params), (scfg, sparams)):
        with pytest.raises(ValueError, match="rewindable"):
            _engine(cfg, params, spec_k=2, draft=(bad, bad_params))
    with pytest.raises(ValueError, match="rewindable"):
        _engine(scfg, sparams, spec_k=2, draft_layers=1)


def test_rejects_vocab_mismatch_and_a_draft_elsewhere():
    _, cfg, _, params = _setup()
    dcfg = dataclasses.replace(cfg, name="wrong-vocab", vocab=cfg.vocab * 2)
    with pytest.raises(ValueError, match="vocab"):
        _engine(cfg, params, spec_k=2, draft=(dcfg, params))
    meta = {"embed": {"table": torch.empty((cfg.vocab, cfg.d_model),
                                           device="meta")}}
    with pytest.raises(ValueError, match="draft params lie on meta"):
        _engine(cfg, params, spec_k=2, draft=(cfg, meta))


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _step_case(paged, seed=0):
    """Reduced starcoder2-3b (W8A16, int8 cache) and a cache of 4 rows
    with a history of real k/v; a verify round: the rows at spread
    positions, each feeding its own count of tokens (row 2 one, its
    next input alone), row 3 inactive."""
    jcfg, cfg, jq, params = _setup()
    if paged:
        mb = MAX_SEQ // 4
        cache = R.init_paged_cache(cfg, SLOTS, MAX_SEQ, 4, SLOTS * mb + 1,
                                   device="cpu")
        perm = np.random.default_rng(seed).permutation(
            np.arange(1, SLOTS * mb + 1)).astype(np.int32)
        cache["block_tables"].copy_(torch.from_numpy(
            perm.reshape(SLOTS, mb)))
    else:
        cache = R.init_cache(cfg, SLOTS, MAX_SEQ, device="cpu")
    fill_history(cfg, params, W8A16, cache, 8, seed)
    rng = np.random.default_rng(seed + 1)
    rnd = {"tokens": rng.integers(1, cfg.vocab, (SLOTS, K + 1)).astype(
               np.int32),
           "index": np.array([8, 5, 11, 3], np.int32),
           "n_tok": np.array([K + 1, 2, 1, 3], np.int32),
           "active": np.array([True, True, True, False])}
    return jcfg, cfg, jq, params, cache, rnd


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _args(rnd, *names):
    return tuple(torch.from_numpy(rnd[k]) for k in names)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_verify_step_is_k_plus_1_slot_steps(paged, sampled):
    """The verify step, eager and captured (the static buffers the CPU
    runs eagerly), is bit for bit k + 1 one-token slot steps, position j
    active where j < n_tokens: samples, the returned index and every
    cache byte, the writes past each row's count (at its frozen
    frontier) included; positions past a row's count sample 0, and the
    index advances by the count."""
    _, cfg, _, params, cache, rnd = _step_case(paged)
    t = TEMP if sampled else 0.0
    keys = (P.PRNGKey(5),) if sampled else ()
    tokens, index, n_tok, active = _args(rnd, "tokens", "index", "n_tok",
                                         "active")
    slot = ST.make_slot_decode_step(cfg, mode=W8A16, temperature=t)
    want_cache, idx, want = _clone(cache), index, []
    for j in range(K + 1):
        nxt, _, idx = slot(params, tokens[:, j:j + 1].contiguous(),
                           want_cache, idx, active & (n_tok > j), *keys)
        want.append(nxt)
    want = torch.stack(want, dim=1)
    eager = ST.make_verify_step(cfg, mode=W8A16, k=K, temperature=t)
    graphed = ST.jit_verify_step(ST.make_verify_step(
        cfg, mode=W8A16, k=K, temperature=t))
    got_cache = _clone(cache)
    for fn in (eager, graphed, graphed):
        for name in cache:                 # in place: one binding
            got_cache[name].copy_(cache[name])
        samples, _, new_index = fn(params, tokens, got_cache, index, n_tok,
                                   active, *keys)
        assert torch.equal(samples, want) and torch.equal(new_index, idx)
        for name in cache:
            assert torch.equal(got_cache[name], want_cache[name]), name
    assert graphed.captured.captures == 1
    n = rnd["n_tok"] * rnd["active"]
    np.testing.assert_array_equal(idx.numpy(), rnd["index"] + n)
    past = np.arange(K + 1)[None, :] >= n[:, None]
    assert (want.numpy()[past] == 0).all() and (want.numpy()[~past] >= 0).all()
    with pytest.raises(TypeError, match="rng"):
        eager(params, tokens, _clone(cache), index, n_tok, active,
              *(() if sampled else (P.PRNGKey(5),)))


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_propose_step_is_k_greedy_slot_steps(paged):
    """The propose step, eager and captured, is bit for bit k greedy
    slot steps, each fed the sample before it: proposals, index and
    every cache byte; an inactive row proposes 0 and keeps its index."""
    _, cfg, _, params, cache, rnd = _step_case(paged)
    tokens, index, active = _args(rnd, "tokens", "index", "active")
    tok = tokens[:, :1].contiguous()
    slot = ST.make_slot_decode_step(cfg, mode=W8A16)
    want_cache, idx, cur, want = _clone(cache), index, tok, []
    for _ in range(K):
        nxt, _, idx = slot(params, cur, want_cache, idx, active)
        want.append(nxt)
        cur = nxt[:, None]
    want = torch.stack(want, dim=1)
    graphed = ST.jit_draft_propose_step(ST.make_draft_propose_step(
        cfg, mode=W8A16, k=K))
    got_cache = _clone(cache)
    for fn in (ST.make_draft_propose_step(cfg, mode=W8A16, k=K), graphed,
               graphed):
        for name in cache:
            got_cache[name].copy_(cache[name])
        props, _, new_index = fn(params, tok, got_cache, index, active)
        assert torch.equal(props, want) and torch.equal(new_index, idx)
        for name in cache:
            assert torch.equal(got_cache[name], want_cache[name]), name
    assert graphed.captured.captures == 1
    assert (want[~active] == 0).all() and (want[active] >= 0).all()
    np.testing.assert_array_equal(idx.numpy(),
                                  rnd["index"] + K * rnd["active"])


def test_propose_step_turns_a_nonfinite_row_into_0():
    """A draft row whose logits go NaN (here: a NaN key scale in its
    cache row) proposes 0 where the slot step emits the -1 sentinel: a
    wrong guess, never a fault; the row beside it proposes its sample."""
    _, cfg, _, params = _setup()
    cache = R.init_cache(cfg, 2, MAX_SEQ, device="cpu")
    cache["k_scale"][:, 0, 0] = float("nan")
    tok = torch.tensor([[7], [9]], dtype=torch.int32)
    index = torch.tensor([1, 1], dtype=torch.int32)
    active = torch.tensor([True, True])
    props, _, _ = ST.make_draft_propose_step(cfg, mode=W8A16, k=2)(
        params, tok, _clone(cache), index, active)
    nxt, _, _ = ST.make_slot_decode_step(cfg, mode=W8A16)(
        params, tok, _clone(cache), index, active)
    assert nxt[0] == -1 and (props[0] == 0).all()
    assert props[1, 0] == nxt[1] and nxt[1] >= 0


def _gap(scores):
    top2 = np.sort(np.asarray(scores, np.float32), axis=-1)[:, -2:]
    return top2[:, 1] - top2[:, 0]


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_verify_step_matches_jax(sampled):
    """The port's verify step and the JAX ``jit_verify_step``, same
    bridged weights, same cache bytes and numpy inputs: equal indices,
    and samples equal wherever the reference's top-2 gap at that
    position (its own slot steps' logits, or their perturbed scores)
    lies outside the tolerance."""
    jcfg, cfg, jq, params, cache, rnd = _step_case(False)
    t = TEMP if sampled else 0.0
    jk = jax.random.PRNGKey(5)
    keys = (P.as_key(np.asarray(jk)),) if sampled else ()
    samples, _, idx = ST.make_verify_step(cfg, mode=W8A16, k=K,
                                          temperature=t)(
        params, *_args(rnd, "tokens"), _clone(cache),
        *_args(rnd, "index", "n_tok", "active"), *keys)
    j_in = [jnp.asarray(rnd[k]) for k in ("tokens", "index", "n_tok",
                                          "active")]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # CPU: donation not usable
        jverify = JST.jit_verify_step(JST.make_verify_step(
            jcfg, mode=JW8A16, k=K, temperature=t))
        jsamples, _, jidx = jverify(jq, j_in[0], _jax_cache(cache),
                                    *j_in[1:], *((jk,) if sampled else ()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    # the reference's gaps, position by position along its own scan
    jlogits = jax.jit(lambda p, t_, c, i: JR.apply_decode(
        p, jcfg, {"tokens": t_, "cache_index": i}, c, mode=JW8A16)[0])
    jslot = jax.jit(JST.make_slot_decode_step(jcfg, mode=JW8A16))
    jc, ji = _jax_cache(cache), j_in[1]
    tol = LOGIT_ATOL / t + SCORE_TOL if sampled else LOGIT_ATOL
    compared = 0
    for j in range(K + 1):
        tok = j_in[0][:, j:j + 1]
        scores = np.asarray(jlogits(jq, tok, jc, ji))[:, -1]
        if sampled:
            scores = np.asarray(jax.vmap(lambda p: jax.random.gumbel(
                jax.random.fold_in(jk, p), (jcfg.vocab,)))(ji)) \
                + np.asarray(jax.jit(lambda x: x / t)(scores))
        act = rnd["active"] & (j < rnd["n_tok"])
        _, jc, ji = jslot(jq, tok, jc, ji, jnp.asarray(act))
        clear = act & (_gap(scores) > tol)
        np.testing.assert_array_equal(samples.numpy()[clear, j],
                                      np.asarray(jsamples)[clear, j])
        compared += int(clear.sum())
    assert compared >= 5, compared


def test_propose_step_matches_jax():
    """The port's propose step and the JAX ``jit_draft_propose_step`` on
    a 1-layer self-draft: equal indices; each row's proposals equal up
    to the first position where the reference's top-2 gap lies within
    the tolerance (after it the two feed different tokens)."""
    jcfg, cfg, jq, params, _, rnd = _step_case(False)
    dcfg, jdcfg = R.draft_config(cfg, 1), JR.draft_config(jcfg, 1)
    dparams = R.draft_params(cfg, params, 1)
    jdparams = JR.draft_params(jcfg, jq, 1)
    cache = R.init_cache(dcfg, SLOTS, MAX_SEQ, device="cpu")
    fill_history(dcfg, dparams, W8A16, cache, 8, 3)
    tok, index, active = _args(rnd, "tokens", "index", "active")
    tok = tok[:, :1].contiguous()
    props, _, idx = ST.make_draft_propose_step(dcfg, mode=W8A16, k=K)(
        dparams, tok, _clone(cache), index, active)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jpropose = JST.jit_draft_propose_step(JST.make_draft_propose_step(
            jdcfg, mode=JW8A16, k=K))
        jprops, _, jidx = jpropose(jdparams, jnp.asarray(tok.numpy()),
                                   _jax_cache(cache),
                                   jnp.asarray(rnd["index"]),
                                   jnp.asarray(rnd["active"]))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    jprops = np.asarray(jprops)
    jlogits = jax.jit(lambda p, t_, c, i: JR.apply_decode(
        p, jdcfg, {"tokens": t_, "cache_index": i}, c, mode=JW8A16)[0])
    jslot = jax.jit(JST.make_slot_decode_step(jdcfg, mode=JW8A16))
    jc, ji, cur = _jax_cache(cache), jnp.asarray(rnd["index"]), \
        jnp.asarray(tok.numpy())
    live = rnd["active"].copy()
    for j in range(K):
        gap = _gap(np.asarray(jlogits(jdparams, cur, jc, ji))[:, -1])
        live &= gap > LOGIT_ATOL
        np.testing.assert_array_equal(props.numpy()[live, j],
                                      jprops[live, j])
        _, jc, ji = jslot(jdparams, cur, jc, ji, jnp.asarray(rnd["active"]))
        cur = jnp.asarray(jprops[:, j:j + 1])
    assert live.sum() >= 2


# ---------------------------------------------------------------------------
# the engine: bit for bit the non-speculative stream
# ---------------------------------------------------------------------------

SERVES = {"contiguous": {}, "paged": dict(block_size=4, prefill_chunk=4),
          "sampled": dict(temperature=TEMP),
          "sampled-paged": dict(block_size=4, prefill_chunk=4,
                                temperature=TEMP)}


# requests a serve of each family takes (the MoE layer's 16 experts make a
# CPU tick several times the dense one's)
N_REQUESTS = {"starcoder2-3b": 40, "qwen2-moe-a2.7b": 16}


def _serve_pair(arch, mode, kind, seed=0, **spec):
    _, cfg, _, params = _setup(arch, mode)
    kw = dict(SERVES[kind])
    rng = P.PRNGKey(11) if "temperature" in kw else None
    reqs = _trace(cfg, n=N_REQUESTS[arch], seed=seed,
                  prompt_len=6 if "block_size" in kw else 4,
                  shared_prefix_len=4 if "block_size" in kw else 0)
    m = MODES[mode][0]
    plain = _engine(cfg, params, m, rng=rng, **kw).serve(reqs)
    eng = _engine(cfg, params, m, rng=rng, spec_k=spec.pop("k", K), **spec,
                  **kw)
    return cfg, params, reqs, plain, eng.serve(reqs), eng, rng


@pytest.mark.parametrize("kind", list(SERVES))
@pytest.mark.parametrize("arch", ARCHES)
def test_w8a16_serve_equals_plain_and_reference(arch, kind):
    """A 1-layer self-draft, k = 3, under W8A16 (greedy and sampled,
    contiguous and paged): every committed token equals the
    non-speculative engine's and the sequential batch-1 reference's, and
    speculation pays (fewer ticks; greedy: more than one token per
    emitting dispatch)."""
    cfg, params, reqs, plain, spec, eng, rng = _serve_pair(
        arch, "w8a16", kind, draft_layers=1)
    assert spec.outputs() == plain.outputs()
    assert spec.outputs() == E.reference_outputs(
        cfg, params, reqs, mode=W8A16, max_seq=eng.max_seq, device="cpu",
        temperature=eng.temperature, rng=rng)
    assert len(spec.results) == len(reqs)
    assert all(r.status == "ok" for r in spec.results)
    assert spec.generated_tokens == plain.generated_tokens
    assert spec.spec_k == K
    if not eng.temperature:
        assert spec.accepted_per_dispatch > 1.0 and spec.ticks < plain.ticks
    if eng.block_size:
        assert spec.leaked_blocks == 0 and spec.shared_block_hits > 0


@pytest.mark.parametrize("kind", ["contiguous", "sampled"])
@pytest.mark.parametrize("arch", ARCHES)
def test_fp_serve_equals_plain(arch, kind):
    """The same under FP (``torch.matmul``): equal to the
    non-speculative engine, whose ticks have the verify positions'
    shapes."""
    _, _, reqs, plain, spec, _, _ = _serve_pair(arch, "fp", kind,
                                                draft_layers=1)
    assert spec.outputs() == plain.outputs()
    assert all(r.status == "ok" for r in spec.results)


@pytest.mark.parametrize("kind", ["contiguous", "paged"])
@pytest.mark.parametrize("arch", ARCHES)
def test_full_depth_self_draft_accepts_everything(arch, kind):
    """``draft_layers = n_layers`` makes the draft the target, its cache
    contiguous whatever the target's and caught up by the one-pass chunk
    step: no proposal is ever rejected, and with max_new divisible by
    k + 1 every emitting dispatch commits exactly k + 1 tokens."""
    _, cfg, _, params = _setup(arch)
    spy = _Spy()
    *_, plain, spec, _, _ = _serve_pair(
        arch, "w8a16", kind, seed=2, draft_layers=cfg.n_layers,
        backend=spy)
    assert spec.outputs() == plain.outputs()
    assert spy.rounds and spy.rejections() == 0
    reqs = _trace(cfg, n=N_REQUESTS[arch] // 2, max_new=8, seed=2)
    rep = _engine(cfg, params, spec_k=K, draft_layers=cfg.n_layers,
                  **SERVES[kind]).serve(reqs)
    assert rep.accepted_per_dispatch == pytest.approx(K + 1)
    assert rep.outputs() == _engine(cfg, params,
                                    **SERVES[kind]).serve(reqs).outputs()


def test_cross_model_draft():
    """A draft of another architecture with the same vocabulary:
    starcoder2-3b drafting for qwen2-moe-a2.7b."""
    _, cfg, _, params = _setup("qwen2-moe-a2.7b")
    dcfg, dparams = _setup("starcoder2-3b")[1::2]
    assert dcfg.vocab == cfg.vocab
    reqs = _trace(cfg, n=N_REQUESTS["qwen2-moe-a2.7b"], seed=3)
    plain = _engine(cfg, params).serve(reqs)
    spec = _engine(cfg, params, spec_k=2, draft=(dcfg, dparams)).serve(reqs)
    assert spec.outputs() == plain.outputs()
    assert spec.accepted_per_dispatch >= 1.0


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
def test_garbage_draft_cannot_corrupt_the_target(paged):
    """A draft of the same arch from another seed proposes tokens the
    target mostly rejects, each one written into the target's cache past
    the committed frontier before the rewind: the committed stream is
    still the non-speculative one (the rejected writes are overwritten
    before any read, in private blocks only), and every dispatch still
    commits its bonus token."""
    _, cfg, _, params = _setup()
    garbage = _setup(seed=666)[3]
    spy = _Spy()
    _, _, _, plain, spec, _, _ = _serve_pair(
        "starcoder2-3b", "w8a16", "paged" if paged else "contiguous",
        seed=4, draft=(cfg, garbage), backend=spy)
    assert spec.outputs() == plain.outputs()
    assert spy.rejections() > 0
    assert spec.accepted_per_dispatch >= 1.0
    if paged:
        assert spec.leaked_blocks == 0 and spec.shared_block_hits > 0


# ---------------------------------------------------------------------------
# composition: preemption mid-speculation, faults, exact resume
# ---------------------------------------------------------------------------

def _two_class(rid):
    return "batch" if rid % 3 == 0 else "interactive"


@pytest.mark.parametrize("draft_layers", [1, 2], ids=["draft1", "full"])
def test_preemption_mid_speculation_resumes_exactly(draft_layers):
    """Preemption lands between speculative rounds with the draft cache
    mid-stream; on resume the draft is rebuilt from the committed
    history (the prompt, then what the request generated, the stashed
    tokens included), so the output is the never-preempted one and a
    full-depth self-draft still has no proposal rejected."""
    _, cfg, _, params = _setup()
    reqs = _trace(cfg, n=12, rate=2000.0, prompt_len=3, max_new=9,
                  priority=_two_class)
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                               max_seq=MAX_SEQ, device="cpu")
    spy = _Spy()
    rep = _engine(cfg, params, block_size=4, num_blocks=9, prefill_chunk=2,
                  spec_k=K, draft_layers=draft_layers, backend=spy).serve(
        reqs, preemption=True)
    assert rep.preempted > 0 and any(r.preemptions for r in rep.results)
    assert rep.outputs() == want
    assert all(r.status == "ok" for r in rep.results)
    assert rep.leaked_blocks == 0
    if draft_layers == cfg.n_layers:
        assert spy.rejections() == 0


def test_resume_rebuilds_the_draft_from_the_committed_history():
    """A request preempted with 4 tokens generated (a non-finite sample
    poisons its second round) resumes with them in its prompt; two rounds
    later the draft's catch-up reads a token generated after the resume.
    A full-depth self-draft then proposes only what the target commits:
    the catch-up fed the committed history, not the stashed tokens (the
    JAX engine reads ``generated[p - len(prompt)]`` there, which after a
    resume is a stashed token: its acceptance drops, its output
    cannot)."""
    _, cfg, _, params = _setup()
    # request 7 of this trace has a varied greedy stream, so a wrong
    # history token makes a wrong proposal
    reqs = [r for r in _trace(cfg, n=12, prompt_len=3, max_new=13)
            if r.rid == 7]
    spy = _Spy()
    rep = _engine(cfg, params, prefill_chunk=2, spec_k=K,
                  draft_layers=cfg.n_layers, backend=spy).serve(
        reqs, fault_plan=E.FaultPlan([E.Fault(1, "nan_logits", 0)]))
    assert rep.preempted == 1 and rep.resumed_prefill_tokens == 3 + 4
    assert rep.outputs() == E.reference_outputs(
        cfg, params, reqs, mode=W8A16, max_seq=MAX_SEQ, device="cpu")
    assert len(set(rep.results[0].tokens)) > 4
    assert spy.rejections() == 0


@pytest.mark.parametrize("seed", [0, 7, 31])
def test_fault_plan_stays_bit_for_bit(seed):
    """Seeded dispatch faults, non-finite samples and torn table rows
    against the speculating engine: a fault in a round discards the
    whole round (proposals in flight are uncommitted), recovery rebuilds
    from the last committed token, and every ok request equals the
    sequential reference."""
    _, cfg, _, params = _setup()
    reqs = _trace(cfg, n=30, rate=8000.0, seed=6,
                  priority=lambda rid: bt.PRIORITY_CLASSES[rid % 2])
    want = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                               max_seq=MAX_SEQ, device="cpu")
    plan = E.FaultPlan.random(seed=seed, n_faults=10, max_tick=60,
                              num_slots=SLOTS)
    rep = _engine(cfg, params, block_size=4, num_blocks=13, prefill_chunk=4,
                  spec_k=2, draft_layers=1).serve(reqs, preemption=True,
                                                  fault_plan=plan)
    assert len(rep.results) == 30 and plan.fired
    for r in rep.results:
        if r.status == "ok":
            assert r.tokens == want[r.rid], r.rid
    assert rep.leaked_blocks == 0


def test_engine_equals_jax_speculative_engine():
    """The port's speculating engine and the JAX package's, same bridged
    W8A16 weights, same trace: each equals its own non-speculative
    engine, and they equal each other on every request where those two
    agree (ROADMAP, level 3; the two part only at a reference near-tie,
    tests/test_torch_engine.py)."""
    jcfg, cfg, jq, params = _setup()
    kw = dict(num_slots=SLOTS, max_seq=MAX_SEQ, prefill_chunk=4)
    reqs = _trace(cfg, n=24, seed=8)
    jreqs = JE.synthetic_requests(24, rate_per_s=3000.0, vocab=cfg.vocab,
                                  prompt_len=4, max_new_tokens=6, seed=8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jplain = JE.Engine(jcfg, jq, mode=JW8A16, **kw).serve(jreqs)
        jspec = JE.Engine(jcfg, jq, mode=JW8A16, spec_k=K, draft_layers=1,
                          **kw).serve(jreqs)
    plain = E.Engine(cfg, params, mode=W8A16, device="cpu", **kw).serve(reqs)
    spec = E.Engine(cfg, params, mode=W8A16, device="cpu", spec_k=K,
                    draft_layers=1, **kw).serve(reqs)
    assert spec.outputs() == plain.outputs()
    assert jspec.outputs() == jplain.outputs()
    agree = [rid for rid, toks in plain.outputs().items()
             if toks == jplain.outputs()[rid]]
    assert len(agree) >= len(reqs) * 3 // 4, agree
    for rid in agree:
        assert spec.outputs()[rid] == jspec.outputs()[rid], rid
    assert [r.status for r in spec.results] == \
        [r.status for r in jspec.results]
    assert spec.generated_tokens == jspec.generated_tokens


# ---------------------------------------------------------------------------
# accounting and the captured steps' bindings
# ---------------------------------------------------------------------------

def test_non_speculative_identity():
    """Without speculation every emitting dispatch commits one token:
    ``accepted_per_dispatch`` is 1.0 exactly, and the per-token latency
    mean is that of the ok requests."""
    _, cfg, _, params = _setup()
    rep = _engine(cfg, params).serve(_trace(cfg, n=20, seed=7))
    assert rep.spec_k == 0 and rep.accepted_per_dispatch == 1.0
    assert 0.0 < rep.latency_per_token_s < float("inf")
    ok = [r for r in rep.results if r.status == "ok" and r.tokens]
    want = float(np.mean([r.latency_s / len(r.tokens) for r in ok]))
    assert rep.latency_per_token_s == pytest.approx(want)


def test_speculative_tokens_counted_once():
    """Throughput counts committed tokens only: a rejected proposal
    never adds to ``generated_tokens``."""
    _, cfg, _, params = _setup()
    reqs = _trace(cfg, n=20, seed=8)
    plain = _engine(cfg, params).serve(reqs)
    spec = _engine(cfg, params, spec_k=K, draft_layers=1).serve(reqs)
    assert spec.generated_tokens == plain.generated_tokens
    assert spec.generated_tokens == sum(len(r.tokens) for r in spec.results)
    assert spec.spec_k == K


def test_warmup_binds_every_step_and_serves_bind_nothing_more():
    """``warmup`` binds the verify step, the propose step and the draft's
    chunk step for every n up to ``draft_cap`` (and the target's chunks),
    never the fused tick; two serves then bind nothing (the self-draft's
    params are a new list over the target's tensors, bound by identity),
    and give the same tokens."""
    _, cfg, _, params = _setup()
    eng = _engine(cfg, params, prefill_chunk=4, spec_k=K, draft_layers=1)
    assert eng.draft_cap == 4 and eng.dcfg.name.endswith("-draft1")
    be = eng.backend
    steps = [be.verify_step(cfg, mode=W8A16, k=K, temperature=0.0),
             be.propose_step(eng.dcfg, mode=W8A16, k=K)]
    steps += [be.chunk_step(c, mode=W8A16, chunk=b)
              for c in (cfg, eng.dcfg) for b in (1, 2, 4)]
    tick = be.slot_step(cfg, mode=W8A16, temperature=0.0)
    before = [s.captured.captures for s in steps]
    tick_before = tick.captured.captures
    eng.warmup()
    bound = [s.captured.captures for s in steps]
    # verify, propose, and n = 1, 2, 3-4 for each of the two chunk steps
    assert [b - a for a, b in zip(before, bound)] == [1, 1, 1, 1, 2, 1, 1, 2]
    reqs = _trace(cfg, n=12, prompt_len=7, seed=9)
    outs = [eng.serve(reqs).outputs() for _ in range(2)]
    assert [s.captured.captures for s in steps] == bound
    assert tick.captured.captures == tick_before
    assert outs[0] == outs[1] == _engine(cfg, params, prefill_chunk=4) \
        .serve(reqs).outputs()
