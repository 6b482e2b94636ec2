"""The port's vlm engine (llama-3.2-vision-90b at reduced size: 2 layers,
one cross layer over 8 patches, d 128, vocab 512) on the CPU: served
contiguous and paged with chunked prefill, every request primed from its
own patch embeddings at admission, bit for bit the port's sequential
``reference_outputs``, and token for token the JAX engine on the same
trace up to a reference near-tie; the reference's source validation and
prime contract; the serve CLI.

The weights are the reference's (``tests/test_torch_vision.py``'s
``gated_params``: every group's ``x_gate`` set nonzero, so the patches
reach the logits), copied through ``models/bridge.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro import engine as JE
from repro.core.qlinear import W8A16 as JW8A16
from repro.engine import dispatch as JD
from repro_torch import engine as E
from repro_torch.core.qlinear import W8A16
from repro_torch.models import registry as R
from repro_torch.runtime import steps as ST

from test_torch_model import LOGIT_ATOL
from test_torch_vision import ARCH, cfgs, gated_params

MAX_SEQ = 16
PROMPT, GEN = 6, 4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """(jcfg, cfg, JAX int8 params, the port's bridged copy)."""
    jcfg, cfg = cfgs()
    jq, tq = gated_params(jcfg)["w8a16"]
    return jcfg, cfg, jq, tq


def _requests(make, cfg, n, **kw):
    kw.setdefault("rate_per_s", 2000.0)
    return make(n, vocab=cfg.vocab, prompt_len=PROMPT, max_new_tokens=GEN,
                source_shape=R.source_shape(cfg), **kw)


@pytest.fixture(scope="module")
def trace(setup):
    """Ten requests through four slots (slot reuse), their sources 8, 7 or
    6 patches long, and the port's sequential reference with each token's
    top-2 logit gap."""
    _, cfg, _, tq = setup
    reqs = _requests(E.synthetic_requests, cfg, 10)
    margins = {}
    want = E.reference_outputs(cfg, tq, reqs, mode=W8A16, max_seq=MAX_SEQ,
                               device="cpu", margins=margins)
    return reqs, want, margins


def _engine(cfg, params, paged=False, **kw):
    kw.setdefault("num_slots", 4)
    if paged:
        kw.setdefault("block_size", 4)
    return E.Engine(cfg, params, mode=W8A16, max_seq=MAX_SEQ,
                    prefill_chunk=4, device="cpu", **kw)


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                     "paged"])
def test_engine_equals_reference_bit_for_bit(setup, trace, paged):
    """``Engine.serve`` with chunked prefill of 4 (each admission primes
    the slot's cross row first; the W8A16 chunk in one pass): every
    request's tokens equal the sequential batch-1 reference's, contiguous
    and paged, through slot reuse, with no block leaked; the warmed-up
    engine serves the same."""
    _, cfg, _, tq = setup
    reqs, want, _ = trace
    assert sorted(len(r.source) for r in reqs[:3]) == [6, 7, 8]
    eng = _engine(cfg, tq, paged)
    rep = eng.serve(reqs)
    assert rep.outputs() == want
    assert {r.slot for r in rep.results} == set(range(4))
    assert rep.leaked_blocks == 0
    eng.warmup()
    assert eng.serve(reqs).outputs() == want


@pytest.mark.parametrize("paged", [False, True], ids=["contiguous",
                                                     "paged"])
def test_engine_matches_the_jax_engine(setup, trace, paged):
    """The port's engine and the JAX engine on the same weights and trace
    (the same prompts and patch bytes): greedy tokens equal, except that a
    request may part ways at a step where the port's reference top-2 gap
    is within LOGIT_ATOL, after which the two decode different inputs."""
    jcfg, cfg, jq, tq = setup
    reqs, _, margins = trace
    got = _engine(cfg, tq, paged).serve(reqs).outputs()
    jreqs = _requests(JE.synthetic_requests, cfg, 10)
    assert all(a.source.tobytes() == b.source.tobytes()
               for a, b in zip(reqs, jreqs))
    jeng = JE.Engine(jcfg, jq, mode=JW8A16, num_slots=4, max_seq=MAX_SEQ,
                     prefill_chunk=4,
                     **(dict(block_size=4) if paged else {}))
    want = jeng.serve(jreqs).outputs()
    assert got.keys() == want.keys()
    parted = 0
    for rid, toks in want.items():
        first = next((i for i, (a, b) in enumerate(zip(got[rid], toks))
                      if a != b), None)
        if first is None:
            continue
        assert margins[rid][first] <= LOGIT_ATOL, (rid, first)
        parted += 1
    assert parted <= len(want) // 4, parted


@pytest.mark.parametrize("case", [
    "missing", "wrong_width", "too_long", "empty", "flat"])
def test_source_validation_matches_the_reference(setup, case):
    """The engine checks every request's patches before admitting anything,
    with the reference's messages: at most n_patches of d_model each."""
    jcfg, cfg, _, tq = setup
    d = cfg.d_model
    source = {"missing": None,
              "wrong_width": np.zeros((4, d + 1), np.float32),
              "too_long": np.zeros((cfg.n_patches + 1, d), np.float32),
              "empty": np.zeros((0, d), np.float32),
              "flat": np.zeros((d,), np.float32)}[case]
    good = _requests(E.synthetic_requests, cfg, 1)[0]
    req = dataclasses.replace(good, rid=5, source=source)
    jreq = JD.EngineRequest(rid=5, prompt=req.prompt, max_new_tokens=GEN,
                            source=source)
    with pytest.raises(ValueError) as want:
        JD._validate_source(jcfg, jreq)
    eng = _engine(cfg, tq)
    with pytest.raises(ValueError) as got:
        eng.serve([good, req])
    assert str(got.value) == str(want.value)
    assert eng._cache is None       # nothing was admitted


def test_preemption_resume_reprimes(setup, trace):
    """Interactive heads evict batch slots from a two-slot paged pool;
    every resumed request, re-primed from its own patches over a slot
    another tenant primed since, equals the reference."""
    _, cfg, _, tq = setup
    reqs, want, _ = trace
    reqs = [dataclasses.replace(
        r, priority="batch" if r.rid % 3 == 0 else "interactive")
        for r in reqs]
    rep = _engine(cfg, tq, True, num_slots=2).serve(reqs, preemption=True)
    assert rep.preempted > 0
    assert rep.outputs() == want
    assert rep.leaked_blocks == 0


def test_primed_cross_kv_isolated_and_scrubbed_on_reuse(setup):
    """The prime contract (the reference's test of the same name):
    (a) poisoned cross k/v in inactive rows never changes the active
    rows' samples or self-cache writes; (b) poison past an active row's
    own xlen is never read; (c) decode never writes xk, xv or xlen (the
    poison comes back bitwise); (d) re-priming a poisoned row overwrites
    it whole: the new tenant decodes as in a fresh pool."""
    _, cfg, _, tq = setup
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
    prime(tq, src_for(7, n0), cache, 0, n0)
    prime(tq, src_for(8, n2), cache, 2, n2)
    idx = torch.tensor([1, 0, 2, 1], dtype=torch.int32)
    active = torch.tensor([True, False, True, False])
    tokens = torch.tensor([[5], [1], [9], [2]], dtype=torch.int32)

    def run(c):
        c = {k: v.clone() for k, v in c.items()}
        nxt, c, i = step(tq, tokens, c, idx, active)
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
    # poison inside the active row's own range is read (the gate is
    # open): its logits move, the other active row's do not
    decode = ST.make_decode_step(cfg, mode=W8A16)

    def logits(c):
        c = {k: v.clone() for k, v in c.items()}
        return decode(tq, {"tokens": tokens, "cache_index": idx}, c)[0]

    live = {k: v.clone() for k, v in cache.items()}
    live["xv"][:, 2, 0] = 55.0
    base, moved = logits(cache), logits(live)
    assert torch.equal(base[0], moved[0])
    assert not torch.equal(base[2], moved[2])

    nB = src_max - 1
    reused = {k: v.clone() for k, v in c2.items()}
    prime(tq, src_for(9, nB), reused, 1, nB)
    fresh = R.init_cache(cfg, S, smax, device="cpu")
    prime(tq, src_for(9, nB), fresh, 1, nB)
    for k in ("xk", "xv", "xlen"):
        assert torch.equal(reused[k][(slice(None),) * (k != "xlen") + (1,)],
                           fresh[k][(slice(None),) * (k != "xlen") + (1,)])
    tok2 = torch.tensor([[5], [7], [9], [2]], dtype=torch.int32)
    only1 = torch.tensor([False, True, False, False])
    zero = torch.zeros((S,), dtype=torch.int32)
    nr = step(tq, tok2, reused, zero, only1)[0].clone()
    nf = step(tq, tok2, fresh, zero, only1)[0].clone()
    assert int(nr[1]) == int(nf[1])


def test_serve_cli_runs_vlm(capsys):
    """``python -m repro_torch.launch.serve --arch llama-3.2-vision-90b``
    on the CPU, paged: the curve's forward takes the patch embeddings of
    ``input_specs``, the decode loop runs, the engine serves every
    request, each with its own patches, as ``reference_outputs`` does."""
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
    assert all(r.source is not None and r.source.shape[1] == res.cfg.d_model
               for r in res.requests)
    assert rep.outputs() == E.reference_outputs(
        res.cfg, res.params, res.requests, mode=W8A16,
        max_seq=res.engine.max_seq, device="cpu")
