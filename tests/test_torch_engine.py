"""The port's continuous-batching engine, on the CPU at reduced size:
bit-for-bit against its own sequential reference, token for token against
the JAX package's reference, isolation of slots, and the package's
boundaries (no JAX inside it, the card by default)."""
import dataclasses
import os
import subprocess
import sys

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
from repro_torch.runtime import steps as ST

from test_torch_model import LOGIT_ATOL, to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT, GEN = 5, 6


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
    reqs = E.synthetic_requests(24, rate_per_s=2000.0, vocab=cfg.vocab,
                                prompt_len=PROMPT, max_new_tokens=GEN)
    return jcfg, cfg, jq, params, reqs


def _engine(cfg, params, **kw):
    return E.Engine(cfg, params, mode=W8A16, num_slots=4,
                    max_seq=PROMPT + GEN, prefill_chunk=4, device="cpu",
                    **kw)


@pytest.mark.parametrize("chunk", [1, 2, 4, None])
def test_engine_equals_reference_bit_for_bit(setup, chunk):
    """24 requests through 4 slots (each slot reused), chunked prefill of
    1, 2 or 4 (prompts of 5 leave 4 tokens: four, two or one captured
    chunk) or per-token prefill: every request's tokens equal the
    sequential batch-1 reference exactly."""
    _, cfg, _, params, reqs = setup
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=4,
                   max_seq=PROMPT + GEN, prefill_chunk=chunk, device="cpu")
    rep = eng.serve(reqs)
    ref = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                              max_seq=eng.max_seq, device="cpu")
    assert rep.outputs() == ref
    assert all(r.status == "ok" and len(r.tokens) == GEN
               for r in rep.results)
    assert len({r.slot for r in rep.results}) == 4
    assert rep.admissions_while_busy > 0
    assert max(rep.occupancy) <= 4


def test_engine_chunk_remainder_buckets(setup):
    """Prompts of 8 leave 7 tokens: a chunk of 4, then 3 padded to a bucket
    of 4 whose padding is never run — still bit-for-bit."""
    _, cfg, _, params, _ = setup
    reqs = E.synthetic_requests(6, rate_per_s=500.0, vocab=cfg.vocab,
                                prompt_len=8, max_new_tokens=3, seed=4)
    eng = E.Engine(cfg, params, mode=W8A16, num_slots=2, max_seq=11,
                   prefill_chunk=4, device="cpu")
    ref = E.reference_outputs(cfg, params, reqs, mode=W8A16,
                              max_seq=eng.max_seq, device="cpu")
    assert eng.serve(reqs, clock="wall").outputs() == ref


def _jax_reference_with_margins(jcfg, jq, reqs, max_seq):
    """The JAX package's ``reference_outputs`` loop, also recording the top-2
    logit gap at every generated token."""
    decode = jax.jit(JST.make_decode_step(jcfg, mode=JW8A16))
    toks, gaps = {}, {}
    for r in reqs:
        cache = JR.init_cache(jcfg, 1, max_seq)
        gen, gap, tok, pos = [], [], None, 0
        while len(gen) < r.max_new_tokens:
            cur = r.prompt[pos] if pos < len(r.prompt) else tok
            logits, cache = decode(
                jq, {"tokens": jnp.asarray([[cur]], jnp.int32),
                     "cache_index": jnp.asarray(pos, jnp.int32)}, cache)
            pos += 1
            if pos >= len(r.prompt):
                row = np.asarray(logits[0, -1])
                tok = int(row.argmax())
                top2 = np.sort(row)[-2:]
                gen.append(tok)
                gap.append(float(top2[1] - top2[0]))
        toks[r.rid], gaps[r.rid] = gen, gap
    return toks, gaps


def test_engine_tokens_match_jax_reference(setup):
    """The port's engine and the JAX package's reference_outputs, same
    weights and same trace: greedy tokens equal, except that a request may
    part ways at a step where the JAX top-2 logit gap is within the model
    tolerance (LOGIT_ATOL, tests/test_torch_model.py) — after which the two
    decode different inputs and are not compared further."""
    jcfg, cfg, jq, params, reqs = setup
    jreqs = JE.synthetic_requests(24, rate_per_s=2000.0, vocab=cfg.vocab,
                                  prompt_len=PROMPT, max_new_tokens=GEN)
    assert [(r.rid, r.prompt, r.arrival_s) for r in jreqs] == \
        [(r.rid, r.prompt, r.arrival_s) for r in reqs]
    eng = _engine(cfg, params)
    got = eng.serve(reqs).outputs()
    want, gaps = _jax_reference_with_margins(jcfg, jq, jreqs, eng.max_seq)
    parted = 0
    for rid, toks in want.items():
        first = next((i for i, (a, b) in enumerate(zip(got[rid], toks))
                      if a != b), None)
        if first is None:
            continue
        assert gaps[rid][first] <= LOGIT_ATOL, (rid, first, gaps[rid])
        parted += 1
    assert parted <= len(want) // 4, parted


def test_jax_reference_loop_is_the_packages_reference(setup):
    """The margin-recording loop above reproduces the JAX package's own
    reference_outputs."""
    jcfg, _, jq, _, _ = setup
    jreqs = JE.synthetic_requests(3, rate_per_s=2000.0, vocab=jcfg.vocab,
                                  prompt_len=PROMPT, max_new_tokens=GEN)
    toks, _ = _jax_reference_with_margins(jcfg, jq, jreqs, 16)
    assert toks == JE.reference_outputs(jcfg, jq, jreqs, mode=JW8A16,
                                        max_seq=16)


def test_inactive_slot_poison_cannot_leak(setup):
    """Garbage in inactive slots' cache rows and token inputs changes
    neither active rows' tokens nor their cache rows, bitwise."""
    _, cfg, _, params, _ = setup
    step = ST.make_slot_decode_step(cfg, mode=W8A16)
    idx = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    active = torch.tensor([True, False, True, False])

    def run(poison):
        cache = R.init_cache(cfg, 4, 16, device="cpu")
        toks = torch.tensor([[5], [1], [9], [2]], dtype=torch.int32)
        if poison:
            g = torch.Generator().manual_seed(1)
            for k, c in cache.items():
                c[:, 1::2] = (torch.randint(-127, 128, c[:, 1::2].shape,
                                            generator=g).to(c.dtype)
                              if c.dtype == torch.int8
                              else torch.rand(c[:, 1::2].shape, generator=g))
            toks[1::2] = 400
        nxt, cache, new_idx = step(params, toks, cache, idx.clone(), active)
        return nxt, cache, new_idx

    a, ca, ia = run(False)
    b, cb, ib = run(True)
    assert torch.equal(a[0::2], b[0::2]) and torch.equal(ia, ib)
    assert torch.equal(a[1::2], torch.zeros(2, dtype=torch.int32))
    assert torch.equal(ia, torch.tensor([3, 0, 4, 1], dtype=torch.int32))
    for k in ca:
        assert torch.equal(ca[k][:, 0::2], cb[k][:, 0::2])


def test_synthetic_requests_match_reference_trace():
    mine = E.synthetic_requests(30, rate_per_s=300.0, vocab=97,
                                prompt_len=6, max_new_tokens=4, seed=3,
                                shared_prefix_len=2, deadline_s=0.5)
    ref = JE.synthetic_requests(30, rate_per_s=300.0, vocab=97,
                                prompt_len=6, max_new_tokens=4, seed=3,
                                shared_prefix_len=2, deadline_s=0.5)
    assert [(r.rid, r.prompt, r.arrival_s, r.deadline_s) for r in mine] == \
        [(r.rid, r.prompt, r.arrival_s, r.deadline_s) for r in ref]


def test_engine_rejects_oversized_request(setup):
    _, cfg, _, params, _ = setup
    eng = _engine(cfg, params)
    with pytest.raises(E.RequestTooLong):
        eng.serve([E.EngineRequest(rid=0, prompt=(1,) * 14,
                                   max_new_tokens=3)])


def test_unported_options_name_their_roadmap_item(setup):
    """Shards on two cards: refused naming the ROADMAP item, before any
    engine is built."""
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        E.ShardedExecutor(devices=["cuda:0", "cuda:1"])


def test_engine_defaults_to_the_card(setup):
    """With no device argument the engine runs on CUDA — and on a machine
    without a card it raises instead of falling back to the CPU."""
    _, cfg, _, params, _ = setup
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        E.Engine(cfg, params, mode=W8A16, num_slots=4, max_seq=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.init_cache(cfg, 1, 16)


def test_port_imports_no_jax():
    """Every repro_torch module, and chip_smoke.py, import without pulling
    in jax, jaxlib or the JAX package."""
    code = r"""
import importlib, pkgutil, sys
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
import chip_smoke
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print(len([n for n in sys.modules if n.startswith("repro_torch")]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
